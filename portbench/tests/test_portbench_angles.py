"""An angle folded flat, where theta0 is 180 degrees: the force there goes
through 1 / sin(theta) of a float32 cosine, and the program resolves it
only to ``check.angle_slack``.  The check holds the program to that
slack there and to nothing looser anywhere else."""

import dataclasses
import math

import pytest
import torch

from portbench import check
from portbench.reference import forces as ref_forces
from test_portbench_barostat import _melt, _topology


def _bonded_gap(sys_, built, st, angles, bonds):
    """(|F_program - F_reference| per particle of the bonds and angles,
    the slack) at the state ``st``, the reference in float64."""
    from chemlab_tpu_torch.engine import bonded_forces, integrate

    n = check.active_count(st)
    prog, _ = bonded_forces.bonded_forces(
        built.spec, built.cfg, st.pos, st.box, st.type_id, st.q, st.bonds,
        st.angles, st.dihedrals, st.pairs14,
        dense=integrate._dense_of(built.cfg, st))
    ref = ref_forces.bonded_forces(st.pos[:n], st.box, bonds, angles,
                                   sys_.bond_k, sys_.bond_r0, sys_.angle_k,
                                   sys_.angle_theta0, torch.float64)
    gap = torch.linalg.vector_norm(prog[:n].double() - ref, dim=-1)
    return gap, check.angle_slack(sys_, st.pos[:n], st.box, angles)


def _bend(st, angle, theta):
    """``st`` with the angle's end k moved to theta from the end i, seen
    from the apex j, at its own distance from j."""
    i, j, k = (int(v) for v in angle)
    pos = st.pos.clone()
    rij = pos[i].double() - pos[j].double()
    rkj = pos[k].double() - pos[j].double()
    u = rij / torch.linalg.vector_norm(rij)
    w = torch.linalg.cross(u, torch.tensor([0.3, -0.5, 0.8],
                                            dtype=torch.float64))
    w = w / torch.linalg.vector_norm(w)
    d = torch.linalg.vector_norm(rkj) * (math.cos(theta) * u
                                         + math.sin(theta) * w)
    pos[k] = (pos[j].double() + d).float()
    return dataclasses.replace(st, pos=pos)


def test_no_slack_where_no_angle_is_folded():
    sys_, built, _, st = _melt()
    _, bonds, angles, _ = _topology(st)
    gap, slack = _bonded_gap(sys_, built, st, angles, bonds)
    assert float(slack.abs().max()) == 0.0
    assert float(gap.max()) < 1e-4
    # stretched straight, at theta0's own end, the force goes to nought
    # with sin(theta) and takes no slack either
    st = _bend(st, angles[0], 3.14159)
    gap, slack = _bonded_gap(sys_, built, st, angles, bonds)
    assert float(slack.abs().max()) == 0.0
    assert float(gap.max()) < 1e-4


@pytest.mark.parametrize("theta", [3e-4, 2e-3, 1e-2, 4e-2])
def test_folded_angle_is_held_to_its_slack(theta):
    sys_, built, _, st = _melt()
    _, bonds, angles, _ = _topology(st)
    st = _bend(st, angles[0], theta)
    gap, slack = _bonded_gap(sys_, built, st, angles, bonds)
    ends = [int(v) for v in angles[0]]
    others = torch.ones_like(gap, dtype=torch.bool)
    others[ends] = False
    # the slack is the folded angle's alone, and covers what float32
    # leaves of its force, with room
    assert float(slack[others].abs().max()) == 0.0
    assert bool((slack[ends] > 0).all())
    assert float((gap[ends] / slack[ends]).max()) < 0.75
    assert float(gap[others].max()) < 1e-4
    # within 0.1 degree of flat the float32 force is off by more than any
    # other term's rounding: the slack is what keeps a sound run correct
    if theta <= 2e-3:
        assert float(gap.max()) > 1e-2
