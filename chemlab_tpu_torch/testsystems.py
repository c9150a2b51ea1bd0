"""The reactive trimer melts: build, warmup and initiator activation.

Port of ``chemlab_tpu/testsystems.py``: the melt's topology text,
coordinates, reaction cfg and LJ pair tables are the port's own copies
(unchanged); ``build_melt`` (LJ), ``build_tabulated_melt`` (every type pair
a func-8 table) and ``build_mixed_tab_melt`` (func 10/12 two-table blends
on two type pairs) reproduce the reference's builds bit for bit (initial
velocities included: both draw from ``np.random.RandomState``) on the card
by default.  ``warmup`` re-draws velocities from a ``torch.Generator``, so
its velocities differ from the reference's ``jax.random`` draw.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile

import numpy as np
import torch

from . import files_io, reaction_parser, topfile
from .engine import build, integrate, runner
from .topology import compile_system_topology

ATRP_CFG_TEXT = """
[general]
interval: 200
nearest=0

[ext_change_neighbour_type]
ext_type=ChangeNeighboursProperty
invoke_on=both
type_transfers=MA:2->PA,ML:1->PL(state=1),ML:2->PL(state=1)

[group_reaction_1]
potential=Harmonic
potential_options=K=30.0,r0=0.97
extensions=change_neighbour_type

[reaction_a]
reaction: FA(3, 4) + MA(1, 2) -> FA(1):DA(2)
cutoff: 1.2
rate: 0.8
intramolecular: 1
intraresidual: 0
active: True
group: reaction_1

[reaction_b]
reaction: DA(3, 4) + MA(1, 2) -> RA(1):DA(2)
cutoff: 1.2
rate: 0.8
intramolecular: 1
intraresidual: 0
active: True
group: reaction_1
"""


def _melt_topology_text(n_mols: int) -> str:
    """An ATRP-style coarse-grained monomer melt: MA-ML-MA trimers with
    harmonic bonds/angles and unit LJ types (reduced units)."""
    return """
[ defaults ]
1 3

[ atomtypes ]
  MA    1.0      0.000     A        1            1
  ML    1.0      0.000     A        1            1
  PA    1.0      0.000     A        1            1
  FA    1.0      0.000     A        1            1
  DA    1.0      0.000     A        1            1
  RA    1.0      0.000     A        1            1
  PL    1.0      0.000     A        1            1

[ atomstate ]
MA 1
PA 1
FA 5
PL 1

[ bondtypes ]
MA ML 1 0.97 60.0
PA PL 1 0.97 60.0
FA PL 1 0.97 60.0
RA PL 1 0.97 60.0
DA PL 1 0.97 60.0
FA RA 1 0.97 60.0
FA DA 1 0.97 60.0
DA RA 1 0.97 60.0
RA RA 1 0.97 60.0

[ angletypes ]
MA ML MA 1 180.0 2.5
PA PL RA 1 180.0 2.5
FA PL RA 1 180.0 2.5
PA PL FA 1 180.0 2.5
PA PL DA 1 180.0 2.5
FA PL FA 1 180.0 2.5
DA PL DA 1 180.0 2.5
FA PL DA 1 180.0 2.5
DA FA PL 1 180.0 2.5
FA DA PL 1 180.0 2.5
FA PA PL 1 180.0 2.5
RA FA PL 1 180.0 2.5
RA RA PL 1 180.0 2.5
RA DA PL 1 180.0 2.5
DA RA PL 1 180.0 2.5
FA RA DA 1 180.0 2.5
FA RA RA 1 180.0 2.5
RA RA RA 1 180.0 2.5
RA RA DA 1 180.0 2.5

[ moleculetype ]
TRI 2

[ atoms ]
1 MA 1 MON AI 1 0.000000 1
2 ML 1 MON LM 2 0.000000 1
3 MA 1 MON AJ 3 0.000000 1

[ bonds ]
1 2
2 3

[ angles ]
1 2 3

[ system ]
generated melt

[ molecules ]
TRI %d
""" % n_mols


def melt_coordinates(n_mols: int, density: float, bond_r: float = 0.97,
                     seed: int = 0) -> files_io.Coordinates:
    """Place trimer molecules at random positions/orientations."""
    rng = np.random.RandomState(seed)
    n = 3 * n_mols
    box_l = float((n / density) ** (1.0 / 3.0))
    box = np.array([box_l, box_l, box_l])
    centers = rng.uniform(0, box_l, size=(n_mols, 3))
    u = rng.normal(size=(n_mols, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    pos = np.empty((n, 3))
    pos[0::3] = centers - bond_r * u
    pos[1::3] = centers
    pos[2::3] = centers + bond_r * u
    pos = np.mod(pos, box)
    res = np.repeat(np.arange(1, n_mols + 1), 3)
    return files_io.Coordinates(
        title="generated melt",
        atom_ids=np.arange(1, n + 1),
        res_idx=res,
        res_names=["MON"] * n,
        atom_names=["AI", "LM", "AJ"] * n_mols,
        pos=pos,
        vel=None,
        box=box,
    )


MELT_TYPES = ("MA", "ML", "PA", "FA", "DA", "RA", "PL")


def _lj_table(r, eps: float, sig: float):
    """(E, F) of the LJ potential at radii ``r``."""
    sr6 = (sig / r) ** 6
    return (4.0 * eps * (sr6 * sr6 - sr6),
            24.0 * eps * (2.0 * sr6 * sr6 - sr6) / r)


def _write_table(path: str, r, e, f) -> None:
    with open(path, "w") as out:
        for k in range(len(r)):
            out.write("%.6f %.8e %.8e\n" % (r[k], e[k], f[k]))


def write_lj_pair_tables(out_dir: str, eps: float = 0.25, sig: float = 1.0,
                         dr: float = 0.002, r_max: float = 3.0,
                         rough: float = 0.0, seed: int = 3) -> None:
    """Write table_T1_T2.pot for every melt type pair: the LJ potential
    sampled at source resolution (the rim135/dacron table granularity,
    ref: examples/rim135/table_A_A.xvg has dr=0.002).  ``rough`` adds
    bounded high-frequency structure to F (and integrates it into E) to
    mimic IBI-table roughness without destabilizing the dynamics."""
    r = np.arange(dr, r_max + dr / 2, dr)
    e, f = _lj_table(r, eps, sig)
    rng = np.random.RandomState(seed)
    names = sorted(MELT_TYPES)
    for i, t1 in enumerate(names):
        for t2 in names[i:]:
            if rough > 0.0:
                bump = rough * np.abs(f) * rng.uniform(-1, 1, size=len(r))
                fq = f + bump
                eq = e.copy()
                eq[:-1] = e[-1] + np.cumsum((fq * dr)[::-1])[::-1][1:]
            else:
                fq, eq = f, e
            _write_table(os.path.join(out_dir, "table_%s_%s.pot" % (t1, t2)),
                         r, eq, fq)


def build_melt(n_mols: int = 2000, density: float = 0.27, kT: float = 1.0,
               reactive: bool = True, seed: int = 42, device="cuda",
               **opt_overrides):
    """Build the reactive melt on ``device``; returns (BuiltSystem,
    SystemTopology, Coordinates) like the reference.  ``opt_overrides``
    go to ``SimOptions`` (``slab_devices=D`` for the slab path, as in the
    reference)."""
    top = topfile.parse_lines(_melt_topology_text(n_mols).splitlines(),
                              "<generated>")
    systop = compile_system_topology(top)
    coords = melt_coordinates(n_mols, density, seed=seed)
    rcfg = None
    if reactive:
        rcfg = reaction_parser.parse_config_lines(ATRP_CFG_TEXT.splitlines())
    # capacity sizing for liquid density (the reference's choice)
    rc_skin = 2.5 + 0.4
    k_liq = int(0.95 * 4.0 / 3.0 * np.pi * rc_skin**3 * 1.25)
    opts_kw = dict(lj_cutoff=2.5, cg_cutoff=2.5, skin=0.4, dt=0.0025, kT=kT,
                   thermostat="lv", thermostat_gamma=1.0, gen_velocity=True,
                   rng_seed=seed, max_neighbors=-(-k_liq // 8) * 8)
    opts_kw.update(opt_overrides)
    built = build.build_system(systop, coords, build.SimOptions(**opts_kw),
                               reaction_config=rcfg, device=device)
    return built, systop, coords


def _build_tab(pair_line, n_mols: int, density: float, kT: float,
               reactive: bool, seed: int, table_dir: str, device,
               opt_overrides: dict):
    """The tabulated melts' common build: the melt's topology with one
    ``[ nonbond_params ]`` line per type pair (``pair_line(t1, t2)``), and
    no ``max_neighbors`` override (the tables keep a supercritical well, so
    the melt stays homogeneous)."""
    names = sorted(MELT_TYPES)
    nb_lines = ["", "[ nonbond_params ]"] + [
        pair_line(t1, t2) for i, t1 in enumerate(names) for t2 in names[i:]]
    top_text = _melt_topology_text(n_mols) + "\n".join(nb_lines) + "\n"
    systop = compile_system_topology(
        topfile.parse_lines(top_text.splitlines(), "<generated-tab>"))
    coords = melt_coordinates(n_mols, density, seed=seed)
    rcfg = (reaction_parser.parse_config_lines(ATRP_CFG_TEXT.splitlines())
            if reactive else None)
    opts_kw = dict(lj_cutoff=2.5, cg_cutoff=2.5, skin=0.4, dt=0.0025, kT=kT,
                   thermostat="lv", thermostat_gamma=1.0, gen_velocity=True,
                   rng_seed=seed, table_dirs=(table_dir,))
    opts_kw.update(opt_overrides)
    built = build.build_system(systop, coords, build.SimOptions(**opts_kw),
                               reaction_config=rcfg, device=device)
    return built, systop, coords


def build_tabulated_melt(n_mols: int = 2000, density: float = 0.27,
                         kT: float = 1.0, reactive: bool = True,
                         seed: int = 42, rough: float = 0.0,
                         table_dir: str | None = None, device="cuda",
                         **opt_overrides):
    """The melt with every nonbonded type pair served by a func-8 table
    (the rim135/dacron workload class); tables go to a fresh temporary
    directory unless ``table_dir`` holds them.  ``opt_overrides`` go to
    ``SimOptions`` (``slab_devices=D`` for the slab path)."""
    if table_dir is None:
        table_dir = tempfile.mkdtemp(prefix="chemlab_tab_")
        write_lj_pair_tables(table_dir, rough=rough)
    return _build_tab(lambda t1, t2: "%s %s 8" % (t1, t2), n_mols, density,
                      kT, reactive, seed, table_dir, device, opt_overrides)


def build_mixed_tab_melt(n_mols: int = 100, density: float = 0.27,
                         kT: float = 1.0, reactive: bool = False,
                         seed: int = 42, device="cuda", **opt_overrides):
    """The tabulated melt with two blended type pairs: MA-MA mixes two
    tables by the MA conversion observable (func 10), MA-ML by a static
    factor 0.35 (func 12)."""
    table_dir = tempfile.mkdtemp(prefix="chemlab_mixtab_")
    write_lj_pair_tables(table_dir)
    r = np.arange(0.002, 3.0 + 0.001, 0.002)
    for name, eps in (("mixA", 0.25), ("mixB", 0.12)):
        _write_table(os.path.join(table_dir, "table_%s.pot" % name), r,
                     *_lj_table(r, eps, 1.0))
    blends = {
        ("MA", "MA"): "MA MA 10 table_mixA.pot table_mixB.pot MA %d"
                      % (2 * n_mols),
        ("MA", "ML"): "MA ML 12 table_mixA.pot table_mixB.pot 0.35"}
    return _build_tab(
        lambda t1, t2: blends.get((t1, t2), "%s %s 8" % (t1, t2)), n_mols,
        density, kT, reactive, seed, table_dir, device, opt_overrides)


def warmup(built, state, steps: int = 400, max_disp: float = 0.05, kT=None,
           seed: int = 7):
    """Resolve overlaps by displacement-capped steepest descent (each
    particle moves along its force by at most ``max_disp``), then draw
    Maxwell-Boltzmann velocities and recompute forces."""
    spec, cfg = built.spec, built.cfg
    for _ in range(steps):
        state = integrate.maybe_rebuild_neighbors(spec, cfg, state)
        force, _, _ = integrate.compute_forces(spec, cfg, state)
        # overflow-safe normalisation: |F| can exceed 1e21 on overlaps
        fmax = torch.amax(torch.abs(force), dim=-1, keepdim=True)
        nonzero = fmax > 0.0
        fdir = torch.where(nonzero,
                           force / torch.where(nonzero, fmax, 1.0), 0.0)
        fnorm = torch.sqrt(torch.sum(fdir**2, dim=-1, keepdim=True))
        ok = fnorm > 0.0
        unit = torch.where(ok, fdir / torch.where(ok, fnorm, 1.0), 0.0)
        step_len = torch.clamp(fmax * fnorm * 1e-4, max=max_disp)
        pos = state.pos + torch.where(state.active[:, None],
                                      unit * step_len, 0.0)
        shift = torch.floor(pos / state.box)
        state = dataclasses.replace(state, pos=pos - shift * state.box)
    tgt = float(spec.kT) if kT is None else kT
    gen = runner.make_generator(seed, state.device)
    v = torch.randn(state.vel.shape, generator=gen, dtype=state.vel.dtype,
                    device=state.device)
    v = v * torch.sqrt(tgt / state.mass)[:, None]
    v = torch.where(state.active[:, None], v, 0.0)
    mtot = torch.sum(torch.where(state.active, state.mass, 0.0))
    v = v - torch.sum(state.mass[:, None] * v, dim=0) / mtot
    v = torch.where(state.active[:, None], v, 0.0)
    state = dataclasses.replace(state, vel=v,
                                step=torch.zeros_like(state.step))
    return runner.initial_forces(spec, cfg, state)


def activate_initiators(built, systop, state, n: int = 20, seed: int = 1):
    """Flip n MA monomers to FA radicals in state 3 and switch reactions on
    (the same numpy draw as the reference)."""
    tsym = systop.atomsym_atomtype
    rng = np.random.RandomState(seed)
    type_id = state.type_id.cpu().numpy()
    rows = np.where((type_id == tsym["MA"])
                    & state.active.cpu().numpy())[0]
    picks = torch.from_numpy(rng.choice(rows, n, replace=False)).to(
        state.device)
    tid = state.type_id.clone()
    tid[picks] = tsym["FA"]
    chem = state.chem_state.clone()
    chem[picks] = 3
    return dataclasses.replace(
        state, type_id=tid, chem_state=chem,
        reactions_on=torch.ones((), dtype=torch.bool, device=state.device))
