"""The pair-kernel choice on three grids: the dispatcher, K3d on the K2
grids, the ladder's plain versions against plain K2, and the pressure.
Port vs reference, the reference in interpret mode on the CPU, the port
through its kernels' plain versions; the grids, the helpers and the
tolerances are those of ``test_torch_ladder.py``.
"""

import jax
import numpy as np
import pytest
import torch

from chemlab_tpu.engine import integrate as rint
from chemlab_tpu.engine import pallas_pair_variants as rvar
from chemlab_tpu_torch.engine import bonded_forces, cell_pair, cell_pair_halo
from chemlab_tpu_torch.engine import cell_pair_variants as variants
from chemlab_tpu_torch.engine import integrate as pint
from chemlab_tpu_torch.engine import observables
from test_torch_ladder import (GRIDS, KIND_OF, ROUTES, _assert_close, _mixed,
                               _operands, _port, _Reference)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's tensors here are small, and pytest-xdist workers share the
    cores: one intra-op thread each avoids oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _default_kernel_choice(monkeypatch):
    """The reference reads its kernel from the environment: each test sets
    it explicitly, or finds it unset."""
    monkeypatch.delenv("CHEMLAB_KERNEL", raising=False)
    monkeypatch.delenv("CHEMLAB_PACKET", raising=False)


@pytest.fixture(scope="module")
def ref():
    return _Reference()


# ---- K3d on the K2 grids ----------------------------------------------------

@pytest.mark.parametrize("grid", ["cap36", "grid222"])
def test_k3d_on_the_k2_grids(ref, grid):
    """K3d, the one ladder kernel legal at ``cap % 8 != 0``, on the cap-36
    melt and on the 2x2x2 grid (S = 8), against the reference's
    ``_column_kernel``."""
    built, _, rst = ref.melt(grid)
    rcfg = built.cfg
    cfg, spec, st = _port(built, rst)
    assert not cell_pair.colt_legal(cfg.cell_cap, cfg.cell_dims)
    r = rvar.cell_pair_forces_columns(
        rst.pos, rst.type_id, rst.active, rst.box, rst.nbr.buckets,
        rcfg.cell_dims, built.spec, rcfg.n_types, rcfg.cell_cap,
        interpret=True, uniform_lj=rcfg.uniform_lj, z_unroll=False)
    p = variants.cell_pair_forces_columns(
        st.pos, st.type_id, st.active, st.box, st.nbr.buckets,
        st.nbr.slot_of, cfg.cell_dims, spec, cfg.n_types,
        uniform_lj=cfg.uniform_lj, z_unroll=False)
    _assert_close(p, r)




# ---- the dispatcher ---------------------------------------------------------

@pytest.mark.parametrize("name", cell_pair.PAIR_KERNELS)
@pytest.mark.parametrize("grid", GRIDS)
def test_dispatcher_matches_reference(ref, grid, name):
    """``cell_pair_forces(kernel=name)`` against the reference's
    ``cell_pair_forces`` under ``CHEMLAB_KERNEL=name``: every return value,
    so a kernel that fills both channels (K3a-K3d) must be taken on both
    sides."""
    built, _, rst = ref.melt(grid)
    cfg, spec, st = _port(built, rst)
    p = cell_pair.cell_pair_forces(
        st.pos, st.type_id, st.active, st.box, st.nbr.buckets,
        st.nbr.slot_of, cfg.cell_dims, spec, cfg.n_types,
        uniform_lj=cfg.uniform_lj, all_lj=cfg.all_lj, kernel=name)
    _assert_close(p, ref.dispatch(grid, name))
    two_channels = ROUTES[grid][name].startswith("K3")
    assert (float(p[3]) != 0.0) == two_channels


@pytest.mark.parametrize("grid", GRIDS)
def test_dispatcher_routes_by_the_reference_rule(ref, grid, monkeypatch):
    """Which kernel each name takes on each grid, recorded at the wrappers:
    the illegal geometries fall to K2, as in the reference."""
    built, _, rst = ref.melt(grid)
    cfg, spec, st = _port(built, rst)
    taken = []
    for mod, fn, tag in ((cell_pair, "colt_cells", "K1"),
                         (cell_pair, "cell_cells", "K2"),
                         (variants, "ladder_cells", None)):
        orig = getattr(mod, fn)

        def record(*a, _orig=orig, _tag=tag, **k):
            taken.append(_tag or {v: key for key, v in
                                  KIND_OF.items()}[a[0]])
            return _orig(*a, **k)
        monkeypatch.setattr(mod, fn, record)
    for name in cell_pair.PAIR_KERNELS:
        del taken[:]
        cell_pair.cell_pair_forces(
            st.pos, st.type_id, st.active, st.box, st.nbr.buckets,
            st.nbr.slot_of, cfg.cell_dims, spec, cfg.n_types,
            uniform_lj=cfg.uniform_lj, all_lj=cfg.all_lj, kernel=name)
        assert taken == [ROUTES[grid][name]], (grid, name, taken)


def test_dispatcher_refuses_what_the_reference_ignores(ref, monkeypatch):
    """Three cases the reference silently ignores raise in the port: an
    unknown name (the reference takes K2), a ladder kernel on a tabulated
    system (the reference's Chebyshev branch comes first) and a ladder
    kernel on a slab mesh (its slab path never reads the name)."""
    built, _, rst = ref.melt("melt")
    cfg, spec, st = _port(built, rst)
    args = (st.pos, st.type_id, st.active, st.box, st.nbr.buckets,
            st.nbr.slot_of, cfg.cell_dims, spec, cfg.n_types)
    with pytest.raises(ValueError, match="unknown pair kernel"):
        cell_pair.cell_pair_forces(*args, kernel="colt3")
    with pytest.raises(ValueError, match="unknown pair kernel"):
        pint.compute_forces(spec, cfg, st, pair_kernel="")
    for name in cell_pair.LADDER:
        with pytest.raises(ValueError, match="tabulated"):
            cell_pair.cell_pair_forces(*args, cheb_kw=8, kernel=name)
    monkeypatch.setattr(cell_pair_halo, "supports", lambda cfg: True)
    for name in cell_pair.LADDER:
        with pytest.raises(ValueError, match="slab mesh"):
            pint.compute_forces(spec, cfg, st, pair_kernel=name)
        with pytest.raises(ValueError, match="slab mesh"):
            pint.virial_pressure(spec, cfg, st, pair_kernel=name)




@pytest.mark.parametrize("grid", GRIDS)
def test_k3_plain_equals_k2_plain_bitwise(ref, grid):
    """Plain K3a-K3d sum the same pairs in K2's order: every channel equals
    plain K2's (its energy and virial modes) bit for bit, wherever the
    kernel takes the grid."""
    built, _, rst = ref.melt(grid)
    cfg, spec, st = _port(built, rst)
    for uniform in (True, False):
        params_spec = spec if uniform else _mixed(cfg, built.spec, spec)[1]
        ops = _operands(cfg, params_spec, st)
        k2 = [cell_pair.cell_pair_forces_cell_ref(
                  *ops, cfg.cell_dims, uniform, False, mode)
              for mode in (cell_pair.CH3_ENERGY, cell_pair.CH3_VIRIAL)]
        kinds = ["column"] + (["packet", "resident", "colz"]
                              if cfg.cell_cap % 8 == 0 else [])
        for kind in kinds:
            got = variants.ladder_cells(kind, *ops, cfg.cell_dims, uniform)
            assert torch.equal(got[..., :4], k2[0]), (kind, uniform)
            assert torch.equal(got[..., 4], k2[1][..., 3]), (kind, uniform)
            assert not got[..., 5:].any()




def test_npt_pressure_with_the_column_kernel(ref, monkeypatch):
    """One ``virial_pressure`` of the 2x2x2 NPT melt with
    ``pair_kernel="column"`` (K3c there: cap 40) against the reference's
    under ``CHEMLAB_KERNEL=column``."""
    built, _, rst = ref.melt("grid222")
    rcfg, rspec = built.cfg, built.spec
    cfg, spec, st = _port(built, rst)
    assert cfg.barostat == "br"
    monkeypatch.setenv("CHEMLAB_KERNEL", "column")
    p_r = float(jax.jit(lambda s: rint.virial_pressure(rspec, rcfg, s))(rst))
    p_p = float(pint.virial_pressure(spec, cfg, st, pair_kernel="column"))
    w_all = float(variants.cell_pair_forces_columns(
        st.pos, st.type_id, st.active, st.box, st.nbr.buckets,
        st.nbr.slot_of, cfg.cell_dims, spec, cfg.n_types,
        uniform_lj=cfg.uniform_lj)[3])
    w_pair = w_all - float(pint._excl_correction(spec, cfg, st, None)[3])
    w_bond = -float(bonded_forces.bonded_strain_derivative(
        spec, cfg, st.pos, st.box, st.type_id, st.q, st.bonds, st.angles,
        st.dihedrals, st.pairs14, dense=pint._dense_of(cfg, st)))
    vol = float(np.prod(np.asarray(rst.box, np.float64)))
    ekin = float(observables.kinetic_energy(st.mass, st.vel, st.active))
    w_ref = 3.0 * vol * p_r - 2.0 * ekin
    w_port = 3.0 * vol * p_p - 2.0 * ekin
    assert w_pair != 0.0
    assert abs(w_port - w_ref) <= 2e-5 * (1.0 + abs(w_pair) + abs(w_bond)), \
        (w_port, w_ref, w_pair, w_bond)
    # the same pressure as the default kernel (K2 on this grid)
    p_auto = float(pint.virial_pressure(spec, cfg, st))
    assert abs(p_p - p_auto) <= 1e-5 * (1.0 + abs(p_auto))
