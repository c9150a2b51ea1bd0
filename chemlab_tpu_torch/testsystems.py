"""The test systems: the reactive trimer melts, the step-growth chain melt,
warmup and initiator activation.

Port of ``chemlab_tpu/testsystems.py``: the melt's topology text,
coordinates, reaction cfg and LJ pair tables are the port's own copies
(unchanged); ``build_melt`` (LJ), ``build_tabulated_melt`` (every type pair
a func-8 table) and ``build_mixed_tab_melt`` (func 10/12 two-table blends
on two type pairs) reproduce the reference's builds bit for bit (initial
velocities included: both draw from ``np.random.RandomState``) on the card
by default.  ``warmup`` re-draws velocities from a ``torch.Generator``, so
its velocities differ from the reference's ``jax.random`` draw.
``build_chain_melt`` (E-B-B-E tetramers linking end to end) is the port's
own input for the dihedral, 1-4, tabulated bonded and full-row reaction
paths; its text, coordinates and tables are plain functions, so the
reference can build the same system.  ``build_row_melt`` puts one
nonbonded variant of the Verlet row path on each type pair of the
charged ATRP melt (``row_topology_text``, ``write_row_tables``).
``generate_example`` writes an equilibrated melt example directory
(``python -m chemlab_tpu_torch.testsystems out_dir``, the reference's
``chemlab-genmelt``).
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
    return _build_trimer_melt(ATRP_CFG_TEXT if reactive else None, n_mols,
                              density, kT, seed, device, opt_overrides)


def melt_options(kT: float = 1.0, seed: int = 42, **opt_overrides) -> dict:
    """The trimer melts' ``SimOptions`` fields (the reference's choice:
    capacities sized for liquid density)."""
    rc_skin = 2.5 + 0.4
    k_liq = int(0.95 * 4.0 / 3.0 * np.pi * rc_skin**3 * 1.25)
    opts_kw = dict(lj_cutoff=2.5, cg_cutoff=2.5, skin=0.4, dt=0.0025, kT=kT,
                   thermostat="lv", thermostat_gamma=1.0, gen_velocity=True,
                   rng_seed=seed, max_neighbors=-(-k_liq // 8) * 8)
    opts_kw.update(opt_overrides)
    return opts_kw


def _build_trimer_melt(cfg_text, n_mols, density, kT, seed, device,
                       opt_overrides, coords=None):
    systop = compile_system_topology(topfile.parse_lines(
        _melt_topology_text(n_mols).splitlines(), "<generated>"))
    if coords is None:
        coords = melt_coordinates(n_mols, density, seed=seed)
    rcfg = (reaction_parser.parse_config_lines(cfg_text.splitlines())
            if cfg_text else None)
    built = build.build_system(
        systop, coords, build.SimOptions(**melt_options(kT, seed,
                                                        **opt_overrides)),
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


# ---- the step-growth chain melt ------------------------------------------

CHAIN_CFG_TEXT = """
[general]
interval: 200
nearest=0

[group_link]
potential=Harmonic
potential_options=K=30.0,r0=0.97

[reaction_link]
reaction: E(0, 1) + E(0, 1) -> F(1):F(1)
cutoff: 1.2
rate: 0.8
intramolecular: 0
intraresidual: 0
active: True
group: link
"""

# Ryckaert-Bellemans C0..C5 of the static E-B-B-E dihedral
CHAIN_RB = (1.0, 1.3, -0.5, -0.8, 0.0, 0.0)


def chain_topology_text(n_mols: int) -> str:
    """Linear E-B-B-E tetramers with unit LJ types: E-B harmonic and B-B
    tabulated bonds (``table_b0``), tabulated E-B-B angles (``table_a0``),
    a Ryckaert-Bellemans E-B-B-E dihedral with its 1-4 pair (fudgeLJ 0.5,
    nrexcl 3), and the types a step-growth link E + E -> F:F creates: a
    harmonic B-F-F angle, a tabulated B-F-F-B dihedral (``table_d0``), a
    harmonic n-cos F-F-B-B dihedral and, once one end of a chain has
    reacted, a harmonic (func 12) F-B-B-E dihedral by type lookup."""
    return """
[ defaults ]
1 3 no 0.5 0.5

[ atomtypes ]
  E    1.0      0.000     A        1            1
  B    1.0      0.000     A        1            1
  F    1.0      0.000     A        1            1

[ bondtypes ]
E B 1 0.97 60.0
B B 8 0

[ angletypes ]
E B B 8 0
B F F 1 120.0 6.0

[ dihedraltypes ]
E B B E 3 %s
F B B E 12 180.0 0.5
B F F B 8 0
F F B B 1 180.0 0.5 2

[ moleculetype ]
TET 3

[ atoms ]
1 E 1 TET E1 1 0.000000 1
2 B 1 TET B1 2 0.000000 1
3 B 1 TET B2 3 0.000000 1
4 E 1 TET E2 4 0.000000 1

[ bonds ]
1 2
2 3
3 4

[ angles ]
1 2 3
2 3 4

[ dihedrals ]
1 2 3 4

[ pairs ]
1 4

[ system ]
generated step-growth chain melt

[ molecules ]
TET %d
""" % (" ".join("%g" % c for c in CHAIN_RB), n_mols)


def chain_coordinates(n_mols: int, density: float, bond_r: float = 0.97,
                      seed: int = 0) -> files_io.Coordinates:
    """Place tetramers with bond angles of 120 degrees and a random
    dihedral at random positions and orientations."""
    rng = np.random.RandomState(seed)
    n = 4 * n_mols
    box_l = float((n / density) ** (1.0 / 3.0))
    box = np.array([box_l, box_l, box_l])
    s, c = np.sin(np.pi / 3), np.cos(np.pi / 3)
    v, k = np.array([s, c, 0.0]), np.array([s, -c, 0.0])
    # the third bond: the all-trans direction v turned about the middle
    # bond k by phi - 180 degrees (Rodrigues)
    alpha = rng.uniform(-np.pi, np.pi, size=(n_mols, 1)) - np.pi
    v3 = (v * np.cos(alpha) + np.cross(k, v) * np.sin(alpha)
          + k * np.dot(k, v) * (1.0 - np.cos(alpha)))
    local = np.zeros((n_mols, 4, 3))
    local[:, 1] = bond_r * v
    local[:, 2] = local[:, 1] + bond_r * k
    local[:, 3] = local[:, 2] + bond_r * v3
    local -= local.mean(axis=1, keepdims=True)
    q, _ = np.linalg.qr(rng.normal(size=(n_mols, 3, 3)))
    centers = rng.uniform(0, box_l, size=(n_mols, 3))
    pos = centers[:, None, :] + np.einsum("mij,mkj->mki", q, local)
    pos = np.mod(pos.reshape(n, 3), box)
    return files_io.Coordinates(
        title="generated chain melt",
        atom_ids=np.arange(1, n + 1),
        res_idx=np.repeat(np.arange(1, n_mols + 1), 4),
        res_names=["TET"] * n,
        atom_names=["E1", "B1", "B2", "E2"] * n_mols,
        pos=pos, vel=None, box=box)


def write_chain_tables(out_dir: str) -> None:
    """The chain melt's bonded tables in ``files_io.read_table``'s
    formats: ``table_b0.xvg`` a harmonic bond (K 60, r0 0.97; nm),
    ``table_a0.xvg`` the cosine-squared angle 30 (cos(theta) - cos(120))^2
    and ``table_d0.xvg`` the cosine dihedral 0.75 (1 + cos(2 phi)), the
    last two in degrees with F = -dE/d(degree)."""
    r = np.arange(0.002, 3.0 + 1e-9, 0.002)
    _write_table(os.path.join(out_dir, "table_b0.xvg"), r,
                 30.0 * (r - 0.97) ** 2, -60.0 * (r - 0.97))
    deg = np.arange(0.0, 180.0 + 1e-9, 0.5)
    th = np.radians(deg)
    c0 = np.cos(np.radians(120.0))
    e = 30.0 * (np.cos(th) - c0) ** 2
    f = 60.0 * (np.cos(th) - c0) * np.sin(th) * np.pi / 180.0
    _write_table(os.path.join(out_dir, "table_a0.xvg"), deg, e, f)
    deg = np.arange(-180.0, 180.0 + 1e-9, 1.0)
    ph = np.radians(deg)
    _write_table(os.path.join(out_dir, "table_d0.xvg"), deg,
                 0.75 * (1.0 + np.cos(2.0 * ph)),
                 1.5 * np.sin(2.0 * ph) * np.pi / 180.0)


def chain_options(kT: float = 1.0, seed: int = 42, table_dir: str = ".",
                  **opt_overrides) -> dict:
    """The chain melt's ``SimOptions`` fields (LJ as in ``build_melt``)."""
    opts_kw = dict(lj_cutoff=2.5, cg_cutoff=2.5, skin=0.4, dt=0.0025, kT=kT,
                   thermostat="lv", thermostat_gamma=1.0, gen_velocity=True,
                   rng_seed=seed, table_dirs=(table_dir,))
    opts_kw.update(opt_overrides)
    return opts_kw


def build_chain_melt(n_mols: int = 2500, density: float = 0.27,
                     kT: float = 1.0, reactive: bool = True, seed: int = 42,
                     table_dir: str | None = None, device="cuda",
                     **opt_overrides):
    """Build the step-growth chain melt (``chain_topology_text``; 2500
    tetramers are 10 000 particles) on ``device``; the tables go to a fresh
    temporary directory unless ``table_dir`` holds them.  Returns
    (BuiltSystem, SystemTopology, Coordinates)."""
    if table_dir is None:
        table_dir = tempfile.mkdtemp(prefix="chemlab_chain_")
        write_chain_tables(table_dir)
    systop = compile_system_topology(topfile.parse_lines(
        chain_topology_text(n_mols).splitlines(), "<generated-chain>"))
    coords = chain_coordinates(n_mols, density, seed=seed)
    rcfg = (reaction_parser.parse_config_lines(CHAIN_CFG_TEXT.splitlines())
            if reactive else None)
    opts = build.SimOptions(**chain_options(kT, seed, table_dir,
                                            **opt_overrides))
    built = build.build_system(systop, coords, opts, reaction_config=rcfg,
                               device=device)
    return built, systop, coords


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


def generate_example(out_dir: str, n_mols: int = 2000, density: float = 0.27,
                     kT: float = 1.0, seed: int = 11, equilibrate: int = 500,
                     device="cuda"):
    """Write a complete runnable example (the reference's polymer_melt.py
    workflow: generate chains, warm up, write conf.gro + topol.top + cfg).
    The melt runs on ``device``; its Langevin block draws from a
    ``torch.Generator`` seeded with ``seed``."""
    from . import writers

    os.makedirs(out_dir, exist_ok=True)
    built, systop, coords = build_melt(n_mols, density, kT=kT, seed=seed,
                                       reactive=False, device=device)
    st = runner.initial_forces(built.spec, built.cfg, built.state)
    st = warmup(built, st, steps=max(equilibrate, 100), kT=kT)
    st = runner.run_block(built.spec, built.cfg, st, equilibrate,
                          gen=runner.make_generator(seed, st.device))
    runner.synchronize(st.device)
    out = writers.state_to_coordinates(st, systop, coords)
    files_io.write_gro(os.path.join(out_dir, "conf.gro"), out, backup=False)
    with open(os.path.join(out_dir, "topol.top"), "w") as f:
        f.write(_melt_topology_text(n_mols))
    with open(os.path.join(out_dir, "atrp.cfg"), "w") as f:
        f.write(ATRP_CFG_TEXT)
    return out_dir


def _main(argv=None, device="cuda"):
    import argparse

    p = argparse.ArgumentParser(prog="chemlab-genmelt",
                                description="generate an equilibrated ATRP "
                                            "melt example directory")
    p.add_argument("out_dir")
    p.add_argument("--n_mols", type=int, default=2000)
    p.add_argument("--density", type=float, default=0.27)
    p.add_argument("--kT", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=11)
    a = p.parse_args(argv)
    generate_example(a.out_dir, a.n_mols, a.density, a.kT, a.seed,
                     device=device)
    print("wrote %s" % a.out_dir)
    return 0


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


# ---- the reaction extensions: two trimer melts -------------------------------

BREAK_CFG_TEXT = """
[general]
interval: 200
nearest=0

[ext_change_neighbour_type]
ext_type=ChangeNeighboursProperty
invoke_on=both
type_transfers=MA:2->PA,ML:1->PL(state=1),ML:2->PL(state=1)

[ext_cut_end]
ext_type=RemoveNeighboursBonds
bonds_to_remove=FA->PL:PA:1
invoke_on=type_1

[group_reaction_1]
potential=Harmonic
potential_options=K=30.0,r0=0.97
extensions=change_neighbour_type,cut_end

[reaction_a]
reaction: FA(3, 4) + MA(1, 2) -> FA(1):DA(2)
cutoff: 1.2
rate: 0.8
intramolecular: 1
intraresidual: 0
active: True
group: reaction_1

[group_restricted]
potential=Harmonic
potential_options=K=30.0,r0=0.97
connectivity_map=%(cmap)s

[reaction_b]
reaction: DA(3, 4) + MA(1, 2) -> RA(1):DA(2)
cutoff: 1.2
rate: 2.0
intramolecular: 1
intraresidual: 0
active: True
group: restricted

[group_break]
potential=Harmonic
potential_options=K=30.0,r0=0.97

[reaction_d]
reaction: MA(0, 9):ML(0, 9) -> PA(0) + PL(0)
cutoff: 50.0
rate: 0.0
diss_rate: %(diss_rate)s
alpha: 0.01
active: True
group: break
"""

RELEASE_CFG_TEXT = """
[general]
interval: 200
nearest=0

[ext_rel]
ext_type=ReleaseMolecule
host_type=MA
target_type=RA
eq_length=1.0
alpha=0.02
init_res=0.000000001
final_type=PL
replicate=1
release_on=bond
release_count=1
release_host=both

[ext_join]
ext_type=JoinMolecule
eq_length=0.97
init_res=0.000000001
final_type=PL
host_type=FA
target_type=ML

[ext_atrp]
ext_type=ATRPActivator
interval=10
num_particles=200
select_from_all=0
ratio_activator=1.0
ratio_deactivator=1.0
delta_catalyst=0.001
k_activate=0.5
k_deactivate=0.5
options=FA(3,A)->FA(1);FA(4,DA)->FA(-1)

[ext_flip]
ext_type=ChangeParticleType
interval=10
num_particles=5
type_id=0
new_type_id=2

[ext_freeze]
ext_type=FreezeRegion
target_type=ML
width=%(freeze_width)s
directions=-x,x
prob=%(freeze_prob)s
remove_particles=True

[group_g1]
potential=Harmonic
potential_options=K=30.0,r0=0.97
extensions=rel,join,atrp,flip,freeze

[reaction_a]
reaction: FA(3, 4) + ML(0, 1) -> FA(1):DA(2)
cutoff: 1.2
rate: 4.0
intramolecular: 1
active: True
group: g1
"""

RESTRICT_MAP = "restrict.list"
RESTRICT_RANGE = 2.5


def write_restrict_map(path: str, coords, type_ids, type_id: int,
                       r_max: float = RESTRICT_RANGE) -> int:
    """Write a RestrictReaction connectivity map: every pair of particles
    of ``type_id`` within ``r_max`` (minimum image) at ``coords``, 1-based
    ids.  Returns the number of pairs."""
    rows = np.where(np.asarray(type_ids) == type_id)[0]
    pos = np.asarray(coords.pos, np.float64)[rows]
    box = np.asarray(coords.box, np.float64)
    n_pairs = 0
    with open(path, "w") as out:
        for lo in range(0, len(rows), 512):
            d = pos[lo:lo + 512, None, :] - pos[None, :, :]
            d -= box * np.round(d / box)
            close = np.sum(d * d, axis=-1) <= r_max * r_max
            i, j = np.nonzero(close)
            i = i + lo
            keep = i < j
            for a, b in zip(rows[i[keep]], rows[j[keep]]):
                out.write("%d %d\n" % (a + 1, b + 1))
            n_pairs += int(keep.sum())
    return n_pairs


def build_break_melt(n_mols: int = 3334, density: float = 0.27,
                     kT: float = 1.0, seed: int = 42,
                     table_dir: str | None = None, diss_rate: float = 0.01,
                     device="cuda", **opt_overrides):
    """The trimer melt under ``BREAK_CFG_TEXT`` (3334 trimers are 10 002
    particles) with the CSVR thermostat: the ATRP forward reaction whose
    events run ChangeNeighboursProperty and RemoveNeighboursBonds (the
    sequential event scan; each event cuts the type_1 side's far PL-PA
    bond), chain growth restricted to the MA pairs of the connectivity map
    (``write_restrict_map`` at the build coordinates, into ``table_dir`` or
    a fresh temporary directory), and MA:ML dissociation at ``diss_rate``
    with a lambda fade (alpha 0.01) whose products the dynamic resolution
    fires.  Returns (BuiltSystem, SystemTopology, Coordinates)."""
    if table_dir is None:
        table_dir = tempfile.mkdtemp(prefix="chemlab_break_")
    coords = melt_coordinates(n_mols, density, seed=seed)
    systop = compile_system_topology(topfile.parse_lines(
        _melt_topology_text(n_mols).splitlines(), "<generated>"))
    write_restrict_map(os.path.join(table_dir, RESTRICT_MAP), coords,
                       systop.type_ids, systop.atomsym_atomtype["MA"])
    text = BREAK_CFG_TEXT % {"cmap": RESTRICT_MAP,
                             "diss_rate": repr(float(diss_rate))}
    overrides = dict(thermostat="vr", table_dirs=(table_dir,))
    overrides.update(opt_overrides)
    return _build_trimer_melt(text, n_mols, density, kT, seed, device,
                              overrides, coords=coords)


def build_release_melt(n_mols: int = 3334, density: float = 0.27,
                       kT: float = 1.0, seed: int = 42,
                       freeze_width: float = 0.2, freeze_prob: float = 0.002,
                       device="cuda", **opt_overrides):
    """The trimer melt under ``RELEASE_CFG_TEXT`` with Langevin: one
    ReleaseMolecule dummy per MA (3334 trimers: 6668 dummies, 16 670
    particles) released when its host reacts, the reaction's ML captured
    by JoinMolecule, an ATRPActivator cycling FA between states 3 and 4,
    ChangeParticleType flipping 5 MA to PA every 10 steps, and a
    FreezeRegion removing ML particles within ``freeze_width`` of the x
    faces with probability ``freeze_prob`` a step.  ``cell_cap`` is 48
    unless given: the build sizes it from the real particles' occupancy,
    and the invisible dummies share their cells (43 in the fullest cell of
    the 10k melt against the rule's 32).  Returns (BuiltSystem,
    SystemTopology, Coordinates)."""
    text = RELEASE_CFG_TEXT % {"freeze_width": repr(float(freeze_width)),
                               "freeze_prob": repr(float(freeze_prob))}
    overrides = dict(cell_cap=48)
    overrides.update(opt_overrides)
    return _build_trimer_melt(text, n_mols, density, kT, seed, device,
                              overrides)


# ---- an exchange reaction: a virtual channel with a neighbour transfer -------

EXCHANGE_CFG_TEXT = """
[general]
interval: 10

[group_g1]
potential=Harmonic
potential_options=K=30.0,r0=0.97

[reaction_x]
reaction: MA(1,2):ML(%(mlmin)d,%(mlmax)d) + MA(1,2) -> FA(1):DA(1) + PL(1)
cutoff: 1.5
rate: 400.0
intramolecular: 1
intraresidual: 1
active: True
group: g1
"""


def build_exchange_melt(n_mols: int = 60, density: float = 0.4,
                        seed: int = 5, ml_window=(0, 9), device="cuda",
                        **opt_overrides):
    """The trimer melt under ``EXCHANGE_CFG_TEXT`` (the reference's
    ``tests/test_exchange.py`` system): an MA bonded to an ML whose state
    lies in ``ml_window`` reacts with an MA partner within 1.5; the pair
    becomes FA:DA without a bond (a virtual channel), and the bonded ML
    becomes PL by a level-1 neighbour transfer.  Returns (BuiltSystem,
    SystemTopology, Coordinates)."""
    systop = compile_system_topology(topfile.parse_lines(
        _melt_topology_text(n_mols).splitlines(), "<generated>"))
    coords = melt_coordinates(n_mols, density, seed=seed)
    rcfg = reaction_parser.parse_config_lines((EXCHANGE_CFG_TEXT % {
        "mlmin": ml_window[0], "mlmax": ml_window[1]}).splitlines())
    opts = dict(lj_cutoff=2.5, cg_cutoff=2.5, skin=0.4, dt=0.0025, kT=1.0,
                gen_velocity=True, rng_seed=seed, max_events=16)
    opts.update(opt_overrides)
    built = build.build_system(systop, coords, build.SimOptions(**opts),
                               reaction_config=rcfg, device=device)
    return built, systop, coords


# ---- the Verlet row path: one nonbonded variant per type pair ---------------

ROW_PPS_INCR = 0.01
ROW_CAPRAD = 0.8
ROW_MAX_FORCE = 60.0
ROW_CHARGES = {"A": -0.05, "L": 0.1}


def row_topology_text(n_mols: int, x_switch: float) -> str:
    """The ATRP melt with charges (every A type -0.05, every L type +0.1:
    neutral trimers, and a product keeps its atom's charge through its
    type's) and a ``[ nonbond_params ]`` line for each row-path family:
    MA-MA func 8, MA-PA func 17 (two ranges of the MA conversion,
    switching at ``x_switch``), PA-PA func 15 (λ-scaled LJ with a force
    cap), ML-ML func 14 (ParticlePairScaling, ``ROW_PPS_INCR`` a step,
    with the same force cap: the descent holds every pair at its birth,
    and a pair it left close must not explode when its ramp starts),
    ML-PL func 13 (table capped at ``ROW_CAPRAD``) and PL-PL func 16
    (energy-capped LJ); every other pair is LJ by combination.  The three
    families without a repulsive core (below the cap, or at a pair's
    birth step) sit on like-charged pairs, where Coulomb keeps the pair
    apart: an A-L pair among them would collapse under its attraction
    (the warmup's descent holds the step, so every func-14 pair there
    stays at its birth)."""
    text = _melt_topology_text(n_mols)
    for sym in MELT_TYPES:
        q = ROW_CHARGES[sym[1]]
        text = text.replace("  %s    1.0      0.000 " % sym,
                            "  %s    1.0      %.3f " % (sym, q))
    text = text.replace("1 MA 1 MON AI 1 0.000000 1",
                        "1 MA 1 MON AI 1 -0.050000 1")
    text = text.replace("2 ML 1 MON LM 2 0.000000 1",
                        "2 ML 1 MON LM 2 0.100000 1")
    text = text.replace("3 MA 1 MON AJ 3 0.000000 1",
                        "3 MA 1 MON AJ 3 -0.050000 1")
    nb = """
[ nonbond_params ]
MA MA 8
MA PA 17 MA %d 0.0:%r:table_rowA.pot:table_rowB.pot %r:1.01:table_rowC.pot:table_rowD.pot
PA PA 15 1.0 1.0 %g
ML ML 14 table_ML_ML.pot %g %g
ML PL 13 table_ML_PL.pot %g
PL PL 16 1.0 1.0 %g
""" % (2 * n_mols, x_switch, x_switch, ROW_MAX_FORCE, ROW_PPS_INCR,
       ROW_MAX_FORCE, ROW_CAPRAD, ROW_CAPRAD)
    return text.replace("[ atomstate ]", nb + "\n[ atomstate ]")


def write_row_tables(out_dir: str) -> None:
    """The row melt's tables: the melt's LJ pair tables
    (``write_lj_pair_tables``) and the four func-17 tables, LJ of depth
    0.25, 0.12, 0.4 and 0.2."""
    write_lj_pair_tables(out_dir)
    r = np.arange(0.002, 3.0 + 0.001, 0.002)
    for name, eps in (("rowA", 0.25), ("rowB", 0.12), ("rowC", 0.4),
                      ("rowD", 0.2)):
        _write_table(os.path.join(out_dir, "table_%s.pot" % name), r,
                     *_lj_table(r, eps, 1.0))


def row_switch(n_mols: int, n_initiators: int = 20, n_events: int = 4):
    """The MA conversion at which the MA-PA blend changes its tables: that
    of the melt after ``n_initiators`` initiators and ``n_events`` MA
    conversions, so a reactive run crosses it."""
    return 1.0 - (n_initiators + n_events) / (2.0 * n_mols)


def build_row_melt(n_mols: int = 3334, density: float = 0.27,
                   kT: float = 1.0, seed: int = 42, x_switch=None,
                   table_dir: str | None = None, device="cuda",
                   **opt_overrides):
    """The ATRP trimer melt on the Verlet row path (3334 trimers are 10 002
    particles): Langevin (gamma 1), cutoffs 2.5 (LJ, tables and Coulomb),
    skin 0.4, compact matching, and one row-path family per type pair
    (``row_topology_text``), so a single step runs every branch of
    ``pair_forces.pair_forces``: LJ beside tables, the func-14 ramp, the
    func-17 multi-range blend, the caps of funcs 13 and 16, the force cap
    of func 15 and Coulomb between the charges.  The MA-PA blend switches
    its tables when the MA conversion crosses ``x_switch``.  Particle λ stays 1 here
    (the melt has no dynamic resolution), so the λ weight of func 15 is
    1; the CPU tests cover λ != 1.  ``x_switch`` defaults to
    ``row_switch(n_mols)``; the tables go to a fresh temporary directory
    unless ``table_dir`` holds them.  Returns (BuiltSystem,
    SystemTopology, Coordinates)."""
    if table_dir is None:
        table_dir = tempfile.mkdtemp(prefix="chemlab_row_")
        write_row_tables(table_dir)
    if x_switch is None:
        x_switch = row_switch(n_mols)
    systop = compile_system_topology(topfile.parse_lines(
        row_topology_text(n_mols, x_switch).splitlines(), "<generated-row>"))
    coords = melt_coordinates(n_mols, density, seed=seed)
    rcfg = reaction_parser.parse_config_lines(ATRP_CFG_TEXT.splitlines())
    overrides = dict(coulomb_cutoff=2.5, table_dirs=(table_dir,))
    overrides.update(opt_overrides)
    built = build.build_system(
        systop, coords, build.SimOptions(**melt_options(kT, seed,
                                                        **overrides)),
        reaction_config=rcfg, device=device)
    return built, systop, coords


if __name__ == "__main__":
    import sys

    sys.exit(_main())
