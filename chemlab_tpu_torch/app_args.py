"""CLI flag system with ``@params`` file support.

The port's copy of ``chemlab_tpu/app_args.py``: the same flags, names and
defaults, with help texts that describe the port.  Behavioral port of the
reference's ``MyArgParser`` (ref: src/app_args.py:29-57):
argument files contain bare ``key=value`` lines (auto-prefixed ``--``),
``#``/``;`` comments, and the effective parameters are written back to
``<output_prefix>_params.out`` so a run is reproducible with ``@file``.
"""

from __future__ import annotations

import argparse
import ast
import os


def _bool(v):
    if isinstance(v, bool):
        return v
    return bool(ast.literal_eval(str(v)))


class ParamsArgumentParser(argparse.ArgumentParser):
    """argparse with GROMACS-style ``@params`` files."""

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("fromfile_prefix_chars", "@")
        super().__init__(*args, **kwargs)

    def convert_arg_line_to_args(self, line):
        line = line.strip()
        if not line or line.startswith(("#", ";")):
            return []
        if not line.startswith("--"):
            line = "--" + line
        return [line]

    def save_to_file(self, path, namespace):
        """Write the effective parameters back out (ref: app_args.py:44-57)."""
        with open(path, "w") as f:
            f.write("# chemlab_tpu_torch effective parameters\n")
            for k in sorted(vars(namespace)):
                v = getattr(namespace, k)
                if v is not None:
                    f.write("%s=%s\n" % (k, v))


def build_parser() -> ParamsArgumentParser:
    """All simulation flags (ref: src/app_args.py:71-211, same names/defaults)."""
    p = ParamsArgumentParser(description="chemlab_tpu_torch reactive MD", add_help=True)

    g = p.add_argument_group("General options")
    g.add_argument("--conf", required=True, help="Input .gro coordinate file")
    g.add_argument("--top", "--topology", required=True, dest="top",
                   help="Topology file")
    g.add_argument("--node_grid", default=None,
                   help="Process grid, e.g. 2,2,2; its product is the "
                        "number of devices (only 1,1,1 runs in the CLI)")
    g.add_argument("--skin", default=0.16, type=float, help="Verlet skin")
    g.add_argument("--output_prefix", default="sim", help="Prefix for output files")
    g.add_argument("--output_file", default="trjout.h5", help="H5MD trajectory")
    g.add_argument("--trj_collect", default=1000, type=int,
                   help="Collect trajectory every n steps")
    g.add_argument("--energy_collect", default=1000, type=int,
                   help="Collect energy every n steps")
    g.add_argument("--topol_collect", default=1000, type=int,
                   help="Collect topology every n steps")
    g.add_argument("--reactions", default=None, help="Reaction config .cfg")
    g.add_argument("--debug", default=None, help="Enable loggers (name:regex,...)")
    g.add_argument("--check_topology", default=False, type=_bool)
    g.add_argument("--start_ar", default=0, type=int,
                   help="Step at which chemical reactions start")
    g.add_argument("--stop_ar", default=-1, type=int,
                   help="Step at which chemical reactions stop")
    g.add_argument("--table_groups", default=None,
                   help="Comma-separated atom types using tabulated potentials")
    g.add_argument("--max_force", default=-1, type=float, help="Force cap")
    g.add_argument("--rate_arrhenius", default=False, type=_bool,
                   help="Update rates from the Arrhenius equation")
    g.add_argument("--exclusion_list", default=None,
                   help="Read exclusion list from file")
    g.add_argument("--benchmark_data", default=None,
                   help="Append wall-clock benchmark rows to this file")
    g.add_argument("--system_monitor_filter", default=None,
                   help="Comma-separated observable labels to print")
    g.add_argument("--do_not_exclude_bonds", default=False, type=_bool)
    g.add_argument("--hooks", default=None,
                   help="Path to hooks.py (defaults to ./hooks.py if present; "
                        "'none' disables the auto-pickup)")
    g.add_argument("--profile_dir", default=None,
                   help="Write a torch.profiler chrome trace of the main "
                        "loop, with the engine's chemlab:: spans, here")
    g.add_argument("--retune_caps", default=-1, type=int,
                   help="Step at which to shrink neighbor capacities to the "
                        "observed occupancy (engine extra; -1 disables); "
                        "useful after equilibrating a packed start whose "
                        "initial density oversized the caps")
    g.add_argument("--presize_caps", default=False, type=_bool,
                   help="After the first reactive block, grow the term tables "
                        "ONCE to cover the whole remaining run from the "
                        "measured append rate, so capacity regrowth never "
                        "lands mid-run (engine extra; rate-aware proactive "
                        "growth remains the backstop)")
    g.add_argument("--cap_ladder", default=0, type=int,
                   help="Plan N term-capacity rungs from the measured append "
                        "rate (two reactive blocks; the later window avoids "
                        "the activation burst); mid-run capacity growth "
                        "steps up a rung and tables stay ~1/N-tight all run "
                        "(engine extra; supersedes --presize_caps when set)")
    g.add_argument("--timers", default=True, type=_bool,
                   help="Record the per-phase timing breakdown in the "
                        "_benchmark.pck (times each phase once more at the "
                        "end)")

    s = p.add_argument_group("Simulation parameters")
    s.add_argument("--kb", type=float, default=0.0083144621,
                   help="Boltzmann constant (kJ/mol/K by default)")
    s.add_argument("--mass_factor", type=float, default=1.6605402,
                   help="Mass scaling factor")
    s.add_argument("--run", type=int, default=10000, help="Total MD steps")
    s.add_argument("--int_step", default=1000, type=int, help="Steps per block")
    s.add_argument("--rng_seed", type=int, default=-1, help="RNG seed")
    s.add_argument("--thermal_groups", default=None,
                   help="Types coupled to the thermostat")
    s.add_argument("--gen_velocity", default=False, type=_bool)
    s.add_argument("--thermostat", default="lv", choices=("lv", "vr", "br", "iso", "no"))
    s.add_argument("--barostat", default="lv", choices=("lv", "br"))
    s.add_argument("--barostat_tau", default=5.0, type=float)
    s.add_argument("--barostat_mass", default=50.0, type=float)
    s.add_argument("--barostat_gammaP", default=1.0, type=float)
    s.add_argument("--thermostat_gamma", type=float, default=5.0)
    s.add_argument("--thermostat_coupling", type=int, default=1,
                   help="Rescale-thermostat coupling interval")
    s.add_argument("--temperature", default=458.0, type=float)
    s.add_argument("--pressure", type=float, default=None)
    s.add_argument("--dt", default=0.001, type=float)
    s.add_argument("--lj_cutoff", default=1.2, type=float)
    s.add_argument("--cg_cutoff", default=1.4, type=float)
    s.add_argument("--coulomb_epsilon1", default=1.0, type=float)
    s.add_argument("--coulomb_epsilon2", default=80.0, type=float)
    s.add_argument("--coulomb_kappa", default=0.0, type=float)
    s.add_argument("--coulomb_cutoff", default=0.9, type=float)

    h = p.add_argument_group("H5MD storage")
    h.add_argument("--store_species", default=True, type=_bool)
    h.add_argument("--store_state", default=True, type=_bool)
    h.add_argument("--store_position", default=True, type=_bool)
    h.add_argument("--store_lambda", default=False, type=_bool)
    h.add_argument("--store_force", default=False, type=_bool)
    h.add_argument("--store_velocity", default=False, type=_bool)
    h.add_argument("--store_charge", default=False, type=_bool)
    h.add_argument("--store_mass", default=True, type=_bool)
    h.add_argument("--store_res_id", default=True, type=_bool)
    h.add_argument("--store_pressure", default=False, type=_bool)
    h.add_argument("--store_single_precision", default=True, type=_bool)
    h.add_argument("--save_before_reaction", default=False, type=_bool)
    h.add_argument("--trj_flush", default=None, type=int)
    h.add_argument("--gro_trj_collect", default=None, type=int)
    h.add_argument("--store_angdih", default=False, type=_bool)

    m = p.add_argument_group("Maximum conversion")
    m.add_argument("--maximum_conversion", default=None,
                   help="Stop criteria, e.g. TYPE(state):max:total[,...]")
    m.add_argument("--eq_steps", default=0, type=int,
                   help="Equilibration blocks after conversion reached")
    m.add_argument("--keep_simulation", default=False, type=_bool)

    c = p.add_argument_group("Counters")
    c.add_argument("--count_types", default=None, help="Types to count, e.g. A,B")
    c.add_argument("--count_tuples", default=False, type=_bool)
    c.add_argument("--count_types_state", default=None,
                   help="Type:state pairs, e.g. A:3,B:4")
    c.add_argument("--count_fix_distances", default=False, type=_bool)

    hb = p.add_argument_group("Hybrid bonded terms")
    hb.add_argument("--t_hybrid_bond", default=0, type=int)
    hb.add_argument("--t_hybrid_angle", default=0, type=int)
    hb.add_argument("--t_hybrid_dihedral", default=0, type=int)

    cp = p.add_argument_group("Checkpointing (beyond the reference)")
    cp.add_argument("--checkpoint_interval", default=0, type=int,
                    help="Save full device state every n blocks (0 = off)")
    cp.add_argument("--restore", default=None,
                    help="Resume bit-exactly from a state .npz checkpoint")

    # ignored-for-compatibility flags accepted by the reference
    p.add_argument("--cap_force", default=False, type=_bool,
                   help=argparse.SUPPRESS)
    return p


def parse_args(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.rng_seed is None or args.rng_seed < 0:
        args.rng_seed = int.from_bytes(os.urandom(4), "little") % (2**31)
    return parser, args
