"""Unit conventions (GROMACS-style units by default).

The port's copy of ``chemlab_tpu/units.py``, unchanged.

Reference defaults (ref: src/start_simulation.py:53-62, src/app_args.py:117-120):
  kB          = 0.0083144621 kJ/(mol K)
  mass factor = 1.6605402    (a.u. -> kg-scale used only for the density print)
  Coulomb prefactor = 138.935485 kJ mol^-1 nm e^-2  (ref: gromacs_topology.py:867)

Examples such as atrp_lj run in reduced units by setting kb=1, mass_factor=1
in the params file.
"""

KB_DEFAULT = 0.0083144621
MASS_FACTOR_DEFAULT = 1.6605402
COULOMB_PREFACTOR = 138.935485
