"""Reference-hooks compatibility layer.

The reference loads per-example ``hooks.py`` plugins via ``execfile``
(ref: src/start_simulation.py:220-228) and calls them with the espressopp
engine objects (ref: :272, :726, :749, :783, :800). The shipped example
hooks are *Python 2* sources (``examples/atrp_lj/hooks.py:91`` has a bare
``print res_ids``) that ``import espressopp`` and drive
``system.storage.{particleExists,getParticle,modifyParticle,decompose}``,
``espressopp.analysis.MaxPID`` / ``AngleDistribution`` and
``topol.atomsym_atomtype`` / ``topol.gt.atomtypes``.

Port of ``chemlab_tpu/hooks_compat.py``: this module lets those files run
unchanged against the port:

* :func:`py2_to_py3` — source-level translation of Python-2 print
  statements (lib2to3 ``fix_print`` with a regex fallback), applied only
  when the original source fails to compile.
* :func:`install_espp_shim` — registers a stand-in ``espressopp`` module
  in ``sys.modules`` exposing the analysis observables the shipped hooks
  use, backed by :mod:`chemlab_tpu_torch.engine.observables`.
* :class:`HookSession` — adapters mapping the espressopp call signature
  ``(system, integrator, ar, topol, args)`` onto a
  :class:`~chemlab_tpu_torch.start_simulation.SimulationContext`.
  Particle edits are buffered in host numpy snapshots and written back to
  the state, on the state's device, once per hook invocation (one tensor
  per dirty field instead of one write per ``modifyParticle`` call).
"""

from __future__ import annotations

import logging
import re
import sys
import types

import numpy as np
import torch

from .engine import build

logger = logging.getLogger("chemlab.hooks_compat")

_PRINT_STMT = re.compile(r"^(\s*)print\s+([^(\s=].*)$", re.M)


def py2_to_py3(src: str, filename: str = "<hooks>") -> str | None:
    """Return a compilable version of ``src``, translating Python-2 print
    statements if needed. Returns None when translation fails."""
    try:
        compile(src, filename, "exec")
        return src
    except SyntaxError:
        pass
    # Preferred: lib2to3's print fixer (handles trailing commas, >> etc.).
    try:
        import warnings
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            from lib2to3.refactor import RefactoringTool
            tool = RefactoringTool(["lib2to3.fixes.fix_print"])
            out = str(tool.refactor_string(src if src.endswith("\n") else src + "\n",
                                           filename))
        compile(out, filename, "exec")
        logger.info("translated Python-2 hook source %s (lib2to3 fix_print)",
                    filename)
        return out
    except Exception:
        pass
    # Fallback: rewrite bare `print expr` lines only.
    out = _PRINT_STMT.sub(r"\1print(\2)", src)
    try:
        compile(out, filename, "exec")
        logger.info("translated Python-2 hook source %s (regex print fix)",
                    filename)
        return out
    except SyntaxError as exc:
        logger.warning("cannot translate hook source %s: %s — hooks skipped",
                       filename, exc)
        return None


class _RandomCompat:
    """``random`` proxy restoring Python-2 semantics the shipped hooks rely
    on: ``random.sample`` accepted sets (ref: examples/atrp_lj/hooks.py:53);
    Python 3.11+ raises TypeError. Scoped to the hook namespace only."""

    def __getattr__(self, name):
        import random
        return getattr(random, name)

    def sample(self, population, k, **kw):
        import random
        if isinstance(population, (set, frozenset, dict)):
            population = sorted(population)
        return random.sample(population, k, **kw)


def patch_namespace(ns: dict) -> dict:
    """Swap py2-incompatible stdlib modules in an exec'd hook namespace."""
    import random
    if ns.get("random") is random:
        ns["random"] = _RandomCompat()
    return ns


# ---------------------------------------------------------------------------
# espressopp stand-in module


class _MaxPID:
    """espressopp.analysis.MaxPID — highest particle id in the store."""

    def __init__(self, system):
        self._system = system

    def compute(self):
        return self._system.storage.max_pid


class _AngleDistribution:
    """espressopp.analysis.AngleDistribution over the live angle table."""

    def __init__(self, system):
        self._system = system

    def load_from_topology_manager(self, tm):  # table is already live
        return None

    def compute(self, n_bins=180):
        from .engine import observables
        st = self._system._ctx.device_state
        hist = observables.angle_distribution(st.pos, st.box, st.angles,
                                              int(n_bins))
        return hist.cpu().numpy().astype(float)


def install_espp_shim():
    """Register a minimal ``espressopp`` module so reference hook files can
    ``import espressopp``. No-op when one is already importable."""
    if "espressopp" in sys.modules:
        return sys.modules["espressopp"]
    mod = types.ModuleType("espressopp")
    mod.__doc__ = ("chemlab_tpu_torch stand-in for the espressopp engine "
                   "(hooks only)")
    analysis = types.ModuleType("espressopp.analysis")
    analysis.MaxPID = _MaxPID
    analysis.AngleDistribution = _AngleDistribution
    mod.analysis = analysis
    mod.Real3D = lambda *a: np.asarray(a if len(a) > 1 else a[0], dtype=float)
    sys.modules["espressopp"] = mod
    sys.modules["espressopp.analysis"] = analysis
    return mod


# ---------------------------------------------------------------------------
# system / topology adapters


class _ParticleView:
    """Snapshot of one particle (reference hooks mutate the local copy and
    persist via modifyParticle, so copy semantics match)."""

    __slots__ = ("id", "type", "mass", "q", "state", "res_id", "lambda_adr",
                 "pos", "v")

    def __init__(self, pid, store):
        row = pid - 1
        self.id = pid
        self.type = int(store.type_id[row])
        self.mass = float(store.mass[row])
        self.q = float(store.q[row])
        self.state = int(store.chem_state[row])
        self.res_id = int(store.res_id[row])
        self.lambda_adr = float(store.lam[row])
        self.pos = store.pos[row].copy()
        self.v = store.vel[row].copy()


_PROP_FIELD = {"type": "type_id", "state": "chem_state", "mass": "mass",
               "q": "q", "lambda_adr": "lam", "res_id": "res_id",
               "pos": "pos", "v": "vel"}


class _StorageAdapter:
    """system.storage over host numpy snapshots of the MDState arrays."""

    def __init__(self, ctx):
        self._ctx = ctx
        st = ctx.device_state
        self.active = st.active.cpu().numpy()
        for field in set(_PROP_FIELD.values()):
            setattr(self, field, getattr(st, field).cpu().numpy().copy())
        self._dirty = set()
        rows = np.nonzero(self.active)[0]
        self.max_pid = int(rows[-1]) + 1 if rows.size else 0

    def particleExists(self, pid):
        return 1 <= pid <= self.active.shape[0] and bool(self.active[pid - 1])

    def getParticle(self, pid):
        if not self.particleExists(pid):
            raise KeyError("particle %d does not exist" % pid)
        return _ParticleView(pid, self)

    def modifyParticle(self, pid, prop, value):
        field = _PROP_FIELD.get(prop)
        if field is None:
            raise ValueError("unknown particle property %r" % prop)
        arr = getattr(self, field)
        arr[pid - 1] = np.asarray(value, dtype=arr.dtype)
        self._dirty.add(field)

    def decompose(self):  # resort/migration is implicit on device
        return None

    def commit(self):
        """Write the dirty fields back into the context's state, on its
        device (one upload each)."""
        if not self._dirty:
            return
        import dataclasses
        if "q" in self._dirty:
            build.refuse_charges(self._ctx.built.spec, self.q)
        st = self._ctx.device_state
        updates = {f: torch.as_tensor(getattr(self, f),
                                      dtype=getattr(st, f).dtype,
                                      device=st.device)
                   for f in self._dirty}
        self._ctx.device_state = dataclasses.replace(st, **updates)
        self._dirty.clear()


class _SystemAdapter:
    def __init__(self, ctx):
        self._ctx = ctx
        self.storage = _StorageAdapter(ctx)
        self.topology_manager = object()  # opaque token for load_from_topology_manager


class _GtAdapter:
    """topol.gt — the raw GROMACS topology (atomtypes records)."""

    def __init__(self, systop):
        self.atomtypes = systop.top.atomtypes


class _TopolAdapter:
    """The reference's GromacsTopology as hooks see it."""

    def __init__(self, systop):
        self.atomsym_atomtype = systop.atomsym_atomtype
        self.gt = _GtAdapter(systop)


class HookSession:
    """One reference-style hook invocation: build adapters, call, commit."""

    def __init__(self, ctx):
        self.ctx = ctx
        self.system = _SystemAdapter(ctx)
        self.topol = _TopolAdapter(ctx.systop)
        self.integrator = types.SimpleNamespace(step=ctx.step)
        self.ar = types.SimpleNamespace()  # ChemicalReaction ext placeholder
        self.args = ctx.args

    # positional layouts per hook, matching the reference call sites
    # (ref: start_simulation.py:272,726,749,783,800)
    def argv(self, name, *extra):
        s = self
        table = {
            "hook_init_reaction": (s.system, s.integrator, s.ar, s.topol, s.args),
            "hook_postsetup_reaction": (s.system, s.integrator, s.topol, s.args, s.ar),
            "hook_before_sim": (s.system, s.integrator, s.ar, s.topol),
            "hook_at_step": (s.system, s.integrator, s.ar, s.topol, s.args) + extra,
            "hook_end": (s.system, s.integrator, s.ar, s.topol, s.args),
        }
        return table[name]

    def commit(self):
        self.system.storage.commit()
