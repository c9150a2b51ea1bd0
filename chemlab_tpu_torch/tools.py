"""CLI helper tools: stop-criteria grammar and counters.

The port's copy of ``chemlab_tpu/tools.py``, without ``Timers``, which
nothing calls.

Behavioral port of src/tools.py (ref: tools.py:102-180 grammar):

  ``TYPE:max:total`` / ``TYPE(state):max:total``  — conversion of one type
  ``T1+T2+...:max:total``                         — summed multi-type conversion
  ``T1-T2:max:total``                             — bond count of a reaction
                                                    group pair list
Criteria are comma-separated; a run stops as soon as ANY criterion is
reached (ref: start_simulation.py:759-770 sets stop_simulation when any
observable passes its stop value).
"""

from __future__ import annotations

import dataclasses
import logging
import re

_RE_TYPE_STATE = re.compile(r"(?P<type>[A-Za-z0-9-]+)\(?(?P<state>\d?)\)?")


class RegexpFilter(logging.Filter):
    """Pass only log records whose message or function name matches the
    regexp (ref: app_args.py:60-68; wired by --debug logger:regex)."""

    def __init__(self, regexp, name=""):
        super().__init__(name)
        self.regexp = re.compile(regexp)

    def filter(self, record):
        return bool(self.regexp.match(str(record.msg))
                    or self.regexp.match(record.funcName))


@dataclasses.dataclass
class StopCriterion:
    kind: str              # 'conversion' | 'bond_count'
    stop_value: float      # conversion fraction or absolute bond count
    obs_idx: int = -1      # conversion-observable index (kind='conversion')
    type_pair: tuple = ()  # (t1, t2) for bond counts
    label: str = ""


def parse_maximum_conversion(expr: str, systop, obs_registry):
    """Parse the --maximum_conversion grammar into StopCriterion list.

    obs_registry is the engine's ObsRegistry: conversion criteria register
    entries there so the device computes them in the fused measurement pass.
    """
    out = []
    name2type = systop.atomsym_atomtype
    for o in expr.split(","):
        type_symbols, max_number, tot_number = o.split(":")
        max_number = int(max_number)
        tot_number = int(tot_number)
        if "-" in type_symbols:
            t1, t2 = type_symbols.split("-")
            out.append(StopCriterion(
                kind="bond_count", stop_value=max_number,
                type_pair=(name2type[t1], name2type[t2]), label=o))
        else:
            entries = []
            for sym in type_symbols.split("+"):
                m = _RE_TYPE_STATE.match(sym).groupdict()
                state = int(m["state"]) if m["state"] else None
                entries.append((name2type[m["type"]], state))
            idx = obs_registry.register(entries, tot_number)
            out.append(StopCriterion(
                kind="conversion", stop_value=float(max_number) / tot_number,
                obs_idx=idx, label=o))
    return out


def criteria_reached(criteria, conversions, bond_type_counts) -> bool:
    """True as soon as ANY criterion is satisfied (reference semantics)."""
    for c in criteria:
        if c.kind == "conversion":
            if float(conversions[c.obs_idx]) >= c.stop_value:
                return True
        else:
            if float(bond_type_counts.get(tuple(sorted(c.type_pair)), 0)) \
                    >= c.stop_value:
                return True
    return False


def parse_count_types(expr: str, systop):
    """--count_types A,B -> [(label, type_id)]."""
    out = []
    for sym in expr.split(","):
        sym = sym.strip()
        out.append(("count_%s" % sym, systop.atomsym_atomtype[sym]))
    return out


def parse_count_types_state(expr: str, systop):
    """--count_types_state A:3,B:4 -> [(label, type_id, state)]."""
    out = []
    for item in expr.split(","):
        sym, state = item.split(":")
        out.append(("count_%s_%s" % (sym, state),
                    systop.atomsym_atomtype[sym.strip()], int(state)))
    return out
