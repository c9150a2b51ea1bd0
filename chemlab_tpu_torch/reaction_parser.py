"""Reaction configuration (.cfg INI) parser.

The port's own copy of ``chemlab_tpu/reaction_parser.py`` (unchanged
apart from this note), so that the port imports nothing of the JAX package.

Implements the three equation grammars and the section layout of the
reference (ref: src/chemlab/reaction_parser.py):

  normal       ``A(min,max) + B(min,max) -> A'(dA):B'(dB)``       (:36-66)
  dissociation ``A(min,max):B(min,max) -> A'(dA) + B'(dB)``       (:69-94)
  exchange     ``A(min,max):B(min,max) + C(min,max) ->
                 A'(dA):C'(dC) + B'(dB)``                          (:97-127)

Sections: ``[general]``, ``[group_*]``, ``[ext_*]``, ``[reaction_*]``
(:189-266).  Unlike the reference, option values are parsed with
``ast.literal_eval``-style safe coercion, never ``eval``.
"""

from __future__ import annotations

import ast
import configparser
import re

REACTION_NORMAL = "normal"
REACTION_DISSOCATION = "diss"
REACTION_EXCHANGE = "exchange"
EXT_POSTPROCESS = "PP"
EXT_INTEGRATOR = "Integrator"

_RE_REACTANT = re.compile(r"(?P<name>\w+)\((?P<min>\d+),\s*(?P<max>\d+)\)")
_RE_PRODUCT = re.compile(r"(?P<name>\w+)\((?P<delta>[0-9-]+)\)")


def _bool(value, default=False):
    """Safe truthiness for config strings ('1', 'true', 'False', ...)."""
    if value is None:
        return default
    if isinstance(value, bool):
        return value
    s = str(value).strip()
    try:
        return bool(ast.literal_eval(s))
    except (ValueError, SyntaxError):
        return s.lower() in ("true", "yes", "on", "1")


def _reactant(text: str) -> dict:
    # fullmatch: a prefix match would let one grammar silently accept a
    # malformed/other-grammar equation (e.g. dissociation consuming an
    # exchange LHS)
    m = _RE_REACTANT.fullmatch(text.strip())
    if m is None:
        raise ValueError("cannot parse reactant %r" % text)
    d = m.groupdict()
    d["min"] = int(d["min"])
    d["max"] = int(d["max"])
    return d


def _product(text: str) -> dict:
    m = _RE_PRODUCT.fullmatch(text.strip())
    if m is None:
        raise ValueError("cannot parse product %r" % text)
    d = m.groupdict()
    d["delta"] = int(d["delta"])
    return d


def parse_equation(equation: str):
    """Normal association: ``A(min,max) + B(min,max) -> A'(dA):B'(dB)``."""
    lhs, rhs = equation.split("->")
    r1, r2 = [_reactant(x) for x in lhs.split("+")]
    p1, p2 = [_product(x) for x in rhs.split(":")]
    for r, p in ((r1, p1), (r2, p2)):
        r["delta"] = p["delta"]
        r["new_type"] = p["name"]
    return {"type_1": r1, "type_2": r2}, REACTION_NORMAL


def parse_reverse_equation(equation: str):
    """Dissociation: ``A(min,max):B(min,max) -> A'(dA) + B'(dB)``."""
    lhs, rhs = equation.split("->")
    r1, r2 = [_reactant(x) for x in lhs.split(":")]
    p1, p2 = [_product(x) for x in rhs.split("+")]
    for r, p in ((r1, p1), (r2, p2)):
        r["delta"] = p["delta"]
        r["new_type"] = p["name"]
    return {"type_1": r1, "type_2": r2}, REACTION_DISSOCATION


def parse_exchange_equation(equation: str):
    """Exchange: ``A(..):B(..) + C(..) -> A'(dA):C'(dC) + B'(dB)``.

    type_1 = A (bonded reactant), type_2 = B (its bonded partner, constraint
    and neighbour-property target), type_3 = C (the incoming partner)
    (ref: reaction_parser.py:97-127, reaction_setup.py:167-255).
    """
    lhs, rhs = equation.split("->")
    pair, single = lhs.split("+")
    r1, r2 = [_reactant(x) for x in pair.split(":")]
    r3 = _reactant(single)
    prod_pair, prod_single = rhs.split("+")
    p1, p3 = [_product(x) for x in prod_pair.split(":")]
    p2 = _product(prod_single)
    for r, p in ((r1, p1), (r2, p2), (r3, p3)):
        r["delta"] = p["delta"]
        r["new_type"] = p["name"]
    return {"type_1": r1, "type_2": r2, "type_3": r3}, REACTION_EXCHANGE


def process_reaction(items) -> tuple:
    """Process one ``[reaction_*]`` section into (group_name, data dict)
    (ref: reaction_parser.py:130-186)."""
    cfg = dict(items)
    data = {
        "rate": float(cfg["rate"]),
        "intramolecular": _bool(cfg.get("intramolecular")),
        "intraresidual": _bool(cfg.get("intraresidual")),
        "virtual": _bool(cfg.get("virtual")),
        "exclude_extensions": set(),
        "equation": cfg["reaction"],
    }
    if "exclude_extensions" in cfg:
        data["exclude_extensions"] = {s.strip() for s in cfg["exclude_extensions"].split(",")}

    reactant_list = reaction_type = None
    for parser in (parse_equation, parse_reverse_equation, parse_exchange_equation):
        try:
            reactant_list, reaction_type = parser(cfg["reaction"])
            break
        except (ValueError, IndexError):
            continue
    if reaction_type is None:
        raise ValueError("could not parse reaction equation: %s" % cfg["reaction"])
    data["reactant_list"] = reactant_list
    data["reaction_type"] = reaction_type

    if "min_cutoff" in cfg:
        data["min_cutoff"] = float(cfg["min_cutoff"])
    if "sigma" in cfg and "eq_distance" in cfg:
        data["sigma"] = float(cfg["sigma"])
        data["eq_distance"] = float(cfg["eq_distance"])
    elif "cutoff" in cfg:
        data["cutoff"] = float(cfg["cutoff"])
    else:
        raise ValueError("no cutoff defined for reaction: %s" % cfg["reaction"])

    if reaction_type == REACTION_DISSOCATION:
        if "diss_rate" in cfg:
            data["diss_rate"] = float(cfg["diss_rate"])
        data["alpha"] = float(cfg["alpha"])

    data["active"] = _bool(cfg.get("active"), default=True)
    return cfg["group"], data


def process_general(items) -> dict:
    """``[general]`` section (ref: reaction_parser.py:189-200)."""
    cfg = dict(items)
    return {
        "interval": int(cfg["interval"]),
        "nearest": _bool(cfg.get("nearest")),
        "pair_distances_filename": cfg.get("pair_distances_filename"),
        "max_per_interval": int(cfg.get("max_per_interval", -1)),
    }


def process_group(items) -> dict:
    """``[group_*]`` section (ref: reaction_parser.py:203-223)."""
    cfg = dict(items)
    group = {
        "reaction_list": [],
        "connectivity_map": cfg.get("connectivity_map"),
        "extensions": {},
    }
    if "extensions" in cfg:
        group["extensions"] = {s.strip(): None for s in cfg["extensions"].split(",")}
    if "potential" in cfg:
        group["potential"] = cfg["potential"]
        group["potential_options"] = dict(
            s.split("=") for s in cfg["potential_options"].split(",")
        )
    if "eq_length" in cfg:
        group["eq_length"] = float(cfg["eq_length"])
        group["final_type"] = cfg["final_type"]
        group["alpha"] = float(cfg["alpha"])
    return group


def process_extension(items) -> dict:
    """``[ext_*]`` section (ref: reaction_parser.py:226-232)."""
    cfg = dict(items)
    ext_class = cfg.pop("ext_type")
    return {"class": ext_class, "options": cfg}


def parse_config(input_file: str) -> dict:
    """Parse a full .cfg file (ref: reaction_parser.py:235-266).

    Groups must come before the reactions that reference them; extension
    sections may appear anywhere before their group.
    """
    parser = configparser.ConfigParser(strict=False, inline_comment_prefixes=("#", ";"))
    # ConfigParser.read() silently ignores missing files; a typo'd path must
    # fail loudly, not surface later as an empty-config TypeError
    with open(input_file) as f:
        parser.read_file(f)
    return _process_parsed_config(parser)


def parse_config_lines(lines) -> dict:
    """Parse reaction config from in-memory text (generated test systems)."""
    parser = configparser.ConfigParser(strict=False, inline_comment_prefixes=("#", ";"))
    parser.read_string("\n".join(lines))
    return _process_parsed_config(parser)


def _process_parsed_config(parser) -> dict:
    config = {"general": None, "reactions": {}}
    extensions = {}
    deferred_reactions = []

    for section in parser.sections():
        items = parser.items(section)
        if section == "general":
            config["general"] = process_general(items)
        elif section.startswith("ext_"):
            name = section[len("ext_"):].strip()
            if name in extensions:
                raise ValueError("duplicate extension name %s" % name)
            extensions[name] = process_extension(items)
        elif section.startswith("group_"):
            name = section[len("group_"):].strip()
            if name not in config["reactions"]:
                config["reactions"][name] = process_group(items)
        elif section.startswith("reaction_"):
            deferred_reactions.append(process_reaction(items))

    # Resolve extension references now that all ext_ sections are read.
    for group in config["reactions"].values():
        for ext_name in group["extensions"]:
            if ext_name not in extensions:
                raise ValueError("extension %s not defined" % ext_name)
            group["extensions"][ext_name] = extensions[ext_name]

    for group_name, data in deferred_reactions:
        if group_name not in config["reactions"]:
            raise ValueError("reaction refers to unknown group %s" % group_name)
        config["reactions"][group_name]["reaction_list"].append(data)
    return config
