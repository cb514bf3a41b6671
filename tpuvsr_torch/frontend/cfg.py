"""TLC .cfg model-file parser.

Grammar exercised by the corpus (all five reference cfgs, e.g.
vsr-revisited/paper/VSR.cfg): CONSTANTS bindings (model values, sets of
model values, numbers), INIT/NEXT or SPECIFICATION, VIEW, SYMMETRY,
INVARIANT and PROPERTY name lists, and \\* comments.

A copy of ``tpuvsr/frontend/cfg.py``: the port imports nothing of the
JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..core.values import ModelValue


@dataclass
class CfgModel:
    constants: dict = field(default_factory=dict)   # name -> value
    init: str = None
    next: str = None
    specification: str = None
    view: str = None
    symmetry: str = None
    invariants: list = field(default_factory=list)
    properties: list = field(default_factory=list)
    constraints: list = field(default_factory=list)


_SECTIONS = {"CONSTANTS", "CONSTANT", "INIT", "NEXT", "SPECIFICATION",
             "VIEW", "SYMMETRY", "INVARIANT", "INVARIANTS", "PROPERTY",
             "PROPERTIES", "CONSTRAINT", "CONSTRAINTS"}


def _parse_value(text: str):
    text = text.strip()
    if text.startswith("{"):
        inner = text.strip("{}").strip()
        if not inner:
            return frozenset()
        return frozenset(_parse_value(p) for p in inner.split(","))
    if text in ("TRUE", "FALSE"):
        return text == "TRUE"
    if text.lstrip("-").isdigit():
        return int(text)
    if text.startswith('"') and text.endswith('"'):
        return text[1:-1]
    return ModelValue(text)


def parse_cfg_text(src: str) -> CfgModel:
    cfg = CfgModel()
    # strip comments
    lines = []
    for raw in src.splitlines():
        idx = raw.find("\\*")
        if idx >= 0:
            raw = raw[:idx]
        if raw.strip():
            lines.append(raw.strip())

    section = None
    i = 0
    while i < len(lines):
        line = lines[i]
        head = line.split()[0]
        if head in _SECTIONS:
            section = head
            rest = line[len(head):].strip()
            i += 1
            if rest:
                _feed(cfg, section, rest)
                if section in ("INIT", "NEXT", "SPECIFICATION", "VIEW", "SYMMETRY"):
                    section = None
            continue
        if section is None:
            raise ValueError(f"cfg line outside any section: {line!r}")
        _feed(cfg, section, line)
        i += 1
    return cfg


def _feed(cfg: CfgModel, section: str, line: str):
    if section in ("CONSTANTS", "CONSTANT"):
        if "=" in line:
            name, val = line.split("=", 1)
            cfg.constants[name.strip()] = _parse_value(val)
        elif "<-" in line:
            name, val = line.split("<-", 1)
            cfg.constants[name.strip()] = _parse_value(val)
        else:
            raise ValueError(f"bad CONSTANTS line: {line!r}")
    elif section == "INIT":
        cfg.init = line.strip()
    elif section == "NEXT":
        cfg.next = line.strip()
    elif section == "SPECIFICATION":
        cfg.specification = line.strip()
    elif section == "VIEW":
        cfg.view = line.strip()
    elif section == "SYMMETRY":
        cfg.symmetry = line.strip()
    elif section in ("INVARIANT", "INVARIANTS"):
        cfg.invariants.extend(line.split())
    elif section in ("PROPERTY", "PROPERTIES"):
        cfg.properties.extend(line.split())
    elif section in ("CONSTRAINT", "CONSTRAINTS"):
        cfg.constraints.extend(line.split())


def parse_cfg_file(path: str) -> CfgModel:
    with open(path) as f:
        return parse_cfg_text(f.read())
