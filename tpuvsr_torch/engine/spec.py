"""The model binding the device BFS consumes (in place of
``tpuvsr/engine/spec.py:SpecModel``).

The port has no TLA+ frontend: a binding is read from a cfg file and
holds the module name, the cfg, the invariant names in cfg order and a
function that builds the dense initial states for a codec (VSR.tla's
``Init`` through ``VSRCodec.init_dense``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

from ..frontend.cfg import CfgModel, parse_cfg_file


@dataclass
class SpecBinding:
    module: str
    cfg: CfgModel
    init: Callable            # codec -> list of dense state dicts
    invariants: list = field(default_factory=list)

    def init_dense(self, codec):
        return list(self.init(codec))


def load_binding(cfg_path: str) -> SpecBinding:
    """Bind a cfg file to the VSR module (the one module with a hand
    model kernel and a dense Init in the port)."""
    cfg = parse_cfg_file(cfg_path)
    return SpecBinding(module="VSR", cfg=cfg,
                       init=lambda codec: [codec.init_dense()],
                       invariants=list(cfg.invariants))
