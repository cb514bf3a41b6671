"""The model binding the device BFS consumes (in place of
``tpuvsr/engine/spec.py:SpecModel``).

The port has no TLA+ frontend: a binding is read from a cfg file and
holds the module name, the cfg, the invariant names in cfg order, a
function that builds the dense initial states for a codec (VSR.tla's
``Init`` through ``VSRCodec.init_dense``) and the evaluated SYMMETRY
set.  Of the definitions a cfg may name, the binding knows one:
``symmValues == Permutations(Values)`` (VSR.tla:151), for VSR and for
the seven models of its analysis family (``_SYMMETRY_DEFS``).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Callable

from ..core.values import FnVal, TLAError, value_key
from ..frontend.cfg import CfgModel, parse_cfg_file

# (module, SYMMETRY name) -> the constant whose Permutations it is.  The
# family's .tla files are not in this repository: their symmValues is
# taken as VSR's Permutations(Values) (VSR.tla:151), as the JAX package's
# tests bind it for them (tests/test_st03_kernel.py:36-37).
_SYMMETRY_DEFS = {(module, "symmValues"): "Values" for module in (
    "VSR", "VR_STATE_TRANSFER", "VR_ASSUME_NEWVIEWCHANGE", "VR_INC_RESEND",
    "VR_APP_STATE", "VR_REPLICA_RECOVERY", "VR_REPLICA_RECOVERY_ASYNC_LOG",
    "VR_REPLICA_RECOVERY_CP")}


@dataclass
class SpecBinding:
    module: str
    cfg: CfgModel
    init: Callable            # codec -> list of dense state dicts
    invariants: list = field(default_factory=list)
    # the SYMMETRY set as ModelValue -> ModelValue maps, identity dropped
    symmetry_perms: list = field(default_factory=list)

    def init_dense(self, codec):
        return list(self.init(codec))


def permutations(values) -> list:
    """TLC's ``Permutations(values)`` as maps with the identity pairs (and
    the identity map) dropped, in the order ``SpecModel._symmetry_perms``
    of ``tpuvsr/engine/spec.py`` yields them: the iteration order of the
    frozenset the interpreter's ``Permutations`` builds
    (``tpuvsr/interp/evalr.py:_permutations``), which the values' hashes
    decide."""
    elems = sorted(values, key=value_key)
    perms = frozenset(FnVal(zip(elems, p))
                      for p in itertools.permutations(elems))
    out = []
    for p in perms:
        mapping = {k: v for k, v in p.items if k is not v}
        if mapping:
            out.append(mapping)
    return out


def symmetry_perms(module: str, cfg: CfgModel) -> list:
    """The cfg's SYMMETRY set evaluated for ``module`` ([] without one);
    a definition the port does not know is a loud error."""
    if not cfg.symmetry:
        return []
    const = _SYMMETRY_DEFS.get((module, cfg.symmetry))
    if const is None:
        raise TLAError(f"SYMMETRY {cfg.symmetry} not defined for module "
                       f"{module} (the port knows "
                       f"{sorted(n for m, n in _SYMMETRY_DEFS if m == module)})")
    return permutations(cfg.constants[const])


def load_binding(cfg_path: str, module: str) -> SpecBinding:
    """Bind a cfg file to the TLA+ module ``module`` (the name its spec
    declares; a cfg does not name it).  A SYMMETRY the port does not know
    for the module is a loud error (``symmetry_perms``);
    ``registry.make_model`` refuses a module with no hand model kernel (the
    port has VSR's and the analysis family's, ``models/registry._resolve``)."""
    cfg = parse_cfg_file(cfg_path)
    return SpecBinding(module=module, cfg=cfg,
                       init=lambda codec: [codec.init_dense()],
                       invariants=list(cfg.invariants),
                       symmetry_perms=symmetry_perms(module, cfg))
