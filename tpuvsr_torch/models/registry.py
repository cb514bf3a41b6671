"""Model registry: which modules have a hand model kernel in the port,
and how to build (codec, kernel) for a binding.

The counterpart of ``tpuvsr/models/registry.py`` for the ``VSR`` module
only, with an identity-only permutation table (``fold_symmetry=False``,
what the device BFS asks for).  The kernel carries the binding's pack
spec: the port's fingerprint kernel reads states in the packed layout's
flat lane order.
"""

from __future__ import annotations

import numpy as np

from ..analysis.widths import derive_ranges_from
from ..engine.pack import build_pack_spec


def make_model(binding, max_msgs=None):
    """(codec, kernel) for a bound spec (``engine/spec.SpecBinding``)."""
    if binding.module != "VSR":
        raise KeyError(f"no hand model kernel for module "
                       f"{binding.module!r} in the port")
    from .vsr import VSRCodec
    from .vsr_kernel import VSRKernel
    constants = binding.cfg.constants
    codec = VSRCodec(constants, max_msgs=max_msgs)
    pk = build_pack_spec(codec, ranges=derive_ranges_from(constants, "VSR"))
    perms = np.arange(codec.shape.V + 1, dtype=np.int32)[None, :]
    return codec, VSRKernel(codec, perms=perms, pack_spec=pk)
