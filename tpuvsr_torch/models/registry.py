"""Model registry: which modules have a hand model kernel in the port,
and how to build (codec, kernel) for a binding.

The counterpart of ``tpuvsr/models/registry.py`` for the modules
``VSR``, ``VR_STATE_TRANSFER`` (ST03), ``VR_ASSUME_NEWVIEWCHANGE``
(A01), ``VR_INC_RESEND`` (I01), ``VR_APP_STATE`` (AS04),
``VR_REPLICA_RECOVERY`` (RR05), ``VR_REPLICA_RECOVERY_ASYNC_LOG``
(AL05) and ``VR_REPLICA_RECOVERY_CP`` (CP06), with an identity-only
permutation table (``fold_symmetry=False``, what the device BFS asks
for: symmetry is reduced by ``engine/canon.py``, not folded into the
fingerprint).  The kernel
carries the binding's pack spec: the port's fingerprint kernel reads
states in the packed layout's flat lane order.
"""

from __future__ import annotations

import numpy as np

from ..analysis.widths import derive_ranges_from
from ..engine.pack import build_pack_spec


def value_perm_table(binding, codec, fold_symmetry=False):
    """``binding.symmetry_perms`` (ModelValue maps) -> ``[P, V+1]`` value-id
    table, the identity first and padding 0 fixed (a copy of
    ``tpuvsr/models/registry.py:value_perm_table``).  Without
    ``fold_symmetry`` only the identity row is emitted: the table a
    kernel whose fingerprint is not folded takes."""
    V = codec.shape.V
    rows = [np.arange(V + 1, dtype=np.int32)]
    if fold_symmetry:
        for p in binding.symmetry_perms:
            row = np.arange(V + 1, dtype=np.int32)
            for mv_from, mv_to in p.items():
                row[codec.value_id[mv_from]] = codec.value_id[mv_to]
            rows.append(row)
    return np.stack(rows)


def _resolve(module):
    """(codec class, kernel class) of a module with a hand model kernel in
    the port (``tpuvsr/models/registry.py:_resolve``, for the modules
    ported so far)."""
    if module == "VSR":
        from .vsr import VSRCodec
        from .vsr_kernel import VSRKernel
        return VSRCodec, VSRKernel
    if module == "VR_STATE_TRANSFER":
        from .st03 import ST03Codec
        from .st03_kernel import ST03Kernel
        return ST03Codec, ST03Kernel
    if module == "VR_APP_STATE":
        from .as04 import AS04Codec
        from .as04_kernel import AS04Kernel
        return AS04Codec, AS04Kernel
    if module == "VR_ASSUME_NEWVIEWCHANGE":
        from .a01 import A01Codec
        from .a01_kernel import A01Kernel
        return A01Codec, A01Kernel
    if module == "VR_INC_RESEND":
        from .i01 import I01Codec
        from .i01_kernel import I01Kernel
        return I01Codec, I01Kernel
    if module == "VR_REPLICA_RECOVERY":
        from .rr05 import RR05Codec
        from .rr05_kernel import RR05Kernel
        return RR05Codec, RR05Kernel
    if module == "VR_REPLICA_RECOVERY_ASYNC_LOG":
        from .al05 import AL05Codec
        from .al05_kernel import AL05Kernel
        return AL05Codec, AL05Kernel
    if module == "VR_REPLICA_RECOVERY_CP":
        from .cp06 import CP06Codec
        from .cp06_kernel import CP06Kernel
        return CP06Codec, CP06Kernel
    raise KeyError(f"no hand model kernel for module {module!r} in the port")


def make_model(binding, max_msgs=None):
    """(codec, kernel) for a bound spec (``engine/spec.SpecBinding``)."""
    codec_cls, kern_cls = _resolve(binding.module_name)
    constants = binding.cfg.constants
    codec = codec_cls(constants, max_msgs=max_msgs)
    pk = build_pack_spec(codec, ranges=derive_ranges_from(constants,
                                                          binding.module_name))
    return codec, kern_cls(codec, perms=value_perm_table(binding, codec),
                           pack_spec=pk)
