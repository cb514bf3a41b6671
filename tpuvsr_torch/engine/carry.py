"""State carried across from the JAX package, as numpy arrays.

The port keeps the JAX package's formats, so its FPSet and packed
frontier load here without conversion of content: ``slots`` uint32
words become int32 bit patterns, and a packed frontier is accepted only
under the same packing manifest digest.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.values import TLAError
from ..device import resolve_device


def table_from_numpy(slots, device=None):
    """A JAX FPSet ``slots`` array ([CAP, 5] uint32) -> the port's
    table on ``device`` (CUDA unless the caller asks for the CPU)."""
    s = np.ascontiguousarray(np.asarray(slots, np.uint32))
    if s.ndim != 2 or s.shape[1] != 5 or s.shape[0] & (s.shape[0] - 1):
        raise TLAError(f"not an FPSet slots array: shape {s.shape}")
    return {"slots": torch.from_numpy(s.view(np.int32).copy()).to(
        resolve_device(device))}


def frontier_from_numpy(rows, manifest, pack_spec, device=None):
    """A packed frontier ([N, words] uint32) written under ``manifest``
    -> the port's packed frontier tensor; refused when the manifest's
    digest is not the port's layout digest (``pack_spec.version``)."""
    if manifest.get("version") != pack_spec.version or \
            manifest.get("words") != pack_spec.words:
        raise TLAError(
            f"packed frontier manifest {manifest.get('version')} / "
            f"{manifest.get('words')} words does not match this layout "
            f"({pack_spec.version} / {pack_spec.words} words)")
    w = np.ascontiguousarray(np.asarray(rows, np.uint32))
    if w.ndim != 2 or w.shape[1] != pack_spec.words:
        raise TLAError(f"packed frontier has shape {w.shape}, expected "
                       f"[N, {pack_spec.words}]")
    return torch.from_numpy(w.view(np.int32).copy()).to(
        resolve_device(device))
