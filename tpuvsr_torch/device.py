"""Device choice for the port (the counterpart of
``tpuvsr/platform_select.py``).

Entry points run on the CUDA card unless the caller asks for the CPU.
There is no quiet fallback: a caller that names no device on a machine
without CUDA gets an error, never a CPU run it did not ask for."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The caller's device if given, else ``cuda``; raises when CUDA is
    asked for (explicitly or by default) and no CUDA device exists."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tpuvsr_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch "
            "versions on the CPU")
    return dev
