"""PyTorch/CUDA port of the device BFS of ``tpuvsr``.

The package mirrors ``tpuvsr/``'s layout and formats (FPSet ``slots``
table, packed frontier words and manifest digest) and imports nothing
of it.  Entry points run on CUDA unless the caller passes
``device="cpu"``; on the CPU every hand kernel is replaced by its plain
PyTorch version.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
