"""The level pass's edge emission (kernel K12) and the device edge
buffers it appends to.

The counterpart of the edge block of the fused body in
``tpuvsr/engine/device_bfs.py`` (:1030-1048): in an edge run
(``PagedBFS(edges=True)``) every enabled item of a tile's work queue,
fresh or duplicate, is one edge of the behaviour graph, (source gid,
action, destination gid).  After K1 inserts the tile, K11 stores each
fresh state's gid (``gid_base`` + its next-buffer row) beside its
fingerprint and looks up the destination gid of every enabled item;
K12 then appends the triples, in queue order, to ``eb_src``, ``eb_aid``
and ``eb_dst`` at ``n`` onwards, but only when the tile commits, so a
paused tile re-entered later emits each edge once.  The host drains the
buffers into ``engine/spill.EdgeCSR`` when a tile finds fewer than
``total_E`` rows of room (reason ``R_EDGE_FLUSH``) and at every chunk's
end.

``emit_edges`` takes the plain PyTorch version for CPU tensors and the
kernel of ``csrc/edge_emit.cu`` for CUDA tensors.
"""

from __future__ import annotations

import torch

from .. import kernels

I32 = torch.int32


class EdgeBuffers:
    """The device append buffer of an edge run: three int32 columns of
    ``cap`` rows, ``n`` of them filled (a host int the level pass keeps
    current), and the two gid bases of the chunk being run:
    ``src_base`` lifts a chunk row to its frontier gid, ``gid_base``
    lifts a next-buffer row to its gid."""

    def __init__(self, cap, device):
        self.cap = int(cap)
        z = lambda: torch.zeros((self.cap,), dtype=I32, device=device)
        self.src, self.aid, self.dst = z(), z(), z()
        self.n = 0
        self.src_base = 0
        self.gid_base = 0


def emit_edges_plain(eb, en, pidx, aid, dst, commit, src_off):
    """Plain version of ``emit_edges``."""
    emit = en & commit
    k = int(emit.sum())
    pos = eb.n + torch.cumsum(emit.to(torch.int64), 0) - 1
    keep = emit & (pos < eb.cap)
    idx = pos[keep]
    eb.src[idx] = (src_off + pidx[keep]).to(I32)
    eb.aid[idx] = aid[keep].to(I32)
    eb.dst[idx] = dst[keep].to(I32)
    return torch.tensor(k, dtype=I32, device=en.device)


def emit_edges(eb, en, pidx, aid, dst, commit, src_off):
    """K12 wrapper.  Append the edges of a tile's work queue to ``eb``
    (an ``EdgeBuffers``) at rows ``eb.n`` onwards: for each item where
    ``en`` ([N] bool, the actions' enabled bits) is set, in queue
    order, (``src_off`` + ``pidx``, ``aid``, ``dst``) ([N] int32 each;
    ``src_off`` = ``eb.src_base`` + the tile's first chunk row; ``dst``
    from ``lookup_gids``), and nothing unless ``commit`` (a 0-dim bool
    tensor) is set.  Rows past ``eb.cap`` are dropped.  Returns the
    count appended as a 0-dim int32 tensor; ``eb.n`` is left to the
    caller, which reads the count with the tile's other results."""
    if en.device.type == "cpu":
        return emit_edges_plain(eb, en, pidx, aid, dst, commit, src_off)
    n = en.shape[0]
    emitted = torch.empty((), dtype=I32, device=en.device)
    ck = kernels.check
    kernels.launch(
        "edge_emit", "tpuvsr_edge_emit",
        ck(en, "en", torch.bool, (n,)), ck(pidx, "pidx", I32, (n,)),
        ck(aid, "aid", I32, (n,)), ck(dst, "dst", I32, (n,)), n,
        ck(commit, "commit", torch.bool, ()), int(src_off), int(eb.n),
        eb.cap, ck(eb.src, "eb_src", I32, (eb.cap,)),
        ck(eb.aid, "eb_aid", I32, (eb.cap,)),
        ck(eb.dst, "eb_dst", I32, (eb.cap,)), emitted.data_ptr(),
        kernels.stream_of(en))
    return emitted
