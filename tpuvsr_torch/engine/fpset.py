"""Device-resident fingerprint set, and kernels K1 (insert) and K2
(batch dedup).

The same table as ``tpuvsr/engine/fpset.py``: one ``slots[CAP, 5]``
table of uint32 words (kept here as int32 bit patterns) with columns
(tag, row0, row1, row2, claim) — tag is fingerprint word 0 remapped
0 -> 1 (0 marks an empty slot), row0..2 are words 1..3, claim holds the
batch lane that inserted the slot — linear probing from ``_slot_hash``
of the keyed fingerprint, at most ``MAX_PROBES`` probes.  A table
written by the JAX package answers queries here unchanged
(``engine/carry.py``).

Unlike the JAX functions, ``insert_core`` updates the table IN PLACE
(the table is the largest object on the card: 1.3 GB at 2^26 slots)
and returns the same dict.

A table may carry a gid column, ``table["gids"]``: a separate
``int32[CAP]`` tensor, -1 where nothing was stored, that holds the graph
node id of the fingerprint in each slot (the streamed behaviour graph of
``engine/paged_bfs.py``).  ``store_gids`` writes it, ``lookup_gids``
reads it, ``insert_gids`` is an insert then a store, and ``grow`` carries
it to the larger table.

The wrappers ``insert_core`` (K1), ``dedup_keep`` (K2), ``store_gids``,
``lookup_gids`` and ``query_core`` (K11) take the plain PyTorch versions
for CPU tensors and the kernels of ``csrc/fpset_insert.cu``,
``csrc/dedup.cu`` and ``csrc/fpset_gids.cu`` for CUDA tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from .pack import MASK32, to_i32, to_u32

MAX_PROBES = 64
# K2's one-block path takes batches up to this size (csrc/dedup.cu
# BLOCK_MAX: a table of 2 x 8,192 slots fills 128 KB of shared memory)
DEDUP_BLOCK_MAX = 8192


def empty_table(capacity: int, device):
    """capacity must be a power of two."""
    if capacity & (capacity - 1):
        raise ValueError(f"FPSet capacity {capacity} is not a power of 2")
    return {"slots": torch.zeros((capacity, 5), dtype=torch.int32,
                                 device=device)}


def mul32(a: torch.Tensor, c) -> torch.Tensor:
    """(a * c) mod 2^32 for int64 a, c in [0, 2^32) (c a tensor or an
    int), without leaving int64 range: c is split in 16-bit halves."""
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & MASK32


def _slot_hash(k: torch.Tensor) -> torch.Tensor:
    """[B, 4] int64 words in [0, 2^32) -> [B] probe start (int64)."""
    h = k[:, 0] ^ mul32(k[:, 1], 0x9E3779B1)
    h = h ^ mul32(k[:, 2], 0x85EBCA6B) ^ (k[:, 3] >> 5)
    h = h ^ (h >> 15)
    return mul32(h, 0x27D4EB2F)


def _keyed(fps: torch.Tensor):
    """Canonical (tag, row) words as int64 in [0, 2^32), and the probe
    start: word 0 remapped 0 -> 1 so 0 can mark empty slots."""
    k = to_u32(fps)
    k[:, 0] = torch.where(k[:, 0] == 0, 1, k[:, 0])
    return k, _slot_hash(k)


# ----------------------------------------------------------------------
# K2: batch dedup
# ----------------------------------------------------------------------
def dedup_batch(fps: torch.Tensor, mask: torch.Tensor):
    """Plain version with the JAX contract: returns (perm, keep) where
    ``perm`` sorts the batch so equal fingerprints are adjacent
    (masked-out lanes sort to the end) and ``keep[i]`` marks lanes of
    ``fps[perm]`` that are valid first occurrences."""
    key = [torch.where(mask, to_u32(fps[:, i]), MASK32) for i in range(4)]
    perm = torch.arange(fps.shape[0], device=fps.device)
    for k in (key[3], key[2], key[1], key[0]):   # lexsort: last = major
        perm = perm[torch.argsort(k[perm], stable=True)]
    sfps = fps[perm]
    neq = (sfps[1:] != sfps[:-1]).any(dim=1)
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=fps.device),
                       neq])
    return perm, first & mask[perm]


def dedup_keep(fps: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """K2 wrapper: the first-occurrence keep mask in QUEUE order, i.e.
    ``zeros.at[perm].set(keep)`` of ``dedup_batch`` (what the fused
    commit consumes, device_bfs.py:937-938).  On the card a batch of at
    most ``DEDUP_BLOCK_MAX`` lanes is one launch with no scratch; a
    larger one two launches over a scratch hash allocated here."""
    if fps.device.type == "cpu":
        perm, keep = dedup_batch(fps, mask)
        out = torch.zeros_like(mask)
        out[perm] = keep
        return out
    return _dedup_kernel(fps, mask)


def _dedup_kernel(fps, mask):
    n = fps.shape[0]
    keep = torch.empty((n,), dtype=torch.bool, device=fps.device)
    ck = kernels.check
    args = (ck(fps, "fps", torch.int32, (n, 4)),
            ck(mask, "mask", torch.bool, (n,)), n, keep.data_ptr())
    if n <= DEDUP_BLOCK_MAX:
        # one block, its hash table in shared memory: no scratch
        kernels.launch("dedup_batch", "tpuvsr_dedup_batch", *args,
                       None, None, None, 0, None, kernels.stream_of(fps))
        return keep
    hcap = 64
    while hcap < 2 * n:
        hcap *= 2
    dev = fps.device
    hkeys = torch.empty((hcap, 4), dtype=torch.int32, device=dev)
    hstate = torch.empty((hcap,), dtype=torch.int32, device=dev)
    hmin = torch.empty((hcap,), dtype=torch.int32, device=dev)
    lane_slot = torch.empty((n,), dtype=torch.int32, device=dev)
    kernels.launch(
        "dedup_batch", "tpuvsr_dedup_batch", *args, hkeys.data_ptr(),
        hstate.data_ptr(), hmin.data_ptr(), hcap, lane_slot.data_ptr(),
        kernels.stream_of(fps))
    return keep


# ----------------------------------------------------------------------
# K1: insert
# ----------------------------------------------------------------------
def insert_core_plain(table, fps, mask):
    """Plain version of ``insert_core``: the JAX claim-then-verify pass,
    all lanes in lock step.  In a probe round every unresolved lane that
    sees an empty slot claims it; among lanes claiming one slot in the
    same round the highest lane id wins (the JAX scatter's last writer
    on the CPU); a lane that reads back its own (tag, row) under another
    lane's claim resolves as a duplicate."""
    slots = table["slots"]
    capm = slots.shape[0] - 1
    keyed, h0 = _keyed(fps)
    n = fps.shape[0]
    dev = fps.device
    lane = torch.arange(n, dtype=torch.int64, device=dev)
    payload = to_i32(torch.cat([keyed, lane[:, None]], dim=1))
    unresolved = mask.clone()
    fresh = torch.zeros_like(mask)
    for t in range(MAX_PROBES):
        if not bool(unresolved.any()):
            break
        idx = (h0 + t) & capm
        cur = slots[idx]
        mine = (to_u32(cur[:, :4]) == keyed).all(dim=1)
        dup = unresolved & mine
        empty = unresolved & (cur[:, 0] == 0)
        # one winner per claimed slot: the highest claiming lane
        e_idx, e_lane = idx[empty], lane[empty]
        order = torch.argsort(e_idx * n + e_lane)
        s_idx, s_lane = e_idx[order], e_lane[order]
        last = torch.ones_like(s_idx, dtype=torch.bool)
        if s_idx.numel() > 1:
            last[:-1] = s_idx[1:] != s_idx[:-1]
        win = s_lane[last]
        slots[idx[win]] = payload[win]
        post = slots[idx]
        won = empty & (post == payload).all(dim=1)
        lost_dup = empty & ~won & (to_u32(post[:, :4]) == keyed).all(dim=1)
        fresh = fresh | won
        unresolved = unresolved & ~dup & ~won & ~lost_dup
    return table, fresh, bool(unresolved.any())


def insert_core(table, fps, mask):
    """K1 wrapper: insert ``fps[mask]`` ([n, 4] int32 words, [n] bool)
    into ``table`` in place.  Returns (table, fresh, overflow): exactly
    one lane per distinct new fingerprint is fresh; duplicates of a
    stored fingerprint are not; ``overflow`` (a bool on the CPU, a
    0-dim int32 CUDA tensor on the card, read without a sync) is set
    when some lane was still unresolved after MAX_PROBES probes — its
    insert did not happen (grow the table and retry)."""
    if fps.device.type == "cpu":
        return insert_core_plain(table, fps, mask)
    return _insert_kernel(table, fps, mask)


def _insert_kernel(table, fps, mask):
    slots = table["slots"]
    n = fps.shape[0]
    fresh = torch.empty((n,), dtype=torch.bool, device=fps.device)
    overflow = torch.zeros((), dtype=torch.int32, device=fps.device)
    ck = kernels.check
    kernels.launch(
        "fpset_insert", "tpuvsr_fpset_insert",
        ck(slots, "slots", torch.int32, (slots.shape[0], 5)),
        slots.shape[0], ck(fps, "fps", torch.int32, (n, 4)),
        ck(mask, "mask", torch.bool, (n,)), n, fresh.data_ptr(),
        overflow.data_ptr(), kernels.stream_of(fps))
    return table, fresh, overflow


def query_core_plain(table, fps, mask):
    """Plain version of ``query_core``."""
    slots = table["slots"]
    capm = slots.shape[0] - 1
    keyed, h0 = _keyed(fps)
    unresolved = mask.clone()
    fresh = torch.zeros_like(mask)
    for t in range(MAX_PROBES):
        if not bool(unresolved.any()):
            break
        cur = slots[(h0 + t) & capm]
        mine = (to_u32(cur[:, :4]) == keyed).all(dim=1)
        empty = unresolved & (cur[:, 0] == 0)
        fresh = fresh | empty
        unresolved = unresolved & ~mine & ~empty
    return fresh, bool(unresolved.any())


def query_core(table, fps, mask):
    """K11 wrapper, read-only membership probe: returns (fresh,
    overflow).  ``fresh`` marks masked lanes whose fingerprint is NOT in
    the table (duplicate lanes of one new fingerprint all read fresh);
    lanes unresolved after MAX_PROBES raise ``overflow`` (a bool, read
    back from the card after the launch) and are not fresh."""
    if fps.device.type == "cpu":
        return query_core_plain(table, fps, mask)
    slots = table["slots"]
    n = fps.shape[0]
    fresh = torch.empty((n,), dtype=torch.bool, device=fps.device)
    overflow = torch.zeros((), dtype=torch.int32, device=fps.device)
    _probe_kernel(slots, None, fps, mask, None, fresh, overflow)
    return fresh, bool(overflow)


def _probe_kernel(slots, vals, fps, mask, out_gid, out_fresh, overflow):
    n = fps.shape[0]
    ck = kernels.check
    cap = slots.shape[0]
    kernels.launch(
        "fpset_probe", "tpuvsr_fpset_probe",
        ck(slots, "slots", torch.int32, (cap, 5)), cap,
        None if vals is None else ck(vals, "gids", torch.int32, (cap,)),
        ck(fps, "fps", torch.int32, (n, 4)),
        ck(mask, "mask", torch.bool, (n,)), n,
        None if out_gid is None else out_gid.data_ptr(),
        None if out_fresh is None else out_fresh.data_ptr(),
        None if overflow is None else overflow.data_ptr(),
        kernels.stream_of(fps))


# ----------------------------------------------------------------------
# K11: the gid column
# ----------------------------------------------------------------------
def empty_gids(capacity: int, device):
    """A gid column for a table of ``capacity`` slots: -1 everywhere."""
    return torch.full((capacity,), -1, dtype=torch.int32, device=device)


def store_gids_plain(slots, vals, fps, gids, mask):
    """Plain version of ``store_gids``: the JAX loop, all lanes in lock
    step; a lane writes at the first slot of its chain that holds its
    own (tag, row) and does not stop at an empty slot."""
    capm = slots.shape[0] - 1
    keyed, h0 = _keyed(fps)
    unresolved = mask.clone()
    for t in range(MAX_PROBES):
        if not bool(unresolved.any()):
            break
        idx = (h0 + t) & capm
        cur = slots[idx]
        mine = unresolved & (to_u32(cur[:, :4]) == keyed).all(dim=1)
        vals[idx[mine]] = gids[mine]
        unresolved = unresolved & ~mine
    return vals


def store_gids(slots, vals, fps, gids, mask):
    """K11 wrapper: write ``gids[mask]`` ([n] int32) into the gid column
    ``vals`` ([CAP] int32) IN PLACE, at the slot each masked lane's
    fingerprint ([n, 4] int32 words) occupies in ``slots`` (insert
    first, then store: a lane not found in MAX_PROBES probes writes
    nothing).  Returns ``vals``.  Two masked lanes with one fingerprint:
    either gid may stay, as in the JAX scatter."""
    if fps.device.type == "cpu":
        return store_gids_plain(slots, vals, fps, gids, mask)
    n = fps.shape[0]
    cap = slots.shape[0]
    ck = kernels.check
    kernels.launch(
        "fpset_store_gids", "tpuvsr_fpset_store_gids",
        ck(slots, "slots", torch.int32, (cap, 5)), cap,
        ck(vals, "gids", torch.int32, (cap,)),
        ck(fps, "fps", torch.int32, (n, 4)),
        ck(gids, "gid values", torch.int32, (n,)),
        ck(mask, "mask", torch.bool, (n,)), n, kernels.stream_of(fps))
    return vals


def lookup_gids_plain(table, vals, fps, mask):
    """Plain version of ``lookup_gids``."""
    slots = table["slots"]
    capm = slots.shape[0] - 1
    keyed, h0 = _keyed(fps)
    unresolved = mask.clone()
    out = torch.full((fps.shape[0],), -1, dtype=torch.int32,
                     device=fps.device)
    for t in range(MAX_PROBES):
        if not bool(unresolved.any()):
            break
        idx = (h0 + t) & capm
        cur = slots[idx]
        mine = unresolved & (to_u32(cur[:, :4]) == keyed).all(dim=1)
        out = torch.where(mine, vals[idx], out)
        empty = cur[:, 0] == 0
        unresolved = unresolved & ~mine & ~empty
    return out


def lookup_gids(table, vals, fps, mask):
    """K11 wrapper (the probe kernel with a gid column): the stored gid
    of each masked lane's fingerprint, -1 where it is absent, where it
    was never given a gid, or unresolved after MAX_PROBES.  Read-only."""
    if fps.device.type == "cpu":
        return lookup_gids_plain(table, vals, fps, mask)
    out = torch.empty((fps.shape[0],), dtype=torch.int32,
                      device=fps.device)
    _probe_kernel(table["slots"], vals, fps, mask, out, None, None)
    return out


def insert_gids(table, vals, fps, gids, mask):
    """``insert_core`` that also records ``gids`` in the column ``vals``
    (both in place): each fresh lane stores its gid at the slot it won.
    Batches hold no two equal fingerprints.  Returns (table, vals,
    overflow, fresh count)."""
    table, fresh, ovf = insert_core(table, fps, mask)
    store_gids(table["slots"], vals, fps, gids, mask & fresh)
    return table, vals, ovf, fresh.sum(dtype=torch.int32)


def grow(table, factor=4):
    """Rebuild into a table ``factor`` times larger (on probe overflow
    or high load): chunked re-insertion of every occupied slot through
    ``insert_core``.  A table with a gid column is rebuilt with it:
    each stored gid follows its fingerprint to the new probe chain
    (``insert_gids``)."""
    slots = table["slots"]
    occ = slots[:, 0] != 0
    fps = slots[occ][:, :4]
    old_gids = table["gids"][occ] if "gids" in table else None
    cap = slots.shape[0]
    new = empty_table(cap * factor, slots.device)
    if old_gids is not None:
        new["gids"] = empty_gids(cap * factor, slots.device)
    chunk = 1 << 16
    for off in range(0, fps.shape[0], chunk):
        part = fps[off:off + chunk].contiguous()
        m = torch.ones((part.shape[0],), dtype=torch.bool,
                       device=slots.device)
        if old_gids is None:
            new, _fresh, ovf = insert_core(new, part, m)
        else:
            new, _v, ovf, _n = insert_gids(
                new, new["gids"], part,
                old_gids[off:off + chunk].contiguous(), m)
        if bool(ovf):
            return grow(table, factor * 2)
    return new


def table_stats(slots):
    """Host-side occupancy/collision stats of a table's ``slots``
    (tensor or numpy): "displaced" slots are occupied slots not at
    their probe-chain start."""
    if isinstance(slots, torch.Tensor):
        slots = slots.cpu().numpy()
    s = np.asarray(slots).view(np.uint32)
    cap = int(s.shape[0])
    occ = s[:, 0] != 0
    n = int(occ.sum())
    out = {"capacity": cap, "occupied": n,
           "occupancy": n / cap if cap else 0.0,
           "displaced": 0, "collision_rate": 0.0}
    if n == 0:
        return out
    keyed = s[occ, :4].astype(np.uint32)
    with np.errstate(over="ignore"):
        h = keyed[:, 0] ^ (keyed[:, 1] * np.uint32(0x9E3779B1))
        h = h ^ (keyed[:, 2] * np.uint32(0x85EBCA6B)) ^ (keyed[:, 3] >> 5)
        h = h ^ (h >> 15)
        home = (h * np.uint32(0x27D4EB2F)) & np.uint32(cap - 1)
    idx = np.nonzero(occ)[0].astype(np.uint32)
    displaced = int((home != idx).sum())
    out["displaced"] = displaced
    out["collision_rate"] = displaced / n
    return out
