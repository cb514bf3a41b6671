"""Host-paged BFS engine: the frontier lives in host memory (and,
optionally, on disk) and pages through the card a chunk at a time.

The counterpart of ``tpuvsr/engine/paged_bfs.py`` (``PagedBFS`` :59-857).
Only the fingerprint set stays resident on the card; each level's
frontier is a list of host pages:

  host frontier pages --chunk in--> device chunk buffer
      [chunk_tiles x tile rows]
  --level pass (DeviceBFS._level: K4, K6, K7, K10, K3, K2, K1, K4)-->
  next-frontier buffer fills --> DRAIN to host pages, reset, continue

The drain rides the level pass's pause protocol: the headroom gate that
makes the resident engine grow its next buffer (``R_NEXT_GROW``) here
means "drain what you have": the paused tile committed nothing, so the
host copies the buffer's rows out, resets its count and re-enters at
the same tile.  The buffer is drained at every chunk's end too, so it
only ever holds rows of the chunk being run.  On the card the host
pages are pinned, so chunk-in and drain copies run at the link's rate.

Edge emission (``edges=True``, symmetry off) streams the behaviour
graph out of the same pass (``engine/edges.py``): the edge buffers are
drained into ``engine/spill.EdgeCSR`` when a tile finds too little room
(``R_EDGE_FLUSH``) and at every chunk's end.  A drain moves a chunk
row's gid base (``src_base`` = level base + chunk start) and a
next-buffer row's (``gid_base`` = level base + frontier + rows drained
so far this level).  With ``retain_levels=True`` every expanded level is
kept as dense host planes on ``level_blocks`` (gid order), which
``engine/device_liveness.DeviceGraph`` reads.  With ``spill_dir`` each
level's pages live in an ``engine/spill.SpillTier``: at most
``spill_ram_rows`` rows in RAM, the rest in the level's files.

Everything else (growth of the message table, the FPSet and the
expansion caps, violations, deadlocks, trace replay, the ``commit``
argument) is DeviceBFS's, and the two engines run the same level pass,
so levels, counts and trace pointer tables are ``DeviceBFS.run()``'s.
With ``commit="per-action"`` and edges on, K11 stores each action's
fresh gids after its insert whatever the tile's fate, and K12 appends
the tile's edges once at its end, on the final commit flag (the JAX
per-action edge block).  Symmetry works as there:
every insert goes through ``_fp``.

Speclint's ``preflight``, the bounds facts and the ample-set reduction
(``bounds=``, ``por=``) are DeviceBFS's (the JAX engine's
``paged_bfs.py:219-236``): ``run`` gates on ``preflight`` before any
device work, and each chunk's level pass probes and stores the C3 level
markers (K17, K11) as ``DeviceBFS.run()`` does.

Left out of this port (see ROADMAP.md): the dispatch window (one level
pass call at a time; the JAX package's results are the same for every
window size), checkpoints and rescue, the wall-clock budget and the run
journal.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..core.values import TLAError
from .bfs import CheckResult
from .device_bfs import DeviceBFS, _Bufs
from .edges import EdgeBuffers
from .fpset import grow
from .spill import EdgeCSR, SpillTier
from .tile import (R_BAG_GROW, R_DEADLOCK, R_EDGE_FLUSH, R_EXPAND_GROW,
                   R_FPSET_GROW, R_NEXT_GROW, R_SLOT_ERR, R_VIOLATION,
                   RUNNING)

I32 = torch.int32


class _HostLevel:
    """A level's host pages in RAM: the drained blocks of packed uint32
    rows, in commit order (the disk tier's ``SpillTier`` answers the
    same calls)."""

    def __init__(self):
        self.blocks = []

    def append(self, block):
        if block.shape[0]:
            self.blocks.append(block)

    def pieces(self, start, n):
        """Rows [start, start + n) as views of the blocks they lie in."""
        out, pos = [], 0
        for b in self.blocks:
            lo, hi = max(start, pos), min(start + n, pos + b.shape[0])
            if lo < hi:
                out.append(b[lo - pos:hi - pos])
            pos += b.shape[0]
        return out

    def map_pages(self, fn):
        self.blocks = [fn(b) for b in self.blocks]

    def drop(self):
        self.blocks = []


class PagedBFS(DeviceBFS):
    """DeviceBFS with a host frontier paged through the card (module
    docstring)."""

    def __init__(self, *args, retain_levels=False, spill_dir=None,
                 spill_ram_rows=None, edges=False, edge_capacity=None,
                 edge_spill_dir=None, edge_ram_rows=None, **kwargs):
        self.retain_levels = retain_levels
        self.level_blocks = []
        # set before DeviceBFS.__init__, which refuses edges elsewhere
        # and under symmetry
        self._edges_on = bool(edges)
        self._edge_capacity = edge_capacity
        self._edge_spill_dir = edge_spill_dir
        self._edge_ram_rows = edge_ram_rows
        self.edge_sink = None
        self._spill_dir = spill_dir
        self._spill_ram_rows = int(spill_ram_rows or (1 << 20))
        self._tiers = []
        if spill_dir and retain_levels:
            raise TLAError(
                "retain_levels (the liveness graph enumeration) needs "
                "the whole level resident; it cannot be combined with "
                "the disk spill tier")
        super().__init__(*args, **kwargs)

    # -- host pages ----------------------------------------------------
    def _level_store(self, level):
        """An empty host page store for one level: a ``SpillTier`` with
        a spill directory, else RAM blocks."""
        if self._spill_dir is None:
            return _HostLevel()
        t = SpillTier(self._spill_dir, level, self._spill_ram_rows)
        self._tiers.append(t)
        return t

    def _pieces(self, host, start, n):
        if isinstance(host, SpillTier):
            return [host.block(start, n)] if n else []
        return host.pieces(start, n)

    def _to_host(self, tensors):
        """Copy device tensors to host numpy arrays: into pinned memory
        on the card (one sync for all), a copy on the CPU."""
        if self.device.type != "cuda":
            return [t.clone().numpy() for t in tensors]
        out = []
        for t in tensors:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            out.append(h)
        torch.cuda.current_stream(self.device).synchronize()
        return [h.numpy() for h in out]

    def _put_chunk(self, chunk, host, start, n):
        """Page rows [start, start + n) of ``host`` into the device chunk
        buffer (pinned pages copy without a staging copy)."""
        off = 0
        for p in self._pieces(host, start, n):
            k = p.shape[0]
            chunk.nb[off:off + k].copy_(
                torch.from_numpy(np.ascontiguousarray(p).view(np.int32)),
                non_blocking=True)
            off += k

    def _dense(self, host, n):
        """A level's ``n`` rows as dense host planes (``retain_levels``),
        unpacked on the engine's device a chunk at a time."""
        pk, step = self._pk, 1 << 16
        parts = []
        for start in range(0, n, step):
            rows = torch.cat([torch.from_numpy(
                np.ascontiguousarray(p).view(np.int32))
                for p in self._pieces(host, start, min(step, n - start))])
            flat = pk.unpack(rows.to(self.device))
            parts.append({k: v.cpu().numpy()
                          for k, v in pk.unflatten(flat).items()})
        return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}

    def _regrow_rows(self, old_pk, old):
        """The message-table growth re-pack of host pages: packed rows
        of the old layout -> dense, padded with empty slots -> packed
        rows of the rebuilt one (``DeviceBFS._grow_msgs`` for pages)."""
        def regrow(rows):
            out = []
            for lo in range(0, rows.shape[0], 1 << 16):
                part = torch.from_numpy(np.ascontiguousarray(
                    rows[lo:lo + (1 << 16)]).view(np.int32)).to(self.device)
                dense = self.codec.pad_msgs(
                    old_pk.unflatten(old_pk.unpack(part)), old)
                out.append(self._pk.pack(self._pk.flatten(
                    dense).contiguous()).cpu().numpy().view(np.uint32))
            return (np.concatenate(out) if out else
                    np.zeros((0, self._pk.words), np.uint32))
        return regrow

    def _total_E(self):
        return sum(self._expand_caps())

    def _chunk_cap(self):
        return self.chunk_tiles * self.tile

    # ------------------------------------------------------------------
    def run(self, max_states=None, max_depth=None, check_deadlock=False,
            log=None) -> CheckResult:
        self._start(log)
        emit = log or (lambda msg: None)
        T, dev = self.tile, self.device
        self._act_counts = np.zeros(len(self.kern.action_names), np.int64)
        self._lanes_disp = 0
        self.counters = {}
        self._copy_s = 0.0
        res = CheckResult()
        t0 = time.time()
        self.spill_count = 0     # drains of a full next buffer
        self.spill_rows = 0      # rows paged out to the host
        self.level_blocks = []
        self._tiers = []
        self._edge_rows_total = self._edge_hw = 0
        if self._edges_on:
            self.edge_sink = EdgeCSR(spill_dir=self._edge_spill_dir,
                                     ram_rows=self._edge_ram_rows)
        self.level_sizes = []
        table, n0, viol = self._register_init(res)
        fp_count = n0
        if viol is not None:
            return self._finish(res, fp_count, table, t0)
        host_front = self._level_store(0)
        host_front.append(self._to_host(
            [self._pk.pack(self._init_flat)])[0].view(np.uint32))
        n_front, level_base, depth = n0, 0, 0
        self.level_sizes = [n0]
        # a tile commits only with total_E rows of room, so total_E + a
        # tile is the next buffer's floor (kept on every rebuild: a stale
        # floor would never let a tile commit into an empty buffer)
        self.next_cap = max(self.next_cap, self._total_E() + T)
        bufs = _Bufs(self.next_cap, self._pk.words, dev)
        eb = None
        if self._edges_on:
            self.edge_cap = max(int(self._edge_capacity
                                    or 4 * self.next_cap),
                                self._total_E() + T)
            eb = EdgeBuffers(self.edge_cap, dev)
        chunk = None
        while n_front > 0:
            if max_depth is not None and depth >= max_depth:
                res.error = f"depth limit {max_depth} reached"
                break
            if self.retain_levels:
                self.level_blocks.append(self._dense(host_front, n_front))
            depth += 1
            drained = self._level_store(depth)
            d_par, d_act, d_prm = [], [], []
            n_next_total = n_next = chunk_start = 0

            def spill():
                """Page the next buffer's rows out to the host and reset
                its count (the buffer holds rows of this chunk only)."""
                nonlocal n_next_total, n_next
                if n_next == 0:
                    return
                t1 = time.time()
                rows, par, act, prm = self._to_host(
                    [bufs.nb[:n_next], bufs.par[:n_next],
                     bufs.act[:n_next], bufs.prm[:n_next]])
                self._copy_s += time.time() - t1
                drained.append(rows.view(np.uint32))
                # par is chunk-relative; lift it to level-relative
                d_par.append(par.astype(np.int64) + chunk_start)
                d_act.append(act)
                d_prm.append(prm)
                n_next_total += n_next
                self.spill_rows += n_next
                self._count("drains")
                n_next = 0

            def drain_edges():
                """The committed edges off the device into the host
                CSR."""
                if eb is None or eb.n == 0:
                    return
                t1 = time.time()
                n = eb.n
                s, a, d = self._to_host([eb.src[:n], eb.aid[:n],
                                         eb.dst[:n]])
                eb.n = 0
                self._copy_s += time.time() - t1
                self.edge_sink.append(s, a, d)
                self._edge_rows_total += n
                self._edge_hw = max(self._edge_hw, n)
                self._count("edge_drains")

            def refloor_edges():
                """Caps grew: drain, and re-floor the edge buffers on the
                new total_E (a stale floor never lets a tile commit)."""
                nonlocal eb
                drain_edges()
                self.edge_cap = max(self.edge_cap, self._total_E() + T)
                eb = EdgeBuffers(self.edge_cap, dev)

            while chunk_start < n_front:
                n_c = min(self._chunk_cap(), n_front - chunk_start)
                if chunk is None:
                    chunk = _Bufs(self._chunk_cap(), self._pk.words, dev)
                t1 = time.time()
                self._put_chunk(chunk, host_front, chunk_start, n_c)
                if dev.type == "cuda":
                    torch.cuda.current_stream(dev).synchronize()
                self._copy_s += time.time() - t1
                self._count("chunks")
                n_tiles_c = (n_c + T - 1) // T
                start_t = 0
                while True:
                    if eb is not None:
                        eb.src_base = level_base + chunk_start
                        eb.gid_base = level_base + n_front + n_next_total
                    out = self._level(table, chunk, n_c, start_t, bufs,
                                      n_next, check_deadlock, eb,
                                      pdepth=depth - 1)
                    start_t, n_next = out["t"], out["nn"]
                    res.states_generated += out["gen"]
                    fp_count += out["dist"]
                    self._act_counts += out["act"]
                    self._need_seen = np.maximum(self._need_seen,
                                                 out["need"])
                    reason = out["reason"]
                    if reason == RUNNING:
                        if start_t >= n_tiles_c:
                            break
                        continue
                    if reason == R_VIOLATION:
                        vp, va, vprm = out["viol"]
                        parent = self._pk.unpack(
                            chunk.nb, torch.tensor([vp], device=dev))
                        bad = self._first_failing(
                            self._materialize_one(parent, va, vprm))
                        gid = level_base + chunk_start + vp
                        if bad is None:
                            raise TLAError(
                                "device invariant pass reported a "
                                "violation the rebuilt state does not "
                                f"show (parent gid {gid}, action "
                                f"{self.kern.action_names[va]})")
                        res.ok = False
                        res.violated_invariant = bad
                        res.trace = self._trace(gid, extra=(va, vprm))
                        res.diameter = depth
                        return self._finish(res, fp_count, table, t0)
                    if reason == R_DEADLOCK:
                        di = out["dead"]
                        res.ok = False
                        res.error = "deadlock"
                        row = self._pk.unpack(
                            chunk.nb, torch.tensor([di], device=dev))
                        res.deadlock_state = self._decode(row)
                        res.trace = self._trace(level_base + chunk_start
                                                + di)
                        res.diameter = depth
                        return self._finish(res, fp_count, table, t0)
                    if reason == R_NEXT_GROW:
                        # drain instead of growing the buffer on the card
                        self.spill_count += 1
                        spill()
                    elif reason == R_EDGE_FLUSH:
                        self._count("edge_flushes")
                        drain_edges()
                    elif reason == R_BAG_GROW:
                        spill()
                        old, old_pk = self.codec.shape.MAX_MSGS, self._pk
                        self._build(old * 2)
                        regrow = self._regrow_rows(old_pk, old)
                        host_front.map_pages(regrow)
                        drained.map_pages(regrow)
                        self.level_blocks = [self.codec.pad_msgs(b, old)
                                             for b in self.level_blocks]
                        self._init_flat = self._pk.flatten(
                            self.codec.pad_msgs(old_pk.unflatten(
                                self._init_flat), old)).contiguous()
                        self.next_cap = max(self.next_cap,
                                            self._total_E() + T)
                        bufs = _Bufs(self.next_cap, self._pk.words, dev)
                        chunk = _Bufs(self._chunk_cap(), self._pk.words,
                                      dev)
                        self._put_chunk(chunk, host_front, chunk_start, n_c)
                        if eb is not None:
                            refloor_edges()
                        self._count("grow_message_table")
                        emit(f"message table grown to "
                             f"{self.codec.shape.MAX_MSGS} slots")
                    elif reason == R_FPSET_GROW:
                        table = grow(table)
                        self._count("grow_fpset")
                        emit(f"FPSet grown to {table['slots'].shape[0]} "
                             f"slots")
                    elif reason == R_EXPAND_GROW:
                        self._grow_expand(out["grow_aid"], emit)
                        if self.next_cap < self._total_E() + T:
                            spill()
                            self.next_cap = self._total_E() + T
                            bufs = _Bufs(self.next_cap, self._pk.words, dev)
                        if eb is not None and \
                                self.edge_cap < self._total_E() + T:
                            refloor_edges()
                    elif reason == R_SLOT_ERR:
                        raise TLAError(
                            "dense-layout slot collision (a second DVC or "
                            "recovery response from one source in one "
                            "view): this interleaving needs the "
                            "multi-slot layout")
                # chunk done: drain what it left, so the next chunk's
                # rows start an empty buffer and the host CSR sees
                # whole chunks in commit order
                self._lanes_disp += min(start_t, n_tiles_c) * sum(
                    self._expand_caps())
                spill()
                drain_edges()
                chunk_start += n_c

            # ---- level complete: the drained pages are the frontier ---
            emit(f"depth {depth}: frontier {n_front}, distinct {fp_count}, "
                 f"generated {res.states_generated}, drains "
                 f"{self.counters.get('drains', 0)}")
            if n_next_total:
                self._h_parent.append(np.concatenate(d_par) + level_base)
                self._h_action.append(np.concatenate(d_act))
                self._h_param.append(np.concatenate(d_prm))
                self.level_sizes.append(n_next_total)
            level_base += n_front
            host_front.drop()
            host_front = drained
            n_front = n_next_total
            if n_front:
                self._calibrate_caps(emit, n_front)
            if n_front == 0:
                break
            if max_states and fp_count >= max_states:
                res.error = f"state limit {max_states} reached"
                break
            if fp_count > 0.5 * table["slots"].shape[0]:
                table = grow(table)
                self._count("grow_fpset")
                emit(f"FPSet grown to {table['slots'].shape[0]} slots")
        res.diameter = depth
        return self._finish(res, fp_count, table, t0)

    def _finish(self, res, fp_count, table, t0):
        super()._finish(res, fp_count, table, t0)
        g, c = res.metrics["gauges"], res.metrics["counters"]
        c["spill_count"] = getattr(self, "spill_count", 0)
        c["spill_rows"] = getattr(self, "spill_rows", 0)
        g["host_copy_s"] = getattr(self, "_copy_s", 0.0)
        if self._spill_dir is not None:
            # what the run wrote to the disk tier (consumed levels'
            # files included); then release what is left
            g["spill_tier_bytes"] = int(sum(t.disk_bytes
                                            for t in self._tiers))
            c["spill_tier_flushes"] = int(sum(t.flushes
                                              for t in self._tiers))
            for t in self._tiers:
                t.drop()
            self._tiers = []
        if self._edges_on:
            g["edge_rows"] = int(self._edge_rows_total)
            g["edge_bytes"] = int(self._edge_rows_total) * EdgeCSR.ROW_BYTES
            g["edge_buf_high_water"] = int(self._edge_hw)
            g["edges_per_s"] = round(self._edge_rows_total
                                     / max(res.elapsed, 1e-9), 1)
        return res

