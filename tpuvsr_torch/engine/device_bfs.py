"""Device-resident breadth-first model checking engine (PyTorch/CUDA).

The counterpart of ``tpuvsr/engine/device_bfs.py`` for the chunked
level pass with the fused commit (``commit="fused"``), packing on.  A
BFS level runs as chunks of ``chunk_tiles`` tiles of ``tile_size``
frontier states; each tile flows through the same three stages:

  chunk --guard matrix--> every action's guard over every lane of the
                          chunk (K4 unpack of the packed frontier,
                          then one batched pass): exact per-action
                          enabled counts per tile
  tile  --work queue  --> the enabled (state, lane) items of each
                          action are compacted (stable, cumsum-and-
                          scatter) and only they are expanded,
                          fingerprinted (K3, incremental from the
                          parents' parts) and invariant-checked
  tile  --single commit-> one dedup (K2), one FPSet insert (K1) and one
                          pack-scatter (K4) into the next buffer

The pause protocol is the JAX engine's: a tile that meets a violation,
a slot error, a full message table, an expansion cap overflow, a probe
overflow or a full next buffer commits only the actions before the
first failing one (the committed-action prefix), reports a reason, and
the host grows the structure and re-enters at that tile; its inserts
persist and resolve as duplicates on re-entry.  Counts, level sizes and
traces are those of the JAX engine.

Host synchronisation: one device->host read per chunk (the per-tile
per-action enabled counts, which also size each compaction exactly, so
actions with no enabled item in a tile are skipped) and one per tile
(the tile's reason flags and fresh count).  The JAX engine reads the
host once per chunk; this port runs tiles from the host loop and reads
their outcome before the next tile, which keeps the pause protocol
exact without masking later tiles.

Left out of this port (see ROADMAP.md): the interpreter checks (preflight,
and the violation cross-check is done with the kernel's own invariant
functions on the state rebuilt on the host), bounds facts, partial-order
reduction, symmetry, the dispatch window, ``run_fused``/``run_chained``,
checkpoints and the per-action commit.  Results match the JAX engine
with bounds off, POR off and a window of 1, which its own tests show
give the same results as the defaults.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..core.values import TLAError
from ..device import resolve_device
from ..models import registry
from ..models.vsr import ERR_BAG_OVERFLOW
from .bfs import CheckResult
from .fpset import dedup_keep, empty_table, grow, insert_core
from .trace import TraceEntry

I32 = torch.int32

# level-pass stop reasons (the JAX engine's codes)
RUNNING = 0
R_VIOLATION = 2      # an invariant failed on a generated state
R_BAG_GROW = 3       # a successor needs more message-table slots
R_FPSET_GROW = 4     # fingerprint probing exhausted (table too full)
R_NEXT_GROW = 5      # next-frontier buffer out of capacity
R_SLOT_ERR = 6       # dense-layout slot collision (config limitation)
R_DEADLOCK = 7       # a frontier state has no enabled successor
R_EXPAND_GROW = 8    # per-action compaction buffer too small


def _align8(n):
    return ((int(n) + 7) // 8) * 8


def _compact(en_f, n):
    """Indices of the first ``n`` True entries of ``en_f``, in order,
    without a host sync (the stable counterpart of
    ``jnp.nonzero(size=n)``)."""
    pos = torch.cumsum(en_f, 0) - 1
    dest = torch.where(en_f & (pos < n), pos, n)
    out = torch.empty((n + 1,), dtype=torch.int64, device=en_f.device)
    out.scatter_(0, dest, torch.arange(en_f.shape[0], device=en_f.device))
    return out[:n]


class _Bufs:
    """A frontier-format buffer set: packed states plus the trace
    pointers (parent row, action id, lane param) of each row.  Every
    tensor has one spare row at index ``cap`` that absorbs the writes
    of non-fresh lanes (the JAX engine's out-of-bounds drop)."""

    def __init__(self, cap, words, device):
        self.cap = cap
        self.nb = torch.zeros((cap + 1, words), dtype=I32, device=device)
        self.par = torch.zeros((cap + 1,), dtype=I32, device=device)
        self.act = torch.zeros((cap + 1,), dtype=I32, device=device)
        self.prm = torch.zeros((cap + 1,), dtype=I32, device=device)

    def grown(self, factor=4):
        new = _Bufs.__new__(_Bufs)
        new.cap = self.cap * factor
        for k in ("nb", "par", "act", "prm"):
            old = getattr(self, k)
            t = torch.zeros((new.cap + 1,) + tuple(old.shape[1:]),
                            dtype=old.dtype, device=old.device)
            t[:self.cap] = old[:self.cap]
            setattr(new, k, t)
        return new


class DeviceBFS:
    def __init__(self, spec, max_msgs=None, tile_size=128,
                 fpset_capacity=1 << 20,
                 next_capacity=1 << 14, chunk_tiles=64,
                 model_factory=None, device=None):
        self.device = resolve_device(device)
        self.spec = spec
        self.tile = int(tile_size)
        self.fpset_capacity = int(fpset_capacity)
        self.next_cap = int(next_capacity)
        self.chunk_tiles = int(chunk_tiles)
        self.inv_names = list(spec.invariants)
        self._model_factory = model_factory or registry.make_model
        self.expand_caps = None
        self._need_seen = None
        self.level_sizes = []
        self.counters = {}
        self._build(max_msgs)

    # ------------------------------------------------------------------
    def _build(self, max_msgs):
        """(Re)build codec and kernel for a message-table bound; called
        again on bag growth."""
        self.codec, self.kern = self._model_factory(self.spec,
                                                    max_msgs=max_msgs)
        kern = self.kern
        self._pk = kern.pk
        names = kern.action_names
        tl = [self.tile * kern._lane_count(n) for n in names]
        if self.expand_caps is None:
            self.expand_caps = [min(t, max(8, _align8(self.tile)))
                                for t in tl]
        else:
            self.expand_caps = [min(t, max(8, int(c)))
                                for t, c in zip(tl, self.expand_caps)]
        if self._need_seen is None or len(self._need_seen) != len(names):
            self._need_seen = np.zeros(len(names), np.int64)
        self._inv = kern.invariant_fn(self.inv_names)
        self._incremental = hasattr(kern, "parent_parts")

    def _expand_caps(self):
        kern, T = self.kern, self.tile
        return [min(T * kern._lane_count(n), max(8, int(c)))
                for n, c in zip(kern.action_names, self.expand_caps)]

    def _count(self, what, by=1):
        self.counters[what] = self.counters.get(what, 0) + by

    # ------------------------------------------------------------------
    # one chunk of tiles (the body of the JAX level pass)
    # ------------------------------------------------------------------
    def _level(self, table, front, n_front, start_t, bufs, nn,
               want_deadlock):
        """Run tiles start_t.. of the level until a reason stops the
        chunk or chunk_tiles tiles committed.  Returns the loop state
        as host values; ``table`` and ``bufs`` are updated in place."""
        T, K = self.tile, self.chunk_tiles
        pk, kern, dev = self._pk, self.kern, self.device
        n_tiles = (n_front + T - 1) // T
        kk = max(0, min(K, n_tiles - start_t))
        n_act = len(kern.action_names)
        caps = self._expand_caps()
        total_E = sum(caps)
        out = {"t": start_t, "reason": RUNNING, "viol": None, "dead": -1,
               "grow_aid": -1, "nn": nn, "dist": 0, "gen": 0,
               "act": np.zeros(n_act, np.int64),
               "need": np.zeros(n_act, np.int64)}
        if kk == 0:
            return out
        # -- stage 1: chunk-wide guard matrix ---------------------------
        cidx = start_t * T + torch.arange(kk * T, device=dev)
        cvalid = cidx < n_front
        cflat = pk.unpack(front.nb, torch.clamp(cidx, 0, front.cap - 1))
        cstates = pk.unflatten(cflat)
        csegs = [g(cstates) & cvalid[:, None] for g in kern._guard_fns()]
        en_any = torch.zeros((kk * T,), dtype=torch.bool, device=dev)
        for s in csegs:
            en_any |= s.any(dim=1)
        counts = torch.stack([s.reshape(kk, -1).sum(dim=1) for s in csegs],
                             dim=1).cpu().numpy()              # [kk, n_act]
        out["need"] = counts.max(axis=0)
        while out["t"] < n_tiles and out["t"] < start_t + K:
            self._count("tiles")
            self._tile(out, table, bufs, cflat, csegs, en_any, cvalid,
                       counts, start_t, caps, total_E, want_deadlock)
            if out["reason"] != RUNNING:
                break
        return out

    def _tile(self, out, table, bufs, cflat, csegs, en_any, cvalid, counts,
              start_t, caps, total_E, want_deadlock):
        T = self.tile
        pk, kern, dev = self._pk, self.kern, self.device
        n_act = len(kern.action_names)
        t = out["t"]
        base = t * T
        off = (t - start_t) * T
        cnts = counts[t - start_t]
        ovf_vec = cnts > np.asarray(caps)
        if ovf_vec.any():
            out["grow_aid"] = int(np.argmax(ovf_vec))
        # headroom gate: with cap - nn >= total_E no scatter can
        # overrun, so an insert is never committed without its state
        if bufs.cap - out["nn"] < total_E:
            out["reason"] = R_NEXT_GROW
            return
        tile_flat = cflat[off:off + T]
        parts = kern.parent_parts(tile_flat) if self._incremental else None
        q_succ, q_fp, q_en, q_pidx, q_lane, q_aid, flags = \
            [], [], [], [], [], [], []
        for aid, (name, fn) in enumerate(zip(kern.action_names,
                                             kern._action_fns())):
            n_a = int(min(cnts[aid], caps[aid]))
            if n_a == 0:
                continue
            L_a = kern._lane_count(name)
            sel = _compact(csegs[aid][off:off + T].reshape(-1), n_a)
            pidx = torch.div(sel, L_a, rounding_mode="floor")
            lane = torch.remainder(sel, L_a)
            st_flat = tile_flat[pidx]
            st_sel = pk.unflatten(st_flat)
            if self._incremental:
                succ, en2 = fn(kern.seed_touch(st_sel), lane)
                clean = {k: v for k, v in succ.items()
                         if not k.startswith("_")}
                succ_flat = pk.flatten(clean)
                ri = kern.lane_replica(name, st_sel, lane).to(I32)
                fp = kern.fingerprint_incremental(
                    succ_flat, ri, succ["_ts"].contiguous(), pidx.to(I32),
                    tile_flat, parts)
            else:
                succ, en2 = fn(st_sel, lane)
                clean = {k: v for k, v in succ.items()
                         if not k.startswith("_")}
                succ_flat = pk.flatten(clean)
                fp = kern.fingerprint(succ_flat)
            iok = self._inv(clean)
            errv = torch.where(en2, clean["err"], 0)
            viol_l = en2 & ~iok & (errv == 0)
            vidx = torch.argmax(viol_l.to(torch.int8))
            flags.append(torch.stack([
                viol_l.any().long(),
                ((errv & ERR_BAG_OVERFLOW) != 0).any().long(),
                ((errv & ~ERR_BAG_OVERFLOW) != 0).any().long(),
                pidx[vidx], lane[vidx],
                torch.tensor(aid, device=dev)]))
            q_succ.append(succ_flat)
            q_fp.append(fp)
            q_en.append(en2)
            q_pidx.append(pidx)
            q_lane.append(lane)
            q_aid.append(torch.full((n_a,), aid, dtype=torch.int64,
                                    device=dev))
        ovf_first = int(np.argmax(ovf_vec)) if ovf_vec.any() else n_act
        dead = cvalid[off:off + T] & ~en_any[off:off + T]
        tail = [dead.any().long(), torch.argmax(dead.to(torch.int8))]
        if q_succ:
            fl = torch.stack(flags)                          # [P, 6]
            bad = (fl[:, 0] | fl[:, 1] | fl[:, 2]) > 0
            first_bad = torch.clamp(
                torch.where(bad, fl[:, 5], n_act).min(), max=ovf_first)
            succ_q = torch.cat(q_succ)
            fp_q = torch.cat(q_fp).contiguous()
            aid_q = torch.cat(q_aid)
            mcommit = torch.cat(q_en) & (aid_q < first_bad)
            # -- stage 3: one dedup, one insert, one scatter -----------
            keep = dedup_keep(fp_q, mcommit)
            _tbl, fresh, ovf_i = insert_core(table, fp_q, keep)
            rank = torch.cumsum(fresh, 0) - 1 + out["nn"]
            dest = torch.where(fresh, rank, bufs.cap)
            pk.pack(succ_q, out=bufs.nb,
                    dest=torch.where(fresh, rank, -1).to(I32))
            bufs.par[dest] = (base + torch.cat(q_pidx)).to(I32)
            bufs.act[dest] = aid_q.to(I32)
            bufs.prm[dest] = torch.cat(q_lane).to(I32)
            head = [fresh.sum(), torch.as_tensor(ovf_i, device=dev).long(),
                    first_bad]
            host = torch.cat([torch.stack(head + tail), fl.reshape(-1)]
                             ).cpu().numpy()
            fl_h = host[5:].reshape(-1, 6)
        else:
            host = torch.stack(tail).cpu().numpy()
            host = np.concatenate([[0, 0, ovf_first], host])
            fl_h = np.zeros((0, 6), np.int64)
        nfi, ovf_i, first_bad, dead_any, dead_i = (int(x) for x in host[:5])
        out["nn"] += nfi
        out["dist"] += nfi
        commit = first_bad >= n_act and not ovf_i
        viol_any = bool(fl_h[:, 0].any())
        if viol_any:
            r = fl_h[np.argmax(fl_h[:, 0] > 0)]
            out["viol"] = (base + int(r[3]), int(r[5]), int(r[4]))
        if viol_any:
            reason = R_VIOLATION
        elif fl_h[:, 2].any():
            reason = R_SLOT_ERR
        elif fl_h[:, 1].any():
            reason = R_BAG_GROW
        elif ovf_vec.any():
            reason = R_EXPAND_GROW
        elif ovf_i:
            reason = R_FPSET_GROW
        else:
            reason = RUNNING
        if reason == RUNNING and want_deadlock and commit and dead_any:
            reason = R_DEADLOCK
            out["dead"] = base + dead_i
        out["reason"] = reason
        if commit:
            out["gen"] += int(cnts.sum())
            out["act"] += cnts
            if reason == RUNNING:
                out["t"] = t + 1

    # ------------------------------------------------------------------
    # growth handlers
    # ------------------------------------------------------------------
    def _grow_msgs(self, bufs_list):
        """Double MAX_MSGS in place: packed buffers go through the old
        layout to dense, gain all-zero slots (content-neutral: absent
        slots change no fingerprint) and are re-packed in the new one."""
        old = self.codec.shape.MAX_MSGS
        old_pk = self._pk
        self._build(old * 2)
        chunk = 1 << 16
        for b in bufs_list:
            rows = b.nb.shape[0]
            nb = torch.zeros((rows, self._pk.words), dtype=I32,
                             device=self.device)
            for lo in range(0, rows, chunk):
                idx = torch.arange(lo, min(rows, lo + chunk),
                                   device=self.device)
                dense = old_pk.unflatten(old_pk.unpack(b.nb, idx))
                dense = self.codec.pad_msgs(dense, old)
                nb[lo:lo + idx.shape[0]] = self._pk.pack(
                    self._pk.flatten(dense).contiguous())
            b.nb = nb
        init = self.codec.pad_msgs(old_pk.unflatten(self._init_flat), old)
        self._init_flat = self._pk.flatten(init).contiguous()

    def _grow_expand(self, aid, emit):
        """R_EXPAND_GROW: grow every action whose observed exact need
        exceeds its cap (the chunk-wide guard matrix measured it)."""
        kern = self.kern
        caps = self._expand_caps()
        grown = []
        for a, name in enumerate(kern.action_names):
            need = int(self._need_seen[a])
            if need > caps[a]:
                self.expand_caps[a] = min(
                    self.tile * kern._lane_count(name), _align8(need))
                grown.append((name, self.expand_caps[a]))
        if not grown:
            self.expand_caps[aid] = min(
                self.tile * kern._lane_count(kern.action_names[aid]),
                _align8(caps[aid] * 2))
            grown = [(kern.action_names[aid], self.expand_caps[aid])]
        self._count("grow_expand_buffer", len(grown))
        emit("expand caps grown to exact chunk need: "
             + ", ".join(f"{n}={c}" for n, c in grown))

    def _calibrate_caps(self, emit, level_states):
        """Level-boundary calibration: shrink the expansion caps onto the
        observed per-tile maxima when that saves >= 20% of the lanes."""
        if level_states < 4 * self.tile:
            return False
        kern, T = self.kern, self.tile
        tgt = [min(T * kern._lane_count(n), max(8, _align8(max(int(s), 1))))
               for n, s in zip(kern.action_names, self._need_seen)]
        cur = self._expand_caps()
        if sum(tgt) * 5 > sum(cur) * 4:
            return False
        self.expand_caps = tgt
        emit(f"expand caps calibrated to exact chunk maxima "
             f"({sum(cur)} -> {sum(tgt)} lanes/tile)")
        return True

    # ------------------------------------------------------------------
    # init, trace replay
    # ------------------------------------------------------------------
    def _first_failing(self, flat):
        """Name of the first cfg invariant that fails on the one state
        ``flat`` [1, lanes], or None."""
        st = self._pk.unflatten(flat)
        for name, f in self.kern.invariant_fns(self.inv_names):
            if not bool(f(st)[0]):
                return name
        return None

    def _register_init(self, res):
        pk = self._pk
        init = self.spec.init_dense(self.codec)
        batch = {k: torch.as_tensor(np.stack([d[k] for d in init]),
                                    device=self.device)
                 for k in init[0]}
        flat = pk.flatten(batch).contiguous()
        fps = self.kern.fingerprint(flat).cpu().numpy()
        keep, seen = [], set()
        for i in range(len(init)):
            key = tuple(fps[i])
            if key not in seen:
                seen.add(key)
                keep.append(i)
        n0 = len(keep)
        self._init_flat = flat[keep]
        table = empty_table(self.fpset_capacity, self.device)
        insert_core(table, torch.as_tensor(fps[keep], device=self.device),
                    torch.ones((n0,), dtype=torch.bool, device=self.device))
        self._h_parent = [np.full(n0, -1, np.int64)]
        self._h_action = [np.full(n0, -1, np.int32)]
        self._h_param = [np.zeros(n0, np.int32)]
        for i in range(n0):
            bad = self._first_failing(self._init_flat[i:i + 1])
            if bad:
                res.ok = False
                res.violated_invariant = bad
                res.trace = self._trace(i)
                return table, n0, i
        res.states_generated += len(init)
        return table, n0, None

    def _materialize_one(self, flat, aid, param):
        """Apply one recorded (action, lane param) to one state [1,
        lanes] — the trace-replay step."""
        fn = self.kern._action_fns()[aid]
        succ, en = fn(self._pk.unflatten(flat),
                      torch.tensor([param], device=self.device))
        if not bool(en[0]):
            raise TLAError("trace replay chose a disabled lane")
        return self._pk.flatten({k: v for k, v in succ.items()
                                 if not k.startswith("_")})

    def _decode(self, flat):
        row = {k: v[0].cpu().numpy()
               for k, v in self._pk.unflatten(flat).items()}
        return self.codec.decode(row)

    def _trace(self, gid, extra=None):
        parent = np.concatenate(self._h_parent)
        action = np.concatenate(self._h_action)
        param = np.concatenate(self._h_param)
        steps = []
        cur = gid
        while action[cur] >= 0:
            steps.append((int(action[cur]), int(param[cur])))
            cur = int(parent[cur])
        steps.reverse()
        if extra is not None:
            steps.append(extra)
        st = self._init_flat[cur:cur + 1]
        out = [TraceEntry(position=1, action_name=None, location=None,
                          state=self._decode(st))]
        for pos, (aid, prm) in enumerate(steps):
            st = self._materialize_one(st, aid, prm)
            name = self.kern.action_names[aid]
            out.append(TraceEntry(position=pos + 2, action_name=name,
                                  location=None, state=self._decode(st)))
        return out

    # ------------------------------------------------------------------
    def run(self, max_states=None, max_depth=None, check_deadlock=False,
            log=None) -> CheckResult:
        emit = log or (lambda msg: None)
        self._act_counts = np.zeros(len(self.kern.action_names), np.int64)
        self._lanes_disp = 0
        self.counters = {}
        res = CheckResult()
        t0 = time.time()
        self.level_sizes = []
        table, n0, viol = self._register_init(res)
        fp_count = n0
        if viol is not None:
            return self._finish(res, fp_count, table, t0)
        front = _Bufs(max(self.next_cap, n0), self._pk.words, self.device)
        front.nb[:n0] = self._pk.pack(self._init_flat)
        bufs = _Bufs(self.next_cap, self._pk.words, self.device)
        n_front, level_base, depth = n0, 0, 0
        self.level_sizes = [n0]
        while n_front > 0:
            if max_depth is not None and depth >= max_depth:
                res.error = f"depth limit {max_depth} reached"
                break
            depth += 1
            start_t, n_next = 0, 0
            n_tiles = (n_front + self.tile - 1) // self.tile
            while True:
                out = self._level(table, front, n_front, start_t, bufs,
                                  n_next, check_deadlock)
                start_t, n_next = out["t"], out["nn"]
                res.states_generated += out["gen"]
                fp_count += out["dist"]
                self._act_counts += out["act"]
                self._need_seen = np.maximum(self._need_seen, out["need"])
                reason = out["reason"]
                if reason == RUNNING:
                    if start_t >= n_tiles:
                        break
                    continue
                if reason == R_VIOLATION:
                    vp, va, vprm = out["viol"]
                    parent = self._pk.unpack(
                        front.nb, torch.tensor([vp], device=self.device))
                    bad = self._first_failing(
                        self._materialize_one(parent, va, vprm))
                    if bad is None:
                        raise TLAError(
                            "device invariant pass reported a violation "
                            "the rebuilt state does not show (parent gid "
                            f"{level_base + vp}, action "
                            f"{self.kern.action_names[va]})")
                    res.ok = False
                    res.violated_invariant = bad
                    res.trace = self._trace(level_base + vp,
                                            extra=(va, vprm))
                    res.diameter = depth
                    return self._finish(res, fp_count, table, t0)
                if reason == R_BAG_GROW:
                    self._grow_msgs([front, bufs])
                    self._count("grow_message_table")
                    emit(f"message table grown to "
                         f"{self.codec.shape.MAX_MSGS} slots")
                elif reason == R_FPSET_GROW:
                    table = grow(table)
                    self._count("grow_fpset")
                    emit(f"FPSet grown to {table['slots'].shape[0]} slots")
                elif reason == R_NEXT_GROW:
                    bufs = bufs.grown()
                    self._count("grow_next_buffer")
                    emit(f"next-frontier buffer grown to {bufs.cap}")
                elif reason == R_EXPAND_GROW:
                    self._grow_expand(out["grow_aid"], emit)
                elif reason == R_SLOT_ERR:
                    raise TLAError(
                        "dense-layout slot collision (a second DVC or "
                        "recovery response from one source in one view): "
                        "this interleaving needs the multi-slot layout")
                elif reason == R_DEADLOCK:
                    di = out["dead"]
                    res.ok = False
                    res.error = "deadlock"
                    row = self._pk.unpack(
                        front.nb, torch.tensor([di], device=self.device))
                    res.deadlock_state = self._decode(row)
                    res.trace = self._trace(level_base + di)
                    res.diameter = depth
                    return self._finish(res, fp_count, table, t0)
            # ---- level complete: pull trace pointers, swap buffers ---
            emit(f"depth {depth}: frontier {n_front}, distinct {fp_count}, "
                 f"generated {res.states_generated}")
            self._lanes_disp += min(start_t, n_tiles) * sum(
                self._expand_caps())
            if n_next:
                self._h_parent.append(
                    bufs.par[:n_next].cpu().numpy().astype(np.int64)
                    + level_base)
                self._h_action.append(bufs.act[:n_next].cpu().numpy().copy())
                self._h_param.append(bufs.prm[:n_next].cpu().numpy().copy())
                self.level_sizes.append(n_next)
            level_base += n_front
            front, bufs = bufs, front
            n_front = n_next
            if n_next:
                self._calibrate_caps(emit, n_front)
            if n_next == 0:
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
        self.table = table          # the run's FPSet, kept for callers
        res.distinct_states = fp_count
        res.levels = list(self.level_sizes)
        res.elapsed = time.time() - t0
        res.states_per_sec = fp_count / res.elapsed if res.elapsed else 0.0
        acts = getattr(self, "_act_counts", None)
        gauges = {"fpset_capacity": int(table["slots"].shape[0]),
                  "fpset_occupancy": fp_count / table["slots"].shape[0],
                  "inserts_per_tile": 1, "commit_mode": "fused",
                  "max_msgs": int(self.codec.shape.MAX_MSGS)}
        if acts is not None:
            gauges["action_expansions"] = {
                n: int(c) for n, c in zip(self.kern.action_names, acts)}
            if self._lanes_disp:
                gauges["occupancy"] = round(
                    float(acts.sum()) / self._lanes_disp, 4)
        res.metrics = {"gauges": gauges, "counters": dict(self.counters)}
        return res


def device_bfs_check(spec, max_states=None, max_depth=None,
                     check_deadlock=False, tile_size=128, max_msgs=None,
                     log=None, device=None, **engine_kw) -> CheckResult:
    """Run the device BFS (message-table growth happens in place) on
    ``device`` (CUDA unless the caller asks for the CPU)."""
    eng = DeviceBFS(spec, max_msgs=max_msgs, tile_size=tile_size,
                    device=device, **engine_kw)
    return eng.run(max_states=max_states, max_depth=max_depth,
                   check_deadlock=check_deadlock, log=log)
