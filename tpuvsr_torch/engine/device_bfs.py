"""Device-resident breadth-first model checking engine (PyTorch/CUDA).

The counterpart of ``tpuvsr/engine/device_bfs.py``, packing on, through
two entry points that give the same results: ``run``, the chunked level
pass, and ``run_fused``, the fused pass; each takes either commit of the
JAX engine (``commit="fused"``, the default, or ``"per-action"``).  With
the fused commit a frontier tile flows through the same three stages in
both:

  guard matrix  --> every action's guard over every lane of the tile
                    (kernel K6 on the VSR model, after K4 unpacks the
                    packed rows): exact per-action enabled counts
  work queue    --> the enabled (state, lane) items of each action are
                    compacted in order (K7) and only they are expanded
                    and invariant-checked (K10 on the VSR model, one
                    launch over the whole queue), then fingerprinted
                    (K3, incremental from the parents' parts; with
                    symmetry on, K9 first maps each to the least element
                    of its orbit and K3 hashes that image in full)
  single commit --> one dedup (K2), one FPSet insert (K1) and one
                    pack-scatter (K4) into the next buffer

The pause protocol is the JAX engine's: a tile that meets a violation,
a slot error, a full message table, an expansion cap overflow, a probe
overflow or a full next buffer commits only the actions before the
first failing one (the committed-action prefix), reports a reason, and
the host grows the structure and re-enters at that tile; its inserts
persist and resolve as duplicates on re-entry.  Counts, level sizes and
traces are those of the JAX engine.

``run`` evaluates the guard matrix chunk-wide and reads the host once
per chunk (the per-tile per-action counts, which size each compaction
exactly) and once per tile (its reason flags and fresh count).

``run_fused`` keeps the whole loop state on the device (the carry of
``engine/tile.py``): each tile runs at the JAX body's fixed caps
``E_a``, the commit (K8 ``commit_prefix``, ``commit_finish``) steps the
carry, and at the end of a level K8 ``level_step`` appends the trace
pointers, records the level's size and makes the next buffer the
frontier, as ``_make_multilevel`` does.  On the card one tile is
captured as a CUDA graph and replayed a quantum of tiles at a time
(4, then four times more each read up to ``REPLAYS_CAP``, and 4 again
after a growth pause) with one host read of the carry after each
quantum; on a stop the host grows
what the reason names, captures the graph again and re-enters mid-level
with the partial level kept on the device.  A replay after a stop
commits nothing but costs a tile's device time, so the host sizes each
large level (at least four tiles) before it runs: K6 over the level's
rows gives its exact per-tile need, the caps are fitted to it and the
next buffer grown to hold every enabled item, and the quantum ends with
the level.  Small levels keep the JAX pause protocol.  On the CPU the
same loop runs eagerly on the plain versions.

Symmetry (``symmetry="auto" | True | False``) has the JAX engine's
meaning: auto is on iff the cfg declares SYMMETRY.  When it is on, the
fingerprint of a successor (and of an initial state) is that of its
orbit's least element (``engine/canon.py``; on the card K9 in the
model's relabel mode, VSR's and the family's alike), the incremental
hash is off, and the frontier keeps the generated successor, so traces
replay real states.

The per-action commit (``commit="per-action"``) is the JAX engine's
historical body (``make_body``, :458-673) and its oracle: the tile's
actions commit one after another, each with its own compaction (K7 on
the action's segment), successors (K10), fingerprints (K3; K9 then K3
with symmetry on), dedup (K2), insert (K1), the commit around them
(K15 ``action_gate`` and ``action_finish``) and pack-scatter (K4).  The
chain from one action to the next lives on the device (``engine/tile``
``PA_FIELDS``), so ``run`` reads the host once a tile and ``run_fused``
captures the whole tile in its CUDA graph.  Its caps are the JAX
per-action caps (``tile * expand_mults[a]`` lanes, the multiple 2 to
start and doubled for the action a tile overflowed), and a level's fit
before it runs sizes only the buffers, not those caps.  Among equal
fingerprints in one action's batch the JAX insert names the last lane
fresh (its scatter's last writer on the CPU); K2 runs over the reversed
batch so the same one is kept.  The fused commit keeps the first, so
the two commits give the same counts and levels and, where an action's
batch holds equal successors, other trace pointers (as the two JAX
commits do).

Edge emission (``edges=True``) streams the behaviour graph out of the
chunked level pass: after K1, K11 stores each fresh state's gid beside
its fingerprint and looks up every enabled item's destination gid, and
K12 appends (source gid, action, destination gid) to the device edge
buffers when the tile commits (``engine/edges.py``).  The drain of those
buffers lives in the host-paged loop, so only ``PagedBFS`` turns it on,
and only with symmetry off (a graph's nodes are concrete states).

Speclint and its facts (``bounds="auto"``, ``por="off"``, the JAX
engine's defaults, :140, :225-252): ``run`` and ``run_fused`` (and
``PagedBFS.run``) start with ``analysis.preflight``.  The bounds facts
(``engine/bounds.py``) prune statically dead actions from the kernel
(``PrunedKernel``: K6's columns, K10's action ids), tighten the pack to
the reachable intervals (``_pk``; ``_pk_decl`` keeps the declared layout)
and seed the fused caps from the static fanout; results are those with
bounds off.  The ample-set reduction (``engine/por.py``, ``por="on"``,
fused commit only) runs K17 (``engine/tile.py`` ``por_cand``,
``por_probe``, ``por_keep``) in each tile: a row whose ample candidate's
successors are all fresh (their FPSet level markers, the gid column,
above the frontier's level) commits only that action's successors, and
K11 stores marker depth + 1 on the fresh lanes after K1.  ``gen`` and
``act`` then count the kept expansions; ``_por_kept``, ``_por_full`` and
``_por_amp`` feed the ``por_cut_ratio``, ``ample_states`` and
``por_eligible_actions`` gauges.  A cfg-only binding (``SpecBinding``)
has no module text to analyse: under "auto" both resolve to None and
preflight runs no pass; "on" raises (the port's rule, the JAX package
has no such binding).

Left out of this port (see ROADMAP.md): the interpreter checks (the
violation cross-check is done with the kernel's own invariant functions
on the state rebuilt on the host), the dispatch window,
``run_chained``, checkpoints (with their bounds and POR manifest
checks), the run journal, and the fused pass's checkpoint and rescue
seams and wall-clock budget.  Results match the JAX engine with a window
of 1, which its own tests show gives the same results as the default.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..analysis import preflight
from ..analysis.widths import derive_ranges_from
from ..core.values import TLAError
from ..device import resolve_device
from ..models import registry
from .. import kernels
from .bfs import CheckResult
from .bounds import prune_kernel, resolve_bounds
from .canon import build_canon_spec, kernel_fold_order
from .device_sim import apply_one, failing_row
from .edges import emit_edges
from .fpset import (dedup_keep, empty_gids, empty_table, grow, insert_core,
                    lookup_gids, store_gids)
from .pack import build_pack_spec
from .por import PORFilter, resolve_por
from .tile import (C_AMP, C_DEAD, C_DEPTH, C_FP_COUNT, C_GEN, C_GFULL,
                   C_HALT, C_IDLE,
                   C_LEVEL_BASE, C_LVL_CUR, C_NEED, C_NEXT_CAP, C_N_FRONT,
                   C_NN, C_REASON, C_STOP, C_T, C_TILES, C_TP_CAP,
                   C_VIOL_AID, C_VIOL_LANE, C_VIOL_ROW, C_GROW_AID,
                   CARRY_FIELDS, ERR_BAG_OVERFLOW, F_AFLAGS, R_BAG_GROW,
                   R_DEADLOCK, R_EDGE_FLUSH, R_EXPAND_GROW, R_FPSET_GROW,
                   R_NEXT_GROW,
                   R_SLOT_ERR, R_VIOLATION, RUNNING, PA_FIELDS, P_COMMIT,
                   Segments, action_finish, action_gate, commit_finish,
                   commit_prefix, compact, level_step, new_carry,
                   por_buffers, por_cand, por_keep, por_probe, por_tables,
                   queue_buffers)
from .trace import TraceEntry

I32 = torch.int32
I64 = torch.int64
REPLAYS_CAP = 64      # tile replays per host read in the fused pass
_UNBOUNDED = 1 << 62


def _align8(n):
    return ((int(n) + 7) // 8) * 8


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
                 model_factory=None, device=None, symmetry="auto",
                 edges=False, commit="fused", bounds="auto", por="off"):
        if commit not in ("fused", "per-action"):
            raise TLAError(f"commit must be 'fused' or 'per-action' "
                           f"(got {commit!r})")
        if edges and not getattr(self, "_edges_on", False):
            # the level pass emits edges on any engine, but their drain
            # (R_EDGE_FLUSH -> the host CSR) is the paged loop's
            raise TLAError(
                "edge emission needs the host-paged drain loop; "
                "construct PagedBFS(edges=True)")
        self._edges_on = getattr(self, "_edges_on", False)
        self.device = resolve_device(device)
        self.spec = spec
        self._symmetry_req = symmetry
        self.tile = int(tile_size)
        self.fpset_capacity = int(fpset_capacity)
        self.next_cap = int(next_capacity)
        self.chunk_tiles = int(chunk_tiles)
        self.inv_names = list(spec.invariants)
        self._model_factory = model_factory or registry.make_model
        # the level-kernel commit (module docstring); the per-action
        # caps are tile x expand_mults[a] lanes (the JAX default
        # multiple 2), each doubled on its own R_EXPAND_GROW
        self.commit = commit
        self.expand_mults = None
        self.expand_caps = None
        self._need_seen = None
        self.level_sizes = []
        self.counters = {}
        # on the card run_fused replays a CUDA graph of one tile; a
        # caller that must see every kernel call as it happens turns
        # this off
        self.graphs = self.device.type == "cuda"
        # speclint's bounds facts (module docstring): dead actions
        # pruned, the pack tightened, the fused caps seeded from fanout
        self._facts = resolve_bounds(spec, bounds)
        self._pruned = []
        # the ample-set reduction: its facts, refused under a blocker
        # when forced; the filter is bound to the kernel in _build
        self._por_facts = resolve_por(
            spec, por,
            temporal=bool(getattr(spec, "temporal_props", None)
                          or spec.cfg.properties),
            edges=self._edges_on, commit=self.commit)
        self._por = None
        self._por_kept = self._por_full = self._por_amp = 0
        self._build(max_msgs)

    # ------------------------------------------------------------------
    def _build(self, max_msgs):
        """(Re)build codec and kernel for a message-table bound; called
        again on bag growth."""
        self.codec, self.kern = self._model_factory(self.spec,
                                                    max_msgs=max_msgs)
        # statically dead actions leave the kernel's lane tables; they
        # are never enabled, so results are those of the full kernel
        if self._facts is not None and self._facts.dead_actions:
            dead = [n for n in self._facts.dead_actions
                    if n in self.kern.action_names]
            if dead and len(dead) < len(self.kern.action_names):
                self.kern = prune_kernel(self.kern, dead)
                self._pruned = dead
        kern = self.kern
        # the pack tightened to the reachable intervals (_pk_decl keeps
        # the declared layout for the bound_tightening_ratio gauge); the
        # flat lane order, which the kernels read, is the same
        self._pk_decl = kern.pk
        tighten = (self._facts.plane_tighten()
                   if self._facts is not None else {})
        self._pk = kern.pk
        if tighten and kern.pk is not None:
            self._pk = build_pack_spec(
                self.codec, ranges=derive_ranges_from(
                    self.spec.cfg.constants, self.spec.module_name),
                tighten=tighten)
        # the model's bag-overflow flag; K8 knows the engine's bit only
        # (a stub model that never fills a bag declares none)
        self._bag_bit = getattr(kern, "ERR_BAG_OVERFLOW", ERR_BAG_OVERFLOW)
        if self._bag_bit != ERR_BAG_OVERFLOW:
            raise TLAError(
                f"{type(kern).__name__}.ERR_BAG_OVERFLOW = {self._bag_bit}: "
                f"the engine's commit reads bit {ERR_BAG_OVERFLOW}")
        names = kern.action_names
        if self.expand_mults is None:
            self.expand_mults = [2] * len(names)
        tl = [self.tile * kern._lane_count(n) for n in names]
        if self.expand_caps is None:
            self.expand_caps = [min(t, max(8, _align8(self.tile)))
                                for t in tl]
            # the bounds pass proves at most `fanout` lanes of an action
            # enabled per state: tile * fanout is a sound first cap
            if self._facts is not None:
                for a, n in enumerate(names):
                    fo = self._facts.fanout.get(n)
                    if fo:
                        self.expand_caps[a] = min(
                            tl[a], max(8, _align8(self.tile * fo)))
        else:
            self.expand_caps = [min(t, max(8, int(c)))
                                for t, c in zip(tl, self.expand_caps)]
        if self._need_seen is None or len(self._need_seen) != len(names):
            self._need_seen = np.zeros(len(names), np.int64)
        self._inv = kern.invariant_fn(self.inv_names)
        # K10 (kern.successors) checks the cfg's invariants by this mask
        self._inv_mask = (kern.invariant_mask(self.inv_names)
                          if hasattr(kern, "successors") else None)
        # rebuilt with the codec: the group table depends on V, the
        # key positions on the layout (MAX_MSGS)
        self._canon = build_canon_spec(self.spec, self.codec, kern,
                                       self._symmetry_req)
        if self._edges_on and (self._canon is not None
                               or kernel_fold_order(kern) > 1):
            raise TLAError(
                "edge emission requires symmetry off: the behaviour "
                "graph's nodes are concrete states, so orbit fingerprints "
                "would merge distinct graph nodes")
        # the least image's hash cannot come from the parent's parts
        self._incremental = (hasattr(kern, "parent_parts")
                             and self._canon is None)
        self._lanes = [kern._lane_count(n) for n in names]
        self._lane_off = [int(x) for x in
                          np.concatenate([[0], np.cumsum(self._lanes)[:-1]])]
        self._lane_aid = torch.as_tensor(
            np.repeat(np.arange(len(names)), self._lanes), device=self.device)
        # the ample-set filter bound to THIS kernel (rebuilt with it, so
        # the action alignment survives bag growth and pruning);
        # _por_active gates every device table: facts with no eligible
        # action leave the tile bodies as they are without POR
        self._por = (PORFilter(self._por_facts, kern)
                     if self._por_facts is not None else None)
        self._por_active = (self._por is not None
                            and self._por.any_eligible
                            and self.commit == "fused")
        if self._por_active:
            self._por_pt = por_tables(self._por.amat, self.device)

    def _expand_caps(self):
        """Per-action compaction capacities, in lanes: the fused
        commit's exact-count caps, or the per-action commit's tile
        multiples (JAX ``_expand_caps``)."""
        kern, T = self.kern, self.tile
        if self.commit == "per-action":
            return [min(T * kern._lane_count(n), max(64, int(T * m)))
                    for n, m in zip(kern.action_names, self.expand_mults)]
        return [min(T * kern._lane_count(n), max(8, int(c)))
                for n, c in zip(kern.action_names, self.expand_caps)]

    def _fp(self, flat, out=None):
        """Fingerprints of flat rows as the FPSet stores them: of the
        orbit's least element (K9 into ``out``, then K3) when symmetry is
        on."""
        if self._canon is not None:
            flat = self._canon.canonicalize(flat, out)
        return self.kern.fingerprint(flat)

    def _count(self, what, by=1):
        self.counters[what] = self.counters.get(what, 0) + by

    def _guards(self, flat, out=None, halt=None):
        """(en [B, n_lanes], en_any [B]) of flat rows: K6 where the model
        has it (``guard_matrix``), else the loop over its guards (which
        ignores ``halt``: a halted tile commits nothing anyway)."""
        kern = self.kern
        if hasattr(kern, "guard_matrix"):
            return kern.guard_matrix(flat, out, halt)
        st = self._pk.unflatten(flat)
        en = torch.cat([g(st) for g in kern._guard_fns()], dim=1)
        if out is None:
            return en, en.any(dim=1)
        out[0].copy_(en)
        out[1].copy_(en.any(dim=1))
        return out

    def _successors(self, flat, q, segs, out=None, halt=None):
        """The successors of the work queue ``q`` (over parents ``flat``,
        action segments ``segs``): a dict with ``succ`` [total, lanes],
        ``en2``, ``err`` and ``iok`` [total], and the touch lists ``ts``
        and replicas ``ri`` the incremental fingerprint reads.  K10 where
        the model has it (``successors``, one launch over the queue, into
        ``out`` when given), else each action's function on its segment
        (which ignores ``halt``: a halted tile commits nothing)."""
        kern = self.kern
        if hasattr(kern, "successors"):
            return kern.successors(flat, q["pidx"], q["aid"], q["lane"],
                                   self._inv_mask, out, halt)
        parts = [self._action_successors(flat, fn, q["pidx"][qo:qo + E],
                                         q["lane"][qo:qo + E])
                 for fn, (_lo, _L, E, qo) in zip(kern._action_fns(),
                                                  segs.host) if E]
        return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}

    def _action_successors(self, flat, fn, pidx, lane):
        """One action's function on the items (``pidx``, ``lane``) of
        the parents ``flat``: ``succ``, ``en2``, ``err``, ``iok``."""
        succ, en2 = fn(self._pk.unflatten(flat[pidx.long()]), lane.long())
        clean = {k: v for k, v in succ.items() if not k.startswith("_")}
        return {"succ": self._pk.flatten(clean), "en2": en2,
                "err": clean["err"].to(I32), "iok": self._inv(clean)}

    # ------------------------------------------------------------------
    # one chunk of tiles (the body of the JAX level pass)
    # ------------------------------------------------------------------
    def _level(self, table, front, n_front, start_t, bufs, nn,
               want_deadlock, eb=None, pdepth=0):
        """Run tiles start_t.. of the level until a reason stops the
        chunk or chunk_tiles tiles committed.  Returns the loop state
        as host values; ``table`` and ``bufs`` (and the edge buffers
        ``eb`` of an edge run, ``engine/edges.EdgeBuffers``) are updated
        in place.  ``pdepth`` is the frontier's level, the ample-set
        reduction's C3 marker bound."""
        T, K = self.tile, self.chunk_tiles
        pk, kern, dev = self._pk, self.kern, self.device
        n_tiles = (n_front + T - 1) // T
        kk = max(0, min(K, n_tiles - start_t))
        n_act = len(kern.action_names)
        caps = self._expand_caps()
        total_E = sum(caps)
        out = {"t": start_t, "reason": RUNNING, "viol": None, "dead": -1,
               "grow_aid": -1, "nn": nn, "dist": 0, "gen": 0,
               "gfull": 0, "amp": 0,
               "act": np.zeros(n_act, np.int64),
               "need": np.zeros(n_act, np.int64)}
        if kk == 0:
            return out
        # -- stage 1: chunk-wide guard matrix ---------------------------
        cidx = start_t * T + torch.arange(kk * T, device=dev)
        cvalid = cidx < n_front
        cflat = pk.unpack(front.nb, torch.clamp(cidx, 0, front.cap - 1))
        en, en_any = self._guards(cflat)
        en = en & cvalid[:, None]
        en_any = en_any & cvalid
        lane_sum = en.reshape(kk, T, -1).sum(dim=1)            # [kk, lanes]
        counts = torch.zeros((kk, n_act), dtype=I64, device=dev).index_add_(
            1, self._lane_aid, lane_sum).cpu().numpy()         # [kk, n_act]
        out["need"] = counts.max(axis=0)
        tile = self._tile if self.commit == "fused" else self._tile_pa
        pdepth_t = (torch.tensor([pdepth], dtype=I64, device=dev)
                    if self._por_active else None)
        while out["t"] < n_tiles and out["t"] < start_t + K:
            self._count("tiles")
            tile(out, table, bufs, cflat, en, en_any, cvalid, counts,
                 start_t, caps, total_E, want_deadlock, eb, pdepth_t)
            if out["reason"] != RUNNING:
                break
        if self._por_active:
            self._por_kept += out["gen"]
            self._por_full += out["gfull"]
            self._por_amp += out["amp"]
        return out

    def _tile(self, out, table, bufs, cflat, en, en_any, cvalid, counts,
              start_t, caps, total_E, want_deadlock, eb=None,
              pdepth_t=None):
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
        # the edge buffers' gate: a full one means "drain to the host"
        if eb is not None and eb.cap - eb.n < total_E:
            out["reason"] = R_EDGE_FLUSH
            return
        tile_flat = cflat[off:off + T]
        # K4's range flag rides along with the tile's host read, after
        # the tile's pack
        oob_flag = lambda: pk.range_flag(dev)[0].long()
        parts = kern.parent_parts(tile_flat) if self._incremental else None
        # the work queue, sized exactly from the chunk's counts (K7)
        sizes = [int(min(c, e)) for c, e in zip(cnts, caps)]
        segs = Segments(self._lane_off, self._lanes, sizes, dev)
        q = queue_buffers(segs.total, n_act, dev)
        ovf_first = int(np.argmax(ovf_vec)) if ovf_vec.any() else n_act
        dead = cvalid[off:off + T] & ~en_any[off:off + T]
        tail = [dead.any().long(), torch.argmax(dead.to(torch.int8))]
        if segs.total:
            compact(en[off:off + T], cvalid[off:off + T], segs, q)
            o = self._successors(tile_flat, q, segs)
            en2, aid_q = o["en2"], q["aid"].long()
            errv = torch.where(en2, o["err"], 0)
            viol = en2 & ~o["iok"] & (errv == 0)
            bag = (errv & self._bag_bit) != 0
            slot = (errv & ~self._bag_bit) != 0
            # the first action with a violation, a full bag or a slot
            # error, and the first violating item (queue order is action
            # order)
            first_bad = torch.clamp(torch.where(viol | bag | slot, aid_q,
                                                n_act).min(), max=ovf_first)
            vidx = torch.argmax(viol.to(torch.int8))
            fp_q = (kern.fingerprint_incremental(
                        o["succ"], o["ri"], o["ts"], q["pidx"], tile_flat,
                        parts) if self._incremental
                    else self._fp(o["succ"]))
            mcommit = en2 & (aid_q < first_bad)
            P = None
            if self._por_active:
                # K17 on the pre-insert table: a row whose ample
                # candidate's successors are all fresh keeps only them
                P = por_buffers(T, segs.total, n_act, dev)
                por_cand(en[off:off + T], cvalid[off:off + T], segs,
                         self._por_pt, P)
                por_probe(table, table["gids"], fp_q, en2, q, P, pdepth_t)
                por_keep(en2, q, P, pdepth_t)
                mcommit = mcommit & P["keep"]
            # -- stage 3: one dedup, one insert, one scatter -----------
            keep = dedup_keep(fp_q, mcommit)
            _tbl, fresh, ovf_i = insert_core(table, fp_q, keep)
            if P is not None:
                # the level markers ride the insert ungated: a paused
                # tile's own inserts read as fresh on re-entry
                store_gids(table["slots"], table["gids"], fp_q, P["mark"],
                           fresh)
            rank = torch.cumsum(fresh, 0) - 1 + out["nn"]
            dest = torch.where(fresh, rank, bufs.cap)
            pk.pack(o["succ"], out=bufs.nb,
                    dest=torch.where(fresh, rank, -1).to(I32))
            bufs.par[dest] = (base + q["pidx"]).to(I32)
            bufs.act[dest] = q["aid"]
            bufs.prm[dest] = q["lane"]
            ovf_t = torch.as_tensor(ovf_i, device=dev)
            # an edge run reads the count K12 appended with the rest
            emitted = [] if eb is None else [self._emit(
                table, eb, fp_q, fresh, rank, en2, q,
                (first_bad >= n_act) & (ovf_t == 0), base).long()]
            host = torch.cat([torch.stack([
                fresh.sum(), ovf_t.long(), first_bad, viol.any().long(),
                slot.any().long(), bag.any().long(),
                q["pidx"][vidx].long(), aid_q[vidx],
                q["lane"][vidx].long()] + tail + [oob_flag()] + emitted)]
                + ([] if P is None else [P["kept"], P["amp"]])
                ).cpu().numpy()
        else:
            P = None
            host = np.concatenate([[0, 0, ovf_first, 0, 0, 0, 0, 0, 0],
                                   torch.stack(tail + [oob_flag()]
                                               ).cpu().numpy()])
        h = [int(x) for x in host]
        if P is not None:
            kept, amp = np.asarray(h[-n_act - 1:-1], np.int64), h[-1]
            h = h[:-n_act - 1]
        if len(h) > 12:
            eb.n += h[12]
        (nfi, ovf_i, first_bad, viol_any, slot_any, bag_any, vrow, vaid,
         vlane, dead_any, dead_i, oob) = h[:12]
        pk.raise_if_out_of_range(oob)
        out["nn"] += nfi
        out["dist"] += nfi
        commit = first_bad >= n_act and not ovf_i
        if viol_any:
            out["viol"] = (base + vrow, vaid, vlane)
        if viol_any:
            reason = R_VIOLATION
        elif slot_any:
            reason = R_SLOT_ERR
        elif bag_any:
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
            if P is None:
                out["gen"] += int(cnts.sum())
                out["act"] += cnts
            else:
                # gen/act describe the reduced run; gfull the unreduced
                out["gen"] += int(kept.sum())
                out["act"] += kept
                out["gfull"] += int(cnts.sum())
                out["amp"] += amp
            if reason == RUNNING:
                out["t"] = t + 1

    def _emit(self, table, eb, fp_q, fresh, rank, en2, q, commit, base):
        """The edge block of a tile (after K1's insert): K11 stores each
        fresh state's gid (``gid_base`` + its next-buffer row) UNGATED,
        as the insert persists across a pause; K11 then looks up the
        destination gid of every enabled item, fresh and duplicate, in
        a launch of its own so it sees the stores; K12 appends the
        triples only when the tile commits (``commit``, on the device).
        Returns the count appended (a 0-dim tensor)."""
        gids = table["gids"]
        store_gids(table["slots"], gids, fp_q,
                   (eb.gid_base + rank).to(I32), fresh)
        emit = en2 & commit
        dst = lookup_gids(table, gids, fp_q, emit)
        return emit_edges(eb, en2, q["pidx"], q["aid"], dst, commit,
                          eb.src_base + base)

    # ------------------------------------------------------------------
    # the per-action commit (commit="per-action")
    # ------------------------------------------------------------------
    def _pa_buffers(self):
        """The tensors a per-action tile writes, for the current kernel
        and caps: the whole tile's queue (action a at its segment), the
        successors, the canonical images, the fingerprints (an edge run
        emits them at the tile's end), the commit masks, the rows K4
        scatters to, and K15's chain.  Kept while the kernel and the
        caps stay (``run``); ``run_fused`` holds them in its state."""
        kern, dev = self.kern, self.device
        caps = tuple(self._expand_caps())
        S = getattr(self, "_pa_cache", None)
        if S is not None and S["kern"] is kern and S["caps"] == caps:
            return S
        n_act = len(kern.action_names)
        segs = Segments(self._lane_off, self._lanes, caps, dev)
        z = lambda *shape, dtype=torch.bool: torch.zeros(
            shape, dtype=dtype, device=dev)
        S = {"kern": kern, "caps": caps, "segs": segs,
             "q": queue_buffers(segs.total, n_act, dev),
             "succ": (kern.successor_buffers(segs.total, dev)
                      if hasattr(kern, "successors") else None),
             "canon": (None if self._canon is None else
                       z(segs.total, self._pk.lanes, dtype=I32)),
             "fpq": z(segs.total, 4, dtype=I32),
             "mcommit": z(segs.total), "dest": z(segs.total, dtype=I32),
             "pa": z(len(PA_FIELDS), dtype=I64)}
        self._pa_cache = S
        return S

    def _pa_successors(self, flat, q, a, out, halt):
        """The successors of action ``a``'s queue segment ``q``: K10 into
        ``out`` where the model has it, else the action's function."""
        kern = self.kern
        if hasattr(kern, "successors"):
            return kern.successors(flat, q["pidx"], q["aid"], q["lane"],
                                   self._inv_mask, out, halt)
        return self._action_successors(flat, kern._action_fns()[a],
                                       q["pidx"], q["lane"])

    def _pa_body(self, S, carry, flat, en, en_any, valid, table, bufs,
                 eb=None, base=0):
        """One per-action tile on the device (no host sync): for each
        action in order, K7 on its segment, its successors (K10), their
        fingerprints (K3; K9 then K3 with symmetry on), K15's gate, K2
        over the reversed batch (the JAX insert's fresh lane among equal
        fingerprints is the last), K1, K15's finish and K4's
        pack-scatter.  An edge run (``eb``) stores each action's fresh
        gids (K11) after its insert, whatever the commit, and appends
        the tile's edges (K11's lookup, K12) once at its end, on the
        final commit flag."""
        kern, pk = self.kern, self._pk
        segs, q, pa = S["segs"], S["q"], S["pa"]
        total_e = segs.total
        halt = carry[C_HALT:C_HALT + 1]
        parts = kern.parent_parts(flat) if self._incremental else None
        en2_all = []
        for a, (_lo, _L, E, qo) in enumerate(segs.host):
            compact(en, valid, segs, q, carry, action=a)
            qa = {k: q[k][qo:qo + E] for k in ("pidx", "lane", "aid", "ok")}
            qa["ovf"] = q["ovf"][a:a + 1]
            out = (None if S["succ"] is None else
                   {k: v[qo:qo + E] for k, v in S["succ"].items()})
            o = self._pa_successors(flat, qa, a, out, halt)
            if self._incremental:
                fp = kern.fingerprint_incremental(
                    o["succ"], o["ri"], o["ts"], qa["pidx"], flat, parts)
            else:
                fp = self._fp(o["succ"], None if S["canon"] is None
                              else S["canon"][qo:qo + E])
            mcommit = S["mcommit"][qo:qo + E]
            dest = S["dest"][qo:qo + E]
            action_gate(carry, pa, qa, o, a, total_e, mcommit)
            keep = dedup_keep(fp.flip(0), mcommit.flip(0)).flip(0)
            _tbl, fresh, ovf_i = insert_core(table, fp, keep)
            if not isinstance(ovf_i, torch.Tensor):
                ovf_i = torch.tensor(int(ovf_i), dtype=I32)
            action_finish(carry, pa, qa, fresh, ovf_i, a, q["cnts"], en_any,
                          valid, bufs, dest)
            pk.pack(o["succ"], out=bufs.nb, dest=dest)
            if eb is not None:
                store_gids(table["slots"], table["gids"], fp,
                           (eb.gid_base + dest).to(I32), fresh)
                S["fpq"][qo:qo + E] = fp
                en2_all.append(o["en2"] & qa["ok"])
        if eb is None:
            return None
        en_q = torch.cat(en2_all)
        commit = pa[P_COMMIT] != 0
        dst = lookup_gids(table, table["gids"], S["fpq"], en_q & commit)
        return emit_edges(eb, en_q, q["pidx"], q["aid"], dst, commit,
                          eb.src_base + base)

    def _tile_pa(self, out, table, bufs, cflat, en, en_any, cvalid, counts,
                 start_t, caps, total_E, want_deadlock, eb=None,
                 pdepth_t=None):
        """One tile of ``run``'s level pass with the per-action commit:
        the headroom gates on the host (as ``_tile``), then the tile on
        the device (``_pa_body``) against a carry made for it, and one
        host read of the carry, K4's range flag and the edges
        appended."""
        T, pk, dev = self.tile, self._pk, self.device
        n_act = len(self.kern.action_names)
        t = out["t"]
        off = (t - start_t) * T
        if bufs.cap - out["nn"] < total_E:
            out["reason"] = R_NEXT_GROW
            return
        if eb is not None and eb.cap - eb.n < total_E:
            out["reason"] = R_EDGE_FLUSH
            return
        S = self._pa_buffers()
        carry = new_carry(n_act, dev, t=t, nn=out["nn"], next_cap=bufs.cap,
                          want_deadlock=bool(want_deadlock))
        emitted = self._pa_body(S, carry, cflat[off:off + T],
                                en[off:off + T], en_any[off:off + T],
                                cvalid[off:off + T], table, bufs, eb, t * T)
        extra = [] if emitted is None else [emitted.long()[None]]
        h = torch.cat([carry, pk.range_flag(dev).long()] + extra
                      ).cpu().tolist()
        if eb is not None:
            eb.n += h.pop()
        pk.raise_if_out_of_range(h.pop())
        self._count("tile_reads")
        nfi = h[C_FP_COUNT]
        out["nn"] += nfi
        out["dist"] += nfi
        reason = h[C_REASON]
        if reason == R_VIOLATION:
            out["viol"] = (h[C_VIOL_ROW], h[C_VIOL_AID], h[C_VIOL_LANE])
        if reason == R_DEADLOCK:
            out["dead"] = h[C_DEAD]
        if h[C_GROW_AID] >= 0:
            out["grow_aid"] = h[C_GROW_AID]
        out["gen"] += h[C_GEN]
        out["act"] += np.asarray(h[C_NEED + n_act:C_NEED + 2 * n_act],
                                 np.int64)
        out["reason"] = reason
        out["t"] = h[C_T]

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
        exceeds its cap (the chunk-wide guard matrix measured it); with
        the per-action commit, double the overflowing action's tile
        multiple (the JAX per-action growth)."""
        kern = self.kern
        if self.commit == "per-action":
            self.expand_mults[aid] *= 2
            self._count("grow_expand_buffer")
            emit(f"expand buffer for {kern.action_names[aid]} grown to "
                 f"tile x {self.expand_mults[aid]}")
            return
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
        observed per-tile maxima when that saves >= 20% of the lanes
        (the fused commit's caps only)."""
        if self.commit != "fused" or level_states < 4 * self.tile:
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
        ``flat`` [1, lanes], or None (``device_sim.failing_row``: one
        ``state_predicates`` call, K18 on the card)."""
        hit = failing_row(self.kern, flat, self.inv_names)
        return None if hit is None else hit[1]

    def _register_init(self, res):
        pk = self._pk
        pk.range_flag(self.device).zero_()
        init = self.spec.init_dense(self.codec)
        batch = {k: torch.as_tensor(np.stack([d[k] for d in init]),
                                    device=self.device)
                 for k in init[0]}
        flat = pk.flatten(batch).contiguous()
        fps = self._fp(flat).cpu().numpy()
        keep, seen = [], set()
        for i in range(len(init)):
            key = tuple(fps[i])
            if key not in seen:
                seen.add(key)
                keep.append(i)
        n0 = len(keep)
        self._init_flat = flat[keep]
        table = empty_table(self.fpset_capacity, self.device)
        fps0 = torch.as_tensor(fps[keep], device=self.device)
        ones = torch.ones((n0,), dtype=torch.bool, device=self.device)
        insert_core(table, fps0, ones)
        if self._edges_on:
            # graph node ids are commit order: the deduped initial
            # states take gids 0..n0-1
            table["gids"] = store_gids(
                table["slots"], empty_gids(self.fpset_capacity,
                                           self.device), fps0,
                torch.arange(n0, dtype=I32, device=self.device), ones)
        if self._por_active:
            # the C3 level-marker column: the initial states are level
            # 0, and a zero column gives each of them marker 0 without a
            # store (an empty slot's value is never read)
            table["gids"] = torch.zeros((self.fpset_capacity,), dtype=I32,
                                        device=self.device)
        self._h_parent = [np.full(n0, -1, np.int64)]
        self._h_action = [np.full(n0, -1, np.int32)]
        self._h_param = [np.zeros(n0, np.int32)]
        # every initial state's invariants in one state_predicates call
        hit = failing_row(self.kern, self._init_flat, self.inv_names)
        if hit is not None:
            i, res.violated_invariant = hit
            res.ok = False
            res.trace = self._trace(i)
            return table, n0, i
        res.states_generated += len(init)
        return table, n0, None

    def _materialize_one(self, flat, aid, param):
        """Apply one recorded (action, lane param) to one state [1,
        lanes] — the trace-replay step (K10 on the VSR model)."""
        succ, en = apply_one(self.kern, flat, aid, param)
        if not en:
            raise TLAError("trace replay chose a disabled lane")
        return succ

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
    def _start(self, log):
        """What every entry point does first: the speclint gate (before
        any device work; a report in which no pass ran for a cfg-only
        binding) and the reduction's counters reset."""
        preflight(self.spec, log=log)
        self._por_kept = self._por_full = self._por_amp = 0

    def run(self, max_states=None, max_depth=None, check_deadlock=False,
            log=None) -> CheckResult:
        self._start(log)
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
                                  n_next, check_deadlock,
                                  pdepth=depth - 1)
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

    # ------------------------------------------------------------------
    # fused run: the tile loop on the device, one host read a quantum
    # ------------------------------------------------------------------
    def _fused_state(self, front, bufs, table, tp, lvl_buf, carry):
        """The tensors one fused tile reads and writes, for the current
        kernel and caps: the CUDA graph of a tile holds their addresses,
        so they stay while it does."""
        kern, T, dev = self.kern, self.tile, self.device
        n_act = len(kern.action_names)
        segs = Segments(self._lane_off, self._lanes, self._expand_caps(),
                        dev)
        z = lambda *shape, dtype=torch.bool: torch.zeros(
            shape, dtype=dtype, device=dev)
        return {"front": front, "bufs": bufs, "table": table, "tp": tp,
                "lvl": lvl_buf, "carry": carry, "segs": segs,
                "q": queue_buffers(segs.total, n_act, dev),
                # K10's outputs
                "succ": (kern.successor_buffers(segs.total, dev)
                         if hasattr(kern, "successors") else None),
                # K9's output: the canonical images of the queue's rows
                "canon": (None if self._canon is None else
                          z(segs.total, self._pk.lanes, dtype=I32)),
                "en": z(T, sum(self._lanes)), "en_any": z(T),
                "tile": z(F_AFLAGS + n_act, dtype=I64),
                "mcommit": z(segs.total), "dest": z(segs.total, dtype=I32),
                "ar": torch.arange(T, device=dev),
                # K15's chain (the per-action commit)
                "pa": z(len(PA_FIELDS), dtype=I64),
                # K17's outputs (the ample-set reduction)
                "por": (por_buffers(T, segs.total, n_act, dev)
                        if self._por_active else None)}

    def _fused_tile(self, S):
        """One tile of the fused pass, with no host sync (the body the
        CUDA graph captures): the tile at the carry's ``t`` of the
        frontier through K6, K7, K10 over the queue at the fixed caps,
        K8's commit around K2/K1/K4, and K8's level step; with the
        per-action commit K6, then ``_pa_body`` (K15's commit an
        action), then the level step."""
        T, kern, pk = self.tile, self.kern, self._pk
        carry, front, bufs, q = S["carry"], S["front"], S["bufs"], S["q"]
        sidx = carry[C_T] * T + S["ar"]
        valid = sidx < carry[C_N_FRONT]
        tile_flat = pk.unpack(front.nb, torch.clamp(sidx, 0, front.cap - 1))
        en, en_any = self._guards(tile_flat, (S["en"], S["en_any"]),
                                  carry[C_HALT:C_HALT + 1])
        if self.commit == "per-action":
            self._pa_body(S, carry, tile_flat, en, en_any, valid,
                          S["table"], bufs)
            level_step(carry, bufs, front.nb, S["tp"], S["lvl"], T)
            return
        compact(en, valid, S["segs"], q, carry)
        parts = kern.parent_parts(tile_flat) if self._incremental else None
        o = self._successors(tile_flat, q, S["segs"], S["succ"],
                             carry[C_HALT:C_HALT + 1])
        fp_q = (kern.fingerprint_incremental(o["succ"], o["ri"], o["ts"],
                                             q["pidx"], tile_flat, parts)
                if self._incremental else self._fp(o["succ"], S["canon"]))
        P, table = S["por"], S["table"]
        if P is not None:
            # K17 before K1, the level (pdepth) read from the carry
            pdepth = carry[C_DEPTH:C_DEPTH + 1]
            por_cand(en, valid, S["segs"], self._por_pt, P)
            por_probe(table, table["gids"], fp_q, o["en2"], q, P, pdepth)
            por_keep(o["en2"], q, P, pdepth)
        commit_prefix(carry, q, o["en2"], o["iok"], o["err"], S["tile"],
                      S["mcommit"], None if P is None else P["keep"])
        keep = dedup_keep(fp_q, S["mcommit"])
        _tbl, fresh, ovf_i = insert_core(table, fp_q, keep)
        if not isinstance(ovf_i, torch.Tensor):
            ovf_i = torch.tensor(int(ovf_i), dtype=I32)
        if P is not None:
            store_gids(table["slots"], table["gids"], fp_q, P["mark"],
                       fresh)
        kept, amp = (None, None) if P is None else (P["kept"], P["amp"])
        commit_finish(carry, q, S["tile"], fresh, ovf_i, en_any, valid,
                      bufs, S["dest"], kept, amp)
        pk.pack(o["succ"], out=bufs.nb, dest=S["dest"])
        level_step(carry, bufs, front.nb, S["tp"], S["lvl"], T)

    def _tile_runner(self, S):
        """A function that runs one fused tile on ``S``: on the card the
        replay of a CUDA graph of ``_fused_tile`` (captured through
        ``kernels.capture``, after a warm-up on a halted copy of the
        carry, which commits nothing and fills the kernels' caches),
        else the eager call.  The replay function keeps ``S`` alive
        (``kernels.capture``): the graph writes its buffers."""
        # K4's range flag exists before a capture records its address
        self._pk.range_flag(self.device)
        if not self.graphs:
            return lambda: self._fused_tile(S)
        t0 = time.time()
        warm = dict(S)
        warm["carry"] = S["carry"].clone()
        warm["carry"][C_HALT] = 1
        self._fused_tile(warm)
        self._count("graph_captures")
        replay = kernels.capture(lambda: self._fused_tile(S))
        self._capture_s += time.time() - t0
        return replay

    def _replay(self, run_tile, n):
        """``n`` tiles, then the one host read of the quantum: the carry,
        the level-size buffer and K4's range flag in one copy (a set flag
        fails the run)."""
        for _ in range(n):
            run_tile()
        self._count("graph_replays", n)
        self._count("quanta")
        self._count("host_reads")
        h = torch.cat([self._fz_carry, self._fz_lvl,
                       self._pk.range_flag(self.device).long()]
                      ).cpu().tolist()
        self._pk.raise_if_out_of_range(h.pop())
        return h

    def _level_need(self, front, t0, n_front):
        """The exact per-action maxima over tiles ``t0..`` of the level in
        ``front`` and their total enabled count (K4 and K6 over the rows,
        ``chunk_tiles`` tiles at a time, one host read at the end)."""
        T, dev = self.tile, self.device
        n_act = len(self.kern.action_names)
        need = torch.zeros((n_act,), dtype=I64, device=dev)
        total = torch.zeros((1,), dtype=I64, device=dev)
        step = T * self.chunk_tiles
        for lo in range(t0 * T, n_front, step):
            k = -(-min(step, n_front - lo) // T)
            idx = lo + torch.arange(k * T, device=dev)
            flat = self._pk.unpack(front.nb, torch.clamp(idx, 0, front.cap - 1))
            en, _any = self._guards(flat)
            en = en & (idx < n_front)[:, None]
            per = torch.zeros((k, n_act), dtype=I64, device=dev).index_add_(
                1, self._lane_aid, en.reshape(k, T, -1).sum(dim=1))
            torch.maximum(need, per.amax(dim=0), out=need)
            total += per.sum()
        h = torch.cat([need, total]).cpu().tolist()
        self._count("level_fits")
        self._count("host_reads")
        return h[:n_act], h[n_act]

    def _fit_level(self, front, bufs, h, emit):
        """Size the rest of a large level before it runs (the fused
        pass's calibration): expansion caps onto its exact per-tile
        maxima (grown where short, shrunk when that saves >= 20% of the
        lanes), and the next buffer (x4 steps) so its headroom gate
        cannot fail, since the level adds at most its enabled count.
        The per-action commit keeps its caps and takes only the
        buffers.  Returns the buffers and whether anything changed."""
        kern, T = self.kern, self.tile
        need, gen_ub = self._level_need(front, h[C_T], h[C_N_FRONT])
        self._need_seen = np.maximum(self._need_seen, need)
        tgt = [min(T * kern._lane_count(n), max(8, _align8(max(x, 1))))
               for n, x in zip(kern.action_names, need)]
        cur = self._expand_caps()
        changed = False
        if self.commit == "fused" and (
                any(a > b for a, b in zip(tgt, cur))
                or sum(tgt) * 5 <= sum(cur) * 4):
            self.expand_caps = tgt
            changed = tgt != cur
            self._count("fit_expand_caps")
            emit(f"expand caps fitted to the level's exact maxima "
                 f"({sum(cur)} -> {sum(tgt)} lanes/tile)")
        while bufs.cap < h[C_NN] + gen_ub + sum(self._expand_caps()):
            front, bufs = front.grown(), bufs.grown()
            changed = True
            self._count("grow_next_buffer")
            emit(f"frontier buffers grown to {bufs.cap}")
        return front, bufs, changed

    def run_fused(self, max_states=None, max_depth=None,
                  check_deadlock=False, log=None,
                  levels_per_dispatch=256) -> CheckResult:
        """Like run(), through the fused pass (module docstring): the
        tile loop, the commit and the level step stay on the device, and
        the host reads the carry once per quantum of tiles.  Levels per
        host read are at most ``levels_per_dispatch``.  Counts, level
        sizes, traces and trace-pointer tables are those of run() and of
        the JAX package's run_fused."""
        if self._edges_on:
            raise TLAError("edge emission runs in PagedBFS.run (the "
                           "chunked level pass), not in run_fused")
        self._start(log)
        emit = log or (lambda msg: None)
        kern, T, dev = self.kern, self.tile, self.device
        n_act = len(kern.action_names)
        self._act_counts = np.zeros(n_act, np.int64)
        self._lanes_disp = 0
        self._capture_s = 0.0
        self.counters = {}
        res = CheckResult()
        t0 = time.time()
        self.level_sizes = []
        table, n0, viol = self._register_init(res)
        if viol is not None:
            return self._finish(res, n0, table, t0)
        gen0 = res.states_generated
        f_cap = max(self.next_cap, n0)
        front = _Bufs(f_cap, self._pk.words, dev)
        front.nb[:n0] = self._pk.pack(self._init_flat)
        bufs = _Bufs(f_cap, self._pk.words, dev)
        tp_cap = max(4 * f_cap, 1 << 16)
        tp = (torch.full((tp_cap,), -1, dtype=I32, device=dev),
              torch.full((tp_cap,), -1, dtype=I32, device=dev),
              torch.zeros((tp_cap,), dtype=I32, device=dev))
        self._fz_lvl = torch.zeros((levels_per_dispatch,), dtype=I64,
                                   device=dev)
        md = _UNBOUNDED if max_depth is None else int(max_depth)
        ms = int(max_states) if max_states else _UNBOUNDED
        self._fz_carry = carry = new_carry(
            n_act, dev, n_front=n0, fp_count=n0,
            want_deadlock=bool(check_deadlock), max_depth=md,
            max_states=ms, max_lvls=levels_per_dispatch, next_cap=f_cap,
            tp_cap=tp_cap)
        h = carry.tolist()
        self.level_sizes = [n0]
        run_tile, quantum, tiles_seen = None, 4, 0

        def set_pointers(n):
            self._h_parent = [tp[0][:n].cpu().numpy().astype(np.int64)]
            self._h_action = [tp[1][:n].cpu().numpy()]
            self._h_param = [tp[2][:n].cpu().numpy()]

        def finish():
            res.states_generated = gen0 + h[C_GEN]
            if self._por_active:
                self._por_kept = h[C_GEN]
                self._por_full = h[C_GFULL]
                self._por_amp = h[C_AMP]
            self._count("tiles", h[C_TILES])
            self._count("replays_after_stop", h[C_IDLE])
            self._finish(res, h[C_FP_COUNT], table, t0)
            res.metrics["gauges"]["graph_capture_s"] = self._capture_s
            return res

        def ocond():
            return (h[C_N_FRONT] > 0 and h[C_DEPTH] < md
                    and h[C_FP_COUNT] < ms
                    and h[C_LEVEL_BASE] + h[C_N_FRONT] + f_cap <= tp_cap)

        def grow_tp():
            nonlocal tp, tp_cap
            grown = False
            while h[C_LEVEL_BASE] + h[C_N_FRONT] + f_cap > tp_cap:
                tp = (torch.cat([tp[0], torch.full_like(tp[0], -1)]),
                      torch.cat([tp[1], torch.full_like(tp[1], -1)]),
                      torch.cat([tp[2], torch.zeros_like(tp[2])]))
                tp_cap *= 2
                grown = True
                self._count("grow_trace_pointers")
                emit(f"trace-pointer store grown to {tp_cap}")
            return grown

        entry, at_boundary, fitted = True, False, -1
        while True:
            if entry and (at_boundary or not ocond()):
                # where the JAX host lands when a dispatch returns
                # RUNNING: a level boundary
                at_boundary = False
                if h[C_N_FRONT] == 0:
                    break
                if max_depth is not None and h[C_DEPTH] >= max_depth:
                    res.error = f"depth limit {max_depth} reached"
                    break
                if max_states and h[C_FP_COUNT] >= max_states:
                    res.error = f"state limit {max_states} reached"
                    break
            # a large level is sized before its tiles run, and a quantum
            # ends with it, so the next one is sized too
            large = h[C_N_FRONT] >= 4 * T
            if large and fitted != h[C_DEPTH]:
                fitted = h[C_DEPTH]
                front, bufs, changed = self._fit_level(front, bufs, h, emit)
                f_cap = bufs.cap
                if changed:
                    run_tile, entry = None, True
            if grow_tp():
                run_tile, entry = None, True
            if entry:
                h[C_REASON] = h[C_HALT] = h[C_STOP] = h[C_LVL_CUR] = 0
                h[C_NEXT_CAP], h[C_TP_CAP] = f_cap, tp_cap
                carry.copy_(torch.tensor(h, dtype=I64))
                if run_tile is None:
                    run_tile = self._tile_runner(self._fused_state(
                        front, bufs, table, tp, self._fz_lvl, carry))
                entry = False
            n = quantum
            if large or h[C_DEPTH] + 1 >= md or 1 >= levels_per_dispatch:
                left = -(-h[C_N_FRONT] // T) - h[C_T]
                n = max(1, min(n, left))
            quantum = min(quantum * 4, REPLAYS_CAP)
            h = self._replay(run_tile, n)
            lv, h = h[len(CARRY_FIELDS) + 2 * n_act:], \
                h[:len(CARRY_FIELDS) + 2 * n_act]
            for x in lv[:h[C_LVL_CUR]]:
                self.level_sizes.append(int(x))
            if h[C_LVL_CUR]:
                carry[C_LVL_CUR] = 0
                h[C_LVL_CUR] = 0
            self._need_seen = np.maximum(
                self._need_seen, h[C_NEED:C_NEED + n_act])
            self._act_counts = np.asarray(
                h[C_NEED + n_act:C_NEED + 2 * n_act], np.int64)
            self._lanes_disp += (h[C_TILES] - tiles_seen) * sum(
                self._expand_caps())
            tiles_seen = h[C_TILES]
            reason = h[C_REASON]
            if reason == RUNNING:
                if h[C_STOP]:
                    entry = at_boundary = True
                continue
            level_base, n_front = h[C_LEVEL_BASE], h[C_N_FRONT]
            if reason == R_VIOLATION:
                vp, va, vprm = h[C_VIOL_ROW], h[C_VIOL_AID], h[C_VIOL_LANE]
                parent = self._pk.unpack(front.nb,
                                         torch.tensor([vp], device=dev))
                bad = self._first_failing(
                    self._materialize_one(parent, va, vprm))
                if bad is None:
                    raise TLAError(
                        "device invariant pass reported a violation the "
                        f"rebuilt state does not show (parent gid "
                        f"{level_base + vp}, action "
                        f"{self.kern.action_names[va]})")
                set_pointers(level_base + n_front)
                res.ok = False
                res.violated_invariant = bad
                res.trace = self._trace(level_base + vp, extra=(va, vprm))
                res.diameter = h[C_DEPTH] + 1
                return finish()
            if reason == R_DEADLOCK:
                di = h[C_DEAD]
                set_pointers(level_base + n_front)
                res.ok = False
                res.error = "deadlock"
                row = self._pk.unpack(front.nb,
                                      torch.tensor([di], device=dev))
                res.deadlock_state = self._decode(row)
                res.trace = self._trace(level_base + di)
                res.diameter = h[C_DEPTH] + 1
                return finish()
            self._count("growth_pauses")
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
                front, bufs = front.grown(), bufs.grown()
                f_cap = bufs.cap
                self._count("grow_next_buffer")
                emit(f"frontier buffers grown to {f_cap}")
            elif reason == R_EXPAND_GROW:
                self._grow_expand(h[C_GROW_AID], emit)
            elif reason == R_SLOT_ERR:
                raise TLAError(
                    "dense-layout slot collision (a second DVC or "
                    "recovery response from one source in one view): "
                    "this interleaving needs the multi-slot layout")
            run_tile, entry = None, True
            quantum = 4          # the next stop may be as near
        set_pointers(h[C_FP_COUNT] if h[C_N_FRONT] == 0
                     else h[C_LEVEL_BASE] + h[C_N_FRONT])
        res.diameter = h[C_DEPTH]
        return finish()

    def _finish(self, res, fp_count, table, t0):
        self.table = table          # the run's FPSet, kept for callers
        res.distinct_states = fp_count
        res.levels = list(self.level_sizes)
        res.elapsed = time.time() - t0
        res.states_per_sec = fp_count / res.elapsed if res.elapsed else 0.0
        acts = getattr(self, "_act_counts", None)
        gauges = {"fpset_capacity": int(table["slots"].shape[0]),
                  "fpset_occupancy": fp_count / table["slots"].shape[0],
                  "inserts_per_tile": (1 if self.commit == "fused"
                                       else len(self.kern.action_names)),
                  "commit_mode": self.commit,
                  "max_msgs": int(self.codec.shape.MAX_MSGS),
                  # the group order this run reduced by (1 = off), and
                  # generated / distinct, which folds the orbit factor
                  # in when symmetry is on
                  "symmetry_perms": (self._canon.perms
                                     if self._canon is not None
                                     else kernel_fold_order(self.kern))}
        if res.states_generated and fp_count:
            gauges["orbit_ratio"] = round(res.states_generated / fp_count, 4)
        if self._facts is not None:
            # what the bounds pass proved and how many pack bits it saved
            if self._facts.state_bound is not None:
                gauges["state_bound"] = int(self._facts.state_bound)
            gauges["dead_actions"] = len(self._pruned)
            ratio = 1.0
            if self._pk is not None and self._pk_decl is not None and \
                    self._pk.total_bits:
                ratio = self._pk_decl.total_bits / self._pk.total_bits
            gauges["bound_tightening_ratio"] = round(ratio, 4)
        if self._por is not None:
            # generated kept / generated full (1.0 when inert), and the
            # expanded states that took the shortcut with work elided
            full = int(self._por_full)
            gauges["por_cut_ratio"] = (round(int(self._por_kept) / full, 4)
                                       if full else 1.0)
            gauges["ample_states"] = int(self._por_amp)
            gauges["por_eligible_actions"] = self._por.n_eligible
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
