"""The behaviour graph of a state space, built by the device engines:
graph construction only.

The counterpart of ``tpuvsr/engine/device_liveness.py`` (``DeviceGraph``,
``_LazyStates``, ``dense_row``, ``_build_fp_index`` :205,
``_make_edge_pass`` :240, ``_build_edges`` :310), in both modes:

* ``"stream"`` (the default): the edges stream out of the safety BFS,
  ``PagedBFS(retain_levels=True, edges=True)``: K11 resolves every
  enabled item's successor to a gid through the gid column of the FPSet
  and K12 appends (src gid, action, dst gid) triples, which the host
  assembles into a CSR (``engine/spill.EdgeCSR``);
* ``"two-pass"``, the oracle the streamed graph is held to: the paged
  BFS enumerates and retains every level, a second FPSet maps each
  state's fingerprint to its gid (``insert_gids``: K1, then K11's
  store), and an edge pass re-expands every level a tile at a time (K6,
  K7, K10, K3), resolving successors with ``lookup_gids`` (K11).

Both give the same CSR up to the order of edges within one source's
segment (``testing.canon_csr``); ``two_pass_prefix`` runs the two-pass
over the first levels of a run cut at a depth.  Liveness needs SYMMETRY off.  The
property evaluation of the JAX module (``_run_batched``,
``batch_predicate``, ``batch_expr``) and ``engine/liveness.py`` need the
TLA+ frontend and the AST lowerer, which the port does not have yet.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..core.values import TLAError
from .fpset import empty_gids, empty_table, insert_gids, lookup_gids
from .paged_bfs import PagedBFS
from .spill import _block_rows
from .tile import Segments, compact, queue_buffers

I32 = torch.int32


class _LazyStates:
    """List-like view of the graph's states: decodes dense rows on
    demand and memoizes."""

    def __init__(self, graph):
        self.g = graph
        self._cache = {}

    def __len__(self):
        return self.g.n

    def __getitem__(self, sid):
        st = self._cache.get(sid)
        if st is None:
            st = self.g.codec.decode(self.g.dense_row(sid))
            self._cache[sid] = st
        return st


class DeviceGraph:
    """Behaviour graph (states, edges, inits) built by the device
    engines."""

    def __init__(self, spec, tile_size=64, chunk_tiles=16, max_states=None,
                 log=None, engine=None, result=None, mode="stream",
                 edge_spill_dir=None, **eng_kwargs):
        """Pass a finished ``engine`` (a PagedBFS built with
        ``retain_levels=True`` whose run() returned ``result``) to reuse
        its enumeration; one that ran with ``edges=True`` hands over its
        streamed CSR.  ``mode`` is ``"stream"`` or ``"two-pass"``."""
        if spec.symmetry_perms:
            raise TLAError("liveness checking requires SYMMETRY off")
        if mode not in ("stream", "two-pass"):
            raise ValueError(f"mode must be 'stream' or 'two-pass' "
                             f"(got {mode!r})")
        self.spec = spec
        t0 = time.time()
        if engine is not None:
            if result is None or not engine.retain_levels:
                raise ValueError("engine reuse needs retain_levels=True "
                                 "and the run's CheckResult")
            eng, res = engine, result
            mode = ("stream" if getattr(eng, "edge_sink", None) is not None
                    else "two-pass")
        else:
            eng = PagedBFS(spec, tile_size=tile_size,
                           chunk_tiles=chunk_tiles, retain_levels=True,
                           edges=(mode == "stream"),
                           edge_spill_dir=edge_spill_dir, **eng_kwargs)
            res = eng.run(max_states=max_states, log=log)
        self.mode = mode
        if res.error is not None:
            raise TLAError(f"device liveness graph: BFS did not reach "
                           f"fixpoint ({res.error})")
        if not res.ok:
            raise TLAError(
                f"device liveness graph: safety violation "
                f"{res.violated_invariant} during state enumeration "
                f"(check invariants before properties)")
        self.eng = eng
        self.codec, self.kern = eng.codec, eng.kern
        self.n = res.distinct_states
        self.inits = list(range(eng.level_sizes[0]))
        self.blocks = eng.level_blocks
        self._block_base = np.cumsum([0] + [_block_rows(b)
                                            for b in self.blocks])
        if self._block_base[-1] != self.n:
            raise TLAError(
                "device liveness graph: retained level blocks cover "
                f"{int(self._block_base[-1])} of {self.n} states")
        self.states = _LazyStates(self)
        self.bfs_elapsed = res.elapsed
        self.distinct_states = self.n
        self.states_generated = res.states_generated
        if mode == "stream":
            self.csr = eng.edge_sink.finalize(self.n)
            eng.edge_sink.drop()
        else:
            self._build_fp_index()
            self.csr = self._build_edges()
        self._edges_list = None
        self.build_elapsed = time.time() - t0
        # graph construction beyond the safety BFS, as a fraction of it
        self.graph_overhead_ratio = round(
            max(0.0, self.build_elapsed - self.bfs_elapsed)
            / max(self.bfs_elapsed, 1e-9), 4)
        if log:
            log(f"device behaviour graph ({mode}): {self.n} states, "
                f"{int(self.csr[1].shape[0])} edges in "
                f"{self.build_elapsed:.1f}s (BFS {self.bfs_elapsed:.1f}s)")

    # -- state access --------------------------------------------------
    def dense_row(self, sid):
        b = int(np.searchsorted(self._block_base, sid, side="right")) - 1
        i = sid - self._block_base[b]
        return {k: v[i] for k, v in self.blocks[b].items()}

    def _flat(self, blk, lo, hi):
        """Rows [lo, hi) of a dense level block as flat rows on the
        engine's device."""
        pk = self.eng._pk
        return pk.flatten({k: torch.as_tensor(v[lo:hi], device=self.eng.device)
                           for k, v in blk.items()}).contiguous()

    # -- fingerprint -> gid --------------------------------------------
    def _build_fp_index(self, blocks=None, batch=8192):
        """A gid-valued FPSet over the states of ``blocks`` (the first
        level blocks; default all) on the device: the fingerprint -> gid
        map the edge pass queries (``insert_gids``)."""
        dev = self.eng.device
        blocks = self.blocks if blocks is None else blocks
        n = sum(_block_rows(b) for b in blocks)
        cap = 1 << max(12, int(np.ceil(np.log2(max(n, 1) * 4))))
        self._gid_table = empty_table(cap, dev)
        self._gid_vals = empty_gids(cap, dev)
        gid = 0
        for blk in blocks:
            nb = _block_rows(blk)
            for off in range(0, nb, batch):
                m = min(batch, nb - off)
                fps = self.eng._fp(self._flat(blk, off, off + m))
                gids = torch.arange(gid, gid + m, dtype=I32, device=dev)
                _t, _v, ovf, fresh = insert_gids(
                    self._gid_table, self._gid_vals, fps, gids,
                    torch.ones((m,), dtype=torch.bool, device=dev))
                if bool(ovf):
                    raise TLAError("gid FPSet probe overflow (grow cap)")
                if int(fresh) != m:
                    raise TLAError("duplicate fingerprint across level "
                                   "blocks (engine invariant broken)")
                gid += m

    # -- edge pass -----------------------------------------------------
    def _edge_pass(self, flat, n_valid):
        """One tile of flat states -> (fp, src row, action id, ok) for
        every enabled lane: the level pass's guard matrix (K6), an
        exactly sized work queue (K7), the successors (K10) and their
        fingerprints (K3), recorded instead of inserted."""
        eng = self.eng
        kern, dev = eng.kern, eng.device
        T = flat.shape[0]
        valid = torch.arange(T, device=dev) < n_valid
        en, _any = eng._guards(flat)
        en = en & valid[:, None]
        counts = torch.zeros((len(kern.action_names),), dtype=torch.int64,
                             device=dev).index_add_(
            0, eng._lane_aid, en.sum(dim=0)).tolist()
        segs = Segments(eng._lane_off, eng._lanes, counts, dev)
        if segs.total == 0:
            return None
        q = queue_buffers(segs.total, len(kern.action_names), dev)
        compact(en, valid, segs, q)
        o = eng._successors(flat, q, segs)
        ok = o["en2"] & q["ok"]
        err = torch.where(ok, o["err"], 0)
        if bool((err != 0).any()):
            kind = ("bag overflow"
                    if bool(((err & eng._bag_bit) != 0).any())
                    else "slot error")
            raise TLAError(f"edge pass produced lane error ({kind}) on "
                           f"a successor the BFS accepted (engine bug)")
        return eng._fp(o["succ"]), q["pidx"], q["aid"], ok

    def _build_edges(self, blocks=None):
        """The second pass -> CSR (indptr[n+1], action_id[m], tid[m]):
        fingerprints resolve to gids on the device (``lookup_gids``).
        ``blocks`` (the first level blocks; default all) limits the
        sources, and the index must hold all their successors."""
        T = self.eng.tile
        src_parts, aid_parts, tid_parts = [], [], []
        for bi, blk in enumerate(self.blocks if blocks is None else blocks):
            base = int(self._block_base[bi])
            nb = _block_rows(blk)
            for off in range(0, nb, T):
                n_t = min(T, nb - off)
                out = self._edge_pass(self._flat(blk, off, off + n_t), n_t)
                if out is None:
                    continue
                fp, src, aid, ok = out
                tid = lookup_gids(self._gid_table, self._gid_vals, fp, ok)
                okm = ok.cpu().numpy()
                tids = tid.cpu().numpy()[okm]
                if (tids < 0).any():
                    raise TLAError("edge pass reached a state the BFS "
                                   "never recorded (fingerprint mismatch)")
                src_parts.append(base + off
                                 + src.cpu().numpy()[okm].astype(np.int64))
                aid_parts.append(aid.cpu().numpy()[okm])
                tid_parts.append(tids)
        src = (np.concatenate(src_parts) if src_parts
               else np.zeros(0, np.int64))
        aid = (np.concatenate(aid_parts) if aid_parts
               else np.zeros(0, np.int32))
        tid = (np.concatenate(tid_parts) if tid_parts
               else np.zeros(0, np.int32))
        order = np.argsort(src, kind="stable")
        src, aid, tid = src[order], aid[order], tid[order]
        indptr = np.zeros(self.n + 1, np.int64)
        np.cumsum(np.bincount(src, minlength=self.n), out=indptr[1:])
        return indptr, aid, tid

    @property
    def edges(self):
        """List-of-lists [(action_name, tid)] view of the CSR arrays,
        built on first access."""
        if self._edges_list is None:
            indptr, aid, tid = self.csr
            names = self.kern.action_names
            self._edges_list = [
                [(names[int(aid[j])], int(tid[j]))
                 for j in range(indptr[u], indptr[u + 1])]
                for u in range(self.n)]
        return self._edges_list


def two_pass_prefix(engine, levels):
    """The two-pass graph of a ``retain_levels`` run cut at a depth (no
    fixpoint, so no ``DeviceGraph``): the fingerprint index over level
    blocks 0..``levels`` and the edge pass over blocks 0..``levels``-1,
    whose successors all lie in the index.  Returns the CSR over the
    retained states (the expanded levels); the states of levels
    ``levels`` on have no edges."""
    g = DeviceGraph.__new__(DeviceGraph)
    g.eng, g.blocks = engine, engine.level_blocks
    g._block_base = np.cumsum([0] + [_block_rows(b) for b in g.blocks])
    g.n = int(g._block_base[-1])
    g._build_fp_index(blocks=g.blocks[:levels + 1])
    return g._build_edges(blocks=g.blocks[:levels])
