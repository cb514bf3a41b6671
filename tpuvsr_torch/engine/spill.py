"""Disk spill tier for the paged engine's host frontier pages, and the
incremental host CSR of the streamed behaviour graph.

A copy of ``tpuvsr/engine/spill.py`` (``SpillTier`` :75, ``EdgeCSR``
:221), numpy and host-only, with the JAX package's page file layout: a
level's pages are append-only files ``L<level>_<seq>.npz`` holding one
array ``rows`` (packed ``[n, words]`` uint32 rows) or one array a plane
(dense plane dicts), so a later checkpoint slice can share them.  The
run journal of the JAX package is not ported: a tier counts its disk
flushes (``flushes``) and bytes (``disk_bytes``) for the engine's
metrics instead.  What only a resumed run needs (``EdgeCSR.seed``, the
reclaim of a killed run's page files, ``SpillTier.row``/``all_rows``)
comes with checkpoints.

* one :class:`SpillTier` per frontier level: the paged engine's drains
  append blocks in commit order; at most ``ram_rows`` rows stay
  resident (plus one in-flight drain block), the rest go to the level's
  files and are read back sequentially (``block(start, n)``) when the
  level pages through the device; ``map_pages`` rewrites every page (the message-table growth re-pack);
  the consumed level's files are deleted (``drop``), so disk holds two
  levels' worth of rows;
* :class:`EdgeCSR`: the drained (src gid, action id, dst gid) triples in
  commit order, in RAM or past a RAM budget in a ``SpillTier`` under
  ``<spill_dir>/edges``; ``finalize(n)`` assembles the CSR arrays.
"""

from __future__ import annotations

import os

import numpy as np


def _block_rows(block):
    if isinstance(block, dict):
        k = next(iter(block))
        return int(block[k].shape[0])
    return int(block.shape[0])


def _concat(blocks):
    if isinstance(blocks[0], dict):
        return {k: np.concatenate([b[k] for b in blocks])
                for k in blocks[0]}
    return np.concatenate(blocks)


def _slice(block, lo, hi):
    if isinstance(block, dict):
        return {k: v[lo:hi] for k, v in block.items()}
    return block[lo:hi]


class SpillTier:
    """Append-only disk-backed row store for one frontier level."""

    def __init__(self, dirpath, level, ram_rows):
        self.dir = dirpath
        self.level = int(level)
        self.ram_rows = max(1, int(ram_rows))
        self._ram = []           # un-flushed blocks, in append order
        self._ram_count = 0
        self._pages = []         # [(path, rows)], flush order
        self._seq = 0
        self.rows = 0
        self.disk_bytes = 0      # cumulative bytes written to disk
        self.flushes = 0         # page files written
        self._last = None        # (path, data) — one-page read cache
        os.makedirs(dirpath, exist_ok=True)

    # -- write side ----------------------------------------------------
    def append(self, block):
        n = _block_rows(block)
        if n == 0:
            return
        self._ram.append(block)
        self._ram_count += n
        self.rows += n
        if self._ram_count > self.ram_rows:
            self._flush()

    def _flush(self):
        if not self._ram_count:
            return
        block = _concat(self._ram)
        path = os.path.join(self.dir,
                            f"L{self.level:05d}_{self._seq:05d}.npz")
        self._seq += 1
        with open(path, "wb") as f:
            if isinstance(block, dict):
                np.savez(f, **block)
            else:
                np.savez(f, rows=block)
            f.flush()
            os.fsync(f.fileno())
        nbytes = os.path.getsize(path)
        self._pages.append((path, self._ram_count))
        self.disk_bytes += nbytes
        self.flushes += 1
        self._ram = []
        self._ram_count = 0

    # -- read side -----------------------------------------------------
    def _load(self, path):
        # one-page cache: the chunk loop's reads are monotonic, so a
        # page overlapping several chunks would otherwise be re-read
        # (and re-decoded) once per chunk instead of once per level
        if self._last is not None and self._last[0] == path:
            return self._last[1]
        with np.load(path, allow_pickle=False) as z:
            if z.files == ["rows"]:
                data = z["rows"]
            else:
                data = {k: z[k] for k in z.files}
        self._last = (path, data)
        return data

    def _iter_pages(self):
        """Yield (start_row, rows, loader) over disk pages then the
        RAM tail, in global row order."""
        pos = 0
        for path, n in self._pages:
            yield pos, n, (lambda p=path: self._load(p))
            pos += n
        for b in self._ram:
            n = _block_rows(b)
            yield pos, n, (lambda b=b: b)
            pos += n

    def block(self, start, n):
        """Rows [start, start+n) assembled across page boundaries."""
        assert 0 <= start and start + n <= self.rows
        parts = []
        for pos, pn, load in self._iter_pages():
            if pos + pn <= start or pos >= start + n:
                continue
            data = load()
            lo = max(0, start - pos)
            hi = min(pn, start + n - pos)
            parts.append(_slice(data, lo, hi))
        return _concat(parts)

    # -- maintenance ---------------------------------------------------
    def map_pages(self, fn):
        """Rewrite every page (disk and RAM) through ``fn(block) ->
        block`` — the bag-growth re-pack path.  Row counts must be
        preserved."""
        new_pages = []
        for path, n in self._pages:
            block = fn(self._load(path))
            assert _block_rows(block) == n
            self.disk_bytes -= os.path.getsize(path)
            with open(path, "wb") as f:
                if isinstance(block, dict):
                    np.savez(f, **block)
                else:
                    np.savez(f, rows=block)
                f.flush()
                os.fsync(f.fileno())
            self.disk_bytes += os.path.getsize(path)
            new_pages.append((path, n))
        self._pages = new_pages
        self._ram = [fn(b) for b in self._ram]
        self._last = None

    def drop(self):
        """Delete this level's files (the level has been consumed)."""
        for path, _n in self._pages:
            try:
                os.unlink(path)
            except OSError:
                pass
        self._pages = []
        self._ram = []
        self._ram_count = 0
        self._last = None


class EdgeCSR:
    """Incremental host CSR of the streamed behaviour graph.
    The level pass's edge-emission commit drains
    ``(src gid, action id, dst gid)`` triples here in COMMIT ORDER;
    ``finalize(n)`` assembles the CSR arrays ``(indptr[n+1], aid[m],
    tid[m])`` the fair-SCC machinery consumes, preserving the drained
    order within each source's segment (the documented bit-identity
    contract: streamed vs two-pass CSRs agree modulo edge order within
    a (src, level) segment).

    Two storage modes: plain RAM blocks, or — past a RAM budget — the
    :class:`SpillTier` disk tier (append-only edge page files under
    ``<spill_dir>/edges``), so a 10^8-edge graph's triples never
    compete with the frontier for host RAM during the BFS.  A per-src
    degree count accumulates as blocks arrive, so ``finalize`` is two
    sequential passes (prefix-sum the counts, then scatter each block
    into its cursor positions) with no global sort."""

    #: bytes one edge row costs on the device append buffer
    ROW_BYTES = 12          # 3 x int32

    def __init__(self, spill_dir=None, ram_rows=None):
        self._tier = None
        self._blocks = []
        if spill_dir:
            self._tier = SpillTier(os.path.join(spill_dir, "edges"),
                                   0, ram_rows or (1 << 20))
        self._counts = np.zeros(1024, np.int64)
        self.rows = 0

    def append(self, src, aid, dst):
        src = np.ascontiguousarray(src, np.int64)
        n = int(src.shape[0])
        if n == 0:
            return
        hi = int(src.max()) + 1
        if hi > self._counts.shape[0]:
            grown = np.zeros(max(hi, 2 * self._counts.shape[0]),
                             np.int64)
            grown[:self._counts.shape[0]] = self._counts
            self._counts = grown
        self._counts[:hi] += np.bincount(src, minlength=hi)
        block = {"src": src,
                 "aid": np.ascontiguousarray(aid, np.int32),
                 "dst": np.ascontiguousarray(dst, np.int32)}
        if self._tier is not None:
            self._tier.append(block)
        else:
            self._blocks.append(block)
        self.rows += n

    def blocks(self):
        """Iterator of the accumulated blocks in drain order (one page
        resident at a time on the disk tier)."""
        if self._tier is not None:
            for _pos, _n, load in self._tier._iter_pages():
                yield load()
        else:
            yield from self._blocks

    def finalize(self, n):
        """Assemble ``(indptr, aid, tid)`` over node ids ``0..n-1``."""
        assert int(self._counts[n:].sum()) == 0, \
            "edge stream names a src gid beyond the state count"
        if self._counts.shape[0] < n:
            # counts only grow to the highest EDGE-EMITTING src gid —
            # trailing terminal states (no enabled action) are legal
            # zero-degree nodes, so pad rather than crash
            grown = np.zeros(n, np.int64)
            grown[:self._counts.shape[0]] = self._counts
            self._counts = grown
        indptr = np.zeros(n + 1, np.int64)
        np.cumsum(self._counts[:n], out=indptr[1:])
        assert int(indptr[-1]) == self.rows
        aid = np.empty(self.rows, np.int32)
        tid = np.empty(self.rows, np.int32)
        cursor = indptr[:-1].copy()
        for block in self.blocks():
            s = np.asarray(block["src"], np.int64)
            order = np.argsort(s, kind="stable")
            ss = s[order]
            first = np.concatenate([[True], ss[1:] != ss[:-1]])
            starts = np.flatnonzero(first)
            runs = np.diff(np.concatenate([starts, [ss.shape[0]]]))
            rank = np.arange(ss.shape[0]) - np.repeat(starts, runs)
            pos = cursor[ss] + rank
            aid[pos] = np.asarray(block["aid"], np.int32)[order]
            tid[pos] = np.asarray(block["dst"], np.int32)[order]
            cursor[ss[starts]] += runs
        assert (cursor == indptr[1:]).all()
        return indptr, aid, tid

    def drop(self):
        if self._tier is not None:
            self._tier.drop()
        self._blocks = []
