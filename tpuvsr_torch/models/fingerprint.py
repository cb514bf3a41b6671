"""Kernel K3, the 128-bit state fingerprint of the VSR family, full and
incremental, shared by the model kernels (``VSRKernel``, ``ST03Kernel``).

The arithmetic of ``tpuvsr/models/vsr_kernel.py`` (:1079-1172) and
``tpuvsr/models/st03_kernel.py`` (:763-907) with an identity permutation
table: a state hashes as

    rep_h[r]  = mix32(sum_c rep_row[r][c] * k_rep[w][c] + seed[w])
    slot_h[m] = mix32(sum_c slot_row[m][c] * k_msg[w][c] + seed[w])
    glob      = mix32(sum_c glob_row[c] * k_glob[w][c] + seed[w])
    total     = sum_r rep_h[r] + sum_m m_present[m] * slot_h[m]
    fp[w]     = mix32(mix32(total[w] + glob[w]) + seed[w])

for the four words w, in wrapping uint32 arithmetic.  A replica row is
the replica index followed by every per-replica plane of ``REP_KEYS``,
a slot row the planes of ``SLOT_KEYS`` at that slot.  The global row
(``GLOB_KEYS``, ST03's no_progress plane and counter) is optional: a
model without one (VSR) has no ``glob`` term at all.  ``parent_parts``
leaves it out of ``total``; the incremental fingerprint recomputes it
for each successor.

A subclass sets ``REP_KEYS``, ``SLOT_KEYS``, ``GLOB_KEYS``,
``FP_KERNELS`` (the ``kernels.KERNELS`` names its launches count under)
and, before ``_build_row_tables``, ``R``, ``M``, ``pk`` and the key
draws ``_k_rep``, ``_k_msg``, ``_k_glob`` (None without a global row)
and ``_seeds``.  CUDA tensors go to ``csrc/vsr_fingerprint.cu``, CPU
tensors to the plain versions here.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..engine.fpset import mul32
from ..engine.pack import MASK32, to_i32, to_u32

I32 = torch.int32


def mix32(x):
    """uint32 finalizer on int64 values in [0, 2^32)."""
    x = x ^ (x >> 16)
    x = mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


class RowFingerprint:
    REP_KEYS = ()
    SLOT_KEYS = ()
    GLOB_KEYS = ()
    FP_KERNELS = {}

    def _build_row_tables(self, pk):
        """Flat-lane index of every replica-row, slot-row and global-row
        column."""
        sp = {k: (a, s) for k, s, a, _e in pk._splits}
        R, M = self.R, self.M
        rep = [[-1] for _ in range(R)]
        for k in self.REP_KEYS:
            a, s = sp[k]
            per = int(np.prod(s)) // R
            for r in range(R):
                rep[r].extend(range(a + r * per, a + (r + 1) * per))
        slot = [[] for _ in range(M)]
        for k in self.SLOT_KEYS:
            a, s = sp[k]
            per = int(np.prod(s)) // M
            for m in range(M):
                slot[m].extend(range(a + m * per, a + (m + 1) * per))
        glob = []
        for k in self.GLOB_KEYS:
            a, s = sp[k]
            glob.extend(range(a, a + int(np.prod(s))))
        self._rep_cols = np.asarray(rep, np.int32)
        self._slot_cols = np.asarray(slot, np.int32)
        self._glob_cols = np.asarray(glob, np.int32)
        self._pres_cols = np.arange(M, dtype=np.int32) + sp["m_present"][0]
        self.nglob = len(glob)
        if self._rep_cols.shape[1] != self.nrep or \
                self._slot_cols.shape[1] != self.nmsg or \
                (self._k_glob is not None
                 and self._k_glob.shape[1] != self.nglob):
            raise ValueError("pack layout does not match the kernel rows")

    def fp_tables(self, device):
        key = str(torch.device(device))
        t = self._fp_tables.get(key)
        if t is None:
            t = {"rep_cols": torch.as_tensor(self._rep_cols),
                 "slot_cols": torch.as_tensor(self._slot_cols),
                 "pres_cols": torch.as_tensor(self._pres_cols),
                 "glob_cols": torch.as_tensor(self._glob_cols),
                 "k_rep": torch.as_tensor(self._k_rep.view(np.int32)),
                 "k_msg": torch.as_tensor(self._k_msg.view(np.int32)),
                 "k_glob": torch.as_tensor(
                     np.zeros((4, 0), np.int32) if self._k_glob is None
                     else self._k_glob.view(np.int32)),
                 "seeds": torch.as_tensor(self._seeds.view(np.int32))}
            t = {k: v.to(device) for k, v in t.items()}
            self._fp_tables[key] = t
        return t

    def _layout_args(self, t, lanes):
        ptr = lambda k: t[k].data_ptr() if t[k].numel() else None
        return (lanes, self.R, self.M, self.nrep, self.nmsg, self.nglob,
                ptr("rep_cols"), ptr("slot_cols"), ptr("pres_cols"),
                ptr("glob_cols"), ptr("k_rep"), ptr("k_msg"),
                ptr("k_glob"), ptr("seeds"))

    # -- plain versions (any device) -----------------------------------
    def _row_hash(self, vals, k, seeds):
        """[..., n] uint32 values (int64) x [4, n] coefficients ->
        [..., 4] mix32(sum + seed).  With a = a0 + 2^16 a1 and c = c0 +
        2^16 c1 in 16-bit halves, sum a c mod 2^32 is sum a0 c0 + 2^16
        (sum a0 c1 + a1 c0) mod 2^32: three float64 products whose
        integer sums stay below 2^53 (exact) while n < 2^20."""
        a0, a1 = (vals & 0xFFFF).double(), (vals >> 16).double()
        c0, c1 = (k & 0xFFFF).double().T, (k >> 16).double().T
        low = (a0 @ c0).long()
        mid = (a0 @ c1 + a1 @ c0).long()
        acc = (low + ((mid & 0xFFFF) << 16)) & MASK32
        return mix32((acc + seeds) & MASK32)

    def _rep_vals(self, flat, t, rows):
        """Values of replica rows ``rows`` ([B, K] int64) of each state."""
        cols = t["rep_cols"].long()[rows]                    # [B, K, nrep]
        vals = to_u32(flat.gather(
            1, cols.clamp(min=0).reshape(flat.shape[0], -1))).reshape(
            cols.shape)
        return torch.where(cols < 0, rows[:, :, None], vals)

    def _slot_vals(self, flat, t, slots):
        cols = t["slot_cols"].long()[slots]                  # [B, K, nmsg]
        return to_u32(flat.gather(
            1, cols.reshape(flat.shape[0], -1))).reshape(cols.shape)

    def _glob_hash(self, flat, t):
        """[B, 4] hash of each state's global row (0 without one)."""
        if not self.nglob:
            return 0
        vals = to_u32(flat[:, t["glob_cols"].long()])        # [B, nglob]
        return self._row_hash(vals, to_u32(t["k_glob"]), to_u32(t["seeds"]))

    def parent_parts_plain(self, flat):
        t = self.fp_tables(flat.device)
        B, dev = flat.shape[0], flat.device
        k_rep, k_msg = to_u32(t["k_rep"]), to_u32(t["k_msg"])
        seeds = to_u32(t["seeds"])
        reps = torch.arange(self.R, device=dev).expand(B, -1)
        slots = torch.arange(self.M, device=dev).expand(B, -1)
        rep_h = self._row_hash(self._rep_vals(flat, t, reps), k_rep, seeds)
        slot_h = self._row_hash(self._slot_vals(flat, t, slots), k_msg,
                                seeds)
        pres = to_u32(flat[:, t["pres_cols"].long()])        # [B, M]
        total = (rep_h.sum(dim=1)
                 + mul32(slot_h, pres[:, :, None]).sum(dim=1)) & MASK32
        return to_i32(rep_h), to_i32(slot_h), to_i32(total)

    def _finish_fp(self, total, seeds):
        return to_i32(mix32((mix32(total) + seeds) & MASK32))

    def fingerprint_plain(self, flat):
        t = self.fp_tables(flat.device)
        _r, _s, total = self.parent_parts_plain(flat)
        return self._finish_fp(
            (to_u32(total) + self._glob_hash(flat, t)) & MASK32,
            to_u32(t["seeds"]))

    def fingerprint_incremental_plain(self, succ, ri, ts, pidx, parent,
                                      parts):
        t = self.fp_tables(succ.device)
        k_rep, k_msg = to_u32(t["k_rep"]), to_u32(t["k_msg"])
        seeds = to_u32(t["seeds"])
        rep_h, slot_h, total = (to_u32(x) for x in parts)
        p, r = pidx.long(), ri.long()
        d = total[p] - rep_h[p, r]
        d = d + self._row_hash(self._rep_vals(succ, t, r[:, None]),
                               k_rep, seeds)[:, 0]
        ok = ts >= 0
        sc = ts.long().clamp(0, self.M - 1)                   # [n, nts]
        pcols = t["pres_cols"].long()[sc]
        pp = to_u32(parent[p].gather(1, pcols))
        sp = to_u32(succ.gather(1, pcols))
        new_h = self._row_hash(self._slot_vals(succ, t, sc), k_msg, seeds)
        old = mul32(slot_h[p[:, None], sc], pp[:, :, None])
        new = mul32(new_h, sp[:, :, None])
        d = d + torch.where(ok[:, :, None], new - old, 0).sum(dim=1)
        d = d + self._glob_hash(succ, t)
        return self._finish_fp(d & MASK32, seeds)

    # -- wrappers --------------------------------------------------------
    def parent_parts(self, flat):
        """[B, lanes] int32 states -> (rep_h [B, R, 4], slot_h [B, M, 4],
        total [B, 4]) int32 words: the per-row hashes and pre-mix sums
        (global row left out) the incremental fingerprint starts from."""
        if flat.device.type == "cpu":
            return self.parent_parts_plain(flat)
        return self._parts_kernel(flat, self.FP_KERNELS["parts"],
                                  want_fp=False)

    def fingerprint(self, flat):
        """[B, lanes] int32 states -> [B, 4] int32 fingerprint words."""
        if flat.device.type == "cpu":
            return self.fingerprint_plain(flat)
        return self._parts_kernel(flat, self.FP_KERNELS["full"],
                                  want_fp=True)

    def _parts_kernel(self, flat, name, want_fp):
        t = self.fp_tables(flat.device)
        B, dev = flat.shape[0], flat.device
        rep_h = torch.empty((B, self.R, 4), dtype=I32, device=dev)
        slot_h = torch.empty((B, self.M, 4), dtype=I32, device=dev)
        total = (None if want_fp else
                 torch.empty((B, 4), dtype=I32, device=dev))
        fp = torch.empty((B, 4), dtype=I32, device=dev) if want_fp else None
        kernels.launch(
            name, "tpuvsr_vsr_fp_parts",
            *self._layout_args(t, flat.shape[1]),
            kernels.check(flat, "flat", I32, (B, self.pk.lanes)), B,
            rep_h.data_ptr(), slot_h.data_ptr(),
            None if total is None else total.data_ptr(),
            None if fp is None else fp.data_ptr(),
            kernels.stream_of(flat))
        return fp if want_fp else (rep_h, slot_h, total)

    def fingerprint_incremental(self, succ, ri, ts, pidx, parent, parts):
        """Successor fingerprints from their parents' parts: ``succ``
        [n, lanes] successors, ``ri`` [n] the replica each mutated,
        ``ts`` [n, R+1] the touched slots (-1 padded), ``pidx`` [n] the
        parent row in ``parent`` [T, lanes] whose ``parent_parts`` are
        ``parts``.  Equal to ``fingerprint(succ)``."""
        if succ.device.type == "cpu":
            return self.fingerprint_incremental_plain(succ, ri, ts, pidx,
                                                      parent, parts)
        return self._incremental_kernel(succ, ri, ts, pidx, parent, parts)

    def _incremental_kernel(self, succ, ri, ts, pidx, parent, parts):
        t = self.fp_tables(succ.device)
        n, lanes = succ.shape
        T = parent.shape[0]
        rep_h, slot_h, total = parts
        ck = kernels.check
        fp = torch.empty((n, 4), dtype=I32, device=succ.device)
        kernels.launch(
            self.FP_KERNELS["incremental"], "tpuvsr_vsr_fp_incremental",
            *self._layout_args(t, lanes), ck(succ, "succ", I32, (n, lanes)),
            n, ck(ri, "ri", I32, (n,)),
            ck(ts, "ts", I32, (n, self.R + 1)), self.R + 1,
            ck(pidx, "pidx", I32, (n,)),
            ck(parent, "parent", I32, (T, lanes)),
            ck(rep_h, "rep_h", I32, (T, self.R, 4)),
            ck(slot_h, "slot_h", I32, (T, self.M, 4)),
            ck(total, "total", I32, (T, 4)), fp.data_ptr(),
            kernels.stream_of(succ))
        return fp

    def fingerprint_batch(self, batch):
        """Dense batch dict -> [B, 4] int32 fingerprints."""
        return self.fingerprint(self.pk.flatten(batch).contiguous())
