"""Batched transition kernel for VSR (reference: VSR.tla:366-918), and
kernel K3 (the VSR fingerprint).

The PyTorch counterpart of ``tpuvsr/models/vsr_kernel.py``.  The JAX
kernel writes every action for ONE state and vmaps it; here every
function takes a batch: ``st`` is a dict of ``[B, ...plane]`` int32
tensors (views of one flat ``[B, lanes]`` row block, see
``engine/pack.py``) and an action takes one lane index per batch item
(``lane`` [B]) and returns (successor dict, enabled [B]).  Guards take
the batch alone and return the ``[B, L_a]`` enabled matrix over all of
the action's lanes.  Successors are computed out of place (a plane an
action changes is a new tensor; the others are shared with ``st``).

Lane plan, semantics and the canonical-zero invariant are those of the
JAX kernel (see its docstring); the arithmetic is identical, so guards,
successors, fingerprints and invariants are bit-identical to it.

K3: ``fingerprint``, ``parent_parts`` and ``fingerprint_incremental``
(``models/fingerprint.RowFingerprint``) send CUDA tensors to
``csrc/vsr_fingerprint.cu`` and CPU tensors to their plain versions.
The engine builds the kernel with
an identity-only permutation table (``fold_symmetry=False``), which is
the only table the port supports: symmetry is reduced before the
fingerprint, by ``engine/canon.py`` through ``SYM_PLANES`` and
``_permuted``.

K6: ``guard_matrix`` evaluates all 19 guards over every lane of flat
rows in one launch (``csrc/vsr_guards.cu``); its plain version is the
loop over ``_guard_fns``.

K10: ``successors`` applies a work queue of (parent row, action, lane)
items in one launch (``csrc/vsr_actions.cu``): the successor rows, the
actions' enabled bits, the error flags, the incremental fingerprint's
touch lists and lane replicas, and the cfg invariants on each
successor.  Its plain version ``successors_plain`` runs the ``act_*``
functions of this module on the items of each action; every call of
``_action_fns`` (the plain actions' only door) is counted in
``PLAIN_CALLS``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from .. import kernels
from ..engine.canon import relabel
from .fingerprint import RowFingerprint
from .vsr import (E_CLIENT, E_OPER, E_REQ, E_VIEW, ERR_BAG_OVERFLOW,
                  ERR_DVC_OVERFLOW, ERR_REC_OVERFLOW, H_COMMIT, H_DEST,
                  H_FIRST, H_LNV, H_OP, H_SRC, H_TYPE, H_VIEW, H_X,
                  M_DVC, M_GETSTATE, M_NEWSTATE, M_PREPARE, M_PREPAREOK,
                  M_RECOVERY, M_RECOVERYRESP, M_SV, M_SVC, NENT,
                  NORMAL, RECOVERING, T_EXEC, T_REQ, VIEWCHANGE,
                  VSRCodec)

I32 = torch.int32
INF = 0x7FFFFFFF

ACTION_NAMES = (
    "TimerSendSVC", "ReceiveHigherSVC", "ReceiveMatchingSVC", "SendDVC",
    "ReceiveHigherDVC", "ReceiveMatchingDVC", "SendSV", "ReceiveSV",
    "ReceiveClientRequest", "ReceivePrepareMsg", "ReceivePrepareOkMsg",
    "ExecuteOp", "SendGetState", "ReceiveGetState", "ReceiveNewState",
    "RestartEmpty", "ReceivesRecoveryMsg", "ReceivesRecoveryResponseMsg",
    "CompleteRecovery",
)

REP_KEYS = ("status", "view", "op", "commit", "lnv", "log", "log_len",
            "peer_op", "ct", "svc", "dvc", "dvc_lnv", "dvc_op",
            "dvc_commit", "dvc_log", "dvc_log_len", "sent_dvc", "sent_sv",
            "rec_number", "rec", "rec_view", "rec_has_log", "rec_log",
            "rec_log_len", "rec_op", "rec_commit")
MSG_KEYS = ("m_present", "m_count", "m_hdr", "m_entry", "m_log",
            "m_log_len", "m_has_log")
AUX_KEYS = ("aux_svc", "aux_restart", "aux_acked", "err")
ALL_KEYS = REP_KEYS + MSG_KEYS + AUX_KEYS
# calls of VSRKernel._action_fns, the door to the plain action functions
PLAIN_CALLS = {"actions": 0}
# the planes K6 reads, in the order of csrc/vsr_guards.cu enum Plane
GUARD_PLANES = ("status", "view", "op", "commit", "log_len", "peer_op",
                "ct", "svc", "dvc", "sent_dvc", "sent_sv", "rec_number",
                "rec", "rec_has_log", "m_present", "m_count", "m_hdr",
                "m_entry", "m_log", "m_log_len", "m_has_log", "aux_svc",
                "aux_restart", "aux_acked")


# ----------------------------------------------------------------------
# batched index helpers: x is [B, n, ...], i (and j) are [B] indices.
# A Python int operand never becomes a tensor through a host-to-device
# copy (which would stall the host on every call on the card, and which
# a CUDA graph cannot capture): it is filled on the device or passed to
# torch as a scalar.
# ----------------------------------------------------------------------
_ARANGE = {}


def _iota(n, device):
    """torch.arange(n) on ``device``, built once per (n, device); only
    ever read."""
    t = _ARANGE.get((n, device))
    if t is None:
        t = _ARANGE[(n, device)] = torch.arange(n, device=device)
    return t


def _ar(x):
    return _iota(x.shape[0], x.device)


def _take(x, i):
    """x[b, i[b]]"""
    return x[_ar(x), i.long()]


def _take2(x, i, j):
    """x[b, i[b], j[b]]"""
    return x[_ar(x), i.long(), j.long()]


def _val(v, x):
    """v as a value to store into x (a Python int is filled on x's
    device)."""
    if isinstance(v, int):
        return torch.full((), v, dtype=x.dtype, device=x.device)
    return v.to(x.dtype)


def _put(x, i, v):
    """Copy of x with x[b, i[b]] = v[b] (v broadcasts per item)."""
    y = x.clone()
    y[_ar(x), i.long()] = _val(v, x)
    return y


def _put2(x, i, j, v):
    y = x.clone()
    y[_ar(x), i.long(), j.long()] = _val(v, x)
    return y


def _where(pred, a, b):
    """torch.where with a [B] predicate broadcast over trailing axes
    (int32 result)."""
    nd = max(a.dim() if isinstance(a, torch.Tensor) else 0,
             b.dim() if isinstance(b, torch.Tensor) else 0)
    return torch.where(pred.reshape((-1,) + (1,) * (nd - 1)), a, b).to(I32)


def _first_true(x):
    """Index of the first True along the last axis (0 when none), the
    value jnp.argmax gives a bool vector."""
    n = x.shape[-1]
    first = torch.where(x, _iota(n, x.device), n).amin(dim=-1)
    return torch.where(first == n, 0, first)


def _clip(x, lo, hi):
    return torch.clamp(x, lo, hi)


def _col(v, B, device):
    """A scalar or [B] value as a [B] int32 column."""
    if isinstance(v, int):
        return torch.full((B,), v, dtype=I32, device=device)
    return v.to(I32).expand(B)


def _lex_less(a, b):
    """Row-wise lexicographic a < b on [B, K] int tensors."""
    ne = a != b
    first = _first_true(ne)
    ai = a.gather(1, first[:, None])[:, 0]
    bi = b.gather(1, first[:, None])[:, 0]
    return ne.any(dim=1) & (ai < bi)


class VSRKernel(RowFingerprint):
    action_names = ACTION_NAMES
    ERR_BAG_OVERFLOW = ERR_BAG_OVERFLOW
    REP_KEYS = REP_KEYS
    MSG_KEYS = MSG_KEYS
    AUX_KEYS = AUX_KEYS
    # plane -> orbit table (tpuvsr/models/vsr_kernel.py:115): a value
    # permutation relabels the operation column of every log-entry row;
    # _permuted applies exactly this, and engine/canon.py reads it
    SYM_PLANES = {"log": ("col", E_OPER), "dvc_log": ("col", E_OPER),
                  "rec_log": ("col", E_OPER), "m_log": ("col", E_OPER),
                  "m_entry": ("col", E_OPER)}
    # K9 relabels those columns as _permuted does: plain value ids
    CANON_MODE = ("plain", 0)
    CANON_KERNEL = "vsr_canon"

    def __init__(self, codec: VSRCodec, perms: np.ndarray = None,
                 pack_spec=None):
        self.codec = codec
        self.shape = s = codec.shape
        self.R, self.V, self.M = s.R, s.V, s.MAX_MSGS
        self.MAX_OPS = s.MAX_OPS
        self.NHDR = codec.NHDR
        if perms is None:
            perms = np.arange(s.V + 1, dtype=np.int32)[None, :]
        self.perms = np.asarray(perms, dtype=np.int32)
        if self.perms.shape[0] != 1 or not (
                self.perms[0] == np.arange(s.V + 1)).all():
            raise ValueError("the port's VSR kernel takes the identity "
                             "permutation table only (fold_symmetry="
                             "False)")
        acts, params = [], []
        for aid, name in enumerate(ACTION_NAMES):
            n = self._lane_count(name)
            acts.append(np.full(n, aid, np.int32))
            params.append(np.arange(n, dtype=np.int32))
        self.lane_action = np.concatenate(acts)
        self.lane_param = np.concatenate(params)
        self.n_lanes = int(self.lane_action.size)

        # the same coefficient draw as the JAX kernel (same generator,
        # same seed, same order), so fingerprints agree bit for bit
        rng = np.random.default_rng(0xC0FFEE)
        nrep = 1 + sum(int(np.prod(self._rep_shape(k))) // s.R
                       for k in REP_KEYS)
        nmsg = self.NHDR + NENT + self.MAX_OPS * NENT + 3
        self.nrep, self.nmsg = nrep, nmsg
        self._k_rep = (rng.integers(1, 2**32, size=(4, nrep),
                                    dtype=np.uint64)
                       .astype(np.uint32) | 1)
        self._k_msg = (rng.integers(1, 2**32, size=(4, nmsg),
                                    dtype=np.uint64)
                       .astype(np.uint32) | 1)
        self._k_glob = None
        self._seeds = (rng.integers(1, 2**32, size=(4,), dtype=np.uint64)
                       .astype(np.uint32))
        self.pk = pack_spec
        self._fp_tables = {}
        if pack_spec is not None:
            self._build_row_tables(pack_spec)

    def _permuted(self, st, perm):
        """Remap the value ids of a batch through one symmetry permutation
        (``perm`` [V+1], 0 -> 0): the operation column of every log-entry
        row (rep/dvc/rec logs, message entry and payload logs), as
        ``tpuvsr/models/vsr_kernel.py:_permuted`` does for one state."""
        st = dict(st)
        for k in self.SYM_PLANES:
            v = st[k].clone()
            v[..., E_OPER] = relabel(perm, v[..., E_OPER])
            st[k] = v
        return st

    def _rep_shape(self, k):
        s = self.shape
        return {
            "status": (s.R,), "view": (s.R,), "op": (s.R,), "commit": (s.R,),
            "lnv": (s.R,), "log": (s.R, s.MAX_OPS, NENT), "log_len": (s.R,),
            "peer_op": (s.R, s.R), "ct": (s.R, s.C, 3), "svc": (s.R, s.R),
            "dvc": (s.R, s.R), "dvc_lnv": (s.R, s.R), "dvc_op": (s.R, s.R),
            "dvc_commit": (s.R, s.R),
            "dvc_log": (s.R, s.R, s.MAX_OPS, NENT),
            "dvc_log_len": (s.R, s.R), "sent_dvc": (s.R,), "sent_sv": (s.R,),
            "rec_number": (s.R,), "rec": (s.R, s.R), "rec_view": (s.R, s.R),
            "rec_has_log": (s.R, s.R), "rec_log": (s.R, s.R, s.MAX_OPS, NENT),
            "rec_log_len": (s.R, s.R), "rec_op": (s.R, s.R),
            "rec_commit": (s.R, s.R),
        }[k]

    def _lane_count(self, name):
        R, V, M = self.R, self.V, self.M
        return {"TimerSendSVC": R, "SendDVC": R, "SendSV": R, "ExecuteOp": R,
                "RestartEmpty": R, "CompleteRecovery": R,
                "ReceiveClientRequest": R * V, "SendGetState": M * R,
                }.get(name, M)

    # ==================================================================
    # message-bag primitives (VSR.tla:228-275), batched
    # ==================================================================
    def _row(self, B, dev, type_, view=0, op=0, commit=0, dest=0, src=0,
             x=0, first=0, lnv=0, entry=None, log=None, log_len=0,
             has_log=0):
        cols = [_col(v, B, dev) for v in
                (type_, view, op, commit, dest, src, x, first, lnv)]
        hdr = torch.zeros((B, self.NHDR), dtype=I32, device=dev)
        hdr[:, :9] = torch.stack(cols, dim=1)
        return {
            "hdr": hdr,
            "entry": (entry if entry is not None
                      else torch.zeros((B, NENT), dtype=I32, device=dev)),
            "log": (log if log is not None else
                    torch.zeros((B, self.MAX_OPS, NENT), dtype=I32,
                                device=dev)),
            "log_len": _col(log_len, B, dev),
            "has_log": _col(has_log, B, dev),
        }

    def _row_eq(self, st, row):
        """[B, M] mask: domain entry equal to row (full record equality)."""
        return ((st["m_present"] == 1)
                & (st["m_hdr"] == row["hdr"][:, None, :]).all(-1)
                & (st["m_entry"] == row["entry"][:, None, :]).all(-1)
                & (st["m_log"] == row["log"][:, None]).all(-1).all(-1)
                & (st["m_log_len"] == row["log_len"][:, None])
                & (st["m_has_log"] == row["has_log"][:, None]))

    def _touch(self, st, idx, pred):
        """Record a touched message slot for incremental fingerprinting
        (no-op unless the caller seeded the "_ts" scratch keys)."""
        if "_ts" not in st:
            return st
        st = dict(st)
        n = _clip(st["_tn"], 0, st["_ts"].shape[1] - 1)
        st["_ts"] = _where(pred, _put(st["_ts"], n, idx), st["_ts"])
        st["_tn"] = st["_tn"] + pred.to(I32)
        return st

    def _bag_send(self, st, row, pred=None):
        """SendFunc upsert (VSR.tla:228-231): +1 if present (tombstones
        revive), else insert at the first free slot with count 1."""
        B, dev = st["m_present"].shape[0], st["m_present"].device
        if pred is None:
            pred = torch.ones((B,), dtype=torch.bool, device=dev)
        eq = self._row_eq(st, row)
        found = eq.any(dim=1)
        free = st["m_present"] == 0
        idx = torch.where(found, _first_true(eq), _first_true(free))
        overflow = pred & ~found & ~free.any(dim=1)
        st = self._touch(st, idx, pred)
        st = dict(st)
        st["m_count"] = _put(st["m_count"], idx,
                             _take(st["m_count"], idx) + pred.to(I32))
        wr = pred & ~found

        def put(cur, val):
            return _where(wr, _put(cur, idx, val), cur)
        st["m_present"] = _where(pred, _put(st["m_present"], idx, 1),
                                 st["m_present"])
        st["m_hdr"] = put(st["m_hdr"], row["hdr"])
        st["m_entry"] = put(st["m_entry"], row["entry"])
        st["m_log"] = put(st["m_log"], row["log"])
        st["m_log_len"] = put(st["m_log_len"], row["log_len"])
        st["m_has_log"] = put(st["m_has_log"], row["has_log"])
        st["err"] = st["err"] | torch.where(overflow, ERR_BAG_OVERFLOW, 0
                                            ).to(I32)
        return st

    def _bag_send_once(self, st, row):
        """SendOnce (VSR.tla:250-252): guard fails if the record is in the
        domain at all — a count-0 tombstone blocks the resend."""
        ok = ~self._row_eq(st, row).any(dim=1)
        return self._bag_send(st, row), ok

    def _bag_discard(self, st, k):
        B, dev = k.shape[0], k.device
        st = self._touch(st, k, torch.ones((B,), dtype=torch.bool,
                                           device=dev))
        st = dict(st)
        st["m_count"] = _put(st["m_count"], k, _take(st["m_count"], k) - 1)
        return st

    def _broadcast(self, st, row, src):
        """BroadcastFunc (VSR.tla:233-240): upsert [msg EXCEPT !.dest = d]
        for every d != src."""
        for d in range(1, self.R + 1):
            rd = dict(row)
            hdr = row["hdr"].clone()
            hdr[:, H_DEST].fill_(d)
            rd["hdr"] = hdr
            st = self._bag_send(st, rd, pred=(src != d))
        return st

    # ==================================================================
    # state helpers
    # ==================================================================
    @staticmethod
    def _primary(view, R):
        return 1 + torch.remainder(view - 1, R)

    def _is_primary(self, st, i, r):
        return self._primary(_take(st["view"], i), self.R) == r

    def _clear_vc(self, st, i, svc=True, dvc=True):
        """ResetRecvMsgs (VSR.tla:299-301) with canonical-zero payloads."""
        if svc:
            st["svc"] = _put(st["svc"], i, 0)
        if dvc:
            for k in ("dvc", "dvc_lnv", "dvc_op", "dvc_commit", "dvc_log",
                      "dvc_log_len"):
                st[k] = _put(st[k], i, 0)
        return st

    def _clear_rec(self, st, i):
        for k in ("rec", "rec_view", "rec_has_log", "rec_log",
                  "rec_log_len", "rec_op", "rec_commit"):
            st[k] = _put(st[k], i, 0)
        return st

    def _reset_sent(self, st, i):
        st["sent_dvc"] = _put(st["sent_dvc"], i, 0)
        st["sent_sv"] = _put(st["sent_sv"], i, 0)
        return st

    @staticmethod
    def _entry_sort_key(rows):
        """value_key order of a log entry record, packed big-endian into
        one int32 (client_id, operation, request_number, view_number)."""
        return (rows[..., E_CLIENT] * (1 << 20) + rows[..., E_OPER] * (1 << 16)
                + rows[..., E_REQ] * (1 << 8) + rows[..., E_VIEW])

    def _log_sort_key(self, log_rows):
        return self._entry_sort_key(log_rows)

    def _msg_lane(self, st, k):
        """Header and destination replica of message lane k ([B])."""
        hdr = _take(st["m_hdr"], k)                 # [B, NHDR]
        r = hdr[:, H_DEST]
        i = _clip(r - 1, 0, self.R - 1)
        return hdr, r, i

    def _recv_en(self, st, k, hdr, mtype):
        return ((_take(st["m_present"], k) == 1)
                & (_take(st["m_count"], k) > 0) & (hdr[:, H_TYPE] == mtype))

    # ==================================================================
    # the 19 actions.  Each takes (st, lane) and returns (succ, enabled);
    # successors are computed totally and masked by the engine.
    # ==================================================================
    def act_timer_send_svc(self, st, lane):       # VSR.tla:578-590
        i = lane
        r = i + 1
        B, dev = lane.shape[0], lane.device
        en = ((st["aux_svc"] < self.shape.timer_limit)
              & ~self._is_primary(st, i, r))
        new_view = _take(st["view"], i) + 1
        s2 = dict(st)
        s2["view"] = _put(st["view"], i, new_view)
        s2["status"] = _put(st["status"], i, VIEWCHANGE)
        s2 = self._clear_vc(s2, i)
        s2 = self._reset_sent(s2, i)
        s2["aux_svc"] = st["aux_svc"] + 1
        s2 = self._broadcast(s2, self._row(B, dev, M_SVC, view=new_view,
                                           src=r), r)
        return s2, en

    def act_receive_higher_svc(self, st, lane):   # VSR.tla:602-613
        k = lane
        B, dev = lane.shape[0], lane.device
        hdr, r, i = self._msg_lane(st, k)
        en = (self._recv_en(st, k, hdr, M_SVC)
              & (hdr[:, H_VIEW] > _take(st["view"], i)))
        s2 = dict(st)
        s2["view"] = _put(st["view"], i, hdr[:, H_VIEW])
        s2["status"] = _put(st["status"], i, VIEWCHANGE)
        s2 = self._clear_vc(s2, i)
        s2["svc"] = _put2(s2["svc"], i, _clip(hdr[:, H_SRC] - 1, 0,
                                                self.R - 1), 1)
        s2 = self._reset_sent(s2, i)
        s2 = self._bag_discard(s2, k)
        s2 = self._broadcast(s2, self._row(B, dev, M_SVC,
                                           view=hdr[:, H_VIEW], src=r), r)
        return s2, en

    def act_receive_matching_svc(self, st, lane):  # VSR.tla:625-634
        k = lane
        hdr, r, i = self._msg_lane(st, k)
        en = (self._recv_en(st, k, hdr, M_SVC)
              & (hdr[:, H_VIEW] == _take(st["view"], i))
              & (_take(st["status"], i) == VIEWCHANGE))
        s2 = dict(st)
        s2["svc"] = _put2(st["svc"], i, _clip(hdr[:, H_SRC] - 1, 0,
                                                self.R - 1), 1)
        s2 = self._bag_discard(s2, k)
        return s2, en

    def act_send_dvc(self, st, lane):             # VSR.tla:648-669
        i = lane
        r = i + 1
        B, dev = lane.shape[0], lane.device
        view = _take(st["view"], i)
        prim = self._primary(view, self.R)
        en = ((_take(st["status"], i) == VIEWCHANGE)
              & (_take(st["sent_dvc"], i) == 0)
              & (_take(st["svc"], i).sum(dim=1) >= self.R // 2))
        lnv_i, op_i = _take(st["lnv"], i), _take(st["op"], i)
        commit_i, log_i = _take(st["commit"], i), _take(st["log"], i)
        log_len_i = _take(st["log_len"], i)
        s2 = dict(st)
        s2["sent_dvc"] = _put(st["sent_dvc"], i, 1)
        self_case = prim == r
        same = ((_take2(st["dvc_lnv"], i, i) == lnv_i)
                & (_take2(st["dvc_op"], i, i) == op_i)
                & (_take2(st["dvc_commit"], i, i) == commit_i)
                & (_take2(st["dvc_log_len"], i, i) == log_len_i)
                & (_take2(st["dvc_log"], i, i) == log_i).all(-1).all(-1))
        collide = self_case & (_take2(st["dvc"], i, i) == 1) & ~same
        for key, val in (("dvc", 1), ("dvc_lnv", lnv_i), ("dvc_op", op_i),
                         ("dvc_commit", commit_i), ("dvc_log", log_i),
                         ("dvc_log_len", log_len_i)):
            s2[key] = _where(self_case, _put2(s2[key], i, i, val), s2[key])
        s2["err"] = s2["err"] | torch.where(collide, ERR_DVC_OVERFLOW,
                                            0).to(I32)
        row = self._row(B, dev, M_DVC, view=view, op=op_i, commit=commit_i,
                        dest=prim, src=r, lnv=lnv_i, log=log_i,
                        log_len=log_len_i, has_log=1)
        s2 = self._bag_send(s2, row, pred=~self_case)
        return s2, en

    def act_receive_higher_dvc(self, st, lane):   # VSR.tla:677-688
        k = lane
        B, dev = lane.shape[0], lane.device
        hdr, r, i = self._msg_lane(st, k)
        j = _clip(hdr[:, H_SRC] - 1, 0, self.R - 1)
        en = (self._recv_en(st, k, hdr, M_DVC)
              & (hdr[:, H_VIEW] > _take(st["view"], i)))
        s2 = dict(st)
        s2["view"] = _put(st["view"], i, hdr[:, H_VIEW])
        s2["status"] = _put(st["status"], i, VIEWCHANGE)
        s2 = self._clear_vc(s2, i)
        s2["dvc"] = _put2(s2["dvc"], i, j, 1)
        s2["dvc_lnv"] = _put2(s2["dvc_lnv"], i, j, hdr[:, H_LNV])
        s2["dvc_op"] = _put2(s2["dvc_op"], i, j, hdr[:, H_OP])
        s2["dvc_commit"] = _put2(s2["dvc_commit"], i, j, hdr[:, H_COMMIT])
        s2["dvc_log"] = _put2(s2["dvc_log"], i, j, _take(st["m_log"], k))
        s2["dvc_log_len"] = _put2(s2["dvc_log_len"], i, j,
                                  _take(st["m_log_len"], k))
        s2 = self._reset_sent(s2, i)
        s2 = self._bag_discard(s2, k)
        s2 = self._broadcast(s2, self._row(B, dev, M_SVC,
                                           view=hdr[:, H_VIEW], src=r), r)
        return s2, en

    def act_receive_matching_dvc(self, st, lane):  # VSR.tla:696-703
        k = lane
        hdr, r, i = self._msg_lane(st, k)
        j = _clip(hdr[:, H_SRC] - 1, 0, self.R - 1)
        en = (self._recv_en(st, k, hdr, M_DVC)
              & (hdr[:, H_VIEW] == _take(st["view"], i)))
        m_log_k, m_log_len_k = _take(st["m_log"], k), _take(st["m_log_len"], k)
        same = ((_take2(st["dvc"], i, j) == 1)
                & (_take2(st["dvc_lnv"], i, j) == hdr[:, H_LNV])
                & (_take2(st["dvc_op"], i, j) == hdr[:, H_OP])
                & (_take2(st["dvc_commit"], i, j) == hdr[:, H_COMMIT])
                & (_take2(st["dvc_log_len"], i, j) == m_log_len_k)
                & (_take2(st["dvc_log"], i, j) == m_log_k).all(-1).all(-1))
        collide = (_take2(st["dvc"], i, j) == 1) & ~same
        s2 = dict(st)
        s2["dvc"] = _put2(st["dvc"], i, j, 1)
        s2["dvc_lnv"] = _put2(st["dvc_lnv"], i, j, hdr[:, H_LNV])
        s2["dvc_op"] = _put2(st["dvc_op"], i, j, hdr[:, H_OP])
        s2["dvc_commit"] = _put2(st["dvc_commit"], i, j, hdr[:, H_COMMIT])
        s2["dvc_log"] = _put2(st["dvc_log"], i, j, m_log_k)
        s2["dvc_log_len"] = _put2(st["dvc_log_len"], i, j, m_log_len_k)
        s2["err"] = st["err"] | torch.where(collide & en, ERR_DVC_OVERFLOW,
                                            0).to(I32)
        s2 = self._bag_discard(s2, k)
        return s2, en

    def _best_j(self, keys):
        """[B, R, K] keys -> [B] index of the lexicographically least row
        (earliest on ties), as the JAX kernel's sequential scan."""
        best_j = torch.zeros(keys.shape[0], dtype=torch.int64,
                             device=keys.device)
        best_key = keys[:, 0]
        for j in range(1, self.R):
            less = _lex_less(keys[:, j], best_key)
            best_key = torch.where(less[:, None], keys[:, j], best_key)
            best_j = torch.where(less, j, best_j)
        return best_j

    def act_send_sv(self, st, lane):              # VSR.tla:716-758
        i = lane
        r = i + 1
        B, dev = lane.shape[0], lane.device
        view = _take(st["view"], i)
        mask = _take(st["dvc"], i) == 1                     # [B, R]
        en = ((_take(st["status"], i) == VIEWCHANGE)
              & (_take(st["sent_sv"], i) == 0)
              & (mask.sum(dim=1) >= self.R // 2 + 1))
        dvc_lnv = _take(st["dvc_lnv"], i)
        dvc_op = _take(st["dvc_op"], i)
        dvc_commit = _take(st["dvc_commit"], i)
        dvc_log = _take(st["dvc_log"], i)                   # [B, R, O, E]
        pair = dvc_lnv * (self.MAX_OPS + 1) + dvc_op
        best_pair = torch.where(mask, pair, -1).amax(dim=1)
        maximal = mask & (pair == best_pair[:, None])
        logk = self._log_sort_key(dvc_log)                  # [B, R, O]
        src_ids = torch.arange(1, self.R + 1, dtype=I32, device=dev)
        keys = torch.cat([dvc_commit[:, :, None], logk,
                          src_ids[None, :, None].expand(B, -1, -1)], dim=2)
        keys = torch.where(maximal[:, :, None], keys, INF)
        best_j = self._best_j(keys)
        new_log = _take(dvc_log, best_j)
        new_on = _take(_take(st["dvc_log_len"], i), best_j)
        new_cn = torch.where(mask, dvc_commit, -1).amax(dim=1)
        s2 = dict(st)
        s2["status"] = _put(st["status"], i, NORMAL)
        s2["log"] = _put(st["log"], i, new_log)
        s2["log_len"] = _put(st["log_len"], i, new_on)
        s2["op"] = _put(st["op"], i, new_on)
        s2["peer_op"] = _put(st["peer_op"], i, 0)
        s2["commit"] = _put(st["commit"], i, new_cn)
        s2["sent_sv"] = _put(st["sent_sv"], i, 1)
        s2["lnv"] = _put(st["lnv"], i, view)
        row = self._row(B, dev, M_SV, view=view, op=new_on, commit=new_cn,
                        src=r, log=new_log, log_len=new_on, has_log=1)
        s2 = self._broadcast(s2, row, r)
        return s2, en

    def act_receive_sv(self, st, lane):           # VSR.tla:773-793
        k = lane
        B, dev = lane.shape[0], lane.device
        hdr, r, i = self._msg_lane(st, k)
        en = (self._recv_en(st, k, hdr, M_SV)
              & (hdr[:, H_VIEW] >= _take(st["view"], i)))
        old_commit = _take(st["commit"], i)
        s2 = dict(st)
        s2["status"] = _put(st["status"], i, NORMAL)
        s2["view"] = _put(st["view"], i, hdr[:, H_VIEW])
        s2["log"] = _put(st["log"], i, _take(st["m_log"], k))
        s2["log_len"] = _put(st["log_len"], i, _take(st["m_log_len"], k))
        s2["op"] = _put(st["op"], i, hdr[:, H_OP])
        s2["commit"] = _put(st["commit"], i, hdr[:, H_COMMIT])
        s2["lnv"] = _put(st["lnv"], i, hdr[:, H_VIEW])
        s2 = self._clear_vc(s2, i)
        s2 = self._reset_sent(s2, i)
        s2 = self._bag_discard(s2, k)
        ack = self._row(B, dev, M_PREPAREOK, view=hdr[:, H_VIEW],
                        op=hdr[:, H_OP],
                        dest=self._primary(hdr[:, H_VIEW], self.R), src=r)
        s2 = self._bag_send(s2, ack, pred=(old_commit < hdr[:, H_OP]))
        return s2, en

    def act_receive_client_request(self, st, lane):  # VSR.tla:366-394
        i = torch.div(lane, self.V, rounding_mode="floor")
        v = torch.remainder(lane, self.V) + 1          # value id
        r = i + 1
        B, dev = lane.shape[0], lane.device
        ct_i = _take(st["ct"], i)[:, 0]                # [B, 3]
        en = (self._is_primary(st, i, r)
              & (_take(st["status"], i) == NORMAL)
              & (_take(st["aux_acked"], v - 1) == 0)
              & (ct_i[:, T_EXEC] == 1))
        req = ct_i[:, T_REQ] + 1
        log_len_i = _take(st["log_len"], i)
        opn = log_len_i + 1
        view_i = _take(st["view"], i)
        entry = torch.stack([view_i, v.to(I32), torch.ones_like(view_i),
                             req], dim=1)
        pos = _clip(log_len_i, 0, self.MAX_OPS - 1)
        s2 = dict(st)
        s2["log"] = _put2(st["log"], i, pos, entry)
        s2["log_len"] = _put(st["log_len"], i, opn)
        s2["op"] = _put(st["op"], i, opn)
        s2["ct"] = _put2(st["ct"], i, torch.zeros_like(i),
                         torch.stack([req, opn, torch.zeros_like(req)], 1))
        row = self._row(B, dev, M_PREPARE, view=view_i, op=opn,
                        commit=_take(st["commit"], i), src=r, entry=entry)
        s2 = self._broadcast(s2, row, r)
        s2["aux_acked"] = _put(st["aux_acked"], v - 1, 1)   # v :> FALSE
        return s2, en

    def act_receive_prepare(self, st, lane):      # VSR.tla:405-428
        k = lane
        B, dev = lane.shape[0], lane.device
        hdr, r, i = self._msg_lane(st, k)
        en = (self._recv_en(st, k, hdr, M_PREPARE)
              & (_take(st["status"], i) == NORMAL)
              & (hdr[:, H_VIEW] == _take(st["view"], i))
              & (hdr[:, H_OP] == _take(st["op"], i) + 1))
        entry = _take(st["m_entry"], k)
        pos = _clip(_take(st["log_len"], i), 0, self.MAX_OPS - 1)
        s2 = dict(st)
        s2["log"] = _put2(st["log"], i, pos, entry)
        s2["log_len"] = _put(st["log_len"], i, hdr[:, H_OP])
        s2["op"] = _put(st["op"], i, hdr[:, H_OP])
        s2["commit"] = _put(st["commit"], i, hdr[:, H_COMMIT])
        exec_ = (hdr[:, H_OP] <= hdr[:, H_COMMIT]).to(I32)
        s2["ct"] = _put2(st["ct"], i, torch.zeros_like(i),
                         torch.stack([entry[:, E_REQ], hdr[:, H_OP], exec_],
                                     1))
        s2 = self._bag_discard(s2, k)
        ack = self._row(B, dev, M_PREPAREOK, view=_take(st["view"], i),
                        op=hdr[:, H_OP], dest=hdr[:, H_SRC], src=r)
        s2 = self._bag_send(s2, ack)
        return s2, en

    def act_receive_prepare_ok(self, st, lane):   # VSR.tla:437-447
        k = lane
        hdr, r, i = self._msg_lane(st, k)
        j = _clip(hdr[:, H_SRC] - 1, 0, self.R - 1)
        en = (self._recv_en(st, k, hdr, M_PREPAREOK)
              & self._is_primary(st, i, r)
              & (_take(st["status"], i) == NORMAL)
              & (hdr[:, H_VIEW] == _take(st["view"], i))
              & (hdr[:, H_OP] > _take2(st["peer_op"], i, j)))
        s2 = dict(st)
        s2["peer_op"] = _put2(st["peer_op"], i, j, hdr[:, H_OP])
        s2 = self._bag_discard(s2, k)
        return s2, en

    def act_execute_op(self, st, lane):           # VSR.tla:457-476
        i = lane
        r = i + 1
        commit_i = _take(st["commit"], i)
        opn = commit_i + 1
        committed = ((_take(st["peer_op"], i) >= opn[:, None]).sum(dim=1)
                     >= self.R // 2)
        en = (self._is_primary(st, i, r)
              & (_take(st["status"], i) == NORMAL)
              & (commit_i < _take(st["op"], i)) & committed)
        entry = _take(_take(st["log"], i),
                      _clip(opn - 1, 0, self.MAX_OPS - 1))
        s2 = dict(st)
        s2["commit"] = _put(st["commit"], i, opn)
        ct = st["ct"].clone()
        ct[_ar(ct), i.long(), 0, T_EXEC] = _val(1, ct)
        s2["ct"] = ct
        s2["aux_acked"] = _put(st["aux_acked"],
                               _clip(entry[:, E_OPER] - 1, 0, self.V - 1),
                               2)                          # v :> TRUE
        return s2, en

    def act_send_get_state(self, st, lane):       # VSR.tla:491-516
        k = torch.div(lane, self.R, rounding_mode="floor")
        rdest = torch.remainder(lane, self.R) + 1
        B, dev = lane.shape[0], lane.device
        hdr, r, i = self._msg_lane(st, k)
        en = (self._recv_en(st, k, hdr, M_PREPARE)
              & ~self._is_primary(st, i, r) & (r != rdest)
              & (_take(st["status"], i) == NORMAL)
              & (hdr[:, H_VIEW] > _take(st["view"], i))
              & (hdr[:, H_OP] > _take(st["op"], i) + 1))
        trunc = torch.minimum(_take(st["commit"], i),
                              _take(st["log_len"], i))
        keep = (torch.arange(self.MAX_OPS, device=dev)[None, :]
                < trunc[:, None])                          # [B, O]
        s2 = dict(st)
        s2["log"] = _put(st["log"], i,
                         torch.where(keep[:, :, None], _take(st["log"], i),
                                     0))
        s2["log_len"] = _put(st["log_len"], i, trunc)
        s2["op"] = _put(st["op"], i, trunc)
        s2["view"] = _put(st["view"], i, hdr[:, H_VIEW])
        s2["lnv"] = _put(st["lnv"], i, hdr[:, H_VIEW])
        row = self._row(B, dev, M_GETSTATE, view=hdr[:, H_VIEW], op=trunc,
                        dest=rdest, src=r)
        s2, ok = self._bag_send_once(s2, row)
        return s2, en & ok

    def act_receive_get_state(self, st, lane):    # VSR.tla:526-543
        k = lane
        B, dev = lane.shape[0], lane.device
        hdr, r, i = self._msg_lane(st, k)
        op_i = _take(st["op"], i)
        en = (self._recv_en(st, k, hdr, M_GETSTATE)
              & (_take(st["view"], i) == hdr[:, H_VIEW])
              & (_take(st["status"], i) == NORMAL)
              & (op_i > hdr[:, H_OP]))
        n = op_i - hdr[:, H_OP]
        idx = torch.arange(self.MAX_OPS, device=dev)[None, :]
        src_pos = _clip(hdr[:, H_OP][:, None] + idx, 0, self.MAX_OPS - 1)
        log_i = _take(st["log"], i)                         # [B, O, E]
        gathered = log_i.gather(
            1, src_pos.long()[:, :, None].expand(-1, -1, NENT))
        rows = torch.where((idx < n[:, None])[:, :, None], gathered, 0)
        reply = self._row(B, dev, M_NEWSTATE, view=_take(st["view"], i),
                          op=op_i, commit=_take(st["commit"], i),
                          first=hdr[:, H_OP] + 1, dest=hdr[:, H_SRC], src=r,
                          log=rows, log_len=_clip(n, 0, self.MAX_OPS),
                          has_log=1)
        s2 = self._bag_discard(dict(st), k)
        s2 = self._bag_send(s2, reply)
        return s2, en

    def act_receive_new_state(self, st, lane):    # VSR.tla:551-567
        k = lane
        B, dev = lane.shape[0], lane.device
        hdr, r, i = self._msg_lane(st, k)
        own_n = _take(st["op"], i)
        en = (self._recv_en(st, k, hdr, M_NEWSTATE)
              & (_take(st["view"], i) == hdr[:, H_VIEW])
              & (_take(st["status"], i) == NORMAL)
              & (own_n == hdr[:, H_FIRST] - 1))
        idx = torch.arange(self.MAX_OPS, device=dev)[None, :]
        pos = _clip(idx - own_n[:, None], 0, self.MAX_OPS - 1)
        from_msg = _take(st["m_log"], k).gather(
            1, pos.long()[:, :, None].expand(-1, -1, NENT))
        rows = torch.where(
            (idx < own_n[:, None])[:, :, None], _take(st["log"], i),
            torch.where((idx < hdr[:, H_OP][:, None])[:, :, None],
                        from_msg, 0))
        s2 = dict(st)
        s2["log"] = _put(st["log"], i, rows)
        s2["log_len"] = _put(st["log_len"], i, hdr[:, H_OP])
        s2["op"] = _put(st["op"], i, hdr[:, H_OP])
        s2 = self._bag_discard(s2, k)
        return s2, en

    def act_restart_empty(self, st, lane):        # VSR.tla:802-837
        i = lane
        r = i + 1
        B, dev = lane.shape[0], lane.device
        en = st["aux_restart"] < self.shape.restart_limit
        is_rec = ((st["m_present"] == 1)
                  & (st["m_hdr"][:, :, H_TYPE] == M_RECOVERY))
        unique = torch.where(is_rec, st["m_hdr"][:, :, H_X],
                             0).amax(dim=1) + 1
        s2 = dict(st)
        s2["log"] = _put(st["log"], i, 0)
        s2["log_len"] = _put(st["log_len"], i, 0)
        s2["view"] = _put(st["view"], i, 1)
        s2["op"] = _put(st["op"], i, 0)
        s2["commit"] = _put(st["commit"], i, 0)
        s2["peer_op"] = _put(st["peer_op"], i, 0)
        empty_row = torch.zeros((self.shape.C, 3), dtype=I32, device=dev)
        empty_row[:, T_EXEC].fill_(1)
        s2["ct"] = _put(st["ct"], i, empty_row)
        s2 = self._clear_vc(s2, i)
        s2 = self._reset_sent(s2, i)
        s2["lnv"] = _put(st["lnv"], i, 0)
        s2 = self._clear_rec(s2, i)
        s2["status"] = _put(st["status"], i, RECOVERING)
        s2["rec_number"] = _put(st["rec_number"], i, unique)
        s2["aux_restart"] = st["aux_restart"] + 1
        s2 = self._broadcast(s2, self._row(B, dev, M_RECOVERY, x=unique,
                                           src=r), r)
        return s2, en

    def act_receive_recovery(self, st, lane):     # VSR.tla:842-858
        k = lane
        B, dev = lane.shape[0], lane.device
        hdr, r, i = self._msg_lane(st, k)
        en = (self._recv_en(st, k, hdr, M_RECOVERY)
              & (_take(st["status"], i) == NORMAL))
        isp = self._is_primary(st, i, r)
        reply = self._row(
            B, dev, M_RECOVERYRESP, view=_take(st["view"], i),
            x=hdr[:, H_X], dest=hdr[:, H_SRC], src=r,
            op=torch.where(isp, _take(st["op"], i), -1),
            commit=torch.where(isp, _take(st["commit"], i), -1),
            log=_where(isp, _take(st["log"], i), 0),
            log_len=torch.where(isp, _take(st["log_len"], i), 0),
            has_log=torch.where(isp, 1, 0))
        s2 = self._bag_discard(dict(st), k)
        s2 = self._bag_send(s2, reply)
        return s2, en

    def act_receive_recovery_response(self, st, lane):  # VSR.tla:864-872
        k = lane
        hdr, r, i = self._msg_lane(st, k)
        j = _clip(hdr[:, H_SRC] - 1, 0, self.R - 1)
        en = (self._recv_en(st, k, hdr, M_RECOVERYRESP)
              & (_take(st["rec_number"], i) == hdr[:, H_X])
              & (_take(st["status"], i) == RECOVERING))
        m_has_log_k = _take(st["m_has_log"], k)
        m_log_k = _take(st["m_log"], k)
        m_log_len_k = _take(st["m_log_len"], k)
        same = ((_take2(st["rec"], i, j) == 1)
                & (_take2(st["rec_view"], i, j) == hdr[:, H_VIEW])
                & (_take2(st["rec_has_log"], i, j) == m_has_log_k)
                & (_take2(st["rec_op"], i, j) == hdr[:, H_OP])
                & (_take2(st["rec_commit"], i, j) == hdr[:, H_COMMIT])
                & (_take2(st["rec_log_len"], i, j) == m_log_len_k)
                & (_take2(st["rec_log"], i, j) == m_log_k).all(-1).all(-1))
        collide = (_take2(st["rec"], i, j) == 1) & ~same
        s2 = dict(st)
        s2["rec"] = _put2(st["rec"], i, j, 1)
        s2["rec_view"] = _put2(st["rec_view"], i, j, hdr[:, H_VIEW])
        s2["rec_has_log"] = _put2(st["rec_has_log"], i, j, m_has_log_k)
        s2["rec_log"] = _put2(st["rec_log"], i, j, m_log_k)
        s2["rec_log_len"] = _put2(st["rec_log_len"], i, j, m_log_len_k)
        s2["rec_op"] = _put2(st["rec_op"], i, j, hdr[:, H_OP])
        s2["rec_commit"] = _put2(st["rec_commit"], i, j, hdr[:, H_COMMIT])
        s2["err"] = st["err"] | torch.where(collide & en, ERR_REC_OVERFLOW,
                                            0).to(I32)
        s2 = self._bag_discard(s2, k)
        return s2, en

    def act_complete_recovery(self, st, lane):    # VSR.tla:878-894
        i = lane
        B, dev = lane.shape[0], lane.device
        rec = _take(st["rec"], i)
        cand = (rec == 1) & (_take(st["rec_has_log"], i) == 1)
        en = ((_take(st["status"], i) == RECOVERING)
              & ((rec == 1).sum(dim=1) > self.R // 2)
              & cand.any(dim=1))
        rec_log = _take(st["rec_log"], i)
        logk = self._log_sort_key(rec_log)
        src_ids = torch.arange(1, self.R + 1, dtype=I32, device=dev)
        rec_view = _take(st["rec_view"], i)
        rec_op = _take(st["rec_op"], i)
        rec_commit = _take(st["rec_commit"], i)
        keys = torch.cat(
            [rec_commit[:, :, None], logk, rec_op[:, :, None],
             src_ids[None, :, None].expand(B, -1, -1),
             rec_view[:, :, None]], dim=2)
        keys = torch.where(cand[:, :, None], keys, INF)
        best_j = self._best_j(keys)
        s2 = dict(st)
        s2["status"] = _put(st["status"], i, NORMAL)
        s2["view"] = _put(st["view"], i, _take(rec_view, best_j))
        s2["lnv"] = _put(st["lnv"], i, _take(rec_view, best_j))
        s2["log"] = _put(st["log"], i, _take(rec_log, best_j))
        s2["log_len"] = _put(st["log_len"], i,
                             _take(_take(st["rec_log_len"], i), best_j))
        s2["op"] = _put(st["op"], i, _take(rec_op, best_j))
        s2["commit"] = _put(st["commit"], i, _take(rec_commit, best_j))
        s2 = self._clear_rec(s2, i)
        return s2, en

    # ==================================================================
    # guards: every lane of one action over a batch -> [B, L_a] bool.
    # Each replicates exactly the `en` conjunction of its action.
    # ==================================================================
    @staticmethod
    def _g(plane, i):
        """plane[b, i[b, k]] for a [B, R] plane and [B, K] indices."""
        return plane.gather(1, i.long())

    def _msg_cols(self, st):
        hdr = st["m_hdr"]
        i = _clip(hdr[:, :, H_DEST] - 1, 0, self.R - 1)          # [B, M]
        recv = (st["m_present"] == 1) & (st["m_count"] > 0)
        return hdr, i, recv

    def _rep_primary(self, st):
        """[B, R]: replica r is the primary of its own view."""
        r = torch.arange(1, self.R + 1, device=st["view"].device)
        return self._primary(st["view"], self.R) == r[None, :]

    def guard_timer_send_svc(self, st):
        return ((st["aux_svc"] < self.shape.timer_limit)[:, None]
                & ~self._rep_primary(st))

    def _guard_recv_view(self, st, mtype, cmp):
        hdr, i, recv = self._msg_cols(st)
        return (recv & (hdr[:, :, H_TYPE] == mtype)
                & cmp(hdr[:, :, H_VIEW], self._g(st["view"], i)))

    def guard_receive_higher_svc(self, st):
        return self._guard_recv_view(st, M_SVC, torch.gt)

    def guard_receive_matching_svc(self, st):
        hdr, i, _ = self._msg_cols(st)
        return (self._guard_recv_view(st, M_SVC, torch.eq)
                & (self._g(st["status"], i) == VIEWCHANGE))

    def guard_send_dvc(self, st):
        return ((st["status"] == VIEWCHANGE) & (st["sent_dvc"] == 0)
                & (st["svc"].sum(dim=2) >= self.R // 2))

    def guard_receive_higher_dvc(self, st):
        return self._guard_recv_view(st, M_DVC, torch.gt)

    def guard_receive_matching_dvc(self, st):
        return self._guard_recv_view(st, M_DVC, torch.eq)

    def guard_send_sv(self, st):
        return ((st["status"] == VIEWCHANGE) & (st["sent_sv"] == 0)
                & ((st["dvc"] == 1).sum(dim=2) >= self.R // 2 + 1))

    def guard_receive_sv(self, st):
        return self._guard_recv_view(st, M_SV, torch.ge)

    def guard_receive_client_request(self, st):
        rep = (self._rep_primary(st) & (st["status"] == NORMAL)
               & (st["ct"][:, :, 0, T_EXEC] == 1))               # [B, R]
        free = st["aux_acked"] == 0                               # [B, V]
        return (rep[:, :, None] & free[:, None, :]).reshape(
            rep.shape[0], self.R * self.V)

    def guard_receive_prepare(self, st):
        hdr, i, _ = self._msg_cols(st)
        return (self._guard_recv_view(st, M_PREPARE, torch.eq)
                & (self._g(st["status"], i) == NORMAL)
                & (hdr[:, :, H_OP] == self._g(st["op"], i) + 1))

    def guard_receive_prepare_ok(self, st):
        hdr, i, recv = self._msg_cols(st)
        j = _clip(hdr[:, :, H_SRC] - 1, 0, self.R - 1)
        prim = (self._primary(self._g(st["view"], i), self.R)
                == hdr[:, :, H_DEST])
        peer = st["peer_op"].reshape(-1, self.R * self.R).gather(
            1, (i * self.R + j).long())
        return (self._guard_recv_view(st, M_PREPAREOK, torch.eq) & prim
                & (self._g(st["status"], i) == NORMAL)
                & (hdr[:, :, H_OP] > peer))

    def guard_execute_op(self, st):
        opn = st["commit"] + 1                                    # [B, R]
        committed = ((st["peer_op"] >= opn[:, :, None]).sum(dim=2)
                     >= self.R // 2)
        return (self._rep_primary(st) & (st["status"] == NORMAL)
                & (st["commit"] < st["op"]) & committed)

    def guard_send_get_state(self, st):
        hdr, i, recv = self._msg_cols(st)
        B, dev = hdr.shape[0], hdr.device
        r = hdr[:, :, H_DEST]                                     # [B, M]
        view_i = self._g(st["view"], i)
        en = (recv & (hdr[:, :, H_TYPE] == M_PREPARE)
              & ~(self._primary(view_i, self.R) == r)
              & (self._g(st["status"], i) == NORMAL)
              & (hdr[:, :, H_VIEW] > view_i)
              & (hdr[:, :, H_OP] > self._g(st["op"], i) + 1))
        rdest = torch.arange(1, self.R + 1, device=dev)
        en = en[:, :, None] & (r[:, :, None] != rdest[None, None, :])
        # SendOnce: the GetState record (view of k, op trunc of the
        # receiver, dest rdest, src r) must not already be in the bag
        trunc = torch.minimum(self._g(st["commit"], i),
                              self._g(st["log_len"], i))          # [B, M]
        zero = lambda x: (x == 0)
        base = ((st["m_present"] == 1)
                & (hdr[:, :, H_TYPE] == M_GETSTATE)
                & zero(hdr[:, :, H_COMMIT]) & zero(hdr[:, :, H_X])
                & zero(hdr[:, :, H_FIRST]) & zero(hdr[:, :, H_LNV])
                & zero(st["m_entry"]).all(-1)
                & zero(st["m_log"]).all(-1).all(-1)
                & zero(st["m_log_len"]) & zero(st["m_has_log"]))   # [B, M]
        # a[b, k, s]: slot s holds k's GetState record for some dest
        a = (base[:, None, :]
             & (hdr[:, None, :, H_VIEW] == hdr[:, :, None, H_VIEW])
             & (hdr[:, None, :, H_OP] == trunc[:, :, None])
             & (hdr[:, None, :, H_SRC] == r[:, :, None]))
        dest_hit = (hdr[:, None, :, H_DEST] == rdest[None, :, None])  # [1|B,R,M]
        present = (a[:, :, None, :] & dest_hit[:, None, :, :]).any(dim=3)
        return (en & ~present).reshape(B, self.M * self.R)

    def guard_receive_get_state(self, st):
        hdr, i, _ = self._msg_cols(st)
        return (self._guard_recv_view(st, M_GETSTATE, torch.eq)
                & (self._g(st["status"], i) == NORMAL)
                & (self._g(st["op"], i) > hdr[:, :, H_OP]))

    def guard_receive_new_state(self, st):
        hdr, i, _ = self._msg_cols(st)
        return (self._guard_recv_view(st, M_NEWSTATE, torch.eq)
                & (self._g(st["status"], i) == NORMAL)
                & (self._g(st["op"], i) == hdr[:, :, H_FIRST] - 1))

    def guard_restart_empty(self, st):
        en = st["aux_restart"] < self.shape.restart_limit
        return en[:, None].expand(-1, self.R)

    def guard_receive_recovery(self, st):
        hdr, i, recv = self._msg_cols(st)
        return (recv & (hdr[:, :, H_TYPE] == M_RECOVERY)
                & (self._g(st["status"], i) == NORMAL))

    def guard_receive_recovery_response(self, st):
        hdr, i, recv = self._msg_cols(st)
        return (recv & (hdr[:, :, H_TYPE] == M_RECOVERYRESP)
                & (self._g(st["rec_number"], i) == hdr[:, :, H_X])
                & (self._g(st["status"], i) == RECOVERING))

    def guard_complete_recovery(self, st):
        cand = (st["rec"] == 1) & (st["rec_has_log"] == 1)
        return ((st["status"] == RECOVERING)
                & ((st["rec"] == 1).sum(dim=2) > self.R // 2)
                & cand.any(dim=2))

    def _guard_fns(self):
        return [
            self.guard_timer_send_svc, self.guard_receive_higher_svc,
            self.guard_receive_matching_svc, self.guard_send_dvc,
            self.guard_receive_higher_dvc, self.guard_receive_matching_dvc,
            self.guard_send_sv, self.guard_receive_sv,
            self.guard_receive_client_request, self.guard_receive_prepare,
            self.guard_receive_prepare_ok, self.guard_execute_op,
            self.guard_send_get_state, self.guard_receive_get_state,
            self.guard_receive_new_state, self.guard_restart_empty,
            self.guard_receive_recovery, self.guard_receive_recovery_response,
            self.guard_complete_recovery,
        ]

    # -- K6: the guard matrix --------------------------------------------
    def guard_matrix(self, flat, out=None, halt=None):
        """K6 wrapper: every action's guard over every lane of flat rows
        ``flat`` [B, lanes] -> (en [B, n_lanes] bool in lane-table
        order, en_any [B] bool), written into ``out`` when given.  With
        ``halt`` (a one-element int64 tensor) it does nothing while
        ``halt[0]`` is not 0."""
        if flat.device.type == "cpu":
            return self.guard_matrix_plain(flat, out, halt)
        return self._guards_kernel(flat, out, halt)

    def _guard_out(self, flat, out):
        if out is not None:
            return out
        B, dev = flat.shape[0], flat.device
        return (torch.zeros((B, self.n_lanes), dtype=torch.bool, device=dev),
                torch.zeros((B,), dtype=torch.bool, device=dev))

    def guard_matrix_plain(self, flat, out=None, halt=None):
        out = self._guard_out(flat, out)
        if halt is not None and bool(halt[0] != 0):
            return out
        st = self.pk.unflatten(flat)
        en = torch.cat([g(st) for g in self._guard_fns()], dim=1)
        out[0].copy_(en)
        out[1].copy_(en.any(dim=1))
        return out

    def guard_tables(self, device):
        """The planes' first lanes in a flat row (``GUARD_PLANES``
        order) and the lane -> (action, param) tables, on ``device``."""
        key = ("guards", str(torch.device(device)))
        t = self._fp_tables.get(key)
        if t is None:
            start = {k: a for k, _s, a, _e in self.pk._splits}
            t = {"planes": torch.tensor([start[k] for k in GUARD_PLANES],
                                        dtype=I32),
                 "lane_action": torch.as_tensor(self.lane_action),
                 "lane_param": torch.as_tensor(self.lane_param)}
            t = {k: v.to(device) for k, v in t.items()}
            self._fp_tables[key] = t
        return t

    def _guards_kernel(self, flat, out, halt):
        out = self._guard_out(flat, out)
        B, lanes = flat.shape
        t = self.guard_tables(flat.device)
        s = self.shape
        ck = kernels.check
        kernels.launch(
            "vsr_guards", "tpuvsr_vsr_guards",
            ck(flat, "flat", I32, (B, self.pk.lanes)), B, lanes,
            self.n_lanes, self.R, self.V, self.M, s.C, self.MAX_OPS,
            self.NHDR, NENT, s.timer_limit, s.restart_limit,
            t["planes"].data_ptr(), t["lane_action"].data_ptr(),
            t["lane_param"].data_ptr(),
            None if halt is None else ck(halt, "halt", torch.int64, (1,)),
            ck(out[0], "en", torch.bool, (B, self.n_lanes)),
            ck(out[1], "en_any", torch.bool, (B,)), kernels.stream_of(flat))
        return out

    def _action_fns(self):
        PLAIN_CALLS["actions"] += 1
        return [
            self.act_timer_send_svc, self.act_receive_higher_svc,
            self.act_receive_matching_svc, self.act_send_dvc,
            self.act_receive_higher_dvc, self.act_receive_matching_dvc,
            self.act_send_sv, self.act_receive_sv,
            self.act_receive_client_request, self.act_receive_prepare,
            self.act_receive_prepare_ok, self.act_execute_op,
            self.act_send_get_state, self.act_receive_get_state,
            self.act_receive_new_state, self.act_restart_empty,
            self.act_receive_recovery, self.act_receive_recovery_response,
            self.act_complete_recovery,
        ]

    def lane_replica(self, name, st, lane):
        """The one replica a lane's action mutates ([B])."""
        if name in ("TimerSendSVC", "SendDVC", "SendSV", "ExecuteOp",
                    "RestartEmpty", "CompleteRecovery"):
            return lane
        if name == "ReceiveClientRequest":
            return torch.div(lane, self.V, rounding_mode="floor")
        if name == "SendGetState":
            k = torch.div(lane, self.R, rounding_mode="floor")
        else:
            k = lane
        return _clip(_take(st["m_hdr"], k)[:, H_DEST] - 1, 0,
                     self.R - 1).to(lane.dtype)

    def seed_touch(self, st):
        """Add the incremental-fingerprint scratch keys."""
        B, dev = st["view"].shape[0], st["view"].device
        st = dict(st)
        st["_ts"] = torch.full((B, self.R + 1), -1, dtype=I32, device=dev)
        st["_tn"] = torch.zeros((B,), dtype=I32, device=dev)
        return st

    # -- K10: the successors of a work queue ------------------------------
    def invariant_mask(self, names):
        """K10's ``inv_mask``: bit b set for entry b of ``INVARIANT_FNS``
        named in ``names``.  Raises KeyError for an invariant with no
        device kernel."""
        keys = list(self.INVARIANT_FNS)
        mask = 0
        for n in names:
            if n not in self.INVARIANT_FNS:
                raise KeyError(n)
            mask |= 1 << keys.index(n)
        return mask

    def successor_buffers(self, n, device):
        """The output buffers of ``successors`` for a queue of ``n``."""
        z = lambda *shape, dtype=I32: torch.zeros(shape, dtype=dtype,
                                                  device=device)
        return {"succ": z(n, self.pk.lanes), "en2": z(n, dtype=torch.bool),
                "err": z(n), "ts": z(n, self.R + 1), "tn": z(n), "ri": z(n),
                "iok": z(n, dtype=torch.bool)}

    def successors(self, flat, pidx, aid, lane, inv_mask, out=None,
                   halt=None):
        """K10 wrapper: the work queue ``pidx``, ``aid``, ``lane`` ([N]
        int32: a row of the flat parents ``flat`` [T, lanes], an action,
        its lane parameter) -> the dict of ``successor_buffers`` (written
        into ``out`` when given): ``succ`` [N, lanes] successor rows,
        ``en2`` [N] the actions' enabled bits, ``err`` [N] the
        successors' error flags, ``ts`` [N, R+1] / ``tn`` [N] the
        touched message slots as ``_touch`` records them, ``ri`` [N] the
        replica each lane mutates (``lane_replica``), ``iok`` [N] the AND
        of the invariants in ``inv_mask`` (``invariant_mask``) on the
        successor.  With ``halt`` (a one-element int64 tensor) it does
        nothing while ``halt[0]`` is not 0."""
        if flat.device.type == "cpu":
            return self.successors_plain(flat, pidx, aid, lane, inv_mask,
                                         out, halt)
        return self._actions_kernel(flat, pidx, aid, lane, inv_mask, out,
                                    halt)

    def successors_plain(self, flat, pidx, aid, lane, inv_mask, out=None,
                         halt=None):
        """The plain version of K10: each action's ``act_*`` function on
        the queue items that name it (a profiler range per action), with
        ``seed_touch``, ``lane_replica`` and the masked invariants."""
        n = pidx.shape[0]
        out = out if out is not None else self.successor_buffers(
            n, flat.device)
        if halt is not None and bool(halt[0] != 0):
            return out
        pk = self.pk
        invs = [getattr(self, f) for b, f in
                enumerate(self.INVARIANT_FNS.values()) if inv_mask >> b & 1]
        for a, (name, fn) in enumerate(zip(ACTION_NAMES,
                                           self._action_fns())):
            sel = torch.nonzero(aid == a)[:, 0]
            if sel.numel() == 0:
                continue
            with record_function(name):
                lanes = lane[sel].long()
                st = pk.unflatten(flat[pidx[sel].long()])
                succ, en = fn(self.seed_touch(st), lanes)
                clean = {k: v for k, v in succ.items()
                         if not k.startswith("_")}
                ok = torch.ones_like(en)
                for f in invs:
                    ok = ok & f(clean)
                out["succ"][sel] = pk.flatten(clean)
                out["en2"][sel] = en
                out["err"][sel] = clean["err"].to(I32)
                out["ts"][sel] = succ["_ts"]
                out["tn"][sel] = succ["_tn"]
                out["ri"][sel] = self.lane_replica(name, st, lanes).to(I32)
                out["iok"][sel] = ok
        return out

    def action_tables(self, device):
        """The first lane of every plane of ``ALL_KEYS`` in a flat row
        (csrc/vsr_actions.cu enum Plane), on ``device``."""
        key = ("actions", str(torch.device(device)))
        t = self._fp_tables.get(key)
        if t is None:
            start = {k: a for k, _s, a, _e in self.pk._splits}
            t = self._fp_tables[key] = torch.tensor(
                [start[k] for k in ALL_KEYS], dtype=I32, device=device)
        return t

    def _actions_kernel(self, flat, pidx, aid, lane, inv_mask, out, halt):
        n = pidx.shape[0]
        T, lanes = flat.shape
        out = out if out is not None else self.successor_buffers(
            n, flat.device)
        s = self.shape
        ck = kernels.check
        kernels.launch(
            "vsr_actions", "tpuvsr_vsr_actions",
            ck(flat, "flat", I32, (T, self.pk.lanes)), lanes,
            ck(pidx, "pidx", I32, (n,)), ck(aid, "aid", I32, (n,)),
            ck(lane, "lane", I32, (n,)), n,
            self.action_tables(flat.device).data_ptr(), self.R, self.V,
            self.M, s.C, self.MAX_OPS, self.NHDR, NENT, s.timer_limit,
            s.restart_limit, int(inv_mask),
            None if halt is None else ck(halt, "halt", torch.int64, (1,)),
            ck(out["succ"], "succ", I32, (n, lanes)),
            ck(out["en2"], "en2", torch.bool, (n,)),
            ck(out["err"], "err", I32, (n,)),
            ck(out["ts"], "ts", I32, (n, self.R + 1)),
            ck(out["tn"], "tn", I32, (n,)), ck(out["ri"], "ri", I32, (n,)),
            ck(out["iok"], "iok", torch.bool, (n,)),
            kernels.stream_of(flat))
        return out

    def step_all(self, st):
        """[B] states -> all lane successors: (succs with a [B, n_lanes]
        leading pair of axes, enabled [B, n_lanes]).  Disabled lanes
        hold garbage."""
        B, dev = st["view"].shape[0], st["view"].device
        parts, ens = [], []
        for name, fn in zip(ACTION_NAMES, self._action_fns()):
            L = self._lane_count(name)
            rep = {k: v.repeat_interleave(L, dim=0) for k, v in st.items()}
            lanes = torch.arange(L, device=dev).repeat(B)
            succ, en = fn(rep, lanes)
            parts.append({k: v.reshape((B, L) + v.shape[1:])
                          for k, v in succ.items() if not k.startswith("_")})
            ens.append(en.reshape(B, L))
        succs = {k: torch.cat([p[k] for p in parts], dim=1)
                 for k in parts[0]}
        return succs, torch.cat(ens, dim=1)

    # ==================================================================
    # K3 (models/fingerprint.py): the VIEW projection excludes aux vars
    # (VSR.tla:149); no global row
    # ==================================================================
    FP_KERNELS = {"full": "vsr_fp_full", "parts": "vsr_fp_parts",
                  "incremental": "vsr_fp_incremental"}
    SLOT_KEYS = ("m_hdr", "m_entry", "m_log", "m_log_len", "m_has_log",
                 "m_count")

    # ==================================================================
    # invariants (VSR.tla:926-952), batched: st -> [B] bool
    # ==================================================================
    def _replica_has_op(self, st):
        """[B, R, V] bool: ReplicaHasOp(r, v) (VSR.tla:933-935)."""
        opers = st["log"][..., E_OPER]                       # [B, R, O]
        v_ids = torch.arange(1, self.V + 1, device=opers.device)
        return (opers[:, :, :, None] == v_ids).any(dim=2)

    def inv_acknowledged_write_not_lost(self, st):
        acked = st["aux_acked"] == 2
        has = self._replica_has_op(st).any(dim=1)
        return (~acked | has).all(dim=1)

    def inv_acknowledged_writes_exist_on_majority(self, st):
        acked = st["aux_acked"] == 2
        n_has = self._replica_has_op(st).sum(dim=1)
        return (~acked | (n_has >= self.R // 2 + 1)).all(dim=1)

    def inv_no_log_divergence(self, st):
        # VSR.tla:926-931 compares rep_log[r1] with itself: vacuous
        return torch.ones_like(st["err"], dtype=torch.bool)

    def inv_test(self, st):
        return torch.ones_like(st["err"], dtype=torch.bool)

    def pred_all_replicas_same_view(self, st):
        return ((st["view"] == st["view"][:, :1]).all(dim=1)
                & (st["status"] == NORMAL).all(dim=1))

    def hunt_score(self, st):
        """[B] int32 defect-proximity score for guided simulation (the
        splitter's ``hunt_beta`` term): how close each state is to
        losing an acknowledged write (AcknowledgedWriteNotLost,
        VSR.tla:945-950).  0 while nothing is acked; afterwards
        1 + 2 * (replicas missing the worst acked value) + 1 if some
        Normal replica lags the max view while holding an acked value
        + 1 if a GetState record is in the bag."""
        acked = st["aux_acked"] == 2                          # [B, V]
        has = self._replica_has_op(st)                        # [B, R, V]
        missing = (~has).sum(dim=1)                           # [B, V]
        worst = torch.where(acked, missing, -1).amax(dim=1)
        vmax = st["view"].amax(dim=1, keepdim=True)
        has_acked_val = (has & acked[:, None, :]).any(dim=2)  # [B, R]
        lag = ((st["status"] == NORMAL) & (st["view"] < vmax)
               & has_acked_val).any(dim=1)
        gs = ((st["m_present"] == 1)
              & (st["m_hdr"][:, :, H_TYPE] == M_GETSTATE)).any(dim=1)
        score = 1 + 2 * worst + lag.to(torch.int64) + gs.to(torch.int64)
        return torch.where(acked.any(dim=1), score, 0).to(I32)

    INVARIANT_FNS = {
        "AcknowledgedWriteNotLost": "inv_acknowledged_write_not_lost",
        "AcknowledgedWritesExistOnMajority":
            "inv_acknowledged_writes_exist_on_majority",
        "NoLogDivergence": "inv_no_log_divergence",
        "TestInv": "inv_test",
        "AllReplicasMoveToSameView": "pred_all_replicas_same_view",
    }

    def invariant_fns(self, names):
        """[(name, st -> [B] bool)] for the named invariants, in order.
        Raises KeyError for invariants with no device kernel."""
        return [(n, getattr(self, self.INVARIANT_FNS[n])) for n in names]

    def invariant_fn(self, names):
        fns = self.invariant_fns(names)

        def check(st):
            ok = torch.ones_like(st["err"], dtype=torch.bool)
            for _n, f in fns:
                ok = ok & f(st)
            return ok
        return check
