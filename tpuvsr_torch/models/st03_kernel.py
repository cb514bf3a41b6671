"""Batched transition kernel for VR_STATE_TRANSFER (ST03), and the ST03
form of kernel K3.

The PyTorch counterpart of ``tpuvsr/models/st03_kernel.py``, in the
batch style of ``models/vsr_kernel.py``: ``st`` is a dict of ``[B,
...plane]`` int32 tensors, an action takes one lane index per batch item
and returns (successor dict, enabled [B]), a guard takes the batch alone
and returns the ``[B, L_a]`` enabled matrix over all of the action's
lanes (the JAX guards are per (state, lane) functions under
``jax.vmap``).  Lane plan and semantics are the JAX kernel's: ST03's
16-action Next (ST03:779-797), quorums counted over count-0 bag
tombstones (ST03:595-600, 669-674), ``SendAsReceived`` count-0 inserts
(ST03:186-187), ``AnyDest`` GetState receives enumerated per (slot,
receiving replica) (ST03:213-218), the ``StateTransfer`` status, and
``NoProgressChange`` over ``SUBSET replicas`` (one lane per bitmask,
ST03:764-776).  The arithmetic is identical, so guards, successors,
fingerprints and invariants are bit-identical to JAX's.

K3 (``models/fingerprint.RowFingerprint``): the fingerprint has a
global row, ``no_prog`` and ``np_ctr`` (``_glob_hash``, JAX :813), that
``parent_parts`` leaves out and the incremental fingerprint recomputes
for every successor; CUDA tensors go to ``csrc/vsr_fingerprint.cu``.

K13: ``guard_matrix`` evaluates the 16 guards over every lane of flat
rows in one launch (``csrc/st03_guards.cu``); its plain version is the
loop over ``_guard_fns``.

K14: ``successors`` applies a work queue of (parent row, action, lane)
items in one launch (``csrc/st03_actions.cu``) with K10's outputs: the
successor rows, the enabled bits, the error flags, the touch lists, the
lane replicas and the cfg invariants on each successor.  Its plain
version ``successors_plain`` runs the ``act_*`` functions.  Every call
of ``_action_fns`` and ``_guard_fns`` (the plain functions' only doors)
is counted in ``PLAIN_CALLS``.

The family.  A01, I01, AS04, RR05, AL05 and CP06
(``models/{a01,i01,as04,rr05,al05,cp06}_kernel.py``) subclass this
kernel as their JAX counterparts subclass JAX's, and run on the same
two CUDA sources: K13 and K14 are templated on the model,
with one C entry point each (``GUARDS_KERNEL``, ``ACTIONS_KERNEL``).  A
subclass names its planes beyond ST03's in ``FAMILY_PLANES`` order
(``PLANE_KEYS``, ``GUARD_KEYS``; a plane a model lacks has offset -1 and
is never read), its actions by their family ids (``FAMILY_ACTIONS``,
``ACTION_ALIASES``) and its invariants by their family bits
(``FAMILY_INVARIANTS``).

Symmetry.  The engine builds the kernel with the identity permutation
table only: ``engine/canon.CanonSpec`` owns the reduction.  It reads the
planes a value permutation relabels (``PERM_REP_KEYS``,
``PERM_MSG_KEYS``), applies ``_permuted`` in its plain version, and runs
K9 (``csrc/canon.cu``, launches counted under ``CANON_KERNEL``) in the
mode ``CANON_MODE`` names, the one statement of how a class relabels
(``_perm_vals`` reads it too): ST03's value ids are ``plain``, A01's
packed entries ``packed``, CP06's ids with a fixed NoOp ``noop``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from .. import kernels
from ..engine.canon import relabel_by_mode
from .fingerprint import RowFingerprint
from .st03 import (ANYDEST, ERR_BAG_OVERFLOW, M_DVC, M_GETSTATE,
                   M_NEWSTATE, M_PREPARE, M_PREPAREOK, M_SV, M_SVC, NORMAL,
                   STATETRANSFER, VIEWCHANGE, ST03Codec)
from .vsr import (H_COMMIT, H_DEST, H_FIRST, H_LNV, H_OP, H_SRC, H_TYPE,
                  H_VIEW, H_X)
from .vsr_kernel import (_clip, _col, _first_true, _iota, _put, _put2,
                         _take, _take2, _where)

I32 = torch.int32
INF = 0x7FFFFFFF

ACTION_NAMES = (
    "TimerSendSVC", "ReceiveHigherSVC", "ReceiveMatchingSVC", "SendDVC",
    "ReceiveHigherDVC", "ReceiveMatchingDVC", "SendSV", "ReceiveSV",
    "ReceiveClientRequest", "ReceivePrepareMsg", "ReceivePrepareOkMsg",
    "ExecuteOp", "SendGetState", "ReceiveGetState", "ReceiveNewState",
    "NoProgressChange",
)

REP_KEYS = ("status", "view", "op", "commit", "lnv", "log", "peer_op",
            "sent_dvc", "sent_sv")
GLOBAL_KEYS = ("no_prog", "np_ctr")
MSG_KEYS = ("m_present", "m_count", "m_hdr", "m_entry", "m_log")
AUX_KEYS = ("aux_svc", "aux_acked", "err")
# every plane, in the codec's zero_state order (csrc/st03_actions.cu
# enum Plane)
ALL_KEYS = REP_KEYS + GLOBAL_KEYS + MSG_KEYS + AUX_KEYS
# the planes K13 reads, in the order of csrc/st03_guards.cu enum Plane
GUARD_PLANES = ("status", "view", "op", "commit", "peer_op", "sent_dvc",
                "sent_sv", "no_prog", "np_ctr", "m_present", "m_count",
                "m_hdr", "m_entry", "m_log", "aux_svc", "aux_acked")
# the family's planes beyond ST03's, in the order of the FamilyPlane enum
# of csrc/st03_actions.cu (I01's tracker and sent flag, AS04's DVC slots
# and app plane, RR05's recovery nonce and response slots, AL05's prefix
# ceilings, RR05's crash counter, CP06's checkpoint fields of the DVC and
# response slots and its bag's checkpoint plane)
FAMILY_PLANES = ("sent_svc", "dvc", "dvc_view", "dvc_lnv", "dvc_op",
                 "dvc_commit", "dvc_log", "app", "rec_number", "rec",
                 "rec_view", "rec_has_log", "rec_log", "rec_op",
                 "rec_commit", "rec_ceil", "aux_restart", "dvc_cpn",
                 "dvc_cp", "rec_flag", "rec_first", "rec_cp", "rec_cpn",
                 "m_cp")
# the ones K13 reads, in the order of its FamilyPlane enum
# (csrc/st03_guards.cu; CP06's guards read the log and the bag's
# checkpoint plane)
FAMILY_GUARD_PLANES = ("sent_svc", "dvc", "dvc_view", "rec_number", "rec",
                       "rec_view", "rec_has_log", "aux_restart", "log",
                       "m_cp")
# the family's action ids (csrc/st03_actions.cu enums Action and
# FamilyAction); a model's action takes the id of its name, or of the
# ST03 action it replaces
FAMILY_ACTIONS = ACTION_NAMES + (
    "ResendSVC", "Crash", "ReceiveRecoveryMsg",
    "ReceiveRecoveryResponseMsg", "CompleteRecovery", "RetryRecovery",
    "ReceiveGetCheckpointMsg", "ReceiveNewCheckpointMsg")
ACTION_ALIASES = {"PrimaryExecuteOp": "ExecuteOp"}
# the family's invariant bits (enums Invariant and FamilyInvariant)
FAMILY_INVARIANTS = (
    "NoLogDivergence", "AcknowledgedWriteNotLost",
    "AcknowledgedWritesExistOnMajority",
    "CommitNumberNeverHigherThanOpNumber", "TestInv",
    "AllReplicasMoveToSameView", "NoReplicaMoreThanOneViewAheadOfMajority",
    "ReceivedDVCsAllSameView", "NoAppStateDivergence",
    "CommitNumberMatchesAppState")
# calls of the family's _action_fns and _guard_fns, the doors to the
# plain action and guard functions
PLAIN_CALLS = {"actions": 0, "guards": 0}


class ST03Kernel(RowFingerprint):
    action_names = ACTION_NAMES
    REP_KEYS = REP_KEYS
    SLOT_KEYS = ("m_hdr", "m_entry", "m_log", "m_count")
    # (record field, bag plane) of a message's payload beyond its header
    # (CP06 adds its checkpoint plane)
    ROW_PLANES = (("entry", "m_entry"), ("log", "m_log"))
    GLOB_KEYS = GLOBAL_KEYS
    FP_KERNELS = {"full": "st03_fp_full", "parts": "st03_fp_parts",
                  "incremental": "st03_fp_incremental"}
    # (kernels.KERNELS name, C entry point) of K13, K14 and K18 for the
    # model
    GUARDS_KERNEL = ("st03_guards", "tpuvsr_st03_guards")
    ACTIONS_KERNEL = ("st03_actions", "tpuvsr_st03_actions")
    STATE_PRED_KERNEL = ("st03_state_pred", "tpuvsr_st03_state_pred")
    # the planes K14 and K13 locate (ST03's, then the family's)
    PLANE_KEYS = ALL_KEYS
    GUARD_KEYS = GUARD_PLANES
    ERR_BAG_OVERFLOW = ERR_BAG_OVERFLOW
    # CrashLimit, which K13 and K14 take (a model with recovery sets it)
    crash_limit = 0
    # the value-id planes a symmetry permutation relabels
    # (tpuvsr/models/st03_kernel.py:86-87; engine/canon.orbit_planes reads
    # them), their relabelling (_perm_vals and K9) and the name K9's
    # launches count under
    PERM_REP_KEYS = ("log",)
    PERM_MSG_KEYS = ("m_entry", "m_log")
    CANON_MODE = ("plain", 0)
    CANON_KERNEL = "st03_canon"

    def __init__(self, codec: ST03Codec, perms: np.ndarray = None,
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
            raise ValueError(f"the port's {type(self).__name__} takes the "
                             "identity permutation table only")
        acts, params = [], []
        for aid, name in enumerate(self.action_names):
            n = self._lane_count(name)
            acts.append(np.full(n, aid, np.int32))
            params.append(np.arange(n, dtype=np.int32))
        self.lane_action = np.concatenate(acts)
        self.lane_param = np.concatenate(params)
        self.n_lanes = int(self.lane_action.size)

        # the same coefficient draws as the JAX kernel (same generator,
        # seed and order: rep, msg, global row, seeds)
        rng = np.random.default_rng(0x57A7E03)
        self.nrep = 1 + sum(int(np.prod(self._rep_shape(k))) // s.R
                            for k in self.REP_KEYS)
        self.nmsg = self._nmsg()

        def keys(n):
            return (rng.integers(1, 2**32, size=(4, n), dtype=np.uint64)
                    .astype(np.uint32) | 1)
        self._k_rep = keys(self.nrep)
        self._k_msg = keys(self.nmsg)
        self._k_glob = keys(s.R + 1)
        self._seeds = (rng.integers(1, 2**32, size=(4,), dtype=np.uint64)
                       .astype(np.uint32))
        self.pk = pack_spec
        self._fp_tables = {}
        if pack_spec is not None:
            self._build_row_tables(pack_spec)

    def _perm_vals(self, arr, perm):
        """A value permutation on one plane, in the class's
        ``CANON_MODE`` (``tpuvsr/models/st03_kernel.py:773``; A01's
        packed entries ``a01_kernel.py:42``, CP06's NoOp
        ``cp06_kernel.py:66``)."""
        mode, shift = self.CANON_MODE
        return relabel_by_mode(perm, arr, mode, shift, self.V)

    def _permuted(self, st, perm):
        """A batch relabelled through one symmetry permutation (``perm``
        [V+1]): the ``PERM_REP_KEYS`` and ``PERM_MSG_KEYS`` planes through
        ``_perm_vals`` (``tpuvsr/models/st03_kernel.py:779``)."""
        st = dict(st)
        for k in self.PERM_REP_KEYS + self.PERM_MSG_KEYS:
            st[k] = self._perm_vals(st[k], perm)
        return st

    def _rep_shape(self, k):
        s = self.shape
        return {
            "status": (s.R,), "view": (s.R,), "op": (s.R,),
            "commit": (s.R,), "lnv": (s.R,), "log": (s.R, s.MAX_OPS),
            "peer_op": (s.R, s.R), "sent_dvc": (s.R,), "sent_sv": (s.R,),
        }[k]

    def _nmsg(self):
        """Columns of a slot row: the header, the entry, the log and the
        count."""
        return self.NHDR + 1 + self.MAX_OPS + 1

    def _lane_count(self, name):
        R, V, M = self.R, self.V, self.M
        return {"TimerSendSVC": R, "SendDVC": R, "SendSV": R,
                "ExecuteOp": R, "ReceiveClientRequest": R * V,
                "ReceiveGetState": M * R,
                "NoProgressChange": 1 << R}.get(name, M)

    # ==================================================================
    # message-bag primitives (ST03:164-218), batched
    # ==================================================================
    def _row(self, B, dev, type_, view=0, op=0, commit=0, dest=0, src=0,
             first=0, lnv=0, entry=0, log=None, x=0):
        cols = [_col(v, B, dev) for v in
                (type_, view, op, commit, dest, src, x, first, lnv)]
        hdr = torch.zeros((B, self.NHDR), dtype=I32, device=dev)
        hdr[:, :9] = torch.stack(cols, dim=1)
        return {"hdr": hdr, "entry": _col(entry, B, dev),
                "log": (log.to(I32) if log is not None else
                        torch.zeros((B, self.MAX_OPS), dtype=I32,
                                    device=dev))}

    def _row_eq(self, st, row):
        """[B, M] mask: a present slot holding the record ``row``."""
        eq = ((st["m_present"] == 1)
              & (st["m_hdr"] == row["hdr"][:, None, :]).all(-1))
        for rk, plane in self.ROW_PLANES:
            cmp = st[plane] == row[rk][:, None]
            eq = eq & (cmp if cmp.dim() == 2 else cmp.all(-1))
        return eq

    def _touch(self, st, idx, pred):
        if "_ts" not in st:
            return st
        st = dict(st)
        n = _clip(st["_tn"], 0, st["_ts"].shape[1] - 1)
        st["_ts"] = _where(pred, _put(st["_ts"], n, idx), st["_ts"])
        st["_tn"] = st["_tn"] + pred.to(I32)
        return st

    def _bag_send(self, st, row, pred=None, new_count=1):
        """SendFunc(m, msgs, new_count) (ST03:164-168): +1 if the record
        is in the domain (tombstones revive), else insert at the first
        free slot with ``new_count`` pending deliveries (0 =
        SendAsReceived); with no free slot, slot 0 and the overflow
        flag."""
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
        st["m_count"] = _put(st["m_count"], idx, _take(st["m_count"], idx)
                             + (pred & found).to(I32))
        wr = pred & ~found

        def put(cur, val):
            return _where(wr, _put(cur, idx, val), cur)
        st["m_present"] = _where(pred, _put(st["m_present"], idx, 1),
                                 st["m_present"])
        st["m_count"] = put(st["m_count"], new_count)
        st["m_hdr"] = put(st["m_hdr"], row["hdr"])
        for rk, plane in self.ROW_PLANES:
            st[plane] = put(st[plane], row[rk])
        st["err"] = st["err"] | torch.where(overflow, ERR_BAG_OVERFLOW, 0
                                            ).to(I32)
        return st

    def _bag_discard(self, st, k):
        B, dev = k.shape[0], k.device
        st = self._touch(st, k, torch.ones((B,), dtype=torch.bool,
                                           device=dev))
        st = dict(st)
        st["m_count"] = _put(st["m_count"], k, _take(st["m_count"], k) - 1)
        return st

    def _broadcast(self, st, row, src):
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

    def _is_normal_primary(self, st, i, r):
        return ((self._primary(_take(st["view"], i), self.R) == r)
                & (_take(st["status"], i) == NORMAL))

    def _can_progress(self, st, i):
        return _take(st["no_prog"], i) == 0

    def _reset_sent(self, st, i):
        st["sent_dvc"] = _put(st["sent_dvc"], i, 0)
        st["sent_sv"] = _put(st["sent_sv"], i, 0)
        return st

    def _processed(self, st, i, mtype):
        """[B, M]: processed (count-0) ``mtype`` records of replica i's
        view addressed to it (ValidDvc, ST03:669-674; the SVC quorum,
        ST03:595-600)."""
        h = st["m_hdr"]
        return ((st["m_present"] == 1) & (st["m_count"] == 0)
                & (h[:, :, H_TYPE] == mtype)
                & (h[:, :, H_DEST] == (i + 1)[:, None])
                & (h[:, :, H_VIEW] == _take(st["view"], i)[:, None]))

    def _svc_tombstones(self, st, i):
        return self._processed(st, i, M_SVC).sum(dim=1)

    def _splice(self, own, suffix, first, op):
        """The log a NewState installs over 1..op: ``own`` [B, OPS] below
        first_op, the suffix (stored re-based at 0) from there, zero
        above op."""
        pos = _iota(self.MAX_OPS, own.device)[None, :]
        f1 = (first - 1)[:, None]
        sfx = suffix.gather(1, _clip(pos - f1, 0, self.MAX_OPS - 1).long())
        return torch.where(pos < f1, own,
                           torch.where(pos < op[:, None], sfx, 0))

    def _msg_lane(self, st, k):
        """Header and destination replica of message lane k ([B])."""
        hdr = _take(st["m_hdr"], k)
        r = hdr[:, H_DEST]
        i = _clip(r - 1, 0, self.R - 1)
        return hdr, r, i

    def _recv_en(self, st, k, hdr, mtype):
        return ((_take(st["m_present"], k) == 1)
                & (_take(st["m_count"], k) > 0) & (hdr[:, H_TYPE] == mtype))

    # ==================================================================
    # the 16 actions
    # ==================================================================
    def act_timer_send_svc(self, st, lane):       # ST03:515-535
        i = lane
        r = i + 1
        B, dev = lane.shape[0], lane.device
        en = ((st["aux_svc"] < self.shape.timer_limit)
              & self._can_progress(st, i)
              & ~self._is_normal_primary(st, i, r))
        new_view = _take(st["view"], i) + 1
        s2 = dict(st)
        s2["view"] = _put(st["view"], i, new_view)
        s2["status"] = _put(st["status"], i, VIEWCHANGE)
        s2 = self._reset_sent(s2, i)
        s2["aux_svc"] = st["aux_svc"] + 1
        s2 = self._broadcast(s2, self._row(B, dev, M_SVC, view=new_view,
                                           src=r), r)
        return s2, en

    def _receive_higher(self, st, lane, mtype):   # ST03:537-556, 616-635
        k = lane
        B, dev = lane.shape[0], lane.device
        hdr, r, i = self._msg_lane(st, k)
        en = (self._recv_en(st, k, hdr, mtype) & self._can_progress(st, i)
              & (hdr[:, H_VIEW] > _take(st["view"], i)))
        s2 = dict(st)
        s2["view"] = _put(st["view"], i, hdr[:, H_VIEW])
        s2["status"] = _put(st["status"], i, VIEWCHANGE)
        s2 = self._reset_sent(s2, i)
        s2 = self._bag_discard(s2, k)
        s2 = self._broadcast(s2, self._row(B, dev, M_SVC,
                                           view=hdr[:, H_VIEW], src=r), r)
        return s2, en

    def _receive_matching(self, st, lane, mtype):  # ST03:558-575, 637-654
        k = lane
        hdr, _r, i = self._msg_lane(st, k)
        en = (self._recv_en(st, k, hdr, mtype) & self._can_progress(st, i)
              & (_take(st["status"], i) == VIEWCHANGE)
              & (hdr[:, H_VIEW] == _take(st["view"], i)))
        return self._bag_discard(dict(st), k), en

    def act_receive_higher_svc(self, st, lane):
        return self._receive_higher(st, lane, M_SVC)

    def act_receive_matching_svc(self, st, lane):
        return self._receive_matching(st, lane, M_SVC)

    def act_send_dvc(self, st, lane):             # ST03:577-614
        i = lane
        r = i + 1
        B, dev = lane.shape[0], lane.device
        view = _take(st["view"], i)
        prim = self._primary(view, self.R)
        en = (self._can_progress(st, i)
              & (_take(st["status"], i) == VIEWCHANGE)
              & (_take(st["sent_dvc"], i) == 0)
              & (self._svc_tombstones(st, i) >= self.R // 2))
        s2 = dict(st)
        s2["sent_dvc"] = _put(st["sent_dvc"], i, 1)
        row = self._row(B, dev, M_DVC, view=view, op=_take(st["op"], i),
                        commit=_take(st["commit"], i), dest=prim, src=r,
                        lnv=_take(st["lnv"], i), log=_take(st["log"], i))
        # the new primary's own DVC is born processed (SendAsReceived,
        # ST03:610-613); everyone else Sends it for delivery
        s2 = self._bag_send(s2, row,
                            new_count=torch.where(prim == r, 0, 1))
        return s2, en

    def act_receive_higher_dvc(self, st, lane):
        return self._receive_higher(st, lane, M_DVC)

    def act_receive_matching_dvc(self, st, lane):
        return self._receive_matching(st, lane, M_DVC)

    def _highest_log(self, st, i):
        """HighestLog/-OpNumber/-CommitNumber (ST03:676-697): the maximal
        (lnv, op) ValidDvc, CHOOSE ties by lex (commit, log, source);
        commit maximized independently."""
        valid = self._processed(st, i, M_DVC)                # [B, M]
        h = st["m_hdr"]
        pair = h[:, :, H_LNV] * (self.MAX_OPS + 1) + h[:, :, H_OP]
        best_pair = torch.where(valid, pair, -1).amax(dim=1)
        cand = valid & (pair == best_pair[:, None])
        keys = torch.cat([h[:, :, H_COMMIT][:, :, None], st["m_log"],
                          h[:, :, H_SRC][:, :, None]], dim=2)
        for c in range(keys.shape[2]):
            col = torch.where(cand, keys[:, :, c], INF)
            cand = cand & (col == col.amin(dim=1, keepdim=True))
        best_k = _first_true(cand)
        new_log = _take(st["m_log"], best_k)
        new_on = _take(h, best_k)[:, H_OP]
        new_cn = torch.where(valid, h[:, :, H_COMMIT], -1).amax(dim=1)
        return new_log, new_on, new_cn, valid.sum(dim=1)

    def act_send_sv(self, st, lane):              # ST03:699-731
        i = lane
        r = i + 1
        B, dev = lane.shape[0], lane.device
        view = _take(st["view"], i)
        new_log, new_on, new_cn, n_valid = self._highest_log(st, i)
        en = (self._can_progress(st, i)
              & (_take(st["status"], i) == VIEWCHANGE)
              & (_take(st["sent_sv"], i) == 0)
              & (n_valid >= self.R // 2 + 1))
        s2 = dict(st)
        s2["status"] = _put(st["status"], i, NORMAL)
        s2["log"] = _put(st["log"], i, new_log)
        s2["op"] = _put(st["op"], i, new_on)
        s2["peer_op"] = _put(st["peer_op"], i, 0)
        s2["commit"] = _put(st["commit"], i, new_cn)
        s2["sent_sv"] = _put(st["sent_sv"], i, 1)
        s2["lnv"] = _put(st["lnv"], i, view)
        row = self._row(B, dev, M_SV, view=view, op=new_on, commit=new_cn,
                        src=r, log=new_log)
        s2 = self._broadcast(s2, row, r)
        return s2, en

    def act_receive_sv(self, st, lane):           # ST03:733-762
        k = lane
        B, dev = lane.shape[0], lane.device
        hdr, r, i = self._msg_lane(st, k)
        hv, view_i = hdr[:, H_VIEW], _take(st["view"], i)
        en = (self._recv_en(st, k, hdr, M_SV) & self._can_progress(st, i)
              & (((hv == view_i) & (_take(st["status"], i) == VIEWCHANGE))
                 | (hv > view_i)))
        old_commit = _take(st["commit"], i)
        s2 = dict(st)
        s2["status"] = _put(st["status"], i, NORMAL)
        s2["view"] = _put(st["view"], i, hv)
        s2["log"] = _put(st["log"], i, _take(st["m_log"], k))
        s2["op"] = _put(st["op"], i, hdr[:, H_OP])
        s2["commit"] = _put(st["commit"], i, hdr[:, H_COMMIT])
        s2["lnv"] = _put(st["lnv"], i, hv)
        s2 = self._reset_sent(s2, i)
        s2 = self._bag_discard(s2, k)
        ok_row = self._row(B, dev, M_PREPAREOK, view=hv, op=hdr[:, H_OP],
                           dest=self._primary(hv, self.R), src=r)
        s2 = self._bag_send(s2, ok_row, pred=old_commit < hdr[:, H_OP])
        return s2, en

    def act_receive_client_request(self, st, lane):  # ST03:293-325
        i = torch.div(lane, self.V, rounding_mode="floor")
        r = i + 1
        vid = torch.remainder(lane, self.V) + 1
        B, dev = lane.shape[0], lane.device
        en = (self._can_progress(st, i)
              & self._is_normal_primary(st, i, r)
              & (_take(st["aux_acked"], vid - 1) == 0))
        opn = _take(st["op"], i) + 1
        s2 = dict(st)
        s2["log"] = _put2(st["log"], i, _clip(opn - 1, 0, self.MAX_OPS - 1),
                          vid)
        s2["op"] = _put(st["op"], i, opn)
        s2["aux_acked"] = _put(st["aux_acked"], vid - 1, 1)
        row = self._row(B, dev, M_PREPARE, view=_take(st["view"], i),
                        op=opn, commit=_take(st["commit"], i), src=r,
                        entry=vid)
        s2 = self._broadcast(s2, row, r)
        return s2, en

    def act_receive_prepare(self, st, lane):      # ST03:327-348
        k = lane
        B, dev = lane.shape[0], lane.device
        hdr, r, i = self._msg_lane(st, k)
        view_i = _take(st["view"], i)
        en = (self._recv_en(st, k, hdr, M_PREPARE)
              & self._can_progress(st, i)
              & ~self._is_normal_primary(st, i, r)
              & (_take(st["status"], i) == NORMAL)
              & (hdr[:, H_VIEW] == view_i)
              & (hdr[:, H_OP] == _take(st["op"], i) + 1))
        s2 = dict(st)
        s2["log"] = _put2(st["log"], i,
                          _clip(hdr[:, H_OP] - 1, 0, self.MAX_OPS - 1),
                          _take(st["m_entry"], k))
        s2["op"] = _put(st["op"], i, hdr[:, H_OP])
        s2["commit"] = _put(st["commit"], i, hdr[:, H_COMMIT])
        s2 = self._bag_discard(s2, k)
        ok_row = self._row(B, dev, M_PREPAREOK, view=view_i, op=hdr[:, H_OP],
                           dest=hdr[:, H_SRC], src=r)
        s2 = self._bag_send(s2, ok_row)
        return s2, en

    def act_receive_prepare_ok(self, st, lane):   # ST03:350-374
        k = lane
        hdr, r, i = self._msg_lane(st, k)
        j = _clip(hdr[:, H_SRC] - 1, 0, self.R - 1)
        en = (self._recv_en(st, k, hdr, M_PREPAREOK)
              & self._can_progress(st, i)
              & self._is_normal_primary(st, i, r)
              & (hdr[:, H_VIEW] == _take(st["view"], i))
              & (hdr[:, H_OP] > _take2(st["peer_op"], i, j)))
        s2 = dict(st)
        s2["peer_op"] = _put2(st["peer_op"], i, j, hdr[:, H_OP])
        s2 = self._bag_discard(s2, k)
        return s2, en

    def act_execute_op(self, st, lane):           # ST03:377-405
        i = lane
        r = i + 1
        opn = _take(st["commit"], i) + 1
        committed = ((_take(st["peer_op"], i) >= opn[:, None]).sum(dim=1)
                     >= self.R // 2)
        en = (self._can_progress(st, i)
              & self._is_normal_primary(st, i, r)
              & (_take(st["commit"], i) < _take(st["op"], i)) & committed)
        vid = _take2(st["log"], i, _clip(opn - 1, 0, self.MAX_OPS - 1))
        s2 = dict(st)
        s2["commit"] = _put(st["commit"], i, opn)
        s2["aux_acked"] = _put(st["aux_acked"],
                               _clip(vid - 1, 0, self.V - 1), 2)
        return s2, en

    def act_send_get_state(self, st, lane):       # ST03:407-447
        k = lane
        B, dev = lane.shape[0], lane.device
        hdr, r, i = self._msg_lane(st, k)
        # SendGetState requests from the replica's commit number and
        # keeps its log (ST03:431-447); SendOnce: the record must not be
        # in the bag at all, a count-0 tombstone included
        row = self._row(B, dev, M_GETSTATE, view=hdr[:, H_VIEW],
                        op=_take(st["commit"], i), dest=ANYDEST, src=i + 1)
        en = (self._recv_en(st, k, hdr, M_PREPARE)
              & self._can_progress(st, i)
              & ~self._is_normal_primary(st, i, r)
              & (_take(st["status"], i) == NORMAL)
              & (hdr[:, H_VIEW] > _take(st["view"], i))
              & (hdr[:, H_OP] > _take(st["op"], i) + 1)
              & ~self._row_eq(st, row).any(dim=1))
        s2 = dict(st)
        s2["status"] = _put(st["status"], i, STATETRANSFER)
        s2 = self._bag_send(s2, row)
        return s2, en

    def act_receive_get_state(self, st, lane):    # ST03:449-477
        k = torch.div(lane, self.R, rounding_mode="floor")
        i = torch.remainder(lane, self.R)
        r = i + 1
        B, dev = lane.shape[0], lane.device
        hdr = _take(st["m_hdr"], k)
        dest = hdr[:, H_DEST]
        op_i = _take(st["op"], i)
        en = ((_take(st["m_present"], k) == 1) & (_take(st["m_count"], k) > 0)
              & (hdr[:, H_TYPE] == M_GETSTATE)
              & ((dest == r) | ((dest == ANYDEST) & (hdr[:, H_SRC] != r)))
              & self._can_progress(st, i)
              & (_take(st["status"], i) == NORMAL)
              & (_take(st["view"], i) == hdr[:, H_VIEW])
              & (op_i > hdr[:, H_OP]))
        # log slice m.op_number+1 .. rep_op_number[r], re-based to 0
        first = hdr[:, H_OP] + 1
        pos = _iota(self.MAX_OPS, dev)[None, :]
        src_pos = _clip(pos + (first - 1)[:, None], 0, self.MAX_OPS - 1)
        n = op_i - hdr[:, H_OP]
        slice_log = torch.where(pos < n[:, None],
                                _take(st["log"], i).gather(1, src_pos.long()),
                                0)
        s2 = self._bag_discard(dict(st), k)
        row = self._row(B, dev, M_NEWSTATE, view=_take(st["view"], i),
                        op=op_i, commit=_take(st["commit"], i), first=first,
                        dest=hdr[:, H_SRC], src=r, log=slice_log)
        s2 = self._bag_send(s2, row)
        return s2, en

    def act_receive_new_state(self, st, lane):    # ST03:479-507
        k = lane
        hdr, _r, i = self._msg_lane(st, k)
        en = (self._recv_en(st, k, hdr, M_NEWSTATE)
              & self._can_progress(st, i)
              & (_take(st["status"], i) == STATETRANSFER)
              & (hdr[:, H_VIEW] > _take(st["view"], i)))
        new_log = self._splice(_take(st["log"], i), _take(st["m_log"], k),
                               hdr[:, H_FIRST], hdr[:, H_OP])
        s2 = dict(st)
        s2["status"] = _put(st["status"], i, NORMAL)
        s2["view"] = _put(st["view"], i, hdr[:, H_VIEW])
        s2["lnv"] = _put(st["lnv"], i, hdr[:, H_VIEW])
        s2["log"] = _put(st["log"], i, new_log)
        s2["op"] = _put(st["op"], i, hdr[:, H_OP])
        s2["commit"] = _put(st["commit"], i, hdr[:, H_COMMIT])
        s2 = self._bag_discard(s2, k)
        return s2, en

    def _subset_bits(self, lane):
        """[..., R] membership bits of the SUBSET lanes ``lane``."""
        return (lane[..., None] >> _iota(self.R, lane.device)) & 1

    def act_no_progress_change(self, st, lane):   # ST03:764-776
        bits = self._subset_bits(lane)
        en = ((st["np_ctr"] < self.shape.np_limit)
              & (bits.sum(dim=1) <= self.R // 2))
        s2 = dict(st)
        s2["no_prog"] = bits.to(I32)
        s2["np_ctr"] = st["np_ctr"] + 1
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
        recv = ((st["m_present"] == 1) & (st["m_count"] > 0)
                & (self._g(st["no_prog"], i) == 0))
        return hdr, i, recv

    def _rep_normal_primary(self, st):
        """[B, R]: replica r is the Normal primary of its own view."""
        r = _iota(self.R, st["view"].device) + 1
        return ((self._primary(st["view"], self.R) == r[None, :])
                & (st["status"] == NORMAL))

    def _msg_normal_primary(self, st, hdr, i):
        """[B, M]: the receiver of each slot is the Normal primary of its
        view under the slot's (unclipped) destination."""
        return ((self._primary(self._g(st["view"], i), self.R)
                 == hdr[:, :, H_DEST])
                & (self._g(st["status"], i) == NORMAL))

    def _guard_recv(self, st, mtype):
        """recv & type & CanProgress(receiver): (hdr, i, mask, view_i)."""
        hdr, i, recv = self._msg_cols(st)
        return (hdr, i, recv & (hdr[:, :, H_TYPE] == mtype),
                self._g(st["view"], i))

    def _tombstones(self, st, mtype):
        """[B, R, M]: slot m is a processed (count-0) ``mtype`` record
        addressed to replica r in r's view."""
        h = st["m_hdr"]
        r = _iota(self.R, h.device) + 1
        return (((st["m_present"] == 1) & (st["m_count"] == 0)
                 & (h[:, :, H_TYPE] == mtype))[:, None, :]
                & (h[:, None, :, H_DEST] == r[None, :, None])
                & (h[:, None, :, H_VIEW] == st["view"][:, :, None]))

    def guard_timer_send_svc(self, st):
        return ((st["aux_svc"] < self.shape.timer_limit)[:, None]
                & (st["no_prog"] == 0) & ~self._rep_normal_primary(st))

    def guard_receive_higher_svc(self, st):
        hdr, _i, m, view_i = self._guard_recv(st, M_SVC)
        return m & (hdr[:, :, H_VIEW] > view_i)

    def guard_receive_matching_svc(self, st):
        hdr, i, m, view_i = self._guard_recv(st, M_SVC)
        return (m & (self._g(st["status"], i) == VIEWCHANGE)
                & (hdr[:, :, H_VIEW] == view_i))

    def guard_send_dvc(self, st):
        return ((st["no_prog"] == 0) & (st["status"] == VIEWCHANGE)
                & (st["sent_dvc"] == 0)
                & (self._tombstones(st, M_SVC).sum(dim=2) >= self.R // 2))

    def guard_receive_higher_dvc(self, st):
        hdr, _i, m, view_i = self._guard_recv(st, M_DVC)
        return m & (hdr[:, :, H_VIEW] > view_i)

    def guard_receive_matching_dvc(self, st):
        hdr, i, m, view_i = self._guard_recv(st, M_DVC)
        return (m & (self._g(st["status"], i) == VIEWCHANGE)
                & (hdr[:, :, H_VIEW] == view_i))

    def guard_send_sv(self, st):
        return ((st["no_prog"] == 0) & (st["status"] == VIEWCHANGE)
                & (st["sent_sv"] == 0)
                & (self._tombstones(st, M_DVC).sum(dim=2)
                   >= self.R // 2 + 1))

    def guard_receive_sv(self, st):
        hdr, i, m, view_i = self._guard_recv(st, M_SV)
        hv = hdr[:, :, H_VIEW]
        return m & (((hv == view_i)
                     & (self._g(st["status"], i) == VIEWCHANGE))
                    | (hv > view_i))

    def guard_receive_client_request(self, st):
        rep = (st["no_prog"] == 0) & self._rep_normal_primary(st)  # [B, R]
        free = st["aux_acked"] == 0                                # [B, V]
        return (rep[:, :, None] & free[:, None, :]).reshape(
            rep.shape[0], self.R * self.V)

    def guard_receive_prepare(self, st):
        hdr, i, m, view_i = self._guard_recv(st, M_PREPARE)
        return (m & ~self._msg_normal_primary(st, hdr, i)
                & (self._g(st["status"], i) == NORMAL)
                & (hdr[:, :, H_VIEW] == view_i)
                & (hdr[:, :, H_OP] == self._g(st["op"], i) + 1))

    def guard_receive_prepare_ok(self, st):
        hdr, i, m, view_i = self._guard_recv(st, M_PREPAREOK)
        j = _clip(hdr[:, :, H_SRC] - 1, 0, self.R - 1)
        peer = st["peer_op"].reshape(-1, self.R * self.R).gather(
            1, (i * self.R + j).long())
        return (m & self._msg_normal_primary(st, hdr, i)
                & (hdr[:, :, H_VIEW] == view_i) & (hdr[:, :, H_OP] > peer))

    def guard_execute_op(self, st):
        opn = st["commit"] + 1                                    # [B, R]
        committed = ((st["peer_op"] >= opn[:, :, None]).sum(dim=2)
                     >= self.R // 2)
        return ((st["no_prog"] == 0) & self._rep_normal_primary(st)
                & (st["commit"] < st["op"]) & committed)

    def guard_send_get_state(self, st):
        hdr, i, m, view_i = self._guard_recv(st, M_PREPARE)
        en = (m & ~self._msg_normal_primary(st, hdr, i)
              & (self._g(st["status"], i) == NORMAL)
              & (hdr[:, :, H_VIEW] > view_i)
              & (hdr[:, :, H_OP] > self._g(st["op"], i) + 1))
        # SendOnce: slot s already holds the GetState record of lane k
        # (view of k, op = the receiver's commit, AnyDest, source i + 1)
        zero = lambda c: hdr[:, :, c] == 0
        base = ((st["m_present"] == 1)
                & (hdr[:, :, H_TYPE] == M_GETSTATE)
                & zero(H_COMMIT) & zero(H_X) & zero(H_FIRST) & zero(H_LNV)
                & (hdr[:, :, H_DEST] == ANYDEST))                 # [B, M]
        for c in range(H_LNV + 1, self.NHDR):     # CP06: H_FLAG, H_CP
            base = base & zero(c)
        for _rk, plane in self.ROW_PLANES:
            v = st[plane]
            base = base & ((v == 0) if v.dim() == 2 else (v == 0).all(-1))
        commit_i = self._g(st["commit"], i)
        a = (base[:, None, :]
             & (hdr[:, None, :, H_VIEW] == hdr[:, :, None, H_VIEW])
             & (hdr[:, None, :, H_OP] == commit_i[:, :, None])
             & (hdr[:, None, :, H_SRC] == (i + 1)[:, :, None]))
        return en & ~a.any(dim=2)

    def guard_receive_get_state(self, st):
        hdr = st["m_hdr"]
        B, dev = hdr.shape[0], hdr.device
        r = _iota(self.R, dev) + 1                                # [R]
        dest, src = hdr[:, :, H_DEST, None], hdr[:, :, H_SRC, None]
        slot = ((st["m_present"] == 1) & (st["m_count"] > 0)
                & (hdr[:, :, H_TYPE] == M_GETSTATE))[:, :, None]
        rep = ((st["no_prog"] == 0) & (st["status"] == NORMAL))[:, None, :]
        en = (slot & ((dest == r) | ((dest == ANYDEST) & (src != r)))
              & rep & (st["view"][:, None, :] == hdr[:, :, H_VIEW, None])
              & (st["op"][:, None, :] > hdr[:, :, H_OP, None]))   # [B,M,R]
        return en.reshape(B, self.M * self.R)

    def guard_receive_new_state(self, st):
        hdr, i, m, view_i = self._guard_recv(st, M_NEWSTATE)
        return (m & (self._g(st["status"], i) == STATETRANSFER)
                & (hdr[:, :, H_VIEW] > view_i))

    def guard_no_progress_change(self, st):
        lanes = _iota(1 << self.R, st["np_ctr"].device)
        small = self._subset_bits(lanes).sum(dim=1) <= self.R // 2
        return (st["np_ctr"] < self.shape.np_limit)[:, None] & small[None, :]

    def _guard_fns(self):
        PLAIN_CALLS["guards"] += 1
        return self._guard_list()

    def _action_fns(self):
        PLAIN_CALLS["actions"] += 1
        return self._action_list()

    def _guard_list(self):
        return [
            self.guard_timer_send_svc, self.guard_receive_higher_svc,
            self.guard_receive_matching_svc, self.guard_send_dvc,
            self.guard_receive_higher_dvc, self.guard_receive_matching_dvc,
            self.guard_send_sv, self.guard_receive_sv,
            self.guard_receive_client_request, self.guard_receive_prepare,
            self.guard_receive_prepare_ok, self.guard_execute_op,
            self.guard_send_get_state, self.guard_receive_get_state,
            self.guard_receive_new_state, self.guard_no_progress_change,
        ]

    def _action_list(self):
        return [
            self.act_timer_send_svc, self.act_receive_higher_svc,
            self.act_receive_matching_svc, self.act_send_dvc,
            self.act_receive_higher_dvc, self.act_receive_matching_dvc,
            self.act_send_sv, self.act_receive_sv,
            self.act_receive_client_request, self.act_receive_prepare,
            self.act_receive_prepare_ok, self.act_execute_op,
            self.act_send_get_state, self.act_receive_get_state,
            self.act_receive_new_state, self.act_no_progress_change,
        ]

    # -- K13: the guard matrix ---------------------------------------------
    def guard_matrix(self, flat, out=None, halt=None):
        """K13 wrapper: every action's guard over every lane of flat
        rows ``flat`` [B, lanes] -> (en [B, n_lanes] bool in lane-table
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

    def _plane_table(self, name, keys, device):
        """The first lane of every plane of ``keys`` in a flat row (-1
        for a plane of ``FAMILY_PLANES`` the model lacks; any other key
        missing from the pack spec raises KeyError), on ``device``
        (cached: a CUDA graph holds its address)."""
        key = (name, str(torch.device(device)))
        t = self._fp_tables.get(key)
        if t is None:
            start = {k: a for k, _s, a, _e in self.pk._splits}
            t = self._fp_tables[key] = torch.tensor(
                [start[k] if k in start or k not in FAMILY_PLANES else -1
                 for k in keys], dtype=I32, device=device)
        return t

    def family_action_ids(self):
        """[n_actions] int32: each action's id in the family's enum
        (csrc/st03_actions.cu Action, FamilyAction)."""
        return np.asarray([FAMILY_ACTIONS.index(ACTION_ALIASES.get(n, n))
                           for n in self.action_names], np.int32)

    def family_mask(self, inv_mask):
        """A model's ``inv_mask`` (bits of its ``INVARIANT_FNS``) as the
        family's invariant bits (``FAMILY_INVARIANTS``), which K14
        reads."""
        mask = 0
        for b, n in enumerate(self.INVARIANT_FNS):
            if inv_mask >> b & 1:
                mask |= 1 << FAMILY_INVARIANTS.index(n)
        return mask

    def guard_tables(self, device):
        """K13's plane offsets (``GUARD_KEYS`` order) and the lane ->
        (family action id, param) tables, on ``device``."""
        key = ("lanes", str(torch.device(device)))
        t = self._fp_tables.get(key)
        if t is None:
            fam = self.family_action_ids()[self.lane_action]
            t = self._fp_tables[key] = {
                "planes": self._plane_table("guards", self.GUARD_KEYS,
                                            device),
                "lane_action": torch.as_tensor(fam).to(device),
                "lane_param": torch.as_tensor(self.lane_param).to(device)}
        return t

    def _guards_kernel(self, flat, out, halt):
        out = self._guard_out(flat, out)
        B, lanes = flat.shape
        t = self.guard_tables(flat.device)
        s = self.shape
        ck = kernels.check
        kernels.launch(
            *self.GUARDS_KERNEL,
            ck(flat, "flat", I32, (B, self.pk.lanes)), B, lanes,
            self.n_lanes, self.R, self.V, self.M, self.MAX_OPS, self.NHDR,
            s.timer_limit, s.np_limit, self.crash_limit,
            t["planes"].data_ptr(),
            t["lane_action"].data_ptr(), t["lane_param"].data_ptr(),
            None if halt is None else ck(halt, "halt", torch.int64, (1,)),
            ck(out[0], "en", torch.bool, (B, self.n_lanes)),
            ck(out[1], "en_any", torch.bool, (B,)), kernels.stream_of(flat))
        return out

    def lane_replica(self, name, st, lane):
        """The one replica a lane's action mutates ([B]).
        NoProgressChange touches no per-replica hashed plane (no_prog is
        in the global row), so any fixed index is correct."""
        if name in ("TimerSendSVC", "SendDVC", "SendSV", "ExecuteOp"):
            return lane
        if name == "NoProgressChange":
            return torch.zeros_like(lane)
        if name == "ReceiveClientRequest":
            return torch.div(lane, self.V, rounding_mode="floor")
        if name == "ReceiveGetState":
            return torch.remainder(lane, self.R)
        return _clip(_take(st["m_hdr"], lane)[:, H_DEST] - 1, 0,
                     self.R - 1).to(lane.dtype)

    def seed_touch(self, st):
        """Add the incremental-fingerprint scratch keys."""
        B, dev = st["view"].shape[0], st["view"].device
        st = dict(st)
        st["_ts"] = torch.full((B, self.R + 1), -1, dtype=I32, device=dev)
        st["_tn"] = torch.zeros((B,), dtype=I32, device=dev)
        return st

    # -- K14: the successors of a work queue ------------------------------
    def invariant_mask(self, names):
        """K14's ``inv_mask``: bit b set for entry b of ``INVARIANT_FNS``
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
        """K14 wrapper, with the interface and outputs of
        ``VSRKernel.successors`` (K10): the work queue ``pidx``, ``aid``,
        ``lane`` ([N] int32) over the flat parents ``flat`` [T, lanes] ->
        ``succ`` [N, lanes], ``en2``, ``err``, ``ts`` [N, R+1], ``tn``,
        ``ri`` and ``iok`` (the AND of the invariants in ``inv_mask``),
        written into ``out`` when given; nothing while ``halt[0]`` is
        set."""
        if flat.device.type == "cpu":
            return self.successors_plain(flat, pidx, aid, lane, inv_mask,
                                         out, halt)
        return self._actions_kernel(flat, pidx, aid, lane, inv_mask, out,
                                    halt)

    def successors_plain(self, flat, pidx, aid, lane, inv_mask, out=None,
                         halt=None):
        """The plain version of K14: each action's ``act_*`` function on
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
        for a, (name, fn) in enumerate(zip(self.action_names,
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
        """The first lane of every plane of ``PLANE_KEYS`` in a flat row
        (csrc/st03_actions.cu enums Plane and FamilyPlane), on
        ``device``."""
        return self._plane_table("actions", self.PLANE_KEYS, device)

    def action_map(self, device):
        """``family_action_ids()`` on ``device`` (cached)."""
        key = ("amap", str(torch.device(device)))
        t = self._fp_tables.get(key)
        if t is None:
            t = self._fp_tables[key] = torch.as_tensor(
                self.family_action_ids()).to(device)
        return t

    def _actions_kernel(self, flat, pidx, aid, lane, inv_mask, out, halt):
        n = pidx.shape[0]
        T, lanes = flat.shape
        out = out if out is not None else self.successor_buffers(
            n, flat.device)
        s = self.shape
        ck = kernels.check
        kernels.launch(
            *self.ACTIONS_KERNEL,
            ck(flat, "flat", I32, (T, self.pk.lanes)), lanes,
            ck(pidx, "pidx", I32, (n,)), ck(aid, "aid", I32, (n,)),
            ck(lane, "lane", I32, (n,)), n,
            self.action_tables(flat.device).data_ptr(),
            self.action_map(flat.device).data_ptr(), self.R, self.V,
            self.M, self.MAX_OPS, self.NHDR, s.timer_limit, s.np_limit,
            self.crash_limit, self.family_mask(int(inv_mask)),
            None if halt is None else ck(halt, "halt", torch.int64, (1,)),
            ck(out["succ"], "succ", I32, (n, lanes)),
            ck(out["en2"], "en2", torch.bool, (n,)),
            ck(out["err"], "err", I32, (n,)),
            ck(out["ts"], "ts", I32, (n, self.R + 1)),
            ck(out["tn"], "tn", I32, (n,)), ck(out["ri"], "ri", I32, (n,)),
            ck(out["iok"], "iok", torch.bool, (n,)),
            kernels.stream_of(flat))
        return out

    # -- K18: the invariants on states themselves -------------------------
    def state_predicates(self, flat, mask):
        """K18 wrapper: flat rows [N, lanes] -> int32 [N], bit b set iff
        entry b of ``INVARIANT_FNS`` holds on the row, for the bits of
        ``mask`` (``invariant_mask``; the others 0).  A CPU tensor takes
        the plain version, a CUDA tensor the kernel (K14's invariant
        code, csrc/st03_actions.cu, one call a bit)."""
        if flat.device.type == "cpu":
            return self.state_predicates_plain(flat, mask)
        return self._state_pred_kernel(flat, mask)

    def state_predicates_plain(self, flat, mask):
        """The plain version of K18: the ``INVARIANT_FNS`` entries of
        ``mask`` on the unflattened rows, one bit each."""
        st = self.pk.unflatten(flat)
        out = torch.zeros((flat.shape[0],), dtype=I32, device=flat.device)
        for b, f in enumerate(self.INVARIANT_FNS.values()):
            if int(mask) >> b & 1:
                out |= getattr(self, f)(st).to(I32) << b
        return out

    def _state_pred_kernel(self, flat, mask):
        N, lanes = flat.shape
        out = torch.empty((N,), dtype=I32, device=flat.device)
        key = ("fbit", str(flat.device))
        fbit = self._fp_tables.get(key)
        if fbit is None:
            fbit = self._fp_tables[key] = torch.tensor(
                [FAMILY_INVARIANTS.index(n) for n in self.INVARIANT_FNS],
                dtype=I32, device=flat.device)
        ck = kernels.check
        kernels.launch(
            *self.STATE_PRED_KERNEL,
            ck(flat, "flat", I32, (N, self.pk.lanes)), lanes, N,
            self.action_tables(flat.device).data_ptr(), fbit.data_ptr(),
            len(self.INVARIANT_FNS), self.R, self.V, self.M, self.MAX_OPS,
            self.NHDR, self.shape.timer_limit, int(mask),
            ck(out, "out", I32, (N,)), kernels.stream_of(flat))
        return out

    # ==================================================================
    # invariants (ST03:804-850), batched: st -> [B] bool
    # ==================================================================
    def _replica_has_op(self, st):
        """[B, R, V]: replica r's log holds value v."""
        v_ids = _iota(self.V, st["log"].device) + 1
        return (st["log"][:, :, :, None] == v_ids).any(dim=2)

    def inv_no_log_divergence(self, st):
        # the r1-vs-r2, commit-gated divergence check (ST03:805-811)
        pos = _iota(self.MAX_OPS, st["log"].device)
        comm = pos[None, None, :] < st["commit"][:, :, None]     # [B, R, P]
        diff = st["log"][:, :, None, :] != st["log"][:, None, :, :]
        both = comm[:, :, None, :] & comm[:, None, :, :]
        return ~(both & diff).flatten(1).any(dim=1)

    def inv_acknowledged_write_not_lost(self, st):
        acked = st["aux_acked"] == 2
        has = self._replica_has_op(st).any(dim=1)
        return (~acked | has).all(dim=1)

    def inv_acknowledged_writes_exist_on_majority(self, st):
        acked = st["aux_acked"] == 2
        n_has = self._replica_has_op(st).sum(dim=1)
        return (~acked | (n_has >= self.R // 2 + 1)).all(dim=1)

    def inv_commit_never_higher_than_op(self, st):
        return (st["commit"] <= st["op"]).all(dim=1)

    def inv_test(self, st):
        return torch.ones_like(st["err"], dtype=torch.bool)

    def pred_all_replicas_same_view(self, st):
        # AllReplicasMoveToSameView (ST03:884-898) with the
        # BlockedOnLastViewChange shield (ST03:877-881)
        r_ids = _iota(self.R, st["view"].device) + 1
        prim_of = self._primary(st["view"], self.R)              # [B, R]
        prim_count = (prim_of[:, None, :] == r_ids[None, :, None]).sum(dim=2)
        blocked = ((st["aux_svc"] == self.shape.timer_limit)
                   & ((st["no_prog"] == 1)
                      & (prim_count > self.R // 2)).any(dim=1))
        prog = st["no_prog"] == 0
        vmax = torch.where(prog, st["view"], -1).amax(dim=1, keepdim=True)
        ok = ((~prog | (st["view"] == vmax)).all(dim=1)
              & (~prog | (st["status"] == NORMAL)).all(dim=1))
        return blocked | ok

    def hunt_score(self, st):
        """[B] int32 defect-proximity score for guided simulation (the
        JAX kernel's: 0 while nothing is acked, else 1 + the replicas
        missing the worst acked value)."""
        acked = st["aux_acked"] == 2
        missing = (~self._replica_has_op(st)).sum(dim=1)         # [B, V]
        worst = torch.where(acked, missing, -1).amax(dim=1)
        return torch.where(acked.any(dim=1), 1 + worst, 0).to(I32)

    INVARIANT_FNS = {
        "NoLogDivergence": "inv_no_log_divergence",
        "AcknowledgedWriteNotLost": "inv_acknowledged_write_not_lost",
        "AcknowledgedWritesExistOnMajority":
            "inv_acknowledged_writes_exist_on_majority",
        "CommitNumberNeverHigherThanOpNumber":
            "inv_commit_never_higher_than_op",
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
