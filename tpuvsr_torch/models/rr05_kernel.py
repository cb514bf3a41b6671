"""Batched transition kernel for VR_REPLICA_RECOVERY (RR05), and the RR05
forms of kernels K3, K13 and K14.

The PyTorch counterpart of ``tpuvsr/models/rr05_kernel.py``, in the
batch style of ``models/st03_kernel.py``.  It subclasses the port's AS04
kernel with the crash-recovery sub-protocol (RR05's 21-action Next,
RR05:999-1025):

* ``Crash`` (RR05:837-861): total wipe to ``Recovering`` (view 0,
  empty log and app, cleared trackers), nonce = ``UniqueNumber`` = max
  RecoveryMsg x in the bag + 1 (RR05:826-835, a deterministic CHOOSE),
  RecoveryMsg broadcast;
* ``ReceiveRecoveryMsg`` (RR05:871-889): only Normal replicas respond;
  the response carries log/op/commit exactly when the responder is the
  primary (Nil sentinel -1 otherwise);
* ``ReceiveRecoveryResponseMsg`` (RR05:896-909): VSR-style response
  slots with implied x = rep_rec_number[dest]; a second, different
  response from one source sets ``ERR_REC_OVERFLOW``;
* ``CompleteRecovery`` (RR05:920-942): install the has-log response in
  the highest view of ALL received responses (unique: one primary per
  view), execute its committed prefix into the app state;
* ``RetryRecovery`` (RR05:951-983): when no such response exists and
  none can arrive, clear and re-nonce;
* the four carried-over actions that must exclude Recovering replicas
  (TimerSendSVC RR05:582, ReceiveHigherSVC RR05:606, ReceiveHigherDVC
  RR05:688, ReceiveSV RR05:798), guard and action;
* log entries packed ``value_id << 8 | view`` as A01's
  (``ReceiveClientRequest`` writes one, ``PrimaryExecuteOp`` reads the
  value id back, and the invariants find an op by its value id).

``aux_restart`` is an aux plane, outside the VIEW projection: K3 does
not hash it, yet ``Crash``'s guard reads it (TLC's VIEW semantics, which
the reference keeps).  K13 and K14 are ``csrc/st03_guards.cu`` and
``csrc/st03_actions.cu`` instantiated for RR05 (``rr05_guards``,
``rr05_actions``); K3 is ``csrc/vsr_fingerprint.cu`` on RR05's rows
(``rr05_fp_*``), whose replica row carries the response slots.
"""

from __future__ import annotations

import torch

from .a01 import ENTRY_VIEW_BITS
from .a01_kernel import A01Kernel
from .as04_kernel import AS04Kernel
from .rr05 import M_RECOVERY, M_RECOVERYRESP, RECOVERING, RR05Codec
from .st03 import NORMAL
from .st03_kernel import I32
from .vsr import ERR_REC_OVERFLOW, H_COMMIT, H_DEST, H_OP, H_SRC, H_TYPE, \
    H_VIEW, H_X
from .vsr_kernel import _clip, _first_true, _iota, _put, _put2, _take, \
    _take2

ACTION_NAMES = (
    "TimerSendSVC", "ReceiveHigherSVC", "ReceiveMatchingSVC", "SendDVC",
    "ReceiveHigherDVC", "ReceiveMatchingDVC", "SendSV", "ReceiveSV",
    "ReceiveClientRequest", "ReceivePrepareMsg", "ReceivePrepareOkMsg",
    "PrimaryExecuteOp", "SendGetState", "ReceiveGetState",
    "ReceiveNewState", "Crash", "ReceiveRecoveryMsg",
    "ReceiveRecoveryResponseMsg", "CompleteRecovery", "RetryRecovery",
    "NoProgressChange",
)

REP_KEYS = AS04Kernel.REP_KEYS + (
    "rec_number", "rec", "rec_view", "rec_has_log", "rec_log", "rec_op",
    "rec_commit")
REC_PLANES = ("rec", "rec_view", "rec_has_log", "rec_log", "rec_op",
              "rec_commit")
PER_REPLICA = ("Crash", "CompleteRecovery", "RetryRecovery")


class RR05Kernel(AS04Kernel):
    action_names = ACTION_NAMES
    REP_KEYS = REP_KEYS
    FP_KERNELS = {"full": "rr05_fp_full", "parts": "rr05_fp_parts",
                  "incremental": "rr05_fp_incremental"}
    GUARDS_KERNEL = ("rr05_guards", "tpuvsr_rr05_guards")
    ACTIONS_KERNEL = ("rr05_actions", "tpuvsr_rr05_actions")
    REC_PLANES = REC_PLANES
    # tpuvsr/models/rr05_kernel.py:57, 83: A01's packed relabelling over
    # every plane named here, the app state included
    PERM_REP_KEYS = ("log", "app", "dvc_log", "rec_log")
    CANON_MODE = A01Kernel.CANON_MODE
    CANON_KERNEL = "rr05_canon"

    def __init__(self, codec: RR05Codec, perms=None, pack_spec=None):
        self.crash_limit = codec.constants.get("CrashLimit", 0)
        super().__init__(codec, perms=perms, pack_spec=pack_spec)

    def _rep_shape(self, k):
        s = self.shape
        extra = {
            "rec_number": (s.R,), "rec": (s.R, s.R),
            "rec_view": (s.R, s.R), "rec_has_log": (s.R, s.R),
            "rec_log": (s.R, s.R, s.MAX_OPS), "rec_op": (s.R, s.R),
            "rec_commit": (s.R, s.R),
        }
        if k in extra:
            return extra[k]
        return super()._rep_shape(k)

    def _lane_count(self, name):
        if name in PER_REPLICA:
            return self.R
        return super()._lane_count(name)

    # RR05 log entries are packed (vid << 8 | view) like A01's: A01's
    # entry-creating action and has-op scan
    _is_primary = A01Kernel._is_primary
    _replica_has_op = A01Kernel._replica_has_op
    act_receive_client_request = A01Kernel.act_receive_client_request

    def act_execute_op(self, st, lane):           # PrimaryExecuteOp,
        i = lane                                  # RR05:426-443
        r = i + 1
        opn = _take(st["commit"], i) + 1
        committed = ((_take(st["peer_op"], i) >= opn[:, None]).sum(dim=1)
                     >= self.R // 2)
        en = (self._can_progress(st, i) & self._is_normal_primary(st, i, r)
              & (_take(st["commit"], i) < _take(st["op"], i)) & committed)
        code = _take2(st["log"], i, _clip(opn - 1, 0, self.MAX_OPS - 1))
        vid = code >> ENTRY_VIEW_BITS
        s2 = self._exec_ops(dict(st), i, _take(st["log"], i), opn)
        s2["aux_acked"] = _put(s2["aux_acked"],
                               _clip(vid - 1, 0, self.V - 1), 2)
        return s2, en

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------
    def _unique_number(self, st):
        """UniqueNumber (RR05:826-835): max RecoveryMsg x in the bag plus
        one (1 when none), [B]."""
        h = st["m_hdr"]
        xs = torch.where((st["m_present"] == 1)
                         & (h[:, :, H_TYPE] == M_RECOVERY), h[:, :, H_X], 0)
        return xs.amax(dim=1) + 1

    def _clear_rec(self, s2, i):
        s2 = dict(s2)
        for key in self.REC_PLANES:
            s2[key] = _put(s2[key], i, 0)
        return s2

    def _best_rec(self, rec, view, has_log):
        """The has-log responses in the highest view of ALL responses
        (RR05:924-931) over the last axis of the slot planes: (cand, the
        first candidate's index, 0 when none)."""
        pres = rec == 1
        vmax = torch.where(pres, view, -1).amax(dim=-1, keepdim=True)
        cand = pres & (has_log == 1) & (view == vmax)
        return cand, _first_true(cand)

    def _rec_quorum(self, rec):
        return (rec == 1).sum(dim=-1) > self.R // 2

    # ------------------------------------------------------------------
    # not-Recovering guard deltas on carried-over actions
    # ------------------------------------------------------------------
    def _not_recovering(self, st, i):
        return _take(st["status"], i) != RECOVERING

    def _dest_not_recovering(self, st):
        """[B, M]: the receiver of each slot is not Recovering."""
        _h, i, _recv = self._msg_cols(st)
        return self._g(st["status"], i) != RECOVERING

    def act_timer_send_svc(self, st, lane):       # RR05:578-600
        s2, en = super().act_timer_send_svc(st, lane)
        return s2, en & self._not_recovering(st, lane)

    def guard_timer_send_svc(self, st):
        return super().guard_timer_send_svc(st) & (st["status"] != RECOVERING)

    def act_receive_higher_svc(self, st, lane):   # RR05:602-625
        s2, en = super().act_receive_higher_svc(st, lane)
        return s2, en & self._not_recovering(st, self._msg_lane(st, lane)[2])

    def guard_receive_higher_svc(self, st):
        return (super().guard_receive_higher_svc(st)
                & self._dest_not_recovering(st))

    def act_receive_higher_dvc(self, st, lane):   # RR05:684-707
        s2, en = super().act_receive_higher_dvc(st, lane)
        return s2, en & self._not_recovering(st, self._msg_lane(st, lane)[2])

    def guard_receive_higher_dvc(self, st):
        return (super().guard_receive_higher_dvc(st)
                & self._dest_not_recovering(st))

    def act_receive_sv(self, st, lane):           # RR05:794-822
        s2, en = super().act_receive_sv(st, lane)
        return s2, en & self._not_recovering(st, self._msg_lane(st, lane)[2])

    def guard_receive_sv(self, st):
        return super().guard_receive_sv(st) & self._dest_not_recovering(st)

    # ------------------------------------------------------------------
    # recovery actions
    # ------------------------------------------------------------------
    def _crash(self, st, i, en, last_op=None):
        """Crash's body (RR05:837-861; AL05:851-885 with ``last_op``, the
        surviving log prefix)."""
        r = i + 1
        B, dev = i.shape[0], i.device
        u = self._unique_number(st)
        s2 = dict(st)
        s2["status"] = _put(st["status"], i, RECOVERING)
        if last_op is None:
            s2["log"] = _put(st["log"], i, 0)
        else:
            pos = _iota(self.MAX_OPS, dev)[None, :]
            s2["log"] = _put(st["log"], i, torch.where(
                pos < last_op[:, None], _take(st["log"], i), 0))
        s2["app"] = _put(st["app"], i, 0)
        s2["view"] = _put(st["view"], i, 0)
        s2["op"] = _put(st["op"], i, 0 if last_op is None else last_op)
        s2["commit"] = _put(st["commit"], i, 0)
        s2["peer_op"] = _put(st["peer_op"], i, 0)
        s2["lnv"] = _put(st["lnv"], i, 0)
        s2 = self._reset_sent(s2, i)
        s2 = self._clear_dvc(s2, i)
        s2 = self._clear_rec(s2, i)
        s2["rec_number"] = _put(s2["rec_number"], i, u)
        s2["aux_restart"] = st["aux_restart"] + 1
        floor = (0 if last_op is None else
                 torch.minimum(_take(st["commit"], i), last_op))
        s2 = self._broadcast(s2, self._row(B, dev, M_RECOVERY, src=r, x=u,
                                           op=floor), r)
        return s2, en

    def act_crash(self, st, lane):                # RR05:837-861
        en = ((st["aux_restart"] < self.crash_limit)
              & self._can_progress(st, lane))
        return self._crash(st, lane, en)

    def guard_crash(self, st):
        return ((st["aux_restart"] < self.crash_limit)[:, None]
                & (st["no_prog"] == 0))

    def _recovery_response(self, st, i, prim, hdr):
        """The response's (first, log) for ReceiveRecoveryMsg: RR05's
        primary attaches its whole log."""
        return 0, torch.where(prim[:, None], _take(st["log"], i), 0)

    def act_receive_recovery(self, st, lane):     # RR05:871-889
        k = lane
        B, dev = lane.shape[0], lane.device
        hdr, r, i = self._msg_lane(st, k)
        en = (self._recv_en(st, k, hdr, M_RECOVERY)
              & self._can_progress(st, i)
              & (_take(st["status"], i) == NORMAL))
        prim = self._is_normal_primary(st, i, r)
        first, log = self._recovery_response(st, i, prim, hdr)
        s2 = self._bag_discard(dict(st), k)
        row = self._row(
            B, dev, M_RECOVERYRESP, view=_take(st["view"], i), x=hdr[:, H_X],
            op=torch.where(prim, _take(st["op"], i), -1),
            commit=torch.where(prim, _take(st["commit"], i), -1),
            dest=hdr[:, H_SRC], src=r, first=first, log=log)
        s2 = self._bag_send(s2, row)
        return s2, en

    def guard_receive_recovery(self, st):
        _hdr, i, m, _view_i = self._guard_recv(st, M_RECOVERY)
        return m & (self._g(st["status"], i) == NORMAL)

    def act_receive_recovery_response(self, st, lane):  # RR05:896-909
        k = lane
        hdr, _r, i = self._msg_lane(st, k)
        j = _clip(hdr[:, H_SRC] - 1, 0, self.R - 1)
        en = (self._recv_en(st, k, hdr, M_RECOVERYRESP)
              & self._can_progress(st, i)
              & (_take(st["rec_number"], i) == hdr[:, H_X])
              & (_take(st["status"], i) == RECOVERING))
        s2 = dict(st)
        # set-union into the per-source slot; a different record from
        # the same source cannot occur (one response per (x, source))
        collide = (en & (_take2(s2["rec"], i, j) == 1)
                   & ((_take2(s2["rec_view"], i, j) != hdr[:, H_VIEW])
                      | (_take2(s2["rec_op"], i, j) != hdr[:, H_OP])))
        s2["rec"] = _put2(s2["rec"], i, j, 1)
        s2["rec_view"] = _put2(s2["rec_view"], i, j, hdr[:, H_VIEW])
        s2["rec_has_log"] = _put2(s2["rec_has_log"], i, j,
                                  (hdr[:, H_OP] >= 0).to(I32))
        s2["rec_log"] = _put2(s2["rec_log"], i, j, _take(st["m_log"], k))
        s2["rec_op"] = _put2(s2["rec_op"], i, j, hdr[:, H_OP])
        s2["rec_commit"] = _put2(s2["rec_commit"], i, j, hdr[:, H_COMMIT])
        s2["err"] = s2["err"] | torch.where(collide, ERR_REC_OVERFLOW, 0
                                            ).to(I32)
        s2 = self._bag_discard(s2, k)
        return s2, en

    def guard_receive_recovery_response(self, st):
        hdr, i, m, _view_i = self._guard_recv(st, M_RECOVERYRESP)
        return (m & (self._g(st["rec_number"], i) == hdr[:, :, H_X])
                & (self._g(st["status"], i) == RECOVERING))

    def _complete_en(self, st, i):
        cand, j = self._best_rec(_take(st["rec"], i),
                                 _take(st["rec_view"], i),
                                 _take(st["rec_has_log"], i))
        en = (self._can_progress(st, i)
              & (_take(st["status"], i) == RECOVERING)
              & self._rec_quorum(_take(st["rec"], i)) & cand.any(dim=1))
        return en, j

    def _installed_log(self, st, i, j):
        """The log CompleteRecovery installs: the response's (RR05)."""
        return _take2(st["rec_log"], i, j)

    def act_complete_recovery(self, st, lane):    # RR05:920-942
        i = lane
        en, j = self._complete_en(st, i)
        rv = _take2(st["rec_view"], i, j)
        new_log = self._installed_log(st, i, j)
        s2 = dict(st)
        s2["status"] = _put(st["status"], i, NORMAL)
        s2["view"] = _put(st["view"], i, rv)
        s2["lnv"] = _put(st["lnv"], i, rv)
        s2["log"] = _put(st["log"], i, new_log)
        s2["op"] = _put(st["op"], i, _take2(st["rec_op"], i, j))
        s2 = self._exec_ops(s2, i, new_log, _take2(st["rec_commit"], i, j))
        s2 = self._clear_rec(s2, i)
        return s2, en

    def guard_complete_recovery(self, st):
        cand, _j = self._best_rec(st["rec"], st["rec_view"],
                                  st["rec_has_log"])
        return ((st["no_prog"] == 0) & (st["status"] == RECOVERING)
                & self._rec_quorum(st["rec"]) & cand.any(dim=2))

    def _pending(self, st):
        """[B, R]: a present, undelivered message with replica r's nonce
        that can still bring a response: a RecoveryMsg whose receiver can
        progress, or any response (RR05:962-969)."""
        h = st["m_hdr"]
        dest_i = _clip(h[:, :, H_DEST] - 1, 0, self.R - 1)
        dest_can = self._g(st["no_prog"], dest_i) == 0
        live = ((st["m_present"] == 1) & (st["m_count"] > 0)
                & (((h[:, :, H_TYPE] == M_RECOVERY) & dest_can)
                   | (h[:, :, H_TYPE] == M_RECOVERYRESP)))     # [B, M]
        return (live[:, None, :]
                & (h[:, None, :, H_X] == st["rec_number"][:, :, None])
                ).any(dim=2)

    def act_retry_recovery(self, st, lane):       # RR05:951-983
        i = lane
        B, dev = lane.shape[0], lane.device
        cand, _j = self._best_rec(_take(st["rec"], i),
                                  _take(st["rec_view"], i),
                                  _take(st["rec_has_log"], i))
        pending = _take(self._pending(st), i)
        en = (self._can_progress(st, i)
              & (_take(st["status"], i) == RECOVERING)
              & self._rec_quorum(_take(st["rec"], i))
              & ~cand.any(dim=1) & ~pending)
        u = self._unique_number(st)
        s2 = self._clear_rec(dict(st), i)
        s2["rec_number"] = _put(s2["rec_number"], i, u)
        s2 = self._broadcast(s2, self._row(B, dev, M_RECOVERY, src=i + 1,
                                           x=u), i + 1)
        return s2, en

    def guard_retry_recovery(self, st):
        cand, _j = self._best_rec(st["rec"], st["rec_view"],
                                  st["rec_has_log"])
        return ((st["no_prog"] == 0) & (st["status"] == RECOVERING)
                & self._rec_quorum(st["rec"]) & ~cand.any(dim=2)
                & ~self._pending(st))

    # ------------------------------------------------------------------
    # action table
    # ------------------------------------------------------------------
    def _guard_list(self):
        return super()._guard_list()[:15] + [
            self.guard_crash, self.guard_receive_recovery,
            self.guard_receive_recovery_response,
            self.guard_complete_recovery, self.guard_retry_recovery,
            self.guard_no_progress_change,
        ]

    def _action_list(self):
        return super()._action_list()[:15] + [
            self.act_crash, self.act_receive_recovery,
            self.act_receive_recovery_response,
            self.act_complete_recovery, self.act_retry_recovery,
            self.act_no_progress_change,
        ]

    def lane_replica(self, name, st, lane):
        if name in PER_REPLICA:
            return lane
        return super().lane_replica(name, st, lane)

