"""Batched transition kernel for VR_ASSUME_NEWVIEWCHANGE (A01), and the
A01 forms of kernels K3, K13 and K14.

The PyTorch counterpart of ``tpuvsr/models/a01_kernel.py``, in the batch
style of ``models/st03_kernel.py`` (``st`` a dict of ``[B, ...plane]``
int32 tensors; an action takes a lane per batch item and returns
(successor dict, enabled [B]); a guard takes the batch and returns
``[B, L_a]``).  It subclasses the port's ST03 kernel, dropping the three
state-transfer actions (A01's 13-action Next, A01:661-677) and applying
the assume-mode differences:

* ``TimerSendSVC`` is blocked for the current primary whatever its
  status (``~IsPrimary(r)``, A01:411; ST03:521 exempts only a Normal
  primary);
* ``ReceiveSV`` accepts any ``m.view_number >= View(r)`` with no status
  conjunct (A01:621-624);
* log entries are packed ``value_id << 8 | view`` ints (models/a01.py):
  ``ReceiveClientRequest`` writes the packed entry, ``ExecuteOp`` reads
  the value id back from it, and the invariants find an op on a replica
  by its value id (``_replica_has_op``).

K13 and K14 are ``csrc/st03_guards.cu`` and ``csrc/st03_actions.cu``
instantiated for A01 (``a01_guards``, ``a01_actions``); K3 is
``csrc/vsr_fingerprint.cu`` on A01's rows (``a01_fp_*``).  The plain
versions count in ``st03_kernel.PLAIN_CALLS``.
"""

from __future__ import annotations

import torch

from .a01 import ENTRY_VIEW_BITS
from .st03 import M_PREPARE, M_SV, NORMAL
from .st03_kernel import (ALL_KEYS, FAMILY_GUARD_PLANES, FAMILY_PLANES,
                          GUARD_PLANES, ST03Kernel)
from .vsr import H_VIEW
from .vsr_kernel import _clip, _iota, _put, _put2, _take, _take2

ACTION_NAMES = (
    "TimerSendSVC", "ReceiveHigherSVC", "ReceiveMatchingSVC", "SendDVC",
    "ReceiveHigherDVC", "ReceiveMatchingDVC", "SendSV", "ReceiveSV",
    "ReceiveClientRequest", "ReceivePrepareMsg", "ReceivePrepareOkMsg",
    "ExecuteOp", "NoProgressChange",
)


class A01Kernel(ST03Kernel):
    action_names = ACTION_NAMES
    FP_KERNELS = {"full": "a01_fp_full", "parts": "a01_fp_parts",
                  "incremental": "a01_fp_incremental"}
    GUARDS_KERNEL = ("a01_guards", "tpuvsr_a01_guards")
    ACTIONS_KERNEL = ("a01_actions", "tpuvsr_a01_actions")
    STATE_PRED_KERNEL = ("a01_state_pred", "tpuvsr_a01_state_pred")
    PLANE_KEYS = ALL_KEYS + FAMILY_PLANES
    GUARD_KEYS = GUARD_PLANES + FAMILY_GUARD_PLANES
    # packed entries: the value-id field relabelled, the view kept, codes
    # <= 0 fixed (tpuvsr/models/a01_kernel.py:42 _perm_vals)
    CANON_MODE = ("packed", ENTRY_VIEW_BITS)
    CANON_KERNEL = "a01_canon"

    def _is_primary(self, st, i, r):
        return self._primary(_take(st["view"], i), self.R) == r

    def _rep_primary(self, st):
        """[B, R]: replica r is the primary of its own view."""
        r = _iota(self.R, st["view"].device) + 1
        return self._primary(st["view"], self.R) == r[None, :]

    # -- guard deltas ---------------------------------------------------
    def act_timer_send_svc(self, st, lane):       # A01:406-424
        s2, _en = super().act_timer_send_svc(st, lane)
        i = lane
        en = ((st["aux_svc"] < self.shape.timer_limit)
              & self._can_progress(st, i) & ~self._is_primary(st, i, i + 1))
        return s2, en

    def guard_timer_send_svc(self, st):
        return ((st["aux_svc"] < self.shape.timer_limit)[:, None]
                & (st["no_prog"] == 0) & ~self._rep_primary(st))

    def act_receive_sv(self, st, lane):           # A01:617-644
        s2, _en = super().act_receive_sv(st, lane)
        hdr, _r, i = self._msg_lane(st, lane)
        en = (self._recv_en(st, lane, hdr, M_SV) & self._can_progress(st, i)
              & (hdr[:, H_VIEW] >= _take(st["view"], i)))
        return s2, en

    def guard_receive_sv(self, st):
        hdr, _i, m, view_i = self._guard_recv(st, M_SV)
        return m & (hdr[:, :, H_VIEW] >= view_i)

    # -- packed-entry deltas --------------------------------------------
    def act_receive_client_request(self, st, lane):  # A01:278-303
        i = torch.div(lane, self.V, rounding_mode="floor")
        r = i + 1
        vid = torch.remainder(lane, self.V) + 1
        B, dev = lane.shape[0], lane.device
        en = (self._can_progress(st, i) & self._is_primary(st, i, r)
              & (_take(st["status"], i) == NORMAL)
              & (_take(st["aux_acked"], vid - 1) == 0))
        opn = _take(st["op"], i) + 1
        view = _take(st["view"], i)
        entry = (vid << ENTRY_VIEW_BITS) | view
        s2 = dict(st)
        s2["log"] = _put2(st["log"], i, _clip(opn - 1, 0, self.MAX_OPS - 1),
                          entry)
        s2["op"] = _put(st["op"], i, opn)
        s2["aux_acked"] = _put(st["aux_acked"], vid - 1, 1)
        row = self._row(B, dev, M_PREPARE, view=view, op=opn,
                        commit=_take(st["commit"], i), src=r, entry=entry)
        s2 = self._broadcast(s2, row, r)
        return s2, en

    def act_execute_op(self, st, lane):           # A01:374-391
        i = lane
        r = i + 1
        opn = _take(st["commit"], i) + 1
        committed = ((_take(st["peer_op"], i) >= opn[:, None]).sum(dim=1)
                     >= self.R // 2)
        en = (self._can_progress(st, i) & self._is_primary(st, i, r)
              & (_take(st["status"], i) == NORMAL)
              & (_take(st["commit"], i) < _take(st["op"], i)) & committed)
        code = _take2(st["log"], i, _clip(opn - 1, 0, self.MAX_OPS - 1))
        vid = code >> ENTRY_VIEW_BITS
        s2 = dict(st)
        s2["commit"] = _put(st["commit"], i, opn)
        s2["aux_acked"] = _put(st["aux_acked"],
                               _clip(vid - 1, 0, self.V - 1), 2)
        return s2, en

    def _replica_has_op(self, st):
        """[B, R, V]: replica r's log holds an entry of value v."""
        v_ids = _iota(self.V, st["log"].device) + 1
        vids = st["log"] >> ENTRY_VIEW_BITS
        return (vids[:, :, :, None] == v_ids).any(dim=2)

    # -- action table (state transfer dropped) --------------------------
    def _guard_list(self):
        return [
            self.guard_timer_send_svc, self.guard_receive_higher_svc,
            self.guard_receive_matching_svc, self.guard_send_dvc,
            self.guard_receive_higher_dvc, self.guard_receive_matching_dvc,
            self.guard_send_sv, self.guard_receive_sv,
            self.guard_receive_client_request, self.guard_receive_prepare,
            self.guard_receive_prepare_ok, self.guard_execute_op,
            self.guard_no_progress_change,
        ]

    def _action_list(self):
        return [
            self.act_timer_send_svc, self.act_receive_higher_svc,
            self.act_receive_matching_svc, self.act_send_dvc,
            self.act_receive_higher_dvc, self.act_receive_matching_dvc,
            self.act_send_sv, self.act_receive_sv,
            self.act_receive_client_request, self.act_receive_prepare,
            self.act_receive_prepare_ok, self.act_execute_op,
            self.act_no_progress_change,
        ]
    # lane_replica is inherited: ST03's mapping covers every A01 action
