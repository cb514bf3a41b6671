"""Batched transition kernel for VR_REPLICA_RECOVERY_ASYNC_LOG (AL05), and
the AL05 forms of kernels K3, K13 and K14.

The PyTorch counterpart of ``tpuvsr/models/al05_kernel.py``, in the
batch style of ``models/st03_kernel.py``.  It subclasses the port's RR05
kernel with the async-log-persistence deltas (AL05's 20-action Next,
AL05:992-1017 — RR05 minus RetryRecovery):

* log entries are plain value ids again (AL05:106-108): ST03's
  ``ReceiveClientRequest`` and has-op scan, AS04's ``PrimaryExecuteOp``;
* ``Crash`` keeps a nondeterministic surviving log prefix: one lane
  per (replica, last_op in 0..MAX_OPS); the RecoveryMsg carries the
  floor ``op = min(old commit, last_op)`` (AL05:851-885);
* ``ReceiveRecoveryMsg`` answers in two record shapes (AL05:888-915):
  a backup's Nil log_suffix (no op/commit/ceil fields) or the
  primary's prefix_ceil + suffix-above-the-floor;
* ``ReceiveRecoveryResponseMsg`` also records the prefix ceiling;
* ``CompleteRecovery`` splices the recovering replica's OWN surviving
  prefix (up to prefix_ceil) under the primary's suffix
  (AL05:947-977).

K13 and K14 are ``csrc/st03_guards.cu`` and ``csrc/st03_actions.cu``
instantiated for AL05 (``al05_guards``, ``al05_actions``); K3 is
``csrc/vsr_fingerprint.cu`` on AL05's rows (``al05_fp_*``).
"""

from __future__ import annotations

import torch

from .al05 import AL05Codec
from .as04_kernel import AS04Kernel
from .rr05_kernel import RR05Kernel
from .st03_kernel import ST03Kernel
from .vsr import H_FIRST, H_OP, H_SRC
from .vsr_kernel import _clip, _iota, _put2, _take, _take2

ACTION_NAMES = (
    "TimerSendSVC", "ReceiveHigherSVC", "ReceiveMatchingSVC", "SendDVC",
    "ReceiveHigherDVC", "ReceiveMatchingDVC", "SendSV", "ReceiveSV",
    "ReceiveClientRequest", "ReceivePrepareMsg", "ReceivePrepareOkMsg",
    "PrimaryExecuteOp", "SendGetState", "ReceiveGetState",
    "ReceiveNewState", "Crash", "ReceiveRecoveryMsg",
    "ReceiveRecoveryResponseMsg", "CompleteRecovery", "NoProgressChange",
)

REP_KEYS = RR05Kernel.REP_KEYS + ("rec_ceil",)


class AL05Kernel(RR05Kernel):
    action_names = ACTION_NAMES
    REP_KEYS = REP_KEYS
    FP_KERNELS = {"full": "al05_fp_full", "parts": "al05_fp_parts",
                  "incremental": "al05_fp_incremental"}
    GUARDS_KERNEL = ("al05_guards", "tpuvsr_al05_guards")
    ACTIONS_KERNEL = ("al05_actions", "tpuvsr_al05_actions")
    REC_PLANES = RR05Kernel.REC_PLANES + ("rec_ceil",)

    def __init__(self, codec: AL05Codec, perms=None, pack_spec=None):
        super().__init__(codec, perms=perms, pack_spec=pack_spec)

    def _rep_shape(self, k):
        if k == "rec_ceil":
            return (self.shape.R, self.shape.R)
        return super()._rep_shape(k)

    # plain value-id entries again: undo RR05's packed-entry borrowings
    # (the relabelling too, tpuvsr/models/al05_kernel.py:55)
    CANON_MODE = ST03Kernel.CANON_MODE
    CANON_KERNEL = "al05_canon"
    _replica_has_op = ST03Kernel._replica_has_op
    act_receive_client_request = ST03Kernel.act_receive_client_request
    act_execute_op = AS04Kernel.act_execute_op

    def _lane_count(self, name):
        if name == "Crash":
            return self.R * (self.MAX_OPS + 1)
        return super()._lane_count(name)

    def _crash_lane(self, lane):
        """(replica, last_op) of a Crash lane."""
        n = self.MAX_OPS + 1
        return torch.div(lane, n, rounding_mode="floor"), \
            torch.remainder(lane, n)

    # ------------------------------------------------------------------
    # async-log recovery actions
    # ------------------------------------------------------------------
    def act_crash(self, st, lane):                # AL05:851-885
        i, last_op = self._crash_lane(lane)
        en = ((st["aux_restart"] < self.crash_limit)
              & self._can_progress(st, i)
              & (last_op <= _take(st["op"], i)))
        return self._crash(st, i, en, last_op=last_op)

    def guard_crash(self, st):
        lanes = _iota(self.R * (self.MAX_OPS + 1), st["op"].device)
        i, last_op = self._crash_lane(lanes)
        return ((st["aux_restart"] < self.crash_limit)[:, None]
                & (st["no_prog"][:, i] == 0)
                & (last_op[None, :] <= st["op"][:, i]))

    def _recovery_response(self, st, i, prim, hdr):
        # the primary's suffix above the RecoveryMsg's floor, re-based
        # at 0, with first = the floor (AL05:888-915)
        floor = hdr[:, H_OP]
        pos = _iota(self.MAX_OPS, floor.device)[None, :]
        n_suffix = torch.clamp(_take(st["op"], i) - floor, min=0)
        src_pos = _clip(pos + floor[:, None], 0, self.MAX_OPS - 1)
        suffix = torch.where(pos < n_suffix[:, None],
                             _take(st["log"], i).gather(1, src_pos.long()),
                             0)
        return (torch.where(prim, floor, 0),
                torch.where(prim[:, None], suffix, 0))

    def act_receive_recovery_response(self, st, lane):  # AL05:918-932
        s2, en = super().act_receive_recovery_response(st, lane)
        hdr, _r, i = self._msg_lane(st, lane)
        j = _clip(hdr[:, H_SRC] - 1, 0, self.R - 1)
        s2["rec_ceil"] = _put2(s2["rec_ceil"], i, j, torch.where(
            hdr[:, H_OP] >= 0, hdr[:, H_FIRST], 0))
        return s2, en

    def _installed_log(self, st, i, j):
        # the replica's own prefix below min(ceil, m_op), the response's
        # suffix (stored re-based at the ceiling) up to m_op
        ceil = _take2(st["rec_ceil"], i, j)[:, None]
        m_op = _take2(st["rec_op"], i, j)[:, None]
        pos = _iota(self.MAX_OPS, ceil.device)[None, :]
        suffix = _take2(st["rec_log"], i, j).gather(
            1, _clip(pos - ceil, 0, self.MAX_OPS - 1).long())
        return torch.where(pos < torch.minimum(ceil, m_op),
                           _take(st["log"], i),
                           torch.where(pos < m_op, suffix, 0))

    # ------------------------------------------------------------------
    # action table (no RetryRecovery)
    # ------------------------------------------------------------------
    def _guard_list(self):
        fns = super()._guard_list()
        del fns[19]                   # RetryRecovery's slot
        return fns

    def _action_list(self):
        fns = super()._action_list()
        del fns[19]
        return fns

    def lane_replica(self, name, st, lane):
        if name == "Crash":
            return self._crash_lane(lane)[0]
        return super().lane_replica(name, st, lane)
