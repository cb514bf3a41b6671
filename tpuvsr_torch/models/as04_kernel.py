"""Batched transition kernel for VR_APP_STATE (AS04), and the AS04 forms
of kernels K3, K13 and K14.

The PyTorch counterpart of ``tpuvsr/models/as04_kernel.py``, in the
batch style of ``models/st03_kernel.py``.  It subclasses the port's ST03
kernel (the same bag primitives, AnyDest lanes and NoProgressChange
SUBSET lanes) with the AS04 deltas (AS04:811-831 Next):

* the ``AppendOps``/``MaybeExecuteOps`` executor (AS04:270-282) as a
  masked positional write: every commit-advancing action
  (ReceivePrepareMsg AS04:373, PrimaryExecuteOp AS04:431,
  ReceiveNewState AS04:533, SendSV AS04:740, ReceiveSV AS04:777)
  appends ``log[old+1..new]`` to the ``app`` plane and raises commit,
  and commit is never lowered (ST03 installs it wholesale);
* DVC quorums from the per-replica ``rep_recv_dvc`` set (AS04:83) as
  dense [dest, source] slots, cleared on every view adoption
  (ResetVcVars AS04:560/582/666/782) and seeded with the carrier by
  ReceiveHigherDVC (AS04:667); a second, different DVC from one source
  sets ``ERR_DVC_OVERFLOW`` in ``err``, on which the engines stop;
* ``ReceiveMatchingSVC`` gains the ``rep_sent_dvc = FALSE`` conjunct
  (AS04:601);
* ``ExecuteOp`` becomes ``PrimaryExecuteOp``;
* the invariant ``NoAppStateDivergence`` (AS04:852-865).

K13 and K14 are ``csrc/st03_guards.cu`` and ``csrc/st03_actions.cu``
instantiated for AS04 (``as04_guards``, ``as04_actions``); K3 is
``csrc/vsr_fingerprint.cu`` on AS04's rows (``as04_fp_*``), whose
replica row carries the app plane and the DVC slots.
"""

from __future__ import annotations

import torch

from .as04 import ERR_DVC_OVERFLOW
from .st03 import (M_DVC, M_NEWSTATE, M_PREPARE, M_PREPAREOK, M_SV, M_SVC,
                   NORMAL, STATETRANSFER, VIEWCHANGE)
from .st03_kernel import (ALL_KEYS, FAMILY_GUARD_PLANES, FAMILY_PLANES,
                          GUARD_PLANES, INF, I32, ST03Kernel)
from .vsr import H_COMMIT, H_DEST, H_FIRST, H_LNV, H_OP, H_SRC, H_VIEW
from .vsr_kernel import (_clip, _first_true, _iota, _put, _put2, _take,
                         _take2, _where)

ACTION_NAMES = (
    "TimerSendSVC", "ReceiveHigherSVC", "ReceiveMatchingSVC", "SendDVC",
    "ReceiveHigherDVC", "ReceiveMatchingDVC", "SendSV", "ReceiveSV",
    "ReceiveClientRequest", "ReceivePrepareMsg", "ReceivePrepareOkMsg",
    "PrimaryExecuteOp", "SendGetState", "ReceiveGetState",
    "ReceiveNewState", "NoProgressChange",
)

REP_KEYS = ("status", "view", "op", "commit", "lnv", "log", "app",
            "peer_op", "sent_dvc", "sent_sv", "dvc", "dvc_lnv", "dvc_op",
            "dvc_commit", "dvc_log")
SLOT_PLANES = ("dvc", "dvc_lnv", "dvc_op", "dvc_commit", "dvc_log")


class AS04Kernel(ST03Kernel):
    action_names = ACTION_NAMES
    REP_KEYS = REP_KEYS
    FP_KERNELS = {"full": "as04_fp_full", "parts": "as04_fp_parts",
                  "incremental": "as04_fp_incremental"}
    GUARDS_KERNEL = ("as04_guards", "tpuvsr_as04_guards")
    ACTIONS_KERNEL = ("as04_actions", "tpuvsr_as04_actions")
    # ST03's plain relabelling over the app state and the DVC slots' logs
    # too (tpuvsr/models/as04_kernel.py:51)
    PERM_REP_KEYS = ("log", "app", "dvc_log")
    CANON_KERNEL = "as04_canon"
    PLANE_KEYS = ALL_KEYS + FAMILY_PLANES
    GUARD_KEYS = GUARD_PLANES + FAMILY_GUARD_PLANES
    ERR_DVC_OVERFLOW = ERR_DVC_OVERFLOW

    def _rep_shape(self, k):
        s = self.shape
        extra = {
            "app": (s.R, s.MAX_OPS), "dvc": (s.R, s.R),
            "dvc_lnv": (s.R, s.R), "dvc_op": (s.R, s.R),
            "dvc_commit": (s.R, s.R),
            "dvc_log": (s.R, s.R, s.MAX_OPS),
        }
        if k in extra:
            return extra[k]
        return super()._rep_shape(k)

    def _lane_count(self, name):
        if name == "PrimaryExecuteOp":
            return self.R
        return super()._lane_count(name)

    # ------------------------------------------------------------------
    # AS04 helpers
    # ------------------------------------------------------------------
    def _exec_ops(self, s2, i, log_plane, new_commit):
        """MaybeExecuteOps (AS04:277-282): when new_commit exceeds the
        commit, append log[old+1..new] to the app plane and raise commit;
        else leave both (commit is never lowered)."""
        old = _take(s2["commit"], i)
        adv = new_commit > old
        pos = _iota(self.MAX_OPS, i.device)[None, :]
        write = (adv[:, None] & (pos >= old[:, None])
                 & (pos < new_commit[:, None]))
        s2 = dict(s2)
        s2["app"] = _put(s2["app"], i, torch.where(
            write, log_plane, _take(s2["app"], i)))
        s2["commit"] = _put(s2["commit"], i, torch.where(adv, new_commit,
                                                         old))
        return s2

    def _clear_dvc(self, s2, i):
        """ResetVcVars' rep_recv_dvc wipe (AS04:287-291)."""
        s2 = dict(s2)
        for key in SLOT_PLANES:
            s2[key] = _put(s2[key], i, 0)
        return s2

    def _dvc_slot_add(self, s2, i, j, lnv, op, commit, log, pred):
        """Set-union a DVC into slot [i, j]: an identical record is a
        no-op, a different one from the same source sets the error
        flag (the dense layout holds one per source)."""
        s2 = dict(s2)
        at = lambda key: _take2(s2[key], i, j)
        same = ((at("dvc") == 1) & (at("dvc_lnv") == lnv)
                & (at("dvc_op") == op) & (at("dvc_commit") == commit)
                & (at("dvc_log") == log).all(dim=1))
        collide = pred & (at("dvc") == 1) & ~same
        for key, val in zip(SLOT_PLANES, (1, lnv, op, commit, log)):
            s2[key] = _where(pred, _put2(s2[key], i, j, val), s2[key])
        s2["err"] = s2["err"] | torch.where(collide, ERR_DVC_OVERFLOW, 0
                                            ).to(I32)
        return s2

    # ------------------------------------------------------------------
    # overridden actions
    # ------------------------------------------------------------------
    def act_receive_higher_svc(self, st, lane):   # AS04:575-587
        s2, en = super().act_receive_higher_svc(st, lane)
        i = _clip(_take(st["m_hdr"], lane)[:, H_DEST] - 1, 0, self.R - 1)
        return self._clear_dvc(s2, i), en

    def act_timer_send_svc(self, st, lane):       # AS04:551-566
        s2, en = super().act_timer_send_svc(st, lane)
        return self._clear_dvc(s2, lane), en

    def act_receive_matching_svc(self, st, lane):  # AS04:589-607
        s2, en = super().act_receive_matching_svc(st, lane)
        i = _clip(_take(st["m_hdr"], lane)[:, H_DEST] - 1, 0, self.R - 1)
        return s2, en & (_take(st["sent_dvc"], i) == 0)

    def act_send_dvc(self, st, lane):             # AS04:609-651
        # ST03's body; the new primary also registers its own DVC in its
        # recv_dvc set (AS04:644-647)
        s2, en = super().act_send_dvc(st, lane)
        i = lane
        self_case = self._primary(_take(st["view"], i), self.R) == i + 1
        s2 = self._dvc_slot_add(s2, i, i, _take(st["lnv"], i),
                                _take(st["op"], i), _take(st["commit"], i),
                                _take(st["log"], i), pred=self_case & en)
        return s2, en

    def act_receive_higher_dvc(self, st, lane):   # AS04:653-672
        k = lane
        B, dev = lane.shape[0], lane.device
        hdr, r, i = self._msg_lane(st, k)
        j = _clip(hdr[:, H_SRC] - 1, 0, self.R - 1)
        en = (self._recv_en(st, k, hdr, M_DVC) & self._can_progress(st, i)
              & (hdr[:, H_VIEW] > _take(st["view"], i)))
        s2 = dict(st)
        s2["view"] = _put(st["view"], i, hdr[:, H_VIEW])
        s2["status"] = _put(st["status"], i, VIEWCHANGE)
        s2 = self._reset_sent(s2, i)
        s2 = self._clear_dvc(s2, i)
        # ResetVcVars seeds the set with the carrier DVC (AS04:667)
        s2 = self._dvc_slot_add(s2, i, j, hdr[:, H_LNV], hdr[:, H_OP],
                                hdr[:, H_COMMIT], _take(st["m_log"], k),
                                pred=torch.ones_like(en))
        s2 = self._bag_discard(s2, k)
        s2 = self._broadcast(s2, self._row(B, dev, M_SVC,
                                           view=hdr[:, H_VIEW], src=r), r)
        return s2, en

    def act_receive_matching_dvc(self, st, lane):  # AS04:674-690
        # ST03's body (the discard), then the recv_dvc slot
        s2, en = super().act_receive_matching_dvc(st, lane)
        hdr, _r, i = self._msg_lane(st, lane)
        j = _clip(hdr[:, H_SRC] - 1, 0, self.R - 1)
        s2 = self._dvc_slot_add(s2, i, j, hdr[:, H_LNV], hdr[:, H_OP],
                                hdr[:, H_COMMIT], _take(st["m_log"], lane),
                                pred=en)
        return s2, en

    def _highest_dvc_slot(self, st, i):
        """HighestLog/-OpNumber/-CommitNumber over the recv_dvc slots
        (AS04:697-727): the maximal (lnv, op) slot, CHOOSE ties by lex
        (commit, log, source); commit maximized alone."""
        mask = _take(st["dvc"], i) == 1
        pair = (_take(st["dvc_lnv"], i) * (self.MAX_OPS + 1)
                + _take(st["dvc_op"], i))
        best_pair = torch.where(mask, pair, -1).amax(dim=1)
        cand = mask & (pair == best_pair[:, None])
        src_ids = (_iota(self.R, i.device) + 1).to(I32)
        keys = torch.cat([_take(st["dvc_commit"], i)[:, :, None],
                          _take(st["dvc_log"], i),
                          src_ids[None, :, None].expand(cand.shape[0], -1,
                                                        1)], dim=2)
        for c in range(keys.shape[2]):
            col = torch.where(cand, keys[:, :, c], INF)
            cand = cand & (col == col.amin(dim=1, keepdim=True))
        best_j = _first_true(cand)
        return (_take2(st["dvc_log"], i, best_j),
                _take2(st["dvc_op"], i, best_j),
                torch.where(mask, _take(st["dvc_commit"], i), -1).amax(1))

    def act_send_sv(self, st, lane):              # AS04:729-757
        i = lane
        r = i + 1
        B, dev = lane.shape[0], lane.device
        view = _take(st["view"], i)
        en = (self._can_progress(st, i)
              & (_take(st["status"], i) == VIEWCHANGE)
              & (_take(st["sent_sv"], i) == 0)
              & ((_take(st["dvc"], i) == 1).sum(dim=1) >= self.R // 2 + 1))
        new_log, new_on, new_cn = self._highest_dvc_slot(st, i)
        s2 = dict(st)
        s2["status"] = _put(st["status"], i, NORMAL)
        s2["log"] = _put(st["log"], i, new_log)
        s2 = self._exec_ops(s2, i, new_log, new_cn)
        s2["op"] = _put(s2["op"], i, new_on)
        s2["peer_op"] = _put(s2["peer_op"], i, 0)
        s2["sent_sv"] = _put(s2["sent_sv"], i, 1)
        s2["lnv"] = _put(s2["lnv"], i, view)
        s2 = self._clear_dvc(s2, i)               # AS04:745
        # the SV carries HighestCommitNumber (AS04:736, 750), which can
        # be below the sender's own commit
        row = self._row(B, dev, M_SV, view=view, op=new_on, commit=new_cn,
                        src=r, log=new_log)
        return self._broadcast(s2, row, r), en

    def act_receive_sv(self, st, lane):           # AS04:759-788
        k = lane
        B, dev = lane.shape[0], lane.device
        hdr, r, i = self._msg_lane(st, k)
        hv, view_i = hdr[:, H_VIEW], _take(st["view"], i)
        en = (self._recv_en(st, k, hdr, M_SV) & self._can_progress(st, i)
              & (((hv == view_i) & (_take(st["status"], i) == VIEWCHANGE))
                 | (hv > view_i)))
        old_commit = _take(st["commit"], i)
        m_log = _take(st["m_log"], k)
        s2 = dict(st)
        s2["status"] = _put(st["status"], i, NORMAL)
        s2["view"] = _put(st["view"], i, hv)
        s2["log"] = _put(st["log"], i, m_log)
        s2 = self._exec_ops(s2, i, m_log, hdr[:, H_COMMIT])
        s2["op"] = _put(s2["op"], i, hdr[:, H_OP])
        s2["lnv"] = _put(s2["lnv"], i, hv)
        s2 = self._reset_sent(s2, i)
        s2 = self._clear_dvc(s2, i)
        s2 = self._bag_discard(s2, k)
        ok_row = self._row(B, dev, M_PREPAREOK, view=hv, op=hdr[:, H_OP],
                           dest=self._primary(hv, self.R), src=r)
        return self._bag_send(s2, ok_row, pred=old_commit < hdr[:, H_OP]), en

    def act_receive_prepare(self, st, lane):      # AS04:361-383
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
        s2 = self._exec_ops(s2, i, _take(s2["log"], i), hdr[:, H_COMMIT])
        s2 = self._bag_discard(s2, k)
        ok_row = self._row(B, dev, M_PREPAREOK, view=view_i, op=hdr[:, H_OP],
                           dest=hdr[:, H_SRC], src=r)
        return self._bag_send(s2, ok_row), en

    def act_execute_op(self, st, lane):           # PrimaryExecuteOp,
        i = lane                                  # AS04:420-437
        r = i + 1
        opn = _take(st["commit"], i) + 1
        committed = ((_take(st["peer_op"], i) >= opn[:, None]).sum(dim=1)
                     >= self.R // 2)
        en = (self._can_progress(st, i) & self._is_normal_primary(st, i, r)
              & (_take(st["commit"], i) < _take(st["op"], i)) & committed)
        vid = _take2(st["log"], i, _clip(opn - 1, 0, self.MAX_OPS - 1))
        s2 = self._exec_ops(dict(st), i, _take(st["log"], i), opn)
        s2["aux_acked"] = _put(s2["aux_acked"],
                               _clip(vid - 1, 0, self.V - 1), 2)
        return s2, en

    def act_receive_new_state(self, st, lane):    # AS04:515-539
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
        s2 = self._exec_ops(s2, i, new_log, hdr[:, H_COMMIT])
        s2["op"] = _put(s2["op"], i, hdr[:, H_OP])
        return self._bag_discard(s2, k), en

    # overridden guards --------------------------------------------------
    def guard_receive_matching_svc(self, st):
        hdr, i, m, view_i = self._guard_recv(st, M_SVC)
        return (super().guard_receive_matching_svc(st)
                & (self._g(st["sent_dvc"], i) == 0))

    def guard_send_sv(self, st):
        return ((st["no_prog"] == 0) & (st["status"] == VIEWCHANGE)
                & (st["sent_sv"] == 0)
                & ((st["dvc"] == 1).sum(dim=2) >= self.R // 2 + 1))

    def lane_replica(self, name, st, lane):
        if name == "PrimaryExecuteOp":
            return lane
        return super().lane_replica(name, st, lane)

    # invariants ---------------------------------------------------------
    def inv_no_app_state_divergence(self, st):
        # AS04:852-865: no pair both committed at an op with differing
        # app entries while r1's log agrees with r1's app there
        pos = _iota(self.MAX_OPS, st["app"].device)
        comm = pos[None, None, :] < st["commit"][:, :, None]     # [B, R, P]
        app = st["app"]
        app_diff = app[:, :, None, :] != app[:, None, :, :]
        log_eq_app = (st["log"] == app)[:, :, None, :]
        viol = (comm[:, :, None, :] & comm[:, None, :, :] & app_diff
                & log_eq_app)
        return ~viol.flatten(1).any(dim=1)

    INVARIANT_FNS = dict(
        ST03Kernel.INVARIANT_FNS,
        NoAppStateDivergence="inv_no_app_state_divergence")
