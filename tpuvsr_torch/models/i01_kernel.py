"""Batched transition kernel for VR_INC_RESEND (I01), and the I01 forms
of kernels K3, K13 and K14.

The PyTorch counterpart of ``tpuvsr/models/i01_kernel.py``, in the batch
style of ``models/st03_kernel.py``.  It subclasses the port's A01 kernel
with the increment-mode deltas (I01's 14-action Next, I01:731-751):

* every view adoption is ``View(r)+1``: ReceiveHigherSVC (I01:455) and
  ReceiveHigherDVC (I01:572) increment instead of adopting the
  carrier's view;
* ``rep_sent_svc`` and ``NotInPhaseSVC`` (I01:416-419) gate
  TimerSendSVC, and ``ResendSVC`` (I01:505-517) sends an SVC to a peer
  again when none is in flight and none ever came back: one lane per
  (replica, peer) pair;
* the DVC tracker (UpdateDVCsTracker, I01:245-250): a slot per source
  with its own view (mixed views are expected: ReceivedDVCsAllSameView
  is the invariant meant to be violated, I01:797-804), with replacement
  semantics, so slots never collide;
* SendSV adopts ``HighestViewNumber`` of the valid (view >= own)
  tracker entries (I01:614-620, 649-675) and installs it as both
  view_number and last_normal_view;
* ReceivePrepareMsg has no primary exemption (I01:311-323);
* the invariants NoReplicaMoreThanOneViewAheadOfMajority (I01:789-795)
  and ReceivedDVCsAllSameView.

K13 and K14 are ``csrc/st03_guards.cu`` and ``csrc/st03_actions.cu``
instantiated for I01 (``i01_guards``, ``i01_actions``); K3 is
``csrc/vsr_fingerprint.cu`` on I01's rows (``i01_fp_*``), whose replica
row carries the tracker.
"""

from __future__ import annotations

import torch

from .a01_kernel import A01Kernel
from .st03 import M_DVC, M_PREPARE, M_SV, M_SVC, NORMAL, VIEWCHANGE
from .st03_kernel import INF, I32
from .vsr import H_COMMIT, H_DEST, H_LNV, H_OP, H_SRC, H_TYPE, H_VIEW
from .vsr_kernel import (_clip, _first_true, _iota, _put, _put2, _take,
                         _take2, _where)

ACTION_NAMES = (
    "TimerSendSVC", "ReceiveHigherSVC", "ReceiveMatchingSVC", "ResendSVC",
    "SendDVC", "ReceiveHigherDVC", "ReceiveMatchingDVC", "SendSV",
    "ReceiveSV", "ReceiveClientRequest", "ReceivePrepareMsg",
    "ReceivePrepareOkMsg", "ExecuteOp", "NoProgressChange",
)

REP_KEYS = ("status", "view", "op", "commit", "lnv", "log", "peer_op",
            "sent_svc", "sent_dvc", "sent_sv", "dvc", "dvc_view",
            "dvc_lnv", "dvc_op", "dvc_commit", "dvc_log")
TRACKER_KEYS = ("dvc", "dvc_view", "dvc_lnv", "dvc_op", "dvc_commit",
                "dvc_log")


class I01Kernel(A01Kernel):
    action_names = ACTION_NAMES
    REP_KEYS = REP_KEYS
    FP_KERNELS = {"full": "i01_fp_full", "parts": "i01_fp_parts",
                  "incremental": "i01_fp_incremental"}
    GUARDS_KERNEL = ("i01_guards", "tpuvsr_i01_guards")
    ACTIONS_KERNEL = ("i01_actions", "tpuvsr_i01_actions")
    STATE_PRED_KERNEL = ("i01_state_pred", "tpuvsr_i01_state_pred")
    # A01's packed relabelling over the DVC slots' logs too
    # (tpuvsr/models/i01_kernel.py:53)
    PERM_REP_KEYS = ("log", "dvc_log")
    CANON_KERNEL = "i01_canon"

    def _rep_shape(self, k):
        s = self.shape
        extra = {
            "sent_svc": (s.R,), "dvc": (s.R, s.R),
            "dvc_view": (s.R, s.R), "dvc_lnv": (s.R, s.R),
            "dvc_op": (s.R, s.R), "dvc_commit": (s.R, s.R),
            "dvc_log": (s.R, s.R, s.MAX_OPS),
        }
        if k in extra:
            return extra[k]
        return super()._rep_shape(k)

    def _lane_count(self, name):
        if name == "ResendSVC":
            return self.R * self.R
        return super()._lane_count(name)

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------
    def _reset_sent3(self, s2, i, svc, dvc, sv):
        s2 = dict(s2)
        s2["sent_svc"] = _put(s2["sent_svc"], i, svc)
        s2["sent_dvc"] = _put(s2["sent_dvc"], i, dvc)
        s2["sent_sv"] = _put(s2["sent_sv"], i, sv)
        return s2

    def _reset_sent(self, st, i):
        # ResetSentVars (I01:232-236): all three flags to FALSE
        st["sent_svc"] = _put(st["sent_svc"], i, 0)
        return super()._reset_sent(st, i)

    def _update_tracker(self, s2, i, vn, src_j, view, lnv, op, commit,
                        log, pred):
        """UpdateDVCsTracker (I01:245-250): drop the entries below ``vn``
        and any entry from ``src_j``, then write the carrier into its
        slot (dropped slots to zeros); ``pred`` gates both parts."""
        s2 = dict(s2)
        slots = _iota(self.R, i.device)[None, :]
        had = _take(s2["dvc"], i) == 1                          # [B, R]
        keep = (had & (_take(s2["dvc_view"], i) >= vn[:, None])
                & (slots != src_j[:, None]))
        keep = torch.where(pred[:, None], keep, had)
        for key in TRACKER_KEYS[1:]:
            row = _take(s2[key], i)
            k = keep.reshape(keep.shape + (1,) * (row.dim() - 2))
            s2[key] = _put(s2[key], i, torch.where(k, row, 0))
        s2["dvc"] = _put(s2["dvc"], i, keep.to(I32))
        for key, val in zip(TRACKER_KEYS, (1, view, lnv, op, commit, log)):
            s2[key] = _where(pred, _put2(s2[key], i, src_j, val), s2[key])
        return s2

    def _clear_tracker(self, s2, i):
        s2 = dict(s2)
        for key in TRACKER_KEYS:
            s2[key] = _put(s2[key], i, 0)
        return s2

    def _not_in_phase_svc(self, st, i):
        # NotInPhaseSVC (I01:416-419)
        return (_take(st["sent_svc"], i) == 0) | (_take(st["sent_dvc"], i)
                                                 == 1)

    # ------------------------------------------------------------------
    # view-change actions (increment mode)
    # ------------------------------------------------------------------
    def act_timer_send_svc(self, st, lane):       # I01:421-438
        i = lane
        r = i + 1
        B, dev = lane.shape[0], lane.device
        en = ((st["aux_svc"] < self.shape.timer_limit)
              & self._can_progress(st, i) & ~self._is_primary(st, i, r)
              & self._not_in_phase_svc(st, i))
        new_view = _take(st["view"], i) + 1
        s2 = dict(st)
        s2["view"] = _put(st["view"], i, new_view)
        s2["status"] = _put(st["status"], i, VIEWCHANGE)
        s2 = self._reset_sent3(s2, i, 1, 0, 0)
        s2["aux_svc"] = st["aux_svc"] + 1
        s2 = self._broadcast(s2, self._row(B, dev, M_SVC, view=new_view,
                                           src=r), r)
        return s2, en

    def guard_timer_send_svc(self, st):
        return (super().guard_timer_send_svc(st)
                & ((st["sent_svc"] == 0) | (st["sent_dvc"] == 1)))

    def act_receive_higher_svc(self, st, lane):   # I01:440-463
        k = lane
        B, dev = lane.shape[0], lane.device
        hdr, r, i = self._msg_lane(st, k)
        view_i = _take(st["view"], i)
        en = (self._recv_en(st, k, hdr, M_SVC) & self._can_progress(st, i)
              & (hdr[:, H_VIEW] > view_i))
        new_view = view_i + 1                  # increment, not adopt
        s2 = dict(st)
        s2["view"] = _put(st["view"], i, new_view)
        s2["status"] = _put(st["status"], i, VIEWCHANGE)
        s2 = self._reset_sent3(s2, i, 1, 0, 0)
        s2 = self._bag_discard(s2, k)
        s2 = self._broadcast(s2, self._row(B, dev, M_SVC, view=new_view,
                                           src=r), r)
        return s2, en

    def guard_resend_svc(self, st):               # RequiresResend,
        R = self.R                                # I01:490-503
        h = st["m_hdr"]
        dev = h.device
        svc = ((st["m_present"] == 1)
               & (h[:, :, H_TYPE] == M_SVC))[:, None, None, :]
        ii = _iota(R, dev)[None, :, None, None] + 1       # the replica
        pp = _iota(R, dev)[None, None, :, None] + 1       # the peer
        dest = h[:, None, None, :, H_DEST]
        src = h[:, None, None, :, H_SRC]
        same_view = h[:, None, None, :, H_VIEW] == st["view"][:, :, None,
                                                              None]
        undelivered = (svc & (dest == pp) & (src == ii) & same_view
                       & (st["m_count"] == 1)[:, None, None, :]).any(-1)
        ever_back = (svc & (dest == ii) & (src == pp) & same_view).any(-1)
        rep = ((st["no_prog"] == 0) & (st["sent_svc"] == 1))[:, :, None]
        en = (rep & (ii != pp)[..., 0] & ~undelivered & ~ever_back)
        return en.reshape(h.shape[0], R * R)

    def act_resend_svc(self, st, lane):           # I01:505-517
        i = torch.div(lane, self.R, rounding_mode="floor")
        p = torch.remainder(lane, self.R)
        B, dev = lane.shape[0], lane.device
        en = self.guard_resend_svc(st).gather(1, lane[:, None].long())[:, 0]
        s2 = self._bag_send(dict(st), self._row(
            B, dev, M_SVC, view=_take(st["view"], i), dest=p + 1, src=i + 1))
        return s2, en

    def act_send_dvc(self, st, lane):             # I01:528-556
        s2, en = super().act_send_dvc(st, lane)
        i = lane
        view = _take(st["view"], i)
        self_case = self._primary(view, self.R) == i + 1
        s2 = self._update_tracker(
            s2, i, view, i, view, _take(st["lnv"], i), _take(st["op"], i),
            _take(st["commit"], i), _take(st["log"], i), pred=self_case & en)
        return s2, en

    def act_receive_higher_dvc(self, st, lane):   # I01:558-581
        k = lane
        B, dev = lane.shape[0], lane.device
        hdr, r, i = self._msg_lane(st, k)
        j = _clip(hdr[:, H_SRC] - 1, 0, self.R - 1)
        view_i = _take(st["view"], i)
        en = (self._recv_en(st, k, hdr, M_DVC) & self._can_progress(st, i)
              & (hdr[:, H_VIEW] > view_i))
        new_view = view_i + 1                  # increment, not adopt
        s2 = dict(st)
        s2["view"] = _put(st["view"], i, new_view)
        s2["status"] = _put(st["status"], i, VIEWCHANGE)
        s2 = self._reset_sent3(s2, i, 1, 0, 0)
        s2 = self._update_tracker(s2, i, new_view, j, hdr[:, H_VIEW],
                                  hdr[:, H_LNV], hdr[:, H_OP],
                                  hdr[:, H_COMMIT], _take(st["m_log"], k),
                                  pred=en)
        s2 = self._bag_discard(s2, k)
        s2 = self._broadcast(s2, self._row(B, dev, M_SVC, view=new_view,
                                           src=r), r)
        return s2, en

    def act_receive_matching_dvc(self, st, lane):  # I01:583-597
        k = lane
        hdr, _r, i = self._msg_lane(st, k)
        j = _clip(hdr[:, H_SRC] - 1, 0, self.R - 1)
        view_i = _take(st["view"], i)
        # no status conjunct (I01:588-591): a Normal replica registers a
        # matching DVC too
        en = (self._recv_en(st, k, hdr, M_DVC) & self._can_progress(st, i)
              & (hdr[:, H_VIEW] == view_i))
        s2 = self._update_tracker(dict(st), i, view_i, j, hdr[:, H_VIEW],
                                  hdr[:, H_LNV], hdr[:, H_OP],
                                  hdr[:, H_COMMIT], _take(st["m_log"], k),
                                  pred=en)
        s2 = self._bag_discard(s2, k)
        return s2, en

    def guard_receive_matching_dvc(self, st):
        hdr, _i, m, view_i = self._guard_recv(st, M_DVC)
        return m & (hdr[:, :, H_VIEW] == view_i)

    def _valid_tracker(self, st, i):
        """[B, R] the valid (view >= own) tracker entries of replica i."""
        return ((_take(st["dvc"], i) == 1)
                & (_take(st["dvc_view"], i) >= _take(st["view"], i)[:, None]))

    def _highest_tracker(self, st, i):
        """HighestViewNumber/-Log/-CommitNumber over the valid tracker
        entries (I01:610-645): the maximal (lnv, op) entry, CHOOSE ties
        by lex (commit, log, source); view and commit maximized
        alone."""
        valid = self._valid_tracker(st, i)
        new_vn = torch.where(valid, _take(st["dvc_view"], i), -1).amax(1)
        pair = (_take(st["dvc_lnv"], i) * (self.MAX_OPS + 1)
                + _take(st["dvc_op"], i))
        best_pair = torch.where(valid, pair, -1).amax(dim=1)
        cand = valid & (pair == best_pair[:, None])
        src_ids = (_iota(self.R, i.device) + 1).to(I32)
        keys = torch.cat([_take(st["dvc_commit"], i)[:, :, None],
                          _take(st["dvc_log"], i),
                          src_ids[None, :, None].expand(cand.shape[0], -1,
                                                        1)], dim=2)
        for c in range(keys.shape[2]):
            col = torch.where(cand, keys[:, :, c], INF)
            cand = cand & (col == col.amin(dim=1, keepdim=True))
        best_j = _first_true(cand)
        return (new_vn, _take2(st["dvc_log"], i, best_j),
                _take2(st["dvc_op"], i, best_j),
                torch.where(valid, _take(st["dvc_commit"], i), -1).amax(1))

    def act_send_sv(self, st, lane):              # I01:647-675
        i = lane
        r = i + 1
        B, dev = lane.shape[0], lane.device
        en = (self._can_progress(st, i)
              & (_take(st["status"], i) == VIEWCHANGE)
              & (_take(st["sent_sv"], i) == 0)
              & (self._valid_tracker(st, i).sum(dim=1) >= self.R // 2 + 1))
        new_vn, new_log, new_on, new_cn = self._highest_tracker(st, i)
        s2 = dict(st)
        s2["status"] = _put(st["status"], i, NORMAL)
        s2["view"] = _put(st["view"], i, new_vn)
        s2["log"] = _put(st["log"], i, new_log)
        s2["op"] = _put(st["op"], i, new_on)
        s2["peer_op"] = _put(st["peer_op"], i, 0)
        s2["commit"] = _put(st["commit"], i, new_cn)
        s2["sent_sv"] = _put(st["sent_sv"], i, 1)
        s2["lnv"] = _put(st["lnv"], i, new_vn)
        s2 = self._clear_tracker(s2, i)
        row = self._row(B, dev, M_SV, view=new_vn, op=new_on, commit=new_cn,
                        src=r, log=new_log)
        return self._broadcast(s2, row, r), en

    def guard_send_sv(self, st):
        valid = ((st["dvc"] == 1)
                 & (st["dvc_view"] >= st["view"][:, :, None]))
        return ((st["no_prog"] == 0) & (st["status"] == VIEWCHANGE)
                & (st["sent_sv"] == 0)
                & (valid.sum(dim=2) >= self.R // 2 + 1))

    def act_receive_sv(self, st, lane):           # I01:686-710
        s2, en = super().act_receive_sv(st, lane)
        i = _clip(_take(st["m_hdr"], lane)[:, H_DEST] - 1, 0, self.R - 1)
        return self._clear_tracker(s2, i), en

    def act_receive_prepare(self, st, lane):      # I01:311-334
        s2, _en = super().act_receive_prepare(st, lane)
        hdr, _r, i = self._msg_lane(st, lane)
        # no primary exemption in I01 (the primary never receives its
        # own broadcast, so the spec drops the conjunct)
        en = (self._recv_en(st, lane, hdr, M_PREPARE)
              & self._can_progress(st, i)
              & (_take(st["status"], i) == NORMAL)
              & (hdr[:, H_VIEW] == _take(st["view"], i))
              & (hdr[:, H_OP] == _take(st["op"], i) + 1))
        return s2, en

    def guard_receive_prepare(self, st):
        hdr, i, m, view_i = self._guard_recv(st, M_PREPARE)
        return (m & (self._g(st["status"], i) == NORMAL)
                & (hdr[:, :, H_VIEW] == view_i)
                & (hdr[:, :, H_OP] == self._g(st["op"], i) + 1))

    # ------------------------------------------------------------------
    # action table
    # ------------------------------------------------------------------
    def _guard_list(self):
        return [
            self.guard_timer_send_svc, self.guard_receive_higher_svc,
            self.guard_receive_matching_svc, self.guard_resend_svc,
            self.guard_send_dvc, self.guard_receive_higher_dvc,
            self.guard_receive_matching_dvc, self.guard_send_sv,
            self.guard_receive_sv, self.guard_receive_client_request,
            self.guard_receive_prepare, self.guard_receive_prepare_ok,
            self.guard_execute_op, self.guard_no_progress_change,
        ]

    def _action_list(self):
        return [
            self.act_timer_send_svc, self.act_receive_higher_svc,
            self.act_receive_matching_svc, self.act_resend_svc,
            self.act_send_dvc, self.act_receive_higher_dvc,
            self.act_receive_matching_dvc, self.act_send_sv,
            self.act_receive_sv, self.act_receive_client_request,
            self.act_receive_prepare, self.act_receive_prepare_ok,
            self.act_execute_op, self.act_no_progress_change,
        ]

    def lane_replica(self, name, st, lane):
        if name == "ResendSVC":
            # the sender (its replica row is unchanged; a slot row is)
            return torch.div(lane, self.R, rounding_mode="floor")
        return super().lane_replica(name, st, lane)

    # ------------------------------------------------------------------
    # invariants
    # ------------------------------------------------------------------
    def inv_no_replica_more_than_one_view_ahead(self, st):
        # I01:789-795: no replica with a majority of the others more
        # than one view behind it
        v = st["view"]
        behind = v[:, None, :] < v[:, :, None] - 1              # [B, r, r1]
        r_ids = _iota(self.R, v.device)
        behind = behind & (r_ids[None, :] != r_ids[:, None])
        return ~(behind.sum(dim=2) > self.R // 2).any(dim=1)

    def inv_received_dvcs_all_same_view(self, st):
        # I01:797-804 (meant to be violated)
        pres = st["dvc"] == 1                                   # [B, R, R]
        views = st["dvc_view"]
        both = pres[:, :, :, None] & pres[:, :, None, :]
        diff = views[:, :, :, None] != views[:, :, None, :]
        mixed = (both & diff).flatten(2).any(dim=2)
        return ~((st["status"] == VIEWCHANGE) & mixed).any(dim=1)

    INVARIANT_FNS = dict(
        A01Kernel.INVARIANT_FNS,
        NoReplicaMoreThanOneViewAheadOfMajority=
        "inv_no_replica_more_than_one_view_ahead",
        ReceivedDVCsAllSameView="inv_received_dvcs_all_same_view")
