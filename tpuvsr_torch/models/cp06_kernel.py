"""Batched transition kernel for VR_REPLICA_RECOVERY_CP (CP06), and the
CP06 forms of kernels K3, K13 and K14.

The PyTorch counterpart of ``tpuvsr/models/cp06_kernel.py``, in the
batch style of ``models/st03_kernel.py``.  It subclasses the port's RR05
kernel with the checkpointing deltas (CP06's 22-action Next,
CP06:1186-1213, which has no RetryRecovery):

* NoOp log entries (id V+1) mark the garbage-collected prefix;
  ``HighestGCedOp`` (CP06:346-354) is the largest NoOp position;
* a reply or DoViewChange picks ``last_cp \\in HighestGCedOp+1..commit``
  (Crash: ``0..commit``), an extra lane dimension of C = MAX_OPS + 1:
  SendDVC and Crash take R x C lanes (lane i * C + cp), ReceiveGetState
  and ReceiveGetCheckpointMsg M x R x C (lane k * R * C + i * C + cp),
  ReceiveRecoveryMsg M x C (lane k * C + cp), ReceiveNewCheckpointMsg M;
* the two reply forms (flag 0: first_op and a log suffix; flag 1: a
  checkpoint and the suffix above it, CP06:404-431), ``ApplyCheckpoint``
  (CP06:383-402) as a masked positional write over the log and app
  planes;
* DoViewChange and StartView carry (checkpoint, cp_number, log_suffix)
  (CP06:785-823, 898-927); WinningDVC breaks ties by the least (checkpoint,
  commit, cp_number, log_suffix keyed by its domain, source);
* recovery through GetCheckpoint -> NewCheckpoint -> Recovery
  (CP06:985-1135) and the two-form CompleteRecovery (CP06:1138-1170);
* the invariants read a NoOp slot through the app state (``OpOf``,
  CP06:1219-1246), and CommitNumberMatchesAppState (CP06:1279-1281).

Message records carry a third payload plane, ``m_cp`` (``ROW_PLANES``),
which a record's equality compares and K3's slot row hashes after
``m_log``.  K13 and K14 are ``csrc/st03_guards.cu`` and
``csrc/st03_actions.cu`` instantiated for CP06 (``cp06_guards``,
``cp06_actions``); K3 is ``csrc/vsr_fingerprint.cu`` on CP06's rows
(``cp06_fp_*``).
"""

from __future__ import annotations

import torch

from .as04_kernel import AS04Kernel
from .cp06 import M_GETCP, M_NEWCP, M_RECOVERY, M_RECOVERYRESP, CP06Codec
from .rr05 import RECOVERING
from .rr05_kernel import RR05Kernel
from .st03 import (ANYDEST, M_DVC, M_GETSTATE, M_NEWSTATE, M_PREPAREOK,
                   M_SV, M_SVC, NORMAL, STATETRANSFER, VIEWCHANGE)
from .st03_kernel import INF, I32, ST03Kernel
from .vsr import (ERR_REC_OVERFLOW, H_COMMIT, H_CP, H_DEST, H_FIRST, H_FLAG,
                  H_LNV, H_OP, H_SRC, H_TYPE, H_VIEW, H_X)
from .vsr_kernel import (_clip, _first_true, _iota, _put, _put2, _take,
                         _take2, _where)

ACTION_NAMES = (
    "TimerSendSVC", "ReceiveHigherSVC", "ReceiveMatchingSVC", "SendDVC",
    "ReceiveHigherDVC", "ReceiveMatchingDVC", "SendSV", "ReceiveSV",
    "ReceiveClientRequest", "ReceivePrepareMsg", "ReceivePrepareOkMsg",
    "PrimaryExecuteOp", "SendGetState", "ReceiveGetState",
    "ReceiveNewState", "Crash", "ReceiveGetCheckpointMsg",
    "ReceiveNewCheckpointMsg", "ReceiveRecoveryMsg",
    "ReceiveRecoveryResponseMsg", "CompleteRecovery", "NoProgressChange",
)

REP_KEYS = RR05Kernel.REP_KEYS + (
    "dvc_cpn", "dvc_cp", "rec_flag", "rec_first", "rec_cp", "rec_cpn")


def _div(x, n):
    return torch.div(x, n, rounding_mode="floor")


class CP06Kernel(RR05Kernel):
    action_names = ACTION_NAMES
    REP_KEYS = REP_KEYS
    SLOT_KEYS = ("m_hdr", "m_entry", "m_log", "m_cp", "m_count")
    ROW_PLANES = (("entry", "m_entry"), ("log", "m_log"), ("cp", "m_cp"))
    FP_KERNELS = {"full": "cp06_fp_full", "parts": "cp06_fp_parts",
                  "incremental": "cp06_fp_incremental"}
    GUARDS_KERNEL = ("cp06_guards", "tpuvsr_cp06_guards")
    ACTIONS_KERNEL = ("cp06_actions", "tpuvsr_cp06_actions")
    STATE_PRED_KERNEL = ("cp06_state_pred", "tpuvsr_cp06_state_pred")
    REC_PLANES = RR05Kernel.REC_PLANES + ("rec_flag", "rec_first",
                                          "rec_cp", "rec_cpn")
    # tpuvsr/models/cp06_kernel.py:56-58: the checkpoints relabel too
    PERM_REP_KEYS = ("log", "app", "dvc_log", "dvc_cp", "rec_log",
                     "rec_cp")
    PERM_MSG_KEYS = ("m_entry", "m_log", "m_cp")
    # plain value ids with the NoOp id (V + 1) fixed
    # (tpuvsr/models/cp06_kernel.py:66 _perm_vals)
    CANON_MODE = ("noop", 0)
    CANON_KERNEL = "cp06_canon"

    def __init__(self, codec: CP06Codec, perms=None, pack_spec=None):
        self.NOOP = codec.noop_id
        super().__init__(codec, perms=perms, pack_spec=pack_spec)

    # plain value ids (and NoOp): ST03's entry-creating action, AS04's
    # PrimaryExecuteOp
    act_receive_client_request = ST03Kernel.act_receive_client_request
    act_execute_op = AS04Kernel.act_execute_op

    def _rep_shape(self, k):
        s = self.shape
        extra = {
            "dvc_cpn": (s.R, s.R), "dvc_cp": (s.R, s.R, s.MAX_OPS),
            "rec_flag": (s.R, s.R), "rec_first": (s.R, s.R),
            "rec_cp": (s.R, s.R, s.MAX_OPS), "rec_cpn": (s.R, s.R),
        }
        if k in extra:
            return extra[k]
        return super()._rep_shape(k)

    def _nmsg(self):
        return super()._nmsg() + self.MAX_OPS     # + the m_cp plane

    def _lane_count(self, name):
        C = self.MAX_OPS + 1
        if name in ("SendDVC", "Crash"):
            return self.R * C
        if name in ("ReceiveGetState", "ReceiveGetCheckpointMsg"):
            return self.M * self.R * C
        if name == "ReceiveRecoveryMsg":
            return self.M * C
        if name == "ReceiveNewCheckpointMsg":
            return self.M
        return super()._lane_count(name)

    def _row(self, B, dev, *args, cp=None, **kw):
        row = super()._row(B, dev, *args, **kw)
        row["cp"] = (cp.to(I32) if cp is not None else
                     torch.zeros((B, self.MAX_OPS), dtype=I32, device=dev))
        return row

    @staticmethod
    def _set_hdr(row, col, val):
        row["hdr"][:, col] = val

    # ------------------------------------------------------------------
    # lane decoding
    # ------------------------------------------------------------------
    def _rep_cp_lane(self, lane):
        """(replica, cp) of a SendDVC or Crash lane i * C + cp."""
        C = self.MAX_OPS + 1
        return _div(lane, C), torch.remainder(lane, C)

    def _slot_rep_cp_lane(self, lane):
        """(slot, replica, cp) of a ReceiveGetState or
        ReceiveGetCheckpointMsg lane k * R * C + i * C + cp."""
        C = self.MAX_OPS + 1
        k = _div(lane, self.R * C)
        rest = torch.remainder(lane, self.R * C)
        return k, _div(rest, C), torch.remainder(rest, C)

    # ------------------------------------------------------------------
    # checkpoint helpers
    # ------------------------------------------------------------------
    def _hgc(self, log):
        """HighestGCedOp (CP06:346-354) of log rows [..., OPS]: the
        largest 1-based position holding NoLogEntry, 0 when none."""
        pos = _iota(self.MAX_OPS, log.device)
        return torch.where(log == self.NOOP, pos + 1, 0).amax(dim=-1)

    def _prefix(self, row, n):
        """row [B, OPS] below position n [B], zero above."""
        pos = _iota(self.MAX_OPS, row.device)[None, :]
        return torch.where(pos < n[:, None], row, 0)

    def _clear_dvc(self, s2, i):
        s2 = super()._clear_dvc(s2, i)
        s2["dvc_cpn"] = _put(s2["dvc_cpn"], i, 0)
        s2["dvc_cp"] = _put(s2["dvc_cp"], i, 0)
        return s2

    def _apply_checkpoint(self, s2, i, suffix, cp_plane, cpn, opn,
                          new_commit):
        """ApplyCheckpoint (CP06:383-402): NoOp the prefix the checkpoint
        covers, the suffix above it, the app state the checkpoint plus the
        executed suffix, op and commit set."""
        pos = _iota(self.MAX_OPS, i.device)[None, :]
        sfx = suffix.gather(1, _clip(pos - cpn[:, None], 0,
                                     self.MAX_OPS - 1).long())
        new_log = torch.where(pos < cpn[:, None], self.NOOP,
                              torch.where(pos < opn[:, None], sfx, 0))
        new_app = torch.where(pos < cpn[:, None], cp_plane,
                              torch.where(pos < new_commit[:, None], sfx, 0))
        s2 = dict(s2)
        s2["log"] = _put(s2["log"], i, new_log)
        s2["app"] = _put(s2["app"], i, new_app)
        s2["op"] = _put(s2["op"], i, opn)
        s2["commit"] = _put(s2["commit"], i, new_commit)
        return s2

    def _log_suffix(self, log_row, first):
        """LogSuffix re-based at 0: source positions first-1.., zero past
        the log's end (every CP06 log has Len(log) == op)."""
        pos = _iota(self.MAX_OPS, log_row.device)[None, :]
        at = pos + first[:, None] - 1
        src = _clip(at, 0, self.MAX_OPS - 1)
        return torch.where(at < self.MAX_OPS, log_row.gather(1, src.long()),
                           0)

    def _dvc_slot_add_cp(self, s2, i, j, lnv, op, commit, suffix,
                         cp_plane, cpn, pred):
        """AS04's slot union (whose collision test reads neither
        checkpoint field), then the checkpoint fields."""
        s2 = self._dvc_slot_add(s2, i, j, lnv, op, commit, suffix,
                                pred=pred)
        s2["dvc_cpn"] = _where(pred, _put2(s2["dvc_cpn"], i, j, cpn),
                               s2["dvc_cpn"])
        s2["dvc_cp"] = _where(pred, _put2(s2["dvc_cp"], i, j, cp_plane),
                              s2["dvc_cp"])
        return s2

    def _merge(self, pred, a, b):
        """The state ``a`` where pred, else ``b``, over the planes the two
        forms of an install write (log, app, op, commit)."""
        out = dict(b)
        for k in ("log", "app", "op", "commit"):
            out[k] = _where(pred, a[k], b[k])
        return out

    # ------------------------------------------------------------------
    # view change: checkpointed DVC / SV
    # ------------------------------------------------------------------
    def act_send_dvc(self, st, lane):             # CP06:785-816
        i, cp = self._rep_cp_lane(lane)
        r = i + 1
        B, dev = lane.shape[0], lane.device
        view = _take(st["view"], i)
        prim = self._primary(view, self.R)
        log_i = _take(st["log"], i)
        hgc = self._hgc(log_i)
        en = (self._can_progress(st, i)
              & (_take(st["status"], i) == VIEWCHANGE)
              & (_take(st["sent_dvc"], i) == 0)
              & (self._svc_tombstones(st, i) >= self.R // 2)
              & (cp >= hgc + 1) & (cp <= _take(st["commit"], i)))
        cp_plane = self._prefix(_take(st["app"], i), cp)
        suffix = self._log_suffix(log_i, cp + 1)
        s2 = dict(st)
        s2["sent_dvc"] = _put(st["sent_dvc"], i, 1)
        row = self._row(B, dev, M_DVC, view=view, op=_take(st["op"], i),
                        commit=_take(st["commit"], i), dest=prim, src=r,
                        lnv=_take(st["lnv"], i), log=suffix, cp=cp_plane)
        self._set_hdr(row, H_CP, cp)
        self_case = prim == r
        s2 = self._bag_send(s2, row, new_count=torch.where(self_case, 0, 1))
        s2 = self._dvc_slot_add_cp(s2, i, i, _take(st["lnv"], i),
                                   _take(st["op"], i),
                                   _take(st["commit"], i), suffix, cp_plane,
                                   cp, pred=self_case & en)
        return s2, en

    def act_receive_higher_dvc(self, st, lane):   # CP06:825-844
        k = lane
        B, dev = lane.shape[0], lane.device
        hdr, r, i = self._msg_lane(st, k)
        j = _clip(hdr[:, H_SRC] - 1, 0, self.R - 1)
        en = (self._recv_en(st, k, hdr, M_DVC) & self._can_progress(st, i)
              & self._not_recovering(st, i)
              & (hdr[:, H_VIEW] > _take(st["view"], i)))
        s2 = dict(st)
        s2["view"] = _put(st["view"], i, hdr[:, H_VIEW])
        s2["status"] = _put(st["status"], i, VIEWCHANGE)
        s2 = self._reset_sent(s2, i)
        s2 = self._clear_dvc(s2, i)
        s2 = self._dvc_slot_add_cp(
            s2, i, j, hdr[:, H_LNV], hdr[:, H_OP], hdr[:, H_COMMIT],
            _take(st["m_log"], k), _take(st["m_cp"], k), hdr[:, H_CP],
            pred=torch.ones_like(en))
        s2 = self._bag_discard(s2, k)
        return self._broadcast(s2, self._row(B, dev, M_SVC,
                                             view=hdr[:, H_VIEW], src=r),
                               r), en

    def act_receive_matching_dvc(self, st, lane):  # CP06:846-862
        k = lane
        hdr, _r, i = self._msg_lane(st, k)
        j = _clip(hdr[:, H_SRC] - 1, 0, self.R - 1)
        en = (self._recv_en(st, k, hdr, M_DVC) & self._can_progress(st, i)
              & (_take(st["status"], i) == VIEWCHANGE)
              & (hdr[:, H_VIEW] == _take(st["view"], i)))
        s2 = self._bag_discard(dict(st), k)
        s2 = self._dvc_slot_add_cp(
            s2, i, j, hdr[:, H_LNV], hdr[:, H_OP], hdr[:, H_COMMIT],
            _take(st["m_log"], k), _take(st["m_cp"], k), hdr[:, H_CP],
            pred=en)
        return s2, en

    def _winning_dvc(self, st, i):
        """WinningDVC (CP06:885-896) and HighestCommitNumber: the maximal
        (lnv, op) slot, CHOOSE ties to the least (checkpoint, commit,
        cp_number, log_suffix keyed by domain, source), the first such."""
        mask = _take(st["dvc"], i) == 1                          # [B, R]
        pair = (_take(st["dvc_lnv"], i) * (self.MAX_OPS + 1)
                + _take(st["dvc_op"], i))
        best_pair = torch.where(mask, pair, -1).amax(dim=1, keepdim=True)
        cand = mask & (pair == best_pair)
        B, dev = i.shape[0], i.device
        src_ids = (_iota(self.R, dev) + 1).to(I32)[None, :, None].expand(
            B, -1, 1)
        pos = _iota(self.MAX_OPS, dev)[None, None, :]
        cpn = _take(st["dvc_cpn"], i)                             # [B, R]
        n_sfx = _take(st["dvc_op"], i) - cpn
        # a suffix entry keyed by its (domain, entry) pair: the record
        # order compares the domain key first
        sfx_key = torch.where(pos < n_sfx[:, :, None],
                              (cpn[:, :, None] + 1 + pos) * 64
                              + _take(st["dvc_log"], i), 0).to(I32)
        keys = torch.cat([_take(st["dvc_cp"], i),
                          _take(st["dvc_commit"], i)[:, :, None],
                          cpn[:, :, None], sfx_key, src_ids], dim=2)
        for c in range(keys.shape[2]):
            col = torch.where(cand, keys[:, :, c], INF)
            cand = cand & (col == col.amin(dim=1, keepdim=True))
        best_j = _first_true(cand)
        new_cn = torch.where(mask, _take(st["dvc_commit"], i), -1).amax(1)
        return best_j, new_cn

    def act_send_sv(self, st, lane):              # CP06:898-937
        i = lane
        r = i + 1
        B, dev = lane.shape[0], lane.device
        view = _take(st["view"], i)
        en = (self._can_progress(st, i)
              & (_take(st["status"], i) == VIEWCHANGE)
              & (_take(st["sent_sv"], i) == 0)
              & ((_take(st["dvc"], i) == 1).sum(dim=1) >= self.R // 2 + 1))
        j, new_cn = self._winning_dvc(st, i)
        w_sfx = _take2(st["dvc_log"], i, j)
        w_cp = _take2(st["dvc_cp"], i, j)
        w_cpn = _take2(st["dvc_cpn"], i, j)
        w_op = _take2(st["dvc_op"], i, j)
        s2 = dict(st)
        s2["status"] = _put(st["status"], i, NORMAL)
        s2 = self._apply_checkpoint(s2, i, w_sfx, w_cp, w_cpn, w_op, new_cn)
        s2["peer_op"] = _put(s2["peer_op"], i, 0)
        s2["sent_sv"] = _put(s2["sent_sv"], i, 1)
        s2["lnv"] = _put(s2["lnv"], i, view)
        s2 = self._clear_dvc(s2, i)
        row = self._row(B, dev, M_SV, view=view, op=w_op, commit=new_cn,
                        src=r, log=w_sfx, cp=w_cp)
        self._set_hdr(row, H_CP, w_cpn)
        return self._broadcast(s2, row, r), en

    def act_receive_sv(self, st, lane):           # CP06:939-971
        k = lane
        B, dev = lane.shape[0], lane.device
        hdr, r, i = self._msg_lane(st, k)
        hv, view_i = hdr[:, H_VIEW], _take(st["view"], i)
        en = (self._recv_en(st, k, hdr, M_SV) & self._can_progress(st, i)
              & self._not_recovering(st, i)
              & (((hv == view_i) & (_take(st["status"], i) == VIEWCHANGE))
                 | (hv > view_i)))
        old_commit = _take(st["commit"], i)
        s2 = dict(st)
        s2["status"] = _put(st["status"], i, NORMAL)
        s2["view"] = _put(st["view"], i, hv)
        s2 = self._apply_checkpoint(s2, i, _take(st["m_log"], k),
                                    _take(st["m_cp"], k), hdr[:, H_CP],
                                    hdr[:, H_OP], hdr[:, H_COMMIT])
        s2["lnv"] = _put(s2["lnv"], i, hv)
        s2 = self._reset_sent(s2, i)
        s2 = self._clear_dvc(s2, i)
        s2 = self._bag_discard(s2, k)
        ok_row = self._row(B, dev, M_PREPAREOK, view=hv, op=hdr[:, H_OP],
                           dest=self._primary(hv, self.R), src=r)
        return self._bag_send(s2, ok_row, pred=old_commit < hdr[:, H_OP]), en

    # ------------------------------------------------------------------
    # state transfer: the two reply forms
    # ------------------------------------------------------------------
    def _get_state_en(self, st, lane):
        k, i, cp = self._slot_rep_cp_lane(lane)
        r = i + 1
        hdr = _take(st["m_hdr"], k)
        dest = hdr[:, H_DEST]
        log_i = _take(st["log"], i)
        base = ((_take(st["m_present"], k) == 1)
                & (_take(st["m_count"], k) > 0)
                & (hdr[:, H_TYPE] == M_GETSTATE)
                & ((dest == r) | ((dest == ANYDEST) & (hdr[:, H_SRC] != r)))
                & self._can_progress(st, i)
                & (_take(st["status"], i) == NORMAL)
                & (_take(st["view"], i) == hdr[:, H_VIEW])
                & (_take(st["op"], i) > hdr[:, H_OP]))
        # GC'd at m.op+1: a checkpoint reply (the cp lanes); else a
        # log-suffix reply (the cp == 0 lane)
        gced = _take(log_i, _clip(hdr[:, H_OP], 0, self.MAX_OPS - 1)) \
            == self.NOOP
        hgc = self._hgc(log_i)
        en_cp = base & gced & (cp >= hgc + 1) & (cp <= _take(st["commit"],
                                                               i))
        en_ls = base & ~gced & (cp == 0)
        return en_cp | en_ls, k, i, cp, gced, hdr

    def act_receive_get_state(self, st, lane):    # CP06:644-680
        en, k, i, cp, gced, hdr = self._get_state_en(st, lane)
        r = i + 1
        B, dev = lane.shape[0], lane.device
        log_i = _take(st["log"], i)
        s2 = self._bag_discard(dict(st), k)
        cp_plane = self._prefix(_take(st["app"], i), cp)
        first_ls = hdr[:, H_OP] + 1
        row_log = torch.where(gced[:, None], self._log_suffix(log_i, cp + 1),
                              self._log_suffix(log_i, first_ls))
        row = self._row(B, dev, M_NEWSTATE, view=_take(st["view"], i),
                        op=_take(st["op"], i), dest=hdr[:, H_SRC], src=r,
                        log=row_log,
                        cp=torch.where(gced[:, None], cp_plane, 0))
        self._set_hdr(row, H_FLAG, gced.to(I32))
        self._set_hdr(row, H_CP, torch.where(gced, cp, 0))
        self._set_hdr(row, H_FIRST, torch.where(gced, 0, first_ls))
        self._set_hdr(row, H_COMMIT, torch.where(gced, cp,
                                                 _take(st["commit"], i)))
        return self._bag_send(s2, row), en

    def act_receive_new_state(self, st, lane):    # CP06:682-712
        k = lane
        hdr, _r, i = self._msg_lane(st, k)
        en = (self._recv_en(st, k, hdr, M_NEWSTATE)
              & self._can_progress(st, i)
              & (_take(st["status"], i) == STATETRANSFER)
              & (_take(st["view"], i) == hdr[:, H_VIEW]))
        is_cp = hdr[:, H_FLAG] == 1
        m_log = _take(st["m_log"], k)
        # flag 1: ApplyCheckpoint wholesale
        s2_cp = self._apply_checkpoint(
            dict(st), i, m_log, _take(st["m_cp"], k), hdr[:, H_CP],
            hdr[:, H_OP], hdr[:, H_COMMIT])
        # flag 0: the replica's own prefix below first_op under the
        # message's suffix
        log0 = self._splice(_take(st["log"], i), m_log, hdr[:, H_FIRST],
                            hdr[:, H_OP])
        s2_ls = dict(st)
        s2_ls["log"] = _put(st["log"], i, log0)
        s2_ls = self._exec_ops(s2_ls, i, log0, hdr[:, H_COMMIT])
        s2_ls["op"] = _put(s2_ls["op"], i, hdr[:, H_OP])
        s2 = self._merge(is_cp, s2_cp, s2_ls)
        s2["status"] = _put(s2["status"], i, NORMAL)
        s2["view"] = _put(s2["view"], i, hdr[:, H_VIEW])
        s2["lnv"] = _put(s2["lnv"], i, hdr[:, H_VIEW])
        return self._bag_discard(s2, k), en

    # ------------------------------------------------------------------
    # recovery: GetCheckpoint -> NewCheckpoint -> Recovery -> responses
    # ------------------------------------------------------------------
    def act_crash(self, st, lane):                # CP06:985-1009
        i, cp = self._rep_cp_lane(lane)
        r = i + 1
        B, dev = lane.shape[0], lane.device
        row = self._row(B, dev, M_GETCP, dest=ANYDEST, src=r)
        en = ((st["aux_restart"] < self.crash_limit)
              & (cp <= _take(st["commit"], i))
              & ~self._row_eq(st, row).any(dim=1))     # SendOnce
        pos = _iota(self.MAX_OPS, dev)[None, :]
        s2 = dict(st)
        s2["status"] = _put(st["status"], i, RECOVERING)
        s2["log"] = _put(st["log"], i, torch.where(
            pos < cp[:, None], self.NOOP, 0))             # EmptyLog(cp)
        s2["app"] = _put(st["app"], i, self._prefix(_take(st["app"], i),
                                                    cp))  # Checkpoint
        s2["view"] = _put(st["view"], i, 0)
        s2["op"] = _put(st["op"], i, cp)
        s2["commit"] = _put(st["commit"], i, cp)
        s2["peer_op"] = _put(st["peer_op"], i, 0)
        s2["lnv"] = _put(st["lnv"], i, 0)
        s2 = self._reset_sent(s2, i)
        s2 = self._clear_dvc(s2, i)
        s2 = self._clear_rec(s2, i)
        s2["rec_number"] = _put(s2["rec_number"], i,
                                self._unique_number(st))
        s2["aux_restart"] = st["aux_restart"] + 1
        return self._bag_send(s2, row), en

    def act_receive_get_checkpoint(self, st, lane):  # CP06:1017-1043
        k, i, cp = self._slot_rep_cp_lane(lane)
        r = i + 1
        B, dev = lane.shape[0], lane.device
        hdr = _take(st["m_hdr"], k)
        dest = hdr[:, H_DEST]
        en = ((_take(st["m_present"], k) == 1)
              & (_take(st["m_count"], k) > 0)
              & (hdr[:, H_TYPE] == M_GETCP)
              & ((dest == r) | ((dest == ANYDEST) & (hdr[:, H_SRC] != r)))
              & self._can_progress(st, i) & self._not_recovering(st, i)
              & (cp <= _take(st["commit"], i)))
        cp_plane = self._prefix(_take(st["app"], i), cp)
        s2 = self._bag_discard(dict(st), k)
        row = self._row(B, dev, M_NEWCP, dest=hdr[:, H_SRC], src=r,
                        cp=cp_plane)
        self._set_hdr(row, H_CP, cp)
        return self._bag_send(s2, row), en

    def act_receive_new_checkpoint(self, st, lane):  # CP06:1051-1079
        k = lane
        B, dev = lane.shape[0], lane.device
        hdr, r, i = self._msg_lane(st, k)
        en = (self._recv_en(st, k, hdr, M_NEWCP)
              & self._can_progress(st, i)
              & (_take(st["status"], i) == RECOVERING))
        cpn = hdr[:, H_CP]
        u = self._unique_number(st)
        pos = _iota(self.MAX_OPS, dev)[None, :]
        s2 = dict(st)
        s2["log"] = _put(st["log"], i, torch.where(pos < cpn[:, None],
                                                   self.NOOP, 0))
        s2["app"] = _put(st["app"], i, _take(st["m_cp"], k))
        s2["op"] = _put(st["op"], i, cpn)
        s2["commit"] = _put(st["commit"], i, cpn)
        s2 = self._bag_discard(s2, k)
        return self._broadcast(s2, self._row(B, dev, M_RECOVERY, src=r, x=u,
                                             op=cpn), r), en

    def _recovery_en(self, st, lane):
        C = self.MAX_OPS + 1
        k, cp = _div(lane, C), torch.remainder(lane, C)
        hdr, r, i = self._msg_lane(st, k)
        base = (self._recv_en(st, k, hdr, M_RECOVERY)
                & (_take(st["status"], i) == NORMAL))
        prim = self._is_normal_primary(st, i, r)
        m_op = hdr[:, H_OP]
        log_i = _take(st["log"], i)
        gced = ((_take(st["op"], i) > m_op)
                & (_take(log_i, _clip(m_op, 0, self.MAX_OPS - 1))
                   == self.NOOP))
        hgc = self._hgc(log_i)
        en_cp = (base & prim & gced & (cp >= hgc + 1)
                 & (cp <= _take(st["commit"], i)))
        en_other = base & (~prim | ~gced) & (cp == 0)
        return en_cp | en_other, k, cp, hdr, r, i, prim, gced

    def act_receive_recovery(self, st, lane):     # CP06:1081-1105
        en, k, cp, hdr, r, i, prim, gced = self._recovery_en(st, lane)
        B, dev = lane.shape[0], lane.device
        log_i = _take(st["log"], i)
        cp_plane = self._prefix(_take(st["app"], i), cp)
        s2 = self._bag_discard(dict(st), k)
        first_ls = hdr[:, H_OP] + 1
        pg = prim & gced
        row_log = torch.where(
            pg[:, None], self._log_suffix(log_i, cp + 1),
            torch.where(prim[:, None], self._log_suffix(log_i, first_ls), 0))
        row = self._row(B, dev, M_RECOVERYRESP, view=_take(st["view"], i),
                        x=hdr[:, H_X], op=_take(st["op"], i),
                        dest=hdr[:, H_SRC], src=r, log=row_log,
                        cp=torch.where(pg[:, None], cp_plane, 0))
        self._set_hdr(row, H_FLAG, pg.to(I32))
        self._set_hdr(row, H_CP, torch.where(pg, cp, 0))
        self._set_hdr(row, H_FIRST, torch.where(
            ~prim, -1, torch.where(gced, 0, first_ls)))
        self._set_hdr(row, H_COMMIT, torch.where(
            ~prim, -1, torch.where(gced, cp, _take(st["commit"], i))))
        return self._bag_send(s2, row), en

    def act_receive_recovery_response(self, st, lane):  # CP06:1107-1121
        k = lane
        hdr, _r, i = self._msg_lane(st, k)
        j = _clip(hdr[:, H_SRC] - 1, 0, self.R - 1)
        en = (self._recv_en(st, k, hdr, M_RECOVERYRESP)
              & (_take(st["rec_number"], i) == hdr[:, H_X])
              & (_take(st["status"], i) == RECOVERING))
        has_log = ~((hdr[:, H_FIRST] == -1) & (hdr[:, H_COMMIT] == -1))
        s2 = dict(st)
        collide = (en & (_take2(s2["rec"], i, j) == 1)
                   & ((_take2(s2["rec_view"], i, j) != hdr[:, H_VIEW])
                      | (_take2(s2["rec_op"], i, j) != hdr[:, H_OP])))
        flag = hdr[:, H_FLAG]
        for key, val in (
                ("rec", 1), ("rec_view", hdr[:, H_VIEW]),
                ("rec_op", hdr[:, H_OP]), ("rec_has_log", has_log.to(I32)),
                ("rec_flag", flag),
                ("rec_first", torch.where(flag == 1, hdr[:, H_CP] + 1,
                                          hdr[:, H_FIRST])),
                ("rec_cpn", hdr[:, H_CP]), ("rec_commit", hdr[:, H_COMMIT]),
                ("rec_log", _take(st["m_log"], k)),
                ("rec_cp", _take(st["m_cp"], k))):
            s2[key] = _put2(s2[key], i, j, val)
        s2["err"] = s2["err"] | torch.where(collide, ERR_REC_OVERFLOW, 0
                                            ).to(I32)
        return self._bag_discard(s2, k), en

    def act_complete_recovery(self, st, lane):    # CP06:1138-1170
        i = lane
        rec_i = _take(st["rec"], i)
        cand, j = self._best_rec(rec_i, _take(st["rec_view"], i),
                                 _take(st["rec_has_log"], i))
        en = ((_take(st["status"], i) == RECOVERING)
              & self._rec_quorum(rec_i) & cand.any(dim=1))
        at = lambda key: _take2(st[key], i, j)
        is_cp = at("rec_flag") == 1
        m_op, m_commit = at("rec_op"), at("rec_commit")
        s2_cp = self._apply_checkpoint(dict(st), i, at("rec_log"),
                                       at("rec_cp"), at("rec_cpn"), m_op,
                                       m_commit)
        log0 = self._splice(_take(st["log"], i), at("rec_log"),
                            at("rec_first"), m_op)
        s2_ls = dict(st)
        s2_ls["log"] = _put(st["log"], i, log0)
        s2_ls = self._exec_ops(s2_ls, i, log0, m_commit)
        s2_ls["op"] = _put(s2_ls["op"], i, m_op)
        s2 = self._merge(is_cp, s2_cp, s2_ls)
        s2["status"] = _put(s2["status"], i, NORMAL)
        s2["view"] = _put(s2["view"], i, at("rec_view"))
        s2["lnv"] = _put(s2["lnv"], i, at("rec_view"))
        return self._clear_rec(s2, i), en

    # ------------------------------------------------------------------
    # guards: every lane of one action over a batch -> [B, L_a] bool
    # ------------------------------------------------------------------
    def _cps(self, dev):
        return _iota(self.MAX_OPS + 1, dev)

    def guard_send_dvc(self, st):
        base = super().guard_send_dvc(st)                        # [B, R]
        cp = self._cps(base.device)[None, None, :]
        ok = ((cp >= self._hgc(st["log"])[:, :, None] + 1)
              & (cp <= st["commit"][:, :, None]))
        return (base[:, :, None] & ok).reshape(base.shape[0], -1)

    def _slot_log_at(self, st, i, pos):
        """log[b, i[b, m], pos[b, m]] for [B, M] replica and position
        indices."""
        B, M = i.shape
        rows = st["log"].gather(1, i.long()[:, :, None].expand(
            B, M, self.MAX_OPS))
        return rows.gather(2, pos.long()[:, :, None])[:, :, 0]

    def guard_receive_get_state(self, st):
        hdr = st["m_hdr"]
        B = hdr.shape[0]
        base = super().guard_receive_get_state(st).reshape(
            B, self.M, self.R)                                   # [B, M, R]
        opk = _clip(hdr[:, :, H_OP], 0, self.MAX_OPS - 1)        # [B, M]
        gced = (st["log"][:, None, :, :].expand(-1, self.M, -1, -1).gather(
            3, opk.long()[:, :, None, None].expand(-1, -1, self.R, 1)
        )[:, :, :, 0] == self.NOOP)                              # [B, M, R]
        cp = self._cps(hdr.device)
        hgc = self._hgc(st["log"])[:, None, :, None]
        commit = st["commit"][:, None, :, None]
        en_cp = ((base & gced)[..., None] & (cp >= hgc + 1)
                 & (cp <= commit))
        en_ls = (base & ~gced)[..., None] & (cp == 0)
        return (en_cp | en_ls).reshape(B, -1)

    def guard_receive_new_state(self, st):
        hdr, i, m, view_i = self._guard_recv(st, M_NEWSTATE)
        return (m & (self._g(st["status"], i) == STATETRANSFER)
                & (hdr[:, :, H_VIEW] == view_i))

    def guard_crash(self, st):
        hdr = st["m_hdr"]
        B, dev = hdr.shape[0], hdr.device
        r = _iota(self.R, dev) + 1
        # SendOnce: a present slot holding [GetCheckpoint, AnyDest,
        # source r, every other field 0]
        want = torch.zeros((self.R, self.NHDR), dtype=I32, device=dev)
        want[:, H_TYPE] = M_GETCP
        want[:, H_DEST] = ANYDEST
        want[:, H_SRC] = r
        blank = ((st["m_present"] == 1) & (st["m_entry"] == 0)
                 & (st["m_log"] == 0).all(-1) & (st["m_cp"] == 0).all(-1))
        sent = (blank[:, :, None]
                & (hdr[:, :, None, :] == want[None, None]).all(-1)
                ).any(dim=1)                                     # [B, R]
        cp = self._cps(dev)[None, None, :]
        en = ((st["aux_restart"] < self.crash_limit)[:, None, None]
              & (cp <= st["commit"][:, :, None]) & ~sent[:, :, None])
        return en.reshape(B, -1)

    def guard_receive_get_checkpoint(self, st):
        hdr = st["m_hdr"]
        B, dev = hdr.shape[0], hdr.device
        r = _iota(self.R, dev) + 1
        dest, src = hdr[:, :, H_DEST, None], hdr[:, :, H_SRC, None]
        slot = ((st["m_present"] == 1) & (st["m_count"] > 0)
                & (hdr[:, :, H_TYPE] == M_GETCP))[:, :, None]
        rep = ((st["no_prog"] == 0)
               & (st["status"] != RECOVERING))[:, None, :]
        en = slot & ((dest == r) | ((dest == ANYDEST) & (src != r))) & rep
        cp = self._cps(dev)[None, None, None, :]
        return (en[..., None] & (cp <= st["commit"][:, None, :, None])
                ).reshape(B, -1)

    def guard_receive_new_checkpoint(self, st):
        _hdr, i, m, _view_i = self._guard_recv(st, M_NEWCP)
        return m & (self._g(st["status"], i) == RECOVERING)

    def _recv_any(self, st, mtype):
        """A deliverable ``mtype`` record whatever its receiver's
        CanProgress (CP06's recovery guards do not ask it): (hdr, i,
        mask)."""
        hdr = st["m_hdr"]
        i = _clip(hdr[:, :, H_DEST] - 1, 0, self.R - 1)
        return hdr, i, ((st["m_present"] == 1) & (st["m_count"] > 0)
                        & (hdr[:, :, H_TYPE] == mtype))

    def guard_receive_recovery(self, st):
        hdr, i, m = self._recv_any(st, M_RECOVERY)
        base = m & (self._g(st["status"], i) == NORMAL)
        prim = self._msg_normal_primary(st, hdr, i)
        m_op = hdr[:, :, H_OP]
        gced = ((self._g(st["op"], i) > m_op)
                & (self._slot_log_at(st, i, _clip(m_op, 0, self.MAX_OPS - 1))
                   == self.NOOP))
        hgc = self._g(self._hgc(st["log"]), i)[:, :, None]
        cp = self._cps(hdr.device)[None, None, :]
        en_cp = ((base & prim & gced)[:, :, None] & (cp >= hgc + 1)
                 & (cp <= self._g(st["commit"], i)[:, :, None]))
        en_other = (base & (~prim | ~gced))[:, :, None] & (cp == 0)
        return (en_cp | en_other).reshape(hdr.shape[0], -1)

    def guard_receive_recovery_response(self, st):
        hdr, i, m = self._recv_any(st, M_RECOVERYRESP)
        return (m & (self._g(st["rec_number"], i) == hdr[:, :, H_X])
                & (self._g(st["status"], i) == RECOVERING))

    def guard_complete_recovery(self, st):
        cand, _j = self._best_rec(st["rec"], st["rec_view"],
                                  st["rec_has_log"])
        return ((st["status"] == RECOVERING) & self._rec_quorum(st["rec"])
                & cand.any(dim=2))

    # ------------------------------------------------------------------
    # action table
    # ------------------------------------------------------------------
    def _guard_list(self):
        return ST03Kernel._guard_list(self)[:15] + [
            self.guard_crash, self.guard_receive_get_checkpoint,
            self.guard_receive_new_checkpoint, self.guard_receive_recovery,
            self.guard_receive_recovery_response,
            self.guard_complete_recovery, self.guard_no_progress_change,
        ]

    def _action_list(self):
        return ST03Kernel._action_list(self)[:15] + [
            self.act_crash, self.act_receive_get_checkpoint,
            self.act_receive_new_checkpoint, self.act_receive_recovery,
            self.act_receive_recovery_response, self.act_complete_recovery,
            self.act_no_progress_change,
        ]

    def lane_replica(self, name, st, lane):
        C = self.MAX_OPS + 1
        if name in ("SendDVC", "Crash"):
            return _div(lane, C)
        if name in ("ReceiveGetState", "ReceiveGetCheckpointMsg"):
            return self._slot_rep_cp_lane(lane)[1]
        if name == "ReceiveRecoveryMsg":
            return _clip(_take(st["m_hdr"], _div(lane, C))[:, H_DEST] - 1, 0,
                         self.R - 1).to(lane.dtype)
        return super().lane_replica(name, st, lane)

    # ------------------------------------------------------------------
    # invariants (CP06:1219-1281), batched: st -> [B] bool
    # ------------------------------------------------------------------
    def _op_of(self, st):
        """OpOf (CP06:1219-1222): a NoOp (GC'd) log slot defers to the
        app state.  The raw-log invariants RR05 inherits are wrong here:
        a recovered or checkpointed replica's log prefix is NoOps while
        its app state holds the operations."""
        return torch.where(st["log"] == self.NOOP, st["app"], st["log"])

    def _replica_has_op(self, st):
        # ReplicaHasOp (CP06:1244-1246) through OpOf
        v_ids = _iota(self.V, st["log"].device) + 1
        return (self._op_of(st)[:, :, :, None] == v_ids).any(dim=2)

    def _committed(self, st):
        pos = _iota(self.MAX_OPS, st["log"].device)
        return pos[None, None, :] < st["commit"][:, :, None]     # [B, R, P]

    def inv_no_log_divergence(self, st):
        # CP06:1224-1231: both-committed ops compared through OpOf
        comm = self._committed(st)
        op_of = self._op_of(st)
        diff = op_of[:, :, None, :] != op_of[:, None, :, :]
        both = comm[:, :, None, :] & comm[:, None, :, :]
        return ~(both & diff).flatten(1).any(dim=1)

    def inv_no_app_state_divergence(self, st):
        # CP06:1234-1240: app divergence on a both-committed op, or a
        # committed app entry equal to NoLogEntry
        comm = self._committed(st)
        app = st["app"]
        diff = app[:, :, None, :] != app[:, None, :, :]
        both = comm[:, :, None, :] & comm[:, None, :, :]
        pair = (both & diff).flatten(1).any(dim=1)
        noop = ((app == self.NOOP) & comm).flatten(1).any(dim=1)
        return ~(pair | noop)

    def inv_commit_matches_app_state(self, st):
        # CP06:1279-1281 (Len(app) == commit) on the planes: app is
        # nonzero exactly below commit
        return ((st["app"] != 0) == self._committed(st)).flatten(1).all(1)

    INVARIANT_FNS = dict(
        RR05Kernel.INVARIANT_FNS,
        CommitNumberMatchesAppState="inv_commit_matches_app_state")
