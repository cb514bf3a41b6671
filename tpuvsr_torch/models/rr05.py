"""Dense state layout for VR_REPLICA_RECOVERY (reference: RR05,
analysis/05-replica-recovery/VR_REPLICA_RECOVERY.tla).

A copy of ``tpuvsr/models/rr05.py`` (``RECOVERING``, the two recovery
message kinds, ``RR05Codec``) with one change: the recovery nonce's pack
bound.  The JAX codec bounds the H_X header column, ``rec_number`` and
``aux_restart`` by the widths pass's ``recovery_nonce`` range, 1 +
CrashLimit ("UniqueNumber mints one per crash").  But ``RetryRecovery``
mints a nonce too (max x of the RecoveryMsgs in the bag + 1, and a
delivered message stays in the bag as a tombstone), so the nonce grows
with the retries and nothing bounds it; the JAX pack masks a value to
its width with no check, so a nonce of 4 wraps to 0 in the packed
frontier.  The port's widths pass (``analysis/widths.py``) derives no
``recovery_nonce`` for this module, and ``_x_hi`` then returns None:
the three planes keep raw 32-bit lanes, as ``rr05.py:61-64`` of the
JAX package already does for an underivable range.  Its pack manifest
therefore differs from the JAX package's for RR05 (ROADMAP queue 3).

RR05 = AS04 (app state, recv_dvc-set quorums, state transfer) + the
crash-recovery sub-protocol (RR05:820-983): ``Crash`` wipes a replica
to the ``Recovering`` status (a FOURTH status code) broadcasting a
``RecoveryMsg`` with a fresh nonce from ``UniqueNumber`` (max x in the
bag + 1, RR05:826-835); only a Normal replica responds, attaching its
log/op/commit exactly when it is the primary (Nil otherwise,
RR05:871-889); ``CompleteRecovery`` installs the highest-view primary
response (RR05:920-942); ``RetryRecovery`` re-nonces when no such
response can ever arrive (RR05:951-983).

Layout additions over AS04: live ``rep_rec_number``/``rep_rec_recv``
(VSR-style [dest, source] response slots with implied x =
rep_rec_number[dest] and dest = r), a real ``aux_restart`` counter
(outside the VIEW projection like all aux vars, RR05:103), and two
more message kinds carrying the H_X header column.  The family's
Recovering code is 3; VSR's (``models/vsr.py``) is 2.
"""

from __future__ import annotations

import numpy as np

from ..core.values import FnVal, TLAError, mk_record
from .a01 import ENTRY_VIEW_BITS
from .as04 import AS04Codec
from .st03 import MSGTYPE_NAMES as ST03_MSGTYPE_NAMES
from .vsr import H_COMMIT, H_DEST, H_OP, H_SRC, H_TYPE, H_VIEW, H_X

RECOVERING = 3

M_RECOVERY, M_RECOVERYRESP = 8, 9
MSGTYPE_NAMES = dict(ST03_MSGTYPE_NAMES)
MSGTYPE_NAMES[M_RECOVERY] = "RecoveryMsg"
MSGTYPE_NAMES[M_RECOVERYRESP] = "RecoveryResponseMsg"


class RR05Codec(AS04Codec):
    def __init__(self, constants, shape=None, max_msgs=None):
        super().__init__(constants, shape=shape, max_msgs=max_msgs)
        if self.shape.MAX_VIEW >= 1 << ENTRY_VIEW_BITS:
            raise TLAError("RR05 packed entries need MAX_VIEW < 256")
        self.status_id[constants["Recovering"]] = RECOVERING
        self.status_mv[RECOVERING] = constants["Recovering"]
        for code in (M_RECOVERY, M_RECOVERYRESP):
            mv = constants[MSGTYPE_NAMES[code]]
            self.mtype_id[mv] = code
            self.mtype_mv[code] = mv

    def _entry_code_hi(self, view_hi):
        # packed 2-field entries (see _enc_entry below)
        return (self.shape.V << ENTRY_VIEW_BITS) | view_hi

    def _x_hi(self, ranges):
        # recovery nonce: bounded where the widths pass derives a range
        # (no RetryRecovery); underivable -> H_X keeps 32 bits
        r = ranges.get("recovery_nonce")
        return int(r[1]) if r else None

    def plane_bounds(self, ranges):
        b = super().plane_bounds(ranges)
        s = self.shape
        view = self._range_hi(ranges, "view_number", s.MAX_VIEW)
        ops = self._range_hi(ranges, "op_number", s.MAX_OPS)
        ent = self._entry_code_hi(view)
        x = self._x_hi(ranges)
        b.update({
            "rec_number": ((0, max(1, x)) if x is not None else None),
            "rec": (0, 1), "rec_view": (0, view),
            "rec_has_log": (0, 1), "rec_log": (0, ent),
            "rec_op": (-1, ops), "rec_commit": (-1, ops),
            # crash counter: bounded with the nonce; underivable -> keep
            # the raw lane, never guess
            "aux_restart": ((0, max(1, x)) if x is not None else None),
        })
        return b

    # RR05 log entries are [operation, view_number] records
    # (RR05:306-309), packed like A01's without the client_id
    def _enc_entry(self, e: FnVal) -> int:
        return (self.value_id[e.apply("operation")] << ENTRY_VIEW_BITS) \
            | e.apply("view_number")

    def _dec_entry(self, code):
        code = int(code)
        return mk_record(
            view_number=code & ((1 << ENTRY_VIEW_BITS) - 1),
            operation=self.values[(code >> ENTRY_VIEW_BITS) - 1])

    def zero_state(self):
        d = super().zero_state()
        s = self.shape
        z = lambda *sh: np.zeros(sh, np.int32)
        d["rec_number"] = z(s.R)
        d["rec"] = z(s.R, s.R)
        d["rec_view"] = z(s.R, s.R)
        d["rec_has_log"] = z(s.R, s.R)
        d["rec_log"] = z(s.R, s.R, s.MAX_OPS)
        d["rec_op"] = z(s.R, s.R)
        d["rec_commit"] = z(s.R, s.R)
        d["aux_restart"] = z()
        return d

    # -- live recovery vars (overrides AS04's frozen checks) ------------
    def _encode_rec(self, st, d, r):
        i = r - 1
        d["rec_number"][i] = st["rep_rec_number"].apply(r)
        for m in st["rep_rec_recv"].apply(r):
            if m.apply("x") != d["rec_number"][i] or m.apply("dest") != r:
                raise TLAError("rec_recv implied-field invariant violated")
            j = m.apply("source") - 1
            if d["rec"][i][j]:
                raise TLAError("recovery-response slot collision")
            d["rec"][i][j] = 1
            d["rec_view"][i][j] = m.apply("view_number")
            self._encode_rec_payload(m, d, i, j)

    def _encode_rec_payload(self, m, d, i, j):
        lg = m.apply("log")
        if isinstance(lg, FnVal):
            d["rec_has_log"][i][j] = 1
            d["rec_log"][i][j] = self._enc_log(lg)
            d["rec_op"][i][j] = m.apply("op_number")
            d["rec_commit"][i][j] = m.apply("commit_number")
        else:                       # log|op|commit are Nil
            d["rec_op"][i][j] = -1
            d["rec_commit"][i][j] = -1

    def _encode_aux_restart(self, st, d):
        d["aux_restart"][()] = st["aux_restart"]

    # -- messages -------------------------------------------------------
    def encode_msg_row(self, m: FnVal):
        t = self.mtype_id[m.apply("type")]
        if t not in (M_RECOVERY, M_RECOVERYRESP):
            return super().encode_msg_row(m)
        hdr = np.zeros(self.NHDR, np.int32)
        log = np.zeros(self.shape.MAX_OPS, np.int32)
        get = m.get
        hdr[H_TYPE] = t
        hdr[H_DEST] = self._enc_dest(get("dest"))
        hdr[H_SRC] = get("source")
        hdr[H_X] = get("x")
        if t == M_RECOVERYRESP:
            hdr[H_VIEW] = get("view_number")
            lg = get("log")
            if isinstance(lg, FnVal):
                log = self._enc_log(lg)
                hdr[H_OP] = get("op_number")
                hdr[H_COMMIT] = get("commit_number")
            else:
                hdr[H_OP] = -1          # log|op|commit are Nil
                hdr[H_COMMIT] = -1
        return hdr, 0, log

    def decode_msg_row(self, hdr, entry, log):
        t = int(hdr[H_TYPE])
        if t not in (M_RECOVERY, M_RECOVERYRESP):
            return super().decode_msg_row(hdr, entry, log)
        mv = self.mtype_mv[t]
        f = {"type": mv, "dest": self._dec_dest(hdr[H_DEST]),
             "source": int(hdr[H_SRC]), "x": int(hdr[H_X])}
        if t == M_RECOVERYRESP:
            f["view_number"] = int(hdr[H_VIEW])
            if int(hdr[H_OP]) < 0:
                f.update(log=self.nil, op_number=self.nil,
                         commit_number=self.nil)
            else:
                f.update(log=self._dec_log(log, hdr[H_OP]),
                         op_number=int(hdr[H_OP]),
                         commit_number=int(hdr[H_COMMIT]))
        return FnVal(f.items())

    def _rec_msg_fields(self, d, r, j):
        """The payload fields of response slot (r, j)."""
        if d["rec_has_log"][r - 1][j]:
            return dict(log=self._dec_log(d["rec_log"][r - 1][j],
                                          d["rec_op"][r - 1][j]),
                        op_number=int(d["rec_op"][r - 1][j]),
                        commit_number=int(d["rec_commit"][r - 1][j]))
        return dict(log=self.nil, op_number=self.nil,
                    commit_number=self.nil)

    def decode(self, d: dict):
        st = super().decode(d)
        d = {k: np.asarray(v) for k, v in d.items()}
        s = self.shape
        reps = range(1, s.R + 1)
        st["rep_rec_number"] = FnVal((r, int(d["rec_number"][r - 1]))
                                     for r in reps)
        resp_mv = self.constants["RecoveryResponseMsg"]

        def rec_msg(r, j):
            f = {"type": resp_mv,
                 "view_number": int(d["rec_view"][r - 1][j]),
                 "x": int(d["rec_number"][r - 1]),
                 "dest": r, "source": j + 1}
            f.update(self._rec_msg_fields(d, r, j))
            return FnVal(f.items())

        st["rep_rec_recv"] = FnVal(
            (r, frozenset(rec_msg(r, j)
                          for j in range(s.R) if d["rec"][r - 1][j]))
            for r in reps)
        st["aux_restart"] = int(d["aux_restart"])
        return st
