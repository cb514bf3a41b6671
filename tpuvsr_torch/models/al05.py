"""Dense state layout for VR_REPLICA_RECOVERY_ASYNC_LOG (reference: AL05,
analysis/05-replica-recovery/VR_REPLICA_RECOVERY_ASYNC_LOG.tla).

A copy of ``tpuvsr/models/al05.py`` (``AL05Codec``).  AL05 has no
``RetryRecovery``, so only ``Crash`` mints a recovery nonce and the
widths pass's bound 1 + CrashLimit holds: its pack manifest is the JAX
package's.

AL05 = RR05 with asynchronous log persistence: ``Crash`` keeps a
nondeterministic log *prefix* (``\\E last_op \\in 0..rep_op_number[r]``,
AL05:851-885) and the RecoveryMsg carries the survivor's floor
``op = MinVal(commit, last_op)``; recovery responses come in TWO forms
(AL05:888-915) — a backup's [view, x, log_suffix=Nil] and the primary's
[view, x, prefix_ceil, log_suffix, op, commit] — and CompleteRecovery
splices its own surviving prefix under the primary's suffix
(AL05:947-977).  No RetryRecovery (20 actions).

Layout deltas over RR05: log entries are plain value ids again, a
``rec_ceil`` plane for prefix_ceil, suffix logs stored re-based at 0
from the ceiling, and the H_OP/H_FIRST columns on the two recovery
message kinds (H_OP = -1 marks the backup's Nil form, whose record
carries no op/commit/ceil fields at all).
"""

from __future__ import annotations

import numpy as np

from ..core.values import FnVal, mk_record
from .rr05 import M_RECOVERY, M_RECOVERYRESP, RR05Codec
from .vsr import (H_COMMIT, H_DEST, H_FIRST, H_OP, H_SRC, H_TYPE,
                  H_VIEW, H_X)


class AL05Codec(RR05Codec):
    def _entry_code_hi(self, view_hi):
        return self.shape.V        # plain 1-field entries again

    def plane_bounds(self, ranges):
        b = super().plane_bounds(ranges)
        b["rec_ceil"] = (0, self._range_hi(ranges, "op_number",
                                           self.shape.MAX_OPS))
        return b

    # AL05 log entries revert to the 1-field [operation] records
    # (AL05:106-108)
    def _enc_entry(self, e: FnVal) -> int:
        return self.value_id[e.apply("operation")]

    def _dec_entry(self, code):
        return mk_record(operation=self.values[int(code) - 1])

    def zero_state(self):
        d = super().zero_state()
        s = self.shape
        d["rec_ceil"] = np.zeros((s.R, s.R), np.int32)
        return d

    def _encode_rec_payload(self, m, d, i, j):
        lg = m.get("log_suffix")
        if isinstance(lg, FnVal):
            ceil = m.apply("prefix_ceil")
            d["rec_has_log"][i][j] = 1
            d["rec_ceil"][i][j] = ceil
            d["rec_log"][i][j] = self._enc_log(lg, first_op=ceil + 1)
            d["rec_op"][i][j] = m.apply("op_number")
            d["rec_commit"][i][j] = m.apply("commit_number")
        else:
            d["rec_op"][i][j] = -1
            d["rec_commit"][i][j] = -1

    def encode_msg_row(self, m: FnVal):
        t = self.mtype_id[m.apply("type")]
        if t not in (M_RECOVERY, M_RECOVERYRESP):
            return super(RR05Codec, self).encode_msg_row(m)
        hdr = np.zeros(self.NHDR, np.int32)
        log = np.zeros(self.shape.MAX_OPS, np.int32)
        get = m.get
        hdr[H_TYPE] = t
        hdr[H_DEST] = self._enc_dest(get("dest"))
        hdr[H_SRC] = get("source")
        hdr[H_X] = get("x")
        if t == M_RECOVERY:
            hdr[H_OP] = get("op")       # MinVal(commit, last_op) floor
        else:
            hdr[H_VIEW] = get("view_number")
            lg = get("log_suffix")
            if isinstance(lg, FnVal):
                ceil = get("prefix_ceil")
                hdr[H_FIRST] = ceil
                hdr[H_OP] = get("op_number")
                hdr[H_COMMIT] = get("commit_number")
                log = self._enc_log(lg, first_op=ceil + 1)
            else:
                hdr[H_OP] = -1          # backup form: log_suffix = Nil
                hdr[H_COMMIT] = -1
        return hdr, 0, log

    def decode_msg_row(self, hdr, entry, log):
        t = int(hdr[H_TYPE])
        if t not in (M_RECOVERY, M_RECOVERYRESP):
            return super(RR05Codec, self).decode_msg_row(hdr, entry, log)
        mv = self.mtype_mv[t]
        f = {"type": mv, "dest": self._dec_dest(hdr[H_DEST]),
             "source": int(hdr[H_SRC]), "x": int(hdr[H_X])}
        if t == M_RECOVERY:
            f["op"] = int(hdr[H_OP])
        else:
            f["view_number"] = int(hdr[H_VIEW])
            if int(hdr[H_OP]) < 0:
                f["log_suffix"] = self.nil
            else:
                ceil = int(hdr[H_FIRST])
                f.update(prefix_ceil=ceil,
                         log_suffix=self._dec_log(
                             log, int(hdr[H_OP]) - ceil, first_op=ceil + 1),
                         op_number=int(hdr[H_OP]),
                         commit_number=int(hdr[H_COMMIT]))
        return FnVal(f.items())

    def _rec_msg_fields(self, d, r, j):
        if d["rec_has_log"][r - 1][j]:
            ceil = int(d["rec_ceil"][r - 1][j])
            return dict(prefix_ceil=ceil,
                        log_suffix=self._dec_log(
                            d["rec_log"][r - 1][j],
                            int(d["rec_op"][r - 1][j]) - ceil,
                            first_op=ceil + 1),
                        op_number=int(d["rec_op"][r - 1][j]),
                        commit_number=int(d["rec_commit"][r - 1][j]))
        return dict(log_suffix=self.nil)
