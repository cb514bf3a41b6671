"""Dense state layout for VR_APP_STATE (reference: AS04,
analysis/04-application-state/VR_APP_STATE.tla).

A copy of ``tpuvsr/models/as04.py`` (``ERR_DVC_OVERFLOW``,
``AS04Codec``).

AS04 is the ST03 protocol (state transfer as a status, AnyDest,
bag-tombstone SVC quorums) with three additions and one swap:

* ``rep_app_state`` (AS04:74): the executed-ops log.  Every
  commit-advancing path appends ``log[old_commit+1..new_commit]``
  through the recursive ``AppendOps`` executor (AS04:270-282), so
  ``Len(rep_app_state[r]) = rep_commit_number[r]`` holds and the app
  plane needs no length column.
* ``rep_recv_dvc`` (AS04:83): DVCs are counted from a per-replica set
  (as in VSR), not from bag tombstones: dense [dest, source] slots with
  the view (View(dest)) and dest implied, reset on every view adoption
  (AS04:560, 582, 666, 782) and seeded with the carrier by
  ReceiveHigherDVC (AS04:667).
* the recovery variables are declared but frozen (``rep_rec_number``,
  ``rep_rec_recv`` and ``aux_restart`` keep their Init values: Next
  has no recovery action, AS04:811-831); the codec checks them instead
  of storing them.
* ``ExecuteOp`` becomes ``PrimaryExecuteOp`` (AS04:420-437).
"""

from __future__ import annotations

import numpy as np

from ..core.values import FnVal, TLAError
from .st03 import ST03Codec

ERR_DVC_OVERFLOW = 2


class AS04Codec(ST03Codec):
    """ST03 codec + app plane + DVC slots + frozen-recovery checks."""

    def plane_bounds(self, ranges):
        b = super().plane_bounds(ranges)
        s = self.shape
        view = self._range_hi(ranges, "view_number", s.MAX_VIEW)
        ops = self._range_hi(ranges, "op_number", s.MAX_OPS)
        ent = self._entry_code_hi(view)
        b.update({
            "app": (0, ent),
            "dvc": (0, 1), "dvc_lnv": (0, view), "dvc_op": (0, ops),
            "dvc_commit": (0, ops), "dvc_log": (0, ent),
        })
        return b

    def zero_state(self):
        d = super().zero_state()
        s = self.shape
        z = lambda *sh: np.zeros(sh, np.int32)
        d["app"] = z(s.R, s.MAX_OPS)
        d["dvc"] = z(s.R, s.R)
        d["dvc_lnv"] = z(s.R, s.R)
        d["dvc_op"] = z(s.R, s.R)
        d["dvc_commit"] = z(s.R, s.R)
        d["dvc_log"] = z(s.R, s.R, s.MAX_OPS)
        return d

    def encode(self, st: dict):
        d = super()._encode_common(st)
        s = self.shape
        for r in range(1, s.R + 1):
            i = r - 1
            app = st["rep_app_state"].apply(r)
            if len(app) != int(d["commit"][i]):
                raise TLAError("AS04 layout invariant violated: "
                               "Len(rep_app_state) != rep_commit_number")
            d["app"][i] = self._enc_log(app)
            self._encode_rec(st, d, r)
            for m in st["rep_recv_dvc"].apply(r):
                if m.apply("view_number") != int(d["view"][i]) or \
                        m.apply("dest") != r:
                    raise TLAError("recv_dvc implied-field invariant "
                                   "violated")
                j = m.apply("source") - 1
                if d["dvc"][i][j]:
                    raise TLAError("DVC slot collision")
                d["dvc"][i][j] = 1
                d["dvc_lnv"][i][j] = m.apply("last_normal_vn")
                d["dvc_op"][i][j] = m.apply("op_number")
                d["dvc_commit"][i][j] = m.apply("commit_number")
                d["dvc_log"][i][j] = self._enc_log(m.apply("log"))
        self._encode_aux_restart(st, d)
        return d

    def _encode_rec(self, st, d, r):
        """AS04 declares the recovery variables but has no recovery
        action (AS04:811-831): they must keep their Init values."""
        if st["rep_rec_number"].apply(r) != 0 or \
                len(st["rep_rec_recv"].apply(r)) != 0:
            raise TLAError("AS04 recovery vars must stay at Init")

    def _encode_aux_restart(self, st, d):
        if st["aux_restart"] != 0:
            raise TLAError("AS04 aux_restart must stay 0")

    def decode(self, d: dict):
        st = super().decode(d)
        d = {k: np.asarray(v) for k, v in d.items()}
        s = self.shape
        reps = range(1, s.R + 1)
        st["rep_app_state"] = FnVal(
            (r, self._dec_log(d["app"][r - 1], d["commit"][r - 1]))
            for r in reps)
        dvc_mv = self.constants["DoViewChangeMsg"]
        st["rep_recv_dvc"] = FnVal(
            (r, frozenset(
                FnVal([("type", dvc_mv),
                       ("view_number", int(d["view"][r - 1])),
                       ("log", self._dec_log(d["dvc_log"][r - 1][j],
                                             d["dvc_op"][r - 1][j])),
                       ("last_normal_vn", int(d["dvc_lnv"][r - 1][j])),
                       ("op_number", int(d["dvc_op"][r - 1][j])),
                       ("commit_number", int(d["dvc_commit"][r - 1][j])),
                       ("dest", r), ("source", j + 1)])
                for j in range(s.R) if d["dvc"][r - 1][j]))
            for r in reps)
        st["rep_rec_number"] = FnVal((r, 0) for r in reps)
        st["rep_rec_recv"] = FnVal((r, frozenset()) for r in reps)
        st["aux_restart"] = 0
        return st
