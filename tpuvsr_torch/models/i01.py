"""Dense state layout for VR_INC_RESEND (reference: I01,
analysis/01-view-changes/VR_INC_RESEND.tla).

A copy of ``tpuvsr/models/i01.py`` (``I01Codec``).

I01 is the increment-mode sibling of A01 (a view change always adopts
``View(r)+1``, I01:455/572) with SVC resends.  Layout deltas over A01:

* ``rep_sent_svc`` (I01:78): a third sent flag gating ResendSVC and
  NotInPhaseSVC (I01:416-419).
* ``rep_recv_dvc`` (I01:82): a DVC tracker set with replacement
  semantics: UpdateDVCsTracker (I01:245-250) drops the entries below the
  new view and any earlier entry from the same source before it adds
  the carrier.  So there is at most one entry per source, and dense
  [dest, source] slots suffice; but entries carry mixed views (SendSV
  adopts HighestViewNumber, I01:614-620), so each slot stores its own
  view.
* log entries are A01's packed records (``vid << 8 | view``).
"""

from __future__ import annotations

import numpy as np

from ..core.values import FnVal, TLAError
from .a01 import A01Codec


class I01Codec(A01Codec):
    def plane_bounds(self, ranges):
        b = super().plane_bounds(ranges)
        s = self.shape
        view = self._range_hi(ranges, "view_number", s.MAX_VIEW)
        ops = self._range_hi(ranges, "op_number", s.MAX_OPS)
        ent = self._entry_code_hi(view)
        b.update({
            "sent_svc": (0, 1),
            "dvc": (0, 1), "dvc_view": (0, view),
            "dvc_lnv": (0, view), "dvc_op": (0, ops),
            "dvc_commit": (0, ops), "dvc_log": (0, ent),
        })
        return b

    def zero_state(self):
        d = super().zero_state()
        s = self.shape
        z = lambda *sh: np.zeros(sh, np.int32)
        d["sent_svc"] = z(s.R)
        d["dvc"] = z(s.R, s.R)
        d["dvc_view"] = z(s.R, s.R)
        d["dvc_lnv"] = z(s.R, s.R)
        d["dvc_op"] = z(s.R, s.R)
        d["dvc_commit"] = z(s.R, s.R)
        d["dvc_log"] = z(s.R, s.R, s.MAX_OPS)
        return d

    def encode(self, st: dict):
        d = self._encode_common(st)
        s = self.shape
        for r in range(1, s.R + 1):
            i = r - 1
            d["sent_svc"][i] = 1 if st["rep_sent_svc"].apply(r) else 0
            for m in st["rep_recv_dvc"].apply(r):
                if m.apply("dest") != r:
                    raise TLAError("recv_dvc dest invariant violated")
                j = m.apply("source") - 1
                if d["dvc"][i][j]:
                    raise TLAError("DVC tracker slot collision "
                                   "(replacement semantics violated)")
                d["dvc"][i][j] = 1
                d["dvc_view"][i][j] = m.apply("view_number")
                d["dvc_lnv"][i][j] = m.apply("last_normal_vn")
                d["dvc_op"][i][j] = m.apply("op_number")
                d["dvc_commit"][i][j] = m.apply("commit_number")
                d["dvc_log"][i][j] = self._enc_log(m.apply("log"))
        return d

    def decode(self, d: dict):
        st = super().decode(d)
        d = {k: np.asarray(v) for k, v in d.items()}
        s = self.shape
        reps = range(1, s.R + 1)
        st["rep_sent_svc"] = FnVal((r, bool(d["sent_svc"][r - 1]))
                                   for r in reps)
        dvc_mv = self.constants["DoViewChangeMsg"]
        st["rep_recv_dvc"] = FnVal(
            (r, frozenset(
                FnVal([("type", dvc_mv),
                       ("view_number", int(d["dvc_view"][r - 1][j])),
                       ("log", self._dec_log(d["dvc_log"][r - 1][j],
                                             d["dvc_op"][r - 1][j])),
                       ("last_normal_vn", int(d["dvc_lnv"][r - 1][j])),
                       ("op_number", int(d["dvc_op"][r - 1][j])),
                       ("commit_number", int(d["dvc_commit"][r - 1][j])),
                       ("dest", r), ("source", j + 1)])
                for j in range(s.R) if d["dvc"][r - 1][j]))
            for r in reps)
        return st
