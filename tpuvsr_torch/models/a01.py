"""Dense state layout for VR_ASSUME_NEWVIEWCHANGE (reference: A01,
analysis/01-view-changes/VR_ASSUME_NEWVIEWCHANGE.tla).

A copy of ``tpuvsr/models/a01.py`` (``ENTRY_VIEW_BITS``, ``A01Codec``).

A01 is the ST03 protocol machinery without state transfer (13 actions,
A01:661-677): the same bag-tombstone quorums, SendAsReceived self-DVCs,
bag-CHOOSE HighestLog and NoProgressChange.  Layout deltas:

* log entries carry [view_number, operation, client_id=Nil]
  (A01:104-107, created at A01:287-289), packed into one int as
  ``value_id << 8 | view_number`` so the ST03 layout is reused
  unchanged.  The packing keeps the interpreter's ``value_key`` record
  order (client_id, a constant Nil, then operation, then view_number),
  so CHOOSE tie-breaks over logs compare the same way.
* five message kinds (no GetState/NewState), two statuses (no
  StateTransfer) and no AnyDest: the cfg declares none of them, and
  ``ST03Codec`` builds its status and message tables from what the cfg
  declares.
"""

from __future__ import annotations

from ..core.values import FnVal, TLAError, mk_record
from .st03 import ST03Codec

ENTRY_VIEW_BITS = 8     # view_number < 256 (MAX_VIEW = 1 + timer limit)


class A01Codec(ST03Codec):
    def __init__(self, constants, shape=None, max_msgs=None):
        super().__init__(constants, shape=shape, max_msgs=max_msgs)
        if self.shape.MAX_VIEW >= 1 << ENTRY_VIEW_BITS:
            raise TLAError(
                f"A01 packed entries need MAX_VIEW < {1 << ENTRY_VIEW_BITS}"
                f" (StartViewOnTimerLimit too large)")

    def _entry_code_hi(self, view_hi):
        # packed entries: value_id << ENTRY_VIEW_BITS | view_number
        return (self.shape.V << ENTRY_VIEW_BITS) | view_hi

    def _enc_entry(self, e: FnVal) -> int:
        return (self.value_id[e.apply("operation")] << ENTRY_VIEW_BITS) \
            | e.apply("view_number")

    def _dec_entry(self, code):
        code = int(code)
        return mk_record(view_number=code & ((1 << ENTRY_VIEW_BITS) - 1),
                         operation=self.values[(code >> ENTRY_VIEW_BITS) - 1],
                         client_id=self.nil)
