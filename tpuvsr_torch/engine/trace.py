"""Counterexample trace entries (a copy of
``tpuvsr/engine/trace.py:TraceEntry``)."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class TraceEntry:
    position: int          # 1-based
    action_name: str       # None for the initial state
    location: str
    state: dict
