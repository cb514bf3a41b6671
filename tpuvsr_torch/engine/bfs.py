"""The result record of a model-checking run (a copy of
``tpuvsr/engine/bfs.py:CheckResult``)."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class CheckResult:
    ok: bool = True
    distinct_states: int = 0
    states_generated: int = 0
    diameter: int = 0
    violated_invariant: str = None
    deadlock_state: dict = None
    trace: list = field(default_factory=list)
    elapsed: float = 0.0
    states_per_sec: float = 0.0
    levels: list = None       # per-level frontier sizes, init included
    metrics: dict = None
    error: str = None
