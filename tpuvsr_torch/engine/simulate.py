"""The result record of a simulation run (a copy of
``tpuvsr/engine/simulate.py:SimResult``)."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class SimResult:
    ok: bool = True
    walks: int = 0
    steps: int = 0
    violated_invariant: str = None
    trace: list = field(default_factory=list)
    elapsed: float = 0.0
    deadlocks: int = 0
    metrics: dict = None      # {"gauges": ..., "counters": ...}
    walkers: int = 0          # fleet size of the run (sim/fleet.py)

