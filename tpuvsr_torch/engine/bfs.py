"""Breadth-first exhaustive model checking on the interpreter, and the
result record of a model-checking run (a copy of
``tpuvsr/engine/bfs.py``).

``bfs_check`` is TLC's BFS worker loop on one host: dequeue, enumerate
the successors over every Next disjunct, check the invariants, project
through VIEW, fold symmetry, deduplicate on the exact canonical view
value and enqueue, with parent pointers for the trace.  It is the
oracle of the device engines.  Left out of the copy: the speclint gate
(``preflight``), the run observer and the fault-injection point, whose
modules the port does not have.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from ..core.values import TLAError
from .trace import reconstruct_trace


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


def bfs_check(spec, check_deadlock: bool = False, max_states: int = None,
              log=None) -> CheckResult:
    """Exhaustive BFS of ``spec`` (an ``engine/spec.SpecModel``) on the
    interpreter; stops at the first violated invariant (with its trace),
    at a deadlock when ``check_deadlock``, or at ``max_states``."""
    res = CheckResult()
    t0 = time.time()
    seen = {}           # canonical view value -> state id
    parents = {}        # state id -> (parent id, action name, location)
    states = []         # state id -> state dict (kept for the trace)
    frontier = []
    level_sizes = []

    def finish(depth):
        res.distinct_states = len(states)
        res.diameter = depth
        res.levels = list(level_sizes)
        res.elapsed = time.time() - t0
        res.states_per_sec = res.states_generated / max(res.elapsed, 1e-9)
        if log is not None:
            log(f"bfs: {res.distinct_states} distinct, "
                f"{res.states_generated} generated, depth {depth}")
        return res

    def register(state, parent_id, action):
        key = spec.view_value(state)
        sid = seen.get(key)
        if sid is None:
            sid = len(states)
            seen[key] = sid
            states.append(state)
            parents[sid] = (parent_id, action.name if action else None,
                            action.location if action else None)
            return sid, True
        return sid, False

    depth = 0
    try:
        for st in spec.init_states():
            res.states_generated += 1
            sid, fresh = register(st, None, None)
            if fresh:
                bad = spec.check_invariants(st)
                if bad:
                    res.ok = False
                    res.violated_invariant = bad
                    res.trace = reconstruct_trace(sid, parents, states)
                    return finish(depth)
                frontier.append(sid)
        level_sizes.append(len(frontier))

        while frontier:
            depth += 1
            next_frontier = []
            for sid in frontier:
                state = states[sid]
                n_succ = 0
                for action, succ in spec.successors(state):
                    n_succ += 1
                    res.states_generated += 1
                    tid, fresh = register(succ, sid, action)
                    if fresh:
                        bad = spec.check_invariants(succ)
                        if bad:
                            res.ok = False
                            res.violated_invariant = bad
                            res.trace = reconstruct_trace(tid, parents,
                                                          states)
                            return finish(depth)
                        next_frontier.append(tid)
                if n_succ == 0 and check_deadlock:
                    res.ok = False
                    res.error = "deadlock"
                    res.deadlock_state = state
                    res.trace = reconstruct_trace(sid, parents, states)
                    return finish(depth)
                if max_states and len(states) >= max_states:
                    res.error = f"state limit {max_states} reached"
                    return finish(depth)
            if next_frontier:
                level_sizes.append(len(next_frontier))
            frontier = next_frontier
    except TLAError as e:
        res.ok = False
        res.error = str(e)
    return finish(depth)
