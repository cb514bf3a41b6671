"""Interpreter-level trace validation: the reference semantics and
the batch validator's confirmer (a copy of ``tpuvsr/validate/host.py``).

Per recorded event, the candidate set (every spec state consistent
with the observations so far) is advanced through
``spec.successors``: a successor survives iff its producing action
matches the recorded one (when observed) and its state agrees with
the recorded partial assignment on every observed variable.  An empty
next candidate set IS the divergence — the implementation took a step
the spec does not allow — and the report carries the spec-side
enabled action set at that point (the dual of ``frontend.trace_parse
.replay_trace``, which asks the opposite question of a
checker-produced trace).

This path is fully general (any value type the interpreter handles);
``batch.py`` is the engine on the card, and calls back into this module
to confirm each divergence the card reports.  Left out of the copy: the
run observer (progress, journal), which the port does not have.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from ..core.values import TLAError


@dataclass
class ValidateResult:
    """Result of validating a batch of traces.  ``divergences`` holds
    one record per diverged trace, in trace order — bit-identical
    across mesh sizes, batch sizes, and rescue/resume seams (the
    acceptance contract); ``first_divergence`` is the headline."""

    ok: bool = True
    traces_checked: int = 0
    accepted: int = 0
    divergences: list = field(default_factory=list)
    elapsed: float = 0.0
    metrics: dict = None
    batch: int = 0
    error: str = None

    @property
    def first_divergence(self):
        return self.divergences[0] if self.divergences else None

    @property
    def traces_per_sec(self):
        return self.traces_checked / self.elapsed if self.elapsed > 0 \
            else 0.0


@dataclass
class HostVerdict:
    """Per-trace verdict of the interpreter validator."""

    tid: str
    ok: bool
    diverged_at: int = None     # event index of the divergence
    enabled: list = None        # [(action_name, location), ...] there
    candidates: int = 0         # candidate-set size at the divergence
    max_candidates: int = 1     # peak candidate-set size seen
    violated_invariant: str = None   # first invariant every candidate
    violated_at: int = None          # broke, and the event index


def _obs_matches(st, obs):
    """State agreement on every observed variable (names were already
    checked against the spec at trace load)."""
    for k, v in obs.items():
        if st[k] != v:
            return False
    return True


def _state_key(st):
    from ..core.values import value_key
    return tuple((k, value_key(v)) for k, v in sorted(st.items()))


def validate_trace(spec, trace, max_candidates=4096) -> HostVerdict:
    """Validate ONE trace against the spec (module docstring).  Raises
    ``TLAError`` when the candidate set exceeds ``max_candidates``
    (an under-observed trace of a wide spec — not a divergence)."""
    v = HostVerdict(tid=trace.tid, ok=True)
    cands = [st for st in spec.init_states()
             if _obs_matches(st, trace.init)]
    if not cands:
        v.ok = False
        v.diverged_at = 0
        v.enabled = []
        v.candidates = 0
        return v
    v.max_candidates = len(cands)
    for i, ev in enumerate(trace.events):
        nxt, seen, enabled = [], set(), {}
        for st in cands:
            for action, succ in spec.successors(st):
                enabled.setdefault(action.name, action.location)
                if ev.action is not None and action.name != ev.action:
                    continue
                if not _obs_matches(succ, ev.vars):
                    continue
                k = _state_key(succ)
                if k not in seen:
                    seen.add(k)
                    nxt.append(succ)
        if not nxt:
            v.ok = False
            v.diverged_at = i
            v.enabled = sorted(enabled.items())
            v.candidates = len(cands)
            return v
        if len(nxt) > max_candidates:
            raise TLAError(
                f"trace {trace.tid}: candidate set exceeds "
                f"{max_candidates} at event {i} — the trace is too "
                f"weakly observed to validate within bounds")
        cands = nxt
        v.max_candidates = max(v.max_candidates, len(cands))
        if v.violated_invariant is None:
            bads = [spec.check_invariants(st) for st in cands]
            if all(b is not None for b in bads):
                # every state consistent with the observations so far
                # violates an invariant: the implementation is in a
                # certainly-bad (if spec-reachable) state — reported
                # as metadata, conformance checking continues
                v.violated_invariant = bads[0]
                v.violated_at = i
    return v


def divergence_record(trace, verdict):
    """The JSON-able divergence report (one stable shape shared with
    the batch validator's device-derived records)."""
    step = verdict.diverged_at
    ev = (trace.events[step].to_record()
          if step is not None and step < len(trace.events) else {})
    rec = {"trace": trace.tid, "step": int(step),
           "event": ev,
           "enabled": [{"action": a, "location": loc}
                       for a, loc in (verdict.enabled or [])],
           "candidates": int(verdict.candidates)}
    if step == 0 and verdict.candidates == 0 and not verdict.enabled:
        rec["reason"] = "no-init-state"
    if verdict.violated_invariant:
        rec["invariant"] = verdict.violated_invariant
        rec["invariant_step"] = verdict.violated_at
    return rec


def host_validate_batch(spec, traces, *, log=None, max_seconds=None,
                        max_candidates=4096) -> ValidateResult:
    """Validate a whole batch through the interpreter: the engine for
    specs without a device kernel (or with observations the codec
    cannot encode), and the semantic oracle the batch engine's tests
    compare against."""
    res = ValidateResult(batch=len(traces))
    t0 = time.time()
    deadline = (t0 + max_seconds) if max_seconds else None
    for n, trace in enumerate(traces):
        verdict = validate_trace(spec, trace,
                                 max_candidates=max_candidates)
        res.traces_checked += 1
        if verdict.ok:
            res.accepted += 1
        else:
            res.divergences.append(divergence_record(trace, verdict))
        if log is not None and ((n + 1) % 64 == 0 or n + 1 == len(traces)):
            log(f"validate-host: {res.traces_checked} traces, "
                f"{len(res.divergences)} divergence(s)")
        if deadline is not None and time.time() > deadline:
            res.error = "deadline"
            break
    # a deadline stop is an incomplete run, not a divergence: res.error
    # says so; ok mirrors the BFS time-budget contract
    res.ok = not res.divergences
    res.elapsed = time.time() - t0
    return res
