"""TRACE.jsonl: the recorded-implementation-trace format.

One JSON object per line, one object per trace:

    {"trace": "t-0007",
     "init": {"x": "0", "y": "0"},
     "events": [{"action": "IncX", "vars": {"x": "1"}},
                {"vars": {"y": "1"}},
                {}]}

* ``trace`` — the trace id (optional; defaults to the line index);
* ``init``  — a PARTIAL observation of the initial state: the spec
  init states consistent with it form the starting candidate set
  (omitted/empty = every init state);
* ``events`` — one recorded event per implementation step.  Each may
  pin the ``action`` name and/or a partial ``vars`` assignment of the
  post-state; anything unpinned is unobserved, and the validator
  tracks every spec state consistent with the observations (the
  nondeterminism handling of arxiv 2404.16075).

Values are JSON ints/bools, or strings holding TLA+ expressions
(parsed and evaluated against the spec's constants, so model values
and structured values round-trip through ``core.values.fmt``).  This
module is the one place the format is read or written; the host and
batch validators both consume :class:`Trace` objects.

A copy of ``tpuvsr/validate/traces.py``: the port keeps its own, so that
it imports nothing of the JAX package.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

from ..core.values import TLAError, fmt


@dataclass
class TraceEvent:
    action: str = None     # recorded action name (None = unobserved)
    vars: dict = field(default_factory=dict)   # partial post-state

    def to_record(self):
        out = {}
        if self.action is not None:
            out["action"] = self.action
        if self.vars:
            out["vars"] = {k: fmt(v) for k, v in sorted(self.vars.items())}
        return out


@dataclass
class Trace:
    tid: str
    events: list                        # [TraceEvent, ...]
    init: dict = field(default_factory=dict)  # partial init observation

    def to_record(self):
        out = {"trace": self.tid,
               "events": [e.to_record() for e in self.events]}
        if self.init:
            out["init"] = {k: fmt(v)
                           for k, v in sorted(self.init.items())}
        return out


def _value_env(spec):
    """Model-value members of cfg-bound sets, bound by name (the
    trace_parse idiom) so trace expressions mentioning them evaluate."""
    from ..core.values import ModelValue
    from ..interp.evalr import EMPTY_ENV
    extra = {}
    for val in spec.cfg.constants.values():
        if isinstance(val, frozenset):
            for m in val:
                if isinstance(m, ModelValue):
                    extra[m.name] = m
    return EMPTY_ENV.extend(extra)


def _parse_value(spec, env, raw, where):
    if isinstance(raw, bool) or isinstance(raw, int):
        return raw
    if isinstance(raw, str):
        from ..frontend.parser import parse_expr_text
        from ..interp.evalr import EvalCtx
        try:
            return spec.ev.eval(parse_expr_text(raw), env, EvalCtx({}))
        except Exception as e:  # noqa: BLE001 — rewrap with location
            raise TLAError(f"{where}: cannot evaluate value {raw!r}: "
                           f"{type(e).__name__}: {e}")
    raise TLAError(f"{where}: unsupported value {raw!r} "
                   f"(use an int, a bool, or a TLA+ expression string)")


def _check_names(spec, trace):
    """A trace naming a variable or action the spec doesn't have must
    fail loudly, not vacuously accept (the trace_parse contract)."""
    varnames = set(spec.module.variables)
    actnames = {a.name for a in spec.actions}
    for k in trace.init:
        if k not in varnames:
            raise TLAError(f"trace {trace.tid}: init observation binds "
                           f"variable {k!r} unknown to the spec")
    for i, ev in enumerate(trace.events):
        if ev.action is not None and ev.action not in actnames:
            raise TLAError(f"trace {trace.tid} event {i}: action "
                           f"{ev.action!r} is not a spec action")
        for k in ev.vars:
            if k not in varnames:
                raise TLAError(f"trace {trace.tid} event {i}: binds "
                               f"variable {k!r} unknown to the spec")


def trace_from_record(rec, spec, default_tid=None):
    """One TRACE.jsonl object -> :class:`Trace` (values evaluated)."""
    if not isinstance(rec, dict):
        raise TLAError(f"trace record is {type(rec).__name__}, "
                       f"not an object")
    env = _value_env(spec)
    tid = str(rec.get("trace", default_tid if default_tid is not None
                      else "t-0"))
    init = {k: _parse_value(spec, env, v, f"trace {tid} init.{k}")
            for k, v in (rec.get("init") or {}).items()}
    events = []
    for i, ev in enumerate(rec.get("events") or []):
        if not isinstance(ev, dict):
            raise TLAError(f"trace {tid} event {i}: not an object")
        act = ev.get("action")
        if act == spec.next_name:
            # the composite next-state relation names no concrete
            # action: a recorded "Next" pins nothing — normalize to
            # action-unobserved so both validators treat it alike
            act = None
        events.append(TraceEvent(
            action=act,
            vars={k: _parse_value(spec, env, v,
                                  f"trace {tid} event {i}.{k}")
                  for k, v in (ev.get("vars") or {}).items()}))
    t = Trace(tid=tid, events=events, init=init)
    _check_names(spec, t)
    return t


def traces_from_records(records, spec):
    return [trace_from_record(r, spec, default_tid=f"t-{i:04d}")
            for i, r in enumerate(records)]


def load_traces(path, spec):
    """Parse + validate a TRACE.jsonl file into a list of Traces."""
    out = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError as e:
                raise TLAError(f"{path}:{i + 1}: not JSON: {e}")
            out.append(trace_from_record(rec, spec,
                                         default_tid=f"t-{i:04d}"))
    return out


def save_traces(path, records):
    """Write TRACE.jsonl records (dicts or Trace objects)."""
    with open(path, "w") as f:
        for r in records:
            if isinstance(r, Trace):
                r = r.to_record()
            f.write(json.dumps(r, sort_keys=True) + "\n")


def record_from_entries(entries, tid="t-0", drop_vars=(),
                        blank_every=None):
    """A TRACE.jsonl record from a ``TraceEntry`` list (a replayed
    counterexample, or a parsed reference trace dump) — the round-trip
    used by ``scripts/validate_demo.py``: a checker-produced trace is
    by construction spec-consistent, so validating it must accept.

    ``drop_vars`` removes variables from every observation (partial
    observation); ``blank_every=k`` blanks every k-th event entirely
    (action and vars — the fully-unobserved step that makes the
    candidate set grow)."""
    drop = set(drop_vars)
    init = {k: fmt(v) for k, v in sorted(entries[0].state.items())
            if k not in drop}
    events = []
    for n, e in enumerate(entries[1:]):
        if blank_every and (n + 1) % blank_every == 0:
            events.append({})
            continue
        ev = {"vars": {k: fmt(v) for k, v in sorted(e.state.items())
                       if k not in drop}}
        if e.action_name:
            ev["action"] = e.action_name
        if not ev["vars"]:
            del ev["vars"]
        events.append(ev)
    return {"trace": tid, "init": init, "events": events}
