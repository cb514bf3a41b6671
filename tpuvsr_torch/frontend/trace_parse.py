"""TLC counterexample-trace parser and replayer.

Reads the TLC trace artifact format — a ``<< ... >>`` sequence of state
records, each carrying a ``_TEAction |-> [position, name, location]``
header followed by the full variable assignment
(the reference's state_transfer_violation_trace.txt:3-26) — into
interpreter states, so recorded TLC counterexamples become golden
regression oracles: `replay_trace` re-executes the action sequence
through this framework's successor enumeration and fails loudly if any
recorded transition is not reproducible.

A trace may have been recorded against an older revision of the spec
(the reference's state-transfer trace predates VSR.tla's recovery
variables), so states are compared only on the variables the trace
actually binds; variables the trace omits are carried from the
replayed state.

A copy of ``tpuvsr/frontend/trace_parse.py``: the port keeps its own, so that it imports
nothing of the JAX package.
"""

from __future__ import annotations

import re

from ..core.values import ModelValue, TLAError
from ..engine.trace import TraceEntry
from ..interp.evalr import EMPTY_ENV, EvalCtx
from .parser import parse_expr_text

_NIL_LOCATION = "Unknown location"


def _model_value_env(cfg):
    """Members of cfg-bound model-value *sets* (e.g. v1 in
    ``Values = {v1, v2, v3}``) are not constants themselves; bind them
    by name so trace expressions mentioning them evaluate."""
    extra = {}
    for val in cfg.constants.values():
        if isinstance(val, frozenset):
            for m in val:
                if isinstance(m, ModelValue):
                    extra[m.name] = m
    return EMPTY_ENV.extend(extra)


def parse_trace_text(text: str, spec) -> list:
    """Parse a TLC trace dump into ``TraceEntry`` rows whose states are
    interpreter value dicts (only the variables the trace binds)."""
    body = text.strip()
    if not body.startswith("<<") or not body.rstrip().endswith(">>"):
        raise TLAError("not a TLC trace dump (expected << ... >>)")
    body = body[2:].rstrip()[:-2]
    parts = re.split(r"\],\s*\n\[", body)
    env = _model_value_env(spec.cfg)
    ctx = EvalCtx({})
    out = []
    for p in parts:
        p = p.strip()
        if not p.startswith("["):
            p = "[" + p
        if not p.endswith("]"):
            p = p + "]"
        rec = spec.ev.eval(parse_expr_text(p), env, ctx)
        te = rec.apply("_TEAction")
        name = te.apply("name")
        loc = te.apply("location")
        out.append(TraceEntry(
            position=te.apply("position"),
            action_name=None if name == "Initial predicate" else name,
            location=None if loc == _NIL_LOCATION else loc,
            state={k: v for k, v in rec.items if k != "_TEAction"}))
    return out


def parse_trace_file(path: str, spec) -> list:
    with open(path) as f:
        return parse_trace_text(f.read(), spec)


def _matches(st: dict, recorded: dict, position) -> bool:
    """State agreement on every trace-bound variable.  A trace variable
    the spec doesn't declare is an error, not a vacuous match — a trace
    from a mismatched spec must not 'replay' by comparing nothing."""
    for k, v in recorded.items():
        if k not in st:
            raise TLAError(
                f"trace position {position}: trace binds variable {k!r} "
                f"unknown to the spec")
        if st[k] != v:
            return False
    return True


def replay_trace(spec, entries) -> list:
    """Re-execute a parsed trace through the interpreter.

    For each recorded step, search the current state's successors for
    one produced by the recorded action whose state agrees with the
    recorded one on every trace-bound variable.  Since the trace may
    omit variables (older-spec recordings), several successors can
    agree on the recorded projection while diverging on omitted ones —
    the search backtracks across those choices rather than committing
    greedily.  Returns the list of full replayed interpreter states
    (including variables the trace omits).  Raises TLAError when no
    choice sequence matches — i.e. the framework's semantics diverge
    from TLC's on this trace.
    """
    inits = [st for st in spec.init_states()
             if _matches(st, entries[0].state, entries[0].position)]
    if not inits:
        raise TLAError("trace initial state is not an Init state")
    deepest = [entries[0].position]

    def extend(cur, i):
        if i == len(entries):
            return [cur]
        e = entries[i]
        for action, succ in spec.successors(cur):
            if action.name == e.action_name and \
                    _matches(succ, e.state, e.position):
                deepest[0] = max(deepest[0], e.position)
                rest = extend(succ, i + 1)
                if rest is not None:
                    return [cur] + rest
        return None

    for st in inits:
        out = extend(st, 1)
        if out is not None:
            return out
    raise TLAError(
        f"trace does not replay: no successor via "
        f"{entries[deepest[0]].action_name if deepest[0] < len(entries) else '?'} "
        f"matches the recorded state at position {deepest[0] + 1}")
