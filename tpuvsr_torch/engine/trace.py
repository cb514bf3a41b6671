"""Counterexample trace entries, their reconstruction and the
TLC-style printers (a copy of ``tpuvsr/engine/trace.py``).

``format_trace_te`` emits the reference's ``_TEAction`` record format,
which ``frontend/trace_parse.py`` reads back; ``format_trace`` the
``State n: <Action location>`` form TLC prints.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..core.values import fmt


@dataclass
class TraceEntry:
    position: int          # 1-based
    action_name: str       # None for the initial state
    location: str
    state: dict


def reconstruct_trace(sid, parents, states):
    """The path from an initial state to ``sid`` through ``parents``
    (state id -> (parent id, action name, action location))."""
    chain = []
    cur = sid
    while cur is not None:
        parent, aname, aloc = parents[cur]
        chain.append((cur, aname, aloc))
        cur = parent
    chain.reverse()
    return [TraceEntry(position=i + 1, action_name=aname, location=aloc,
                       state=states[s])
            for i, (s, aname, aloc) in enumerate(chain)]


def format_trace_te(trace, varnames=None) -> str:
    """A trace in the reference's ``_TEAction`` record format (the format
    ``frontend.trace_parse`` reads back)."""
    blocks = []
    for e in trace:
        name = e.action_name or "Initial predicate"
        loc = e.location or "Unknown location"
        lines = ["[", " _TEAction |-> [",
                 f"   position |-> {e.position},",
                 f'   name |-> "{name}",',
                 f'   location |-> "{loc}"', " ],"]
        names = varnames or sorted(e.state)
        lines.append(",\n".join(f"{n} |-> {fmt(e.state[n])}"
                                for n in names))
        lines.append("]")
        blocks.append("\n".join(lines))
    return "<<\n" + ",\n".join(blocks) + "\n>>\n"


def format_trace(trace, varnames=None) -> str:
    """A trace as TLC prints one: ``State n: <Action location>`` and the
    variables as a conjunction."""
    lines = []
    for e in trace:
        if e.action_name is None:
            header = f"State {e.position}: <Initial predicate>"
        else:
            header = (f"State {e.position}: "
                      f"<{e.action_name} {e.location or ''}>".rstrip() + ">")
            header = header.replace(">>", ">")
        lines.append(header)
        names = varnames or sorted(e.state)
        lines.append("/\\ " + "\n/\\ ".join(
            f"{n} = {fmt(e.state[n])}" for n in names))
        lines.append("")
    return "\n".join(lines)
