"""TLA+ values used by the state codecs and the cfg parser.

A copy of the part of ``tpuvsr/core/values.py`` that the dense codecs
and ``frontend/cfg.py`` need: model values, immutable functions
(records, sequences, the message bag), the canonical total order
``value_key`` and the TLC-style printer ``fmt``.  The port keeps its own
copy so that it imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Any, Iterable, Tuple


class TLAError(Exception):
    """A spec, cfg or layout error (for example a binding the dense
    layout cannot hold)."""


class ModelValue:
    """An uninterpreted model value bound in a .cfg (e.g. ``Nil``, ``v1``).

    Interned: identity comparison is value comparison."""

    _interned: dict = {}
    __slots__ = ("name",)

    def __new__(cls, name: str) -> "ModelValue":
        mv = cls._interned.get(name)
        if mv is None:
            mv = object.__new__(cls)
            mv.name = name
            cls._interned[name] = mv
        return mv

    def __repr__(self) -> str:
        return self.name

    def __hash__(self) -> int:
        return hash(("MV", self.name))


class FnVal:
    """An immutable TLA+ function, stored as (key, value) pairs sorted by
    ``value_key`` of the key (canonical equality and hash)."""

    __slots__ = ("items", "_map", "_hash", "_key")

    def __init__(self, pairs: Iterable[Tuple[Any, Any]]):
        m = dict(pairs)
        self._map = m
        self.items = tuple(sorted(m.items(), key=lambda kv: value_key(kv[0])))
        self._hash = None
        self._key = None

    def __len__(self) -> int:
        return len(self.items)

    def __hash__(self) -> int:
        h = self._hash
        if h is None:
            h = self._hash = hash(self.items)
        return h

    def __eq__(self, other: Any) -> bool:
        if self is other:
            return True
        if not isinstance(other, FnVal):
            return False
        return self.items == other.items

    def __ne__(self, other: Any) -> bool:
        return not self.__eq__(other)

    def domain(self) -> frozenset:
        return frozenset(self._map)

    def apply(self, k: Any) -> Any:
        try:
            return self._map[k]
        except KeyError:
            raise TLAError(
                f"function applied outside domain: {fmt(self)}[{fmt(k)}]")

    def get(self, k: Any, default: Any = None) -> Any:
        return self._map.get(k, default)

    def is_sequence(self) -> bool:
        n = len(self._map)
        if n == 0:
            return True
        return all(isinstance(k, int) for k in self._map) and \
            frozenset(self._map) == frozenset(range(1, n + 1))

    def seq_elems(self) -> list:
        return [self._map[i] for i in range(1, len(self._map) + 1)]

    def __repr__(self) -> str:
        return fmt(self)


def mk_record(**fields: Any) -> FnVal:
    return FnVal(fields.items())


def value_key(v: Any):
    """Canonical total-order key across the value universe."""
    t = type(v)
    if t is bool:
        return (0, v)
    if t is int:
        return (1, v)
    if t is str:
        return (2, v)
    if t is ModelValue:
        return (3, v.name)
    if t is frozenset:
        return (4, tuple(sorted(value_key(x) for x in v)))
    if t is FnVal:
        k = v._key
        if k is None:
            k = v._key = (5, tuple((value_key(a), value_key(b))
                                   for a, b in v.items))
        return k
    raise TLAError(f"unorderable value type: {t!r}")


def fmt(v: Any) -> str:
    """Print a value in TLC trace style."""
    t = type(v)
    if t is bool:
        return "TRUE" if v else "FALSE"
    if t is int:
        return str(v)
    if t is str:
        return f'"{v}"'
    if t is ModelValue:
        return v.name
    if t is frozenset:
        elems = sorted(v, key=value_key)
        return "{" + ", ".join(fmt(e) for e in elems) + "}"
    if t is FnVal:
        if len(v) == 0:
            return "<<>>"
        if v.is_sequence():
            return "<<" + ", ".join(fmt(e) for e in v.seq_elems()) + ">>"
        if all(isinstance(k, str) for k in v.domain()):
            return "[" + ", ".join(f"{k} |-> {fmt(x)}"
                                   for k, x in v.items) + "]"
        return "(" + " @@ ".join(f"{fmt(k)} :> {fmt(x)}"
                                 for k, x in v.items) + ")"
    return repr(v)
