"""TLA+ value domain of the model checker.

Implements the value universe exercised by the reference corpus
(the vsr-revisited specs): booleans, naturals/integers, strings,
model values (cfg-bound CONSTANTS such as Nil/Normal/v1), finite sets,
and functions.  Records, sequences, and the message bag are all TLA+
functions (records = functions over string domains, sequences = functions
over 1..n), so a single immutable ``FnVal`` covers them — this mirrors TLC
value semantics (e.g. ``<<>> = [x \\in {} |-> x]`` and the non-1-based log
slices built at VSR.tla:535).

Determinism requirements (SURVEY.md §2.7.5): every ``CHOOSE`` must return
the same element for the same set across evaluations, and symmetry
canonicalization needs a total order on values.  ``value_key`` provides a
canonical total order over the whole universe.

A copy of ``tpuvsr/core/values.py``: the port keeps its own, so that it
imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Any, Iterable, Tuple


class ModelValue:
    """An uninterpreted model value bound in a .cfg (e.g. ``Nil``, ``v1``).

    Interned: identity comparison is value comparison.  TLC semantics: a
    model value is equal only to itself and unequal to every other value.
    """

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

    # Equality is identity (interned); default object eq suffices.


class FnVal:
    """An immutable TLA+ function: finite mapping from values to values.

    Stored as a tuple of (key, value) pairs sorted by ``value_key`` of the
    key, giving canonical equality/hash regardless of construction order.
    Covers records ([a |-> 1]), sequences (<<a, b>> with domain 1..n),
    logs with arbitrary integer domains, and the message bag
    (message-record -> pending-delivery count, VSR.tla:228-245).
    """

    __slots__ = ("items", "_map", "_hash", "_key")

    def __init__(self, pairs: Iterable[Tuple[Any, Any]]):
        m = dict(pairs)
        self._map = m
        self.items = tuple(sorted(m.items(), key=lambda kv: value_key(kv[0])))
        self._hash = None
        self._key = None

    @staticmethod
    def empty() -> "FnVal":
        return _EMPTY_FN

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

    # --- TLA+ operations -------------------------------------------------

    def domain(self) -> frozenset:
        return frozenset(self._map)

    def has_key(self, k: Any) -> bool:
        return k in self._map

    def apply(self, k: Any) -> Any:
        try:
            return self._map[k]
        except KeyError:
            raise TLAError(f"function applied outside domain: {fmt(self)}[{fmt(k)}]")

    def get(self, k: Any, default: Any = None) -> Any:
        return self._map.get(k, default)

    def updated(self, k: Any, v: Any) -> "FnVal":
        m = dict(self._map)
        m[k] = v
        return FnVal(m.items())

    def merge_left(self, other: "FnVal") -> "FnVal":
        """``self @@ other`` — left-biased merge (TLC module semantics)."""
        m = dict(other._map)
        m.update(self._map)
        return FnVal(m.items())

    # --- sequence view ---------------------------------------------------

    def is_sequence(self) -> bool:
        n = len(self._map)
        if n == 0:
            return True
        return all(isinstance(k, int) for k in self._map) and \
            frozenset(self._map) == frozenset(range(1, n + 1))

    def seq_len(self) -> int:
        # Len() in TLC requires a sequence; corpus only calls it on 1..n logs.
        return len(self._map)

    def seq_elems(self) -> list:
        return [self._map[i] for i in range(1, len(self._map) + 1)]

    def seq_append(self, v: Any) -> "FnVal":
        n = len(self._map)
        m = dict(self._map)
        m[n + 1] = v
        return FnVal(m.items())

    def __repr__(self) -> str:
        return fmt(self)


_EMPTY_FN = FnVal(())


class TLAError(Exception):
    """Evaluation error (e.g. applying a function outside its domain).

    The reference relies on lazy evaluation to keep some of these latent
    (SURVEY.md §2.7.1: the dead ``m.commit`` at VSR.tla:421); an eager
    engine must only raise when the faulty expression is actually reached.
    """


def mk_seq(elems: Iterable[Any]) -> FnVal:
    return FnVal((i + 1, v) for i, v in enumerate(elems))


def mk_record(**fields: Any) -> FnVal:
    return FnVal(fields.items())


_TYPE_RANK = {bool: 0, int: 1, str: 2, ModelValue: 3, frozenset: 4, FnVal: 5}


def value_key(v: Any):
    """Canonical total-order key across the whole value universe.

    Used for: deterministic CHOOSE (min element satisfying the predicate is
    NOT what TLC does — TLC picks the first in its internal normalized
    order; we define our own stable order, which is all the determinism the
    semantics require), FnVal canonical item order, set ordering, and
    symmetry canonicalization (min over permutations).
    """
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
        ks = sorted(value_key(x) for x in v)
        return (4, tuple(ks))
    if t is FnVal:
        k = v._key
        if k is None:
            k = v._key = (5, tuple((value_key(a), value_key(b)) for a, b in v.items))
        return k
    raise TLAError(f"unorderable value type: {t!r}")


def tla_eq(a: Any, b: Any) -> bool:
    """TLA+ equality.  Cross-type comparisons are FALSE (TLC is permissive
    for model values vs anything; we extend that to all type mismatches,
    which is sound for this corpus, e.g. ``m.log # Nil`` at VSR.tla:882)."""
    ta, tb = type(a), type(b)
    if ta is bool or tb is bool:
        return (ta is bool and tb is bool) and a == b
    if ta is int and tb is int:
        return a == b
    if ta is not tb:
        return False
    return a == b


def fmt(v: Any) -> str:
    """Pretty-print a value in TLC trace style (TRACE:8-24 format)."""
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
            return "[" + ", ".join(f"{k} |-> {fmt(x)}" for k, x in v.items) + "]"
        return "(" + " @@ ".join(f"{fmt(k)} :> {fmt(x)}" for k, x in v.items) + ")"
    return repr(v)


def permute_value(v: Any, mapping: dict) -> Any:
    """Apply a model-value permutation (symmetry reduction, VSR.tla:151)
    recursively through sets, function domains, and function values."""
    t = type(v)
    if t is ModelValue:
        return mapping.get(v, v)
    if t is frozenset:
        return frozenset(permute_value(e, mapping) for e in v)
    if t is FnVal:
        return FnVal((permute_value(k, mapping), permute_value(x, mapping))
                     for k, x in v.items)
    return v
