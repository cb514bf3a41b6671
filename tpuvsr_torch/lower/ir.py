"""Guarded-command IR extraction (SURVEY.md §7.4 `ir/`).

A reference action is uniformly shaped (SURVEY.md §2.2):

    \\E r \\in replicas [, m \\in DOMAIN messages, v \\in Values, ...] :
        guard conjuncts /\\ primed updates /\\ UNCHANGED frame

This module turns a parsed action expression (frontend/parser.py AST)
into an ``ActionIR``: the ordered LANE BINDERS (the existentials the
device kernel enumerates as one lane per combination) plus the body
conjunct tree, with utilities the lowerer (lower/compile.py) uses to
classify conjuncts as guards vs. updates.

Only the *top-level* existential chain is lifted into lane binders —
quantifiers inside guards (Quantify lambdas, CHOOSE maximality checks)
stay expression-level and are vectorized by the lowerer instead.

A copy of ``tpuvsr/lower/ir.py`` (the port takes nothing else of
``lower/`` yet): the analysis passes read ``contains_prime`` and
``extract_action``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

# lane-binder domain tags
D_REPLICAS = "replicas"
D_VALUES = "values"
D_MSGS = "msgs"
D_SUBSETS = "subsets"
D_TRACKER = "tracker"    # `\E m \in rep_rec_recv[r]` with updates
                         # inside (RR05's CompleteRecovery) — one lane
                         # per tracker slot
D_INTRANGE = "intrange"  # `\E last_op \in 0..rep_op_number[r]` with
                         # updates inside (AL05's prefix crash) — one
                         # lane per log position (span is layout-
                         # bounded by MAX_OPS)

# tracker state variables whose per-replica rows are lane-enumerable
TRACKER_VARS = ("rep_recv_dvc", "rep_rec_recv")


@dataclass
class Binder:
    name: str
    domain: str          # one of the D_* tags
    info: tuple = None   # D_TRACKER: (tracker var name, owner binder)


@dataclass
class ActionIR:
    name: str
    binders: list = field(default_factory=list)
    body: tuple = None   # conjunct tree (everything under the binders)


def classify_domain(dom_expr, bound_names=()):
    """Map a binder's domain expression to (tag, info), or None if it
    is not lane-enumerable (left as an inner quantifier)."""
    if dom_expr == ("id", "replicas"):
        return D_REPLICAS, None
    if dom_expr == ("id", "Values"):
        return D_VALUES, None
    if dom_expr[0] == "domain" and dom_expr[1] == ("id", "messages"):
        return D_MSGS, None
    if dom_expr[0] == "powerset" and dom_expr[1] == ("id", "replicas"):
        return D_SUBSETS, None
    if (dom_expr[0] == "apply" and dom_expr[1][0] == "id"
            and dom_expr[1][1] in TRACKER_VARS
            and dom_expr[2][0] == "id"
            and dom_expr[2][1] in bound_names):
        return D_TRACKER, (dom_expr[1][1], dom_expr[2][1])
    if (dom_expr[0] == "binop" and dom_expr[1] == "range"
            and dom_expr[2][0] == "num"):
        return D_INTRANGE, (dom_expr[2][1], dom_expr[3])
    return None


def extract_action(name, expr) -> ActionIR:
    """Lift the top-level existential chain of an action body into lane
    binders.  Handles both shapes in the corpus: binders outermost
    (ReceiveClientRequest) and binders behind leading guard conjuncts
    (TimerSendSVC's ``aux_svc < Limit /\\ \\E r : ...``,
    NoProgressChange's counter guard)."""
    binders = []
    rest = []

    def bound():
        return tuple(b.name for b in binders)

    def walk(e):
        if e[0] == "and":
            items = list(e[1])
            ex = [i for i, x in enumerate(items)
                  if x[0] == "exists" and _liftable(x, bound())]
            if len(ex) == 1:
                inner = items.pop(ex[0])
                rest.extend(items)
                walk(inner)
            else:
                rest.append(e)
        elif e[0] == "exists" and _liftable(e, bound()):
            for names, dom in e[1]:
                tag, info = classify_domain(dom, bound())
                for n in names:
                    binders.append(Binder(n, tag, info))
            walk(e[2])
        else:
            rest.append(e)

    walk(expr)
    body = rest[0] if len(rest) == 1 else ("and", rest)
    return ActionIR(name=name, binders=binders, body=body)


def _liftable(e, bound_names):
    if e[0] != "exists":
        return False
    return all(classify_domain(dom, bound_names) is not None
               for _names, dom in e[1])


def contains_prime(e, module, _seen=None) -> bool:
    """Does this expression (transitively through operator definitions
    in `module`) prime any state variable?  Used to classify conjuncts
    as updates (ResetSentVars, Send, DiscardAndBroadcast, ... all prime
    through their definitions)."""
    if _seen is None:
        _seen = set()
    if not isinstance(e, tuple):
        return False
    if e[0] == "prime":
        return True
    if e[0] in ("call", "id"):
        name = e[1]
        d = module.defs.get(name)
        if d is not None and name not in _seen:
            _seen.add(name)
            if contains_prime(d.body, module, _seen):
                return True
    for x in e:
        if isinstance(x, tuple) and contains_prime(x, module, _seen):
            return True
        if isinstance(x, list):
            for y in x:
                if isinstance(y, tuple) and contains_prime(y, module, _seen):
                    return True
    return False
