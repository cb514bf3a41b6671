"""Liveness checking: the behaviour graph x the property automaton, a
fair-SCC search under weak fairness (a copy of
``tpuvsr/engine/liveness.py``; SURVEY.md §3.4).

Property shapes supported (the corpus's inventory):
  []<>P                  — violated by a fair lasso whose cycle is
                           everywhere ~P
  P ~> Q                 — violated by a fair lasso with a P-state at or
                           before the cycle and no later Q
  \\A x \\in S : ...      — constant-set quantification over either shape

Both negations are one-jump Büchi automata (guess the point after which
the bad condition holds forever), so the product graph is at most twice
the behaviour graph.  A cycle C is weakly fair for WF_vars(A) iff C
takes a real (state-changing) A-step or some state of C has <<A>>_vars
disabled; infinite stuttering at a state is a (trivially) fair cycle for
every WF whose action is disabled there — TLC's temporal semantics for
[][Next]_vars specs.

The graph is the interpreter's (``build_graph``) or a device-built
``engine/device_liveness.DeviceGraph``, whose CSR arrays and batched
state predicates (K18 on the card, ``batch_predicate``) this module
reads.  Symmetry must be off.  States are identified by their VIEW
value, as TLC builds its behaviour graph under a VIEW.

Left out of the copy: the run observer (``tpuvsr/obs``), whose module
the port does not have yet.  ``liveness_check`` takes ``obs=None`` only
and raises on any other value; ``LivenessResult.metrics`` stays None,
and the graph's gauges (mode, overhead, edges/s) go to ``log``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from ..core.values import TLAError
from .spec import SpecModel
from .trace import TraceEntry


@dataclass
class LivenessResult:
    ok: bool = True
    property_name: str = None
    distinct_states: int = 0
    elapsed: float = 0.0
    trace: list = field(default_factory=list)   # prefix + cycle
    cycle_start: int = 0                        # index into trace
    error: str = None
    metrics: dict = None      # None: the port has no run observer yet


def _build_graph(spec: SpecModel, max_states=None):
    """Reachable behavior graph: states, edges (sid, action, tid)."""
    if spec.symmetry_perms:
        raise TLAError("liveness checking requires SYMMETRY off "
                       "(reference cfg guidance, A01 cfg:22-24)")
    ids = {}
    states = []
    edges = []          # list of lists: sid -> [(action_name, tid)]
    order = []

    def intern(st):
        k = spec.view_value(st)
        sid = ids.get(k)
        if sid is None:
            sid = len(states)
            ids[k] = sid
            states.append(st)
            edges.append([])
            order.append(sid)
        return sid

    frontier = [intern(st) for st in spec.init_states()]
    inits = list(frontier)
    seen_depth = 0
    while frontier:
        seen_depth += 1
        nxt = []
        for sid in frontier:
            if edges[sid]:
                continue
            st = states[sid]
            for action, succ in spec.successors(st):
                known = len(states)
                tid = intern(succ)
                edges[sid].append((action.name, tid))
                if tid >= known:
                    nxt.append(tid)
            if max_states and len(states) > max_states:
                raise TLAError(
                    f"liveness graph exceeds {max_states} states")
        frontier = nxt
    return states, edges, inits


def _collect_props(spec: SpecModel, name):
    """Expand a PROPERTY definition into (kind, P_expr, Q_expr, env)
    leaves; kind in {"gf", "leadsto"}."""
    from ..interp.evalr import EMPTY_ENV, EvalCtx
    d = spec.module.defs.get(name)
    if d is None:
        raise TLAError(f"PROPERTY {name} not defined")
    leaves = []

    def walk(e, env):
        tag = e[0]
        if tag == "box" and e[1][0] == "diamond":
            leaves.append(("gf", e[1][1], None, env))
        elif tag == "binop" and e[1] == "leadsto":
            leaves.append(("leadsto", e[2], e[3], env))
        elif tag == "forall":
            for binding in spec.ev._group_bindings(e[1], env, EvalCtx({})):
                walk(e[2], env.extend(binding))
        elif tag == "and":
            for x in e[1]:
                walk(x, env)
        elif tag == "id" and e[1] in spec.module.defs:
            walk(spec.module.defs[e[1]].body, env)
        else:
            raise TLAError(f"unsupported temporal property shape: {tag}")
    walk(d.body, EMPTY_ENV)
    return leaves


def _eval_pred(spec, expr, env, st):
    from ..interp.evalr import EvalCtx
    return spec.ev.eval(expr, env, EvalCtx(st)) is True


def _fairness_groups(spec):
    """WF action groups from the decomposed SPECIFICATION.

    The corpus uses two WF shapes: per-action ``WF_vars(SendDVC)``
    lists (A01:793-806) and a single disjunction ``WF_vars(WFActions)``
    with ``WFActions == A1 \\/ A2 \\/ ...`` (ST03:922-943, AL05, CP06)
    — and VSR's ``WF_vars(Next)``.  WF of a disjunction is fair iff
    some disjunct is taken infinitely often or the whole disjunction is
    disabled infinitely often, so each WF formula becomes a *group* of
    action names."""
    action_names = {a.name for a in spec.actions}
    groups = []
    for kind, _sub, act in spec.fairness:
        if kind != "wf":
            raise TLAError("only weak fairness appears in the corpus")
        if act[0] != "id":
            raise TLAError(f"unsupported fairness action: {act!r}")
        name = act[1]
        if name in action_names:
            groups.append((name, frozenset([name])))
            continue
        d = spec.module.defs.get(name)
        if d is None:
            raise TLAError(f"WF action {name} not defined")
        members = set()

        def flat(e):
            if e[0] == "or":
                for x in e[1]:
                    flat(x)
            elif e[0] == "id" and e[1] in action_names:
                members.add(e[1])
            elif e[0] == "id" and e[1] in spec.module.defs:
                flat(spec.module.defs[e[1]].body)
            else:
                raise TLAError(
                    f"WF action {name} is not a disjunction of actions")
        flat(d.body)
        groups.append((name, frozenset(members)))
    return groups


def _tarjan_sccs(n_nodes, succ):
    """Iterative Tarjan over node ids 0..n-1 with succ(u) -> iterable."""
    index = [-1] * n_nodes
    low = [0] * n_nodes
    onstack = [False] * n_nodes
    stack = []
    sccs = []
    counter = [0]
    for root in range(n_nodes):
        if index[root] != -1:
            continue
        work = [(root, 0, list(succ(root)))]
        while work:
            u, pi, children = work[-1]
            if pi == 0:
                index[u] = low[u] = counter[0]
                counter[0] += 1
                stack.append(u)
                onstack[u] = True
            advanced = False
            for ci in range(pi, len(children)):
                v = children[ci]
                if index[v] == -1:
                    work[-1] = (u, ci + 1, children)
                    work.append((v, 0, list(succ(v))))
                    advanced = True
                    break
                elif onstack[v]:
                    low[u] = min(low[u], index[v])
            if advanced:
                continue
            if low[u] == index[u]:
                comp = []
                while True:
                    w = stack.pop()
                    onstack[w] = False
                    comp.append(w)
                    if w == u:
                        break
                sccs.append(comp)
            work.pop()
            if work:
                p = work[-1][0]
                low[p] = min(low[p], low[u])
    return sccs


def build_graph(spec: SpecModel, max_states=None):
    """Public: the reachable behavior graph (states, edges, inits).
    Reusable across property runs — e.g. checking a spec with and
    without its liveness shields shares one graph, since shield
    predicates appear only in properties, never in Next."""
    return _build_graph(spec, max_states)


def liveness_check(spec: SpecModel, max_states=None,
                   log=None, graph=None, obs=None) -> LivenessResult:
    """`graph` may be the interpreter-built (states, edges, inits)
    triple from build_graph, or a device-built
    engine.device_liveness.DeviceGraph (same attributes, lazy state
    decode, batched predicate evaluation).  ``obs`` must be None: the
    port has no run observer yet (``tpuvsr/obs``), and a run that was
    handed one would drop what it asked for."""
    if obs is not None:
        raise TLAError("liveness_check: the port has no run observer "
                       "(obs must be None)")
    res = LivenessResult()
    t0 = time.time()

    def finish(res):
        res.elapsed = time.time() - t0
        return res
    dev_graph = None
    try:
        if graph is None:
            states, edges, inits = _build_graph(spec, max_states)
        elif hasattr(graph, "batch_predicate"):
            dev_graph = graph
            states, inits = graph.states, graph.inits
            # don't touch .edges when CSR arrays exist —
            # materializing the list-of-lists view defeats the
            # array representation
            edges = None if hasattr(graph, "csr") else graph.edges
        else:
            states, edges, inits = graph
    except TLAError as e:
        res.ok = False
        res.error = str(e)
        return finish(res)
    import numpy as np

    res.distinct_states = len(states)
    n = len(states)
    wf_groups = _fairness_groups(spec)

    # edge access: CSR arrays when the device graph provides them
    # (shipped-constant graphs are far too large for list-of-lists),
    # else the interpreter's list form
    csr = getattr(dev_graph, "csr", None) if dev_graph else None
    if csr is not None:
        indptr, aidv, tidv = csr
        names = list(dev_graph.kern.action_names)
        srcv = np.repeat(np.arange(n, dtype=np.int64),
                         np.diff(indptr))
        n_edges = int(tidv.shape[0])

        def edges_of(u):
            return [(names[int(aidv[j])], int(tidv[j]))
                    for j in range(indptr[u], indptr[u + 1])]

        def succ_tids(u):
            return tidv[indptr[u]:indptr[u + 1]]

        # vectorized per-group "has a real member step" arrays
        real = tidv != srcv
        name_to_aid = {nm: i for i, nm in enumerate(names)}
        genab = []
        for _gname, members in wf_groups:
            maids = np.asarray([name_to_aid[m] for m in members
                                if m in name_to_aid], np.int32)
            sel = real & np.isin(aidv, maids)
            g = np.zeros(n, bool)
            np.logical_or.at(g, srcv[sel], True)
            genab.append(g)

        def group_enabled(u, gi):
            return bool(genab[gi][u])
    else:
        n_edges = sum(len(e) for e in edges)

        def edges_of(u):
            return edges[u]

        def succ_tids(u):
            return np.asarray([t for _a, t in edges[u]], np.int64)

        enabled = [set() for _ in range(n)]
        for sid in range(n):
            for aname, tid in edges[sid]:
                if tid != sid:
                    enabled[sid].add(aname)

        def group_enabled(u, gi):
            return bool(enabled[u] & wf_groups[gi][1])

    if log:
        log(f"behavior graph: {n} states, {n_edges} edges")

    def batch_values(expr, env):
        """[n] device-batched bools, or None when the leaf cannot be
        evaluated on device (no kernel and no AST lowerer)."""
        if dev_graph is None:
            return None
        if expr[0] == "id" and env.is_empty():
            vals = dev_graph.batch_predicate(expr[1])
            if vals is not None:
                return np.asarray(vals, bool)
        if hasattr(dev_graph, "batch_expr"):
            vals = dev_graph.batch_expr(expr, _flatten_env(env))
            if vals is not None:
                return np.asarray(vals, bool)
        return None

    def pred_values(expr, env):
        vals = batch_values(expr, env)
        if vals is not None:
            return vals
        return np.fromiter(
            (_eval_pred(spec, expr, env, states[sid])
             for sid in range(n)), bool, n)

    if dev_graph is not None and log:
        # streamed-graph health: how the device graph was built, what
        # the construction cost beyond the safety BFS was, and the edge
        # emission rate (JAX's gauges; the port logs them)
        health = [(k, getattr(dev_graph, k, None)) for k in (
            "mode", "graph_overhead_ratio", "edges_per_s")]
        log("device graph: " + ", ".join(
            f"{k} {v}" for k, v in health if v is not None))
    for prop_name in spec.temporal_props:
        for kind, p_expr, q_expr, env in _collect_props(spec, prop_name):
            if kind == "gf":
                # violation automaton: jump to phase 1 on ~P, stay on ~P
                bad = ~pred_values(p_expr, env)
                seed = bad
            else:
                # P ~> Q: phase-1 condition is ~Q; the jump additionally
                # requires P at the jump state — P is evaluated only
                # where ~Q holds unless a device batch is available
                bad = ~pred_values(q_expr, env)
                pv = batch_values(p_expr, env)
                if pv is not None:
                    seed = bad & pv
                else:
                    seed = np.asarray(
                        [bool(bad[sid])
                         and _eval_pred(spec, p_expr, env, states[sid])
                         for sid in range(n)], bool)

            # phase-1 subgraph: states with bad=True, edges bad->bad
            # (+ implicit stutter self-loops).  A fair cycle inside it
            # reachable from a seed state violates the property.
            def p1_succ(u):
                tt = succ_tids(u)
                return tt[bad[tt]] if csr is not None else \
                    [t for t in tt if bad[t]]

            sccs = _tarjan_sccs(n, lambda u: p1_succ(u) if bad[u] else ())

            def cycle_fair(comp):
                """A fair cycle exists within this (all-bad) SCC iff for
                every WF group: some internal state-changing edge takes
                a member, or some SCC state has the whole group disabled
                — strong connectivity then stitches one cycle through
                all the witnesses.  A singleton SCC is the stuttering
                lasso, fair iff every WF group is disabled there."""
                comp_set = set(comp)
                taken = {a for u in comp for (a, t) in edges_of(u)
                         if t in comp_set and t != u}
                for gi, (_gname, members) in enumerate(wf_groups):
                    if taken & members:
                        continue
                    if all(group_enabled(u, gi) for u in comp):
                        return False    # group always enabled, no
                                        # member ever taken: unfair
                return True

            # a violation needs BOTH a fair all-bad SCC and a lasso
            # reaching it (init -> seed -> bad-only path) — try every
            # candidate SCC, not just the first
            for comp in sccs:
                if not all(bad[u] for u in comp):
                    continue
                if not cycle_fair(comp):
                    continue
                path = _find_lasso(spec, states, edges_of, inits, seed,
                                   bad, set(comp))
                if path is not None:
                    res.ok = False
                    res.property_name = prop_name
                    res.trace, res.cycle_start = path
                    return finish(res)
    return finish(res)


def _flatten_env(env):
    """interp Env chain -> {name: value} with inner bindings winning."""
    chain = []
    while env is not None:
        chain.append(env.mapping)
        env = env.parent
    out = {}
    for m in reversed(chain):
        out.update(m)
    return out


def _find_lasso(spec, states, edges_of, inits, seed, bad, comp):
    """BFS init -> seed state s, then bad-only path s -> comp; returns
    (trace_entries, cycle_start_index) or None."""
    from collections import deque

    # phase A: shortest path from any init to a seed state
    prev = {}
    dq = deque()
    for i in inits:
        if i not in prev:
            prev[i] = (None, None)
            dq.append(i)
    target = None
    while dq:
        u = dq.popleft()
        if seed[u]:
            # phase B must reach comp from u via bad states
            pb = _bad_path(edges_of, bad, u, comp)
            if pb is not None:
                target = (u, pb)
                break
        for aname, t in edges_of(u):
            if t not in prev:
                prev[t] = (u, aname)
                dq.append(t)
    if target is None:
        return None
    u, pb = target
    # reconstruct prefix
    pre = []
    cur = u
    while cur is not None:
        p, a = prev[cur]
        pre.append((cur, a))
        cur = p
    pre.reverse()
    full = pre + pb[1:] if pb else pre
    loc = {a.name: a.location for a in spec.actions}
    entries = []
    for i, (sid, aname) in enumerate(full):
        entries.append(TraceEntry(
            position=i + 1, action_name=aname,
            location=loc.get(aname) if aname else None,
            state=states[sid]))
    cycle_start = len(pre) - 1 if not pb or len(pb) <= 1 else len(pre)
    return entries, max(0, cycle_start)


def _bad_path(edges_of, bad, start, comp):
    """BFS through bad-states from start into comp; [(sid, action)]."""
    from collections import deque
    if start in comp:
        return [(start, None)]
    prev = {start: (None, None)}
    dq = deque([start])
    while dq:
        u = dq.popleft()
        for aname, t in edges_of(u):
            if bad[t] and t not in prev:
                prev[t] = (u, aname)
                if t in comp:
                    out = []
                    cur = t
                    while cur is not None:
                        p, a = prev[cur]
                        out.append((cur, a))
                        cur = p
                    out.reverse()
                    return out
                dq.append(t)
    return None
