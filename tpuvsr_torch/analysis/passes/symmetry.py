"""Pass 4 — symmetry soundness.

TLC's SYMMETRY optimization is only sound when every declared
permutation is a structural automorphism of the state graph.  Two ways
the corpus (or a grown config) can break that:

1. The SYMMETRY definition evaluates to maps that are not bijections
   of the symmetric model-value universe (e.g. a constant map
   ``[v \\in Values |-> v1]``): canonicalization then merges
   non-isomorphic states and the checker silently under-explores.
   Checked semantically on the evaluated ``spec.symmetry_perms``.

2. The spec uses a symmetric model value asymmetrically: a variable
   bound over the symmetric set appearing under an order or arithmetic
   operator (``<``, ``..``, ``+`` — TLC would error at evaluation
   time, long into a run), or a cfg constant pinning a NAME to one
   symmetric value that the spec then references (the classic
   TLC "symmetric model value used in the spec" unsoundness).
   Checked by a taint walk over every definition reachable from
   Init/Next/invariants/VIEW: binders whose domain is a symmetric-set
   constant taint their variable; taints propagate through operator
   calls by position.

``CHOOSE`` over a symmetric domain is reported as info: both TLC and
this port resolve it deterministically over a canonical order, which
is sound for state exploration but makes the chosen element
orbit-dependent — worth knowing when debugging a trace.

Device-soundness: the engines now canonicalize states to
orbit representatives ON DEVICE (engine/canon.py), which adds two
machine-checkable preconditions this pass enforces:

3. The evaluated permutation set plus identity must be CLOSED under
   composition — min-over-enumerated-images is only orbit-invariant
   for a group (``Permutations(S)`` always is; a hand-written subset
   may not be).

4. Each permutation must act on the encoded layout as a bijection of
   value ids that fixes the padding id 0, and only through planes the
   kernel's orbit table names.  The pass EMITS that table (via
   ``canon.orbit_planes`` — the same function the canonicalization
   kernel consumes), so lint and kernel cannot disagree about which
   planes a permutation touches.

A copy of ``tpuvsr/analysis/passes/symmetry.py`` that reads the port's
``engine/canon`` and ``models/registry`` (the full value table:
``value_perm_table(..., fold_symmetry=True)``); the port's
``SpecModel.invariants`` holds names, so the invariant roots are read
from ``spec.module.defs``.
"""

from __future__ import annotations

from ...core.values import ModelValue
from ..report import SEV_ERROR, SEV_INFO, SEV_WARN

PASS = "symmetry"

_ORDERED_OPS = ("lt", "le", "gt", "ge", "plus", "minus", "times",
                "div", "mod", "range")


def run(spec, report):
    perms = spec.symmetry_perms
    if not perms:
        report.add(PASS, SEV_INFO, spec.module.name,
                   "no SYMMETRY declared; nothing to check")
        return

    moved = set()
    for p in perms:
        moved.update(p.keys())
        moved.update(p.values())

    # ground universe: the cfg constant set(s) the moved values live in
    universe = set()
    sym_set_consts = []
    for cname, cval in spec.ev.constants.items():
        if isinstance(cval, frozenset) and cval & moved:
            universe |= {v for v in cval if isinstance(v, ModelValue)}
            sym_set_consts.append(cname)
    if not universe:
        universe = set(moved)

    for i, p in enumerate(perms):
        stray = (set(p.keys()) | set(p.values())) - universe
        if stray:
            report.add(PASS, SEV_ERROR, f"perm #{i}",
                       f"permutation moves values outside the "
                       f"symmetric set(s) "
                       f"{sorted(c for c in sym_set_consts)}: "
                       f"{sorted(v.name for v in stray)}")
            continue
        image = {p.get(u, u) for u in universe}
        if len(image) != len(universe):
            report.add(PASS, SEV_ERROR, f"perm #{i}",
                       f"not a bijection of the symmetric set: "
                       f"{{{', '.join(sorted(u.name for u in universe))}}} "
                       f"maps onto only {len(image)} of "
                       f"{len(universe)} values — canonicalization "
                       f"would merge non-isomorphic states")

    # device-soundness: group closure + encoded orbit table
    _device_orbit_check(spec, perms, report)

    # cfg constants that pin a NAME to one symmetric value
    pinned = {cname for cname, cval in spec.ev.constants.items()
              if isinstance(cval, ModelValue) and cval in universe
              and cname not in spec.module.variables}

    # taint walk over reachable definitions
    roots = [a.expr for a in spec.actions]
    roots += [spec.module.defs[n].body for n in spec.invariants]
    init_def = spec.module.defs.get(spec.init_name)
    if init_def is not None:
        roots.append(init_def.body)
    if spec.view_def is not None:
        roots.append(spec.view_def.body)
    walker = _Taint(spec, frozenset(sym_set_consts), pinned, report)
    for root in roots:
        walker.walk(root, frozenset())


def _device_orbit_check(spec, perms, report):
    """Checks 3 and 4 (module docstring): closure of the evaluated
    group, and the kernel/codec orbit table the device
    canonicalization pass consumes."""
    from ...engine.canon import group_closed, orbit_planes
    if not group_closed(perms):
        report.add(PASS, SEV_ERROR, "group",
                   "SYMMETRY permutation set (plus identity) is not "
                   "closed under composition: the orbit-least image "
                   "is then orbit-DEPENDENT and device "
                   "canonicalization (and the host min-image "
                   "fingerprint) would merge or split orbits "
                   "inconsistently.  TLC's Permutations(S) is always "
                   "closed; hand-written SYMMETRY sets must be too")
    try:
        from ...models.registry import _resolve, has_device_model
        from ...models.registry import value_perm_table
    except ImportError:
        return
    if not has_device_model(spec):
        report.add(PASS, SEV_INFO, spec.module.name,
                   "no compiled device kernel for this module; orbit "
                   "table check skipped (the interpreter's "
                   "view-value canonicalization needs no table)")
        return
    codec_cls, kern_cls = _resolve(spec.module.name)
    codec = codec_cls(spec.ev.constants)
    planes = orbit_planes(kern_cls)
    if planes is None:
        report.add(PASS, SEV_ERROR, kern_cls.__name__,
                   "kernel declares no orbit plane table (SYM_PLANES "
                   "or PERM_REP_KEYS/PERM_MSG_KEYS): device "
                   "canonicalization cannot know which planes a "
                   "permutation touches; -symmetry on would fail at "
                   "engine build")
        return
    zero = codec.zero_state()
    missing = sorted(k for k in planes if k not in zero)
    if missing:
        report.add(PASS, SEV_ERROR, kern_cls.__name__,
                   f"orbit table names planes {missing} the codec "
                   f"layout does not declare — lint/kernel drift")
    table = value_perm_table(spec, codec, fold_symmetry=True)
    V = int(codec.shape.V)
    for i, row in enumerate(table):
        bad = (int(row[0]) != 0
               or sorted(int(x) for x in row) != list(range(V + 1)))
        if bad:
            report.add(PASS, SEV_ERROR, f"perm #{i}",
                       "permutation does not act as a bijection of "
                       "the encoded value ids fixing the padding id "
                       "0: canonicalizing through this row would "
                       "corrupt non-symmetric fields")
    report.add(PASS, SEV_INFO, kern_cls.__name__,
               f"device orbit table: group order {len(table)} "
               f"(identity included), planes "
               f"{sorted(planes)} — emitted by canon.orbit_planes, "
               f"the same source the canonicalization kernel reads")


class _Taint:
    def __init__(self, spec, sym_consts, pinned, report):
        self.spec = spec
        self.sym_consts = sym_consts       # names of symmetric SETS
        self.pinned = pinned               # names pinned to one value
        self.report = report
        self._reported = set()
        self._def_memo = set()             # (defname, taint signature)

    # ------------------------------------------------------------------
    def _emit(self, sev, subject, msg):
        key = (subject, msg)
        if key not in self._reported:
            self._reported.add(key)
            self.report.add(PASS, sev, subject, msg)

    def _is_sym_domain(self, dom):
        return isinstance(dom, tuple) and dom and dom[0] == "id" \
            and dom[1] in self.sym_consts

    def walk(self, e, tainted):
        """tainted: frozenset of bound-variable names ranging over a
        symmetric set in the current scope."""
        if not isinstance(e, tuple) or not e:
            return
        tag = e[0]
        if tag == "id":
            if e[1] in self.pinned:
                self._emit(
                    SEV_ERROR, e[1],
                    f"constant {e[1]!r} pins symmetric model value "
                    f"{self.spec.ev.constants[e[1]]!r} and is "
                    f"referenced by the spec — symmetry reduction is "
                    f"unsound (TLC's symmetric-value-in-spec rule)")
            return
        if tag == "binop" and e[1] in _ORDERED_OPS:
            for side in (e[2], e[3]):
                if isinstance(side, tuple) and side \
                        and side[0] == "id" and side[1] in tainted:
                    self._emit(
                        SEV_ERROR, side[1],
                        f"symmetric-set variable {side[1]!r} used "
                        f"under order/arithmetic operator "
                        f"{e[1]!r} — permutations are not "
                        f"automorphisms of an ordered use")
        if tag == "setmap":                # ('setmap', elem, groups)
            new = set(tainted)
            for names, dom in e[2]:
                self.walk(dom, tainted)
                if self._is_sym_domain(dom):
                    new.update(names)
            self.walk(e[1], frozenset(new))
            return
        if tag in ("exists", "forall", "fnctor"):
            groups, body = (e[1], e[2])
            new = set(tainted)
            for names, dom in groups:
                self.walk(dom, tainted)
                if self._is_sym_domain(dom):
                    new.update(names)
            self.walk(body, frozenset(new))
            return
        if tag == "setfilter":
            var, dom, pred = e[1], e[2], e[3]
            self.walk(dom, tainted)
            new = set(tainted)
            if self._is_sym_domain(dom):
                new.add(var)
            self.walk(pred, frozenset(new))
            return
        if tag == "choose":
            var, dom, body = e[1], e[2], e[3]
            self.walk(dom, tainted)
            new = set(tainted)
            if self._is_sym_domain(dom):
                new.add(var)
                self._emit(
                    SEV_INFO, var,
                    "CHOOSE over a symmetric set resolves "
                    "deterministically over the canonical value order "
                    "(sound for exploration; orbit-dependent in "
                    "traces)")
            self.walk(body, frozenset(new))
            return
        if tag == "call":
            name, args = e[1], e[2]
            for a in args:
                self.walk(a, tainted)
            d = self.spec.module.defs.get(name)
            if d is not None and len(d.params) == len(args):
                arg_taint = frozenset(
                    p for p, a in zip(d.params, args)
                    if isinstance(a, tuple) and a and a[0] == "id"
                    and a[1] in tainted)
                key = (name, arg_taint)
                if key not in self._def_memo:
                    self._def_memo.add(key)
                    self.walk(d.body, arg_taint)
            return
        for x in e[1:]:
            if isinstance(x, tuple):
                self.walk(x, tainted)
            elif isinstance(x, list):
                for y in x:
                    if isinstance(y, tuple):
                        self.walk(y, tainted)
                    elif isinstance(y, (tuple, list)):
                        for z in y:
                            if isinstance(z, tuple):
                                self.walk(z, tainted)
