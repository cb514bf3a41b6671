"""Pass 5 — kernel/IR drift detection.

The hand-written kernels (models/*_kernel.py) and the lowerer
(lower/compile.py) are two implementations of the same spec; the
kernels are also the differential oracle the lowerer is held to.  The
hazard this pass guards against is silent drift: a spec edit renames
or adds an action, the lowerer picks it up from the AST automatically,
and the hand kernel keeps exploring the OLD action set — every
differential test still passes on the states both can reach.

Cross-checks, per registered module:

* action list — the kernel's ``action_names`` must equal the Next
  disjunct names the spec model derives (a renamed/missing/extra
  action is an ERROR; an order difference only reorders lane ids and
  is a WARN);
* lane-binder domains — for every action whose top-level existential
  chain the IR extractor can lift (lower/ir.extract_action), the
  binder-domain product must equal the kernel's ``_lane_count``
  (a mismatch means the kernel enumerates a different bound-variable
  space than the spec declares: WARN, since hand kernels may
  legitimately over-enumerate and mask the excess with guards);
* state layout — the kernel's hashed key tables (REP_KEYS/MSG_KEYS/
  AUX_KEYS and, where present, GLOBAL_KEYS) must exactly cover the
  codec's ``zero_state`` planes: a plane the kernel does not hash is
  invisible to fingerprinting (ERROR), a key without a plane is a
  stale layout reference (ERROR);
* packed-frontier bounds — the codec's ``plane_bounds``
  tables feed the engine/pack bit budgets, and the widths-pass range
  table is their single source of truth.  A codec width/layout edit
  that is not reflected in the bounds packs real values into too few
  bits and wraps silently, so the pass cross-checks: bound keys must
  name real ``zero_state`` planes (stale reference: ERROR),
  per-column bound arity must match the plane shape (ERROR, surfaced
  from build_pack_spec), the all-zero padding row and every encoded
  init state must round-trip the packed format EXACTLY (a wrap here
  is a bound that no longer covers the layout: ERROR).

A copy of ``tpuvsr/analysis/passes/drift.py`` over the port's registry
(a kernel takes its pack spec, as ``registry.make_model`` builds it) and
the port's ``PackSpec``, whose plain pack refuses an out-of-bound value
instead of wrapping it: a plane fails the round trip exactly when one of
its values lies outside its lane's bit budget (``_roundtrip_bad``).
"""

from __future__ import annotations

from ...core.values import TLAError
from ...lower.ir import extract_action
from ..report import SEV_ERROR, SEV_INFO, SEV_WARN

PASS = "drift"


def run(spec, report):
    from ...models import registry
    try:
        codec_cls, kern_cls = registry._resolve(spec.module.name)
    except KeyError:
        report.add(PASS, SEV_INFO, spec.module.name,
                   "no registered device kernel for this module; "
                   "nothing to cross-check")
        return
    try:
        codec = codec_cls(spec.ev.constants)
    except TLAError as e:
        report.add(PASS, SEV_WARN, spec.module.name,
                   f"dense layout refuses these constants ({e}); "
                   f"kernel cross-check skipped")
        return
    except Exception as e:       # noqa: BLE001
        # a non-TLAError here is either a real codec regression (must
        # stay loud — this pass IS the gate for it) or a spec that
        # merely shares a registered module's name; err on loud, with
        # the standard -lint=off / TPUVSR_LINT=off bypass for forks
        report.add(PASS, SEV_ERROR, spec.module.name,
                   f"dense layout construction failed "
                   f"({type(e).__name__}: {e}); drift cross-check "
                   f"could not run (TPUVSR_LINT=off bypasses if this "
                   f"spec only shares the module name)")
        return
    try:
        from ...engine.pack import build_pack_spec
        from .widths import derive_ranges
        kern = kern_cls(codec,
                        perms=registry.value_perm_table(spec, codec),
                        pack_spec=build_pack_spec(
                            codec, ranges=derive_ranges(spec)))
    except Exception as e:       # noqa: BLE001
        # the codec ACCEPTED these constants, so this is almost
        # certainly a real kernel-side regression, not a name-shared
        # foreign spec — keep the corpus lint gate loud (ERROR)
        report.add(PASS, SEV_ERROR, spec.module.name,
                   f"kernel construction failed after its codec "
                   f"accepted the constants "
                   f"({type(e).__name__}: {e}); drift cross-check "
                   f"could not run")
        return
    check_drift(spec, codec, kern, report)
    check_pack_drift(spec, codec, report)
    check_bounds_drift(spec, codec, report)


def check_drift(spec, codec, kern, report):
    """Cross-check one (spec, codec, kernel) triple.  Split out from
    ``run`` so tests can drive it with a stub kernel."""
    spec_actions = [a.name for a in spec.actions]
    kern_actions = list(kern.action_names)

    missing = [n for n in spec_actions if n not in kern_actions]
    extra = [n for n in kern_actions if n not in spec_actions]
    for n in missing:
        report.add(PASS, SEV_ERROR, n,
                   "spec action has no kernel implementation (the "
                   "kernel's action list has drifted from the spec's "
                   "Next disjuncts)")
    for n in extra:
        report.add(PASS, SEV_ERROR, n,
                   "kernel implements an action the spec's Next does "
                   "not mention (renamed or removed in the spec)")
    if not missing and not extra and spec_actions != kern_actions:
        report.add(PASS, SEV_WARN, spec.module.name,
                   "kernel action order differs from the spec's Next "
                   "disjunct order (lane ids are permuted)")

    # lane-binder domains vs kernel lane counts
    shape = codec.shape
    dims = {"replicas": shape.R, "values": shape.V,
            "msgs": shape.MAX_MSGS, "subsets": 1 << shape.R,
            "tracker": shape.R, "intrange": shape.MAX_OPS + 1}
    for action in spec.actions:
        if action.name not in kern_actions:
            continue
        air = extract_action(action.name, action.expr)
        if not air.binders:
            continue               # nothing liftable to compare
        expected = 1
        for b in air.binders:
            expected *= dims[b.domain]
        got = kern._lane_count(action.name)
        if got != expected:
            doms = "x".join(b.domain for b in air.binders)
            report.add(PASS, SEV_WARN, action.name,
                       f"kernel enumerates {got} lanes but the spec's "
                       f"binder chain ({doms}) spans {expected} "
                       f"combinations — lane plan drift")

    # state-layout coverage: hashed keys vs dense planes
    keys = set()
    for attr in ("REP_KEYS", "MSG_KEYS", "AUX_KEYS", "GLOBAL_KEYS"):
        keys.update(getattr(kern, attr, ()))
    planes = set(codec.zero_state().keys())
    for k in sorted(planes - keys):
        report.add(PASS, SEV_ERROR, k,
                   "dense state plane is not covered by the kernel's "
                   "hashed key tables — the plane would be invisible "
                   "to fingerprint dedup")
    for k in sorted(keys - planes):
        report.add(PASS, SEV_ERROR, k,
                   "kernel key table names a plane the codec layout "
                   "does not allocate (stale layout reference)")


def check_pack_drift(spec, codec, report):
    """Packed-frontier bound drift.  Split out
    from ``run`` so tests can drive it with a deliberately-stale stub
    codec (the fixture: a codec width edit WITHOUT a widths-table /
    bounds edit must fail speclint, not wrap at runtime)."""
    if not hasattr(codec, "plane_bounds"):
        report.add(PASS, SEV_INFO, spec.module.name,
                   "codec declares no plane_bounds; the packed "
                   "frontier runs at ratio 1.0 (no bit budgets to "
                   "cross-check)")
        return
    from ...engine.pack import build_pack_spec
    from .widths import derive_ranges
    ranges = derive_ranges(spec)
    planes = set(codec.zero_state().keys())
    for k in sorted(set(codec.plane_bounds(ranges)) - planes):
        report.add(PASS, SEV_ERROR, k,
                   "plane_bounds names a plane the codec layout does "
                   "not allocate (stale packing reference)")
    try:
        pk = build_pack_spec(codec, ranges=ranges)
    except TLAError as e:
        report.add(PASS, SEV_ERROR, spec.module.name,
                   f"packing-spec construction failed ({e}) — the "
                   f"plane_bounds tables have drifted from the dense "
                   f"layout")
        return

    def roundtrip_errors(row, what):
        bad = _roundtrip_bad(pk, row)
        for k in bad:
            report.add(PASS, SEV_ERROR, k,
                       f"{what} does not round-trip the packed "
                       f"format (plane {k!r}: a value lies outside "
                       f"its declared bit budget and would wrap "
                       f"silently) — the codec layout has drifted "
                       f"from its plane_bounds / the widths table")
        return bad

    # the all-zero row is the padding every growth path re-packs;
    # a bound excluding 0 breaks pad_msgs/_grow_msgs invisibly
    zero = codec.zero_state()
    if roundtrip_errors(zero, "the zero row"):
        return
    ok = 0
    for i, st in enumerate(spec.init_states()):
        if i >= 64:
            break                  # static smoke, not an enumeration
        if roundtrip_errors(codec.encode(st), f"init state {i}"):
            return
        ok += 1
    report.add(PASS, SEV_INFO, spec.module.name,
               f"packed layout {pk.packed_bytes} B/state "
               f"({pk.ratio:.2f}x vs dense); zero row and {ok} init "
               f"state(s) round-trip exactly")


def check_bounds_drift(spec, codec, report):
    """Bounds-tightened packing drift (extending the pack-drift
    fixture): the widths table, the codec's
    ``plane_bounds`` and the bounds pass's tightened intervals must
    agree on ONE layout — a codec width edit that diverges from the
    shared range table shows up as a tightened round-trip failure
    here, at lint time, not as a silent wrap inside a ``-bounds on``
    run.  Checks: every encoded init state round-trips the TIGHTENED
    packing exactly (the reachable intervals over-approximate
    reachability, so init states are always inside them)."""
    if not hasattr(codec, "plane_bounds"):
        return
    from ...engine.pack import build_pack_spec
    from .bounds import analyze
    from .widths import derive_ranges
    facts = analyze(spec)
    tighten = facts.plane_tighten()
    if not tighten:
        return                      # untightened = pack-drift covered
    ranges = derive_ranges(spec)
    try:
        pk = build_pack_spec(codec, ranges=ranges, tighten=tighten)
    except TLAError as e:
        report.add(PASS, SEV_ERROR, spec.module.name,
                   f"bounds-tightened packing-spec construction "
                   f"failed ({e}) — the tightened intervals have "
                   f"drifted from the dense layout")
        return
    if pk is None:
        return
    bad = []
    for i, st in enumerate(spec.init_states()):
        if i >= 64:
            break
        bad = _roundtrip_bad(pk, codec.encode(st))
        if bad:
            for k in bad:
                report.add(PASS, SEV_ERROR, k,
                           f"init state {i} does not round-trip the "
                           f"bounds-TIGHTENED packing (plane {k!r}): "
                           f"the codec layout stores values outside "
                           f"the reachable interval the bounds pass "
                           f"derived — width tables have drifted")
            return
    report.add(PASS, SEV_INFO, spec.module.name,
               f"bounds-tightened packing ({pk.total_bits} bits/state "
               f"vs declared) round-trips every init state exactly")


def _roundtrip_bad(pk, row):
    """The planes of one dense row (a dict of numpy values) that would
    not survive ``pk``'s pack and unpack: those holding a value outside
    its lane's ``[lo, lo + mask]`` budget, sorted."""
    import numpy as np

    bad = []
    for key, _shape, a, e in pk._splits:
        v = np.asarray(row[key], np.int64).reshape(-1)
        off = (v - pk._lo[a:e].astype(np.int64)) & 0xFFFFFFFF
        if (off > pk._mask[a:e].astype(np.int64)).any():
            bad.append(key)
    return sorted(bad)
