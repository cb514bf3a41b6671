"""speclint: static analysis over the frontend AST, the guarded-command
IR and the dense kernel layouts, gating every checking run.

A copy of ``tpuvsr/analysis/__init__.py``.  Its seven passes
(``passes/``): frames, widths, vacuity, symmetry, drift, bounds (pass
6: reachable intervals, dead actions, fanout and state-space bounds,
facts the engines consume) and independence (pass 7: the action
independence relation behind the engines' ample-set partial-order
reduction).  ``widths.py`` beside them is the port's one source of the
field ranges (``derive_ranges_from``).

Entry points:

* ``run_lint(spec)``: the full report;
* ``preflight(spec)``: the engine gate, all seven passes, cached per
  spec object; raises ``LintError`` on an error-severity finding and
  honours ``TPUVSR_LINT=off``.

A cfg-only binding (``engine/spec.SpecBinding``: the module's `.tla` is
not at hand, as VSR's and its family's are not in this repository) has
no module text to analyse: both return a report in which no pass ran.
The JAX package has no such binding; this is the port's rule.
"""

from __future__ import annotations

import os

from .passes import PASS_ORDER, PASSES, PREFLIGHT_PASSES
from .report import (Finding, LintError, LintReport, SEV_ERROR, SEV_INFO,
                     SEV_WARN)

__all__ = ["run_lint", "preflight", "lint_enabled", "has_module_text",
           "Finding", "LintError", "LintReport", "SEV_ERROR", "SEV_WARN",
           "SEV_INFO", "PASS_ORDER", "PREFLIGHT_PASSES"]


def has_module_text(spec) -> bool:
    """True for a spec bound to a parsed module (``SpecModel``), False
    for a cfg-only binding."""
    return hasattr(getattr(spec, "module", None), "defs")


def run_lint(spec, passes=None) -> LintReport:
    """Run the requested passes (default: all seven, in canonical
    order) over a bound spec and return the report."""
    if not has_module_text(spec):
        report = LintReport(module=spec.module_name)
        report.add("speclint", SEV_INFO, spec.module_name,
                   "cfg-only binding: no module text to analyse, no pass "
                   "ran")
        return report
    report = LintReport(module=spec.module.name)
    for name in (passes if passes is not None else PASS_ORDER):
        PASSES[name](spec, report)
        report.passes_run.append(name)
    return report


def lint_enabled() -> bool:
    return os.environ.get("TPUVSR_LINT", "").lower() not in (
        "off", "0", "false", "no")


def preflight(spec, log=None):
    """Fail-fast gate the engines call before dispatch.

    Runs all seven passes once per spec object; raises ``LintError`` if
    any error-severity finding survives.  Returns the report (or None
    when disabled via TPUVSR_LINT=off)."""
    if not lint_enabled():
        return None
    cached = getattr(spec, "_speclint_report", None)
    if cached is not None:
        if not cached.ok:
            raise LintError(cached)
        return cached
    report = run_lint(spec, passes=PREFLIGHT_PASSES)
    spec._speclint_report = report
    if log is not None:
        for f in report.warnings:
            log(f"speclint: {f}")
    if not report.ok:
        raise LintError(report)
    return report
