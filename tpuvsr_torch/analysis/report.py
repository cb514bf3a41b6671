"""Finding/report model for the speclint static analyzer.

A lint run produces one ``LintReport`` per bound spec: an ordered list
of ``Finding``s, each attributed to the pass that raised it, with a
TLC-operator-level subject (action/invariant/variable name) so the
report reads like a compiler diagnostic, not a stack trace.

Exit-code contract (documented in README "Static analysis"):

  0   no error-severity findings (warnings/info allowed)
  1   at least one error-severity finding
  2   usage error (bad flags — raised by argparse, not this module)

The engine pre-flight path wraps an erroring report in ``LintError``
(a ``TLAError`` subclass, so existing CLI/engine error handling treats
a lint abort like any other refused-to-run condition).

A copy of ``tpuvsr/analysis/report.py``.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

from ..core.values import TLAError

SEV_ERROR = "error"
SEV_WARN = "warning"
SEV_INFO = "info"

_SEV_RANK = {SEV_ERROR: 0, SEV_WARN: 1, SEV_INFO: 2}


@dataclass
class Finding:
    passname: str        # which analyzer pass raised it
    severity: str        # SEV_ERROR | SEV_WARN | SEV_INFO
    subject: str         # action/invariant/variable the finding is about
    message: str

    def to_dict(self):
        return {"pass": self.passname, "severity": self.severity,
                "subject": self.subject, "message": self.message}

    def __str__(self):
        return (f"{self.severity:>7}  [{self.passname}] "
                f"{self.subject}: {self.message}")


@dataclass
class LintReport:
    module: str = ""
    findings: list = field(default_factory=list)
    passes_run: list = field(default_factory=list)
    # structured per-pass sections beyond findings (the bounds pass
    # attaches its facts under extras["bounds"] so `-lint -json`
    # surfaces intervals/dead actions/state_bound)
    extras: dict = field(default_factory=dict)

    def add(self, passname, severity, subject, message):
        self.findings.append(Finding(passname, severity, subject, message))

    def by_severity(self, severity):
        return [f for f in self.findings if f.severity == severity]

    @property
    def errors(self):
        return self.by_severity(SEV_ERROR)

    @property
    def warnings(self):
        return self.by_severity(SEV_WARN)

    @property
    def ok(self):
        return not self.errors

    @property
    def exit_code(self):
        return 0 if self.ok else 1

    def to_dict(self):
        out = {"module": self.module, "ok": self.ok,
               "passes": list(self.passes_run),
               "errors": len(self.errors),
               "warnings": len(self.warnings),
               "findings": [f.to_dict() for f in self.findings]}
        out.update(self.extras)
        return out

    def to_json(self):
        return json.dumps(self.to_dict())

    def render(self):
        """Human-readable multi-line report (severity-sorted)."""
        lines = [f"speclint: module {self.module} — "
                 f"{len(self.errors)} error(s), "
                 f"{len(self.warnings)} warning(s), "
                 f"passes: {', '.join(self.passes_run)}"]
        for f in sorted(self.findings,
                        key=lambda f: _SEV_RANK.get(f.severity, 3)):
            lines.append(str(f))
        return "\n".join(lines)


class LintError(TLAError):
    """Raised by the engine pre-flight when the analyzer finds
    error-severity defects; carries the full report."""

    def __init__(self, report: LintReport):
        self.report = report
        errs = "; ".join(f"[{f.passname}] {f.subject}: {f.message}"
                         for f in report.errors)
        super().__init__(
            f"speclint pre-flight failed for module {report.module} "
            f"({len(report.errors)} error(s)): {errs} — rerun with "
            f"-lint for the full report, or -lint=off / TPUVSR_LINT=off "
            f"to bypass the gate")
