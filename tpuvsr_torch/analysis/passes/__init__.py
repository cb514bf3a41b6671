"""Pass registry for the speclint analyzer (a copy of
``tpuvsr/analysis/passes/__init__.py``).

Each pass module exposes ``PASS`` (its name) and ``run(spec, report)``.
``PASS_ORDER`` is the canonical execution order: cheap pure-AST passes
first, the kernel cross-check (which instantiates a codec and kernel)
after them, then the bounds and independence facts.
``PREFLIGHT_PASSES`` is the set the engines gate dispatch on: all seven.
"""

from __future__ import annotations

from . import bounds, drift, frames, independence, symmetry, vacuity, widths

PASSES = {m.PASS: m.run for m in (frames, widths, vacuity, symmetry,
                                  drift, bounds, independence)}
PASS_ORDER = ("frames", "widths", "vacuity", "symmetry", "drift",
              "bounds", "independence")
PREFLIGHT_PASSES = PASS_ORDER
