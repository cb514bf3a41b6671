"""Engine-side consumption of the speclint bounds pass.

A copy of ``tpuvsr/engine/bounds.py`` (``resolve_bounds`` :36,
``PrunedKernel`` :56, ``prune_kernel`` :110).
``analysis/passes/bounds.py`` computes the facts; this module is the
seam through which the engines trust them:

* :func:`resolve_bounds`: the one policy switch.  ``"auto"`` (every
  engine's default) consumes the facts iff the speclint gate is live
  (``TPUVSR_LINT=off`` disables consumption too); forcing ``"on"``
  under a disabled gate is a loud error.  A cfg-only binding
  (``engine/spec.SpecBinding``) has no module text to analyse: under
  ``"auto"`` the facts are None, and ``"on"`` raises a ``TLAError``
  that names the missing module text (the port's rule; the JAX package
  has no cfg-only binding).
* :func:`prune_kernel`: wraps a device kernel with the statically dead
  actions removed, so the guard matrix and the work queue never hold a
  lane whose guard folds to FALSE.  Dead actions are never enabled, so
  counts, level sizes, verdicts and traces are those of the unpruned
  kernel.

The port's kernels also expose ``guard_matrix`` (K6, K13: every lane of
every action) and ``successors`` (K10, K14: a work queue of (row,
action id, lane) items).  ``PrunedKernel`` maps both: K6's columns are
kept by ``_lane_keep``, and K10/K14 get the base kernel's action ids.
Every other lane- or action-indexed table of the base kernel is
refused loudly (``_REFUSED``): delegating it would run dead lanes under
renumbered ids.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.values import TLAError


def resolve_bounds(spec, req="auto"):
    """The engines' bounds switch -> :class:`BoundsFacts` or None.

    ``req``: ``"auto"`` (on iff the speclint gate is live and the spec
    has module text) | True/"on" (forced; an error when the gate is off
    or the binding is cfg-only) | False/"off"."""
    if req is False or req == "off" or req is None:
        return None
    forced = req is True or req == "on"
    from ..analysis import has_module_text, lint_enabled
    if not lint_enabled():
        if forced:
            raise TLAError(
                "bounds=on requires the speclint gate: TPUVSR_LINT=off "
                "/ -lint=off disables the static analysis the "
                "tightened packing and pruned action lists would "
                "trust (drop -bounds on or re-enable lint)")
        return None
    if not has_module_text(spec):
        if forced:
            raise TLAError(
                f"bounds=on needs the module text of "
                f"{spec.module_name}: a cfg-only binding has no .tla to "
                f"analyse (bind it with load_spec, or drop bounds=on)")
        return None
    from ..analysis.passes.bounds import analyze
    return analyze(spec)


# lane- and action-indexed tables of the port's kernels: a pruned
# kernel cannot hand these out (their rows are the base kernel's lanes)
_REFUSED = frozenset({
    "guard_matrix_plain", "successors_plain", "guard_tables",
    "action_tables", "action_map", "family_action_ids", "_guards_kernel",
    "_actions_kernel", "_guard_list", "_action_list", "_guard_out"})
# the lane- and action-indexed calls a pruned kernel maps onto its base
_MAPPED = frozenset({"step_all", "guard_matrix", "successors"})


class PrunedKernel:
    """A device kernel with statically dead actions removed.

    Implements the attribute contract the engines consume
    (``action_names`` / ``n_lanes`` / ``_lane_count`` / ``_guard_fns`` /
    ``_action_fns`` / ``lane_action`` / ``lane_param`` / ``step_all``,
    and the port's ``guard_matrix`` and ``successors``); fingerprints,
    invariants, symmetry tables and key tables delegate to the wrapped
    kernel, and the lane-indexed internals in ``_REFUSED`` raise."""

    def __init__(self, kern, dead):
        names = list(kern.action_names)
        dead = [n for n in dead if n in names]
        keep = [n for n in names if n not in dead]
        if not keep:
            raise TLAError("prune_kernel: every action is dead — the "
                           "engine needs at least one live action "
                           "(run bounds=off to inspect the space)")
        self._base = kern
        self.pruned_actions = dead
        self.action_names = keep
        keep_aids = np.asarray([names.index(n) for n in keep], np.int32)
        # flat lane tables: keep the lanes of live actions, renumber
        # action ids onto the filtered list (lane params unchanged)
        la = np.asarray(kern.lane_action, np.int32)
        self._lane_keep = np.where(np.isin(la, keep_aids))[0]
        remap = np.full(len(names), -1, np.int32)
        remap[keep_aids] = np.arange(len(keep), dtype=np.int32)
        self.lane_action = remap[la[self._lane_keep]]
        self.lane_param = np.asarray(kern.lane_param,
                                     np.int32)[self._lane_keep]
        self.n_lanes = int(self._lane_keep.shape[0])
        self._keep_idx = [names.index(n) for n in keep]
        self._keep_aids = keep_aids
        self._dev = {}

    def _tables(self, device):
        """(kept lane columns [n_lanes] int64, base action id of each
        pruned id [n_act] int32) on ``device``."""
        key = str(device)
        t = self._dev.get(key)
        if t is None:
            t = (torch.as_tensor(self._lane_keep, dtype=torch.int64,
                                 device=device),
                 torch.as_tensor(self._keep_aids, dtype=torch.int32,
                                 device=device))
            self._dev[key] = t
        return t

    def _lane_count(self, name):
        return self._base._lane_count(name)

    def _guard_fns(self):
        fns = self._base._guard_fns()
        return [fns[i] for i in self._keep_idx]

    def _action_fns(self):
        fns = self._base._action_fns()
        return [fns[i] for i in self._keep_idx]

    def _mapped_step_all(self, st):
        succs, ens = self._base.step_all(st)
        idx = self._tables(ens.device)[0]
        return ({k: v[:, idx] for k, v in succs.items()}, ens[:, idx])

    def _mapped_guard_matrix(self, flat, out=None, halt=None):
        """The base kernel's guard matrix (K6/K13) with the dead lanes'
        columns dropped; ``en_any`` is unchanged (a dead lane is never
        enabled)."""
        en, en_any = self._base.guard_matrix(flat, None, halt)
        en = en[:, self._tables(flat.device)[0]]
        if out is None:
            return en, en_any
        out[0].copy_(en)
        out[1].copy_(en_any)
        return out

    def _mapped_successors(self, flat, pidx, aid, lane, inv_mask,
                           out=None, halt=None):
        """K10/K14 over a work queue whose action ids are the pruned
        kernel's: they are mapped to the base kernel's first."""
        if isinstance(aid, torch.Tensor):
            base_aid = self._tables(aid.device)[1][aid.long()]
        else:
            base_aid = int(self._keep_aids[int(aid)])
        return self._base.successors(flat, pidx, base_aid, lane, inv_mask,
                                     out, halt)

    def __getattr__(self, name):
        base = self.__dict__["_base"]
        if name in _MAPPED:
            # mapped where the base kernel has it, absent where it has not
            # (the engines ask hasattr for K6 and K10)
            getattr(base, name)
            return getattr(self, "_mapped_" + name)
        if name in _REFUSED:
            raise TLAError(
                f"PrunedKernel.{name}: the base kernel's lane- and "
                f"action-indexed table would run dead lanes under "
                f"renumbered ids ({self.pruned_actions} pruned)")
        return getattr(base, name)


def prune_kernel(kern, dead):
    """Wrap `kern` with the `dead` action names removed (no-op pass
    back when nothing would change)."""
    dead = [n for n in dead if n in kern.action_names]
    if not dead:
        return kern
    return PrunedKernel(kern, dead)
