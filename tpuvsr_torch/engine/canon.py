"""Symmetry reduction: orbit-canonical state images, and kernel K9.

A copy of ``tpuvsr/engine/canon.py`` for the port's flat rows.  Before a
successor is fingerprinted it is mapped to the least element of its
orbit under the cfg's SYMMETRY group, so every orbit-mate dedups against
one FPSet entry (TLC's SYMMETRY; VSR.cfg declares
``Permutations(Values)``, and the family's cfgs bind the same name).
The image is used only to compute the fingerprint: the frontier keeps
the generated successor, so trace replay walks real states.

The group is an identity-first ``[P, V+1]`` value-id table
(``group_table``), and it acts on a state through the kernel's
``_permuted`` where it has one (VSR and the family), else through its
``SYM_PLANES`` table (``{plane: "all" | ("col", i)}``).  ``orbit_planes``
reads that table, or the family's ``PERM_REP_KEYS`` / ``PERM_MSG_KEYS``.
An image's key is the concatenation of the symmetric planes in sorted
plane-name order, each in C order of its dense shape, compared as
uint32; the least image wins, a tie keeps the earlier one.

A permutation relabels each code ``c`` of those planes (or columns) in
one of three ways, K9's modes (``MODES``, ``relabel_by_mode``); a
kernel states its own in ``CANON_MODE``, which its ``_permuted`` and K9
both follow:

* ``plain``: ``c`` is a value id, ``perm[c]`` with JAX's gather
  semantics (``relabel``): VSR's operation columns, ST03, AS04, AL05;
* ``packed``: ``c`` is ``vid << shift | view`` (A01's entries, I01,
  RR05): for ``c > 0`` only ``vid`` is relabelled, ``c <= 0`` stays;
* ``noop``: ids above V are fixed (CP06's NoOp, V + 1), the others are
  clipped into ``0..V`` and relabelled.

``CanonSpec.canonicalize`` takes a batch of flat rows ``[n, lanes]``
int32 (the layout of ``engine/pack.py``): a CPU tensor goes to
``canonicalize_plain``, the plain PyTorch version of the JAX function, a
CUDA tensor to kernel K9 (``csrc/canon.cu``) in the kernel's mode.
Images of a row differ only at the lanes a permutation relabels, so the
first difference of two keys lies at one of them: K9 compares images at
those lanes alone, read through a host-built table of their flat-lane
indices in key order (``CanonSpec.pos``).
"""

from __future__ import annotations

import hashlib
import json

import numpy as np
import torch

from .. import kernels
from ..core.values import TLAError
from .pack import to_u32

I32 = torch.int32
# K9's relabel modes, in the order of csrc/canon.cu's enum Mode
MODES = ("plain", "packed", "noop")


def kernel_fold_order(kern):
    """Group order a kernel's own fingerprint folds over (the minimum
    over P hashes of a kernel built with a multi-row perm table); 1 =
    unfolded, what the engine builds."""
    perms = getattr(kern, "perms", None)
    if perms is None:
        return 1
    return int(np.asarray(perms).shape[0])


def orbit_planes(kern):
    """The plane -> orbit-action table of a kernel (class or instance):
    which planes a value permutation touches, and how.  ``"all"``
    remaps every lane of the plane, ``("col", i)`` column ``i`` of its
    last axis.  From ``SYM_PLANES``, else the family's ``PERM_REP_KEYS``
    / ``PERM_MSG_KEYS``; None when the kernel declares neither."""
    sp = getattr(kern, "SYM_PLANES", None)
    if sp:
        return dict(sp)
    rep = tuple(getattr(kern, "PERM_REP_KEYS", ()) or ())
    msg = tuple(getattr(kern, "PERM_MSG_KEYS", ()) or ())
    if not rep and not msg:
        return None
    return {k: "all" for k in rep + msg}


def group_closed(perms):
    """True iff {identity} + perms is closed under composition (each
    perm a dict ModelValue -> ModelValue, identity pairs dropped): the
    least image over the enumerated perms is orbit-invariant only for a
    closed group."""
    frozen = {frozenset(p.items()) for p in perms}
    frozen.add(frozenset())
    for p in perms:
        for q in perms:
            comp = {}
            keys = set(p) | set(q)
            for k in keys:
                v = p.get(q.get(k, k), q.get(k, k))
                if v is not k:
                    comp[k] = v
            if frozenset(comp.items()) not in frozen:
                return False
    return True


def group_table(spec, codec):
    """The binding's SYMMETRY group as an identity-first ``[P, V+1]``
    value-id table, its closure enforced loudly."""
    from ..models.registry import value_perm_table
    if not group_closed(spec.symmetry_perms):
        raise TLAError(
            "SYMMETRY permutation set is not closed under composition "
            "(plus identity): orbit canonicalization would be "
            "orbit-dependent and the checker would under- or "
            "over-merge states.  TLC's Permutations(S) is always "
            "closed; hand-written SYMMETRY sets must be too")
    return value_perm_table(spec, codec, fold_symmetry=True)


def relabel(perm, v):
    """``perm[v]`` with JAX's gather semantics for an index out of range
    (a negative one counts from the end, then the index is clamped into
    the table); no reachable state holds such a value."""
    n = perm.shape[0]
    i = v.long()
    i = torch.where(i < 0, i + n, i).clamp(0, n - 1)
    return perm[i].to(v.dtype)


def relabel_by_mode(perm, v, mode, shift=0, V=0):
    """A permutation ``perm`` [V+1] on a plane of codes ``v`` in one of
    K9's modes (``MODES``):

    * ``plain``: ``relabel`` (``tpuvsr/models/st03_kernel.py:773``);
    * ``packed``: codes ``vid << shift | view``; for ``v > 0`` the value
      id relabelled and the view kept, ``v <= 0`` unchanged
      (``tpuvsr/models/a01_kernel.py:42``);
    * ``noop``: ids past V unchanged, the others clipped into ``0..V``
      and relabelled (``tpuvsr/models/cp06_kernel.py:66``)."""
    if mode == "plain":
        return relabel(perm, v)
    if mode == "packed":
        vid = relabel(perm, v >> shift)
        return torch.where(v > 0, (vid << shift) | (v & ((1 << shift) - 1)),
                           v)
    if mode == "noop":
        return torch.where(v > V, v, perm[v.clamp(0, V).long()].to(v.dtype))
    raise TLAError(f"no K9 relabel mode {mode!r} (one of {MODES})")


def relabel_mode(kern):
    """K9's (mode, shift) for a kernel: its ``CANON_MODE``, by which its
    ``_permuted`` relabels too; a kernel with no ``_permuted`` relabels
    through its ``SYM_PLANES`` table, plainly.  A kernel with a
    ``_permuted`` and no known mode is refused."""
    if not hasattr(kern, "_permuted"):
        return "plain", 0
    mode = getattr(kern, "CANON_MODE", None)
    if mode is None or mode[0] not in MODES:
        raise TLAError(
            f"{type(kern).__name__} relabels through its _permuted but "
            f"names no K9 mode (CANON_MODE = (one of {MODES}, shift)), "
            f"but {mode!r}: the device canonicalization cannot follow it")
    return mode[0], int(mode[1])


def _lex_less(a, b):
    """Row-wise lexicographic a < b over two ``[n, K]`` key matrices:
    the first differing column decides."""
    neq = a != b
    i = torch.argmax(neq.to(torch.int8), dim=1)[:, None]
    return neq.any(dim=1) & (a.gather(1, i)[:, 0] < b.gather(1, i)[:, 0])


class CanonSpec:
    """Canonicalization for one (binding, codec, kernel): ``canonicalize``
    maps flat rows to the least elements of their orbits.  ``mode`` and
    ``shift`` are K9's relabelling (``relabel_mode``), ``kernel`` the
    name its launches count under (the model's ``CANON_KERNEL``)."""

    def __init__(self, group, planes, kern):
        self.group = np.asarray(group, np.int32)     # [P, V+1], id 1st
        self.planes = dict(planes)
        self.kern = kern
        payload = json.dumps(
            {"group": self.group.tolist(),
             "planes": {k: list(v) if isinstance(v, tuple) else v
                        for k, v in sorted(self.planes.items())}},
            sort_keys=True)
        #: digest of (group table, orbit plane table), the same as the
        #: JAX package's for the same group and planes
        self.version = "canon/1:" + hashlib.sha256(
            payload.encode()).hexdigest()[:16]
        self.pos = self._positions(kern.pk)
        name, self.shift = relabel_mode(kern)
        self.mode = MODES.index(name)
        self.kernel = getattr(kern, "CANON_KERNEL", "vsr_canon")
        self._dev = {}

    @property
    def perms(self):
        """Group order, identity included."""
        return int(self.group.shape[0])

    def manifest(self):
        """Checkpoint-manifest record of this canonicalization spec."""
        return {"version": self.version, "perms": self.perms,
                "planes": sorted(self.planes)}

    def _positions(self, pk):
        """Flat-lane indices, in key order, of the lanes a permutation
        may change: the symmetric planes by sorted name, each in C order
        of its dense shape, restricted to the relabelled column."""
        span = {k: (a, s) for k, s, a, _e in pk._splits}
        pos = []
        for k in sorted(self.planes):
            a, shape = span[k]
            idx = np.arange(int(np.prod(shape)))
            how = self.planes[k]
            if how != "all":
                idx = idx.reshape(shape)[..., int(how[1])].reshape(-1)
            pos.append(a + idx)
        return np.concatenate(pos).astype(np.int32)

    def tables(self, device):
        """The group and position tables on ``device`` (cached: a CUDA
        graph that launches K9 holds their addresses)."""
        key = str(torch.device(device))
        t = self._dev.get(key)
        if t is None:
            t = {"group": torch.as_tensor(self.group).to(device),
                 "pos": torch.as_tensor(self.pos).to(device)}
            self._dev[key] = t
        return t

    # ------------------------------------------------------------------
    def _apply(self, st, perm):
        """One permutation's action on a batch of dense states: the
        kernel's own ``_permuted`` where it has one, else the
        ``SYM_PLANES`` table action."""
        if hasattr(self.kern, "_permuted"):
            return self.kern._permuted(st, perm)
        out = dict(st)
        for k, how in self.planes.items():
            v = st[k]
            if how == "all":
                out[k] = relabel(perm, v)
            else:
                col = int(how[1])
                v = v.clone()
                v[..., col] = relabel(perm, v[..., col])
                out[k] = v
        return out

    def _key(self, st):
        """``[n, K]`` comparison keys of a batch of images: the flattened
        symmetric planes as uint32 (planes no permutation touches are
        equal across images and never decide)."""
        n = st[next(iter(self.planes))].shape[0]
        return torch.cat([to_u32(st[k]).reshape(n, -1)
                          for k in sorted(self.planes)], dim=1)

    def canonicalize_plain(self, rows):
        """The plain PyTorch version of K9 (any device): the least image
        of each row over the group, by the JAX package's fold over the
        images in table order."""
        pk = self.kern.pk
        group = self.tables(rows.device)["group"]
        st = pk.unflatten(rows)
        img = self._apply(st, group[0])
        best, bkey = pk.flatten(img), self._key(img)
        for p in range(1, self.perms):
            img = self._apply(st, group[p])
            ckey = self._key(img)
            less = _lex_less(ckey, bkey)[:, None]
            bkey = torch.where(less, ckey, bkey)
            best = torch.where(less, pk.flatten(img), best)
        return best

    def canonicalize(self, rows, out=None):
        """``[n, lanes]`` int32 flat rows -> the least elements of their
        orbits, written to ``out`` when given: K9 on a CUDA tensor, the
        plain version on a CPU one."""
        if rows.device.type == "cpu":
            res = self.canonicalize_plain(rows)
            return res if out is None else out.copy_(res)
        return self._canon_kernel(rows, out)

    def _canon_kernel(self, rows, out):
        n, lanes = rows.shape
        t = self.tables(rows.device)
        if out is None:
            out = torch.empty_like(rows)
        ck = kernels.check
        kernels.launch(
            self.kernel, "tpuvsr_canon",
            ck(rows, "rows", I32, (n, self.kern.pk.lanes)), n, lanes,
            t["group"].data_ptr(), self.perms, self.group.shape[1],
            t["pos"].data_ptr(), int(self.pos.shape[0]), self.mode,
            self.shift, ck(out, "out", I32, (n, lanes)),
            kernels.stream_of(rows))
        return out

    def fingerprint_fn(self, kern):
        """``rows -> kern.fingerprint(canonicalize(rows))``: the
        fingerprint the engine stores when symmetry is on."""
        return lambda rows: kern.fingerprint(self.canonicalize(rows))


def build_canon_spec(spec, codec, kern, symmetry="auto"):
    """Resolve the engine's ``symmetry`` switch into a CanonSpec or None.

    ``"auto"``: canonicalize iff the cfg declares SYMMETRY (TLC's
    meaning).  ``True`` insists (a cfg without SYMMETRY is an error);
    ``False`` turns the reduction off (every orbit member is stored)."""
    enabled = (bool(spec.symmetry_perms) if symmetry == "auto"
               else bool(symmetry))
    if not enabled:
        return None
    if not spec.symmetry_perms:
        raise TLAError(
            "symmetry canonicalization requested (-symmetry on) but "
            "the cfg declares no SYMMETRY — there is no permutation "
            "group to reduce by")
    planes = orbit_planes(kern)
    if planes is None:
        raise TLAError(
            f"kernel {type(kern).__name__} declares no orbit plane "
            f"table (SYM_PLANES or PERM_REP_KEYS/PERM_MSG_KEYS): the "
            f"device canonicalization pass cannot know which planes "
            f"a value permutation touches.  Run -symmetry off or add "
            f"the table")
    missing = [k for k in planes if k not in codec.zero_state()]
    if missing:
        raise TLAError(
            f"orbit plane table names planes {missing} the codec "
            f"layout does not declare (lint/kernel drift)")
    return CanonSpec(group_table(spec, codec), planes, kern=kern)
