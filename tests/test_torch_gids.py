"""Parity of the port's FPSet gid column (K11's plain versions:
``store_gids``, ``lookup_gids``, ``insert_gids``, ``query_core`` and
``grow`` with a column) with the JAX package's, on the CPU, and the C
entry points of every hand kernel against the ctypes table.

Inputs are made with numpy from fixed seeds and fed to both packages:
fingerprints with word-0 zeros and high bits, tables 30-100% full, and
lanes that run out of probes.  Everything compared is integer, so the
tolerance is 0.  Where JAX lets any writer win (slot positions of an
insert, two lanes of one fingerprint storing into one slot) the contract
is set equality, compared as fingerprint -> gid maps."""

import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpuvsr.engine import fpset as J
from tests.test_torch_threads import one_torch_thread  # noqa: F401
from tpuvsr_torch import kernels
from tpuvsr_torch.engine import fpset as P
from tpuvsr_torch.engine.carry import table_from_numpy


def _fps(rng, n):
    f = rng.integers(0, 2**32, size=(n, 4), dtype=np.uint64).astype(
        np.uint32)
    f[::7, 0] = 0                     # tag remapped 0 -> 1
    f[1::5, 1:] |= np.uint32(0x80000000)
    return f


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32).copy())


def _jax_table(cap, pre):
    t = J.empty_table(cap)
    t, _, _ = J.insert_batch(t, jnp.asarray(pre), jnp.ones(len(pre), bool))
    return np.asarray(t["slots"])


def _gid_map(slots, vals):
    """{keyed fingerprint: gid} of every occupied slot with a gid."""
    s = np.asarray(slots).view(np.uint32)
    v = np.asarray(vals).view(np.int32)
    occ = (s[:, 0] != 0) & (v >= 0)
    return {tuple(r): int(g) for r, g in zip(s[occ, :4], v[occ])}


def _keyed(f):
    k = np.array(f, np.uint32).copy()
    k[:, 0] = np.where(k[:, 0] == 0, 1, k[:, 0])
    return k


def _table_case(seed, load):
    rng = np.random.default_rng(seed)
    cap = 1 << int(rng.integers(5, 9))
    pre = np.unique(_fps(rng, int(cap * load)), axis=0)
    pre = pre[rng.permutation(len(pre))]
    slots = _jax_table(cap, pre)
    return rng, cap, pre, slots


@pytest.mark.parametrize("seed,load", [(s, l) for s in range(4)
                                       for l in (0.3, 0.7, 0.95)])
def test_store_gids_matches_jax(seed, load):
    """Distinct stored fingerprints (some masked out) and absent ones:
    the columns are equal bit for bit."""
    rng, cap, pre, slots = _table_case(seed, load)
    absent = _fps(rng, 16)
    fps = np.concatenate([pre, absent])
    fps = fps[rng.permutation(len(fps))]
    gids = rng.integers(-2**31, 2**31, len(fps)).astype(np.int32)
    mask = rng.random(len(fps)) < 0.8
    vals0 = rng.integers(-1, 1000, cap).astype(np.int32)
    want = J.store_gids(jnp.asarray(slots), jnp.asarray(vals0),
                        jnp.asarray(fps), jnp.asarray(gids),
                        jnp.asarray(mask))
    got = P.store_gids(_t(slots), torch.from_numpy(vals0.copy()), _t(fps),
                       torch.from_numpy(gids), torch.from_numpy(mask))
    assert np.array_equal(np.asarray(want), got.numpy())


def test_store_gids_duplicate_lanes_any_writer_wins():
    """Two masked lanes of one fingerprint: each package keeps one of
    their gids at that slot, and every other slot is equal."""
    rng, cap, pre, slots = _table_case(21, 0.6)
    fps = np.concatenate([pre, pre[:10]])
    gids = np.arange(len(fps), dtype=np.int32) + 100
    mask = np.ones(len(fps), bool)
    vals0 = np.full(cap, -1, np.int32)
    want = np.asarray(J.store_gids(jnp.asarray(slots), jnp.asarray(vals0),
                                   jnp.asarray(fps), jnp.asarray(gids),
                                   jnp.asarray(mask)))
    got = P.store_gids(_t(slots), torch.from_numpy(vals0.copy()), _t(fps),
                       torch.from_numpy(gids), torch.from_numpy(mask)).numpy()
    wm, gm = _gid_map(slots, want), _gid_map(slots, got)
    assert wm.keys() == gm.keys() == set(map(tuple, _keyed(pre)))
    for i, k in enumerate(map(tuple, _keyed(pre))):
        allowed = {int(gids[i])} | ({int(gids[len(pre) + i])}
                                    if i < 10 else set())
        assert wm[k] in allowed and gm[k] in allowed
        if i >= 10:
            assert wm[k] == gm[k]


@pytest.mark.parametrize("seed,load", [(s, l) for s in range(4)
                                       for l in (0.3, 0.7, 0.95)])
def test_lookup_gids_matches_jax(seed, load):
    """Stored, absent and masked-out fingerprints, some stored without a
    gid (-1 in the column): the lookups are equal."""
    rng, cap, pre, slots = _table_case(100 + seed, load)
    vals = np.where(rng.random(cap) < 0.8,
                    rng.integers(0, 2**31 - 1, cap), -1).astype(np.int32)
    probe = np.concatenate([pre[rng.integers(0, len(pre), 3 * cap // 4)],
                            _fps(rng, cap // 4)])
    mask = rng.random(len(probe)) < 0.9
    want = J.lookup_gids({"slots": jnp.asarray(slots)}, jnp.asarray(vals),
                         jnp.asarray(probe), jnp.asarray(mask))
    got = P.lookup_gids({"slots": _t(slots)}, torch.from_numpy(vals),
                        _t(probe), torch.from_numpy(mask))
    assert np.array_equal(np.asarray(want), got.numpy())
    assert (got.numpy()[~mask] == -1).all()


@pytest.mark.parametrize("seed", range(4))
def test_query_core_matches_jax_at_high_load(seed):
    rng, cap, pre, slots = _table_case(200 + seed, 0.97)
    probe = np.concatenate([pre, _fps(rng, cap)])
    mask = rng.random(len(probe)) < 0.85
    jf, jo = J.query_core({"slots": jnp.asarray(slots)}, jnp.asarray(probe),
                          jnp.asarray(mask))
    pf, po = P.query_core({"slots": _t(slots)}, _t(probe),
                          torch.from_numpy(mask))
    assert np.array_equal(np.asarray(jf), pf.numpy())
    assert bool(jo) == po


def test_lanes_that_run_out_of_probes():
    """A table with every slot taken: an absent fingerprint is not found
    in 64 probes, so the lookup gives -1, the store writes nothing and
    the query raises overflow, in both packages."""
    rng = np.random.default_rng(5)
    cap = 64
    slots = _jax_table(cap, _fps(rng, 4 * cap))
    assert (slots[:, 0] != 0).all()
    absent = _fps(rng, 12)
    mask = np.ones(12, bool)
    vals0 = np.arange(cap, dtype=np.int32)
    got_l = P.lookup_gids({"slots": _t(slots)}, torch.from_numpy(vals0),
                          _t(absent), torch.from_numpy(mask))
    want_l = J.lookup_gids({"slots": jnp.asarray(slots)},
                           jnp.asarray(vals0), jnp.asarray(absent),
                           jnp.asarray(mask))
    assert (got_l.numpy() == -1).all()
    assert np.array_equal(np.asarray(want_l), got_l.numpy())
    got_s = P.store_gids(_t(slots), torch.from_numpy(vals0.copy()),
                         _t(absent), torch.full((12,), 7, dtype=torch.int32),
                         torch.from_numpy(mask))
    assert np.array_equal(got_s.numpy(), vals0)
    pf, po = P.query_core({"slots": _t(slots)}, _t(absent),
                          torch.from_numpy(mask))
    jf, jo = J.query_core({"slots": jnp.asarray(slots)},
                          jnp.asarray(absent), jnp.asarray(mask))
    assert po and bool(jo) and not pf.any() and not np.asarray(jf).any()


@pytest.mark.parametrize("seed", range(4))
def test_insert_gids_matches_jax(seed):
    """insert_gids into a table that already holds some of the batch:
    the fresh count, the overflow flag and the fingerprint -> gid map
    are equal (slot positions are JAX's any-writer scatter)."""
    rng, cap, pre, slots = _table_case(300 + seed, 0.4)
    vals0 = np.full(cap, -1, np.int32)
    vals0[slots[:, 0] != 0] = 5
    batch = np.unique(np.concatenate([pre[:8], _fps(rng, cap // 3)]),
                      axis=0)
    batch = batch[rng.permutation(len(batch))]
    gids = (np.arange(len(batch)) + 1000).astype(np.int32)
    mask = rng.random(len(batch)) < 0.9
    jt, jv, jo, jn = J.insert_gids({"slots": jnp.asarray(slots)},
                                   jnp.asarray(vals0), jnp.asarray(batch),
                                   jnp.asarray(gids), jnp.asarray(mask))
    pt = table_from_numpy(slots, device="cpu")
    pt, pv, po, pn = P.insert_gids(pt, torch.from_numpy(vals0.copy()),
                                   _t(batch), torch.from_numpy(gids),
                                   torch.from_numpy(mask))
    assert int(jn) == int(pn) and bool(jo) == bool(po)
    assert _gid_map(jt["slots"], jv) == _gid_map(pt["slots"].numpy(),
                                                 pv.numpy())


@pytest.mark.parametrize("factor", [4, 2])
def test_grow_carries_the_gid_column(factor):
    """grow of a table with a gid column: every stored gid follows its
    fingerprint to the larger table, as in the JAX grow, and a lookup
    there finds it."""
    rng = np.random.default_rng(40 + factor)
    cap = 128
    fps = np.unique(_fps(rng, 110), axis=0)
    gids = rng.permutation(len(fps)).astype(np.int32)
    jt = J.empty_table(cap)
    jt, jv, _o, _n = J.insert_gids(jt, jnp.full((cap,), -1, jnp.int32),
                                   jnp.asarray(fps), jnp.asarray(gids),
                                   jnp.ones(len(fps), bool))
    jt["gids"] = jv
    jg = J.grow(jt, factor)
    pt = table_from_numpy(np.asarray(jt["slots"]), device="cpu")
    pt["gids"] = torch.from_numpy(np.asarray(jv).copy())
    pg = P.grow(pt, factor)
    assert pg["slots"].shape[0] == np.asarray(jg["slots"]).shape[0] \
        == cap * factor
    assert _gid_map(pg["slots"].numpy(), pg["gids"].numpy()) \
        == _gid_map(jg["slots"], jg["gids"]) \
        == dict(zip(map(tuple, _keyed(fps)), gids.tolist()))
    got = P.lookup_gids(pg, pg["gids"], _t(fps),
                        torch.ones(len(fps), dtype=torch.bool))
    assert np.array_equal(got.numpy(), gids)
    assert "gids" not in P.grow({"slots": pt["slots"]})


# ----------------------------------------------------------------------
# the C entry points of every kernel against the ctypes table
# ----------------------------------------------------------------------
def expand_macros(src):
    """A kernel source with its argument-list macros (vsr_fingerprint.cu's
    layout arguments) and its entry-point macros (st03_guards.cu's and
    st03_actions.cu's ``M(name, MODEL)``, one entry a model) written
    out, so each ``TPUVSR_EXPORT int tpuvsr_...(...)`` reads whole."""
    for name, body in re.findall(
            r"#define (\w+_ARGS)((?:[^\n]*\\\n)*[^\n]*)", src):
        src = src.replace(name + ",", body.replace("\\", "") + ",")
    for macro, body in re.findall(
            r"#define (\w+_ENTRY)\(name, MODEL\)((?:[^\n]*\\\n)*[^\n]*)",
            src):
        body = body.replace("\\", "")
        src = re.sub(rf"^{macro}\((\w+), (\w+)\)$",
                     lambda m: body.replace("##name##", m.group(1))
                     .replace("MODEL", m.group(2)), src, flags=re.M)
    return src


def _entries():
    out = []
    for stem in kernels.SOURCES:
        src = expand_macros(open(os.path.join(kernels.CSRC,
                                              f"{stem}.cu")).read())
        for m in re.finditer(r"TPUVSR_EXPORT int (tpuvsr_\w+)\((.*?)\)",
                             src, re.S):
            out.append((stem, m.group(1), m.group(2)))
    return out


@pytest.mark.parametrize("stem,entry,args", _entries(),
                         ids=[e[1] for e in _entries()])
def test_entry_signature_matches_the_ctypes_table(stem, entry, args):
    def kind(a):
        if "*" in a:
            return "p"
        if "long long" in a:
            return "q"
        return "f" if "float" in a else "i"
    assert "".join(kind(a) for a in args.split(",")) == kernels._ENTRY[entry]
    assert entry in kernels._ENTRY


def test_every_ctypes_entry_and_kernel_has_a_source():
    names = {e[1] for e in _entries()}
    assert set(kernels._ENTRY) == names
    for stem, _replaces in kernels.KERNELS.values():
        assert os.path.exists(os.path.join(kernels.CSRC, f"{stem}.cu"))
    assert {"fpset_store_gids", "fpset_probe", "edge_emit"} <= \
        set(kernels.KERNELS)
