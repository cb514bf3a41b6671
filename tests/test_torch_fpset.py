"""Parity of the port's FPSet (K1 insert, K2 dedup, query, grow) with
the JAX package's, on the CPU (the port's plain PyTorch versions).

Inputs are made with numpy from fixed seeds and fed to both packages;
everything compared is integer, so the tolerance is 0.  FPSet slot
positions are compared as sets: the JAX scatter lets an arbitrary writer
win a slot, so only membership is a contract."""

import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpuvsr.engine import fpset as J
from tpuvsr_torch import kernels
from tests.test_torch_threads import one_torch_thread  # noqa: F401
from tpuvsr_torch.engine import fpset as P
from tpuvsr_torch.engine.carry import table_from_numpy
from tpuvsr_torch.testing import DEDUP_CASES, dedup_case


def _fps(rng, n):
    return rng.integers(0, 2**32, size=(n, 4), dtype=np.uint64).astype(
        np.uint32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32).copy())


def _members(slots):
    s = np.asarray(slots).view(np.uint32)
    return set(map(tuple, s[s[:, 0] != 0, :4]))


def _jax_table(cap, pre):
    t = J.empty_table(cap)
    t, _, _ = J.insert_batch(t, jnp.asarray(pre),
                             jnp.ones(len(pre), bool))
    return np.asarray(t["slots"])


@pytest.mark.parametrize("seed", range(8))
def test_insert_matches_jax_near_full_and_overflow(seed):
    """Random batches drawn from a small pool (in-batch duplicates,
    word-0 zeros, high bits) into tables 30-95% full: fresh mask,
    overflow flag and membership equal the JAX insert_core's."""
    rng = np.random.default_rng(seed)
    cap = 1 << int(rng.integers(4, 9))
    pool = _fps(rng, 3 * cap)
    pool[:4, 0] = 0
    pool[4] = 0xFFFFFFFF
    pre = pool[rng.integers(0, len(pool), int(cap * rng.uniform(0.3, 0.95)))]
    slots0 = _jax_table(cap, pre)
    batch = pool[rng.integers(0, len(pool), int(rng.integers(8, 3 * cap)))]
    mask = rng.random(len(batch)) < 0.8
    jt, jf, jo = J.insert_batch({"slots": jnp.asarray(slots0)},
                                jnp.asarray(batch), jnp.asarray(mask))
    pt = table_from_numpy(slots0, device="cpu")
    pt, pf, po = P.insert_core(pt, _t(batch), torch.from_numpy(mask))
    assert np.array_equal(np.asarray(jf), pf.numpy())
    assert bool(jo) == po
    assert _members(jt["slots"]) == _members(pt["slots"].numpy())


def test_insert_overflow_is_exercised():
    """A table with every slot taken overflows every lane of a fresh
    batch in both packages, and inserts nothing."""
    rng = np.random.default_rng(11)
    cap = 64
    slots0 = _jax_table(cap, _fps(rng, 4 * cap))
    assert (slots0[:, 0] != 0).all()
    batch = _fps(rng, 16)
    mask = np.ones(16, bool)
    jt, jf, jo = J.insert_batch({"slots": jnp.asarray(slots0)},
                                jnp.asarray(batch), jnp.asarray(mask))
    pt, pf, po = P.insert_core(table_from_numpy(slots0, device="cpu"),
                               _t(batch), torch.from_numpy(mask))
    assert bool(jo) and po
    assert not np.asarray(jf).any() and not pf.any()
    assert _members(jt["slots"]) == _members(pt["slots"].numpy())


@pytest.mark.parametrize("seed", range(6))
def test_dedup_matches_jax(seed):
    """K2's queue-order keep mask equals zeros.at[perm].set(keep) of
    the JAX dedup_batch: duplicates, masked lanes, high bits, and the
    all-ones fingerprint that sorts among the masked-out lanes."""
    rng = np.random.default_rng(100 + seed)
    pool = _fps(rng, 40)
    pool[0] = 0xFFFFFFFF
    pool[1] = [0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFE]
    pool[2] = 0
    pool[3, 0] = 0x80000000
    batch = pool[rng.integers(0, len(pool), 300)]
    mask = rng.random(300) < 0.7
    perm, keep = J.dedup_batch(jnp.asarray(batch), jnp.asarray(mask))
    want = np.zeros(300, bool)
    want[np.asarray(perm)] = np.asarray(keep)
    got = P.dedup_keep(_t(batch), torch.from_numpy(mask)).numpy()
    assert np.array_equal(want, got)
    pp, pk = P.dedup_batch(_t(batch), torch.from_numpy(mask))
    assert np.array_equal(np.asarray(perm), pp.numpy())
    assert np.array_equal(np.asarray(keep), pk.numpy())


@pytest.mark.parametrize("name", DEDUP_CASES)
def test_dedup_case_matches_jax(name):
    """K2's plain version on each case of ``testing.dedup_case`` (n = 1,
    all masked out, all equal, all-ones fingerprints among masked-out
    lanes, the hunt's 4,096, n at the one-block limit and one past it)
    equals the JAX dedup_batch scattered to queue order."""
    c = dedup_case(name)
    u32 = c.fps.view(np.uint32)
    perm, keep = J.dedup_batch(jnp.asarray(u32), jnp.asarray(c.mask))
    want = np.zeros(len(c.mask), bool)
    want[np.asarray(perm)] = np.asarray(keep)
    got = P.dedup_keep(torch.from_numpy(c.fps.copy()),
                       torch.from_numpy(c.mask)).numpy()
    assert np.array_equal(want, got)
    if name == "all_masked":
        assert not got.any()
    if name == "all_equal":
        assert got.sum() == 1


def test_dedup_block_max_matches_the_kernel_source():
    """The wrapper's one-block limit is the kernel's: a batch the kernel
    would send down its scratch path gets scratch from the wrapper."""
    src = open(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tpuvsr_torch", "csrc",
        "dedup.cu")).read()
    m = re.search(r"constexpr int BLOCK_MAX = (\d+);", src)
    assert m and int(m.group(1)) == P.DEDUP_BLOCK_MAX
    # and the entry point the wrapper calls with or without scratch
    sig = re.search(r"TPUVSR_EXPORT int tpuvsr_dedup_batch\((.*?)\)", src,
                    re.S).group(1)
    kinds = "".join("p" if "*" in a else "q" if "long long" in a else "i"
                    for a in sig.split(","))
    assert kinds == kernels._ENTRY["tpuvsr_dedup_batch"]


def test_carried_table_answers_queries_like_jax():
    """A JAX-built table carried through table_from_numpy answers
    query_core exactly as the JAX query_core does, and table_stats
    agree."""
    rng = np.random.default_rng(7)
    cap = 256
    pre = _fps(rng, 200)
    pre[:3, 0] = 0
    slots0 = _jax_table(cap, pre)
    probe = np.concatenate([pre[rng.integers(0, 200, 100)], _fps(rng, 100)])
    mask = rng.random(200) < 0.9
    jf, jo = J.query_core({"slots": jnp.asarray(slots0)},
                          jnp.asarray(probe), jnp.asarray(mask))
    pt = table_from_numpy(slots0, device="cpu")
    pf, po = P.query_core(pt, _t(probe), torch.from_numpy(mask))
    assert np.array_equal(np.asarray(jf), pf.numpy()) and bool(jo) == po
    assert J.table_stats(slots0) == P.table_stats(pt["slots"])


def test_grow_keeps_membership():
    rng = np.random.default_rng(3)
    t = P.empty_table(64, "cpu")
    fps = _fps(rng, 40)
    t, fresh, ovf = P.insert_core(t, _t(fps), torch.ones(40, dtype=torch.bool))
    assert fresh.all() and not ovf
    g = P.grow(t)
    assert g["slots"].shape[0] == 256
    assert _members(g["slots"].numpy()) == _members(t["slots"].numpy())
    f2, _ = P.query_core(g, _t(fps), torch.ones(40, dtype=torch.bool))
    assert not f2.any()


def test_table_from_numpy_refuses_bad_shapes():
    from tpuvsr_torch.core.values import TLAError
    with pytest.raises(TLAError):
        table_from_numpy(np.zeros((48, 5), np.uint32), device="cpu")
    with pytest.raises(TLAError):
        table_from_numpy(np.zeros((64, 4), np.uint32), device="cpu")
