"""Parity of the port's counter-based random numbers (tpuvsr_torch/sim/
rng.py, the plain twin of kernel K5) with jax.random on the CPU.

Everything is compared bit for bit (tolerance 0): keys, bits and
uniforms are integer or exact float operations; gumbel, normal and
erf_inv copy XLA's CPU float code operation for operation (Cephes
log/log1p, Giles' erf_inv, with the fused multiply-adds XLA's code
generator emits).  A mismatch is reported as how many of N values
differ and by how many ulps."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_threads import one_torch_thread  # noqa: F401
from tpuvsr_torch.sim import rng

SEEDS = [0, 1, 2, 2**31 - 1]
WALK_IDS = np.array([0, 1, 5, 4095, 2**31 - 1, 2**31, 2**31 + 7,
                     2**32 - 1], np.uint32)
N_LANES = 699           # VSRKernel.n_lanes at MAX_MSGS=48 (the hunt's)
ACTION_LANES = [3, 48, 48, 3, 48, 48, 3, 48, 9, 48, 48, 3, 144, 48, 48,
                3, 48, 48, 3]
LOGW = np.log(np.array([3, 1, 1, 2, 1, 1, 2, 2, 2, 1, 1, 1, 6, 1, 1, 1,
                        1, 1, 1.0])).astype(np.float32)


def ulps(want, got):
    """(values that differ, largest difference in ulps)."""
    a = np.asarray(want, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(got, np.float32).view(np.int32).astype(np.int64)
    d = np.abs(a - b)
    return int((d != 0).sum()), int(d.max()) if d.size else 0


def assert_bits(want, got, what):
    n, worst = ulps(want, got)
    assert n == 0, (f"{what}: {n} of {np.asarray(want).size} values "
                    f"differ, by up to {worst} ulps")


def t64(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


@pytest.fixture(scope="module")
def walker_keys():
    """{seed: (JAX walker keys [8, 2] uint32, port keys)}."""
    out = {}
    for seed in SEEDS:
        jk = jax.random.PRNGKey(seed)
        pk = rng.prng_key(seed)
        assert np.array_equal(np.asarray(jk).astype(np.int64), pk.numpy())
        jw = np.asarray(jax.vmap(jax.random.fold_in, in_axes=(None, 0))(
            jk, WALK_IDS))
        out[seed] = (jw, rng.fold_in(pk[None], t64(WALK_IDS)))
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_matches_jax(walker_keys, seed):
    jw, pw = walker_keys[seed]
    assert np.array_equal(jw.astype(np.int64), pw.numpy())
    # step keys and the two-stage keys of a step, as the chunk folds them
    for d in (0, 7, 39):
        jd = np.asarray(jax.vmap(jax.random.fold_in, in_axes=(0, None))(
            jw, jnp.uint32(d)))
        pd = rng.fold_in(pw, d)
        assert np.array_equal(jd.astype(np.int64), pd.numpy())
        for x in (1, 2, 0xA5A5):
            jx = np.asarray(jax.vmap(jax.random.fold_in,
                                     in_axes=(0, None))(jd, jnp.uint32(x)))
            assert np.array_equal(jx.astype(np.int64),
                                  rng.fold_in(pd, x).numpy())


@pytest.mark.parametrize("n", [1, 19, N_LANES])
@pytest.mark.parametrize("seed", SEEDS)
def test_draws_match_jax(walker_keys, seed, n):
    jw, pw = walker_keys[seed]
    bits = np.asarray(jax.vmap(lambda k: jax.random.bits(k, (n,)))(jw))
    assert np.array_equal(bits.astype(np.int64),
                          rng.random_bits(pw, n).numpy())
    for name, jf, pf in (
            ("uniform", lambda k: jax.random.uniform(k, (n,)),
             lambda k: rng.uniform(k, n)),
            ("gumbel", lambda k: jax.random.gumbel(k, (n,)),
             lambda k: rng.gumbel(k, n)),
            ("normal", lambda k: jax.random.normal(k, (n,)),
             lambda k: rng.normal(k, n))):
        assert_bits(jax.jit(jax.vmap(jf))(jw), pf(pw), f"{name} n={n}")


def test_float_draws_match_jax_on_many_keys():
    keys = np.asarray(jax.vmap(jax.random.fold_in, in_axes=(None, 0))(
        jax.random.PRNGKey(7), np.arange(4096, dtype=np.uint32)))
    pk = t64(keys)
    assert_bits(jax.jit(jax.vmap(lambda k: jax.random.gumbel(k, (64,))))(
        keys), rng.gumbel(pk, 64), "gumbel")
    assert_bits(jax.jit(jax.vmap(lambda k: jax.random.normal(k, (64,))))(
        keys), rng.normal(pk, 64), "normal")


def test_erf_inv_matches_xla():
    x = np.random.default_rng(0).uniform(-1, 1, 100_000).astype(np.float32)
    x = np.concatenate([x, np.float32([
        -1, 1, 0, -0.0, 0.5, 1e-8, -1e-30, 0.99999994, -0.99999994,
        rng.NORMAL_LO, 0.9967, -0.9999])])
    assert_bits(jax.jit(jax.lax.erf_inv)(x),
                rng.erf_inv(torch.from_numpy(x)), "erf_inv")


def test_log_and_log1p_match_xla():
    r = np.random.default_rng(1)
    x = np.concatenate([r.uniform(1e-6, 100, 100_000),
                        10.0 ** r.uniform(-37, 1, 20_000),
                        [rng.TINY, 1.0, 0.5, 88.0]]).astype(np.float32)
    assert_bits(jax.jit(jnp.log)(x), rng.xla_log(torch.from_numpy(x)),
                "log")
    y = r.uniform(-0.999, 3, 100_000).astype(np.float32)
    assert_bits(jax.jit(jnp.log1p)(y), rng.xla_log1p(torch.from_numpy(y)),
                "log1p")


def test_fma_is_correctly_rounded():
    r = np.random.default_rng(2)
    a, b = (r.uniform(-10, 10, 4000).astype(np.float32) for _ in range(2))
    c = (r.uniform(-100, 100, 4000)
         * r.choice([1e-6, 1.0, 1e6], 4000)).astype(np.float32)
    got = rng.fma(torch.from_numpy(a), torch.from_numpy(b),
                  torch.from_numpy(c)).numpy()
    # x86 long double (64-bit mantissa) holds a * b exactly; its one
    # rounding of the sum is far below float32's half ulp
    ld = (a.astype(np.longdouble) * b.astype(np.longdouble)
          + c.astype(np.longdouble)).astype(np.float32)
    assert np.array_equal(got.view(np.int32), ld.view(np.int32))


# ----------------------------------------------------------------------
# K5's plain version against the JAX chunk's draw (fleet.py:374-415)
# ----------------------------------------------------------------------
def _jax_draw(weighted, sigma, lane_aid):
    """The draw lines of tpuvsr/sim/fleet.py:chunk_fn, as compiled
    there (log-weights and sigma are compile-time constants)."""
    n_act, L = len(ACTION_LANES), lane_aid.size
    la, lw = jnp.asarray(lane_aid), jnp.asarray(LOGW)

    def f(key, walk_ids, en, d):
        wkeys = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(
            key, walk_ids)
        wlogw = jnp.zeros((1,))
        if weighted:
            wlogw = jnp.broadcast_to(lw[None, :], (walk_ids.shape[0], n_act))
            if sigma > 0.0:
                nk = jax.vmap(jax.random.fold_in, in_axes=(0, None))(
                    wkeys, jnp.uint32(0xA5A5))
                noise = jax.vmap(lambda k: jax.random.normal(k, (n_act,)))(nk)
                wlogw = wlogw + noise * sigma
        keys = jax.vmap(jax.random.fold_in, in_axes=(0, None))(
            wkeys, d.astype(jnp.uint32))
        if weighted:
            k1 = jax.vmap(jax.random.fold_in, in_axes=(0, None))(
                keys, jnp.uint32(1))
            k2 = jax.vmap(jax.random.fold_in, in_axes=(0, None))(
                keys, jnp.uint32(2))
            act_en = jnp.zeros((en.shape[0], n_act), bool).at[:, la].max(en)
            g = jax.vmap(lambda k: jax.random.gumbel(k, (n_act,)))(k1) \
                + wlogw
            a_star = jnp.argmax(jnp.where(act_en, g, -jnp.inf), axis=1)
            v = jax.vmap(lambda k: jax.random.uniform(k, (L,)))(k2)
            in_act = en & (la[None, :] == a_star[:, None])
            lane = jnp.argmax(jnp.where(in_act, v, -1.0), axis=1)
        else:
            u = jax.vmap(lambda k: jax.random.uniform(k, (L,)))(keys)
            lane = jnp.argmax(jnp.where(en, u, -1.0), axis=1)
        return lane, en.any(axis=1), wkeys, wlogw
    return jax.jit(f)


@pytest.mark.parametrize("weighted,sigma", [(True, 1.0), (True, 0.5),
                                            (True, 0.0), (False, 0.0)])
def test_lane_choice_matches_jax_chunk(weighted, sigma):
    lane_aid = np.concatenate([np.full(n, a, np.int32)
                               for a, n in enumerate(ACTION_LANES)])
    assert lane_aid.size == N_LANES
    W = 512
    f = _jax_draw(weighted, sigma, lane_aid)
    r = np.random.default_rng(3)
    for trial, dens in enumerate((0.003, 0.05, 0.6)):
        en = r.random((W, N_LANES)) < dens
        en[:3] = False                  # rows with no enabled lane
        ids = (np.arange(W) + 2**31 - 100 + 1000 * trial).astype(np.uint32)
        d = np.int32(trial * 13 + 1)
        lane, can, wk, wlogw = f(jax.random.PRNGKey(2), ids, en, d)
        pw = t64(wk)
        pl = None
        if weighted:
            logw = torch.from_numpy(LOGW)
            pl = (rng.swarm_noise(pw, logw, sigma) if sigma > 0.0
                  else logw[None, :].expand(W, -1).contiguous())
            assert_bits(wlogw, pl, "swarm noise")
        got_lane, got_can = rng.choose_lanes(
            pw, int(d), torch.from_numpy(en), torch.from_numpy(lane_aid),
            pl)
        assert np.array_equal(np.asarray(lane), got_lane.numpy())
        assert np.array_equal(np.asarray(can), got_can.numpy())


def test_lane_table_is_the_hunt_kernels():
    """N_LANES and ACTION_LANES are the VSR kernel's at MAX_MSGS=48."""
    import os
    from tpuvsr_torch.engine.spec import load_binding
    from tpuvsr_torch.models.registry import make_model
    cfg = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", "VSR_defect.cfg")
    _codec, kern = make_model(load_binding(cfg, "VSR"), max_msgs=48)
    assert kern.n_lanes == N_LANES
    assert np.array_equal(kern.lane_action, np.concatenate(
        [np.full(n, a, np.int32) for a, n in enumerate(ACTION_LANES)]))


def test_k5_wrappers_take_the_plain_version_on_the_cpu():
    from tpuvsr_torch import kernels
    before = kernels.launch_counts()
    en = torch.zeros((4, N_LANES), dtype=torch.bool)
    en[:, 5] = True
    lane, can = rng.choose_lanes(rng.fold_in(rng.prng_key(0)[None],
                                             torch.arange(4)), 3, en,
                                 torch.zeros(N_LANES, dtype=torch.int32))
    assert lane.tolist() == [5] * 4 and can.all()
    assert kernels.launch_counts() == before
