"""Counter-based random numbers of the walker fleet, bit-exact with
``jax.random`` (threefry2x32, partitionable layout) on the CPU.

The plain PyTorch counterpart of the parts of ``jax.random`` that
``tpuvsr/sim/fleet.py`` calls: ``PRNGKey``, ``fold_in``, 32-bit
``random_bits``, ``uniform``, ``gumbel`` and ``normal``, following
``jax/_src/prng.py`` and ``jax/_src/random.py`` (JAX 0.9.0 with
``jax_threefry_partitionable`` on):

* a key is a pair of uint32 words ``(k0, k1)``; ``prng_key(seed)`` is
  ``(seed >> 32, seed & 0xFFFFFFFF)``, i.e. ``(0, seed)`` for a 32-bit
  seed;
* ``fold_in(key, d)`` hashes the counter pair ``(0, d)`` and takes the
  two output words as the new key; ``split(key, n)`` key ``i`` is
  ``fold_in(key, i)``;
* ``random_bits(key, n)`` word ``i`` is ``x0 ^ x1`` of the hash of the
  counter pair ``(0, i)`` (the uint64 iota split into hi/lo words); a
  draw of shape ``(W, L)`` is the flat draw of ``W * L`` words, so word
  ``w * L + l`` is element ``(w, l)`` (the shared-stream draws of
  ``engine/device_sim.py``);
* ``uniform`` puts the top 23 bits in the mantissa of a float in
  [1, 2), subtracts 1, scales to [minval, maxval) and clamps below at
  minval;
* ``gumbel`` is ``-log(-log(uniform(minval=tiny)))``;
* ``normal`` is ``sqrt(2) * erf_inv(uniform(minval=nextafter(-1, 0)))``.

uint32 words are carried as int64 tensors in [0, 2^32).  Keys are int64
tensors of shape ``[..., 2]`` and every function is batched over the
leading axes.

The float functions copy XLA's CPU code, not the platform's libm:
``log`` and ``log1p`` are the Cephes polynomials XLA's CPU backend
inlines for ``llvm.log.f32`` and ``log1p`` (one float32 rounding per
operation, no fused multiply-add), and ``erf_inv`` is XLA's float32
polynomial (Giles).  Written as single float32 operations, each rounds
the same on any IEEE device, so the same code gives the same bits on
the CPU and the card.  The CUDA kernel K5 (``csrc/fleet_draw.cu``)
repeats these operations with ``__fmul_rn``/``__fadd_rn``; the wrappers
``choose_lanes`` and ``swarm_noise`` send CUDA tensors to it and CPU
tensors to the plain versions here.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels

MASK32 = 0xFFFFFFFF
F32 = torch.float32
TINY = float(np.finfo(np.float32).tiny)
NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
SQRT2 = float(np.float32(np.sqrt(2)))
SWARM_SALT = 0xA5A5           # fold_in data of the per-walker swarm key
LAYOUT_WALKER, LAYOUT_SHARED = 0, 1    # K5's two streams (fleet_draw.cu)

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v, r):
    return ((v << r) | (v >> (32 - r))) & MASK32


def threefry_2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds (``prng._threefry2x32_lowering``)
    on int64 words in [0, 2^32); arguments broadcast."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: [2] int64."""
    seed = int(seed)
    if not -(1 << 31) <= seed < (1 << 31):
        raise ValueError(f"seed {seed} is not a 32-bit integer")
    return torch.tensor([0, seed & MASK32], dtype=torch.int64,
                        device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` over keys ``[..., 2]``; ``data`` is an
    int or an int tensor that broadcasts against ``key[..., 0]``."""
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device)
    o0, o1 = threefry_2x32(key[..., 0], key[..., 1],
                           torch.zeros_like(d), d & MASK32)
    return torch.stack(torch.broadcast_tensors(o0, o1), dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` of one key [2]: [num, 2]."""
    return fold_in(key[None, :], torch.arange(int(num), device=key.device))


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """32-bit ``random_bits`` of shape ``[..., n]`` (int64 words)."""
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    o0, o1 = threefry_2x32(key[..., 0, None], key[..., 1, None],
                           torch.zeros_like(i), i)
    return o0 ^ o1


def _c(x, like):
    """The float32 constant x on like's device."""
    return torch.tensor(x, dtype=F32, device=like.device)


def _bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """Top 23 bits as a float in [0, 1): bitcast(bits >> 9 | 1.0) - 1."""
    fb = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return fb.view(F32) - 1.0


def uniform(key, n, minval=0.0, maxval=1.0) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32, minval, maxval)``."""
    lo, hi = _c(minval, key), _c(maxval, key)
    f = _bits_to_unit(random_bits(key, n))
    return torch.maximum(lo, f * (hi - lo) + lo)


# ----------------------------------------------------------------------
# XLA's float32 log, log1p and erf_inv on the CPU
# ----------------------------------------------------------------------
_SQRTHF = 0.707106769084930419921875
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LOG_Q1 = -2.12194440e-4
_LOG_Q2 = 0.693359375
_MIN_NORM = TINY
_LOG1P_SMALL = 0.41421356          # |x| below: the rational branch
_LOG1P_P = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
            6.5787325942061044846969e0, 2.9911919328553073277375e1,
            6.0949667980987787057556e1, 5.7112963590585538103336e1,
            2.0039553499201281259648e1)
_LOG1P_Q = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
            2.2176239823732856465394e2, 3.0909872225312059774938e2,
            2.1642788614495947685003e2, 6.0118660497603843919306e1)
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def fma(a, b, c):
    """float32 ``a * b + c`` with one rounding (a fused multiply-add),
    exact on any IEEE device: the product is exact in float64, the sum
    is rounded to odd there (TwoSum error term), and rounding that to
    float32 is then the correctly rounded result."""
    p = a.double() * b.double()
    c = torch.as_tensor(c, dtype=F32, device=p.device).double()
    s = p + c
    bp = s - p
    e = (p - (s - bp)) + (c - bp)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(e > 0, float("inf"), float("-inf")).to(s)
    s = torch.where((e != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def _log_core(x: torch.Tensor) -> torch.Tensor:
    """Cephes logf for x > 0 (XLA CPU ``log_f32``), no special cases;
    the multiply-adds XLA's CPU code generator fuses are fused here."""
    x = torch.where(x > _c(_MIN_NORM, x), x, _c(_MIN_NORM, x))
    xb = x.view(torch.int32).to(torch.int64)
    e = ((xb >> 23) - 127).to(F32) + 1.0
    m = ((xb & 0x807FFFFF) | 0x3F000000).to(torch.int32).view(F32)
    lt = m < _c(_SQRTHF, x)
    e = e - torch.where(lt, _c(1.0, x), _c(0.0, x))
    x = (m - 1.0) + torch.where(lt, m, _c(0.0, x))
    z = x * x
    x3 = z * x
    p = _LOG_P
    y1 = fma(fma(x, _c(p[0], x), p[1]), x, p[2])
    y2 = fma(fma(x, _c(p[3], x), p[4]), x, p[5])
    y3 = fma(fma(x, _c(p[6], x), p[7]), x, p[8])
    y = fma(fma(y1, x3, y2), x3, y3)
    y = fma(y, x3, e * _c(_LOG_Q1, x))
    r = fma(z, _c(-0.5, x), x) + y
    return fma(e, _c(_LOG_Q2, x), r)


def xla_log(x: torch.Tensor) -> torch.Tensor:
    """float32 natural log, bit-exact with XLA's CPU ``log``."""
    r = _log_core(x)
    r = torch.where(x > 0, r, _c(float("nan"), x))
    r = torch.where(x == 0, _c(float("-inf"), x), r)
    return torch.where(x == float("inf"), _c(float("inf"), x), r)


def xla_log1p(x: torch.Tensor) -> torch.Tensor:
    """float32 log(1 + x), bit-exact with XLA's CPU ``log1p``."""
    big = xla_log(x + 1.0)
    z = x * x
    x0 = x * 0.0
    p = x0 + _LOG1P_P[0]
    for c in _LOG1P_P[1:]:
        p = fma(p, x, c)
    q = x0 + _LOG1P_Q[0]
    for c in _LOG1P_Q[1:]:
        q = fma(q, x, c)
    small = x + fma(z, _c(-0.5, x), (x * z) * (p / q))
    return torch.where(x.abs() < _c(_LOG1P_SMALL, x), small, big)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """float32 inverse error function, bit-exact with XLA's CPU
    ``erf_inv`` (Giles' single-precision polynomial)."""
    w = -xla_log1p(x * -x)
    lt = w < 5.0
    # sqrt in float64 rounded once to float32: the correctly rounded
    # float32 root (torch's float32 CPU sqrt is not always)
    t = torch.where(lt, w + -2.5, torch.sqrt(w.double()).float() + -3.0)
    p = torch.where(lt, _c(_ERFINV_LT5[0], x), _c(_ERFINV_GE5[0], x))
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = fma(p, t, torch.where(lt, _c(a, x), _c(b, x)))
    p = torch.where(x.abs() == 1.0, _c(float("inf"), x), p)
    return x * p


def gumbel(key, n) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,))`` (mode "low")."""
    return -xla_log(-xla_log(uniform(key, n, TINY, 1.0)))


def normal(key, n) -> torch.Tensor:
    """``jax.random.normal(key, (n,))``."""
    return _c(SQRT2, key) * erf_inv(uniform(key, n, NORMAL_LO, 1.0))


# ----------------------------------------------------------------------
# K5: the fleet's draw and lane choice (sim/fleet.py:374-415)
# ----------------------------------------------------------------------
def _argmax_first(v: torch.Tensor) -> torch.Tensor:
    """jnp.argmax along the last axis: the first index among equal
    maxima (index 0 for a row of -inf)."""
    n = v.shape[-1]
    idx = torch.arange(n, device=v.device)
    best = v.amax(dim=-1, keepdim=True)
    return torch.where(v == best, idx, n).amin(dim=-1)


def choose_lanes_plain(wkeys, d, en, lane_aid, wlogw=None):
    """Plain version of K5.  ``wkeys`` [W, 2] walker keys, ``d`` the
    step (an int or a one-element int32 tensor), ``en`` [W, L] enabled
    lanes, ``lane_aid`` [L] action ids, ``wlogw`` [W, n_act] float32
    log-weights (None: unweighted).  Returns (lane [W] int32, can [W]
    bool)."""
    keys = fold_in(wkeys, torch.as_tensor(d, device=wkeys.device)
                   .reshape(()).long())
    L = en.shape[1]
    if wlogw is not None:
        n_act = wlogw.shape[1]
        k1, k2 = fold_in(keys, 1), fold_in(keys, 2)
        aid = lane_aid.long()
        act_en = torch.zeros((en.shape[0], n_act), dtype=torch.int32,
                             device=en.device).index_add_(
            1, aid, en.to(torch.int32)) > 0
        g = gumbel(k1, n_act) + wlogw
        a_star = _argmax_first(torch.where(act_en, g, _c(float("-inf"),
                                                         g)))
        v = uniform(k2, L)
        in_act = en & (aid[None, :] == a_star[:, None])
        lane = _argmax_first(torch.where(in_act, v, _c(-1.0, v)))
    else:
        u = uniform(keys, L)
        lane = _argmax_first(torch.where(en, u, _c(-1.0, u)))
    return lane.to(torch.int32), en.any(dim=1)


def swarm_noise_plain(wkeys, logw, sigma):
    """Plain version of K5's swarm entry: ``logw + sigma *
    normal(fold_in(wkey, 0xA5A5), n_act)`` per walker ([W, n_act]).
    As XLA compiles it: ``sqrt(2) * sigma`` folds into one float32
    constant and the add fuses with the multiply."""
    u = uniform(fold_in(wkeys, SWARM_SALT), logw.shape[0], NORMAL_LO, 1.0)
    scale = _c(SQRT2, u) * _c(sigma, u)
    return fma(erf_inv(u), scale, logw[None, :])


def choose_lanes(wkeys, d, en, lane_aid, wlogw=None):
    """K5 wrapper: CPU tensors go to ``choose_lanes_plain``, CUDA
    tensors to the kernel (see ``choose_lanes_plain`` for the
    contract)."""
    if en.device.type == "cpu":
        return choose_lanes_plain(wkeys, d, en, lane_aid, wlogw)
    W, L = en.shape
    n_act = 0 if wlogw is None else wlogw.shape[1]
    if n_act > 32:
        raise ValueError(f"K5 takes at most 32 actions, got {n_act}")
    keys = wkeys.to(torch.int32).contiguous()
    if not isinstance(d, torch.Tensor):
        d = torch.full((1,), int(d), dtype=torch.int32, device=en.device)
    lane = torch.empty((W,), dtype=torch.int32, device=en.device)
    can = torch.empty((W,), dtype=torch.bool, device=en.device)
    ck = kernels.check
    kernels.launch(
        "fleet_choose", "tpuvsr_fleet_choose",
        ck(keys, "wkeys", torch.int32, (W, 2)),
        ck(d, "d", torch.int32, (1,)),
        ck(en, "en", torch.bool, (W, L)), L,
        ck(lane_aid, "lane_aid", torch.int32, (L,)),
        None if wlogw is None else ck(wlogw, "wlogw", F32, (W, n_act)),
        n_act, W, lane.data_ptr(), can.data_ptr(), LAYOUT_WALKER,
        kernels.stream_of(en))
    return lane, can


def swarm_noise(wkeys, logw, sigma):
    """K5 swarm wrapper: [W, n_act] float32 per-walker log-weights."""
    if wkeys.device.type == "cpu":
        return swarm_noise_plain(wkeys, logw, sigma)
    W, n_act = wkeys.shape[0], logw.shape[0]
    keys = wkeys.to(torch.int32).contiguous()
    out = torch.empty((W, n_act), dtype=F32, device=wkeys.device)
    ck = kernels.check
    kernels.launch(
        "fleet_swarm_noise", "tpuvsr_fleet_swarm_noise",
        ck(keys, "wkeys", torch.int32, (W, 2)),
        ck(logw, "logw", F32, (n_act,)), n_act, float(sigma), W,
        out.data_ptr(), LAYOUT_WALKER, kernels.stream_of(wkeys))
    return out


# ----------------------------------------------------------------------
# K5, shared-stream layout: DeviceSimulator's draw (engine/device_sim.py)
# ----------------------------------------------------------------------
def choose_shared_plain(keys, t, en, lane_aid, wlogw=None):
    """Plain version of K5's shared layout (the step of
    ``tpuvsr/engine/device_sim.py:chunk_fn``, :247-267).  ``keys`` [k, 2]
    the chunk's step keys, ``t`` the step's row (an int or a
    one-element int tensor), ``en`` [W, L] enabled lanes, ``lane_aid``
    [L] action ids, ``wlogw`` [W, n_act] float32 log-weights (None:
    uniform over the enabled lanes).  One key serves every walker:
    walker w's numbers are row w of the draw of shape (W, L) (and (W,
    n_act) for the gumbel stage, under ``split(key)``'s first key; the
    lane stage takes its second).  Returns (lane [W] int32, can [W]
    bool)."""
    key = keys[int(torch.as_tensor(t).reshape(()))].long() & MASK32
    W, L = en.shape
    if wlogw is not None:
        n_act = wlogw.shape[1]
        k1, k2 = split(key)
        aid = lane_aid.long()
        act_en = torch.zeros((W, n_act), dtype=torch.int32,
                             device=en.device).index_add_(
            1, aid, en.to(torch.int32)) > 0
        g = gumbel(k1, W * n_act).reshape(W, n_act) + wlogw
        a_star = _argmax_first(torch.where(act_en, g, _c(float("-inf"),
                                                         g)))
        v = uniform(k2, W * L).reshape(W, L)
        in_act = en & (aid[None, :] == a_star[:, None])
        lane = _argmax_first(torch.where(in_act, v, _c(-1.0, v)))
    else:
        u = uniform(key, W * L).reshape(W, L)
        lane = _argmax_first(torch.where(en, u, _c(-1.0, u)))
    return lane.to(torch.int32), en.any(dim=1)


def choose_shared(keys, t, en, lane_aid, wlogw=None):
    """K5 wrapper, shared layout: CPU tensors go to
    ``choose_shared_plain``, CUDA tensors to the kernel (``t`` then a
    one-element int32 tensor on the card, so a CUDA graph replays the
    launch at every step)."""
    if en.device.type == "cpu":
        return choose_shared_plain(keys, t, en, lane_aid, wlogw)
    W, L = en.shape
    n_act = 0 if wlogw is None else wlogw.shape[1]
    if n_act > 32:
        raise ValueError(f"K5 takes at most 32 actions, got {n_act}")
    ck = kernels.check
    lane = torch.empty((W,), dtype=torch.int32, device=en.device)
    can = torch.empty((W,), dtype=torch.bool, device=en.device)
    kernels.launch(
        "fleet_choose_shared", "tpuvsr_fleet_choose",
        ck(keys, "keys", torch.int32, (keys.shape[0], 2)),
        ck(t, "t", torch.int32, (1,)),
        ck(en, "en", torch.bool, (W, L)), L,
        ck(lane_aid, "lane_aid", torch.int32, (L,)),
        None if wlogw is None else ck(wlogw, "wlogw", F32, (W, n_act)),
        n_act, W, lane.data_ptr(), can.data_ptr(), LAYOUT_SHARED,
        kernels.stream_of(en))
    return lane, can


def shared_noise_plain(key, logw, sigma, W):
    """Plain version of K5's shared round noise
    (``tpuvsr/engine/device_sim.py:_round_logw``): ``logw + normal(key,
    (W, n_act)) * sigma``, each operation rounded on its own as JAX runs
    them outside a jit ([W, n_act] float32)."""
    n_act = logw.shape[0]
    noise = normal(key.long() & MASK32, W * n_act).reshape(W, n_act) \
        * _c(sigma, logw)
    return logw[None, :] + noise


def shared_noise(key, logw, sigma, W):
    """K5 wrapper, shared round noise (``key`` [2] the round's key)."""
    if logw.device.type == "cpu":
        return shared_noise_plain(key, logw, sigma, W)
    n_act = logw.shape[0]
    k = key.to(torch.int32).contiguous()
    out = torch.empty((W, n_act), dtype=F32, device=logw.device)
    ck = kernels.check
    kernels.launch(
        "fleet_noise_shared", "tpuvsr_fleet_swarm_noise",
        ck(k, "key", torch.int32, (2,)), ck(logw, "logw", F32, (n_act,)),
        n_act, float(sigma), W, out.data_ptr(), LAYOUT_SHARED,
        kernels.stream_of(logw))
    return out
