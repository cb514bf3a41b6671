// K5: the walker fleet's per-step draw and two-stage lane choice, and
// the per-round swarm noise, in two layouts of the random stream.
//
// Per-walker layout (LAYOUT_WALKER): the draws of
// tpuvsr/sim/fleet.py:chunk_fn (fleet.py:374-415): per walker w at step
// d, keys = fold_in(wkey[w], d), then
//   weighted:   k1 = fold_in(keys, 1), k2 = fold_in(keys, 2);
//               a* = argmax(where(act_en, gumbel(k1, n_act) + wlogw, -inf))
//               lane = argmax(where(en & lane_aid == a*, uniform(k2, L), -1))
//   unweighted: lane = argmax(where(en, uniform(keys, L), -1))
//   can = any(en)
// and the swarm entry (fleet.py:375-385):
//   wlogw[w] = logw + sigma * normal(fold_in(wkey[w], 0xA5A5), n_act).
//
// Shared layout (LAYOUT_SHARED): the draws of
// tpuvsr/engine/device_sim.py:chunk_fn's step (:247-267), one key a step
// for every walker, key = keys[step] (the step's row of the chunk's key
// table), and walker w's counters offset into one [W, L] draw:
//   weighted:   k1, k2 = split(key) = fold_in(key, 0), fold_in(key, 1);
//               g[w, a] = gumbel(k1, (W, n_act))[w, a] (counter w*n_act+a)
//               v[w, l] = uniform(k2, (W, L))[w, l]     (counter w*L+l)
//   unweighted: u[w, l] = uniform(key, (W, L))[w, l]
// with the same two-stage choice; and the round's noise (_round_logw
// :325-336), which JAX runs op by op outside the chunk's jit, so each
// operation rounds on its own:
//   wlogw[w, a] = logw[a] + (sqrt(2) * erf_inv(u)) * sigma,
//   u = uniform(key, (W, n_act), nextafter(-1, 0), 1)[w, a].
// jnp.argmax takes the first index among equal maxima and index 0 for a
// row that is all -inf; the warp reductions here keep that rule.
//
// The random numbers are jax.random's (threefry2x32, partitionable
// layout: word i of random_bits(key, n) is x0 ^ x1 of the hash of the
// counter pair (0, i), and a draw of shape (W, L) is the flat draw of
// W*L words), so each lane's number depends only on its counter.  The
// float functions are XLA's CPU code, operation for operation, with its
// fused multiply-adds: the Cephes log/log1p and Giles' erf_inv
// polynomial (tpuvsr_torch/sim/rng.py is the plain twin and says where
// each comes from).  Every float operation is written with an explicit
// rounding intrinsic (__fmul_rn, __fadd_rn, __fmaf_rn, __fdiv_rn,
// __fsqrt_rn) so the compiler cannot contract or reorder it, and the
// file must not be built with --use_fast_math.
//
// What bounds it on the H100: a walker reads its [L] enabled row once
// (L bytes: 699 lanes at MAX_MSGS=48) and its n_act log-weights, and
// hashes one threefry block (20 rounds of add-rotate-xor) per lane it
// may choose from, plus n_act blocks for the gumbel draw.  At the
// hunt's shape (4096 walkers x 699 lanes) the bytes (2.9 MB) and the
// integer operations are both small: the launch is latency bound.
//
// Design.  One warp per walker: lanes are strided over the 32 threads,
// each thread hashes the counters of its own lanes and keeps its best
// (value, index); a shuffle reduction with a lowest-index tie-break
// names the winner.  The action-enabled mask is a 32-bit OR reduction
// (n_act <= 32), and the gumbel draw puts one action on each thread.
// The layout changes only where the keys and counters come from.
#include "common.cuh"

namespace {

constexpr float MIN_NORM = 1.17549435e-38f;
constexpr float SQRTHF = 0.707106769084930419921875f;
__constant__ float LOG_P[9] = {7.0376836292e-2f, -1.1514610310e-1f,
                            1.1676998740e-1f, -1.2420140846e-1f,
                            1.4249322787e-1f, -1.6668057665e-1f,
                            2.0000714765e-1f, -2.4999993993e-1f,
                            3.3333331174e-1f};
constexpr float LOG_Q1 = -2.12194440e-4f;
constexpr float LOG_Q2 = 0.693359375f;
constexpr float LOG1P_SMALL = 0.41421356f;
__constant__ float LOG1P_P[7] = {
    4.5270000862445199635215e-5f, 4.9854102823193375972212e-1f,
    6.5787325942061044846969e0f, 2.9911919328553073277375e1f,
    6.0949667980987787057556e1f, 5.7112963590585538103336e1f,
    2.0039553499201281259648e1f};
__constant__ float LOG1P_Q[7] = {
    1.0f, 1.5062909083469192043167e1f, 8.3047565967967209469434e1f,
    2.2176239823732856465394e2f, 3.0909872225312059774938e2f,
    2.1642788614495947685003e2f, 6.0118660497603843919306e1f};
__constant__ float ERFINV_LT5[9] = {
    2.81022636e-08f, 3.43273939e-07f, -3.5233877e-06f, -4.39150654e-06f,
    0.00021858087f, -0.00125372503f, -0.00417768164f, 0.246640727f,
    1.50140941f};
__constant__ float ERFINV_GE5[9] = {
    -0.000200214257f, 0.000100950558f, 0.00134934322f, -0.00367342844f,
    0.00573950773f, -0.0076224613f, 0.00943887047f, 1.00167406f,
    2.83297682f};
constexpr float SQRT2 = 1.41421354f;
constexpr float NORMAL_LO = -0.99999994f;
constexpr uint32_t SWARM_SALT = 0xA5A5u;
constexpr int LAYOUT_WALKER = 0;
constexpr int LAYOUT_SHARED = 1;

__device__ __forceinline__ uint32_t rotl(uint32_t v, int r) {
    return (v << r) | (v >> (32 - r));
}

// threefry2x32, 20 rounds (jax/_src/prng.py _threefry2x32_lowering)
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1,
                                         uint32_t& x0, uint32_t& x1) {
    const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
    const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
    x0 += ks[0];
    x1 += ks[1];
#pragma unroll
    for (int i = 0; i < 5; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            x0 += x1;
            x1 = rotl(x1, rot[i % 2][j]) ^ x0;
        }
        x0 += ks[(i + 1) % 3];
        x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
    }
}

__device__ __forceinline__ void fold_in(uint32_t& k0, uint32_t& k1,
                                        uint32_t d) {
    uint32_t x0 = 0, x1 = d;
    threefry(k0, k1, x0, x1);
    k0 = x0;
    k1 = x1;
}

__device__ __forceinline__ uint32_t bits(uint32_t k0, uint32_t k1,
                                         uint32_t i) {
    uint32_t x0 = 0, x1 = i;
    threefry(k0, k1, x0, x1);
    return x0 ^ x1;
}

// uniform(key, n, lo, hi)[i]
__device__ __forceinline__ float uniform(uint32_t k0, uint32_t k1,
                                         uint32_t i, float lo, float hi) {
    float f = __fsub_rn(__uint_as_float((bits(k0, k1, i) >> 9)
                                        | 0x3F800000u), 1.0f);
    return fmaxf(lo, __fadd_rn(__fmul_rn(f, __fsub_rn(hi, lo)), lo));
}

// Cephes logf as XLA's CPU backend inlines it (x > 0, finite)
__device__ float xla_log_core(float x) {
    x = x > MIN_NORM ? x : MIN_NORM;
    const int xb = __float_as_int(x);
    float e = __fadd_rn((float)((xb >> 23) - 127), 1.0f);
    const float m = __int_as_float((xb & 0x807FFFFF) | 0x3F000000);
    const bool lt = m < SQRTHF;
    e = __fsub_rn(e, lt ? 1.0f : 0.0f);
    const float t = __fadd_rn(__fsub_rn(m, 1.0f), lt ? m : 0.0f);
    const float z = __fmul_rn(t, t);
    const float t3 = __fmul_rn(z, t);
    const float y1 = __fmaf_rn(__fmaf_rn(t, LOG_P[0], LOG_P[1]), t, LOG_P[2]);
    const float y2 = __fmaf_rn(__fmaf_rn(t, LOG_P[3], LOG_P[4]), t, LOG_P[5]);
    const float y3 = __fmaf_rn(__fmaf_rn(t, LOG_P[6], LOG_P[7]), t, LOG_P[8]);
    float y = __fmaf_rn(__fmaf_rn(y1, t3, y2), t3, y3);
    y = __fmaf_rn(y, t3, __fmul_rn(e, LOG_Q1));
    const float r = __fadd_rn(__fmaf_rn(z, -0.5f, t), y);
    return __fmaf_rn(e, LOG_Q2, r);
}

__device__ float xla_log(float x) {
    if (x == 0.0f) return -INFINITY;
    if (!(x > 0.0f)) return NAN;
    if (x == INFINITY) return INFINITY;
    return xla_log_core(x);
}

__device__ float xla_log1p(float x) {
    if (fabsf(x) < LOG1P_SMALL) {
        const float z = __fmul_rn(x, x);
        const float x0 = __fmul_rn(x, 0.0f);
        float p = __fadd_rn(x0, LOG1P_P[0]);
        float q = __fadd_rn(x0, LOG1P_Q[0]);
#pragma unroll
        for (int i = 1; i < 7; ++i) {
            p = __fmaf_rn(p, x, LOG1P_P[i]);
            q = __fmaf_rn(q, x, LOG1P_Q[i]);
        }
        const float y = __fmul_rn(__fmul_rn(x, z), __fdiv_rn(p, q));
        return __fadd_rn(x, __fmaf_rn(z, -0.5f, y));
    }
    return xla_log(__fadd_rn(x, 1.0f));
}

__device__ float erf_inv(float x) {
    const float w = -xla_log1p(__fmul_rn(x, -x));
    const bool lt = w < 5.0f;
    const float t = lt ? __fadd_rn(w, -2.5f)
                       : __fadd_rn(__fsqrt_rn(w), -3.0f);
    float p = lt ? ERFINV_LT5[0] : ERFINV_GE5[0];
#pragma unroll
    for (int i = 1; i < 9; ++i)
        p = __fmaf_rn(p, t, lt ? ERFINV_LT5[i] : ERFINV_GE5[i]);
    if (fabsf(x) == 1.0f) p = INFINITY;
    return __fmul_rn(x, p);
}

// (value, index) of the larger, the smaller index among equals
__device__ __forceinline__ void warp_argmax(float& v, int& idx) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xFFFFFFFFu, v, off);
        const int oi = __shfl_down_sync(0xFFFFFFFFu, idx, off);
        if (ov > v || (ov == v && oi < idx)) {
            v = ov;
            idx = oi;
        }
    }
    idx = __shfl_sync(0xFFFFFFFFu, idx, 0);
}

__global__ void fleet_choose_kernel(const uint32_t* __restrict__ wkeys,
                                    const int* __restrict__ step,
                                    const uint8_t* __restrict__ en, int L,
                                    const int* __restrict__ lane_aid,
                                    const float* __restrict__ wlogw,
                                    int n_act, int W, int layout,
                                    int* __restrict__ lane_out,
                                    uint8_t* __restrict__ can_out) {
    const int w = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x)
                        >> 5);
    const int t = threadIdx.x & 31;
    if (w >= W) return;                      // whole warps exit together
    const uint8_t* row = en + (size_t)w * L;
    uint32_t k0, k1, lane0 = 0, act0 = 0;
    if (layout == LAYOUT_SHARED) {
        const size_t s = (size_t)*step;
        k0 = wkeys[2 * s];
        k1 = wkeys[2 * s + 1];
        lane0 = (uint32_t)w * (uint32_t)L;
        act0 = (uint32_t)w * (uint32_t)n_act;
    } else {
        k0 = wkeys[2 * (size_t)w];
        k1 = wkeys[2 * (size_t)w + 1];
        fold_in(k0, k1, (uint32_t)*step);
    }
    int any = 0;
    float best = -1.0f;
    int bidx = 0x7FFFFFFF;
    if (wlogw != nullptr) {
        uint32_t a0 = k0, a1 = k1, b0 = k0, b1 = k1;
        const uint32_t s1 = layout == LAYOUT_SHARED ? 0u : 1u;
        fold_in(a0, a1, s1);
        fold_in(b0, b1, s1 + 1u);
        uint32_t amask = 0;
        for (int l = t; l < L; l += 32)
            if (row[l]) amask |= 1u << lane_aid[l];
        amask = __reduce_or_sync(0xFFFFFFFFu, amask);
        any = amask != 0;
        float g = -INFINITY;
        int gi = t < n_act ? t : 0x7FFFFFFF;
        if (t < n_act && ((amask >> t) & 1u)) {
            const float u = uniform(a0, a1, act0 + (uint32_t)t, MIN_NORM,
                                    1.0f);
            g = __fadd_rn(-xla_log(-xla_log(u)),
                          wlogw[(size_t)w * n_act + t]);
        }
        warp_argmax(g, gi);
        const int a_star = gi;
        for (int l = t; l < L; l += 32) {
            if (row[l] && lane_aid[l] == a_star) {
                const float v = uniform(b0, b1, lane0 + (uint32_t)l, 0.0f,
                                        1.0f);
                if (v > best) {
                    best = v;
                    bidx = l;
                }
            }
        }
    } else {
        for (int l = t; l < L; l += 32) {
            if (row[l]) {
                any = 1;
                const float v = uniform(k0, k1, lane0 + (uint32_t)l, 0.0f,
                                        1.0f);
                if (v > best) {
                    best = v;
                    bidx = l;
                }
            }
        }
        any = __any_sync(0xFFFFFFFFu, any);
    }
    // a lane with no candidate keeps (-1, first of its lanes): the
    // all-masked row then chooses lane 0, as jnp.argmax does
    if (bidx == 0x7FFFFFFF) bidx = t;
    warp_argmax(best, bidx);
    if (t == 0) {
        lane_out[w] = bidx;
        can_out[w] = (uint8_t)any;
    }
}

__global__ void fleet_swarm_kernel(const uint32_t* __restrict__ wkeys,
                                   const float* __restrict__ logw,
                                   int n_act, float sigma, int W,
                                   int layout, float* __restrict__ out) {
    const size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
    if (i >= (size_t)W * n_act) return;
    const int w = (int)(i / n_act), a = (int)(i % n_act);
    if (layout == LAYOUT_SHARED) {
        // one key for the round, counter w * n_act + a; each operation
        // rounds on its own (JAX runs them outside a jit)
        const float u = uniform(wkeys[0], wkeys[1], (uint32_t)i, NORMAL_LO,
                                1.0f);
        out[i] = __fadd_rn(logw[a], __fmul_rn(__fmul_rn(SQRT2, erf_inv(u)),
                                              sigma));
        return;
    }
    uint32_t k0 = wkeys[2 * (size_t)w], k1 = wkeys[2 * (size_t)w + 1];
    fold_in(k0, k1, SWARM_SALT);
    const float u = uniform(k0, k1, (uint32_t)a, NORMAL_LO, 1.0f);
    // XLA folds sqrt(2) * sigma into one constant and fuses the add
    out[i] = __fmaf_rn(erf_inv(u), __fmul_rn(SQRT2, sigma), logw[a]);
}

}  // namespace

// wkeys: [W, 2] uint32 walker keys (layout 0), or the [steps, 2] step
// keys of a chunk (layout 1); step: one int32 on the device (so a CUDA
// graph can replay the launch at every step): the step d (layout 0) or
// the row of the step's key (layout 1); en: [W, L] uint8; lane_aid: [L]
// int32; wlogw: [W, n_act] float32 or null (unweighted); lane: [W]
// int32 and can: [W] uint8 out.  n_act <= 32.
TPUVSR_EXPORT int tpuvsr_fleet_choose(const void* wkeys, const void* step,
                                      const void* en, int L,
                                      const void* lane_aid,
                                      const void* wlogw, int n_act, int W,
                                      void* lane, void* can, int layout,
                                      void* stream) {
    if (n_act > 32) return (int)cudaErrorInvalidValue;
    if (W > 0) {
        const int threads = 256;               // 8 walkers a block
        KLAUNCH(fleet_choose_kernel, tpuvsr_blocks(32LL * W, threads),
                threads, (cudaStream_t)stream, (const uint32_t*)wkeys,
                (const int*)step, (const uint8_t*)en, L,
                (const int*)lane_aid, (const float*)wlogw, n_act, W,
                layout, (int*)lane, (uint8_t*)can);
    }
    return (int)cudaGetLastError();
}

// wkeys: [W, 2] uint32 walker keys (layout 0) or the round's one key
// [2] (layout 1); logw: [n_act] float32; out: [W, n_act] float32.
TPUVSR_EXPORT int tpuvsr_fleet_swarm_noise(const void* wkeys,
                                           const void* logw, int n_act,
                                           float sigma, int W, void* out,
                                           int layout, void* stream) {
    const long long n = (long long)W * n_act;
    if (n > 0) {
        const int threads = 256;
        KLAUNCH(fleet_swarm_kernel, tpuvsr_blocks(n, threads), threads,
                (cudaStream_t)stream, (const uint32_t*)wkeys,
                (const float*)logw, n_act, sigma, W, layout,
                (float*)out);
    }
    return (int)cudaGetLastError();
}
