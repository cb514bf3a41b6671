// K7: the fused tile's work-queue compaction.
//
// Replaces the per-action stable compaction of
// tpuvsr/engine/device_bfs.py:_fused_body_factory (:838),
//   (sel,) = jnp.nonzero(en_f, size=E_a, fill_value=T*L_a)
// for all actions of a tile in one launch: for action a, en_f is the
// [T, L_a] block of its lanes in the guard matrix (K6), masked to the
// tile's valid rows and read row-major.  The first E_a enabled items go
// to the queue segment of a, in order, as (row, lane, a, ok); the rest
// of the segment holds the fill item (row T-1, lane 0, not ok), which
// is what jnp.nonzero's fill value T*L_a becomes once split into a row
// (clipped) and a lane.  The kernel also writes the exact per-action
// counts (the JAX body's cnts), their overflow of E_a, and raises the
// carry's need vector to them.
//
// What bounds it on the H100: at a tile of 128 rows and 475 lanes it
// reads 61 KB of the guard matrix and writes 13 bytes a queue entry, a
// byte bound of about 0.03 us; what it costs is latency: the dependent
// steps of a stable scan, each a barrier or a global load.
//
// Design.  One block of 32 warps per action (a segment), rows taken in
// chunks of 1,024.  The items of one row of an action lie contiguous in
// the guard matrix (lanes lo .. lo+L_a-1), so a warp reads a row 32
// lanes at a time, coalesced, and counts it with warp votes
// (__ballot_sync, __popc): no shared-memory scan over items; it
// counts four rows at once, their loads in flight together.  The
// chunk's per-row counts are scanned once in shared memory (a warp
// scan by shuffles, then a scan of the 32 warp totals: three
// barriers).  Each warp then reads its rows again and writes each
// enabled item at its row's offset plus its rank in the row,
// __popc(ballot & lanemask_lt), while that is below E_a, and stops at a
// row that starts past E_a.  The actions' blocks run side by side on
// separate SMs; the per-action commit's single segment gets the 32
// warps of one block, four rows of a 128-row tile each.  Blocks share
// nothing, so each action's order is the item order, as the stable
// nonzero keeps it.  With a carry whose halt word is set the kernel
// does nothing.  The per-action commit compacts one action at a time:
// it passes that action's row of the segment table and a0, the
// action's id, which the queue's action column takes (a0 + the block's
// row).
#include "common.cuh"

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int BATCH = 4;              // rows a warp counts at once
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(THREADS) compact_kernel(
        const uint8_t* __restrict__ en, const uint8_t* __restrict__ valid,
        int T, int n_lanes, const int* __restrict__ segs, int a0,
        int* __restrict__ q_pidx, int* __restrict__ q_lane,
        int* __restrict__ q_aid, uint8_t* __restrict__ q_ok,
        long long* __restrict__ cnts, uint8_t* __restrict__ ovf,
        const long long* __restrict__ halt, long long* __restrict__ need) {
    if (halt && *halt) return;
    __shared__ int rows_s[THREADS];   // a chunk's row counts, then offsets
    __shared__ int warp_s[WARPS];
    const int a = blockIdx.x, tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const unsigned below = (1u << lane) - 1u;
    const int lo = segs[4 * a], L = segs[4 * a + 1], E = segs[4 * a + 2];
    const int qo = segs[4 * a + 3], aid = a0 + a;
    int base = 0;                     // enabled items of earlier chunks
    for (int c0 = 0; c0 < T; c0 += THREADS) {
        const int nrows = min(THREADS, T - c0);
        // (1) each row's enabled count, by warp votes; a warp takes
        // BATCH rows at once, so that their loads are in flight together
        for (int j0 = warp; j0 < nrows; j0 += BATCH * WARPS) {
            bool v[BATCH];
            const uint8_t* e[BATCH];
            int cnt[BATCH];
#pragma unroll
            for (int k = 0; k < BATCH; ++k) {
                const int j = j0 + k * WARPS;
                v[k] = j < nrows && valid[c0 + j];
                e[k] = en + (size_t)(c0 + (j < nrows ? j : 0)) * n_lanes + lo;
                cnt[k] = 0;
            }
            for (int g = 0; g < L; g += 32) {
                bool x[BATCH];
#pragma unroll
                for (int k = 0; k < BATCH; ++k)
                    x[k] = g + lane < L && e[k][g + lane];
#pragma unroll
                for (int k = 0; k < BATCH; ++k)
                    cnt[k] += __popc(__ballot_sync(FULL, x[k] && v[k]));
            }
#pragma unroll
            for (int k = 0; k < BATCH; ++k)
                if (lane == 0 && j0 + k * WARPS < nrows)
                    rows_s[j0 + k * WARPS] = cnt[k];
        }
        __syncthreads();
        // (2) exclusive scan of the chunk's row counts
        const int v = tid < nrows ? rows_s[tid] : 0;
        int incl = v;
        for (int o = 1; o < 32; o <<= 1) {
            const int u = __shfl_up_sync(FULL, incl, o);
            if (lane >= o) incl += u;
        }
        if (lane == 31) warp_s[warp] = incl;
        __syncthreads();
        if (warp == 0) {
            int w = warp_s[lane];
            for (int o = 1; o < 32; o <<= 1) {
                const int u = __shfl_up_sync(FULL, w, o);
                if (lane >= o) w += u;
            }
            warp_s[lane] = w;
        }
        __syncthreads();
        rows_s[tid] = base + incl - v + (warp ? warp_s[warp - 1] : 0);
        const int chunk = warp_s[WARPS - 1];
        __syncthreads();
        // (3) each row's enabled items at its offset plus their rank
        for (int j = warp; j < nrows; j += WARPS) {
            const int row = c0 + j;
            int off = rows_s[j];
            if (off >= E || !valid[row]) continue;
            const uint8_t* e = en + (size_t)row * n_lanes + lo;
            for (int g = 0; g < L && off < E; g += 32) {
                const bool x = g + lane < L && e[g + lane];
                const unsigned b = __ballot_sync(FULL, x);
                const int pos = off + __popc(b & below);
                if (x && pos < E) {
                    q_pidx[qo + pos] = row;
                    q_lane[qo + pos] = g + lane;
                    q_aid[qo + pos] = aid;
                    q_ok[qo + pos] = 1;
                }
                off += __popc(b);
            }
        }
        base += chunk;
        __syncthreads();              // rows_s is refilled next chunk
    }
    for (int p = base + tid; p < E; p += THREADS) {
        q_pidx[qo + p] = T - 1;
        q_lane[qo + p] = 0;
        q_aid[qo + p] = aid;
        q_ok[qo + p] = 0;
    }
    if (tid == 0) {
        cnts[a] = base;
        ovf[a] = base > E;
        if (need && need[a] < base) need[a] = base;
    }
}

}  // namespace

// en: [T, n_lanes] uint8 guard matrix; valid: [T] uint8; segs: [n_act,
// 4] int32 (first lane, L_a, E_a, queue offset); a0: the id of the
// action of segs' first row; q_*: [total] queue (int32 row, lane,
// action; uint8 ok); cnts: [n_act] int64; ovf: [n_act] uint8; carry:
// int64 words or null, its halt word at c_halt and need[n_act] from
// c_need.
TPUVSR_EXPORT int tpuvsr_compact(const void* en, const void* valid, int T,
                                 int n_lanes, const void* segs, int n_act,
                                 int a0, void* q_pidx, void* q_lane,
                                 void* q_aid, void* q_ok, void* cnts,
                                 void* ovf,
                                 void* carry, int c_halt, int c_need,
                                 void* stream) {
    if (n_act > 0) {
        long long* c = (long long*)carry;
        KLAUNCH(compact_kernel, n_act, THREADS, (cudaStream_t)stream,
                (const uint8_t*)en, (const uint8_t*)valid, T, n_lanes,
                (const int*)segs, a0, (int*)q_pidx, (int*)q_lane,
                (int*)q_aid, (uint8_t*)q_ok, (long long*)cnts, (uint8_t*)ovf,
                c ? c + c_halt : nullptr, c ? c + c_need : nullptr);
    }
    return (int)cudaGetLastError();
}
