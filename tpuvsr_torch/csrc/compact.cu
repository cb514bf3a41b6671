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
// reads 61 KB of the guard matrix and writes 13 bytes a queue entry;
// the block-wide scans make a launch latency-bound.
//
// Design.  One block per action (a segment); the block walks the
// action's T*L_a items in chunks of THREADS, takes an inclusive
// Hillis-Steele scan of the chunk's enabled flags in shared memory, and
// writes each enabled item at the running count plus its rank while
// that is below E_a.  Blocks share nothing, so each action's order is
// the item order, as the stable nonzero keeps it.  With a carry whose
// halt word is set the kernel does nothing.  The per-action commit
// compacts one action at a time: it passes that action's row of the
// segment table and a0, the action's id, which the queue's action
// column takes (a0 + the block's row).
#include "common.cuh"

namespace {

constexpr int THREADS = 512;

__global__ void compact_kernel(const uint8_t* __restrict__ en,
                               const uint8_t* __restrict__ valid, int T,
                               int n_lanes, const int* __restrict__ segs,
                               int a0, int* __restrict__ q_pidx,
                               int* __restrict__ q_lane,
                               int* __restrict__ q_aid,
                               uint8_t* __restrict__ q_ok,
                               long long* __restrict__ cnts,
                               uint8_t* __restrict__ ovf,
                               const long long* __restrict__ halt,
                               long long* __restrict__ need) {
    if (halt && *halt) return;
    __shared__ int scan[THREADS];
    __shared__ int base;
    const int a = blockIdx.x, tid = threadIdx.x;
    const int lo = segs[4 * a], L = segs[4 * a + 1], E = segs[4 * a + 2];
    const int qo = segs[4 * a + 3];
    const int TL = T * L;
    if (tid == 0) base = 0;
    __syncthreads();
    for (int c0 = 0; c0 < TL; c0 += THREADS) {
        const int i = c0 + tid;
        int x = 0, row = 0, lane = 0;
        if (i < TL) {
            row = i / L;
            lane = i - row * L;
            x = valid[row] && en[(size_t)row * n_lanes + lo + lane];
        }
        scan[tid] = x;
        __syncthreads();
        for (int off = 1; off < THREADS; off <<= 1) {
            const int v = tid >= off ? scan[tid - off] : 0;
            __syncthreads();
            scan[tid] += v;
            __syncthreads();
        }
        const int pos = base + scan[tid] - x;
        if (x && pos < E) {
            q_pidx[qo + pos] = row;
            q_lane[qo + pos] = lane;
            q_aid[qo + pos] = a0 + a;
            q_ok[qo + pos] = 1;
        }
        __syncthreads();
        if (tid == THREADS - 1) base += scan[THREADS - 1];
        __syncthreads();
    }
    const int cnt = base;
    for (int p = cnt + tid; p < E; p += THREADS) {
        q_pidx[qo + p] = T - 1;
        q_lane[qo + p] = 0;
        q_aid[qo + p] = a0 + a;
        q_ok[qo + p] = 0;
    }
    if (tid == 0) {
        cnts[a] = cnt;
        ovf[a] = cnt > E;
        if (need && need[a] < cnt) need[a] = cnt;
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
