// K12: the level pass's edge emission — append a tile's behaviour-graph
// edges to the device edge buffers.
//
// Replaces the edge block of tpuvsr/engine/device_bfs.py's fused body
// (:1030-1048; its per-action twin :616-681):
//   emit = en_q & commit
//   edst = where(emit, edge_n + cumsum(emit) - 1, E_cap)
//   eb_src[edst] = src_base + base + pidx_q; eb_aid[edst] = aid_q;
//   eb_dst[edst] = dst_g                       (mode="drop")
// for a tile's work queue, whose order is action-major (K7 writes it
// so), after K11 has stored the fresh states' gids and looked up the
// destination gid of every enabled item.  The commit decision is read
// on the device (one byte the wrapper computes from the tile's first
// failing action and K1's overflow word), so a paused tile appends
// nothing and the host learns the count from the tile's one read.
//
// What bounds it on the H100: a queue of at most total_E (~2,500 at the
// defect config) items, 13 bytes in and 12 out each: launch latency;
// the byte bound is under a microsecond.
//
// Design.  One block of THREADS threads walks the queue in chunks; a
// warp-shuffle inclusive scan of each chunk's emit flags (then of the
// warp totals) gives each item its rank, and the item is written at
// edge_n + the running count + its rank, in queue order.  Ranks past
// the buffer are dropped, as JAX's mode="drop" does (the level pass's
// headroom gate keeps them from happening).  The count appended goes
// to ``emitted``.
#include "common.cuh"

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;

__global__ void edge_emit_kernel(const uint8_t* __restrict__ en,
                                 const int* __restrict__ pidx,
                                 const int* __restrict__ aid,
                                 const int* __restrict__ dst, int n,
                                 const uint8_t* __restrict__ commit,
                                 int src_off, int edge_n, int e_cap,
                                 int* __restrict__ eb_src,
                                 int* __restrict__ eb_aid,
                                 int* __restrict__ eb_dst,
                                 int* __restrict__ emitted) {
    __shared__ int warp_sum[WARPS];
    __shared__ int base;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    if (!*commit) {
        if (tid == 0) *emitted = 0;
        return;
    }
    if (tid == 0) base = 0;
    __syncthreads();
    for (int c0 = 0; c0 < n; c0 += THREADS) {
        const int i = c0 + tid;
        const int x = (i < n && en[i]) ? 1 : 0;
        int s = x;                                  // inclusive warp scan
        for (int d = 1; d < 32; d <<= 1) {
            const int y = __shfl_up_sync(0xFFFFFFFFu, s, d);
            if (lane >= d) s += y;
        }
        if (lane == 31) warp_sum[warp] = s;
        __syncthreads();
        if (warp == 0) {
            int w = warp_sum[lane];                 // WARPS == 32
            for (int d = 1; d < 32; d <<= 1) {
                const int y = __shfl_up_sync(0xFFFFFFFFu, w, d);
                if (lane >= d) w += y;
            }
            warp_sum[lane] = w;
        }
        __syncthreads();
        const int rank = s + (warp ? warp_sum[warp - 1] : 0);
        if (x) {
            const int pos = edge_n + base + rank - 1;
            if (pos < e_cap) {
                eb_src[pos] = src_off + pidx[i];
                eb_aid[pos] = aid[i];
                eb_dst[pos] = dst[i];
            }
        }
        __syncthreads();
        if (tid == 0) base += warp_sum[WARPS - 1];
        __syncthreads();
    }
    if (tid == 0) *emitted = base;
}

}  // namespace

// en: [n] uint8; pidx, aid, dst: [n] int32; commit: one uint8 on the
// device; eb_src, eb_aid, eb_dst: [e_cap] int32; emitted: one int32.
TPUVSR_EXPORT int tpuvsr_edge_emit(const void* en, const void* pidx,
                                   const void* aid, const void* dst, int n,
                                   const void* commit, int src_off,
                                   int edge_n, int e_cap, void* eb_src,
                                   void* eb_aid, void* eb_dst,
                                   void* emitted, void* stream) {
    KLAUNCH(edge_emit_kernel, 1, THREADS, (cudaStream_t)stream,
            (const uint8_t*)en, (const int*)pidx, (const int*)aid,
            (const int*)dst, n, (const uint8_t*)commit, src_off, edge_n,
            e_cap, (int*)eb_src, (int*)eb_aid, (int*)eb_dst,
            (int*)emitted);
    return (int)cudaGetLastError();
}
