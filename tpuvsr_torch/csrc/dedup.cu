// K2: stable first-occurrence dedup of a fingerprint batch.
//
// Replaces tpuvsr/engine/fpset.py:dedup_batch as the fused commit uses
// it (device_bfs.py:937-938): the lexsort-based (perm, keep) pair is
// only ever scattered back to queue order, so this kernel returns the
// keep mask in queue order directly.  keep[i] is true for a masked-in
// lane i when no masked-in lane j < i carries the same fingerprint.
//
// What bounds it on the H100: each lane reads its 16-byte fingerprint
// and mask byte and writes one keep byte; a hash table adds a few
// random accesses per lane.  At the engine's batch sizes (a few
// thousand lanes: a fused tile's queue, an action's segment, the
// hunt's 4,096 walkers) the bytes take nanoseconds and a call is
// latency: launches, graph nodes and dependent memory round trips.
//
// Design.  Instead of a sort: every masked-in lane claims a slot of an
// open-addressing hash of 2n..4n slots for its fingerprint and takes an
// atomicMin of its index at that slot; a lane is kept iff its index
// won.  Equal fingerprints meet in one slot, so the winner is the
// earliest lane, as the stable sort makes it.  Up to BLOCK_MAX lanes
// (every batch the engines make) this is one launch of one block of up
// to 1,024 threads: the table lives in shared memory (8 bytes a slot:
// the claiming lane, whose fingerprint is the slot's key, read from
// global memory through L1, and the least lane), cleared in the kernel;
// claim and keep are two phases split by __syncthreads().  No memset,
// no scratch in device memory.  (Measured on the H100 and not kept:
// staging the batch in shared memory, and one probe and one atomicMin a
// fingerprint a warp; both were slower on the fused tile's queue.)
// Past BLOCK_MAX lanes the table no longer fits a block's shared
// memory, and the batch goes to two kernels over a scratch hash in
// device memory that the wrapper allocates (CAS-claimed, the same
// claim-then-publish protocol as fpset_insert.cu), after two memsets.
// The path depends on n alone.
//
// One corner of the JAX function is kept exactly: there, masked-out
// lanes sort under the all-ones key, and neighbours are compared by
// their REAL fingerprints.  A masked-in lane whose fingerprint is all
// ones therefore sorts among the masked-out lanes by position and is
// kept iff the nearest earlier lane of that group (masked-out, or
// all-ones) has a real fingerprint that is not all ones.  The keep
// phase scans back for that lane; the scan runs only for all-ones
// fingerprints.
#include <climits>

#include "common.cuh"

extern __shared__ int tpuvsr_dedup_smem[];

namespace {

constexpr uint32_t EMPTY = 0u, CLAIMING = 1u, READY = 2u;
// the one-block path: at most BLOCK_MAX lanes (engine/fpset.py
// DEDUP_BLOCK_MAX), a table of at most 2 x BLOCK_MAX slots (128 KB)
constexpr int BLOCK_MAX = 8192;
constexpr int BLOCK_THREADS = 1024;
constexpr int BLOCK_ITEMS = BLOCK_MAX / BLOCK_THREADS;

__device__ __forceinline__ bool all_ones(const uint32_t* f) {
    return (f[0] & f[1] & f[2] & f[3]) == 0xFFFFFFFFu;
}

// the nearest earlier lane of the all-ones key group (masked out, or
// masked in and all ones) decides an all-ones lane: kept iff that lane
// is not all ones, or there is none
__device__ bool keep_all_ones(const uint32_t* fps, const uint8_t* mask,
                              int i) {
    for (int j = i - 1; j >= 0; --j) {
        const uint32_t* g = fps + 4 * (size_t)j;
        if (!mask[j] || all_ones(g)) return !all_ones(g);
    }
    return true;
}

// one block: claim[s] (the lane whose fingerprint the slot holds, -1
// empty) and least[s] (the least lane of that fingerprint) in shared
// memory, hcap = hm + 1 slots each; each thread takes lanes tid,
// tid + blockDim, ... (at most BLOCK_ITEMS of them)
__global__ void __launch_bounds__(BLOCK_THREADS) dedup_block_kernel(
        const uint32_t* __restrict__ fps, const uint8_t* __restrict__ mask,
        int n, uint32_t hm, uint8_t* __restrict__ keep) {
    int* claim = tpuvsr_dedup_smem;
    int* least = claim + hm + 1;
    const int tid = threadIdx.x, nt = blockDim.x;
    for (uint32_t s = tid; s <= hm; s += nt) {
        claim[s] = -1;
        least[s] = INT_MAX;
    }
    __syncthreads();
    int slot[BLOCK_ITEMS];
#pragma unroll
    for (int k = 0; k < BLOCK_ITEMS; ++k) {
        const int i = tid + k * nt;
        slot[k] = -1;
        if (i >= n || !mask[i]) continue;
        const uint32_t* f = fps + 4 * (size_t)i;
        const uint32_t f0 = f[0], f1 = f[1], f2 = f[2], f3 = f[3];
        if ((f0 & f1 & f2 & f3) == 0xFFFFFFFFu) continue;
        uint32_t s = tpuvsr_slot_hash(f0, f1, f2, f3) & hm;
        for (;;) {
            int c = *(volatile int*)(claim + s);
            if (c < 0) c = atomicCAS(claim + s, -1, i);
            if (c < 0) break;                   // claimed it
            const uint32_t* g = fps + 4 * (size_t)c;
            if (g[0] == f0 && g[1] == f1 && g[2] == f2 && g[3] == f3)
                break;                          // its fingerprint's slot
            s = (s + 1) & hm;
        }
        atomicMin(least + s, i);
        slot[k] = (int)s;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BLOCK_ITEMS; ++k) {
        const int i = tid + k * nt;
        if (i >= n) continue;
        keep[i] = !mask[i] ? 0
                  : slot[k] >= 0 ? least[slot[k]] == i
                                 : keep_all_ones(fps, mask, i);
    }
}

__global__ void dedup_claim_kernel(const uint32_t* __restrict__ fps,
                                   const uint8_t* __restrict__ mask, int n,
                                   uint32_t* __restrict__ hkeys,
                                   uint32_t* __restrict__ hstate,
                                   int* __restrict__ hmin, uint32_t hm,
                                   int* __restrict__ lane_slot) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const uint32_t* f = fps + 4 * (size_t)i;
    if (!mask[i] || all_ones(f)) {
        lane_slot[i] = -1;
        return;
    }
    uint32_t s = tpuvsr_slot_hash(f[0], f[1], f[2], f[3]) & hm;
    for (;;) {
        uint32_t st = tpuvsr_load(hstate + s);
        if (st == EMPTY) {
            if (atomicCAS(hstate + s, EMPTY, CLAIMING) == EMPTY) {
                uint32_t* k = hkeys + 4 * (size_t)s;
                k[0] = f[0];
                k[1] = f[1];
                k[2] = f[2];
                k[3] = f[3];
                __threadfence();
                atomicExch(hstate + s, READY);
                atomicMin(hmin + s, i);
                lane_slot[i] = (int)s;
                return;
            }
            continue;
        }
        if (st == CLAIMING) continue;       // wait for the publish
        __threadfence();
        const uint32_t* k = hkeys + 4 * (size_t)s;
        if (tpuvsr_load(k) == f[0] && tpuvsr_load(k + 1) == f[1] &&
                tpuvsr_load(k + 2) == f[2] && tpuvsr_load(k + 3) == f[3]) {
            atomicMin(hmin + s, i);
            lane_slot[i] = (int)s;
            return;
        }
        s = (s + 1) & hm;
    }
}

__global__ void dedup_keep_kernel(const uint32_t* __restrict__ fps,
                                  const uint8_t* __restrict__ mask, int n,
                                  const int* __restrict__ hmin,
                                  const int* __restrict__ lane_slot,
                                  uint8_t* __restrict__ keep) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    if (!mask[i]) {
        keep[i] = 0;
        return;
    }
    const int s = lane_slot[i];
    keep[i] = s >= 0 ? hmin[s] == i : keep_all_ones(fps, mask, i);
}

}  // namespace

// The one-block path's table: a power of two >= 2n slots, at least 64.
static uint32_t block_slots(int n) {
    uint32_t h = 64;
    while (h < 2u * (uint32_t)n) h *= 2;
    return h;
}

// fps: [n, 4] uint32; mask, keep: [n] uint8.  Up to BLOCK_MAX lanes one
// kernel, one block, nothing else (the scratch arguments unused, null
// from the wrapper).  Past it, scratch from the wrapper: hkeys [hcap, 4]
// uint32, hstate [hcap] uint32, hmin [hcap] int32, lane_slot [n] int32,
// hcap a power of two >= 2n.
TPUVSR_EXPORT int tpuvsr_dedup_batch(const void* fps, const void* mask,
                                     int n, void* keep, void* hkeys,
                                     void* hstate, void* hmin,
                                     long long hcap, void* lane_slot,
                                     void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (n > 0 && n <= BLOCK_MAX) {
        const uint32_t slots = block_slots(n);
        const size_t smem = (size_t)slots * 2 * sizeof(int);
        // above 48 KB of dynamic shared memory the kernel opts in, once
        // for the largest table (128 KB), at the first such call
        static bool opted = false;
        if (smem > 48 * 1024 && !opted) {
            const cudaError_t e = cudaFuncSetAttribute(
                dedup_block_kernel,
                cudaFuncAttributeMaxDynamicSharedMemorySize,
                (int)(2 * BLOCK_MAX * 2 * sizeof(int)));
            if (e != cudaSuccess) return (int)e;
            opted = true;
        }
        const int threads = n < BLOCK_THREADS ? (n + 31) / 32 * 32
                                              : BLOCK_THREADS;
        KLAUNCH_SMEM(dedup_block_kernel, 1, threads, smem, st,
                     (const uint32_t*)fps, (const uint8_t*)mask, n,
                     slots - 1, (uint8_t*)keep);
    } else if (n > BLOCK_MAX) {
        if (!hkeys || !hstate || !hmin || !lane_slot || hcap < 2LL * n)
            return (int)cudaErrorInvalidValue;
        cudaMemsetAsync(hstate, 0, (size_t)hcap * 4, st);
        cudaMemsetAsync(hmin, 0x7F, (size_t)hcap * 4, st);  // > any lane
        const int threads = 256;
        KLAUNCH(dedup_claim_kernel, tpuvsr_blocks(n, threads), threads, st,
                (const uint32_t*)fps, (const uint8_t*)mask, n,
                (uint32_t*)hkeys, (uint32_t*)hstate, (int*)hmin,
                (uint32_t)(hcap - 1), (int*)lane_slot);
        KLAUNCH(dedup_keep_kernel, tpuvsr_blocks(n, threads), threads, st,
                (const uint32_t*)fps, (const uint8_t*)mask, n,
                (const int*)hmin, (const int*)lane_slot, (uint8_t*)keep);
    }
    return (int)cudaGetLastError();
}
