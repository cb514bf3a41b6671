// K2: stable first-occurrence dedup of a fingerprint batch.
//
// Replaces tpuvsr/engine/fpset.py:dedup_batch as the fused commit uses
// it (device_bfs.py:937-938): the lexsort-based (perm, keep) pair is
// only ever scattered back to queue order, so this kernel returns the
// keep mask in queue order directly.  keep[i] is true for a masked-in
// lane i when no masked-in lane j < i carries the same fingerprint.
//
// What bounds it on the H100: each lane reads its 16-byte fingerprint
// and mask byte and writes one keep byte; the scratch hash adds a few
// random accesses per lane.  At the engine's batch sizes (a few
// thousand lanes) a launch is latency-bound.
//
// Design.  Instead of a sort: pass 1 inserts every masked-in lane into
// a scratch open-addressing hash of 2n..4n slots (CAS-claimed, the
// same claim-then-publish protocol as fpset_insert.cu) and takes an
// atomicMin of the lane index at the slot of its fingerprint; pass 2
// keeps a lane iff its index won.  Equal fingerprints meet in one slot,
// so the winner is the earliest lane, as the stable sort makes it.
//
// One corner of the JAX function is kept exactly: there, masked-out
// lanes sort under the all-ones key, and neighbours are compared by
// their REAL fingerprints.  A masked-in lane whose fingerprint is all
// ones therefore sorts among the masked-out lanes by position and is
// kept iff the nearest earlier lane of that group (masked-out, or
// all-ones) has a real fingerprint that is not all ones.  Pass 2 scans
// back for that lane; the scan runs only for all-ones fingerprints.
#include "common.cuh"

namespace {

constexpr uint32_t EMPTY = 0u, CLAIMING = 1u, READY = 2u;

__device__ __forceinline__ bool all_ones(const uint32_t* f) {
    return (f[0] & f[1] & f[2] & f[3]) == 0xFFFFFFFFu;
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
    if (s >= 0) {
        keep[i] = hmin[s] == i;
        return;
    }
    // all-ones fingerprint: find the nearest earlier lane of the
    // all-ones key group (masked out, or masked in and all ones)
    for (int j = i - 1; j >= 0; --j) {
        const uint32_t* g = fps + 4 * (size_t)j;
        if (!mask[j] || all_ones(g)) {
            keep[i] = !all_ones(g);
            return;
        }
    }
    keep[i] = 1;
}

}  // namespace

// fps: [n, 4] uint32; mask, keep: [n] uint8.  Scratch from the wrapper:
// hkeys [hcap, 4] uint32, hstate [hcap] uint32, hmin [hcap] int32,
// lane_slot [n] int32, hcap a power of two >= 2n.
TPUVSR_EXPORT int tpuvsr_dedup_batch(const void* fps, const void* mask,
                                     int n, void* keep, void* hkeys,
                                     void* hstate, void* hmin,
                                     long long hcap, void* lane_slot,
                                     void* stream) {
    if (n > 0) {
        cudaStream_t st = (cudaStream_t)stream;
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
