// Shared helpers of the port's hand kernels (CUDA C++ for sm_90a).
//
// Every kernel source exposes a plain C interface: each entry point
// takes device pointers, sizes and the caller's CUDA stream, launches
// on that stream without synchronising, and returns the value of
// cudaGetLastError() so the Python wrapper can raise on a refused
// launch.  KLAUNCH (KLAUNCH_SMEM with dynamic shared memory) wraps the
// launch syntax so the same source reads as one kernel call per launch
// site.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define KLAUNCH(kernel, grid, block, stream, ...) \
    kernel<<<(grid), (block), 0, (stream)>>>(__VA_ARGS__)
#define KLAUNCH_SMEM(kernel, grid, block, smem, stream, ...) \
    kernel<<<(grid), (block), (smem), (stream)>>>(__VA_ARGS__)

#define TPUVSR_EXPORT extern "C" __attribute__((visibility("default")))

static inline unsigned int tpuvsr_blocks(long long n, int threads) {
    return (unsigned int)((n + threads - 1) / threads);
}

// Probe-start hash of a keyed 128-bit fingerprint: the same arithmetic
// as tpuvsr/engine/fpset.py:_slot_hash, in wrapping uint32.
__device__ __forceinline__ uint32_t tpuvsr_slot_hash(
        uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
    uint32_t h = a ^ (b * 0x9E3779B1u);
    h = h ^ (c * 0x85EBCA6Bu) ^ (d >> 5);
    h = h ^ (h >> 15);
    return h * 0x27D4EB2Fu;
}

__device__ __forceinline__ uint32_t tpuvsr_load(const uint32_t* p) {
    return *(const volatile uint32_t*)p;
}

// The FPSet probe chain shared by K11 (csrc/fpset_gids.cu) and K17
// (csrc/por_ample.cu): a fingerprint [4] uint32 is keyed (word 0 remapped
// 0 -> 1, as tpuvsr/engine/fpset.py:_keyed does, since 0 marks an empty
// slot) and probed linearly from tpuvsr_slot_hash over the slots[CAP, 5]
// table (tag, row0, row1, row2, claim), at most TPUVSR_MAX_PROBES probes.
constexpr int TPUVSR_MAX_PROBES = 64;

__device__ __forceinline__ void tpuvsr_keyed(const uint32_t* fps,
                                             long long i, uint32_t* k) {
    k[0] = fps[4 * (size_t)i + 0];
    k[1] = fps[4 * (size_t)i + 1];
    k[2] = fps[4 * (size_t)i + 2];
    k[3] = fps[4 * (size_t)i + 3];
    if (k[0] == 0) k[0] = 1;
}

// true when the slot row holds the keyed fingerprint k
__device__ __forceinline__ bool tpuvsr_slot_is(const uint32_t* row,
                                               const uint32_t* k) {
    return row[0] == k[0] && row[1] == k[1] && row[2] == k[2] &&
           row[3] == k[3];
}

// The read-only probe of one keyed fingerprint: the index of the slot
// that holds it, -1 when an empty slot ends the chain first (absent), -2
// when it is unresolved after TPUVSR_MAX_PROBES probes.
__device__ __forceinline__ long long tpuvsr_probe(const uint32_t* slots,
                                                  uint32_t capm,
                                                  const uint32_t* k) {
    const uint32_t h = tpuvsr_slot_hash(k[0], k[1], k[2], k[3]);
    for (int t = 0; t < TPUVSR_MAX_PROBES; ++t) {
        const uint32_t idx = (h + (uint32_t)t) & capm;
        const uint32_t* row = slots + 5 * (size_t)idx;
        if (tpuvsr_slot_is(row, k)) return idx;
        if (row[0] == 0) return -1;
    }
    return -2;
}
