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
