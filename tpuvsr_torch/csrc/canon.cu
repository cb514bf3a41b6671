// K9: orbit canonicalization (symmetry reduction).
//
// Replaces tpuvsr/engine/canon.py:202 CanonSpec.canonicalize (with
// _apply :177, _key :194 and _lex_less :134; on the VSR layout the
// permutation action is tpuvsr/models/vsr_kernel.py:1015 _permuted).
// Each state row becomes the lexicographically least of its images under
// the symmetry group, an identity-first [P, V+1] value-id table.  An
// image's key is the concatenation of the symmetric planes in sorted
// plane-name order, each flattened in C order of its dense shape,
// compared as uint32; a tie keeps the earlier image (strict <).
//
// The images of one row differ only at the lanes a permutation relabels
// (on VSR the operation column of every log-entry row), so the first
// difference of two keys lies at one of them.  The host-built table
// ``pos`` lists their flat-lane indices in key order
// (engine/canon.py:CanonSpec._positions): the kernel compares images at
// those K lanes only, and the winner is the row with those lanes
// relabelled through its table row.
//
// What bounds it on the H100: bytes.  Each row is read once and written
// once (4 x lanes bytes each way); the P - 1 comparisons read the K key
// lanes from shared memory.  At the BFS tile's sizes (a few thousand
// rows of a few hundred lanes) a launch is latency-bound.
//
// Design.  One block per row.  The block copies the row to the output
// (coalesced) and loads the K key lanes into shared memory.  For each
// group row after the identity, each thread finds the first key position
// of its stride where that image differs from the best so far, a shared
// atomicMin gives the first over the block, and one thread compares the
// two images there.  Then the key lanes of the output are overwritten
// with the winner's relabelling.  A value outside 0..V (no reachable
// state holds one) indexes the table as a JAX gather does: a negative
// one counts from the end, then it is clamped.
#include "common.cuh"

namespace {

constexpr int THREADS = 128;

__global__ void canon_kernel(const int* __restrict__ rows, int lanes,
                             const int* __restrict__ group, int P, int V1,
                             const int* __restrict__ pos, int K,
                             int* __restrict__ out) {
    extern __shared__ int vals[];          // [K] key lanes of the row
    __shared__ int s_first, s_best;
    const size_t b = blockIdx.x;
    const int* row = rows + b * (size_t)lanes;
    int* dst = out + b * (size_t)lanes;
    for (int i = threadIdx.x; i < lanes; i += blockDim.x) dst[i] = row[i];
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
        int v = row[pos[k]];
        if (v < 0) v += V1;
        vals[k] = v < 0 ? 0 : (v >= V1 ? V1 - 1 : v);
    }
    if (threadIdx.x == 0) s_best = 0;
    __syncthreads();
    for (int g = 1; g < P; ++g) {
        if (threadIdx.x == 0) s_first = K;
        __syncthreads();
        const int* pg = group + (size_t)g * V1;
        const int* pb = group + (size_t)s_best * V1;
        for (int k = threadIdx.x; k < K; k += blockDim.x) {
            if (pg[vals[k]] != pb[vals[k]]) {
                atomicMin(&s_first, k);
                break;
            }
        }
        __syncthreads();
        if (threadIdx.x == 0 && s_first < K) {
            const int v = vals[s_first];
            if ((uint32_t)pg[v] < (uint32_t)pb[v]) s_best = g;
        }
        __syncthreads();
    }
    const int* pw = group + (size_t)s_best * V1;
    for (int k = threadIdx.x; k < K; k += blockDim.x)
        dst[pos[k]] = pw[vals[k]];
}

}  // namespace

// rows [n, lanes] int32 -> out [n, lanes] int32 (not aliased); group
// [P, V1] int32, identity first; pos [K] int32 flat-lane indices in key
// order.
TPUVSR_EXPORT int tpuvsr_canon(const void* rows, int n, int lanes,
                               const void* group, int P, int V1,
                               const void* pos, int K, void* out,
                               void* stream) {
    if (n > 0) {
        const size_t smem = (size_t)K * sizeof(int);
        if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
        KLAUNCH_SMEM(canon_kernel, n, THREADS, smem, (cudaStream_t)stream,
                     (const int*)rows, lanes, (const int*)group, P, V1,
                     (const int*)pos, K, (int*)out);
    }
    return (int)cudaGetLastError();
}
