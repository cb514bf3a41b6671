// K9: orbit canonicalization (symmetry reduction).
//
// Replaces tpuvsr/engine/canon.py:202 CanonSpec.canonicalize (with
// _apply :177, _key :194 and _lex_less :134), with the model's own
// permutation action: on the VSR layout tpuvsr/models/vsr_kernel.py:1015
// _permuted, on the family tpuvsr/models/st03_kernel.py:779 _permuted
// over its _perm_vals (st03_kernel.py:773, a01_kernel.py:42,
// cp06_kernel.py:66).  Each state row becomes the lexicographically least
// of its images under the symmetry group, an identity-first [P, V+1]
// value-id table.  An image's key is the concatenation of the symmetric
// planes in sorted plane-name order, each flattened in C order of its
// dense shape, compared as uint32; a tie keeps the earlier image (strict
// <).
//
// A group row g relabels a key-lane code c in one of three ways (the
// launch argument ``mode``, engine/canon.py MODES; exactly the model's
// _perm_vals):
//   M_PLAIN   c is a value id: g[c], with a JAX gather's handling of an
//             index outside 0..V (a negative one counts from the end, then
//             the index is clamped).  VSR's operation columns, ST03, AS04,
//             AL05.
//   M_PACKED  c is vid << shift | view (A01, I01, RR05): for c > 0,
//             g[vid] << shift | view, vid taken by a logical shift of the
//             32-bit word and gathered as above; c <= 0 is unchanged.
//   M_NOOP    ids above V are fixed (CP06's NoOp, V + 1); the others are
//             clipped into 0..V and relabelled, g[clip(c, 0, V)].
//
// The images of one row differ only at the lanes a permutation relabels,
// so the first difference of two keys lies at one of them.  The
// host-built table ``pos`` lists their flat-lane indices in key order
// (engine/canon.py:CanonSpec._positions): the kernel compares images at
// those K lanes only (the first lane whose relabelled words differ, as
// uint32), and the winner is the row with those lanes relabelled through
// its table row.
//
// What bounds it on the H100: bytes.  Each row is read once and written
// once, so the least time is 2 x n x lanes x 4 B over 3.35 TB/s; the
// P - 1 comparisons read the K key lanes from shared memory and the
// [P, V+1] table from L1.  At the BFS tile's sizes (a few thousand rows
// of a few hundred lanes) a launch is latency-bound.
//
// Design.  One block per row.  The block copies the row to the output
// (coalesced) and loads the K raw key-lane codes into shared memory (at
// most 48 KB: 12,288 key lanes; a larger table is refused at launch).
// For each group row after the identity, each thread finds the first key
// position of its stride where that image differs from the best so far,
// a shared atomicMin gives the first over the block, and one thread
// compares the two images there.  Then the key lanes of the output are
// overwritten with the winner's relabelling.
#include "common.cuh"

namespace {

constexpr int THREADS = 128;

enum Mode { M_PLAIN, M_PACKED, M_NOOP };

// g[i] as a JAX gather reads it: a negative index counts from the end,
// then the index is clamped into the table
__device__ __forceinline__ int gather(const int* g, int i, int V1) {
    if (i < 0) i += V1;
    return g[i < 0 ? 0 : (i >= V1 ? V1 - 1 : i)];
}

// the code c relabelled through table row g
__device__ __forceinline__ int relabel(const int* g, int c, int V1,
                                       int mode, int shift) {
    if (mode == M_PACKED) {
        if (c <= 0) return c;
        const uint32_t u = (uint32_t)c;
        const uint32_t view = u & ((1u << shift) - 1u);
        return (int)(((uint32_t)gather(g, (int)(u >> shift), V1) << shift)
                     | view);
    }
    if (mode == M_NOOP) {
        if (c > V1 - 1) return c;
        return g[c < 0 ? 0 : c];
    }
    return gather(g, c, V1);
}

__global__ void canon_kernel(const int* __restrict__ rows, int lanes,
                             const int* __restrict__ group, int P, int V1,
                             const int* __restrict__ pos, int K, int mode,
                             int shift, int* __restrict__ out) {
    extern __shared__ int vals[];          // [K] key-lane codes of the row
    __shared__ int s_first, s_best;
    const size_t b = blockIdx.x;
    const int* row = rows + b * (size_t)lanes;
    int* dst = out + b * (size_t)lanes;
    for (int i = threadIdx.x; i < lanes; i += blockDim.x) dst[i] = row[i];
    for (int k = threadIdx.x; k < K; k += blockDim.x) vals[k] = row[pos[k]];
    if (threadIdx.x == 0) s_best = 0;
    __syncthreads();
    for (int g = 1; g < P; ++g) {
        if (threadIdx.x == 0) s_first = K;
        __syncthreads();
        const int* pg = group + (size_t)g * V1;
        const int* pb = group + (size_t)s_best * V1;
        for (int k = threadIdx.x; k < K; k += blockDim.x) {
            if (relabel(pg, vals[k], V1, mode, shift)
                != relabel(pb, vals[k], V1, mode, shift)) {
                atomicMin(&s_first, k);
                break;
            }
        }
        __syncthreads();
        if (threadIdx.x == 0 && s_first < K) {
            const int c = vals[s_first];
            if ((uint32_t)relabel(pg, c, V1, mode, shift)
                < (uint32_t)relabel(pb, c, V1, mode, shift))
                s_best = g;
        }
        __syncthreads();
    }
    const int* pw = group + (size_t)s_best * V1;
    for (int k = threadIdx.x; k < K; k += blockDim.x)
        dst[pos[k]] = relabel(pw, vals[k], V1, mode, shift);
}

}  // namespace

// rows [n, lanes] int32 -> out [n, lanes] int32 (not aliased); group
// [P, V1] int32, identity first; pos [K] int32 flat-lane indices in key
// order; mode an enum Mode, shift the packed mode's view bits (1..31).
TPUVSR_EXPORT int tpuvsr_canon(const void* rows, int n, int lanes,
                               const void* group, int P, int V1,
                               const void* pos, int K, int mode, int shift,
                               void* out, void* stream) {
    if (mode < M_PLAIN || mode > M_NOOP
        || (mode == M_PACKED && (shift < 1 || shift > 31)))
        return (int)cudaErrorInvalidValue;
    if (n > 0) {
        const size_t smem = (size_t)K * sizeof(int);
        if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
        KLAUNCH_SMEM(canon_kernel, n, THREADS, smem, (cudaStream_t)stream,
                     (const int*)rows, lanes, (const int*)group, P, V1,
                     (const int*)pos, K, mode, shift, (int*)out);
    }
    return (int)cudaGetLastError();
}
