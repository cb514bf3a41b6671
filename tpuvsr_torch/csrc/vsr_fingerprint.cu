// K3: the 128-bit state fingerprint of the VSR family, full and
// incremental.
//
// Replaces tpuvsr/models/vsr_kernel.py:_mix32, _rep_hashes,
// _slot_hashes, _fp_one, fingerprint, parent_parts and
// fingerprint_incremental, and their ST03 counterparts
// tpuvsr/models/st03_kernel.py:763-907 with its global row _glob_hash
// (identity permutation table only: the engine's kernel is built with
// fold_symmetry=False).  The fingerprint of a dense state is
//   rep_h[r]  = mix32(sum_c rep_row[r][c] * k_rep[w][c] + seed[w])
//   slot_h[m] = mix32(sum_c slot_row[m][c] * k_msg[w][c] + seed[w])
//   glob      = mix32(sum_c glob_row[c] * k_glob[w][c] + seed[w])
//   total     = sum_r rep_h[r] + sum_m m_present[m] * slot_h[m]
//   fp[w]     = mix32(mix32(total[w] + glob[w]) + seed[w])
// for the four words w, in wrapping uint32 arithmetic.  A replica row
// is the replica index followed by every per-replica state slice; a
// slot row is the message slot's planes (VSR: header, entry, payload
// log, log length, has-log flag and count; ST03: header, entry, log and
// count).  The global row is optional (nglob = 0: no glob term, VSR);
// ST03's is its no_progress plane and counter.  total (the parts) never
// includes it: the incremental form recomputes it from the successor.
// The wrapper hands the kernels the flat lane index of every row column
// (rep_cols, slot_cols, glob_cols), so the state stays in the engine's
// flat [B, lanes] int32 layout.
//
// What bounds it on the H100: integer multiply-adds — about 4 x (R x
// n_rep + M x n_msg) per full state (1,680 x 4 at the defect layout)
// against a 1.9 KB state read; the incremental form touches one
// replica row and at most R + 1 slot rows per successor.  At these
// sizes the launches are small and latency-bound.
//
// Design.  Parts: one thread per (state, row) computes the row's four
// hash words; a second pass, one thread per state, sums the parts and
// mixes.  Incremental: one thread per successor starts from its
// parent's total, swaps in the touched replica row's hash and the
// touched slots' hashes, and mixes.  No shared memory, no warp
// primitives: a simple, exact first version.
#include "common.cuh"

namespace {

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
    x = x ^ (x >> 16);
    x = x * 0x85EBCA6Bu;
    x = x ^ (x >> 13);
    x = x * 0xC2B2AE35u;
    x = x ^ (x >> 16);
    return x;
}

struct Layout {
    int lanes;               // ints per flat state row
    int R, M, nrep, nmsg, nglob;
    const int* rep_cols;     // [R, nrep] flat lane index, -1 = replica id
    const int* slot_cols;    // [M, nmsg] flat lane index
    const int* pres_cols;    // [M] flat lane index of m_present[m]
    const int* glob_cols;    // [nglob] flat lane index (null if nglob 0)
    const uint32_t* k_rep;   // [4, nrep]
    const uint32_t* k_msg;   // [4, nmsg]
    const uint32_t* k_glob;  // [4, nglob] (null if nglob 0)
    const uint32_t* seeds;   // [4]
};

__device__ __forceinline__ void rep_hash(const Layout& L, const int* st,
                                         int r, uint32_t h[4]) {
    uint32_t a0 = 0, a1 = 0, a2 = 0, a3 = 0;
    const int* cols = L.rep_cols + (size_t)r * L.nrep;
    for (int c = 0; c < L.nrep; ++c) {
        const int lane = cols[c];
        const uint32_t v = lane < 0 ? (uint32_t)r : (uint32_t)st[lane];
        a0 += v * L.k_rep[c];
        a1 += v * L.k_rep[L.nrep + c];
        a2 += v * L.k_rep[2 * L.nrep + c];
        a3 += v * L.k_rep[3 * L.nrep + c];
    }
    h[0] = mix32(a0 + L.seeds[0]);
    h[1] = mix32(a1 + L.seeds[1]);
    h[2] = mix32(a2 + L.seeds[2]);
    h[3] = mix32(a3 + L.seeds[3]);
}

__device__ __forceinline__ void slot_hash(const Layout& L, const int* st,
                                          int m, uint32_t h[4]) {
    uint32_t a0 = 0, a1 = 0, a2 = 0, a3 = 0;
    const int* cols = L.slot_cols + (size_t)m * L.nmsg;
    for (int c = 0; c < L.nmsg; ++c) {
        const uint32_t v = (uint32_t)st[cols[c]];
        a0 += v * L.k_msg[c];
        a1 += v * L.k_msg[L.nmsg + c];
        a2 += v * L.k_msg[2 * L.nmsg + c];
        a3 += v * L.k_msg[3 * L.nmsg + c];
    }
    h[0] = mix32(a0 + L.seeds[0]);
    h[1] = mix32(a1 + L.seeds[1]);
    h[2] = mix32(a2 + L.seeds[2]);
    h[3] = mix32(a3 + L.seeds[3]);
}

// adds the global row's hash to d (nothing without a global row)
__device__ __forceinline__ void add_glob(const Layout& L, const int* st,
                                         uint32_t d[4]) {
    if (L.nglob == 0) return;
    uint32_t a[4] = {0, 0, 0, 0};
    for (int c = 0; c < L.nglob; ++c) {
        const uint32_t v = (uint32_t)st[L.glob_cols[c]];
        for (int w = 0; w < 4; ++w) a[w] += v * L.k_glob[w * L.nglob + c];
    }
    for (int w = 0; w < 4; ++w) d[w] += mix32(a[w] + L.seeds[w]);
}

// one thread per (state, row): rows 0..R-1 are replicas, R..R+M-1 slots
__global__ void parts_kernel(Layout L, const int* __restrict__ flat, int B,
                             uint32_t* __restrict__ rep_h,
                             uint32_t* __restrict__ slot_h) {
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const int rows = L.R + L.M;
    if (t >= (long long)B * rows) return;
    const int b = (int)(t / rows), row = (int)(t % rows);
    const int* st = flat + (size_t)b * L.lanes;
    uint32_t h[4];
    uint32_t* out;
    if (row < L.R) {
        rep_hash(L, st, row, h);
        out = rep_h + ((size_t)b * L.R + row) * 4;
    } else {
        slot_hash(L, st, row - L.R, h);
        out = slot_h + ((size_t)b * L.M + row - L.R) * 4;
    }
    out[0] = h[0];
    out[1] = h[1];
    out[2] = h[2];
    out[3] = h[3];
}

// one thread per state: total = sum of parts;
// fp = mix(mix(total + glob) + seed)
__global__ void total_kernel(Layout L, const int* __restrict__ flat, int B,
                             const uint32_t* __restrict__ rep_h,
                             const uint32_t* __restrict__ slot_h,
                             uint32_t* __restrict__ total,
                             uint32_t* __restrict__ fp) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    const int* st = flat + (size_t)b * L.lanes;
    uint32_t s[4] = {0, 0, 0, 0};
    for (int r = 0; r < L.R; ++r)
        for (int w = 0; w < 4; ++w)
            s[w] += rep_h[((size_t)b * L.R + r) * 4 + w];
    for (int m = 0; m < L.M; ++m) {
        const uint32_t p = (uint32_t)st[L.pres_cols[m]];
        for (int w = 0; w < 4; ++w)
            s[w] += slot_h[((size_t)b * L.M + m) * 4 + w] * p;
    }
    if (total)
        for (int w = 0; w < 4; ++w) total[(size_t)b * 4 + w] = s[w];
    if (fp) {
        add_glob(L, st, s);
        for (int w = 0; w < 4; ++w)
            fp[(size_t)b * 4 + w] = mix32(mix32(s[w]) + L.seeds[w]);
    }
}

// one thread per successor item
__global__ void incremental_kernel(
        Layout L, const int* __restrict__ succ, int n,
        const int* __restrict__ ri, const int* __restrict__ ts, int nts,
        const int* __restrict__ pidx, const int* __restrict__ parent,
        const uint32_t* __restrict__ rep_h,
        const uint32_t* __restrict__ slot_h,
        const uint32_t* __restrict__ total, uint32_t* __restrict__ fp) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int p = pidx[i];
    const int r = ri[i];
    const int* st = succ + (size_t)i * L.lanes;
    const int* pst = parent + (size_t)p * L.lanes;
    uint32_t d[4], h[4];
    for (int w = 0; w < 4; ++w)
        d[w] = total[(size_t)p * 4 + w] - rep_h[((size_t)p * L.R + r) * 4 + w];
    rep_hash(L, st, r, h);
    for (int w = 0; w < 4; ++w) d[w] += h[w];
    for (int t = 0; t < nts; ++t) {
        const int s = ts[(size_t)i * nts + t];
        if (s < 0) continue;
        const int sc = s < L.M ? s : L.M - 1;
        const uint32_t pp = (uint32_t)pst[L.pres_cols[sc]];
        const uint32_t sp = (uint32_t)st[L.pres_cols[sc]];
        slot_hash(L, st, sc, h);
        for (int w = 0; w < 4; ++w) {
            d[w] -= slot_h[((size_t)p * L.M + sc) * 4 + w] * pp;
            d[w] += h[w] * sp;
        }
    }
    add_glob(L, st, d);
    for (int w = 0; w < 4; ++w)
        fp[(size_t)i * 4 + w] = mix32(mix32(d[w]) + L.seeds[w]);
}

Layout make_layout(int lanes, int R, int M, int nrep, int nmsg, int nglob,
                   const void* rep_cols, const void* slot_cols,
                   const void* pres_cols, const void* glob_cols,
                   const void* k_rep, const void* k_msg, const void* k_glob,
                   const void* seeds) {
    Layout L;
    L.lanes = lanes;
    L.R = R;
    L.M = M;
    L.nrep = nrep;
    L.nmsg = nmsg;
    L.nglob = nglob;
    L.rep_cols = (const int*)rep_cols;
    L.slot_cols = (const int*)slot_cols;
    L.pres_cols = (const int*)pres_cols;
    L.glob_cols = (const int*)glob_cols;
    L.k_rep = (const uint32_t*)k_rep;
    L.k_msg = (const uint32_t*)k_msg;
    L.k_glob = (const uint32_t*)k_glob;
    L.seeds = (const uint32_t*)seeds;
    return L;
}

}  // namespace

#define TPUVSR_LAYOUT_ARGS                                              \
    int lanes, int R, int M, int nrep, int nmsg, int nglob,            \
        const void *rep_cols, const void *slot_cols,                   \
        const void *pres_cols, const void *glob_cols,                  \
        const void *k_rep, const void *k_msg, const void *k_glob,      \
        const void *seeds
#define TPUVSR_LAYOUT                                                   \
    make_layout(lanes, R, M, nrep, nmsg, nglob, rep_cols, slot_cols,   \
                pres_cols, glob_cols, k_rep, k_msg, k_glob, seeds)

// flat: [B, lanes] int32 -> rep_h [B, R, 4], slot_h [B, M, 4], total
// [B, 4] (pre-mix sums, global row left out), and fp [B, 4] when fp is
// not null; total may be null when only fp is wanted.
TPUVSR_EXPORT int tpuvsr_vsr_fp_parts(TPUVSR_LAYOUT_ARGS, const void* flat,
                                      int B, void* rep_h, void* slot_h,
                                      void* total, void* fp, void* stream) {
    if (B > 0) {
        const Layout L = TPUVSR_LAYOUT;
        cudaStream_t st = (cudaStream_t)stream;
        const int threads = 128;
        KLAUNCH(parts_kernel, tpuvsr_blocks((long long)B * (R + M), threads),
                threads, st, L, (const int*)flat, B, (uint32_t*)rep_h,
                (uint32_t*)slot_h);
        KLAUNCH(total_kernel, tpuvsr_blocks(B, threads), threads, st, L,
                (const int*)flat, B, (const uint32_t*)rep_h,
                (const uint32_t*)slot_h, (uint32_t*)total, (uint32_t*)fp);
    }
    return (int)cudaGetLastError();
}

// succ: [n, lanes] int32 successors; ri [n], pidx [n] int32; ts [n, nts]
// int32 touched slots (-1 padded); parent [T, lanes] and the parents'
// parts rep_h [T, R, 4], slot_h [T, M, 4], total [T, 4] -> fp [n, 4].
TPUVSR_EXPORT int tpuvsr_vsr_fp_incremental(
        TPUVSR_LAYOUT_ARGS, const void* succ, int n, const void* ri,
        const void* ts, int nts, const void* pidx, const void* parent,
        const void* rep_h, const void* slot_h, const void* total, void* fp,
        void* stream) {
    if (n > 0) {
        const Layout L = TPUVSR_LAYOUT;
        const int threads = 128;
        KLAUNCH(incremental_kernel, tpuvsr_blocks(n, threads), threads,
                (cudaStream_t)stream, L, (const int*)succ, n, (const int*)ri,
                (const int*)ts, nts, (const int*)pidx, (const int*)parent,
                (const uint32_t*)rep_h, (const uint32_t*)slot_h,
                (const uint32_t*)total, (uint32_t*)fp);
    }
    return (int)cudaGetLastError();
}
