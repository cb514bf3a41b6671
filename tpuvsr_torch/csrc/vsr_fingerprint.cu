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
// What bounds it on the H100: about 4 x (R x n_rep + M x n_msg) 32-bit
// multiply-adds per full state (1,304 columns at the defect layout)
// against a 5.4 KB state read: 0.2 us for a tile's 128 parents by
// bytes.  The products are 32 x 32-bit wrapping, which no tensor-core
// MMA computes exactly, so the work stays on the integer pipes.  What
// costs time is latency: at these sizes a launch has little work, and
// a design that walks a row's columns one after another on one thread,
// each a dependent pair of global loads, waits on memory a column.
//
// Design.  Full and parts are one launch: one block of 8 warps per
// state.  It copies the state row into shared memory (16-byte loads
// where the row is aligned; the layout sizes the dynamic shared memory
// at launch).  A row's columns are cut into pieces of 32; each warp
// takes pieces in turn, its lanes one column each (a coalesced read of
// the column and key tables, the value from shared memory), reduces
// the four words by __shfl_xor_sync (a butterfly that halves the words
// a lane keeps: six shuffles, not twenty) and adds them into the row's
// sum in shared memory.  Wrapping uint32 addition is associative and
// commutative, so any order of pieces gives the plain version's bits.
// After a barrier the rows are mixed and written, and one warp sums the
// parts (the present slots only), adds the global row and writes total
// and fp.  Incremental: one warp per successor, four to a block; the
// warp hashes the touched replica row, each touched slot and the
// global row the same way, its lanes over the columns, and folds them
// into its parent's total; each group of eight lanes keeps one word.
#include "common.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int PARTS_THREADS = 256;
constexpr int INCR_WARPS = 4;

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

// the warp's totals of four words, reduced and spread at once: a lane
// ends with the total of word (lane >> 3) & 3, in six shuffles (a
// butterfly that halves the words each lane keeps, then a reduction of
// one word over each group of eight lanes)
__device__ __forceinline__ uint32_t warp_sum4(const uint32_t a[4],
                                              int lane) {
    const bool hi = lane & 16, mid = lane & 8;
    uint32_t k0 = hi ? a[2] : a[0], k1 = hi ? a[3] : a[1];
    k0 += __shfl_xor_sync(FULL, hi ? a[0] : a[2], 16);
    k1 += __shfl_xor_sync(FULL, hi ? a[1] : a[3], 16);
    uint32_t s = mid ? k1 : k0;
    s += __shfl_xor_sync(FULL, mid ? k0 : k1, 8);
    s += __shfl_xor_sync(FULL, s, 4);
    s += __shfl_xor_sync(FULL, s, 2);
    s += __shfl_xor_sync(FULL, s, 1);
    return s;
}

// one lane's share of a row's four sums: columns lane, lane+32, ... of
// the row whose flat lane indices are cols[0..n) and key words
// k[w * n + c]; a column index below 0 reads the replica id ``rid``
__device__ __forceinline__ void row_terms(const int* cols, int n,
                                          const uint32_t* k, int lane,
                                          const uint32_t* st, int rid,
                                          uint32_t a[4]) {
#pragma unroll 4
    for (int c = lane; c < n; c += 32) {
        const int col = cols[c];
        const uint32_t v = col < 0 ? (uint32_t)rid : st[col];
        a[0] += v * k[c];
        a[1] += v * k[n + c];
        a[2] += v * k[2 * n + c];
        a[3] += v * k[3 * n + c];
    }
}

// one block per state.  Shared memory: the state row [lanes], then the
// row sums [(R + M + 1) * 4] (row R + M is the global row).
__global__ void __launch_bounds__(PARTS_THREADS) parts_kernel(
        Layout L, const int* __restrict__ flat, uint32_t* __restrict__ rep_h,
        uint32_t* __restrict__ slot_h, uint32_t* __restrict__ total,
        uint32_t* __restrict__ fp) {
    extern __shared__ uint32_t smem[];
    uint32_t* st = smem;
    uint32_t* acc = smem + L.lanes;
    const int b = blockIdx.x, tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int nwarps = PARTS_THREADS / 32;
    const int rows = L.R + L.M, nacc = (rows + 1) * 4;
    for (int j = tid; j < nacc; j += PARTS_THREADS) acc[j] = 0;
    // the state row: scalar loads up to a 16-byte boundary, then int4
    const uint32_t* src = (const uint32_t*)flat + (size_t)b * L.lanes;
    const int head =
        min(L.lanes, (int)((16 - ((uintptr_t)src & 15)) & 15) / 4);
    for (int j = tid; j < head; j += PARTS_THREADS) st[j] = src[j];
    const int nvec = (L.lanes - head) / 4;
    const uint4* vsrc = (const uint4*)(src + head);
    for (int j = tid; j < nvec; j += PARTS_THREADS) {
        const uint4 q = vsrc[j];
        uint32_t* d = st + head + 4 * j;
        d[0] = q.x;
        d[1] = q.y;
        d[2] = q.z;
        d[3] = q.w;
    }
    for (int j = head + 4 * nvec + tid; j < L.lanes; j += PARTS_THREADS)
        st[j] = src[j];
    __syncthreads();
    // pieces of 32 columns: replica rows, slot rows, the global row
    const int prep = (L.nrep + 31) / 32, pmsg = (L.nmsg + 31) / 32;
    const int pglob = (L.nglob + 31) / 32;
    const int n_rep = L.R * prep, n_units = n_rep + L.M * pmsg + pglob;
    for (int u = warp; u < n_units; u += nwarps) {
        int row, piece, n;
        const int* cols;
        const uint32_t* k;
        if (u < n_rep) {
            row = u / prep;
            piece = u - row * prep;
            n = L.nrep;
            cols = L.rep_cols + (size_t)row * n;
            k = L.k_rep;
        } else if (u < n_rep + L.M * pmsg) {
            const int m = (u - n_rep) / pmsg;
            piece = u - n_rep - m * pmsg;
            row = L.R + m;
            n = L.nmsg;
            cols = L.slot_cols + (size_t)m * n;
            k = L.k_msg;
        } else {
            row = rows;
            piece = u - n_rep - L.M * pmsg;
            n = L.nglob;
            cols = L.glob_cols;
            k = L.k_glob;
        }
        const int c = piece * 32 + lane;
        uint32_t a[4] = {0, 0, 0, 0};
        if (c < n) {
            const int col = cols[c];
            const uint32_t v = col < 0 ? (uint32_t)row : st[col];
            for (int w = 0; w < 4; ++w) a[w] = v * k[w * n + c];
        }
        const uint32_t t = warp_sum4(a, lane);
        if ((lane & 7) == 0) atomicAdd(&acc[row * 4 + (lane >> 3)], t);
    }
    __syncthreads();
    const int nmix = (rows + (L.nglob > 0)) * 4;
    for (int j = tid; j < nmix; j += PARTS_THREADS) {
        const uint32_t h = mix32(acc[j] + L.seeds[j & 3]);
        acc[j] = h;
        if (j < L.R * 4)
            rep_h[(size_t)b * L.R * 4 + j] = h;
        else if (j < rows * 4)
            slot_h[(size_t)b * L.M * 4 + j - L.R * 4] = h;
    }
    __syncthreads();
    if (warp == 0) {
        uint32_t s[4] = {0, 0, 0, 0};
        for (int r = lane; r < rows; r += 32) {
            const uint32_t p = r < L.R ? 1u : st[L.pres_cols[r - L.R]];
            for (int w = 0; w < 4; ++w) s[w] += acc[r * 4 + w] * p;
        }
        const uint32_t t = warp_sum4(s, lane);
        const int w = lane >> 3;
        if ((lane & 7) == 0) {
            if (total) total[(size_t)b * 4 + w] = t;
            if (fp) {
                const uint32_t g = L.nglob ? acc[rows * 4 + w] : 0u;
                fp[(size_t)b * 4 + w] = mix32(mix32(t + g) + L.seeds[w]);
            }
        }
    }
}

// one warp per successor item; each group of eight lanes keeps a word
__global__ void __launch_bounds__(INCR_WARPS * 32) incremental_kernel(
        Layout L, const int* __restrict__ succ, int n,
        const int* __restrict__ ri, const int* __restrict__ ts, int nts,
        const int* __restrict__ pidx, const int* __restrict__ parent,
        const uint32_t* __restrict__ rep_h,
        const uint32_t* __restrict__ slot_h,
        const uint32_t* __restrict__ total, uint32_t* __restrict__ fp) {
    const int lane = threadIdx.x & 31;
    const int i = blockIdx.x * INCR_WARPS + (threadIdx.x >> 5);
    if (i >= n) return;
    const int p = pidx[i];
    const int r = ri[i];
    const uint32_t* st = (const uint32_t*)succ + (size_t)i * L.lanes;
    const uint32_t* pst = (const uint32_t*)parent + (size_t)p * L.lanes;
    const int w = lane >> 3;
    const uint32_t seed = L.seeds[w];
    uint32_t a[4] = {0, 0, 0, 0};
    row_terms(L.rep_cols + (size_t)r * L.nrep, L.nrep, L.k_rep, lane, st, r,
              a);
    uint32_t d = total[(size_t)p * 4 + w]
                 - rep_h[((size_t)p * L.R + r) * 4 + w]
                 + mix32(warp_sum4(a, lane) + seed);
    for (int t = 0; t < nts; ++t) {
        const int s = ts[(size_t)i * nts + t];
        if (s < 0) continue;
        const int sc = s < L.M ? s : L.M - 1;
        uint32_t h[4] = {0, 0, 0, 0};
        row_terms(L.slot_cols + (size_t)sc * L.nmsg, L.nmsg, L.k_msg, lane,
                  st, 0, h);
        const uint32_t pp = pst[L.pres_cols[sc]];
        const uint32_t sp = st[L.pres_cols[sc]];
        d -= slot_h[((size_t)p * L.M + sc) * 4 + w] * pp;
        d += mix32(warp_sum4(h, lane) + seed) * sp;
    }
    if (L.nglob) {
        uint32_t g[4] = {0, 0, 0, 0};
        row_terms(L.glob_cols, L.nglob, L.k_glob, lane, st, 0, g);
        d += mix32(warp_sum4(g, lane) + seed);
    }
    if ((lane & 7) == 0) fp[(size_t)i * 4 + w] = mix32(mix32(d) + seed);
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
// not null; total may be null when only fp is wanted.  A layout whose
// state row and row sums exceed a block's shared memory is refused
// (the attribute call's error is returned).
TPUVSR_EXPORT int tpuvsr_vsr_fp_parts(TPUVSR_LAYOUT_ARGS, const void* flat,
                                      int B, void* rep_h, void* slot_h,
                                      void* total, void* fp, void* stream) {
    if (B > 0) {
        const Layout L = TPUVSR_LAYOUT;
        const size_t smem = ((size_t)lanes + (size_t)(R + M + 1) * 4) * 4;
        if (smem > 48 * 1024) {
            const cudaError_t e = cudaFuncSetAttribute(
                parts_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                (int)smem);
            if (e != cudaSuccess) return (int)e;
        }
        KLAUNCH_SMEM(parts_kernel, B, PARTS_THREADS, smem,
                     (cudaStream_t)stream, L, (const int*)flat,
                     (uint32_t*)rep_h, (uint32_t*)slot_h, (uint32_t*)total,
                     (uint32_t*)fp);
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
        KLAUNCH(incremental_kernel, tpuvsr_blocks(n, INCR_WARPS),
                INCR_WARPS * 32, (cudaStream_t)stream, L, (const int*)succ,
                n, (const int*)ri, (const int*)ts, nts, (const int*)pidx,
                (const int*)parent, (const uint32_t*)rep_h,
                (const uint32_t*)slot_h, (const uint32_t*)total,
                (uint32_t*)fp);
    }
    return (int)cudaGetLastError();
}
