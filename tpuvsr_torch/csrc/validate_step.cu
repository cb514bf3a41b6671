// K16: the trace-validation step.
//
// Replaces one step of tpuvsr/validate/batch.py:260 chunk_fn, the
// vmapped one_trace (:216-258), for every trace of a round at step s,
// over the port's flat candidate rows (T traces, K candidate slots each,
// W int32 words a row, L lanes).  Three entry points:
//
//   count  one warp a candidate row: the lanes of the guard matrix that
//          are enabled in a live candidate of an active trace (s < tlen,
//          not diverged) and whose action matches the event's observed
//          action (-1 = any) -> cnt[row];
//   fill   the same mask, each row's items written at its offset (the
//          exclusive scan of cnt, taken by the wrapper) in lane order:
//          a work queue (row, action, lane parameter) in (trace,
//          candidate, lane) order, the order of the JAX first-occurrence
//          scan;
//   commit one block a trace, over the queue's successor rows, enabled
//          bits, error words and fingerprints: the observation filter
//          (the words the event pins), the err exclusion and flag, the
//          first occurrence of each fingerprint among the items that
//          pass (a hash table in device scratch, two slots an item,
//          keyed by fingerprint and holding the least queue index, so
//          no pair of items is compared), the ranks (a block scan in
//          queue order), and for a trace with no consistent successor
//          div_at = s, div_cand = its live candidates and div_en = the
//          OR of their guard rows (a diverging trace keeps its
//          candidates); then, one block a candidate row, the kept rows
//          scattered into the updated traces' candidate slots (the
//          rest zeroed) and alive.  The chunk's
//          reductions go to red[4] (int64, summed): traces that
//          overflowed K, traces that met a full message table, and at
//          the chunk's last step the traces still running past it and
//          those diverged.
//
// What bounds it on the H100: count and fill read the [T*K, L] guard
// matrix once (byte-sized flags; a warp reads a row's lanes 32 at a
// time); commit reads each successor row's pinned words, its
// fingerprint and the kept rows (W words each) and writes the trace's
// K candidate rows.  Bytes bound all three; the hash probes and the
// block scan make small rounds latency-bound.
//
// Design.  The JAX step expands every candidate's L lanes and compares
// every pair of the K*L successors; here only the enabled, matching
// lanes are expanded (by the model's kernels between select and commit)
// and deduplicated by hash.  Queue index order is the JAX (candidate,
// lane) order, so the least index of a fingerprint is its first
// occurrence and the scan's rank its JAX rank.
#include "common.cuh"

#include <climits>

namespace {

constexpr int SEL_THREADS = 256;         // 8 rows a block
constexpr int THREADS = 256;             // commit: one block a trace
constexpr int WARPS = THREADS / 32;
constexpr int EMPTY = INT_MAX;

__device__ __forceinline__ bool row_active(const uint8_t* alive,
                                           const int* div_at,
                                           const int* tlen, int r, int t,
                                           int s) {
    return alive[r] && s < tlen[t] && div_at[t] < 0;
}

__global__ void count_kernel(const uint8_t* __restrict__ en,
                             const uint8_t* __restrict__ alive,
                             const int* __restrict__ div_at,
                             const int* __restrict__ tlen,
                             const int* __restrict__ aid,
                             const int* __restrict__ lane_aid, int R, int K,
                             int L, int s, int* __restrict__ cnt) {
    const int r = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int ln = threadIdx.x & 31;
    if (r >= R) return;                  // whole warps leave together
    const int t = r / K;
    int c = 0;
    if (row_active(alive, div_at, tlen, r, t, s)) {
        const int a = aid[t];
        for (int l0 = 0; l0 < L; l0 += 32) {
            const int l = l0 + ln;
            const bool m = l < L && en[(size_t)r * L + l]
                           && (a < 0 || lane_aid[l] == a);
            c += __popc(__ballot_sync(0xffffffffu, m));
        }
    }
    if (ln == 0) cnt[r] = c;
}

__global__ void fill_kernel(const uint8_t* __restrict__ en,
                            const uint8_t* __restrict__ alive,
                            const int* __restrict__ div_at,
                            const int* __restrict__ tlen,
                            const int* __restrict__ aid,
                            const int* __restrict__ lane_aid, int R, int K,
                            int L, int s,
                            const int* __restrict__ lane_prm,
                            const long long* __restrict__ roff,
                            int* __restrict__ q_pidx,
                            int* __restrict__ q_aid,
                            int* __restrict__ q_lane) {
    const int r = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int ln = threadIdx.x & 31;
    if (r >= R) return;
    const int t = r / K;
    if (!row_active(alive, div_at, tlen, r, t, s)) return;
    const int a = aid[t];
    long long base = roff[r];
    for (int l0 = 0; l0 < L; l0 += 32) {
        const int l = l0 + ln;
        const bool m = l < L && en[(size_t)r * L + l]
                       && (a < 0 || lane_aid[l] == a);
        const unsigned b = __ballot_sync(0xffffffffu, m);
        if (m) {
            const long long pos = base + __popc(b & ((1u << ln) - 1u));
            q_pidx[pos] = r;
            q_aid[pos] = lane_aid[l];
            q_lane[pos] = lane_prm[l];
        }
        base += __popc(b);
    }
}

__device__ __forceinline__ bool same_fp(const int* fp, long long i,
                                        long long j) {
    const int4 a = reinterpret_cast<const int4*>(fp)[i];
    const int4 b = reinterpret_cast<const int4*>(fp)[j];
    return a.x == b.x && a.y == b.y && a.z == b.z && a.w == b.w;
}

__device__ __forceinline__ long long home(const int* fp, long long i,
                                          long long M) {
    const int4 a = reinterpret_cast<const int4*>(fp)[i];
    return (long long)(tpuvsr_slot_hash((uint32_t)a.x, (uint32_t)a.y,
                                        (uint32_t)a.z, (uint32_t)a.w)
                       % (uint32_t)M);
}

// block-wide exclusive scan of one flag a thread; *total gets the sum
__device__ __forceinline__ int block_scan(int x, int* warp_sums,
                                          int* total) {
    const int ln = threadIdx.x & 31, w = threadIdx.x >> 5;
    int v = x;
    for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, v, off);
        if (ln >= off) v += y;
    }
    if (ln == 31) warp_sums[w] = v;
    __syncthreads();
    if (w == 0) {
        int u = ln < WARPS ? warp_sums[ln] : 0;
        for (int off = 1; off < 32; off <<= 1) {
            const int y = __shfl_up_sync(0xffffffffu, u, off);
            if (ln >= off) u += y;
        }
        if (ln < WARPS) warp_sums[ln] = u;      // inclusive
        if (ln == WARPS - 1) *total = u;
    }
    __syncthreads();
    const int before = w ? warp_sums[w - 1] : 0;
    const int excl = before + v - x;
    __syncthreads();                             // warp_sums reused
    return excl;
}

__global__ void commit_kernel(int T, int K, int W, int L, int s, int last,
                              int step_end,
                              const long long* __restrict__ roff,
                              const int* __restrict__ succ,
                              const uint8_t* __restrict__ en2,
                              const int* __restrict__ err,
                              const int* __restrict__ fp,
                              const uint8_t* __restrict__ en,
                              const int* __restrict__ o_lo,
                              const int* __restrict__ o_hi,
                              const int* __restrict__ obs_w,
                              const int* __restrict__ obs_v,
                              int* __restrict__ cands,
                              uint8_t* __restrict__ alive,
                              int* __restrict__ div_at,
                              uint8_t* __restrict__ div_en,
                              int* __restrict__ div_cand,
                              const int* __restrict__ tlen,
                              int* __restrict__ table,
                              uint8_t* __restrict__ flag,
                              int* __restrict__ sel,
                              int* __restrict__ kept,
                              long long* __restrict__ red) {
    __shared__ int warp_sums[WARPS];
    __shared__ int s_total, s_errhit, s_alive;
    const int t = blockIdx.x, tid = threadIdx.x;
    const long long row0 = (long long)t * K;
    const bool act = s < tlen[t] && div_at[t] < 0;
    if (tid == 0) kept[t] = -1;          // -1: the trace's rows stay
    if (act) {
        const long long qs = roff[row0], qe = roff[row0 + K];
        const long long n = qe - qs, M = 2 * n;
        int* tab = table + 2 * qs;
        if (tid == 0) {
            s_errhit = 0;
            s_alive = 0;
        }
        for (long long k = tid; k < M; k += THREADS) tab[k] = EMPTY;
        __syncthreads();
        int na = 0;
        for (int c = tid; c < K; c += THREADS) na += alive[row0 + c];
        if (na) atomicAdd(&s_alive, na);
        // the observation filter, the err exclusion, the insert
        const int lo = o_lo[t], hi = o_hi[t];
        for (long long i = qs + tid; i < qe; i += THREADS) {
            bool ok = en2[i];
            for (int j = lo; ok && j < hi; ++j)
                ok = succ[i * W + obs_w[j]] == obs_v[j];
            const bool e = err[i] != 0;
            if (ok && e) s_errhit = 1;
            const bool pass = ok && !e;
            flag[i] = pass;
            if (!pass) continue;
            for (long long p = home(fp, i, M);; p = p + 1 == M ? 0 : p + 1) {
                const int old = atomicCAS(tab + p, EMPTY, (int)(i - qs));
                if (old == EMPTY) break;
                if (same_fp(fp, qs + old, i)) {
                    atomicMin(tab + p, (int)(i - qs));
                    break;
                }
            }
        }
        __syncthreads();
        // the first occurrence of each fingerprint: its slot holds it
        for (long long i = qs + tid; i < qe; i += THREADS) {
            if (!flag[i]) continue;
            for (long long p = home(fp, i, M);; p = p + 1 == M ? 0 : p + 1) {
                const int v = tab[p];
                if (same_fp(fp, qs + v, i)) {
                    if (qs + v == i) flag[i] = 2;
                    break;
                }
            }
        }
        __syncthreads();
        // ranks in queue order; the kept items' queue indices by rank
        int base = 0;
        for (long long c0 = qs; c0 < qe; c0 += THREADS) {
            const long long i = c0 + tid;
            const int u = i < qe && flag[i] == 2;
            const int pos = base + block_scan(u, warp_sums, &s_total);
            if (u && pos < K) sel[row0 + pos] = (int)i;
            base += s_total;
            __syncthreads();
        }
        const int n_new = base;
        if (n_new == 0) {
            // divergence: the candidates stay; record the enabled set
            for (int l = tid; l < L; l += THREADS) {
                uint8_t any = 0;
                for (int c = 0; c < K && !any; ++c)
                    any = alive[row0 + c] && en[(row0 + c) * L + l];
                div_en[(long long)t * L + l] = any;
            }
            if (tid == 0) {
                div_at[t] = s;
                div_cand[t] = s_alive;
            }
        } else if (tid == 0) {
            kept[t] = n_new < K ? n_new : K;
        }
        if (tid == 0) {
            if (n_new > K)
                atomicAdd((unsigned long long*)&red[0], 1ull);
            if (s_errhit)
                atomicAdd((unsigned long long*)&red[1], 1ull);
        }
    }
    if (last && tid == 0) {
        const int da = div_at[t];
        if (da < 0 && tlen[t] > step_end)
            atomicAdd((unsigned long long*)&red[2], 1ull);
        if (da >= 0) atomicAdd((unsigned long long*)&red[3], 1ull);
    }
}

// the updated traces' candidate rows: rank c < kept[t] takes the queue
// item sel[row], the rest are zero and dead
__global__ void scatter_kernel(int K, int W, const int* __restrict__ kept,
                               const int* __restrict__ sel,
                               const int* __restrict__ succ,
                               int* __restrict__ cands,
                               uint8_t* __restrict__ alive) {
    const long long r = blockIdx.x;
    const int t = (int)(r / K), c = (int)(r - (long long)t * K);
    const int k = kept[t];
    if (k < 0) return;
    int* dst = cands + r * W;
    if (c < k) {
        const int* src = succ + (long long)sel[r] * W;
        for (int w = threadIdx.x; w < W; w += THREADS) dst[w] = src[w];
    } else {
        for (int w = threadIdx.x; w < W; w += THREADS) dst[w] = 0;
    }
    if (threadIdx.x == 0) alive[r] = c < k;
}

}  // namespace

// en: [R, L] uint8 guard matrix (R = T*K rows); alive: [R] uint8;
// div_at, tlen, aid: [T] int32; lane_aid: [L] int32; cnt: [R] int32.
TPUVSR_EXPORT int tpuvsr_vstep_count(const void* en, const void* alive,
                                     const void* div_at, const void* tlen,
                                     const void* aid, const void* lane_aid,
                                     int R, int K, int L, int s, void* cnt,
                                     void* stream) {
    if (R > 0)
        KLAUNCH(count_kernel, tpuvsr_blocks((long long)R * 32, SEL_THREADS),
                SEL_THREADS, (cudaStream_t)stream, (const uint8_t*)en,
                (const uint8_t*)alive, (const int*)div_at, (const int*)tlen,
                (const int*)aid, (const int*)lane_aid, R, K, L, s,
                (int*)cnt);
    return (int)cudaGetLastError();
}

// as count, then lane_prm: [L] int32; roff: [R+1] int64 (row r's items
// start at roff[r]); q_pidx, q_aid, q_lane: [Q] int32 queue columns.
TPUVSR_EXPORT int tpuvsr_vstep_fill(const void* en, const void* alive,
                                    const void* div_at, const void* tlen,
                                    const void* aid, const void* lane_aid,
                                    int R, int K, int L, int s,
                                    const void* lane_prm, const void* roff,
                                    void* q_pidx, void* q_aid, void* q_lane,
                                    void* stream) {
    if (R > 0)
        KLAUNCH(fill_kernel, tpuvsr_blocks((long long)R * 32, SEL_THREADS),
                SEL_THREADS, (cudaStream_t)stream, (const uint8_t*)en,
                (const uint8_t*)alive, (const int*)div_at, (const int*)tlen,
                (const int*)aid, (const int*)lane_aid, R, K, L, s,
                (const int*)lane_prm, (const long long*)roff, (int*)q_pidx,
                (int*)q_aid, (int*)q_lane);
    return (int)cudaGetLastError();
}

// T traces of K slots, W words a row, L lanes, step s; last != 0 adds
// the remaining (tlen > step_end) and diverged counts.  roff: [T*K+1]
// int64; succ: [Q, W] int32; en2: [Q] uint8; err: [Q] int32; fp: [Q, 4]
// int32 (16-byte aligned rows); en: [T*K, L] uint8; o_lo, o_hi: [T]
// int32 into obs_w, obs_v (int32 word, value); cands: [T*K, W] int32,
// alive: [T*K] uint8, div_at: [T] int32, div_en: [T, L] uint8,
// div_cand: [T] int32 (updated in place); tlen: [T] int32; table: [2Q]
// int32, flag: [Q] uint8, sel: [T*K] int32, kept: [T] int32 scratch;
// red: [4] int64.  Two launches: the per-trace commit, then the scatter
// of the kept rows (one block a candidate row).
TPUVSR_EXPORT int tpuvsr_vstep_commit(
        int T, int K, int W, int L, int s, int last, int step_end,
        const void* roff, const void* succ, const void* en2, const void* err,
        const void* fp, const void* en, const void* o_lo, const void* o_hi,
        const void* obs_w, const void* obs_v, void* cands, void* alive,
        void* div_at, void* div_en, void* div_cand, const void* tlen,
        void* table, void* flag, void* sel, void* kept, void* red,
        void* stream) {
    if (T > 0) {
        KLAUNCH(commit_kernel, T, THREADS, (cudaStream_t)stream, T, K, W, L,
                s, last, step_end, (const long long*)roff, (const int*)succ,
                (const uint8_t*)en2, (const int*)err, (const int*)fp,
                (const uint8_t*)en, (const int*)o_lo, (const int*)o_hi,
                (const int*)obs_w, (const int*)obs_v, (int*)cands,
                (uint8_t*)alive, (int*)div_at, (uint8_t*)div_en,
                (int*)div_cand, (const int*)tlen, (int*)table,
                (uint8_t*)flag, (int*)sel, (int*)kept, (long long*)red);
        const cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
        KLAUNCH(scatter_kernel, (unsigned int)((long long)T * K), THREADS,
                (cudaStream_t)stream, K, W, (const int*)kept,
                (const int*)sel, (const int*)succ, (int*)cands,
                (uint8_t*)alive);
    }
    return (int)cudaGetLastError();
}
