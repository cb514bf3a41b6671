// K17: the ample-set step of the fused commit's partial-order reduction,
// three entries.
//
// Replaces the POR block of tpuvsr/engine/device_bfs.py:
// _fused_body_factory: the ample candidate of each frontier row
// (:783-799: conflict = en_act @ ~amat.T > 0, cand = en_act & ~conflict,
// aid_star = argmax(cand)), the C3 probe of the ample successors' level
// markers in the pre-insert FPSet and the keep mask (:909-931), and the
// kept/amp counters (:989-1013).  The level markers themselves are
// K11's store of pdepth + 1 on the fresh lanes after K1 (:1014-1019),
// and K8 folds the counters into the carry.
//
//   cand    one thread per tile row: the row's enabled-action bitmask
//           (n_act <= 64, one uint64) from the guard-matrix row the
//           tile already has (valid rows only); an action a is a
//           candidate when it is enabled and no enabled action lies in
//           its conflict mask (the host turns PORFilter.amat once into
//           n_act masks, ~amat rows as uint64, held in shared memory;
//           an ineligible action's row is all ones, so it vetoes
//           itself).  Writes has_cand, aid_star (the lowest candidate,
//           __ffsll; 0 when there is none, as argmax of an all-False
//           row gives), n_en (the popcount), clears amp_bad, and zeroes
//           the keep step's counters.
//   probe   one thread per queue item: is_amp = enabled & has_cand[p] &
//           aid == aid_star[p]; such an item's fingerprint is probed
//           through the common.cuh chain in the PRE-insert slots (the
//           launch precedes K1's on the stream), and a stored marker g
//           with 0 <= g <= pdepth (an old state: a potential cycle)
//           sets amp_bad[p] by atomicOr.  pdepth is read on the device
//           (the carry's depth word, or a one-word tensor in run()).
//   keep    one thread per queue item and per tile row: take = has_cand
//           & ~amp_bad; keep = enabled & (~take[p] | aid == aid_star[p]);
//           kept[aid] += keep; mark = pdepth + 1 (the values K11 stores
//           on the fresh lanes); amp += take & n_en > 1 per row.
//
// What bounds it on the H100: latency.  cand reads T guard rows of
// n_lanes bytes (a few KB a tile), probe one 16-byte fingerprint and one
// 20-byte slot row per probe step of the ample items only, keep a few
// bytes per queue item.  The least time is those bytes over the memory
// rate; a launch costs more than that at the tile sizes the engines
// use.
//
// Design.  One thread per row or item, no shared state beyond the
// conflict masks; the counters are global atomics (a few hundred items
// a tile).  Its plain PyTorch versions are engine/tile.py
// por_cand_plain, por_probe_plain and por_keep_plain (JAX's int32
// matmul, lookup_gids_plain and a scatter amax).
#include "common.cuh"

namespace {

constexpr int MAX_ACTIONS = 64;
constexpr int THREADS = 256;

__global__ void cand_kernel(const uint8_t* __restrict__ en,
                            const uint8_t* __restrict__ valid, int T,
                            int n_lanes, const int* __restrict__ segs,
                            int n_act,
                            const unsigned long long* __restrict__ conf,
                            uint8_t* __restrict__ has_cand,
                            int* __restrict__ aid_star,
                            int* __restrict__ n_en,
                            int* __restrict__ amp_bad,
                            long long* __restrict__ kept,
                            long long* __restrict__ amp) {
    __shared__ unsigned long long s_conf[MAX_ACTIONS];
    __shared__ int s_lo[MAX_ACTIONS], s_len[MAX_ACTIONS];
    for (int a = threadIdx.x; a < n_act; a += blockDim.x) {
        s_conf[a] = conf[a];
        s_lo[a] = segs[4 * a];
        s_len[a] = segs[4 * a + 1];
    }
    __syncthreads();
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r < n_act) kept[r] = 0;
    if (r == 0) *amp = 0;
    if (r >= T) return;
    unsigned long long m = 0;
    if (valid[r]) {
        const uint8_t* row = en + (size_t)r * n_lanes;
        for (int a = 0; a < n_act; ++a) {
            const int lo = s_lo[a], hi = s_lo[a] + s_len[a];
            for (int l = lo; l < hi; ++l) {
                if (row[l]) {
                    m |= 1ull << a;
                    break;
                }
            }
        }
    }
    unsigned long long cand = 0;
    for (int a = 0; a < n_act; ++a)
        if (((m >> a) & 1ull) && !(m & s_conf[a])) cand |= 1ull << a;
    has_cand[r] = cand != 0;
    aid_star[r] = cand ? __ffsll((long long)cand) - 1 : 0;
    n_en[r] = __popcll(m);
    amp_bad[r] = 0;
}

__global__ void probe_kernel(const uint32_t* __restrict__ slots,
                             uint32_t capm, const int* __restrict__ gids,
                             const uint32_t* __restrict__ fps,
                             const uint8_t* __restrict__ en2,
                             const uint8_t* __restrict__ q_ok,
                             const int* __restrict__ q_pidx,
                             const int* __restrict__ q_aid, int total,
                             const uint8_t* __restrict__ has_cand,
                             const int* __restrict__ aid_star,
                             const long long* __restrict__ pdepth,
                             int* __restrict__ amp_bad) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= total || !(en2[i] && q_ok[i])) return;
    const int p = q_pidx[i];
    if (!has_cand[p] || q_aid[i] != aid_star[p]) return;
    uint32_t k[4];
    tpuvsr_keyed(fps, i, k);
    const long long idx = tpuvsr_probe(slots, capm, k);
    if (idx < 0) return;
    const long long g = gids[idx];
    if (g >= 0 && g <= *pdepth) atomicOr(&amp_bad[p], 1);
}

__global__ void keep_kernel(const uint8_t* __restrict__ en2,
                            const uint8_t* __restrict__ q_ok,
                            const int* __restrict__ q_pidx,
                            const int* __restrict__ q_aid, int total,
                            const uint8_t* __restrict__ has_cand,
                            const int* __restrict__ aid_star,
                            const int* __restrict__ n_en,
                            const int* __restrict__ amp_bad, int T,
                            const long long* __restrict__ pdepth,
                            uint8_t* __restrict__ keep,
                            int* __restrict__ mark,
                            long long* __restrict__ kept,
                            long long* __restrict__ amp) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < total) {
        const int p = q_pidx[i];
        const bool take = has_cand[p] && !amp_bad[p];
        const bool k = en2[i] && q_ok[i] &&
                       (!take || q_aid[i] == aid_star[p]);
        keep[i] = k;
        mark[i] = (int)(*pdepth + 1);
        if (k) atomicAdd((unsigned long long*)&kept[q_aid[i]], 1ull);
    }
    if (i < T && has_cand[i] && !amp_bad[i] && n_en[i] > 1)
        atomicAdd((unsigned long long*)amp, 1ull);
}

}  // namespace

// en: [T, n_lanes] uint8 guard matrix; valid: [T] uint8; segs: [n_act,
// 4] int32 (first lane, lane count, cap, queue offset); conf: [n_act]
// uint64 conflict masks; has_cand: [T] uint8; aid_star, n_en, amp_bad:
// [T] int32; kept: [n_act] int64; amp: one int64.
TPUVSR_EXPORT int tpuvsr_por_cand(const void* en, const void* valid, int T,
                                  int n_lanes, const void* segs, int n_act,
                                  const void* conf, void* has_cand,
                                  void* aid_star, void* n_en, void* amp_bad,
                                  void* kept, void* amp, void* stream) {
    if (n_act > MAX_ACTIONS) return (int)cudaErrorInvalidValue;
    const int n = T > n_act ? T : n_act;
    KLAUNCH(cand_kernel, tpuvsr_blocks(n, THREADS), THREADS,
            (cudaStream_t)stream, (const uint8_t*)en,
            (const uint8_t*)valid, T, n_lanes, (const int*)segs, n_act,
            (const unsigned long long*)conf, (uint8_t*)has_cand,
            (int*)aid_star, (int*)n_en, (int*)amp_bad, (long long*)kept,
            (long long*)amp);
    return (int)cudaGetLastError();
}

// slots: [cap, 5] uint32 (cap a power of two); gids: [cap] int32 level
// markers; fps: [total, 4] uint32; en2, q_ok: [total] uint8; q_pidx,
// q_aid: [total] int32; pdepth: one int64.
TPUVSR_EXPORT int tpuvsr_por_probe(const void* slots, long long cap,
                                   const void* gids, const void* fps,
                                   const void* en2, const void* q_ok,
                                   const void* q_pidx, const void* q_aid,
                                   int total, const void* has_cand,
                                   const void* aid_star, const void* pdepth,
                                   void* amp_bad, void* stream) {
    if (total > 0) {
        KLAUNCH(probe_kernel, tpuvsr_blocks(total, THREADS), THREADS,
                (cudaStream_t)stream, (const uint32_t*)slots,
                (uint32_t)(cap - 1), (const int*)gids, (const uint32_t*)fps,
                (const uint8_t*)en2, (const uint8_t*)q_ok,
                (const int*)q_pidx, (const int*)q_aid, total,
                (const uint8_t*)has_cand, (const int*)aid_star,
                (const long long*)pdepth, (int*)amp_bad);
    }
    return (int)cudaGetLastError();
}

// keep: [total] uint8 out; mark: [total] int32 out; the rest as above.
TPUVSR_EXPORT int tpuvsr_por_keep(const void* en2, const void* q_ok,
                                  const void* q_pidx, const void* q_aid,
                                  int total, const void* has_cand,
                                  const void* aid_star, const void* n_en,
                                  const void* amp_bad, int T,
                                  const void* pdepth, void* keep, void* mark,
                                  void* kept, void* amp, void* stream) {
    const int n = total > T ? total : T;
    if (n > 0) {
        KLAUNCH(keep_kernel, tpuvsr_blocks(n, THREADS), THREADS,
                (cudaStream_t)stream, (const uint8_t*)en2,
                (const uint8_t*)q_ok, (const int*)q_pidx,
                (const int*)q_aid, total, (const uint8_t*)has_cand,
                (const int*)aid_star, (const int*)n_en,
                (const int*)amp_bad, T, (const long long*)pdepth,
                (uint8_t*)keep, (int*)mark, (long long*)kept,
                (long long*)amp);
    }
    return (int)cudaGetLastError();
}
