// K8: the fused tile's commit and the level step, three entries.
//
// Replaces the single-commit stage of
// tpuvsr/engine/device_bfs.py:_fused_body_factory and the level tail of
// _make_multilevel's obody, as DeviceBFS.run_fused runs them:
//   commit_prefix  the headroom gate (:806-820), the per-action
//                  violation/bag/slot flags, the first violating item
//                  and the committed-action prefix (:874-931): the
//                  commit mask the dedup (K2) and the insert (K1) take;
//   commit_finish  after the insert: dest = nn + cumsum(fresh) - 1, the
//                  scatter of the trace pointers (:942-956), the commit
//                  flag, the reason by its priority and deadlock
//                  (:957-985), and the carry's counters;
//   level_step     when the level's last tile has run (:1231-1300): the
//                  level's trace pointers appended at level_base +
//                  n_front, its size recorded, its rows made the next
//                  frontier (a row copy), and the JAX ocond terms
//                  (:1182) turned into a stop flag.
// All three read the carry (enum Carry, engine/tile.py CARRY_FIELDS)
// and, once its halt word is set, commit nothing: the prefix masks
// every item out, the finish writes dest = -1 and counts an idle
// replay, the level step does nothing.
//
// What bounds it on the H100: the prefix and the finish touch a few
// bytes per queue item (a few thousand items a tile) and are
// latency-bound; the level step moves the level's packed rows (476
// bytes a row, 143 MB at the defect config's depth 10) and its
// pointers once a level, bound by bytes.
//
// Design.  The prefix and the finish are one block each (the queue is
// small): per-action flags by shared-memory atomics, the fresh ranks by
// a chunked Hillis-Steele scan, thread 0 writes the verdict and steps
// the carry after the block has read it.  The level step is a
// grid-stride copy whose blocks only read the carry, then a one-thread
// kernel that updates it.
#include "common.cuh"

namespace {

enum Carry {
    C_T, C_REASON, C_HALT, C_STOP, C_NN, C_N_FRONT, C_DEPTH, C_LEVEL_BASE,
    C_FP_COUNT, C_GEN, C_TILES, C_LVL_CUR, C_VIOL_ROW, C_VIOL_AID,
    C_VIOL_LANE, C_DEAD, C_GROW_AID, C_IDLE, C_WANT_DEADLOCK, C_MAX_DEPTH,
    C_MAX_STATES, C_MAX_LVLS, C_NEXT_CAP, C_TP_CAP, C_NEED
};

enum Tile {
    F_FIRST_BAD, F_ROOM, F_VIOL, F_SLOT, F_BAG, F_OVF, F_GROW_AID, F_VROW,
    F_VAID, F_VLANE, F_AFLAGS
};

enum Reason {
    RUNNING = 0, R_VIOLATION = 2, R_BAG_GROW = 3, R_FPSET_GROW = 4,
    R_NEXT_GROW = 5, R_SLOT_ERR = 6, R_DEADLOCK = 7, R_EXPAND_GROW = 8
};

constexpr int ERR_BAG_OVERFLOW = 1;
constexpr int MAX_ACTIONS = 64;
constexpr int THREADS = 512;
constexpr int INT_BIG = 0x7FFFFFFF;

__global__ void prefix_kernel(const long long* __restrict__ carry,
                              const uint8_t* __restrict__ en2,
                              const uint8_t* __restrict__ iok,
                              const int* __restrict__ err,
                              const int* __restrict__ q_pidx,
                              const int* __restrict__ q_lane,
                              const int* __restrict__ q_aid,
                              const uint8_t* __restrict__ q_ok,
                              const uint8_t* __restrict__ ovf, int total,
                              int n_act, uint8_t* __restrict__ mcommit,
                              long long* __restrict__ tile) {
    __shared__ int flags[MAX_ACTIONS];
    __shared__ int vmin[MAX_ACTIONS];
    __shared__ int s_first_bad, s_room;
    const int tid = threadIdx.x;
    for (int a = tid; a < n_act; a += THREADS) {
        flags[a] = 0;
        vmin[a] = INT_BIG;
    }
    __syncthreads();
    for (int i = tid; i < total; i += THREADS) {
        const bool ok = en2[i] && q_ok[i];
        const int e = ok ? err[i] : 0;
        const bool v = ok && !iok[i] && e == 0;
        const int f = (v ? 1 : 0) | ((e & ERR_BAG_OVERFLOW) ? 2 : 0) |
                      ((e & ~ERR_BAG_OVERFLOW) ? 4 : 0);
        if (f) atomicOr(&flags[q_aid[i]], f);
        if (v) atomicMin(&vmin[q_aid[i]], i);
    }
    __syncthreads();
    if (tid == 0) {
        int first_bad = n_act, va = -1, grow = -1;
        int any_v = 0, any_s = 0, any_b = 0, any_o = 0;
        for (int a = 0; a < n_act; ++a) {
            const int f = flags[a];
            if ((f || ovf[a]) && first_bad == n_act) first_bad = a;
            if ((f & 1) && va < 0) va = a;
            if (ovf[a] && grow < 0) grow = a;
            any_v |= f & 1;
            any_b |= (f >> 1) & 1;
            any_s |= (f >> 2) & 1;
            any_o |= ovf[a] != 0;
            tile[F_AFLAGS + a] = f;
        }
        const int room = carry[C_NEXT_CAP] - carry[C_NN] >= total;
        tile[F_FIRST_BAD] = first_bad;
        tile[F_ROOM] = room;
        tile[F_VIOL] = any_v;
        tile[F_SLOT] = any_s;
        tile[F_BAG] = any_b;
        tile[F_OVF] = any_o;
        tile[F_GROW_AID] = grow;
        const int vi = va >= 0 ? vmin[va] : -1;
        tile[F_VROW] = vi >= 0 ? q_pidx[vi] : -1;
        tile[F_VAID] = va;
        tile[F_VLANE] = vi >= 0 ? q_lane[vi] : -1;
        s_first_bad = first_bad;
        s_room = room && carry[C_HALT] == 0;
    }
    __syncthreads();
    for (int i = tid; i < total; i += THREADS)
        mcommit[i] = s_room && en2[i] && q_ok[i] && q_aid[i] < s_first_bad;
}

__global__ void finish_kernel(long long* __restrict__ carry,
                              const long long* __restrict__ tile,
                              const uint8_t* __restrict__ fresh,
                              const int* __restrict__ ovf_i,
                              const int* __restrict__ q_pidx,
                              const int* __restrict__ q_lane,
                              const int* __restrict__ q_aid, int total,
                              const long long* __restrict__ cnts, int n_act,
                              const uint8_t* __restrict__ en_any,
                              const uint8_t* __restrict__ valid, int T,
                              int* __restrict__ par, int* __restrict__ act,
                              int* __restrict__ prm,
                              int* __restrict__ dest) {
    __shared__ int scan[THREADS];
    __shared__ int base, dmin;
    const int tid = threadIdx.x;
    const long long halted = carry[C_HALT];
    const long long nn = carry[C_NN], t = carry[C_T];
    __syncthreads();
    if (halted) {
        for (int i = tid; i < total; i += THREADS) dest[i] = -1;
        if (tid == 0) carry[C_IDLE] += 1;
        return;
    }
    if (tid == 0) {
        base = 0;
        dmin = INT_BIG;
    }
    __syncthreads();
    const int row0 = (int)(t * T);
    for (int c0 = 0; c0 < total; c0 += THREADS) {
        const int i = c0 + tid;
        const int x = i < total ? fresh[i] != 0 : 0;
        scan[tid] = x;
        __syncthreads();
        for (int off = 1; off < THREADS; off <<= 1) {
            const int v = tid >= off ? scan[tid - off] : 0;
            __syncthreads();
            scan[tid] += v;
            __syncthreads();
        }
        if (i < total) {
            const long long d = nn + base + scan[tid] - x;
            dest[i] = x ? (int)d : -1;
            if (x) {
                par[d] = row0 + q_pidx[i];
                act[d] = q_aid[i];
                prm[d] = q_lane[i];
            }
        }
        __syncthreads();
        if (tid == THREADS - 1) base += scan[THREADS - 1];
        __syncthreads();
    }
    for (int r = tid; r < T; r += THREADS)
        if (valid[r] && !en_any[r]) atomicMin(&dmin, r);
    __syncthreads();
    if (tid != 0) return;
    const long long nfi = base;
    const bool room = tile[F_ROOM] != 0, oi = *ovf_i != 0;
    const bool commit = room && tile[F_FIRST_BAD] >= n_act && !oi;
    int reason = RUNNING;
    if (!room) reason = R_NEXT_GROW;
    else if (tile[F_VIOL]) reason = R_VIOLATION;
    else if (tile[F_SLOT]) reason = R_SLOT_ERR;
    else if (tile[F_BAG]) reason = R_BAG_GROW;
    else if (tile[F_OVF]) reason = R_EXPAND_GROW;
    else if (oi) reason = R_FPSET_GROW;
    if (reason == RUNNING && carry[C_WANT_DEADLOCK] && commit &&
            dmin < T) {
        reason = R_DEADLOCK;
        carry[C_DEAD] = t * T + dmin;
    }
    if (reason == R_VIOLATION) {
        carry[C_VIOL_ROW] = t * T + tile[F_VROW];
        carry[C_VIOL_AID] = tile[F_VAID];
        carry[C_VIOL_LANE] = tile[F_VLANE];
    }
    if (tile[F_OVF]) carry[C_GROW_AID] = tile[F_GROW_AID];
    carry[C_NN] = nn + nfi;
    carry[C_FP_COUNT] += nfi;
    if (commit) {
        long long sum = 0;
        for (int a = 0; a < n_act; ++a) {
            sum += cnts[a];
            carry[C_NEED + n_act + a] += cnts[a];
        }
        carry[C_GEN] += sum;
        if (reason == RUNNING) {
            carry[C_T] = t + 1;
            carry[C_TILES] += 1;
        }
    }
    carry[C_REASON] = reason;
    if (reason != RUNNING) carry[C_HALT] = 1;
}

// true when the level's tile loop is done and nothing stopped it
__device__ __forceinline__ bool level_done(const long long* carry, int T) {
    const long long nf = carry[C_N_FRONT];
    return !carry[C_HALT] && carry[C_T] >= (nf + T - 1) / T;
}

__global__ void level_copy_kernel(const long long* __restrict__ carry,
                                  const int* __restrict__ nb,
                                  const int* __restrict__ par,
                                  const int* __restrict__ act,
                                  const int* __restrict__ prm,
                                  int* __restrict__ front, int words,
                                  int* __restrict__ tpp,
                                  int* __restrict__ tpa,
                                  int* __restrict__ tpm, int T) {
    if (!level_done(carry, T)) return;
    const long long n = carry[C_NN], lb = carry[C_LEVEL_BASE];
    const long long at = lb + carry[C_N_FRONT];
    const long long stride = (long long)gridDim.x * blockDim.x;
    const long long i0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    for (long long i = i0; i < n; i += stride) {
        tpp[at + i] = (int)(par[i] + lb);
        tpa[at + i] = act[i];
        tpm[at + i] = prm[i];
    }
    const long long n_words = n * words;
    for (long long i = i0; i < n_words; i += stride) front[i] = nb[i];
}

__global__ void level_update_kernel(long long* __restrict__ carry,
                                    long long* __restrict__ lvl_buf,
                                    int lvl_cap, int T) {
    if (!level_done(carry, T)) return;
    const long long n = carry[C_NN], nf = carry[C_N_FRONT];
    if (n > 0) {
        if (carry[C_LVL_CUR] < lvl_cap) lvl_buf[carry[C_LVL_CUR]] = n;
        carry[C_LVL_CUR] += 1;
    }
    carry[C_LEVEL_BASE] += nf;
    carry[C_N_FRONT] = n;
    carry[C_T] = 0;
    carry[C_NN] = 0;
    carry[C_DEPTH] += 1;
    if (n == 0 || carry[C_DEPTH] >= carry[C_MAX_DEPTH] ||
            carry[C_FP_COUNT] >= carry[C_MAX_STATES] ||
            carry[C_LVL_CUR] >= carry[C_MAX_LVLS] ||
            carry[C_LEVEL_BASE] + n + carry[C_NEXT_CAP] > carry[C_TP_CAP]) {
        carry[C_STOP] = 1;
        carry[C_HALT] = 1;
    }
}

}  // namespace

// carry: int64 words (enum Carry); en2, iok, q_ok, ovf, mcommit: uint8;
// err, q_*: int32 [total]; tile: int64 [F_AFLAGS + n_act].
TPUVSR_EXPORT int tpuvsr_commit_prefix(const void* carry, const void* en2,
                                       const void* iok, const void* err,
                                       const void* q_pidx,
                                       const void* q_lane,
                                       const void* q_aid, const void* q_ok,
                                       const void* ovf, int total, int n_act,
                                       void* mcommit, void* tile,
                                       void* stream) {
    if (n_act > MAX_ACTIONS) return (int)cudaErrorInvalidValue;
    KLAUNCH(prefix_kernel, 1, THREADS, (cudaStream_t)stream,
            (const long long*)carry, (const uint8_t*)en2,
            (const uint8_t*)iok, (const int*)err, (const int*)q_pidx,
            (const int*)q_lane, (const int*)q_aid, (const uint8_t*)q_ok,
            (const uint8_t*)ovf, total, n_act, (uint8_t*)mcommit,
            (long long*)tile);
    return (int)cudaGetLastError();
}

// fresh: [total] uint8 (K1); ovf_i: one int32 (K1's overflow); cnts:
// [n_act] int64; en_any, valid: [T] uint8; par, act, prm: next-buffer
// pointer columns (int32); dest: [total] int32 out.
TPUVSR_EXPORT int tpuvsr_commit_finish(void* carry, const void* tile,
                                       const void* fresh, const void* ovf_i,
                                       const void* q_pidx,
                                       const void* q_lane,
                                       const void* q_aid, int total,
                                       const void* cnts, int n_act,
                                       const void* en_any, const void* valid,
                                       int T, void* par, void* act,
                                       void* prm, void* dest, void* stream) {
    KLAUNCH(finish_kernel, 1, THREADS, (cudaStream_t)stream,
            (long long*)carry, (const long long*)tile,
            (const uint8_t*)fresh, (const int*)ovf_i, (const int*)q_pidx,
            (const int*)q_lane, (const int*)q_aid, total,
            (const long long*)cnts, n_act, (const uint8_t*)en_any,
            (const uint8_t*)valid, T, (int*)par, (int*)act, (int*)prm,
            (int*)dest);
    return (int)cudaGetLastError();
}

// nb: next buffer's packed rows [cap + 1, words] int32; par, act, prm:
// its pointer columns; front: the frontier's packed rows; tpp, tpa,
// tpm: trace-pointer tables (int32); lvl_buf: [lvl_cap] int64.
TPUVSR_EXPORT int tpuvsr_level_step(void* carry, const void* nb,
                                    const void* par, const void* act,
                                    const void* prm, void* front, int words,
                                    void* tpp, void* tpa, void* tpm,
                                    void* lvl_buf, int lvl_cap, int T,
                                    void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    KLAUNCH(level_copy_kernel, 264, 256, st, (const long long*)carry,
            (const int*)nb, (const int*)par, (const int*)act,
            (const int*)prm, (int*)front, words, (int*)tpp, (int*)tpa,
            (int*)tpm, T);
    KLAUNCH(level_update_kernel, 1, 1, st, (long long*)carry,
            (long long*)lvl_buf, lvl_cap, T);
    return (int)cudaGetLastError();
}
