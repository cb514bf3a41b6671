// K8: the fused tile's commit and the level step, three entries; and
// K15: the per-action commit, two entries.
//
// K8 replaces the single-commit stage of
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
// Under the ample-set reduction (K17, csrc/por_ample.cu) commit_prefix
// also ANDs K17's keep mask into the commit mask, and commit_finish
// counts K17's kept expansions in gen/act, the unreduced ones in gfull
// and K17's amp count (:989-1013); with POR off both pointers are null
// and the launches are the same as without it.
//   level_step     when the level's last tile has run (:1231-1300): the
//                  level's trace pointers appended at level_base +
//                  n_front, its size recorded, its rows made the next
//                  frontier (a row copy), and the JAX ocond terms
//                  (:1182) turned into a stop flag.
// K15 replaces the commit of the per-action body,
// tpuvsr/engine/device_bfs.py:_tile_body_factory's make_body (:458-673),
// one insert an action, in action order, with the chain between the
// actions kept in a per-tile state vector (enum PaTile) on the device:
//   action_gate    before action a's insert: at a = 0 the headroom gate
//                  (:500-511) opens the chain; then a's flags over its
//                  queue segment, the first violating item (:568-577),
//                  a's expansion overflow, and commit_a = commit &
//                  ~have_v & ~a_slot & ~a_bag & ~ovf_a (:584-587): the
//                  mask a's dedup (K2) and insert (K1) take;
//   action_finish  after a's insert: dest = nn + cumsum(fresh) - 1, the
//                  scatter of a's trace pointers, nn and the distinct
//                  count by a's fresh count, commit = commit_a &
//                  ~a_ovf_i (:589-609); after the last action the
//                  reason by its priority (:626-636), deadlock, and gen,
//                  act and t gated on the final commit (:637-667).
// All five read the carry (enum Carry, engine/tile.py CARRY_FIELDS)
// and, once its halt word is set, commit nothing: the prefix and the
// gate mask every item out, the finishes write dest = -1 and count an
// idle replay (K15's at the last action), the level step does nothing.
//
// What bounds it on the H100: the prefix and the finish touch a few
// bytes per queue item (a few thousand items a tile) and are
// latency-bound, as are K15's entries (an action's segment, a few
// hundred items); the level step moves the level's packed rows (476
// bytes a row, 143 MB at the defect config's depth 10) and its
// pointers once a level, bound by bytes.
//
// Design.  The prefix, the finish and K15's entries are one block each
// (the queue is small): per-action flags by shared-memory atomics, the
// fresh ranks by a chunked Hillis-Steele scan, thread 0 writes the
// verdict and steps the carry after the block has read it.  The two
// finishes share the scan and scatter (rank_scatter) and the verdict's
// fold (fold_verdict); they differ only in where the flags come from.  The level
// step is a grid-stride copy whose blocks only read the carry, then a
// one-thread kernel that updates it.
#include "common.cuh"

namespace {

enum Carry {
    C_T, C_REASON, C_HALT, C_STOP, C_NN, C_N_FRONT, C_DEPTH, C_LEVEL_BASE,
    C_FP_COUNT, C_GEN, C_TILES, C_LVL_CUR, C_VIOL_ROW, C_VIOL_AID,
    C_VIOL_LANE, C_DEAD, C_GROW_AID, C_IDLE, C_WANT_DEADLOCK, C_MAX_DEPTH,
    C_MAX_STATES, C_MAX_LVLS, C_NEXT_CAP, C_TP_CAP, C_GFULL, C_AMP, C_NEED
};

enum Tile {
    F_FIRST_BAD, F_ROOM, F_VIOL, F_SLOT, F_BAG, F_OVF, F_GROW_AID, F_VROW,
    F_VAID, F_VLANE, F_AFLAGS
};

// K15's per-tile chain (engine/tile.py PA_FIELDS)
enum PaTile {
    P_COMMIT, P_COMMIT_A, P_ROOM, P_VIOL, P_SLOT, P_BAG, P_OVF_E, P_OVF_I,
    P_GROW_AID, P_VROW, P_VAID, P_VLANE, P_FIELDS
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
                              const uint8_t* __restrict__ ovf,
                              const uint8_t* __restrict__ keep, int total,
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
        mcommit[i] = s_room && en2[i] && q_ok[i] &&
                     q_aid[i] < s_first_bad && (!keep || keep[i]);
}

// The two finishes' shared steps.  A halted carry commits nothing: dest
// all -1, and one more idle replay where ``idle`` (the tile's last
// call).
__device__ void halted_finish(long long* carry, int total, bool idle,
                              int* __restrict__ dest) {
    for (int i = threadIdx.x; i < total; i += THREADS) dest[i] = -1;
    if (threadIdx.x == 0 && idle) carry[C_IDLE] += 1;
}

// The block's rank scan of fresh [total] (a chunked Hillis-Steele
// scan): dest = nn + rank for the fresh items and -1 for the rest, and
// each fresh item's trace pointers (tile base + row, action, lane) at
// dest.  Returns the fresh count, to every thread.
__device__ int rank_scatter(const uint8_t* __restrict__ fresh, int total,
                            long long nn, int row0,
                            const int* __restrict__ q_pidx,
                            const int* __restrict__ q_lane,
                            const int* __restrict__ q_aid,
                            int* __restrict__ par, int* __restrict__ act,
                            int* __restrict__ prm, int* __restrict__ dest) {
    __shared__ int scan[THREADS];
    __shared__ int base;
    const int tid = threadIdx.x;
    if (tid == 0) base = 0;
    __syncthreads();
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
    return base;
}

// The first valid row of the tile with no enabled lane (INT_BIG when
// there is none), to every thread.
__device__ int first_dead(const uint8_t* __restrict__ en_any,
                          const uint8_t* __restrict__ valid, int T) {
    __shared__ int dmin;
    if (threadIdx.x == 0) dmin = INT_BIG;
    __syncthreads();
    for (int r = threadIdx.x; r < T; r += THREADS)
        if (valid[r] && !en_any[r]) atomicMin(&dmin, r);
    __syncthreads();
    return dmin;
}

// A tile's flags, from K8's prefix or from K15's chain
struct Verdict {
    bool room, viol, slot, bag, ovf_e, ovf_i, commit;
    long long grow_aid, vrow, vaid, vlane;
};

// Thread 0 of both finishes, at the tile's end: the reason by its
// priority (next-buffer gate > violation > slot > bag > expand >
// fpset), then deadlock (the first dead row ``dmin``, when the carry
// asks for it and the tile commits); the violation's and the first
// overflow's ids; on a commit gen and act by the tile's counts, and t
// and tiles by one while the reason stays RUNNING; halt on any reason.
// Under POR (``kept`` set: K17's kept counts per action and ``amp``, its
// count of rows that took the ample shortcut) gen and act take the kept
// counts, gfull the unreduced ones and amp K17's count.
__device__ void fold_verdict(long long* carry, const Verdict& v, int dmin,
                             long long t, int T,
                             const long long* __restrict__ cnts,
                             int n_act,
                             const long long* __restrict__ kept = nullptr,
                             const long long* __restrict__ amp = nullptr) {
    int reason = RUNNING;
    if (!v.room) reason = R_NEXT_GROW;
    else if (v.viol) reason = R_VIOLATION;
    else if (v.slot) reason = R_SLOT_ERR;
    else if (v.bag) reason = R_BAG_GROW;
    else if (v.ovf_e) reason = R_EXPAND_GROW;
    else if (v.ovf_i) reason = R_FPSET_GROW;
    if (reason == RUNNING && carry[C_WANT_DEADLOCK] && v.commit &&
            dmin < T) {
        reason = R_DEADLOCK;
        carry[C_DEAD] = t * T + dmin;
    }
    if (reason == R_VIOLATION) {
        carry[C_VIOL_ROW] = t * T + v.vrow;
        carry[C_VIOL_AID] = v.vaid;
        carry[C_VIOL_LANE] = v.vlane;
    }
    if (v.ovf_e) carry[C_GROW_AID] = v.grow_aid;
    if (v.commit) {
        const long long* gen = kept ? kept : cnts;
        long long sum = 0, full = 0;
        for (int a = 0; a < n_act; ++a) {
            sum += gen[a];
            full += cnts[a];
            carry[C_NEED + n_act + a] += gen[a];
        }
        carry[C_GEN] += sum;
        if (kept) {
            carry[C_GFULL] += full;
            carry[C_AMP] += *amp;
        }
        if (reason == RUNNING) {
            carry[C_T] = t + 1;
            carry[C_TILES] += 1;
        }
    }
    carry[C_REASON] = reason;
    if (reason != RUNNING) carry[C_HALT] = 1;
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
                              int* __restrict__ dest,
                              const long long* __restrict__ kept,
                              const long long* __restrict__ amp) {
    const long long halted = carry[C_HALT];
    const long long nn = carry[C_NN], t = carry[C_T];
    __syncthreads();
    if (halted) {
        halted_finish(carry, total, true, dest);
        return;
    }
    const int nfi = rank_scatter(fresh, total, nn, (int)(t * T), q_pidx,
                                 q_lane, q_aid, par, act, prm, dest);
    const int dmin = first_dead(en_any, valid, T);
    if (threadIdx.x != 0) return;
    const bool room = tile[F_ROOM] != 0, oi = *ovf_i != 0;
    carry[C_NN] = nn + nfi;
    carry[C_FP_COUNT] += nfi;
    const Verdict v{room, tile[F_VIOL] != 0, tile[F_SLOT] != 0,
                    tile[F_BAG] != 0, tile[F_OVF] != 0, oi,
                    room && tile[F_FIRST_BAD] >= n_act && !oi,
                    tile[F_GROW_AID], tile[F_VROW], tile[F_VAID],
                    tile[F_VLANE]};
    fold_verdict(carry, v, dmin, t, T, cnts, n_act, kept, amp);
}

// K15 action_gate: action a's flags over its queue segment [E] and its
// commit mask; a = 0 opens the chain with the headroom gate
__global__ void gate_kernel(const long long* __restrict__ carry,
                            long long* __restrict__ pa,
                            const uint8_t* __restrict__ en2,
                            const uint8_t* __restrict__ iok,
                            const int* __restrict__ err,
                            const int* __restrict__ q_pidx,
                            const int* __restrict__ q_lane,
                            const uint8_t* __restrict__ q_ok,
                            const uint8_t* __restrict__ ovf_a, int a, int E,
                            long long total_e,
                            uint8_t* __restrict__ mcommit) {
    __shared__ int flags, vmin, s_commit;
    const int tid = threadIdx.x;
    if (tid == 0) {
        flags = 0;
        vmin = INT_BIG;
        if (a == 0) {
            const int room = carry[C_NEXT_CAP] - carry[C_NN] >= total_e;
            pa[P_ROOM] = room;
            pa[P_COMMIT] = room;
            pa[P_COMMIT_A] = 0;
            pa[P_VIOL] = pa[P_SLOT] = pa[P_BAG] = 0;
            pa[P_OVF_E] = pa[P_OVF_I] = 0;
            pa[P_GROW_AID] = pa[P_VROW] = pa[P_VAID] = pa[P_VLANE] = -1;
        }
    }
    __syncthreads();
    for (int i = tid; i < E; i += THREADS) {
        const bool ok = en2[i] && q_ok[i];
        const int e = ok ? err[i] : 0;
        const bool v = ok && !iok[i] && e == 0;
        const int f = (v ? 1 : 0) | ((e & ERR_BAG_OVERFLOW) ? 2 : 0) |
                      ((e & ~ERR_BAG_OVERFLOW) ? 4 : 0);
        if (f) atomicOr(&flags, f);
        if (v) atomicMin(&vmin, i);
    }
    __syncthreads();
    if (tid == 0) {
        const int f = flags;
        const bool have_v = f & 1, bag = f & 2, slot = f & 4;
        const bool ovf = *ovf_a != 0;
        if (have_v && pa[P_VROW] < 0) {
            pa[P_VROW] = q_pidx[vmin];
            pa[P_VAID] = a;
            pa[P_VLANE] = q_lane[vmin];
        }
        if (ovf && !pa[P_OVF_E]) pa[P_GROW_AID] = a;
        pa[P_VIOL] |= have_v;
        pa[P_BAG] |= bag;
        pa[P_SLOT] |= slot;
        pa[P_OVF_E] |= ovf;
        const int commit_a = pa[P_COMMIT] && !have_v && !slot && !bag &&
                             !ovf && carry[C_HALT] == 0;
        pa[P_COMMIT_A] = commit_a;
        s_commit = commit_a;
    }
    __syncthreads();
    for (int i = tid; i < E; i += THREADS)
        mcommit[i] = s_commit && en2[i] && q_ok[i];
}

// K15 action_finish: a's fresh items get their next-buffer rows and
// trace pointers; the last action folds the tile's verdict into the
// carry
__global__ void action_finish_kernel(long long* __restrict__ carry,
                                     long long* __restrict__ pa,
                                     const uint8_t* __restrict__ fresh,
                                     const int* __restrict__ ovf_i,
                                     const int* __restrict__ q_pidx,
                                     const int* __restrict__ q_lane,
                                     const int* __restrict__ q_aid, int a,
                                     int E, int n_act,
                                     const long long* __restrict__ cnts,
                                     const uint8_t* __restrict__ en_any,
                                     const uint8_t* __restrict__ valid,
                                     int T, int* __restrict__ par,
                                     int* __restrict__ act,
                                     int* __restrict__ prm,
                                     int* __restrict__ dest) {
    const bool last = a == n_act - 1;
    const long long halted = carry[C_HALT];
    const long long nn = carry[C_NN], t = carry[C_T];
    __syncthreads();
    if (halted) {
        halted_finish(carry, E, last, dest);
        return;
    }
    const int nfi = rank_scatter(fresh, E, nn, (int)(t * T), q_pidx, q_lane,
                                 q_aid, par, act, prm, dest);
    const int dmin = last ? first_dead(en_any, valid, T) : INT_BIG;
    if (threadIdx.x != 0) return;
    const bool oi = *ovf_i != 0;
    carry[C_NN] = nn + nfi;
    carry[C_FP_COUNT] += nfi;
    pa[P_OVF_I] |= oi;
    pa[P_COMMIT] = pa[P_COMMIT_A] && !oi;
    if (!last) return;
    const Verdict v{pa[P_ROOM] != 0, pa[P_VIOL] != 0, pa[P_SLOT] != 0,
                    pa[P_BAG] != 0, pa[P_OVF_E] != 0, pa[P_OVF_I] != 0,
                    pa[P_COMMIT] != 0, pa[P_GROW_AID], pa[P_VROW],
                    pa[P_VAID], pa[P_VLANE]};
    fold_verdict(carry, v, dmin, t, T, cnts, n_act);
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
// err, q_*: int32 [total]; tile: int64 [F_AFLAGS + n_act]; keep: null,
// or K17's [total] uint8 keep mask, ANDed into mcommit (POR).
TPUVSR_EXPORT int tpuvsr_commit_prefix(const void* carry, const void* en2,
                                       const void* iok, const void* err,
                                       const void* q_pidx,
                                       const void* q_lane,
                                       const void* q_aid, const void* q_ok,
                                       const void* ovf, const void* keep,
                                       int total, int n_act,
                                       void* mcommit, void* tile,
                                       void* stream) {
    if (n_act > MAX_ACTIONS) return (int)cudaErrorInvalidValue;
    KLAUNCH(prefix_kernel, 1, THREADS, (cudaStream_t)stream,
            (const long long*)carry, (const uint8_t*)en2,
            (const uint8_t*)iok, (const int*)err, (const int*)q_pidx,
            (const int*)q_lane, (const int*)q_aid, (const uint8_t*)q_ok,
            (const uint8_t*)ovf, (const uint8_t*)keep, total, n_act,
            (uint8_t*)mcommit, (long long*)tile);
    return (int)cudaGetLastError();
}

// fresh: [total] uint8 (K1); ovf_i: one int32 (K1's overflow); cnts:
// [n_act] int64; en_any, valid: [T] uint8; par, act, prm: next-buffer
// pointer columns (int32); dest: [total] int32 out; kept, amp: null, or
// K17's [n_act] int64 kept counts and one int64 amp count (POR).
TPUVSR_EXPORT int tpuvsr_commit_finish(void* carry, const void* tile,
                                       const void* fresh, const void* ovf_i,
                                       const void* q_pidx,
                                       const void* q_lane,
                                       const void* q_aid, int total,
                                       const void* cnts, int n_act,
                                       const void* en_any, const void* valid,
                                       int T, void* par, void* act,
                                       void* prm, void* dest,
                                       const void* kept, const void* amp,
                                       void* stream) {
    KLAUNCH(finish_kernel, 1, THREADS, (cudaStream_t)stream,
            (long long*)carry, (const long long*)tile,
            (const uint8_t*)fresh, (const int*)ovf_i, (const int*)q_pidx,
            (const int*)q_lane, (const int*)q_aid, total,
            (const long long*)cnts, n_act, (const uint8_t*)en_any,
            (const uint8_t*)valid, T, (int*)par, (int*)act, (int*)prm,
            (int*)dest, (const long long*)kept, (const long long*)amp);
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

// K15.  carry: int64 words (enum Carry); pa: int64 [P_FIELDS]; en2,
// iok, q_ok, mcommit: uint8 [E] (action a's queue segment); err, q_*:
// int32 [E]; ovf_a: one uint8 (K7's overflow flag of a); total_e: the
// tile's expansion lanes (the headroom gate).
TPUVSR_EXPORT int tpuvsr_action_gate(const void* carry, void* pa,
                                     const void* en2, const void* iok,
                                     const void* err, const void* q_pidx,
                                     const void* q_lane, const void* q_ok,
                                     const void* ovf_a, int a, int E,
                                     long long total_e, void* mcommit,
                                     void* stream) {
    KLAUNCH(gate_kernel, 1, THREADS, (cudaStream_t)stream,
            (const long long*)carry, (long long*)pa, (const uint8_t*)en2,
            (const uint8_t*)iok, (const int*)err, (const int*)q_pidx,
            (const int*)q_lane, (const uint8_t*)q_ok,
            (const uint8_t*)ovf_a, a, E, total_e, (uint8_t*)mcommit);
    return (int)cudaGetLastError();
}

// fresh: [E] uint8 (K1); ovf_i: one int32 (K1's overflow); q_*: int32
// [E] (a's queue segment, q_aid = a); cnts: [n_act] int64 (K7's exact
// counts of the tile); en_any, valid: [T] uint8; par, act, prm:
// next-buffer pointer columns (int32); dest: [E] int32 out.
TPUVSR_EXPORT int tpuvsr_action_finish(void* carry, void* pa,
                                       const void* fresh, const void* ovf_i,
                                       const void* q_pidx,
                                       const void* q_lane,
                                       const void* q_aid, int a, int E,
                                       int n_act, const void* cnts,
                                       const void* en_any, const void* valid,
                                       int T, void* par, void* act,
                                       void* prm, void* dest, void* stream) {
    KLAUNCH(action_finish_kernel, 1, THREADS, (cudaStream_t)stream,
            (long long*)carry, (long long*)pa, (const uint8_t*)fresh,
            (const int*)ovf_i, (const int*)q_pidx, (const int*)q_lane,
            (const int*)q_aid, a, E, n_act, (const long long*)cnts,
            (const uint8_t*)en_any, (const uint8_t*)valid, T, (int*)par,
            (int*)act, (int*)prm, (int*)dest);
    return (int)cudaGetLastError();
}
