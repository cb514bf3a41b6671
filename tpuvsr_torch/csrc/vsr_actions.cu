// K10: the VSR transition relation (successors and invariants).
//
// Replaces the 19 action functions of tpuvsr/models/vsr_kernel.py
// (act_* at :331-894, with the message-bag primitives _bag_send,
// _broadcast and _bag_discard), vmapped over the work queue by the JAX
// engines (tpuvsr/engine/device_bfs.py _fused_body_factory, the fleet's
// apply_grouped at tpuvsr/sim/fleet.py:339), and the cfg invariants of
// :1176-1191 (invariant_fn :1238) on each successor.  The port's plain
// version is VSRKernel.successors_plain (models/vsr_kernel.py): the
// act_* loop over the queue's actions, seed_touch, lane_replica and
// invariant_fn.
//
// One launch takes a work queue of N items (pidx, aid, lane): a parent
// row of the flat [T, lanes] block, one of the 19 actions and its lane
// parameter.  For each item it writes the successor row (the pack
// layout's lane order), the action's enabled bit, the successor's error
// flags, the incremental fingerprint's touch list (_ts [R+1], -1 padded,
// and its count _tn, exactly as _touch records them), the replica the
// lane mutates (lane_replica) and the AND of the invariants chosen by
// inv_mask (bit b = entry b of INVARIANT_FNS).  Successors are computed
// totally, enabled or not, as the plain version computes them.
//
// What bounds it on the H100: neither bytes nor operations at the
// engine's sizes.  An item reads one parent row and writes one successor
// row (4 x lanes bytes each way, 5.4 KB at MAX_MSGS 32); the action is a
// few dozen scalar steps, except that each bag upsert compares the new
// record with the message slots until one is equal (M slots of NHDR +
// NENT + MAX_OPS x NENT + 3 words), R times for a broadcast.  The work
// is branchy control flow over one row: a launch is latency-bound, and
// an item's time is the chain of dependent shared-memory reads its
// action makes.
//
// Design.  A warp an item, up to WARPS items a block (fewer when a row
// is large: a block keeps within the 48 KB a block has by default, down
// to one item, which opts in to more).  The warp copies its parent row
// into dynamic shared memory (scalar loads up to a 16-byte boundary of
// the source, then uint4, several in flight a lane; the parents come
// from L2, since several items share one), runs the action on it and
// copies the row out the same way.  The reads of an action run on every
// lane alike (the same reads give every lane the same values); its
// writes go in sections between two __syncwarp()s, where lane 0 alone
// makes the scalar writes, in the plain version's order, while the
// lanes write the row's longer runs in parallel (the copies and clears
// of log and view-change planes, the record being built, a new
// message).  A bag upsert (send) lets each lane test its slots (free,
// and equal to the record) and takes the first equal slot and the first
// free one from __ballot_sync + __ffs: the serial loop's first equal
// slot, else its first free slot, else slot 0 with the overflow flag.
// SendGetState's any_eq is the same scan, RestartEmpty's largest
// recovery nonce a warp max, and the invariants go over the replicas a
// lane each.  Planes are located by a host-built offset table over
// ALL_KEYS (enum Plane below), kept in registers (every helper but the
// upsert is inlined: measured, actions out of line cost more than the
// code size saves); R, V, M, C, MAX_OPS, NHDR and NENT are arguments,
// so a grown message table needs no rebuild.  Integer arithmetic wraps
// as int32 does in PyTorch; sums that PyTorch takes in int64 are int64
// here; the primary of a view keeps torch.remainder's floor modulo; a
// lexicographic tie keeps the earlier row.  With a halt word (the fused
// pass's carry) the kernel does nothing while it is set.
//
// K18, the state predicates (tpuvsr_vsr_state_pred), is in this file
// too, on St::invariants below.  It replaces the batched invariant and
// predicate calls of the JAX liveness graph
// (tpuvsr/engine/device_liveness.py:383 _run_batched via :394
// batch_predicate: jit(vmap(invariant_fn([name]))) over each retained
// level block) and the engines' check of a state's own invariants (the
// initial states, a reported violation's rebuilt state).  For each of N
// flat rows it writes one int32 whose bit b is set iff entry b of
// INVARIANT_FNS holds on the row, for the bits of mask (others 0): one
// St::invariants call a bit.  What bounds it: the bytes of the planes
// the invariants read (view, status, log, aux_acked) and the int32 out;
// a simple first design, one thread a state reading its row where it
// lies (no shared memory, uncoalesced across a warp), so expect it well
// above that bound.  K10's warp evaluates the same invariants
// (Item::invariants) with its lanes over the replicas.
#include <algorithm>
#include <climits>

#include "common.cuh"

extern __shared__ int tpuvsr_actions_smem[];

namespace {

// ALL_KEYS order (models/vsr_kernel.py)
enum Plane {
    P_STATUS, P_VIEW, P_OP, P_COMMIT, P_LNV, P_LOG, P_LOG_LEN, P_PEER_OP,
    P_CT, P_SVC, P_DVC, P_DVC_LNV, P_DVC_OP, P_DVC_COMMIT, P_DVC_LOG,
    P_DVC_LOG_LEN, P_SENT_DVC, P_SENT_SV, P_REC_NUMBER, P_REC, P_REC_VIEW,
    P_REC_HAS_LOG, P_REC_LOG, P_REC_LOG_LEN, P_REC_OP, P_REC_COMMIT,
    P_M_PRESENT, P_M_COUNT, P_M_HDR, P_M_ENTRY, P_M_LOG, P_M_LOG_LEN,
    P_M_HAS_LOG, P_AUX_SVC, P_AUX_RESTART, P_AUX_ACKED, P_ERR, N_PLANES
};

// the action ids (ACTION_NAMES order)
enum Action {
    A_TIMER_SEND_SVC, A_RECEIVE_HIGHER_SVC, A_RECEIVE_MATCHING_SVC,
    A_SEND_DVC, A_RECEIVE_HIGHER_DVC, A_RECEIVE_MATCHING_DVC, A_SEND_SV,
    A_RECEIVE_SV, A_RECEIVE_CLIENT_REQUEST, A_RECEIVE_PREPARE,
    A_RECEIVE_PREPARE_OK, A_EXECUTE_OP, A_SEND_GET_STATE,
    A_RECEIVE_GET_STATE, A_RECEIVE_NEW_STATE, A_RESTART_EMPTY,
    A_RECEIVE_RECOVERY, A_RECEIVE_RECOVERY_RESPONSE, A_COMPLETE_RECOVERY,
    N_ACTIONS
};

// the invariants (INVARIANT_FNS order), bits of inv_mask
enum Invariant {
    I_ACKNOWLEDGED_WRITE_NOT_LOST, I_ACKNOWLEDGED_WRITES_EXIST_ON_MAJORITY,
    I_NO_LOG_DIVERGENCE, I_TEST_INV, I_ALL_REPLICAS_MOVE_TO_SAME_VIEW,
    N_INVARIANTS
};

// the codec's encodings (models/vsr.py)
constexpr int NORMAL = 0, VIEWCHANGE = 1, RECOVERING = 2;
constexpr int M_PREPARE = 1, M_PREPAREOK = 2, M_SVC = 3, M_DVC = 4,
              M_SV = 5, M_GETSTATE = 6, M_NEWSTATE = 7, M_RECOVERY = 8,
              M_RECOVERYRESP = 9;
constexpr int H_TYPE = 0, H_VIEW = 1, H_OP = 2, H_COMMIT = 3, H_DEST = 4,
              H_SRC = 5, H_X = 6, H_FIRST = 7, H_LNV = 8, N_ROWHDR = 9;
constexpr int E_VIEW = 0, E_OPER = 1, E_CLIENT = 2, E_REQ = 3, N_ENTRY = 4;
constexpr int T_REQ = 0, T_OP = 1, T_EXEC = 2;
constexpr int ERR_BAG_OVERFLOW = 1, ERR_DVC_OVERFLOW = 2,
              ERR_REC_OVERFLOW = 4;
constexpr int INF = 0x7FFFFFFF;
constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 4;            // K10: items (warps) a block, at most
constexpr int PRED_THREADS = 128;   // K18

__device__ __forceinline__ int wadd(int a, int b) {
    return (int)((unsigned)a + (unsigned)b);
}

__device__ __forceinline__ int wsub(int a, int b) {
    return (int)((unsigned)a - (unsigned)b);
}

__device__ __forceinline__ int wmul(int a, int b) {
    return (int)((unsigned)a * (unsigned)b);
}

__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }

__device__ __forceinline__ int clipi(int x, int lo, int hi) {
    return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ long long clipl(long long x, long long lo,
                                          long long hi) {
    return x < lo ? lo : (x > hi ? hi : x);
}

// 1 + (view - 1) mod R with a floor modulo (torch.remainder)
__device__ __forceinline__ int primary(int view, int R) {
    int x = wsub(view, 1) % R;
    if (x < 0) x += R;
    return 1 + x;
}

// value_key order of a log entry packed into one int32
// (_entry_sort_key: client, operation, request number, view)
__device__ __forceinline__ int sort_key(const int* e) {
    return wadd(wadd(wmul(e[E_CLIENT], 1 << 20), wmul(e[E_OPER], 1 << 16)),
                wadd(wmul(e[E_REQ], 1 << 8), e[E_VIEW]));
}

// K18's view of one state row where it lies (one thread a state) and
// the invariants on it
struct St {
    const int* s;
    const int* off;
    int R, V, M, C, OPS, NHDR, NENT;

    __device__ int at(int p, int i) const { return s[off[p] + i]; }
    __device__ const int* log_row(int p, int i) const {
        return &s[off[p] + i * OPS * NENT];
    }

    __device__ bool has_op(int r, int v) const {
        const int* l = log_row(P_LOG, r);
        for (int o = 0; o < OPS; ++o)
            if (l[o * NENT + E_OPER] == v + 1) return true;
        return false;
    }

    __device__ bool invariants(int mask) const {
        bool ok = true;
        if (mask & (1 << I_ACKNOWLEDGED_WRITE_NOT_LOST))
            for (int v = 0; v < V; ++v) {
                if (at(P_AUX_ACKED, v) != 2) continue;
                bool has = false;
                for (int r = 0; r < R && !has; ++r) has = has_op(r, v);
                ok = ok && has;
            }
        if (mask & (1 << I_ACKNOWLEDGED_WRITES_EXIST_ON_MAJORITY))
            for (int v = 0; v < V; ++v) {
                if (at(P_AUX_ACKED, v) != 2) continue;
                int n = 0;
                for (int r = 0; r < R; ++r) n += has_op(r, v);
                ok = ok && n >= R / 2 + 1;
            }
        if (mask & (1 << I_ALL_REPLICAS_MOVE_TO_SAME_VIEW))
            for (int r = 0; r < R; ++r)
                ok = ok && at(P_VIEW, r) == at(P_VIEW, 0) &&
                     at(P_STATUS, r) == NORMAL;
        // NoLogDivergence (vacuous as the spec writes it) and TestInv hold
        return ok;
    }
};

// The bag's first slot equal to the record (rec: header, entry, log;
// rll, rhl its log_len and has_log) and its first free slot, -1 where
// none: each lane tests slots lane, lane + 32, ..., and __ballot_sync +
// __ffs give the first of each, as the serial loop meets them.
__device__ __forceinline__ void bag_scan(
        const int* present, const int* hdr, const int* entry,
        const int* mlog, const int* log_len, const int* has_log,
        const int* rec, int M, int NHDR, int NENT, int lsz, int rll, int rhl,
        int lane, int& found, int& free) {
    const int* re = rec + NHDR;
    const int* rl = re + NENT;
    found = free = -1;
    for (int base = 0; base < M; base += 32) {
        const int m = base + lane;
        bool fr = false, eq = false;
        if (m < M) {
            fr = present[m] == 0;
            eq = present[m] == 1;
            const int* h = hdr + m * NHDR;
            for (int c = 0; c < NHDR && eq; ++c) eq = h[c] == rec[c];
            const int* e = entry + m * NENT;
            for (int c = 0; c < NENT && eq; ++c) eq = e[c] == re[c];
            const int* l = mlog + m * lsz;
            for (int c = 0; c < lsz && eq; ++c) eq = l[c] == rl[c];
            eq = eq && log_len[m] == rll && has_log[m] == rhl;
        }
        const unsigned bf = __ballot_sync(FULL, fr);
        const unsigned be = __ballot_sync(FULL, eq);
        if (free < 0 && bf) free = base + __ffs(bf) - 1;
        if (be) {
            found = base + __ffs(be) - 1;
            return;
        }
    }
}

// SendFunc upsert (_bag_send): +1 on the first equal record (a count-0
// tombstone revives), else the record at the first free slot with
// count 1; with no free slot, slot 0 and the overflow flag.  Lane 0
// counts the touch in ts[tn] and writes the scalars, the lanes a new
// record's words.  Out of line, the bag's planes as arguments: one copy
// of its code for its dozen call sites (measured on the H100: 6-8%
// faster than inlined).
__device__ __noinline__ void bag_send(
        int* present, int* count, int* hdr, int* entry, int* mlog,
        int* log_len, int* has_log, int* err, const int* rec, int* ts,
        int tn, int R, int M, int NHDR, int NENT, int lsz, int rll, int rhl,
        int lane, bool pred) {
    int found, free;
    bag_scan(present, hdr, entry, mlog, log_len, has_log, rec, M, NHDR,
             NENT, lsz, rll, rhl, lane, found, free);
    const int idx = found >= 0 ? found : (free >= 0 ? free : 0);
    const bool overflow = pred && found < 0 && free < 0;
    const bool add = pred && found < 0;
    __syncwarp();
    if (lane == 0) {
        if (pred) ts[clipi(tn, 0, R)] = idx;
        count[idx] = wadd(count[idx], pred ? 1 : 0);
        if (pred) present[idx] = 1;
        if (add) {
            log_len[idx] = rll;
            has_log[idx] = rhl;
        }
        if (overflow) *err |= ERR_BAG_OVERFLOW;
    }
    if (add) {
        const int* re = rec + NHDR;
        const int* rl = re + NENT;
        for (int t = lane; t < NHDR; t += 32) hdr[idx * NHDR + t] = rec[t];
        for (int t = lane; t < NENT; t += 32) entry[idx * NENT + t] = re[t];
        for (int t = lane; t < lsz; t += 32) mlog[idx * lsz + t] = rl[t];
    }
    __syncwarp();
}

// K10's work item: one warp, its row in shared memory, the record being
// sent (rec: header NHDR, entry NENT, log OPS x NENT words) and the
// touch list (ts) in shared memory after it.  Every lane holds the same
// copy of the scalars (plane offsets, the message lane's header mh, the
// record's log_len and has_log, the touch count).
struct Item {
    int* s;
    int off[N_PLANES];
    int R, V, M, C, OPS, NHDR, NENT;
    int lane;
    bool lead;                      // lane 0: the one that writes
    int mh[N_ROWHDR];
    int* rec;
    int rll, rhl;
    int* ts;
    int tn;

#define ITEM_FN __device__ __forceinline__
    ITEM_FN int at(int p, int i) const { return s[off[p] + i]; }
    ITEM_FN int* ptr(int p, int i) const { return s + off[p] + i; }
    ITEM_FN int& w(int p, int i) const { return s[off[p] + i]; }
    ITEM_FN int lsz() const { return OPS * NENT; }
    // a [R, OPS, NENT] plane's row i / a [R, R, OPS, NENT] plane's (i, j)
    ITEM_FN int* log_row(int p, int i) const { return ptr(p, i * lsz()); }
    ITEM_FN int* log_rr(int p, int i, int j) const {
        return ptr(p, (i * R + j) * lsz());
    }
    ITEM_FN int rr(int p, int i, int j) const { return at(p, i * R + j); }
    ITEM_FN int& wrr(int p, int i, int j) const { return w(p, i * R + j); }
    ITEM_FN int& ct(int i, int c, int t) const {
        return w(P_CT, (i * C + c) * 3 + t);
    }
    ITEM_FN int* re() const { return rec + NHDR; }
    ITEM_FN int* rl() const { return rec + NHDR + NENT; }

    // -- writes ------------------------------------------------------------
    // A section: between two __syncwarp()s, lane 0 alone runs the scalar
    // writes (as the plain version orders them, reading its own writes)
    // while the lanes write disjoint words in parallel (fill, copy);
    // nothing there reads a word the section writes but lane 0 itself.
    ITEM_FN void sync() const { __syncwarp(); }
    template <typename F>
    ITEM_FN void solo(F f) const {
        __syncwarp();
        if (lead) f();
        __syncwarp();
    }
    ITEM_FN void put(int* a, int v) const { solo([&] { *a = v; }); }
    ITEM_FN void fill(int* a, int n, int v) const {
        for (int t = lane; t < n; t += 32) a[t] = v;
    }
    ITEM_FN void copy(int* d, const int* src, int n) const {
        for (int t = lane; t < n; t += 32) d[t] = src[t];
    }
    // n words equal, the lanes over them
    ITEM_FN bool same(const int* a, const int* b, int n) const {
        bool ok = true;
        for (int t = lane; t < n && ok; t += 32) ok = a[t] == b[t];
        return __all_sync(FULL, ok);
    }

    // -- the record being built ----------------------------------------
    ITEM_FN void row(int type, int view, int op, int commit, int dest,
                     int src, int x, int first, int lnv) {
        sync();
        const int n = NHDR + NENT + lsz();
        for (int t = lane; t < n; t += 32) {
            int v = 0;
            switch (t) {
            case H_TYPE: v = type; break;
            case H_VIEW: v = view; break;
            case H_OP: v = op; break;
            case H_COMMIT: v = commit; break;
            case H_DEST: v = dest; break;
            case H_SRC: v = src; break;
            case H_X: v = x; break;
            case H_FIRST: v = first; break;
            case H_LNV: v = lnv; break;
            }
            rec[t] = v;
        }
        sync();
        rll = 0;
        rhl = 0;
    }

    // -- message-bag primitives (VSR.tla:228-275) ------------------------
    // _bag_discard's writes (lane 0, in a section; every lane then
    // counts the touch: tn += 1)
    ITEM_FN void discard_w(int k) const {
        ts[clipi(tn, 0, R)] = k;
        w(P_M_COUNT, k) = wsub(at(P_M_COUNT, k), 1);
    }

    // SendOnce's test: the record is in the bag
    ITEM_FN bool any_eq() const {
        int found, free;
        bag_scan(ptr(P_M_PRESENT, 0), ptr(P_M_HDR, 0), ptr(P_M_ENTRY, 0),
                 ptr(P_M_LOG, 0), ptr(P_M_LOG_LEN, 0), ptr(P_M_HAS_LOG, 0),
                 rec, M, NHDR, NENT, lsz(), rll, rhl, lane, found, free);
        return found >= 0;
    }

    // the upsert (bag_send); a broadcast's next destination (next_dest
    // > 0) goes into the record after it
    ITEM_FN void send(bool pred, int next_dest = 0) {
        bag_send(ptr(P_M_PRESENT, 0), ptr(P_M_COUNT, 0), ptr(P_M_HDR, 0),
                 ptr(P_M_ENTRY, 0), ptr(P_M_LOG, 0), ptr(P_M_LOG_LEN, 0),
                 ptr(P_M_HAS_LOG, 0), ptr(P_ERR, 0), rec, ts, tn, R, M,
                 NHDR, NENT, lsz(), rll, rhl, lane, pred);
        if (next_dest > 0) put(rec + H_DEST, next_dest);
        if (pred) tn = wadd(tn, 1);
    }

    // BroadcastFunc (_broadcast): the record to every d != src, in order
    ITEM_FN void broadcast(int src) {
        put(rec + H_DEST, 1);
        for (int d = 1; d <= R; ++d) send(src != d, d < R ? d + 1 : 0);
    }

    // -- state helpers (lane-strided writes, inside a section) -----------
    ITEM_FN void clear_vc(int i) const {
        fill(ptr(P_SVC, i * R), R, 0);
        fill(ptr(P_DVC, i * R), R, 0);
        fill(ptr(P_DVC_LNV, i * R), R, 0);
        fill(ptr(P_DVC_OP, i * R), R, 0);
        fill(ptr(P_DVC_COMMIT, i * R), R, 0);
        fill(ptr(P_DVC_LOG_LEN, i * R), R, 0);
        fill(log_rr(P_DVC_LOG, i, 0), R * lsz(), 0);
    }

    ITEM_FN void clear_rec(int i) const {
        fill(ptr(P_REC, i * R), R, 0);
        fill(ptr(P_REC_VIEW, i * R), R, 0);
        fill(ptr(P_REC_HAS_LOG, i * R), R, 0);
        fill(ptr(P_REC_LOG_LEN, i * R), R, 0);
        fill(ptr(P_REC_OP, i * R), R, 0);
        fill(ptr(P_REC_COMMIT, i * R), R, 0);
        fill(log_rr(P_REC_LOG, i, 0), R * lsz(), 0);
    }

    // the message lane k: its header copied (mh), its receiver
    ITEM_FN int msg_lane(int k) {
#pragma unroll
        for (int c = 0; c < N_ROWHDR; ++c) mh[c] = at(P_M_HDR, k * NHDR + c);
        return clipi(wsub(mh[H_DEST], 1), 0, R - 1);
    }

    ITEM_FN bool recv_en(int k, int mtype) const {
        return at(P_M_PRESENT, k) == 1 && at(P_M_COUNT, k) > 0 &&
               mh[H_TYPE] == mtype;
    }

    ITEM_FN int src_rep() const {
        return clipi(wsub(mh[H_SRC], 1), 0, R - 1);
    }

    // _lex_less(a, b) over keys of K words; key(j, t) gives word t of row j
    template <typename F>
    ITEM_FN int best_j(F key, int K) const {
        int best = 0;
        for (int j = 1; j < R; ++j) {
            for (int t = 0; t < K; ++t) {
                const int a = key(j, t), b = key(best, t);
                if (a != b) {
                    if (a < b) best = j;
                    break;
                }
            }
        }
        return best;
    }

    // St::invariants on this (the successor's) row, the lanes over the
    // replicas
    ITEM_FN bool has_op(int r, int v) const {
        const int* l = log_row(P_LOG, r);
        for (int o = 0; o < OPS; ++o)
            if (l[o * NENT + E_OPER] == v + 1) return true;
        return false;
    }

    ITEM_FN int replicas_with(int v) const {
        int n = 0;
        for (int base = 0; base < R; base += 32) {
            const int r = base + lane;
            n += __popc(__ballot_sync(FULL, r < R && has_op(r, v)));
        }
        return n;
    }

    ITEM_FN bool invariants(int mask) const {
        bool ok = true;
        if (mask & (1 << I_ACKNOWLEDGED_WRITE_NOT_LOST))
            for (int v = 0; v < V; ++v)
                if (at(P_AUX_ACKED, v) == 2) ok = ok && replicas_with(v) > 0;
        if (mask & (1 << I_ACKNOWLEDGED_WRITES_EXIST_ON_MAJORITY))
            for (int v = 0; v < V; ++v)
                if (at(P_AUX_ACKED, v) == 2)
                    ok = ok && replicas_with(v) >= R / 2 + 1;
        if (mask & (1 << I_ALL_REPLICAS_MOVE_TO_SAME_VIEW))
            for (int base = 0; base < R; base += 32) {
                const int r = base + lane;
                ok = ok && __all_sync(FULL, r >= R ||
                                      (at(P_VIEW, r) == at(P_VIEW, 0) &&
                                       at(P_STATUS, r) == NORMAL));
            }
        // NoLogDivergence (vacuous as the spec writes it) and TestInv hold
        return ok;
    }
#undef ITEM_FN
};

// ----------------------------------------------------------------------
// the 19 actions (VSR.tla:366-894): each updates the row in place, in
// the plain version's order, and returns the enabled bit (every lane).
// The reads before a section see the row as the plain version does at
// that point; a section's writes go to words nothing in it reads but
// lane 0, in the plain version's order where one word is written twice.
// ----------------------------------------------------------------------
#define ACTION __device__ __forceinline__ bool

ACTION timer_send_svc(Item& g, int i, int timer_limit) {
    const int r = i + 1;
    const bool en = g.at(P_AUX_SVC, 0) < timer_limit &&
                    primary(g.at(P_VIEW, i), g.R) != r;
    const int new_view = wadd(g.at(P_VIEW, i), 1);
    g.sync();
    if (g.lead) {
        g.w(P_VIEW, i) = new_view;
        g.w(P_STATUS, i) = VIEWCHANGE;
        g.w(P_SENT_DVC, i) = 0;
        g.w(P_SENT_SV, i) = 0;
        g.w(P_AUX_SVC, 0) = wadd(g.at(P_AUX_SVC, 0), 1);
    }
    g.clear_vc(i);
    g.sync();
    g.row(M_SVC, new_view, 0, 0, 0, r, 0, 0, 0);
    g.broadcast(r);
    return en;
}

ACTION receive_higher_svc(Item& g, int k) {
    const int i = g.msg_lane(k), r = g.mh[H_DEST];
    const bool en = g.recv_en(k, M_SVC) && g.mh[H_VIEW] > g.at(P_VIEW, i);
    const int j = g.src_rep();
    g.sync();
    if (g.lead) {
        g.w(P_VIEW, i) = g.mh[H_VIEW];
        g.w(P_STATUS, i) = VIEWCHANGE;
        g.w(P_SENT_DVC, i) = 0;
        g.w(P_SENT_SV, i) = 0;
        g.discard_w(k);
    }
    g.clear_vc(i);
    g.sync();
    g.tn = wadd(g.tn, 1);
    g.put(&g.wrr(P_SVC, i, j), 1);          // after clear_vc's zeros
    g.row(M_SVC, g.mh[H_VIEW], 0, 0, 0, r, 0, 0, 0);
    g.broadcast(r);
    return en;
}

ACTION receive_matching_svc(Item& g, int k) {
    const int i = g.msg_lane(k);
    const bool en = g.recv_en(k, M_SVC) && g.mh[H_VIEW] == g.at(P_VIEW, i) &&
                    g.at(P_STATUS, i) == VIEWCHANGE;
    const int j = g.src_rep();
    g.solo([&] {
        g.wrr(P_SVC, i, j) = 1;
        g.discard_w(k);
    });
    g.tn = wadd(g.tn, 1);
    return en;
}

ACTION send_dvc(Item& g, int i) {
    const int R = g.R, r = i + 1;
    const int view = g.at(P_VIEW, i), prim = primary(view, R);
    long long svc = 0;
    for (int j = 0; j < R; ++j) svc += g.rr(P_SVC, i, j);
    const bool en = g.at(P_STATUS, i) == VIEWCHANGE &&
                    g.at(P_SENT_DVC, i) == 0 && svc >= R / 2;
    const int lnv = g.at(P_LNV, i), op = g.at(P_OP, i);
    const int commit = g.at(P_COMMIT, i), log_len = g.at(P_LOG_LEN, i);
    const int* log = g.log_row(P_LOG, i);
    const bool self_case = prim == r;
    const bool same = g.rr(P_DVC_LNV, i, i) == lnv &&
                      g.rr(P_DVC_OP, i, i) == op &&
                      g.rr(P_DVC_COMMIT, i, i) == commit &&
                      g.rr(P_DVC_LOG_LEN, i, i) == log_len &&
                      g.same(g.log_rr(P_DVC_LOG, i, i), log, g.lsz());
    const bool collide = self_case && g.rr(P_DVC, i, i) == 1 && !same;
    g.row(M_DVC, view, op, commit, prim, r, 0, 0, lnv);
    g.rll = log_len;
    g.rhl = 1;
    g.sync();
    if (g.lead) {
        g.w(P_SENT_DVC, i) = 1;
        if (self_case) {
            g.wrr(P_DVC, i, i) = 1;
            g.wrr(P_DVC_LNV, i, i) = lnv;
            g.wrr(P_DVC_OP, i, i) = op;
            g.wrr(P_DVC_COMMIT, i, i) = commit;
            g.wrr(P_DVC_LOG_LEN, i, i) = log_len;
        }
        if (collide) g.w(P_ERR, 0) |= ERR_DVC_OVERFLOW;
    }
    g.copy(g.rl(), log, g.lsz());
    if (self_case) g.copy(g.log_rr(P_DVC_LOG, i, i), log, g.lsz());
    g.sync();
    g.send(!self_case);
    return en;
}

ACTION receive_higher_dvc(Item& g, int k) {
    const int i = g.msg_lane(k), r = g.mh[H_DEST], j = g.src_rep();
    const bool en = g.recv_en(k, M_DVC) && g.mh[H_VIEW] > g.at(P_VIEW, i);
    g.sync();
    if (g.lead) {
        g.w(P_VIEW, i) = g.mh[H_VIEW];
        g.w(P_STATUS, i) = VIEWCHANGE;
    }
    g.clear_vc(i);
    g.sync();
    // the sender's DVC, after clear_vc's zeros
    if (g.lead) {
        g.wrr(P_DVC, i, j) = 1;
        g.wrr(P_DVC_LNV, i, j) = g.mh[H_LNV];
        g.wrr(P_DVC_OP, i, j) = g.mh[H_OP];
        g.wrr(P_DVC_COMMIT, i, j) = g.mh[H_COMMIT];
        g.wrr(P_DVC_LOG_LEN, i, j) = g.at(P_M_LOG_LEN, k);
        g.w(P_SENT_DVC, i) = 0;
        g.w(P_SENT_SV, i) = 0;
        g.discard_w(k);
    }
    g.copy(g.log_rr(P_DVC_LOG, i, j), g.ptr(P_M_LOG, k * g.lsz()), g.lsz());
    g.sync();
    g.tn = wadd(g.tn, 1);
    g.row(M_SVC, g.mh[H_VIEW], 0, 0, 0, r, 0, 0, 0);
    g.broadcast(r);
    return en;
}

ACTION receive_matching_dvc(Item& g, int k) {
    const int i = g.msg_lane(k), j = g.src_rep();
    const bool en = g.recv_en(k, M_DVC) && g.mh[H_VIEW] == g.at(P_VIEW, i);
    const int ll = g.at(P_M_LOG_LEN, k);
    const int* ml = g.ptr(P_M_LOG, k * g.lsz());
    int* w = g.log_rr(P_DVC_LOG, i, j);
    const bool same = g.rr(P_DVC, i, j) == 1 &&
                      g.rr(P_DVC_LNV, i, j) == g.mh[H_LNV] &&
                      g.rr(P_DVC_OP, i, j) == g.mh[H_OP] &&
                      g.rr(P_DVC_COMMIT, i, j) == g.mh[H_COMMIT] &&
                      g.rr(P_DVC_LOG_LEN, i, j) == ll &&
                      g.same(w, ml, g.lsz());
    const bool collide = g.rr(P_DVC, i, j) == 1 && !same;
    g.sync();
    if (g.lead) {
        g.wrr(P_DVC, i, j) = 1;
        g.wrr(P_DVC_LNV, i, j) = g.mh[H_LNV];
        g.wrr(P_DVC_OP, i, j) = g.mh[H_OP];
        g.wrr(P_DVC_COMMIT, i, j) = g.mh[H_COMMIT];
        g.wrr(P_DVC_LOG_LEN, i, j) = ll;
        if (collide && en) g.w(P_ERR, 0) |= ERR_DVC_OVERFLOW;
        g.discard_w(k);
    }
    g.copy(w, ml, g.lsz());
    g.sync();
    g.tn = wadd(g.tn, 1);
    return en;
}

ACTION send_sv(Item& g, int i) {
    const int R = g.R, OPS = g.OPS, r = i + 1;
    const int view = g.at(P_VIEW, i);
    int n = 0;
    for (int j = 0; j < R; ++j) n += g.rr(P_DVC, i, j) == 1;
    const bool en = g.at(P_STATUS, i) == VIEWCHANGE &&
                    g.at(P_SENT_SV, i) == 0 && n >= R / 2 + 1;
    // the maximal (last normal view, op number) pair among received DVCs
    auto pair = [&](int j) {
        return wadd(wmul(g.rr(P_DVC_LNV, i, j), OPS + 1),
                    g.rr(P_DVC_OP, i, j));
    };
    int best_pair = INT_MIN, new_cn = INT_MIN;
    for (int j = 0; j < R; ++j) {
        const bool got = g.rr(P_DVC, i, j) == 1;
        best_pair = imax(best_pair, got ? pair(j) : -1);
        new_cn = imax(new_cn, got ? g.rr(P_DVC_COMMIT, i, j) : -1);
    }
    // the lexicographically least (commit, log keys, source) among them
    auto key = [&](int j, int t) {
        if (!(g.rr(P_DVC, i, j) == 1 && pair(j) == best_pair)) return INF;
        if (t == 0) return g.rr(P_DVC_COMMIT, i, j);
        if (t <= OPS)
            return sort_key(g.log_rr(P_DVC_LOG, i, j) + (t - 1) * g.NENT);
        return j + 1;
    };
    const int b = g.best_j(key, OPS + 2);
    const int new_on = g.rr(P_DVC_LOG_LEN, i, b);
    const int* bl = g.log_rr(P_DVC_LOG, i, b);
    g.row(M_SV, view, new_on, new_cn, 0, r, 0, 0, 0);
    g.rll = new_on;
    g.rhl = 1;
    g.sync();
    if (g.lead) {
        g.w(P_STATUS, i) = NORMAL;
        g.w(P_LOG_LEN, i) = new_on;
        g.w(P_OP, i) = new_on;
        g.w(P_COMMIT, i) = new_cn;
        g.w(P_SENT_SV, i) = 1;
        g.w(P_LNV, i) = view;
    }
    g.copy(g.rl(), bl, g.lsz());
    g.copy(g.log_row(P_LOG, i), bl, g.lsz());
    g.fill(g.ptr(P_PEER_OP, i * R), R, 0);
    g.sync();
    g.broadcast(r);
    return en;
}

ACTION receive_sv(Item& g, int k) {
    const int i = g.msg_lane(k), r = g.mh[H_DEST];
    const bool en = g.recv_en(k, M_SV) && g.mh[H_VIEW] >= g.at(P_VIEW, i);
    const int old_commit = g.at(P_COMMIT, i);
    g.sync();
    if (g.lead) {
        g.w(P_STATUS, i) = NORMAL;
        g.w(P_VIEW, i) = g.mh[H_VIEW];
        g.w(P_LOG_LEN, i) = g.at(P_M_LOG_LEN, k);
        g.w(P_OP, i) = g.mh[H_OP];
        g.w(P_COMMIT, i) = g.mh[H_COMMIT];
        g.w(P_LNV, i) = g.mh[H_VIEW];
        g.w(P_SENT_DVC, i) = 0;
        g.w(P_SENT_SV, i) = 0;
        g.discard_w(k);
    }
    g.copy(g.log_row(P_LOG, i), g.ptr(P_M_LOG, k * g.lsz()), g.lsz());
    g.clear_vc(i);
    g.sync();
    g.tn = wadd(g.tn, 1);
    g.row(M_PREPAREOK, g.mh[H_VIEW], g.mh[H_OP], 0,
          primary(g.mh[H_VIEW], g.R), r, 0, 0, 0);
    g.send(old_commit < g.mh[H_OP]);
    return en;
}

ACTION receive_client_request(Item& g, int lane) {
    const int i = lane / g.V, v = lane - i * g.V + 1, r = i + 1;
    const bool en = primary(g.at(P_VIEW, i), g.R) == r &&
                    g.at(P_STATUS, i) == NORMAL &&
                    g.at(P_AUX_ACKED, v - 1) == 0 &&
                    g.ct(i, 0, T_EXEC) == 1;
    const int req = wadd(g.ct(i, 0, T_REQ), 1);
    const int log_len = g.at(P_LOG_LEN, i), opn = wadd(log_len, 1);
    const int view = g.at(P_VIEW, i);
    g.row(M_PREPARE, view, opn, g.at(P_COMMIT, i), 0, r, 0, 0, 0);
    int* slot = g.log_row(P_LOG, i) + clipi(log_len, 0, g.OPS - 1) * g.NENT;
    g.solo([&] {
        int* re = g.re();
        re[E_VIEW] = slot[E_VIEW] = view;
        re[E_OPER] = slot[E_OPER] = v;
        re[E_CLIENT] = slot[E_CLIENT] = 1;
        re[E_REQ] = slot[E_REQ] = req;
        for (int e = N_ENTRY; e < g.NENT; ++e) slot[e] = 0;
        g.w(P_LOG_LEN, i) = opn;
        g.w(P_OP, i) = opn;
        g.ct(i, 0, T_REQ) = req;
        g.ct(i, 0, T_OP) = opn;
        g.ct(i, 0, T_EXEC) = 0;
    });
    g.broadcast(r);
    g.put(g.ptr(P_AUX_ACKED, v - 1), 1);
    return en;
}

ACTION receive_prepare(Item& g, int k) {
    const int i = g.msg_lane(k), r = g.mh[H_DEST];
    const bool en = g.recv_en(k, M_PREPARE) && g.at(P_STATUS, i) == NORMAL &&
                    g.mh[H_VIEW] == g.at(P_VIEW, i) &&
                    g.mh[H_OP] == wadd(g.at(P_OP, i), 1);
    const int view = g.at(P_VIEW, i);
    int* slot = g.log_row(P_LOG, i) +
                clipi(g.at(P_LOG_LEN, i), 0, g.OPS - 1) * g.NENT;
    const int* me = g.ptr(P_M_ENTRY, k * g.NENT);
    g.sync();
    if (g.lead) {
        g.w(P_LOG_LEN, i) = g.mh[H_OP];
        g.w(P_OP, i) = g.mh[H_OP];
        g.w(P_COMMIT, i) = g.mh[H_COMMIT];
        g.ct(i, 0, T_REQ) = me[E_REQ];
        g.ct(i, 0, T_OP) = g.mh[H_OP];
        g.ct(i, 0, T_EXEC) = g.mh[H_OP] <= g.mh[H_COMMIT];
        g.discard_w(k);
    }
    g.copy(slot, me, g.NENT);
    g.sync();
    g.tn = wadd(g.tn, 1);
    g.row(M_PREPAREOK, view, g.mh[H_OP], 0, g.mh[H_SRC], r, 0, 0, 0);
    g.send(true);
    return en;
}

ACTION receive_prepare_ok(Item& g, int k) {
    const int i = g.msg_lane(k), r = g.mh[H_DEST], j = g.src_rep();
    const bool en = g.recv_en(k, M_PREPAREOK) &&
                    primary(g.at(P_VIEW, i), g.R) == r &&
                    g.at(P_STATUS, i) == NORMAL &&
                    g.mh[H_VIEW] == g.at(P_VIEW, i) &&
                    g.mh[H_OP] > g.rr(P_PEER_OP, i, j);
    g.solo([&] {
        g.wrr(P_PEER_OP, i, j) = g.mh[H_OP];
        g.discard_w(k);
    });
    g.tn = wadd(g.tn, 1);
    return en;
}

ACTION execute_op(Item& g, int i) {
    const int r = i + 1;
    const int commit = g.at(P_COMMIT, i), opn = wadd(commit, 1);
    int n = 0;
    for (int j = 0; j < g.R; ++j) n += g.rr(P_PEER_OP, i, j) >= opn;
    const bool en = primary(g.at(P_VIEW, i), g.R) == r &&
                    g.at(P_STATUS, i) == NORMAL &&
                    commit < g.at(P_OP, i) && n >= g.R / 2;
    const int oper = g.log_row(P_LOG, i)[
        clipi(wsub(opn, 1), 0, g.OPS - 1) * g.NENT + E_OPER];
    g.solo([&] {
        g.w(P_COMMIT, i) = opn;
        g.ct(i, 0, T_EXEC) = 1;
        g.w(P_AUX_ACKED, clipi(wsub(oper, 1), 0, g.V - 1)) = 2;
    });
    return en;
}

ACTION send_get_state(Item& g, int lane) {
    const int k = lane / g.R, rdest = lane - k * g.R + 1;
    const int i = g.msg_lane(k), r = g.mh[H_DEST];
    const bool en = g.recv_en(k, M_PREPARE) &&
                    primary(g.at(P_VIEW, i), g.R) != r && r != rdest &&
                    g.at(P_STATUS, i) == NORMAL &&
                    g.mh[H_VIEW] > g.at(P_VIEW, i) &&
                    g.mh[H_OP] > wadd(g.at(P_OP, i), 1);
    const int c = g.at(P_COMMIT, i), ll = g.at(P_LOG_LEN, i);
    const int trunc = c < ll ? c : ll;
    int* l = g.log_row(P_LOG, i);
    g.sync();
    if (g.lead) {
        g.w(P_LOG_LEN, i) = trunc;
        g.w(P_OP, i) = trunc;
        g.w(P_VIEW, i) = g.mh[H_VIEW];
        g.w(P_LNV, i) = g.mh[H_VIEW];
    }
    for (int t = g.lane; t < g.lsz(); t += 32)
        if (!(t / g.NENT < trunc)) l[t] = 0;
    g.sync();
    // SendOnce: enabled only if the record is not in the bag at all
    g.row(M_GETSTATE, g.mh[H_VIEW], trunc, 0, rdest, r, 0, 0, 0);
    const bool ok = !g.any_eq();
    g.send(true);
    return en && ok;
}

ACTION receive_get_state(Item& g, int k) {
    const int i = g.msg_lane(k), r = g.mh[H_DEST];
    const int op_i = g.at(P_OP, i);
    const bool en = g.recv_en(k, M_GETSTATE) &&
                    g.at(P_VIEW, i) == g.mh[H_VIEW] &&
                    g.at(P_STATUS, i) == NORMAL && op_i > g.mh[H_OP];
    const int n = wsub(op_i, g.mh[H_OP]);
    g.row(M_NEWSTATE, g.at(P_VIEW, i), op_i, g.at(P_COMMIT, i), g.mh[H_SRC],
          r, 0, wadd(g.mh[H_OP], 1), 0);
    const int* l = g.log_row(P_LOG, i);
    int* rl = g.rl();
    g.sync();
    if (g.lead) g.discard_w(k);
    for (int t = g.lane; t < g.lsz(); t += 32) {
        const int o = t / g.NENT, e = t - o * g.NENT;
        const int src = (int)clipl((long long)g.mh[H_OP] + o, 0, g.OPS - 1);
        rl[t] = o < n ? l[src * g.NENT + e] : 0;
    }
    g.sync();
    g.tn = wadd(g.tn, 1);
    g.rll = clipi(n, 0, g.OPS);
    g.rhl = 1;
    g.send(true);
    return en;
}

ACTION receive_new_state(Item& g, int k) {
    const int i = g.msg_lane(k);
    const int own_n = g.at(P_OP, i);
    const bool en = g.recv_en(k, M_NEWSTATE) &&
                    g.at(P_VIEW, i) == g.mh[H_VIEW] &&
                    g.at(P_STATUS, i) == NORMAL &&
                    own_n == wsub(g.mh[H_FIRST], 1);
    int* l = g.log_row(P_LOG, i);
    const int* ml = g.ptr(P_M_LOG, k * g.lsz());
    g.sync();
    if (g.lead) {
        g.w(P_LOG_LEN, i) = g.mh[H_OP];
        g.w(P_OP, i) = g.mh[H_OP];
        g.discard_w(k);
    }
    for (int t = g.lane; t < g.lsz(); t += 32) {
        const int o = t / g.NENT, e = t - o * g.NENT;
        if (o < own_n) continue;                // keeps its own entry
        const int p = (int)clipl((long long)o - own_n, 0, g.OPS - 1);
        l[t] = o < g.mh[H_OP] ? ml[p * g.NENT + e] : 0;
    }
    g.sync();
    g.tn = wadd(g.tn, 1);
    return en;
}

ACTION restart_empty(Item& g, int i, int restart_limit) {
    const int r = i + 1;
    const bool en = g.at(P_AUX_RESTART, 0) < restart_limit;
    int unique = INT_MIN;
    for (int m = g.lane; m < g.M; m += 32) {
        const bool is_rec = g.at(P_M_PRESENT, m) == 1 &&
                            g.at(P_M_HDR, m * g.NHDR + H_TYPE) == M_RECOVERY;
        unique = imax(unique, is_rec ? g.at(P_M_HDR, m * g.NHDR + H_X) : 0);
    }
    unique = wadd(__reduce_max_sync(FULL, unique), 1);
    g.sync();
    if (g.lead) {
        g.w(P_LOG_LEN, i) = 0;
        g.w(P_VIEW, i) = 1;
        g.w(P_OP, i) = 0;
        g.w(P_COMMIT, i) = 0;
        g.w(P_SENT_DVC, i) = 0;
        g.w(P_SENT_SV, i) = 0;
        g.w(P_LNV, i) = 0;
        g.w(P_STATUS, i) = RECOVERING;
        g.w(P_REC_NUMBER, i) = unique;
        g.w(P_AUX_RESTART, 0) = wadd(g.at(P_AUX_RESTART, 0), 1);
    }
    g.fill(g.log_row(P_LOG, i), g.lsz(), 0);
    g.fill(g.ptr(P_PEER_OP, i * g.R), g.R, 0);
    int* ct = &g.ct(i, 0, 0);
    for (int t = g.lane; t < g.C * 3; t += 32) ct[t] = t % 3 == T_EXEC;
    g.clear_vc(i);
    g.clear_rec(i);
    g.sync();
    g.row(M_RECOVERY, 0, 0, 0, 0, r, unique, 0, 0);
    g.broadcast(r);
    return en;
}

ACTION receive_recovery(Item& g, int k) {
    const int i = g.msg_lane(k), r = g.mh[H_DEST];
    const bool en = g.recv_en(k, M_RECOVERY) && g.at(P_STATUS, i) == NORMAL;
    const bool isp = primary(g.at(P_VIEW, i), g.R) == r;
    g.row(M_RECOVERYRESP, g.at(P_VIEW, i), isp ? g.at(P_OP, i) : -1,
          isp ? g.at(P_COMMIT, i) : -1, g.mh[H_SRC], r, g.mh[H_X], 0, 0);
    const int* l = g.log_row(P_LOG, i);
    int* rl = g.rl();
    g.sync();
    if (g.lead) g.discard_w(k);
    for (int t = g.lane; t < g.lsz(); t += 32) rl[t] = isp ? l[t] : 0;
    g.sync();
    g.tn = wadd(g.tn, 1);
    g.rll = isp ? g.at(P_LOG_LEN, i) : 0;
    g.rhl = isp ? 1 : 0;
    g.send(true);
    return en;
}

ACTION receive_recovery_response(Item& g, int k) {
    const int i = g.msg_lane(k), j = g.src_rep();
    const bool en = g.recv_en(k, M_RECOVERYRESP) &&
                    g.at(P_REC_NUMBER, i) == g.mh[H_X] &&
                    g.at(P_STATUS, i) == RECOVERING;
    const int hl = g.at(P_M_HAS_LOG, k), ll = g.at(P_M_LOG_LEN, k);
    const int* ml = g.ptr(P_M_LOG, k * g.lsz());
    int* w = g.log_rr(P_REC_LOG, i, j);
    const bool same = g.rr(P_REC, i, j) == 1 &&
                      g.rr(P_REC_VIEW, i, j) == g.mh[H_VIEW] &&
                      g.rr(P_REC_HAS_LOG, i, j) == hl &&
                      g.rr(P_REC_OP, i, j) == g.mh[H_OP] &&
                      g.rr(P_REC_COMMIT, i, j) == g.mh[H_COMMIT] &&
                      g.rr(P_REC_LOG_LEN, i, j) == ll &&
                      g.same(w, ml, g.lsz());
    const bool collide = g.rr(P_REC, i, j) == 1 && !same;
    g.sync();
    if (g.lead) {
        g.wrr(P_REC, i, j) = 1;
        g.wrr(P_REC_VIEW, i, j) = g.mh[H_VIEW];
        g.wrr(P_REC_HAS_LOG, i, j) = hl;
        g.wrr(P_REC_LOG_LEN, i, j) = ll;
        g.wrr(P_REC_OP, i, j) = g.mh[H_OP];
        g.wrr(P_REC_COMMIT, i, j) = g.mh[H_COMMIT];
        if (collide && en) g.w(P_ERR, 0) |= ERR_REC_OVERFLOW;
        g.discard_w(k);
    }
    g.copy(w, ml, g.lsz());
    g.sync();
    g.tn = wadd(g.tn, 1);
    return en;
}

ACTION complete_recovery(Item& g, int i) {
    const int R = g.R, OPS = g.OPS;
    int n = 0;
    bool any = false;
    for (int j = 0; j < R; ++j) {
        const bool got = g.rr(P_REC, i, j) == 1;
        n += got;
        any = any || (got && g.rr(P_REC_HAS_LOG, i, j) == 1);
    }
    const bool en = g.at(P_STATUS, i) == RECOVERING && n > R / 2 && any;
    // the least (commit, log keys, op, source, view) among responses
    // that carry a log
    auto key = [&](int j, int t) {
        if (!(g.rr(P_REC, i, j) == 1 && g.rr(P_REC_HAS_LOG, i, j) == 1))
            return INF;
        if (t == 0) return g.rr(P_REC_COMMIT, i, j);
        if (t <= OPS)
            return sort_key(g.log_rr(P_REC_LOG, i, j) + (t - 1) * g.NENT);
        if (t == OPS + 1) return g.rr(P_REC_OP, i, j);
        if (t == OPS + 2) return j + 1;
        return g.rr(P_REC_VIEW, i, j);
    };
    const int b = g.best_j(key, OPS + 4);
    g.sync();
    if (g.lead) {
        g.w(P_STATUS, i) = NORMAL;
        g.w(P_VIEW, i) = g.rr(P_REC_VIEW, i, b);
        g.w(P_LNV, i) = g.rr(P_REC_VIEW, i, b);
        g.w(P_LOG_LEN, i) = g.rr(P_REC_LOG_LEN, i, b);
        g.w(P_OP, i) = g.rr(P_REC_OP, i, b);
        g.w(P_COMMIT, i) = g.rr(P_REC_COMMIT, i, b);
    }
    g.copy(g.log_row(P_LOG, i), g.log_rr(P_REC_LOG, i, b), g.lsz());
    g.sync();
    g.clear_rec(i);             // after the copy read the chosen log
    g.sync();
    return en;
}

// the replica a lane's action mutates (lane_replica), from the parent
__device__ __forceinline__ int lane_replica(const Item& g, int a, int lane) {
    switch (a) {
    case A_TIMER_SEND_SVC: case A_SEND_DVC: case A_SEND_SV:
    case A_EXECUTE_OP: case A_RESTART_EMPTY: case A_COMPLETE_RECOVERY:
        return lane;
    case A_RECEIVE_CLIENT_REQUEST:
        return lane / g.V;
    case A_SEND_GET_STATE:
        return clipi(wsub(g.at(P_M_HDR, lane / g.R * g.NHDR + H_DEST), 1),
                     0, g.R - 1);
    default:
        return clipi(wsub(g.at(P_M_HDR, lane * g.NHDR + H_DEST), 1), 0,
                     g.R - 1);
    }
}

__device__ __forceinline__ bool apply(Item& g, int a, int lane,
                                      int timer_limit, int restart_limit) {
    switch (a) {
    case A_TIMER_SEND_SVC: return timer_send_svc(g, lane, timer_limit);
    case A_RECEIVE_HIGHER_SVC: return receive_higher_svc(g, lane);
    case A_RECEIVE_MATCHING_SVC: return receive_matching_svc(g, lane);
    case A_SEND_DVC: return send_dvc(g, lane);
    case A_RECEIVE_HIGHER_DVC: return receive_higher_dvc(g, lane);
    case A_RECEIVE_MATCHING_DVC: return receive_matching_dvc(g, lane);
    case A_SEND_SV: return send_sv(g, lane);
    case A_RECEIVE_SV: return receive_sv(g, lane);
    case A_RECEIVE_CLIENT_REQUEST: return receive_client_request(g, lane);
    case A_RECEIVE_PREPARE: return receive_prepare(g, lane);
    case A_RECEIVE_PREPARE_OK: return receive_prepare_ok(g, lane);
    case A_EXECUTE_OP: return execute_op(g, lane);
    case A_SEND_GET_STATE: return send_get_state(g, lane);
    case A_RECEIVE_GET_STATE: return receive_get_state(g, lane);
    case A_RECEIVE_NEW_STATE: return receive_new_state(g, lane);
    case A_RESTART_EMPTY: return restart_empty(g, lane, restart_limit);
    case A_RECEIVE_RECOVERY: return receive_recovery(g, lane);
    case A_RECEIVE_RECOVERY_RESPONSE:
        return receive_recovery_response(g, lane);
    case A_COMPLETE_RECOVERY: return complete_recovery(g, lane);
    }
    return false;
}

// the warp's copy of n words from global src to shared dst, and back:
// scalar words up to a 16-byte boundary of the global side, then uint4,
// IN_FLIGHT loads a lane issued before the first is stored
constexpr int IN_FLIGHT = 8;

__device__ __forceinline__ void row_in(int* dst, const int* src, int n,
                                       int lane) {
    const int head = min(n, (int)((16 - ((uintptr_t)src & 15)) & 15) / 4);
    for (int t = lane; t < head; t += 32) dst[t] = __ldg(src + t);
    const int nvec = (n - head) / 4;
    const int4* v = (const int4*)(src + head);
    for (int t0 = lane; t0 < nvec; t0 += 32 * IN_FLIGHT) {
        int4 q[IN_FLIGHT];
#pragma unroll
        for (int u = 0; u < IN_FLIGHT; ++u)
            if (t0 + 32 * u < nvec) q[u] = __ldg(v + t0 + 32 * u);
#pragma unroll
        for (int u = 0; u < IN_FLIGHT; ++u) {
            if (t0 + 32 * u >= nvec) break;
            int* d = dst + head + 4 * (t0 + 32 * u);
            d[0] = q[u].x;
            d[1] = q[u].y;
            d[2] = q[u].z;
            d[3] = q[u].w;
        }
    }
    for (int t = head + 4 * nvec + lane; t < n; t += 32)
        dst[t] = __ldg(src + t);
}

__device__ __forceinline__ void row_out(int* dst, const int* src, int n,
                                        int lane) {
    const int head = min(n, (int)((16 - ((uintptr_t)dst & 15)) & 15) / 4);
    for (int t = lane; t < head; t += 32) dst[t] = src[t];
    const int nvec = (n - head) / 4;
    int4* v = (int4*)(dst + head);
    for (int t = lane; t < nvec; t += 32) {
        const int* s = src + head + 4 * t;
        v[t] = make_int4(s[0], s[1], s[2], s[3]);
    }
    for (int t = head + 4 * nvec + lane; t < n; t += 32) dst[t] = src[t];
}

// one warp an item, ipb items a block; each warp's share of the dynamic
// shared memory is stride ints: the row, the record, the touch list
__global__ void __launch_bounds__(WARPS * 32) actions_kernel(
        const int* __restrict__ flat, int lanes, int N, int ipb, int stride,
        const int* __restrict__ pidx, const int* __restrict__ aid,
        const int* __restrict__ lane_of, const int* __restrict__ planes,
        int R, int V, int M, int C, int OPS, int NHDR, int NENT,
        int timer_limit, int restart_limit, int inv_mask,
        const long long* __restrict__ halt, int* __restrict__ succ,
        uint8_t* __restrict__ en2, int* __restrict__ err,
        int* __restrict__ ts, int* __restrict__ tn, int* __restrict__ ri,
        uint8_t* __restrict__ iok) {
    if (halt && *halt) return;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const long long n = (long long)blockIdx.x * ipb + warp;
    if (warp >= ipb || n >= N) return;
    int* row = tpuvsr_actions_smem + (size_t)warp * stride;
    row_in(row, flat + (size_t)pidx[n] * lanes, lanes, lane);
    Item g;
    g.s = row;
#pragma unroll
    for (int p = 0; p < N_PLANES; ++p) g.off[p] = __ldg(planes + p);
    g.R = R; g.V = V; g.M = M; g.C = C; g.OPS = OPS; g.NHDR = NHDR;
    g.NENT = NENT;
    g.lane = lane;
    g.lead = lane == 0;
    g.rec = row + lanes;
    g.ts = g.rec + NHDR + NENT + OPS * NENT;
    g.rll = g.rhl = 0;
    g.tn = 0;
    for (int t = lane; t <= R; t += 32) g.ts[t] = -1;
    __syncwarp();
    const int a = aid[n], ln = lane_of[n];
    const int rep = lane_replica(g, a, ln);
    const bool en = apply(g, a, ln, timer_limit, restart_limit);
    __syncwarp();
    const bool ok = g.invariants(inv_mask);
    if (g.lead) {
        ri[n] = rep;
        en2[n] = en;
        err[n] = g.at(P_ERR, 0);
        tn[n] = g.tn;
        iok[n] = ok;
    }
    for (int t = lane; t <= R; t += 32) ts[n * (R + 1) + t] = g.ts[t];
    row_out(succ + (size_t)n * lanes, row, lanes, lane);
}

// K18: one thread a state, on its row where it lies
__global__ void state_pred_kernel(
        const int* __restrict__ flat, int lanes, int N,
        const int* __restrict__ planes, int R, int V, int M, int C,
        int OPS, int NHDR, int NENT, int mask, int* __restrict__ out) {
    const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (n >= N) return;
    St g;
    g.s = flat + n * lanes;
    g.off = planes;
    g.R = R; g.V = V; g.M = M; g.C = C; g.OPS = OPS; g.NHDR = NHDR;
    g.NENT = NENT;
    int bits = 0;
    for (int b = 0; b < N_INVARIANTS; ++b)
        if (mask >> b & 1) bits |= (g.invariants(1 << b) ? 1 : 0) << b;
    out[n] = bits;
}

}  // namespace

// flat: [T, lanes] int32 parent rows; pidx, aid, lane: [N] int32 work
// queue; planes: [N_PLANES] int32 plane offsets (ALL_KEYS order); halt:
// one int64 word or null; succ: [N, lanes] int32; en2, iok: [N] uint8;
// err, tn, ri: [N] int32; ts: [N, R + 1] int32.
TPUVSR_EXPORT int tpuvsr_vsr_actions(
        const void* flat, int lanes, const void* pidx, const void* aid,
        const void* lane, int N, const void* planes, int R, int V, int M,
        int C, int OPS, int NHDR, int NENT, int timer_limit,
        int restart_limit, int inv_mask, const void* halt, void* succ,
        void* en2, void* err, void* ts, void* tn, void* ri, void* iok,
        void* stream) {
    if (N > 0) {
        if (NHDR < N_ROWHDR) return (int)cudaErrorInvalidValue;
        // a warp's share: the row, the record and the touch list, in
        // whole 16-byte units; as many items a block as keep it within
        // the 48 KB a block has by default, at least one and at most WARPS
        const int words = lanes + NHDR + NENT + OPS * NENT + R + 1;
        const int stride = (words + 3) & ~3;
        const size_t per = (size_t)stride * sizeof(int);
        const int ipb = (int)std::max<size_t>(
            1, std::min<size_t>(WARPS, 48 * 1024 / per));
        const size_t smem = per * ipb;
        // A row past 48 KB (a message table grown to some 400 slots)
        // needs the kernel's opt-in, up to the device's limit (227 KB
        // on the H100).  The opt-in is made once per larger size, at
        // the first (eager) launch of a layout, before any capture.
        static size_t opted = 48 * 1024;
        if (smem > opted) {
            int dev = 0, most = 0;
            cudaError_t e = cudaGetDevice(&dev);
            if (e == cudaSuccess)
                e = cudaDeviceGetAttribute(
                    &most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
            if (e != cudaSuccess) return (int)e;
            if (smem > (size_t)most) return (int)cudaErrorInvalidValue;
            e = cudaFuncSetAttribute(
                actions_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                (int)smem);
            if (e != cudaSuccess) return (int)e;
            opted = smem;
        }
        cudaStream_t st = (cudaStream_t)stream;
        KLAUNCH_SMEM(actions_kernel, tpuvsr_blocks(N, ipb), ipb * 32, smem,
            st, (const int*)flat, lanes, N, ipb, stride, (const int*)pidx,
            (const int*)aid, (const int*)lane, (const int*)planes, R, V, M,
            C, OPS, NHDR, NENT, timer_limit, restart_limit, inv_mask,
            (const long long*)halt, (int*)succ, (uint8_t*)en2, (int*)err,
            (int*)ts, (int*)tn, (int*)ri, (uint8_t*)iok);
    }
    return (int)cudaGetLastError();
}

// K18.  flat: [N, lanes] int32 rows; planes: [N_PLANES] int32 plane
// offsets (ALL_KEYS order); mask: bits of INVARIANT_FNS to evaluate;
// out: [N] int32, bit b set iff invariant b holds (bits outside mask 0).
TPUVSR_EXPORT int tpuvsr_vsr_state_pred(
        const void* flat, int lanes, int N, const void* planes, int R,
        int V, int M, int C, int OPS, int NHDR, int NENT, int mask,
        void* out, void* stream) {
    if (mask >> N_INVARIANTS) return (int)cudaErrorInvalidValue;
    if (N > 0) {
        cudaStream_t st = (cudaStream_t)stream;
        KLAUNCH(state_pred_kernel, tpuvsr_blocks(N, PRED_THREADS),
            PRED_THREADS, st, (const int*)flat, lanes, N,
            (const int*)planes, R, V, M, C, OPS, NHDR, NENT, mask,
            (int*)out);
    }
    return (int)cudaGetLastError();
}
