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
// is branchy control flow over one row: a launch is latency-bound.
//
// Design (simple first).  One block per item: the block copies the
// parent row into dynamic shared memory (coalesced), thread 0 runs the
// action's scalar code in place on it, in the plain version's order of
// reads and writes, then the block writes the row out (coalesced).
// Planes are located by a host-built offset table over ALL_KEYS (enum
// Plane below); R, V, M, C, MAX_OPS, NHDR and NENT are arguments, so a
// grown message table needs no rebuild.  Integer arithmetic wraps as
// int32 does in PyTorch; sums that PyTorch takes in int64 are int64
// here; the primary of a view keeps torch.remainder's floor modulo; a
// lexicographic tie keeps the earlier row.  With a halt word (the fused
// pass's carry) the kernel does nothing while it is set.
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
constexpr int E_VIEW = 0, E_OPER = 1, E_CLIENT = 2, E_REQ = 3;
constexpr int T_REQ = 0, T_OP = 1, T_EXEC = 2;
constexpr int ERR_BAG_OVERFLOW = 1, ERR_DVC_OVERFLOW = 2,
              ERR_REC_OVERFLOW = 4;
constexpr int INF = 0x7FFFFFFF;
constexpr int THREADS = 128;

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

// One state row in shared memory, its layout, and the block's scratch:
// the header of the message lane (a copy taken before any write), the
// record being sent (row hdr / entry / log / log_len / has_log) and the
// touch list.
struct St {
    int* s;
    const int* off;
    int R, V, M, C, OPS, NHDR, NENT;
    int* mh;                        // [NHDR]
    int* rh;                        // [NHDR]
    int* re;                        // [NENT]
    int* rl;                        // [OPS * NENT]
    int rll, rhl;                   // the record's log_len and has_log
    int* ts;                        // [R + 1]
    int tn;

    __device__ int& at(int p, int i) const { return s[off[p] + i]; }
    __device__ int& hdr(int k, int c) const {
        return s[off[P_M_HDR] + k * NHDR + c];
    }
    __device__ int lsz() const { return OPS * NENT; }
    // a [R, OPS, NENT] plane's row i / a [R, R, OPS, NENT] plane's (i, j)
    __device__ int* log_row(int p, int i) const {
        return &s[off[p] + i * lsz()];
    }
    __device__ int* log_rr(int p, int i, int j) const {
        return &s[off[p] + (i * R + j) * lsz()];
    }
    __device__ int& rr(int p, int i, int j) const {
        return s[off[p] + i * R + j];
    }
    __device__ int& ct(int i, int c, int t) const {
        return s[off[P_CT] + (i * C + c) * 3 + t];
    }

    // -- the record being built ----------------------------------------
    __device__ void row(int type, int view, int op, int commit, int dest,
                        int src, int x, int first, int lnv) {
        for (int c = 0; c < NHDR; ++c) rh[c] = 0;
        rh[H_TYPE] = type; rh[H_VIEW] = view; rh[H_OP] = op;
        rh[H_COMMIT] = commit; rh[H_DEST] = dest; rh[H_SRC] = src;
        rh[H_X] = x; rh[H_FIRST] = first; rh[H_LNV] = lnv;
        for (int e = 0; e < NENT; ++e) re[e] = 0;
        for (int e = 0; e < lsz(); ++e) rl[e] = 0;
        rll = 0;
        rhl = 0;
    }

    // -- message-bag primitives (VSR.tla:228-275) ------------------------
    __device__ void touch(int idx, bool pred) {
        if (!pred) return;
        ts[clipi(tn, 0, R)] = idx;
        tn = wadd(tn, 1);
    }

    // the slot holds a present record equal to the one being sent
    __device__ bool row_eq(int m) const {
        if (at(P_M_PRESENT, m) != 1) return false;
        for (int c = 0; c < NHDR; ++c)
            if (hdr(m, c) != rh[c]) return false;
        for (int e = 0; e < NENT; ++e)
            if (at(P_M_ENTRY, m * NENT + e) != re[e]) return false;
        for (int e = 0; e < lsz(); ++e)
            if (at(P_M_LOG, m * lsz() + e) != rl[e]) return false;
        return at(P_M_LOG_LEN, m) == rll && at(P_M_HAS_LOG, m) == rhl;
    }

    __device__ bool any_eq() const {
        for (int m = 0; m < M; ++m)
            if (row_eq(m)) return true;
        return false;
    }

    // SendFunc upsert (_bag_send): +1 on the first equal record (a
    // count-0 tombstone revives), else the record at the first free
    // slot with count 1; with no free slot, slot 0 and the overflow flag
    __device__ void send(bool pred) {
        int found = -1, free = -1;
        for (int m = 0; m < M && found < 0; ++m) {
            if (free < 0 && at(P_M_PRESENT, m) == 0) free = m;
            if (row_eq(m)) found = m;
        }
        const int idx = found >= 0 ? found : (free >= 0 ? free : 0);
        const bool overflow = pred && found < 0 && free < 0;
        touch(idx, pred);
        at(P_M_COUNT, idx) = wadd(at(P_M_COUNT, idx), pred ? 1 : 0);
        if (pred) at(P_M_PRESENT, idx) = 1;
        if (pred && found < 0) {
            for (int c = 0; c < NHDR; ++c) hdr(idx, c) = rh[c];
            for (int e = 0; e < NENT; ++e) at(P_M_ENTRY, idx * NENT + e) = re[e];
            for (int e = 0; e < lsz(); ++e)
                at(P_M_LOG, idx * lsz() + e) = rl[e];
            at(P_M_LOG_LEN, idx) = rll;
            at(P_M_HAS_LOG, idx) = rhl;
        }
        if (overflow) at(P_ERR, 0) |= ERR_BAG_OVERFLOW;
    }

    __device__ void discard(int k) {
        touch(k, true);
        at(P_M_COUNT, k) = wsub(at(P_M_COUNT, k), 1);
    }

    // BroadcastFunc (_broadcast): the record to every d != src, in order
    __device__ void broadcast(int src) {
        for (int d = 1; d <= R; ++d) {
            rh[H_DEST] = d;
            send(src != d);
        }
    }

    // -- state helpers -----------------------------------------------------
    __device__ void clear_vc(int i) {
        for (int j = 0; j < R; ++j) {
            rr(P_SVC, i, j) = 0;
            rr(P_DVC, i, j) = 0;
            rr(P_DVC_LNV, i, j) = 0;
            rr(P_DVC_OP, i, j) = 0;
            rr(P_DVC_COMMIT, i, j) = 0;
            rr(P_DVC_LOG_LEN, i, j) = 0;
            int* l = log_rr(P_DVC_LOG, i, j);
            for (int e = 0; e < lsz(); ++e) l[e] = 0;
        }
    }

    __device__ void clear_rec(int i) {
        for (int j = 0; j < R; ++j) {
            rr(P_REC, i, j) = 0;
            rr(P_REC_VIEW, i, j) = 0;
            rr(P_REC_HAS_LOG, i, j) = 0;
            rr(P_REC_LOG_LEN, i, j) = 0;
            rr(P_REC_OP, i, j) = 0;
            rr(P_REC_COMMIT, i, j) = 0;
            int* l = log_rr(P_REC_LOG, i, j);
            for (int e = 0; e < lsz(); ++e) l[e] = 0;
        }
    }

    __device__ void reset_sent(int i) {
        at(P_SENT_DVC, i) = 0;
        at(P_SENT_SV, i) = 0;
    }

    // the message lane k: its header copied (mh), its receiver
    __device__ int msg_lane(int k) {
        for (int c = 0; c < NHDR; ++c) mh[c] = hdr(k, c);
        return clipi(wsub(mh[H_DEST], 1), 0, R - 1);
    }

    __device__ bool recv_en(int k, int mtype) const {
        return at(P_M_PRESENT, k) == 1 && at(P_M_COUNT, k) > 0 &&
               mh[H_TYPE] == mtype;
    }

    __device__ int src_rep() const {
        return clipi(wsub(mh[H_SRC], 1), 0, R - 1);
    }

    // _lex_less(a, b) over keys of K words; key(j, t) gives word t of row j
    template <typename F>
    __device__ int best_j(F key, int K) const {
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

    // the invariants on this (the successor's) row
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

// ----------------------------------------------------------------------
// the 19 actions (VSR.tla:366-894): each updates the row in place, in
// the plain version's order, and returns the enabled bit
// ----------------------------------------------------------------------
__device__ bool timer_send_svc(St& g, int i, int timer_limit) {
    const int r = i + 1;
    const bool en = g.at(P_AUX_SVC, 0) < timer_limit &&
                    primary(g.at(P_VIEW, i), g.R) != r;
    const int new_view = wadd(g.at(P_VIEW, i), 1);
    g.at(P_VIEW, i) = new_view;
    g.at(P_STATUS, i) = VIEWCHANGE;
    g.clear_vc(i);
    g.reset_sent(i);
    g.at(P_AUX_SVC, 0) = wadd(g.at(P_AUX_SVC, 0), 1);
    g.row(M_SVC, new_view, 0, 0, 0, r, 0, 0, 0);
    g.broadcast(r);
    return en;
}

__device__ bool receive_higher_svc(St& g, int k) {
    const int i = g.msg_lane(k), r = g.mh[H_DEST];
    const bool en = g.recv_en(k, M_SVC) && g.mh[H_VIEW] > g.at(P_VIEW, i);
    g.at(P_VIEW, i) = g.mh[H_VIEW];
    g.at(P_STATUS, i) = VIEWCHANGE;
    g.clear_vc(i);
    g.rr(P_SVC, i, g.src_rep()) = 1;
    g.reset_sent(i);
    g.discard(k);
    g.row(M_SVC, g.mh[H_VIEW], 0, 0, 0, r, 0, 0, 0);
    g.broadcast(r);
    return en;
}

__device__ bool receive_matching_svc(St& g, int k) {
    const int i = g.msg_lane(k);
    const bool en = g.recv_en(k, M_SVC) && g.mh[H_VIEW] == g.at(P_VIEW, i) &&
                    g.at(P_STATUS, i) == VIEWCHANGE;
    g.rr(P_SVC, i, g.src_rep()) = 1;
    g.discard(k);
    return en;
}

__device__ bool send_dvc(St& g, int i) {
    const int R = g.R, r = i + 1;
    const int view = g.at(P_VIEW, i), prim = primary(view, R);
    long long svc = 0;
    for (int j = 0; j < R; ++j) svc += g.rr(P_SVC, i, j);
    const bool en = g.at(P_STATUS, i) == VIEWCHANGE &&
                    g.at(P_SENT_DVC, i) == 0 && svc >= R / 2;
    const int lnv = g.at(P_LNV, i), op = g.at(P_OP, i);
    const int commit = g.at(P_COMMIT, i), log_len = g.at(P_LOG_LEN, i);
    const int* log = g.log_row(P_LOG, i);
    g.at(P_SENT_DVC, i) = 1;
    const bool self_case = prim == r;
    bool same = g.rr(P_DVC_LNV, i, i) == lnv && g.rr(P_DVC_OP, i, i) == op &&
                g.rr(P_DVC_COMMIT, i, i) == commit &&
                g.rr(P_DVC_LOG_LEN, i, i) == log_len;
    const int* dl = g.log_rr(P_DVC_LOG, i, i);
    for (int e = 0; e < g.lsz(); ++e) same = same && dl[e] == log[e];
    const bool collide = self_case && g.rr(P_DVC, i, i) == 1 && !same;
    g.row(M_DVC, view, op, commit, prim, r, 0, 0, lnv);
    for (int e = 0; e < g.lsz(); ++e) g.rl[e] = log[e];
    g.rll = log_len;
    g.rhl = 1;
    if (self_case) {
        g.rr(P_DVC, i, i) = 1;
        g.rr(P_DVC_LNV, i, i) = lnv;
        g.rr(P_DVC_OP, i, i) = op;
        g.rr(P_DVC_COMMIT, i, i) = commit;
        int* w = g.log_rr(P_DVC_LOG, i, i);
        for (int e = 0; e < g.lsz(); ++e) w[e] = g.rl[e];
        g.rr(P_DVC_LOG_LEN, i, i) = log_len;
    }
    if (collide) g.at(P_ERR, 0) |= ERR_DVC_OVERFLOW;
    g.send(!self_case);
    return en;
}

__device__ bool receive_higher_dvc(St& g, int k) {
    const int i = g.msg_lane(k), r = g.mh[H_DEST], j = g.src_rep();
    const bool en = g.recv_en(k, M_DVC) && g.mh[H_VIEW] > g.at(P_VIEW, i);
    g.at(P_VIEW, i) = g.mh[H_VIEW];
    g.at(P_STATUS, i) = VIEWCHANGE;
    g.clear_vc(i);
    g.rr(P_DVC, i, j) = 1;
    g.rr(P_DVC_LNV, i, j) = g.mh[H_LNV];
    g.rr(P_DVC_OP, i, j) = g.mh[H_OP];
    g.rr(P_DVC_COMMIT, i, j) = g.mh[H_COMMIT];
    int* w = g.log_rr(P_DVC_LOG, i, j);
    for (int e = 0; e < g.lsz(); ++e) w[e] = g.at(P_M_LOG, k * g.lsz() + e);
    g.rr(P_DVC_LOG_LEN, i, j) = g.at(P_M_LOG_LEN, k);
    g.reset_sent(i);
    g.discard(k);
    g.row(M_SVC, g.mh[H_VIEW], 0, 0, 0, r, 0, 0, 0);
    g.broadcast(r);
    return en;
}

__device__ bool receive_matching_dvc(St& g, int k) {
    const int i = g.msg_lane(k), j = g.src_rep();
    const bool en = g.recv_en(k, M_DVC) && g.mh[H_VIEW] == g.at(P_VIEW, i);
    const int ll = g.at(P_M_LOG_LEN, k);
    const int* ml = &g.at(P_M_LOG, k * g.lsz());
    bool same = g.rr(P_DVC, i, j) == 1 &&
                g.rr(P_DVC_LNV, i, j) == g.mh[H_LNV] &&
                g.rr(P_DVC_OP, i, j) == g.mh[H_OP] &&
                g.rr(P_DVC_COMMIT, i, j) == g.mh[H_COMMIT] &&
                g.rr(P_DVC_LOG_LEN, i, j) == ll;
    int* w = g.log_rr(P_DVC_LOG, i, j);
    for (int e = 0; e < g.lsz(); ++e) same = same && w[e] == ml[e];
    const bool collide = g.rr(P_DVC, i, j) == 1 && !same;
    g.rr(P_DVC, i, j) = 1;
    g.rr(P_DVC_LNV, i, j) = g.mh[H_LNV];
    g.rr(P_DVC_OP, i, j) = g.mh[H_OP];
    g.rr(P_DVC_COMMIT, i, j) = g.mh[H_COMMIT];
    for (int e = 0; e < g.lsz(); ++e) w[e] = ml[e];
    g.rr(P_DVC_LOG_LEN, i, j) = ll;
    if (collide && en) g.at(P_ERR, 0) |= ERR_DVC_OVERFLOW;
    g.discard(k);
    return en;
}

__device__ bool send_sv(St& g, int i) {
    const int R = g.R, OPS = g.OPS, r = i + 1;
    const int view = g.at(P_VIEW, i);
    int n = 0;
    for (int j = 0; j < R; ++j) n += g.rr(P_DVC, i, j) == 1;
    const bool en = g.at(P_STATUS, i) == VIEWCHANGE &&
                    g.at(P_SENT_SV, i) == 0 && n >= R / 2 + 1;
    // the maximal (last normal view, op number) pair among received DVCs
    auto pair = [&](int j) {
        return wadd(wmul(g.rr(P_DVC_LNV, i, j), OPS + 1), g.rr(P_DVC_OP, i, j));
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
    g.row(M_SV, view, new_on, new_cn, 0, r, 0, 0, 0);
    const int* bl = g.log_rr(P_DVC_LOG, i, b);
    for (int e = 0; e < g.lsz(); ++e) g.rl[e] = bl[e];
    g.rll = new_on;
    g.rhl = 1;
    g.at(P_STATUS, i) = NORMAL;
    int* l = g.log_row(P_LOG, i);
    for (int e = 0; e < g.lsz(); ++e) l[e] = g.rl[e];
    g.at(P_LOG_LEN, i) = new_on;
    g.at(P_OP, i) = new_on;
    for (int j = 0; j < R; ++j) g.rr(P_PEER_OP, i, j) = 0;
    g.at(P_COMMIT, i) = new_cn;
    g.at(P_SENT_SV, i) = 1;
    g.at(P_LNV, i) = view;
    g.broadcast(r);
    return en;
}

__device__ bool receive_sv(St& g, int k) {
    const int i = g.msg_lane(k), r = g.mh[H_DEST];
    const bool en = g.recv_en(k, M_SV) && g.mh[H_VIEW] >= g.at(P_VIEW, i);
    const int old_commit = g.at(P_COMMIT, i);
    g.at(P_STATUS, i) = NORMAL;
    g.at(P_VIEW, i) = g.mh[H_VIEW];
    int* l = g.log_row(P_LOG, i);
    for (int e = 0; e < g.lsz(); ++e) l[e] = g.at(P_M_LOG, k * g.lsz() + e);
    g.at(P_LOG_LEN, i) = g.at(P_M_LOG_LEN, k);
    g.at(P_OP, i) = g.mh[H_OP];
    g.at(P_COMMIT, i) = g.mh[H_COMMIT];
    g.at(P_LNV, i) = g.mh[H_VIEW];
    g.clear_vc(i);
    g.reset_sent(i);
    g.discard(k);
    g.row(M_PREPAREOK, g.mh[H_VIEW], g.mh[H_OP], 0,
          primary(g.mh[H_VIEW], g.R), r, 0, 0, 0);
    g.send(old_commit < g.mh[H_OP]);
    return en;
}

__device__ bool receive_client_request(St& g, int lane) {
    const int i = lane / g.V, v = lane - i * g.V + 1, r = i + 1;
    const bool en = primary(g.at(P_VIEW, i), g.R) == r &&
                    g.at(P_STATUS, i) == NORMAL &&
                    g.at(P_AUX_ACKED, v - 1) == 0 &&
                    g.ct(i, 0, T_EXEC) == 1;
    const int req = wadd(g.ct(i, 0, T_REQ), 1);
    const int log_len = g.at(P_LOG_LEN, i), opn = wadd(log_len, 1);
    const int view = g.at(P_VIEW, i);
    g.row(M_PREPARE, view, opn, g.at(P_COMMIT, i), 0, r, 0, 0, 0);
    g.re[E_VIEW] = view;
    g.re[E_OPER] = v;
    g.re[E_CLIENT] = 1;
    g.re[E_REQ] = req;
    int* slot = g.log_row(P_LOG, i) + clipi(log_len, 0, g.OPS - 1) * g.NENT;
    for (int e = 0; e < g.NENT; ++e) slot[e] = g.re[e];
    g.at(P_LOG_LEN, i) = opn;
    g.at(P_OP, i) = opn;
    g.ct(i, 0, T_REQ) = req;
    g.ct(i, 0, T_OP) = opn;
    g.ct(i, 0, T_EXEC) = 0;
    g.broadcast(r);
    g.at(P_AUX_ACKED, v - 1) = 1;
    return en;
}

__device__ bool receive_prepare(St& g, int k) {
    const int i = g.msg_lane(k), r = g.mh[H_DEST];
    const bool en = g.recv_en(k, M_PREPARE) && g.at(P_STATUS, i) == NORMAL &&
                    g.mh[H_VIEW] == g.at(P_VIEW, i) &&
                    g.mh[H_OP] == wadd(g.at(P_OP, i), 1);
    const int view = g.at(P_VIEW, i);
    int* slot = g.log_row(P_LOG, i) +
                clipi(g.at(P_LOG_LEN, i), 0, g.OPS - 1) * g.NENT;
    for (int e = 0; e < g.NENT; ++e) slot[e] = g.at(P_M_ENTRY, k * g.NENT + e);
    g.at(P_LOG_LEN, i) = g.mh[H_OP];
    g.at(P_OP, i) = g.mh[H_OP];
    g.at(P_COMMIT, i) = g.mh[H_COMMIT];
    g.ct(i, 0, T_REQ) = g.at(P_M_ENTRY, k * g.NENT + E_REQ);
    g.ct(i, 0, T_OP) = g.mh[H_OP];
    g.ct(i, 0, T_EXEC) = g.mh[H_OP] <= g.mh[H_COMMIT];
    g.discard(k);
    g.row(M_PREPAREOK, view, g.mh[H_OP], 0, g.mh[H_SRC], r, 0, 0, 0);
    g.send(true);
    return en;
}

__device__ bool receive_prepare_ok(St& g, int k) {
    const int i = g.msg_lane(k), r = g.mh[H_DEST], j = g.src_rep();
    const bool en = g.recv_en(k, M_PREPAREOK) &&
                    primary(g.at(P_VIEW, i), g.R) == r &&
                    g.at(P_STATUS, i) == NORMAL &&
                    g.mh[H_VIEW] == g.at(P_VIEW, i) &&
                    g.mh[H_OP] > g.rr(P_PEER_OP, i, j);
    g.rr(P_PEER_OP, i, j) = g.mh[H_OP];
    g.discard(k);
    return en;
}

__device__ bool execute_op(St& g, int i) {
    const int r = i + 1;
    const int commit = g.at(P_COMMIT, i), opn = wadd(commit, 1);
    int n = 0;
    for (int j = 0; j < g.R; ++j) n += g.rr(P_PEER_OP, i, j) >= opn;
    const bool en = primary(g.at(P_VIEW, i), g.R) == r &&
                    g.at(P_STATUS, i) == NORMAL &&
                    commit < g.at(P_OP, i) && n >= g.R / 2;
    const int oper = g.log_row(P_LOG, i)[
        clipi(wsub(opn, 1), 0, g.OPS - 1) * g.NENT + E_OPER];
    g.at(P_COMMIT, i) = opn;
    g.ct(i, 0, T_EXEC) = 1;
    g.at(P_AUX_ACKED, clipi(wsub(oper, 1), 0, g.V - 1)) = 2;
    return en;
}

__device__ bool send_get_state(St& g, int lane) {
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
    for (int o = 0; o < g.OPS; ++o)
        if (!(o < trunc))
            for (int e = 0; e < g.NENT; ++e) l[o * g.NENT + e] = 0;
    g.at(P_LOG_LEN, i) = trunc;
    g.at(P_OP, i) = trunc;
    g.at(P_VIEW, i) = g.mh[H_VIEW];
    g.at(P_LNV, i) = g.mh[H_VIEW];
    // SendOnce: enabled only if the record is not in the bag at all
    g.row(M_GETSTATE, g.mh[H_VIEW], trunc, 0, rdest, r, 0, 0, 0);
    const bool ok = !g.any_eq();
    g.send(true);
    return en && ok;
}

__device__ bool receive_get_state(St& g, int k) {
    const int i = g.msg_lane(k), r = g.mh[H_DEST];
    const int op_i = g.at(P_OP, i);
    const bool en = g.recv_en(k, M_GETSTATE) &&
                    g.at(P_VIEW, i) == g.mh[H_VIEW] &&
                    g.at(P_STATUS, i) == NORMAL && op_i > g.mh[H_OP];
    const int n = wsub(op_i, g.mh[H_OP]);
    g.row(M_NEWSTATE, g.at(P_VIEW, i), op_i, g.at(P_COMMIT, i), g.mh[H_SRC],
          r, 0, wadd(g.mh[H_OP], 1), 0);
    const int* l = g.log_row(P_LOG, i);
    for (int o = 0; o < g.OPS; ++o) {
        const int src = (int)clipl((long long)g.mh[H_OP] + o, 0, g.OPS - 1);
        for (int e = 0; e < g.NENT; ++e)
            g.rl[o * g.NENT + e] = o < n ? l[src * g.NENT + e] : 0;
    }
    g.rll = clipi(n, 0, g.OPS);
    g.rhl = 1;
    g.discard(k);
    g.send(true);
    return en;
}

__device__ bool receive_new_state(St& g, int k) {
    const int i = g.msg_lane(k);
    const int own_n = g.at(P_OP, i);
    const bool en = g.recv_en(k, M_NEWSTATE) &&
                    g.at(P_VIEW, i) == g.mh[H_VIEW] &&
                    g.at(P_STATUS, i) == NORMAL &&
                    own_n == wsub(g.mh[H_FIRST], 1);
    int* l = g.log_row(P_LOG, i);
    const int* ml = &g.at(P_M_LOG, k * g.lsz());
    for (int o = 0; o < g.OPS; ++o) {
        if (o < own_n) continue;                // keeps its own entry
        const int p = (int)clipl((long long)o - own_n, 0, g.OPS - 1);
        for (int e = 0; e < g.NENT; ++e)
            l[o * g.NENT + e] = o < g.mh[H_OP] ? ml[p * g.NENT + e] : 0;
    }
    g.at(P_LOG_LEN, i) = g.mh[H_OP];
    g.at(P_OP, i) = g.mh[H_OP];
    g.discard(k);
    return en;
}

__device__ bool restart_empty(St& g, int i, int restart_limit) {
    const int r = i + 1;
    const bool en = g.at(P_AUX_RESTART, 0) < restart_limit;
    int unique = INT_MIN;
    for (int m = 0; m < g.M; ++m) {
        const bool is_rec = g.at(P_M_PRESENT, m) == 1 &&
                            g.hdr(m, H_TYPE) == M_RECOVERY;
        unique = imax(unique, is_rec ? g.hdr(m, H_X) : 0);
    }
    unique = wadd(unique, 1);
    int* l = g.log_row(P_LOG, i);
    for (int e = 0; e < g.lsz(); ++e) l[e] = 0;
    g.at(P_LOG_LEN, i) = 0;
    g.at(P_VIEW, i) = 1;
    g.at(P_OP, i) = 0;
    g.at(P_COMMIT, i) = 0;
    for (int j = 0; j < g.R; ++j) g.rr(P_PEER_OP, i, j) = 0;
    for (int c = 0; c < g.C; ++c) {
        g.ct(i, c, T_REQ) = 0;
        g.ct(i, c, T_OP) = 0;
        g.ct(i, c, T_EXEC) = 1;
    }
    g.clear_vc(i);
    g.reset_sent(i);
    g.at(P_LNV, i) = 0;
    g.clear_rec(i);
    g.at(P_STATUS, i) = RECOVERING;
    g.at(P_REC_NUMBER, i) = unique;
    g.at(P_AUX_RESTART, 0) = wadd(g.at(P_AUX_RESTART, 0), 1);
    g.row(M_RECOVERY, 0, 0, 0, 0, r, unique, 0, 0);
    g.broadcast(r);
    return en;
}

__device__ bool receive_recovery(St& g, int k) {
    const int i = g.msg_lane(k), r = g.mh[H_DEST];
    const bool en = g.recv_en(k, M_RECOVERY) && g.at(P_STATUS, i) == NORMAL;
    const bool isp = primary(g.at(P_VIEW, i), g.R) == r;
    g.row(M_RECOVERYRESP, g.at(P_VIEW, i), isp ? g.at(P_OP, i) : -1,
          isp ? g.at(P_COMMIT, i) : -1, g.mh[H_SRC], r, g.mh[H_X], 0, 0);
    const int* l = g.log_row(P_LOG, i);
    for (int e = 0; e < g.lsz(); ++e) g.rl[e] = isp ? l[e] : 0;
    g.rll = isp ? g.at(P_LOG_LEN, i) : 0;
    g.rhl = isp ? 1 : 0;
    g.discard(k);
    g.send(true);
    return en;
}

__device__ bool receive_recovery_response(St& g, int k) {
    const int i = g.msg_lane(k), j = g.src_rep();
    const bool en = g.recv_en(k, M_RECOVERYRESP) &&
                    g.at(P_REC_NUMBER, i) == g.mh[H_X] &&
                    g.at(P_STATUS, i) == RECOVERING;
    const int hl = g.at(P_M_HAS_LOG, k), ll = g.at(P_M_LOG_LEN, k);
    const int* ml = &g.at(P_M_LOG, k * g.lsz());
    bool same = g.rr(P_REC, i, j) == 1 &&
                g.rr(P_REC_VIEW, i, j) == g.mh[H_VIEW] &&
                g.rr(P_REC_HAS_LOG, i, j) == hl &&
                g.rr(P_REC_OP, i, j) == g.mh[H_OP] &&
                g.rr(P_REC_COMMIT, i, j) == g.mh[H_COMMIT] &&
                g.rr(P_REC_LOG_LEN, i, j) == ll;
    int* w = g.log_rr(P_REC_LOG, i, j);
    for (int e = 0; e < g.lsz(); ++e) same = same && w[e] == ml[e];
    const bool collide = g.rr(P_REC, i, j) == 1 && !same;
    g.rr(P_REC, i, j) = 1;
    g.rr(P_REC_VIEW, i, j) = g.mh[H_VIEW];
    g.rr(P_REC_HAS_LOG, i, j) = hl;
    for (int e = 0; e < g.lsz(); ++e) w[e] = ml[e];
    g.rr(P_REC_LOG_LEN, i, j) = ll;
    g.rr(P_REC_OP, i, j) = g.mh[H_OP];
    g.rr(P_REC_COMMIT, i, j) = g.mh[H_COMMIT];
    if (collide && en) g.at(P_ERR, 0) |= ERR_REC_OVERFLOW;
    g.discard(k);
    return en;
}

__device__ bool complete_recovery(St& g, int i) {
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
    g.at(P_STATUS, i) = NORMAL;
    g.at(P_VIEW, i) = g.rr(P_REC_VIEW, i, b);
    g.at(P_LNV, i) = g.rr(P_REC_VIEW, i, b);
    int* l = g.log_row(P_LOG, i);
    const int* bl = g.log_rr(P_REC_LOG, i, b);
    for (int e = 0; e < g.lsz(); ++e) l[e] = bl[e];
    g.at(P_LOG_LEN, i) = g.rr(P_REC_LOG_LEN, i, b);
    g.at(P_OP, i) = g.rr(P_REC_OP, i, b);
    g.at(P_COMMIT, i) = g.rr(P_REC_COMMIT, i, b);
    g.clear_rec(i);
    return en;
}

// the replica a lane's action mutates (lane_replica), from the parent
__device__ int lane_replica(const St& g, int a, int lane) {
    switch (a) {
    case A_TIMER_SEND_SVC: case A_SEND_DVC: case A_SEND_SV:
    case A_EXECUTE_OP: case A_RESTART_EMPTY: case A_COMPLETE_RECOVERY:
        return lane;
    case A_RECEIVE_CLIENT_REQUEST:
        return lane / g.V;
    case A_SEND_GET_STATE:
        return clipi(wsub(g.hdr(lane / g.R, H_DEST), 1), 0, g.R - 1);
    default:
        return clipi(wsub(g.hdr(lane, H_DEST), 1), 0, g.R - 1);
    }
}

__device__ bool apply(St& g, int a, int lane, int timer_limit,
                      int restart_limit) {
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

__global__ void actions_kernel(
        const int* __restrict__ flat, int lanes,
        const int* __restrict__ pidx, const int* __restrict__ aid,
        const int* __restrict__ lane_of, const int* __restrict__ planes,
        int R, int V, int M, int C, int OPS, int NHDR, int NENT,
        int timer_limit, int restart_limit, int inv_mask,
        const long long* __restrict__ halt, int* __restrict__ succ,
        uint8_t* __restrict__ en2, int* __restrict__ err,
        int* __restrict__ ts, int* __restrict__ tn, int* __restrict__ ri,
        uint8_t* __restrict__ iok) {
    if (halt && *halt) return;
    int* row = tpuvsr_actions_smem;
    const size_t n = blockIdx.x;
    const int* src = flat + (size_t)pidx[n] * lanes;
    for (int l = threadIdx.x; l < lanes; l += blockDim.x) row[l] = src[l];
    __syncthreads();
    if (threadIdx.x == 0) {
        int* scratch = row + lanes;
        St g;
        g.s = row;
        g.off = planes;
        g.R = R; g.V = V; g.M = M; g.C = C; g.OPS = OPS; g.NHDR = NHDR;
        g.NENT = NENT;
        g.mh = scratch;
        g.rh = g.mh + NHDR;
        g.re = g.rh + NHDR;
        g.rl = g.re + NENT;
        g.ts = g.rl + OPS * NENT;
        g.rll = g.rhl = 0;
        for (int t = 0; t <= R; ++t) g.ts[t] = -1;
        g.tn = 0;
        const int a = aid[n], lane = lane_of[n];
        ri[n] = lane_replica(g, a, lane);
        en2[n] = apply(g, a, lane, timer_limit, restart_limit);
        err[n] = g.at(P_ERR, 0);
        for (int t = 0; t <= R; ++t) ts[n * (R + 1) + t] = g.ts[t];
        tn[n] = g.tn;
        iok[n] = g.invariants(inv_mask);
    }
    __syncthreads();
    int* dst = succ + n * lanes;
    for (int l = threadIdx.x; l < lanes; l += blockDim.x) dst[l] = row[l];
}

}  // namespace

// Dynamic shared memory of one block: the row and the scratch words.
static size_t actions_smem(int lanes, int R, int OPS, int NHDR, int NENT) {
    return (size_t)(lanes + 2 * NHDR + NENT + OPS * NENT + R + 1) *
           sizeof(int);
}

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
        const size_t smem = actions_smem(lanes, R, OPS, NHDR, NENT);
        if (NHDR < N_ROWHDR) return (int)cudaErrorInvalidValue;
        // A block may take 48 KB of dynamic shared memory by default;
        // a row past that (a message table grown to some 400 slots)
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
        KLAUNCH_SMEM(actions_kernel, N, THREADS, smem, st,
            (const int*)flat, lanes, (const int*)pidx, (const int*)aid,
            (const int*)lane, (const int*)planes, R, V, M, C, OPS, NHDR,
            NENT, timer_limit, restart_limit, inv_mask,
            (const long long*)halt, (int*)succ, (uint8_t*)en2, (int*)err,
            (int*)ts, (int*)tn, (int*)ri, (uint8_t*)iok);
    }
    return (int)cudaGetLastError();
}
