// K14: the ST03 (VR_STATE_TRANSFER) transition relation (successors and
// invariants).
//
// Replaces the 16 action functions of tpuvsr/models/st03_kernel.py
// (act_* at :261-570, with the message-bag primitives _bag_send,
// _bag_discard and _broadcast at :183-227, lane_replica :723 and
// seed_touch :741), vmapped over the work queue by the JAX engines
// (step_all :747 and the fused body of tpuvsr/engine/device_bfs.py), and
// the invariants inv_* of :912-938 (invariant_fn :976) on each
// successor.  The port's plain version is ST03Kernel.successors_plain
// (models/st03_kernel.py).
//
// One launch takes a work queue of N items (pidx, aid, lane) and writes,
// for each, what K10 (csrc/vsr_actions.cu) writes: the successor row,
// the enabled bit, the error flags, the touch list (_ts [R+1], -1
// padded, and _tn), the replica the lane mutates and the AND of the
// invariants chosen by inv_mask (bit b = entry b of INVARIANT_FNS).
// Successors are computed totally, enabled or not.
//
// ST03 against VSR: a send may insert its record with count 0 (the new
// primary's own DoViewChange, SendAsReceived), and the quorums of SendDVC
// and SendSV count such count-0 records in the bag; a replica in the
// StateTransfer status waits for a NewState, whose log overwrites the
// suffix from first_op on; SendGetState asks from the replica's commit
// number and keeps its log; a GetState is addressed to AnyDest (-1);
// every action but NoProgressChange needs its replica's CanProgress; and
// NoProgressChange rewrites the no_progress plane from its lane's subset.
//
// What bounds it on the H100: neither bytes nor operations at the
// engine's sizes.  An item reads one parent row and writes one successor
// row (a few hundred int32 lanes each way); the action is a few dozen
// scalar steps, except that each bag upsert compares the new record with
// the message slots until one is equal (M slots of NHDR + 1 + MAX_OPS
// words), R times for a broadcast.  A launch is latency-bound.
//
// Design, that of K10.  One block per item: the block copies the parent
// row into dynamic shared memory (coalesced), thread 0 runs the action's
// scalar code in place on it, in the plain version's order of reads and
// writes, then the block writes the row out (coalesced).  Planes are
// located by a host-built offset table over ALL_KEYS (enum Plane); R, V,
// M, MAX_OPS and NHDR are arguments, so a grown message table needs no
// rebuild.  Integer arithmetic wraps as int32 does in PyTorch; the
// primary of a view keeps torch.remainder's floor modulo.  With a halt
// word (the fused pass's carry) the kernel does nothing while it is set.
//
// The family layout.  Everything above the kernel (the Plane and Action
// enums, the St row with its bag primitives, the actions, apply() and
// the invariants) is the ST03 layer that the family's other models
// (A01, I01, AS04, RR05, CP06 subclass ST03Kernel) extend: their planes
// follow N_ST03_PLANES in their ALL_KEYS, their actions follow
// N_ST03_ACTIONS, and a model that changes an ST03 action replaces its
// case in apply().
#include <climits>

#include "common.cuh"

extern __shared__ int tpuvsr_st03_smem[];

namespace {

// ALL_KEYS order (models/st03_kernel.py)
enum Plane {
    P_STATUS, P_VIEW, P_OP, P_COMMIT, P_LNV, P_LOG, P_PEER_OP, P_SENT_DVC,
    P_SENT_SV, P_NO_PROG, P_NP_CTR, P_M_PRESENT, P_M_COUNT, P_M_HDR,
    P_M_ENTRY, P_M_LOG, P_AUX_SVC, P_AUX_ACKED, P_ERR, N_ST03_PLANES
};

// the action ids (ACTION_NAMES order)
enum Action {
    A_TIMER_SEND_SVC, A_RECEIVE_HIGHER_SVC, A_RECEIVE_MATCHING_SVC,
    A_SEND_DVC, A_RECEIVE_HIGHER_DVC, A_RECEIVE_MATCHING_DVC, A_SEND_SV,
    A_RECEIVE_SV, A_RECEIVE_CLIENT_REQUEST, A_RECEIVE_PREPARE,
    A_RECEIVE_PREPARE_OK, A_EXECUTE_OP, A_SEND_GET_STATE,
    A_RECEIVE_GET_STATE, A_RECEIVE_NEW_STATE, A_NO_PROGRESS_CHANGE,
    N_ST03_ACTIONS
};

// the invariants (INVARIANT_FNS order), bits of inv_mask
enum Invariant {
    I_NO_LOG_DIVERGENCE, I_ACKNOWLEDGED_WRITE_NOT_LOST,
    I_ACKNOWLEDGED_WRITES_EXIST_ON_MAJORITY,
    I_COMMIT_NUMBER_NEVER_HIGHER_THAN_OP_NUMBER, I_TEST_INV,
    I_ALL_REPLICAS_MOVE_TO_SAME_VIEW, N_INVARIANTS
};

// the codec's encodings (models/st03.py, models/vsr.py)
constexpr int NORMAL = 0, VIEWCHANGE = 1, STATETRANSFER = 2;
constexpr int M_PREPARE = 1, M_PREPAREOK = 2, M_SVC = 3, M_DVC = 4,
              M_SV = 5, M_GETSTATE = 6, M_NEWSTATE = 7;
constexpr int H_TYPE = 0, H_VIEW = 1, H_OP = 2, H_COMMIT = 3, H_DEST = 4,
              H_SRC = 5, H_X = 6, H_FIRST = 7, H_LNV = 8, N_ROWHDR = 9;
constexpr int ANYDEST = -1;
constexpr int ERR_BAG_OVERFLOW = 1;
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

// One state row in shared memory, its layout, and the block's scratch:
// the header of the message lane (a copy taken before any write), the
// record being sent (header rh, entry re, log rl) and the touch list.
struct St {
    int* s;
    const int* off;
    int R, V, M, OPS, NHDR;
    int* mh;                        // [NHDR]
    int* rh;                        // [NHDR]
    int re;
    int* rl;                        // [OPS]
    int* ts;                        // [R + 1]
    int tn;

    __device__ int& at(int p, int i) const { return s[off[p] + i]; }
    __device__ int& hdr(int k, int c) const {
        return s[off[P_M_HDR] + k * NHDR + c];
    }
    __device__ int* log_row(int i) const { return &s[off[P_LOG] + i * OPS]; }
    __device__ int* m_log(int k) const { return &s[off[P_M_LOG] + k * OPS]; }
    __device__ int& peer(int i, int j) const {
        return s[off[P_PEER_OP] + i * R + j];
    }

    // -- the record being built ----------------------------------------
    __device__ void row(int type, int view, int op, int commit, int dest,
                        int src, int first, int lnv) {
        for (int c = 0; c < NHDR; ++c) rh[c] = 0;
        rh[H_TYPE] = type; rh[H_VIEW] = view; rh[H_OP] = op;
        rh[H_COMMIT] = commit; rh[H_DEST] = dest; rh[H_SRC] = src;
        rh[H_FIRST] = first; rh[H_LNV] = lnv;
        re = 0;
        for (int o = 0; o < OPS; ++o) rl[o] = 0;
    }

    // -- message-bag primitives (ST03:164-218) -------------------------
    __device__ void touch(int idx, bool pred) {
        if (!pred) return;
        ts[clipi(tn, 0, R)] = idx;
        tn = wadd(tn, 1);
    }

    // the slot holds a present record equal to the one being sent
    __device__ bool row_eq(int m) const {
        if (at(P_M_PRESENT, m) != 1 || at(P_M_ENTRY, m) != re) return false;
        for (int c = 0; c < NHDR; ++c)
            if (hdr(m, c) != rh[c]) return false;
        const int* l = m_log(m);
        for (int o = 0; o < OPS; ++o)
            if (l[o] != rl[o]) return false;
        return true;
    }

    __device__ bool any_eq() const {
        for (int m = 0; m < M; ++m)
            if (row_eq(m)) return true;
        return false;
    }

    // SendFunc(m, msgs, new_count) (_bag_send): +1 on the first equal
    // record (a count-0 tombstone revives), else the record at the first
    // free slot with new_count pending deliveries (0 = SendAsReceived);
    // with no free slot, slot 0 and the overflow flag
    __device__ void send(bool pred, int new_count) {
        int found = -1, free = -1;
        for (int m = 0; m < M && found < 0; ++m) {
            if (free < 0 && at(P_M_PRESENT, m) == 0) free = m;
            if (row_eq(m)) found = m;
        }
        const int idx = found >= 0 ? found : (free >= 0 ? free : 0);
        const bool overflow = pred && found < 0 && free < 0;
        touch(idx, pred);
        at(P_M_COUNT, idx) = wadd(at(P_M_COUNT, idx),
                                  pred && found >= 0 ? 1 : 0);
        if (pred) at(P_M_PRESENT, idx) = 1;
        if (pred && found < 0) {
            at(P_M_COUNT, idx) = new_count;
            for (int c = 0; c < NHDR; ++c) hdr(idx, c) = rh[c];
            at(P_M_ENTRY, idx) = re;
            int* l = m_log(idx);
            for (int o = 0; o < OPS; ++o) l[o] = rl[o];
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
            send(src != d, 1);
        }
    }

    // -- state helpers -----------------------------------------------------
    __device__ bool can_progress(int i) const { return at(P_NO_PROG, i) == 0; }

    __device__ bool normal_primary(int i, int r) const {
        return primary(at(P_VIEW, i), R) == r && at(P_STATUS, i) == NORMAL;
    }

    __device__ void reset_sent(int i) {
        at(P_SENT_DVC, i) = 0;
        at(P_SENT_SV, i) = 0;
    }

    // processed (count-0) mtype records addressed to replica i in its
    // view (_svc_tombstones, _valid_dvc)
    __device__ bool tombstone(int m, int i, int mtype) const {
        return at(P_M_PRESENT, m) == 1 && at(P_M_COUNT, m) == 0 &&
               hdr(m, H_TYPE) == mtype && hdr(m, H_DEST) == i + 1 &&
               hdr(m, H_VIEW) == at(P_VIEW, i);
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

    // -- the invariants on this (the successor's) row ----------------------
    __device__ int has_op(int r, int v) const {
        const int* l = log_row(r);
        for (int o = 0; o < OPS; ++o)
            if (l[o] == v + 1) return 1;
        return 0;
    }

    __device__ bool invariants(int mask, int timer_limit) const {
        bool ok = true;
        if (mask & (1 << I_NO_LOG_DIVERGENCE))
            for (int a = 0; a < R; ++a)
                for (int b = 0; b < R; ++b)
                    for (int o = 0; o < OPS; ++o)
                        if (o < at(P_COMMIT, a) && o < at(P_COMMIT, b) &&
                                log_row(a)[o] != log_row(b)[o])
                            ok = false;
        if (mask & (1 << I_ACKNOWLEDGED_WRITE_NOT_LOST))
            for (int v = 0; v < V; ++v) {
                if (at(P_AUX_ACKED, v) != 2) continue;
                int n = 0;
                for (int r = 0; r < R; ++r) n += has_op(r, v);
                ok = ok && n > 0;
            }
        if (mask & (1 << I_ACKNOWLEDGED_WRITES_EXIST_ON_MAJORITY))
            for (int v = 0; v < V; ++v) {
                if (at(P_AUX_ACKED, v) != 2) continue;
                int n = 0;
                for (int r = 0; r < R; ++r) n += has_op(r, v);
                ok = ok && n >= R / 2 + 1;
            }
        if (mask & (1 << I_COMMIT_NUMBER_NEVER_HIGHER_THAN_OP_NUMBER))
            for (int r = 0; r < R; ++r)
                ok = ok && at(P_COMMIT, r) <= at(P_OP, r);
        if (mask & (1 << I_ALL_REPLICAS_MOVE_TO_SAME_VIEW)) {
            // BlockedOnLastViewChange (ST03:877-881) or every progressing
            // replica Normal in the largest progressing view (ST03:884-898)
            bool blocked = false;
            if (at(P_AUX_SVC, 0) == timer_limit)
                for (int r = 0; r < R; ++r) {
                    int n = 0;
                    for (int j = 0; j < R; ++j)
                        n += primary(at(P_VIEW, j), R) == r + 1;
                    blocked = blocked || (at(P_NO_PROG, r) == 1 && n > R / 2);
                }
            int vmax = INT_MIN;
            for (int r = 0; r < R; ++r)
                vmax = imax(vmax, at(P_NO_PROG, r) == 0 ? at(P_VIEW, r) : -1);
            bool same = true;
            for (int r = 0; r < R; ++r)
                if (at(P_NO_PROG, r) == 0)
                    same = same && at(P_VIEW, r) == vmax &&
                           at(P_STATUS, r) == NORMAL;
            ok = ok && (blocked || same);
        }
        // TestInv holds
        return ok;
    }
};

// ----------------------------------------------------------------------
// the 16 actions (ST03:293-776): each updates the row in place, in the
// plain version's order, and returns the enabled bit
// ----------------------------------------------------------------------
__device__ bool timer_send_svc(St& g, int i, int timer_limit) {
    const int r = i + 1;
    const bool en = g.at(P_AUX_SVC, 0) < timer_limit && g.can_progress(i) &&
                    !g.normal_primary(i, r);
    const int new_view = wadd(g.at(P_VIEW, i), 1);
    g.at(P_VIEW, i) = new_view;
    g.at(P_STATUS, i) = VIEWCHANGE;
    g.reset_sent(i);
    g.at(P_AUX_SVC, 0) = wadd(g.at(P_AUX_SVC, 0), 1);
    g.row(M_SVC, new_view, 0, 0, 0, r, 0, 0);
    g.broadcast(r);
    return en;
}

// ReceiveHigherSVC / ReceiveHigherDVC (ST03:537-556, 616-635)
__device__ bool receive_higher(St& g, int k, int mtype) {
    const int i = g.msg_lane(k), r = g.mh[H_DEST];
    const bool en = g.recv_en(k, mtype) && g.can_progress(i) &&
                    g.mh[H_VIEW] > g.at(P_VIEW, i);
    g.at(P_VIEW, i) = g.mh[H_VIEW];
    g.at(P_STATUS, i) = VIEWCHANGE;
    g.reset_sent(i);
    g.discard(k);
    g.row(M_SVC, g.mh[H_VIEW], 0, 0, 0, r, 0, 0);
    g.broadcast(r);
    return en;
}

// ReceiveMatchingSVC / ReceiveMatchingDVC (ST03:558-575, 637-654)
__device__ bool receive_matching(St& g, int k, int mtype) {
    const int i = g.msg_lane(k);
    const bool en = g.recv_en(k, mtype) && g.can_progress(i) &&
                    g.at(P_STATUS, i) == VIEWCHANGE &&
                    g.mh[H_VIEW] == g.at(P_VIEW, i);
    g.discard(k);
    return en;
}

__device__ bool send_dvc(St& g, int i) {
    const int R = g.R, r = i + 1;
    const int view = g.at(P_VIEW, i), prim = primary(view, R);
    int tomb = 0;
    for (int m = 0; m < g.M; ++m) tomb += g.tombstone(m, i, M_SVC);
    const bool en = g.can_progress(i) && g.at(P_STATUS, i) == VIEWCHANGE &&
                    g.at(P_SENT_DVC, i) == 0 && tomb >= R / 2;
    g.at(P_SENT_DVC, i) = 1;
    g.row(M_DVC, view, g.at(P_OP, i), g.at(P_COMMIT, i), prim, r, 0,
          g.at(P_LNV, i));
    const int* l = g.log_row(i);
    for (int o = 0; o < g.OPS; ++o) g.rl[o] = l[o];
    // the new primary's own DVC is born processed (SendAsReceived)
    g.send(true, prim == r ? 0 : 1);
    return en;
}

__device__ bool send_sv(St& g, int i) {
    const int R = g.R, OPS = g.OPS, r = i + 1;
    const int view = g.at(P_VIEW, i);
    // HighestLog (ST03:676-697): among the valid DVCs, the maximal
    // (last normal view, op number) pair, ties to the least (commit,
    // log, source), the first such slot; the commit maximized alone
    int n_valid = 0, best_pair = INT_MIN, new_cn = INT_MIN;
    auto pair = [&](int m) {
        return wadd(wmul(g.hdr(m, H_LNV), OPS + 1), g.hdr(m, H_OP));
    };
    for (int m = 0; m < g.M; ++m) {
        const bool v = g.tombstone(m, i, M_DVC);
        n_valid += v;
        best_pair = imax(best_pair, v ? pair(m) : -1);
        new_cn = imax(new_cn, v ? g.hdr(m, H_COMMIT) : -1);
    }
    // key word t of slot m: commit, log[0..OPS-1], source
    auto key = [&](int m, int t) {
        if (t == 0) return g.hdr(m, H_COMMIT);
        if (t <= OPS) return g.m_log(m)[t - 1];
        return g.hdr(m, H_SRC);
    };
    int best = -1;
    for (int m = 0; m < g.M; ++m) {
        if (!(g.tombstone(m, i, M_DVC) && pair(m) == best_pair)) continue;
        bool less = best < 0;
        for (int t = 0; t < OPS + 2 && !less; ++t) {
            const int a = key(m, t), b = key(best, t);
            if (a != b) {
                less = a < b;
                break;
            }
        }
        if (less) best = m;
    }
    if (best < 0) best = 0;
    const bool en = g.can_progress(i) && g.at(P_STATUS, i) == VIEWCHANGE &&
                    g.at(P_SENT_SV, i) == 0 && n_valid >= R / 2 + 1;
    const int new_on = g.hdr(best, H_OP);
    g.row(M_SV, view, new_on, new_cn, 0, r, 0, 0);
    const int* bl = g.m_log(best);
    for (int o = 0; o < OPS; ++o) g.rl[o] = bl[o];
    g.at(P_STATUS, i) = NORMAL;
    int* l = g.log_row(i);
    for (int o = 0; o < OPS; ++o) l[o] = g.rl[o];
    g.at(P_OP, i) = new_on;
    for (int j = 0; j < R; ++j) g.peer(i, j) = 0;
    g.at(P_COMMIT, i) = new_cn;
    g.at(P_SENT_SV, i) = 1;
    g.at(P_LNV, i) = view;
    g.broadcast(r);
    return en;
}

__device__ bool receive_sv(St& g, int k) {
    const int i = g.msg_lane(k), r = g.mh[H_DEST];
    const int hv = g.mh[H_VIEW], v = g.at(P_VIEW, i);
    const bool en = g.recv_en(k, M_SV) && g.can_progress(i) &&
                    ((hv == v && g.at(P_STATUS, i) == VIEWCHANGE) || hv > v);
    const int old_commit = g.at(P_COMMIT, i);
    g.at(P_STATUS, i) = NORMAL;
    g.at(P_VIEW, i) = hv;
    int* l = g.log_row(i);
    const int* ml = g.m_log(k);
    for (int o = 0; o < g.OPS; ++o) l[o] = ml[o];
    g.at(P_OP, i) = g.mh[H_OP];
    g.at(P_COMMIT, i) = g.mh[H_COMMIT];
    g.at(P_LNV, i) = hv;
    g.reset_sent(i);
    g.discard(k);
    g.row(M_PREPAREOK, hv, g.mh[H_OP], 0, primary(hv, g.R), r, 0, 0);
    g.send(old_commit < g.mh[H_OP], 1);
    return en;
}

__device__ bool receive_client_request(St& g, int lane) {
    const int i = lane / g.V, vid = lane - i * g.V + 1, r = i + 1;
    const bool en = g.can_progress(i) && g.normal_primary(i, r) &&
                    g.at(P_AUX_ACKED, vid - 1) == 0;
    const int opn = wadd(g.at(P_OP, i), 1);
    g.log_row(i)[clipi(wsub(opn, 1), 0, g.OPS - 1)] = vid;
    g.at(P_OP, i) = opn;
    g.at(P_AUX_ACKED, vid - 1) = 1;
    g.row(M_PREPARE, g.at(P_VIEW, i), opn, g.at(P_COMMIT, i), 0, r, 0, 0);
    g.re = vid;
    g.broadcast(r);
    return en;
}

__device__ bool receive_prepare(St& g, int k) {
    const int i = g.msg_lane(k), r = g.mh[H_DEST];
    const int view = g.at(P_VIEW, i);
    const bool en = g.recv_en(k, M_PREPARE) && g.can_progress(i) &&
                    !g.normal_primary(i, r) && g.at(P_STATUS, i) == NORMAL &&
                    g.mh[H_VIEW] == view &&
                    g.mh[H_OP] == wadd(g.at(P_OP, i), 1);
    g.log_row(i)[clipi(wsub(g.mh[H_OP], 1), 0, g.OPS - 1)] =
        g.at(P_M_ENTRY, k);
    g.at(P_OP, i) = g.mh[H_OP];
    g.at(P_COMMIT, i) = g.mh[H_COMMIT];
    g.discard(k);
    g.row(M_PREPAREOK, view, g.mh[H_OP], 0, g.mh[H_SRC], r, 0, 0);
    g.send(true, 1);
    return en;
}

__device__ bool receive_prepare_ok(St& g, int k) {
    const int i = g.msg_lane(k), r = g.mh[H_DEST];
    const int j = clipi(wsub(g.mh[H_SRC], 1), 0, g.R - 1);
    const bool en = g.recv_en(k, M_PREPAREOK) && g.can_progress(i) &&
                    g.normal_primary(i, r) &&
                    g.mh[H_VIEW] == g.at(P_VIEW, i) &&
                    g.mh[H_OP] > g.peer(i, j);
    g.peer(i, j) = g.mh[H_OP];
    g.discard(k);
    return en;
}

__device__ bool execute_op(St& g, int i) {
    const int r = i + 1;
    const int opn = wadd(g.at(P_COMMIT, i), 1);
    int n = 0;
    for (int j = 0; j < g.R; ++j) n += g.peer(i, j) >= opn;
    const bool en = g.can_progress(i) && g.normal_primary(i, r) &&
                    g.at(P_COMMIT, i) < g.at(P_OP, i) && n >= g.R / 2;
    const int vid = g.log_row(i)[clipi(wsub(opn, 1), 0, g.OPS - 1)];
    g.at(P_COMMIT, i) = opn;
    g.at(P_AUX_ACKED, clipi(wsub(vid, 1), 0, g.V - 1)) = 2;
    return en;
}

__device__ bool send_get_state(St& g, int k) {
    const int i = g.msg_lane(k), r = g.mh[H_DEST];
    // asks from the replica's commit number and keeps its log; SendOnce:
    // enabled only if the record is not in the bag at all
    g.row(M_GETSTATE, g.mh[H_VIEW], g.at(P_COMMIT, i), 0, ANYDEST, i + 1, 0,
          0);
    const bool en = g.recv_en(k, M_PREPARE) && g.can_progress(i) &&
                    !g.normal_primary(i, r) && g.at(P_STATUS, i) == NORMAL &&
                    g.mh[H_VIEW] > g.at(P_VIEW, i) &&
                    g.mh[H_OP] > wadd(g.at(P_OP, i), 1) && !g.any_eq();
    g.at(P_STATUS, i) = STATETRANSFER;
    g.send(true, 1);
    return en;
}

__device__ bool receive_get_state(St& g, int lane) {
    const int k = lane / g.R, i = lane - k * g.R, r = i + 1;
    g.msg_lane(k);
    const int dest = g.mh[H_DEST], op_i = g.at(P_OP, i);
    const bool en = g.at(P_M_PRESENT, k) == 1 && g.at(P_M_COUNT, k) > 0 &&
                    g.mh[H_TYPE] == M_GETSTATE &&
                    (dest == r || (dest == ANYDEST && g.mh[H_SRC] != r)) &&
                    g.can_progress(i) && g.at(P_STATUS, i) == NORMAL &&
                    g.at(P_VIEW, i) == g.mh[H_VIEW] && op_i > g.mh[H_OP];
    // the log slice m.op_number+1 .. rep_op_number[r], re-based to 0
    const int first = wadd(g.mh[H_OP], 1), n = wsub(op_i, g.mh[H_OP]);
    g.row(M_NEWSTATE, g.at(P_VIEW, i), op_i, g.at(P_COMMIT, i), g.mh[H_SRC],
          r, first, 0);
    const int* l = g.log_row(i);
    for (int o = 0; o < g.OPS; ++o)
        g.rl[o] = o < n ? l[clipl((long long)o + wsub(first, 1), 0,
                                  g.OPS - 1)] : 0;
    g.discard(k);
    g.send(true, 1);
    return en;
}

__device__ bool receive_new_state(St& g, int k) {
    const int i = g.msg_lane(k);
    const bool en = g.recv_en(k, M_NEWSTATE) && g.can_progress(i) &&
                    g.at(P_STATUS, i) == STATETRANSFER &&
                    g.mh[H_VIEW] > g.at(P_VIEW, i);
    // the new log over 1..m.op_number: the replica's own prefix below
    // first_op, the message's suffix (stored re-based at 0) from there
    const int first1 = wsub(g.mh[H_FIRST], 1);
    int* l = g.log_row(i);
    const int* ml = g.m_log(k);
    for (int o = 0; o < g.OPS; ++o)
        if (!(o < first1))
            l[o] = o < g.mh[H_OP]
                       ? ml[clipl((long long)o - first1, 0, g.OPS - 1)] : 0;
    g.at(P_STATUS, i) = NORMAL;
    g.at(P_VIEW, i) = g.mh[H_VIEW];
    g.at(P_LNV, i) = g.mh[H_VIEW];
    g.at(P_OP, i) = g.mh[H_OP];
    g.at(P_COMMIT, i) = g.mh[H_COMMIT];
    g.discard(k);
    return en;
}

__device__ bool no_progress_change(St& g, int mask, int np_limit) {
    int n = 0;
    for (int r = 0; r < g.R; ++r) n += (mask >> r) & 1;
    const bool en = g.at(P_NP_CTR, 0) < np_limit && n <= g.R / 2;
    for (int r = 0; r < g.R; ++r) g.at(P_NO_PROG, r) = (mask >> r) & 1;
    g.at(P_NP_CTR, 0) = wadd(g.at(P_NP_CTR, 0), 1);
    return en;
}

// the replica a lane's action mutates (lane_replica), from the parent
__device__ int lane_replica(const St& g, int a, int lane) {
    switch (a) {
    case A_TIMER_SEND_SVC: case A_SEND_DVC: case A_SEND_SV:
    case A_EXECUTE_OP:
        return lane;
    case A_NO_PROGRESS_CHANGE:
        return 0;
    case A_RECEIVE_CLIENT_REQUEST:
        return lane / g.V;
    case A_RECEIVE_GET_STATE:
        return lane % g.R;
    default:
        return clipi(wsub(g.hdr(lane, H_DEST), 1), 0, g.R - 1);
    }
}

__device__ bool apply(St& g, int a, int lane, int timer_limit,
                      int np_limit) {
    switch (a) {
    case A_TIMER_SEND_SVC: return timer_send_svc(g, lane, timer_limit);
    case A_RECEIVE_HIGHER_SVC: return receive_higher(g, lane, M_SVC);
    case A_RECEIVE_MATCHING_SVC: return receive_matching(g, lane, M_SVC);
    case A_SEND_DVC: return send_dvc(g, lane);
    case A_RECEIVE_HIGHER_DVC: return receive_higher(g, lane, M_DVC);
    case A_RECEIVE_MATCHING_DVC: return receive_matching(g, lane, M_DVC);
    case A_SEND_SV: return send_sv(g, lane);
    case A_RECEIVE_SV: return receive_sv(g, lane);
    case A_RECEIVE_CLIENT_REQUEST: return receive_client_request(g, lane);
    case A_RECEIVE_PREPARE: return receive_prepare(g, lane);
    case A_RECEIVE_PREPARE_OK: return receive_prepare_ok(g, lane);
    case A_EXECUTE_OP: return execute_op(g, lane);
    case A_SEND_GET_STATE: return send_get_state(g, lane);
    case A_RECEIVE_GET_STATE: return receive_get_state(g, lane);
    case A_RECEIVE_NEW_STATE: return receive_new_state(g, lane);
    case A_NO_PROGRESS_CHANGE: return no_progress_change(g, lane, np_limit);
    }
    return false;
}

__global__ void actions_kernel(
        const int* __restrict__ flat, int lanes,
        const int* __restrict__ pidx, const int* __restrict__ aid,
        const int* __restrict__ lane_of, const int* __restrict__ planes,
        int R, int V, int M, int OPS, int NHDR, int timer_limit,
        int np_limit, int inv_mask, const long long* __restrict__ halt,
        int* __restrict__ succ, uint8_t* __restrict__ en2,
        int* __restrict__ err, int* __restrict__ ts, int* __restrict__ tn,
        int* __restrict__ ri, uint8_t* __restrict__ iok) {
    if (halt && *halt) return;
    int* row = tpuvsr_st03_smem;
    const size_t n = blockIdx.x;
    const int* src = flat + (size_t)pidx[n] * lanes;
    for (int l = threadIdx.x; l < lanes; l += blockDim.x) row[l] = src[l];
    __syncthreads();
    if (threadIdx.x == 0) {
        int* scratch = row + lanes;
        St g;
        g.s = row;
        g.off = planes;
        g.R = R; g.V = V; g.M = M; g.OPS = OPS; g.NHDR = NHDR;
        g.mh = scratch;
        g.rh = g.mh + NHDR;
        g.rl = g.rh + NHDR;
        g.ts = g.rl + OPS;
        g.re = 0;
        for (int t = 0; t <= R; ++t) g.ts[t] = -1;
        g.tn = 0;
        const int a = aid[n], lane = lane_of[n];
        ri[n] = lane_replica(g, a, lane);
        en2[n] = apply(g, a, lane, timer_limit, np_limit);
        err[n] = g.at(P_ERR, 0);
        for (int t = 0; t <= R; ++t) ts[n * (R + 1) + t] = g.ts[t];
        tn[n] = g.tn;
        iok[n] = g.invariants(inv_mask, timer_limit);
    }
    __syncthreads();
    int* dst = succ + n * lanes;
    for (int l = threadIdx.x; l < lanes; l += blockDim.x) dst[l] = row[l];
}

}  // namespace

// flat: [T, lanes] int32 parent rows; pidx, aid, lane: [N] int32 work
// queue; planes: [N_ST03_PLANES] int32 plane offsets (ALL_KEYS order);
// halt: one int64 word or null; succ: [N, lanes] int32; en2, iok: [N]
// uint8; err, tn, ri: [N] int32; ts: [N, R + 1] int32.
TPUVSR_EXPORT int tpuvsr_st03_actions(
        const void* flat, int lanes, const void* pidx, const void* aid,
        const void* lane, int N, const void* planes, int R, int V, int M,
        int OPS, int NHDR, int timer_limit, int np_limit, int inv_mask,
        const void* halt, void* succ, void* en2, void* err, void* ts,
        void* tn, void* ri, void* iok, void* stream) {
    if (N > 0) {
        // the row and the scratch words of one block
        const size_t smem = (size_t)(lanes + 2 * NHDR + OPS + R + 1) *
                            sizeof(int);
        if (NHDR < N_ROWHDR || smem > 48 * 1024)
            return (int)cudaErrorInvalidValue;
        cudaStream_t st = (cudaStream_t)stream;
        KLAUNCH_SMEM(actions_kernel, N, THREADS, smem, st,
            (const int*)flat, lanes, (const int*)pidx, (const int*)aid,
            (const int*)lane, (const int*)planes, R, V, M, OPS, NHDR,
            timer_limit, np_limit, inv_mask, (const long long*)halt,
            (int*)succ, (uint8_t*)en2, (int*)err, (int*)ts, (int*)tn,
            (int*)ri, (uint8_t*)iok);
    }
    return (int)cudaGetLastError();
}
