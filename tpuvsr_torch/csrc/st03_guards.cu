// K13: the guard matrix of the ST03 (VR_STATE_TRANSFER) family: ST03,
// A01 (VR_ASSUME_NEWVIEWCHANGE), I01 (VR_INC_RESEND), AS04
// (VR_APP_STATE), RR05 (VR_REPLICA_RECOVERY), AL05
// (VR_REPLICA_RECOVERY_ASYNC_LOG) and CP06 (VR_REPLICA_RECOVERY_CP).
//
// Replaces tpuvsr/engine/device_bfs.py:_guard_matrix (:398), the vmapped
// sweep of the guards of tpuvsr/models/st03_kernel.py:578-710 over every
// (state, lane) of a batch, and the guards the family's kernels replace
// or add: tpuvsr/models/a01_kernel.py:61,71 (TimerSendSVC, ReceiveSV),
// i01_kernel.py:150,173,253,303,340 (TimerSendSVC, ResendSVC,
// ReceiveMatchingDVC, SendSV, ReceivePrepareMsg), as04_kernel.py:
// 319,324 (ReceiveMatchingSVC, SendSV), rr05_kernel.py:132,141,150,159
// (the not-Recovering conjunct), :189, :212, :245, :279, :308 (Crash and
// the four other recovery actions), al05_kernel.py:102 (Crash over
// R x (MAX_OPS + 1) lanes) and cp06_kernel.py:183-664 (CP06's guards).  The port's plain version is the
// loop over the model's _guard_fns (models/st03_kernel.py and its
// subclasses); this kernel computes the same [B, n_lanes] enabled matrix
// (lane-table order: action-major, then the action's lane parameter)
// and en_any[b] = OR over the row.
//
// The family.  The kernel is a template on the model, with one entry
// point each (tpuvsr_st03_guards, tpuvsr_a01_guards, tpuvsr_i01_guards,
// tpuvsr_as04_guards, tpuvsr_rr05_guards, tpuvsr_al05_guards,
// tpuvsr_cp06_guards); a
// model's deltas are if-constexpr branches, so
// ST03's instantiation does ST03's work alone.  The host's lane table
// names each lane's action by its family id (enum Action, then
// FamilyAction in csrc/st03_actions.cu: A01 and I01 drop and add
// actions, so their ids do not line up with ST03's), and the plane
// table locates the family planes after ST03's (FamilyPlane; a plane the
// model lacks is never read).  A01 blocks TimerSendSVC for the primary
// whatever its status and takes any StartView of a view not below its
// own; I01 adds NotInPhaseSVC to TimerSendSVC, counts SendSV's quorum
// over the valid (view >= own) DVC tracker entries, registers a matching
// DVC whatever its status, drops ReceivePrepareMsg's primary exemption
// and has ResendSVC, one lane per (replica, peer) pair, whose guard
// scans the bag twice; AS04 counts SendSV's quorum over its DVC slots
// and asks sent_dvc = FALSE of ReceiveMatchingSVC (so do RR05 and AL05,
// which build on it).  RR05 and AL05 keep a Recovering replica out of
// TimerSendSVC, ReceiveHigherSVC, ReceiveHigherDVC and ReceiveSV, and add
// Crash (while aux_restart < CrashLimit; AL05: one lane per surviving
// prefix length, at most the replica's op), ReceiveRecoveryMsg (a Normal
// receiver), ReceiveRecoveryResponseMsg (a Recovering receiver with the
// message's nonce), CompleteRecovery (a majority of responses, one with
// a log in the highest view) and RetryRecovery (RR05: a majority, none
// with a log in the highest view, and no present undelivered message
// with the nonce that can still bring one: a scan of the bag a lane).
// CP06 (cp_recovery_guard and the CP06 branches of guard) adds the
// checkpoint lane dimension C = OPS + 1 to SendDVC and Crash (i * C + cp),
// ReceiveGetState and ReceiveGetCheckpointMsg (k * R * C + i * C + cp) and
// ReceiveRecoveryMsg (k * C + cp), cp in HighestGCedOp + 1 .. commit for a
// GC'd reply (0 .. commit for Crash and ReceiveGetCheckpointMsg) or 0
// for a suffix reply; Crash's SendOnce scans for its GetCheckpoint
// (checkpoint plane included), ReceiveNewState asks the replica's own
// view, and its recovery guards do not ask CanProgress.
//
// ST03's guards, against VSR's (K6, csrc/vsr_guards.cu): every guard
// but NoProgressChange's asks CanProgress of its replica (no_prog = 0);
// SendDVC and SendSV count processed (count-0) SVC and DVC records in
// the bag instead of per-replica sets; ReceiveGetState's lanes are
// (slot, receiving replica) pairs, since a GetState sent to AnyDest (-1)
// goes to any replica but its sender; SendGetState's SendOnce scans the
// M slots for the record it would send; NoProgressChange has a lane per
// subset of the replicas (1 << R lanes), enabled for the minority
// subsets while the counter is below its limit.
//
// What bounds it on the H100: neither bytes nor operations at the
// engine's sizes (a tile of 128 rows of a few hundred lanes): each row
// is read once and each guard is a handful of compares, except the
// quorum counts (M slots per replica lane) and SendGetState's SendOnce
// scan (M slots per slot lane).  A launch is latency-bound.
//
// Design, that of K6.  One block per state row: the block copies the
// row into shared memory (coalesced), then each thread evaluates the
// guards of its lanes from shared memory, the lane -> (action,
// parameter) pair read from the host-built lane tables, the planes
// located by the host-built plane-offset table (enum Plane below,
// GUARD_PLANES in models/st03_kernel.py).  en_any is an OR across the
// block.  Integer arithmetic wraps as int32 does in PyTorch; the primary
// of a view keeps torch.remainder's floor modulo.  With a halt word (the
// fused pass's carry) the kernel does nothing while it is set.
#include "common.cuh"

namespace {

enum Plane {
    P_STATUS, P_VIEW, P_OP, P_COMMIT, P_PEER_OP, P_SENT_DVC, P_SENT_SV,
    P_NO_PROG, P_NP_CTR, P_M_PRESENT, P_M_COUNT, P_M_HDR, P_M_ENTRY,
    P_M_LOG, P_AUX_SVC, P_AUX_ACKED, N_PLANES
};

// the family's planes K13 reads (FAMILY_GUARD_PLANES)
enum FamilyPlane {
    P_SENT_SVC = N_PLANES, P_DVC, P_DVC_VIEW, P_REC_NUMBER, P_REC,
    P_REC_VIEW, P_REC_HAS_LOG, P_AUX_RESTART, P_LOG, P_M_CP, N_FAMILY_PLANES
};

// the models (one instantiation and entry point each)
enum Model {
    MODEL_ST03, MODEL_A01, MODEL_I01, MODEL_AS04, MODEL_RR05, MODEL_AL05,
    MODEL_CP06
};

// the family ids of the actions beyond ST03's (csrc/st03_actions.cu enum
// FamilyAction)
constexpr int A_RESEND_SVC = 16, A_CRASH = 17, A_RECEIVE_RECOVERY = 18,
              A_RECEIVE_RECOVERY_RESPONSE = 19, A_COMPLETE_RECOVERY = 20,
              A_RETRY_RECOVERY = 21, A_RECEIVE_GET_CHECKPOINT = 22,
              A_RECEIVE_NEW_CHECKPOINT = 23;

// the codec's encodings (models/st03.py, models/rr05.py, models/cp06.py,
// models/vsr.py)
constexpr int NORMAL = 0, VIEWCHANGE = 1, STATETRANSFER = 2, RECOVERING = 3;
constexpr int M_PREPARE = 1, M_PREPAREOK = 2, M_SVC = 3, M_DVC = 4,
              M_SV = 5, M_GETSTATE = 6, M_NEWSTATE = 7, M_RECOVERY = 8,
              M_RECOVERYRESP = 9, M_GETCP = 10, M_NEWCP = 11;
constexpr int H_TYPE = 0, H_VIEW = 1, H_OP = 2, H_COMMIT = 3, H_DEST = 4,
              H_SRC = 5, H_X = 6;
constexpr int ANYDEST = -1;
constexpr int THREADS = 128;

struct Row {
    const int* s;       // the state row in shared memory
    const int* off;     // plane offsets
    int R, V, M, OPS, NHDR;

    __device__ int at(int p, int i) const { return s[off[p] + i]; }
    __device__ int hdr(int k, int col) const {
        return s[off[P_M_HDR] + k * NHDR + col];
    }
};

__device__ __forceinline__ int wadd(int a, int b) {
    return (int)((unsigned)a + (unsigned)b);
}

__device__ __forceinline__ int clipi(int x, int lo, int hi) {
    return x < lo ? lo : (x > hi ? hi : x);
}

// 1 + (view - 1) mod R with a floor modulo (torch.remainder)
__device__ __forceinline__ int primary(int view, int R) {
    int x = wadd(view, -1) % R;
    if (x < 0) x += R;
    return 1 + x;
}

__device__ __forceinline__ int dest_rep(const Row& g, int k) {
    return clipi(wadd(g.hdr(k, H_DEST), -1), 0, g.R - 1);
}

__device__ __forceinline__ bool can_progress(const Row& g, int i) {
    return g.at(P_NO_PROG, i) == 0;
}

// replica i is the Normal primary of its view, named r
__device__ __forceinline__ bool normal_primary(const Row& g, int i, int r) {
    return primary(g.at(P_VIEW, i), g.R) == r && g.at(P_STATUS, i) == NORMAL;
}

// a deliverable mtype record, whatever its receiver's CanProgress (CP06's
// recovery guards do not ask it)
__device__ bool recv_any(const Row& g, int k, int mtype) {
    return g.at(P_M_PRESENT, k) == 1 && g.at(P_M_COUNT, k) > 0 &&
           g.hdr(k, H_TYPE) == mtype;
}

// a deliverable mtype record whose receiver can progress
__device__ bool recv(const Row& g, int k, int mtype) {
    return recv_any(g, k, mtype) && can_progress(g, dest_rep(g, k));
}

// processed (count-0) mtype records addressed to replica r in its view
__device__ int tombstones(const Row& g, int r, int mtype) {
    int n = 0;
    const int view = g.at(P_VIEW, r);
    for (int m = 0; m < g.M; ++m)
        n += g.at(P_M_PRESENT, m) == 1 && g.at(P_M_COUNT, m) == 0 &&
             g.hdr(m, H_TYPE) == mtype && g.hdr(m, H_DEST) == r + 1 &&
             g.hdr(m, H_VIEW) == view;
    return n;
}

// (cp_plane: the bag has CP06's checkpoint plane, compared too)
__device__ bool send_get_state(const Row& g, int k, bool cp_plane) {
    const int i = dest_rep(g, k), r = g.hdr(k, H_DEST);
    const int view_i = g.at(P_VIEW, i);
    if (!(recv(g, k, M_PREPARE) && !normal_primary(g, i, r) &&
          g.at(P_STATUS, i) == NORMAL && g.hdr(k, H_VIEW) > view_i &&
          g.hdr(k, H_OP) > wadd(g.at(P_OP, i), 1)))
        return false;
    // SendOnce: the record [GetState, view of k, op = commit of i, dest
    // AnyDest, source i + 1, every other field 0] in the bag at all
    const int want_op = g.at(P_COMMIT, i);
    for (int s = 0; s < g.M; ++s) {
        if (g.at(P_M_PRESENT, s) != 1 || g.at(P_M_ENTRY, s) != 0) continue;
        bool eq = true;
        for (int c = 0; c < g.NHDR && eq; ++c) {
            const int want = c == H_TYPE ? M_GETSTATE
                             : c == H_VIEW ? g.hdr(k, H_VIEW)
                             : c == H_OP ? want_op
                             : c == H_DEST ? ANYDEST
                             : c == H_SRC ? i + 1 : 0;
            eq = g.hdr(s, c) == want;
        }
        for (int o = 0; o < g.OPS && eq; ++o)
            eq = g.at(P_M_LOG, s * g.OPS + o) == 0 &&
                 (!cp_plane || g.at(P_M_CP, s * g.OPS + o) == 0);
        if (eq) return false;
    }
    return true;
}

// I01's ResendSVC (RequiresResend, I01:490-503), lane i * R + peer: the
// replica has sent an SVC in this view, none to the peer is undelivered
// (count 1) and none came back from the peer in this view
__device__ bool resend_svc(const Row& g, int lane) {
    const int i = lane / g.R, p = lane - i * g.R, r = i + 1, peer = p + 1;
    if (!(can_progress(g, i) && r != peer && g.at(P_SENT_SVC, i) == 1))
        return false;
    const int view = g.at(P_VIEW, i);
    for (int m = 0; m < g.M; ++m) {
        if (g.at(P_M_PRESENT, m) != 1 || g.hdr(m, H_TYPE) != M_SVC ||
                g.hdr(m, H_VIEW) != view)
            continue;
        const int dest = g.hdr(m, H_DEST), src = g.hdr(m, H_SRC);
        if (dest == peer && src == r && g.at(P_M_COUNT, m) == 1)
            return false;
        if (dest == r && src == peer) return false;
    }
    return true;
}

// RR05's response slots of replica i: a majority has responded; *cand:
// one of them has a log in the highest view of all of them (_best_rec)
__device__ bool rec_quorum(const Row& g, int i, bool* cand) {
    int n = 0, vmax = -1;
    for (int j = 0; j < g.R; ++j) {
        const bool pres = g.at(P_REC, i * g.R + j) == 1;
        n += pres;
        if (pres && g.at(P_REC_VIEW, i * g.R + j) > vmax)
            vmax = g.at(P_REC_VIEW, i * g.R + j);
    }
    *cand = false;
    for (int j = 0; j < g.R; ++j)
        *cand = *cand || (g.at(P_REC, i * g.R + j) == 1 &&
                          g.at(P_REC_HAS_LOG, i * g.R + j) == 1 &&
                          g.at(P_REC_VIEW, i * g.R + j) == vmax);
    return n > g.R / 2;
}

// RetryRecovery's pending scan: a present, undelivered message with
// replica i's nonce that can still bring a response
__device__ bool rec_pending(const Row& g, int i) {
    const int x = g.at(P_REC_NUMBER, i);
    for (int m = 0; m < g.M; ++m) {
        if (g.at(P_M_PRESENT, m) != 1 || g.at(P_M_COUNT, m) <= 0 ||
                g.hdr(m, H_X) != x)
            continue;
        const int t = g.hdr(m, H_TYPE);
        if (t == M_RECOVERYRESP ||
                (t == M_RECOVERY && can_progress(g, dest_rep(g, m))))
            return true;
    }
    return false;
}

// CP06: HighestGCedOp of replica i's log (the largest 1-based position
// of a NoOp entry, id V + 1; 0 when none), and whether its entry at
// position o is NoOp
__device__ int hgc(const Row& g, int i) {
    int h = 0;
    for (int o = 0; o < g.OPS; ++o)
        if (g.at(P_LOG, i * g.OPS + o) == g.V + 1) h = o + 1;
    return h;
}

__device__ bool gced_at(const Row& g, int i, int o) {
    return g.at(P_LOG, i * g.OPS + clipi(o, 0, g.OPS - 1)) == g.V + 1;
}

// CP06's recovery guards: the checkpoint lane dimension C = OPS + 1
__device__ bool cp_recovery_guard(const Row& g, int a, int p,
                                  int crash_limit) {
    const int C = g.OPS + 1;
    switch (a) {
    case A_CRASH: {     // lane i * C + cp
        const int i = p / C, cp = p - i * C;
        if (!(g.at(P_AUX_RESTART, 0) < crash_limit &&
              cp <= g.at(P_COMMIT, i)))
            return false;
        // SendOnce: the record [GetCheckpoint, AnyDest, source i + 1,
        // every other field 0] in the bag at all
        for (int s = 0; s < g.M; ++s) {
            if (g.at(P_M_PRESENT, s) != 1 || g.at(P_M_ENTRY, s) != 0)
                continue;
            bool eq = true;
            for (int c = 0; c < g.NHDR && eq; ++c)
                eq = g.hdr(s, c) == (c == H_TYPE ? M_GETCP
                                     : c == H_DEST ? ANYDEST
                                     : c == H_SRC ? i + 1 : 0);
            for (int o = 0; o < g.OPS && eq; ++o)
                eq = g.at(P_M_LOG, s * g.OPS + o) == 0 &&
                     g.at(P_M_CP, s * g.OPS + o) == 0;
            if (eq) return false;
        }
        return true;
    }
    case A_RECEIVE_GET_CHECKPOINT: {    // lane k * R * C + i * C + cp
        const int k = p / (g.R * C), rest = p - k * g.R * C;
        const int i = rest / C, cp = rest - i * C, r = i + 1;
        const int dest = g.hdr(k, H_DEST);
        return recv_any(g, k, M_GETCP) &&
               (dest == r || (dest == ANYDEST && g.hdr(k, H_SRC) != r)) &&
               can_progress(g, i) && g.at(P_STATUS, i) != RECOVERING &&
               cp <= g.at(P_COMMIT, i);
    }
    case A_RECEIVE_NEW_CHECKPOINT:      // lane k
        return recv(g, p, M_NEWCP) &&
               g.at(P_STATUS, dest_rep(g, p)) == RECOVERING;
    case A_RECEIVE_RECOVERY: {          // lane k * C + cp
        const int k = p / C, cp = p - k * C, i = dest_rep(g, k);
        if (!(recv_any(g, k, M_RECOVERY) && g.at(P_STATUS, i) == NORMAL))
            return false;
        const int m_op = g.hdr(k, H_OP);
        const bool pg = normal_primary(g, i, g.hdr(k, H_DEST)) &&
                        g.at(P_OP, i) > m_op && gced_at(g, i, m_op);
        return pg ? cp >= hgc(g, i) + 1 && cp <= g.at(P_COMMIT, i)
                  : cp == 0;
    }
    case A_RECEIVE_RECOVERY_RESPONSE: {
        const int i = dest_rep(g, p);
        return recv_any(g, p, M_RECOVERYRESP) &&
               g.at(P_REC_NUMBER, i) == g.hdr(p, H_X) &&
               g.at(P_STATUS, i) == RECOVERING;
    }
    case A_COMPLETE_RECOVERY: {         // lane r
        bool cand;
        const bool q = rec_quorum(g, p, &cand);
        return g.at(P_STATUS, p) == RECOVERING && q && cand;
    }
    }
    return false;
}

// the recovery actions' guards (RR05, AL05)
template <int MODEL>
__device__ bool recovery_guard(const Row& g, int a, int p, int crash_limit) {
    if constexpr (MODEL == MODEL_CP06)
        return cp_recovery_guard(g, a, p, crash_limit);
    switch (a) {
    case A_CRASH: {     // lane r (AL05: r * (OPS + 1) + last_op)
        int i = p, last_op = 0;
        if constexpr (MODEL == MODEL_AL05) {
            i = p / (g.OPS + 1);
            last_op = p - i * (g.OPS + 1);
        }
        return g.at(P_AUX_RESTART, 0) < crash_limit && can_progress(g, i) &&
               (MODEL != MODEL_AL05 || last_op <= g.at(P_OP, i));
    }
    case A_RECEIVE_RECOVERY:        // lane k
        return recv(g, p, M_RECOVERY) &&
               g.at(P_STATUS, dest_rep(g, p)) == NORMAL;
    case A_RECEIVE_RECOVERY_RESPONSE: {
        const int i = dest_rep(g, p);
        return recv(g, p, M_RECOVERYRESP) &&
               g.at(P_REC_NUMBER, i) == g.hdr(p, H_X) &&
               g.at(P_STATUS, i) == RECOVERING;
    }
    case A_COMPLETE_RECOVERY: {     // lane r
        bool cand;
        const bool q = rec_quorum(g, p, &cand);
        return can_progress(g, p) && g.at(P_STATUS, p) == RECOVERING && q &&
               cand;
    }
    case A_RETRY_RECOVERY: {        // lane r
        if constexpr (MODEL != MODEL_RR05) return false;
        bool cand;
        const bool q = rec_quorum(g, p, &cand);
        return can_progress(g, p) && g.at(P_STATUS, p) == RECOVERING && q &&
               !cand && !rec_pending(g, p);
    }
    }
    return false;
}

template <int MODEL>
__device__ bool guard(const Row& g, int a, int p, int timer_limit,
                      int np_limit, int crash_limit) {
    constexpr bool A01_LIKE = MODEL == MODEL_A01 || MODEL == MODEL_I01;
    // AS04's app state and DVC slots (AS04, RR05, AL05, CP06)
    constexpr bool APP_STATE = MODEL == MODEL_AS04 || MODEL == MODEL_RR05 ||
                               MODEL == MODEL_AL05 || MODEL == MODEL_CP06;
    constexpr bool RECOVERY =
        MODEL == MODEL_RR05 || MODEL == MODEL_AL05 || MODEL == MODEL_CP06;
    // CP06's checkpoint lanes: SendDVC i * C + cp, ReceiveGetState
    // k * R * C + i * C + cp, cp in HighestGCedOp + 1 .. commit (the
    // GC'd reply) or 0 (the suffix reply)
    constexpr bool CP06 = MODEL == MODEL_CP06;
    const int R = g.R, C = g.OPS + 1;
    if constexpr (CP06) {
        if (a == 3) {       // SendDVC
            const int i = p / C, cp = p - i * C;
            return can_progress(g, i) && g.at(P_STATUS, i) == VIEWCHANGE &&
                   g.at(P_SENT_DVC, i) == 0 &&
                   tombstones(g, i, M_SVC) >= R / 2 &&
                   cp >= hgc(g, i) + 1 && cp <= g.at(P_COMMIT, i);
        }
        if (a == 13) {      // ReceiveGetState
            const int k = p / (R * C), rest = p - k * R * C;
            const int i = rest / C, cp = rest - i * C, r = i + 1;
            const int dest = g.hdr(k, H_DEST);
            if (!(g.at(P_M_PRESENT, k) == 1 && g.at(P_M_COUNT, k) > 0 &&
                  g.hdr(k, H_TYPE) == M_GETSTATE &&
                  (dest == r || (dest == ANYDEST && g.hdr(k, H_SRC) != r)) &&
                  can_progress(g, i) && g.at(P_STATUS, i) == NORMAL &&
                  g.at(P_VIEW, i) == g.hdr(k, H_VIEW) &&
                  g.at(P_OP, i) > g.hdr(k, H_OP)))
                return false;
            return gced_at(g, i, g.hdr(k, H_OP))
                ? cp >= hgc(g, i) + 1 && cp <= g.at(P_COMMIT, i) : cp == 0;
        }
        if (a == 14) {      // ReceiveNewState: of the replica's own view
            const int i = dest_rep(g, p);
            return recv(g, p, M_NEWSTATE) &&
                   g.at(P_STATUS, i) == STATETRANSFER &&
                   g.hdr(p, H_VIEW) == g.at(P_VIEW, i);
        }
    }
    if constexpr (RECOVERY) {
        if (a >= A_CRASH) return recovery_guard<MODEL>(g, a, p, crash_limit);
        // TimerSendSVC, ReceiveHigherSVC, ReceiveHigherDVC, ReceiveSV:
        // not for a Recovering replica (RR05:582, 606, 688, 798)
        if ((a == 0 && g.at(P_STATUS, p) == RECOVERING) ||
                ((a == 1 || a == 4 || a == 7) &&
                 g.at(P_STATUS, dest_rep(g, p)) == RECOVERING))
            return false;
    }
    switch (a) {
    case 0:     // TimerSendSVC, lane r
        if constexpr (A01_LIKE) {
            // blocked for the primary whatever its status; I01 adds
            // NotInPhaseSVC
            bool en = g.at(P_AUX_SVC, 0) < timer_limit &&
                      can_progress(g, p) &&
                      primary(g.at(P_VIEW, p), R) != p + 1;
            if constexpr (MODEL == MODEL_I01)
                en = en && (g.at(P_SENT_SVC, p) == 0 ||
                            g.at(P_SENT_DVC, p) == 1);
            return en;
        }
        return g.at(P_AUX_SVC, 0) < timer_limit && can_progress(g, p) &&
               !normal_primary(g, p, p + 1);
    case 1:     // ReceiveHigherSVC, lane k
        return recv(g, p, M_SVC) &&
               g.hdr(p, H_VIEW) > g.at(P_VIEW, dest_rep(g, p));
    case 2: {   // ReceiveMatchingSVC (AS04 on: and sent_dvc = FALSE)
        const int i = dest_rep(g, p);
        return recv(g, p, M_SVC) && g.at(P_STATUS, i) == VIEWCHANGE &&
               g.hdr(p, H_VIEW) == g.at(P_VIEW, i) &&
               (!APP_STATE || g.at(P_SENT_DVC, i) == 0);
    }
    case 3:     // SendDVC, lane r
        return can_progress(g, p) && g.at(P_STATUS, p) == VIEWCHANGE &&
               g.at(P_SENT_DVC, p) == 0 && tombstones(g, p, M_SVC) >= R / 2;
    case 4:     // ReceiveHigherDVC
        return recv(g, p, M_DVC) &&
               g.hdr(p, H_VIEW) > g.at(P_VIEW, dest_rep(g, p));
    case 5: {   // ReceiveMatchingDVC (I01: whatever the status)
        const int i = dest_rep(g, p);
        return recv(g, p, M_DVC) &&
               (MODEL == MODEL_I01 || g.at(P_STATUS, i) == VIEWCHANGE) &&
               g.hdr(p, H_VIEW) == g.at(P_VIEW, i);
    }
    case 6: {   // SendSV, lane r: a quorum of DVCs
        int n;
        if constexpr (MODEL == MODEL_I01) {
            // the valid (view >= own) tracker entries
            n = 0;
            for (int j = 0; j < R; ++j)
                n += g.at(P_DVC, p * R + j) == 1 &&
                     g.at(P_DVC_VIEW, p * R + j) >= g.at(P_VIEW, p);
        } else if constexpr (APP_STATE) {
            n = 0;      // the recv_dvc slots
            for (int j = 0; j < R; ++j) n += g.at(P_DVC, p * R + j) == 1;
        } else {
            n = tombstones(g, p, M_DVC);
        }
        return can_progress(g, p) && g.at(P_STATUS, p) == VIEWCHANGE &&
               g.at(P_SENT_SV, p) == 0 && n >= R / 2 + 1;
    }
    case 7: {   // ReceiveSV (A01, I01: any view not below its own)
        const int i = dest_rep(g, p);
        const int hv = g.hdr(p, H_VIEW), v = g.at(P_VIEW, i);
        if constexpr (A01_LIKE) return recv(g, p, M_SV) && hv >= v;
        return recv(g, p, M_SV) &&
               ((hv == v && g.at(P_STATUS, i) == VIEWCHANGE) || hv > v);
    }
    case 8: {   // ReceiveClientRequest, lane r * V + v
        const int r = p / g.V, v = p - r * g.V;
        return can_progress(g, r) && normal_primary(g, r, r + 1) &&
               g.at(P_AUX_ACKED, v) == 0;
    }
    case 9: {   // ReceivePrepareMsg (I01: no primary exemption)
        const int i = dest_rep(g, p);
        return recv(g, p, M_PREPARE) &&
               (MODEL == MODEL_I01 ||
                !normal_primary(g, i, g.hdr(p, H_DEST))) &&
               g.at(P_STATUS, i) == NORMAL &&
               g.hdr(p, H_VIEW) == g.at(P_VIEW, i) &&
               g.hdr(p, H_OP) == wadd(g.at(P_OP, i), 1);
    }
    case 10: {  // ReceivePrepareOkMsg
        const int i = dest_rep(g, p);
        const int j = clipi(wadd(g.hdr(p, H_SRC), -1), 0, R - 1);
        return recv(g, p, M_PREPAREOK) &&
               normal_primary(g, i, g.hdr(p, H_DEST)) &&
               g.hdr(p, H_VIEW) == g.at(P_VIEW, i) &&
               g.hdr(p, H_OP) > g.at(P_PEER_OP, i * R + j);
    }
    case 11: {  // ExecuteOp, lane r
        const int opn = wadd(g.at(P_COMMIT, p), 1);
        int n = 0;
        for (int j = 0; j < R; ++j) n += g.at(P_PEER_OP, p * R + j) >= opn;
        return can_progress(g, p) && normal_primary(g, p, p + 1) &&
               g.at(P_COMMIT, p) < g.at(P_OP, p) && n >= R / 2;
    }
    case 12:    // SendGetState, lane k
        return send_get_state(g, p, CP06);
    case 13: {  // ReceiveGetState, lane k * R + (receiver - 1)
        const int k = p / R, i = p - k * R, r = i + 1;
        const int dest = g.hdr(k, H_DEST);
        return g.at(P_M_PRESENT, k) == 1 && g.at(P_M_COUNT, k) > 0 &&
               g.hdr(k, H_TYPE) == M_GETSTATE &&
               (dest == r || (dest == ANYDEST && g.hdr(k, H_SRC) != r)) &&
               can_progress(g, i) && g.at(P_STATUS, i) == NORMAL &&
               g.at(P_VIEW, i) == g.hdr(k, H_VIEW) &&
               g.at(P_OP, i) > g.hdr(k, H_OP);
    }
    case 14: {  // ReceiveNewState
        const int i = dest_rep(g, p);
        return recv(g, p, M_NEWSTATE) &&
               g.at(P_STATUS, i) == STATETRANSFER &&
               g.hdr(p, H_VIEW) > g.at(P_VIEW, i);
    }
    case 15:    // NoProgressChange, lane = a subset of the replicas
        return g.at(P_NP_CTR, 0) < np_limit && __popc(p) <= R / 2;
    case A_RESEND_SVC:
        if constexpr (MODEL == MODEL_I01) return resend_svc(g, p);
        return false;
    }
    return false;
}

template <int MODEL>
__global__ void guards_kernel(const int* __restrict__ flat, int lanes,
                              int n_lanes, int R, int V, int M, int OPS,
                              int NHDR, int timer_limit, int np_limit,
                              int crash_limit,
                              const int* __restrict__ planes,
                              const int* __restrict__ lane_action,
                              const int* __restrict__ lane_param,
                              const long long* __restrict__ halt,
                              uint8_t* __restrict__ en,
                              uint8_t* __restrict__ en_any) {
    if (halt && *halt) return;
    extern __shared__ int row[];
    __shared__ int any;
    const int b = blockIdx.x;
    const int* src = flat + (size_t)b * lanes;
    for (int l = threadIdx.x; l < lanes; l += blockDim.x) row[l] = src[l];
    if (threadIdx.x == 0) any = 0;
    __syncthreads();
    Row g{row, planes, R, V, M, OPS, NHDR};
    int mine = 0;
    uint8_t* out = en + (size_t)b * n_lanes;
    for (int l = threadIdx.x; l < n_lanes; l += blockDim.x) {
        const bool e = guard<MODEL>(g, lane_action[l], lane_param[l],
                                    timer_limit, np_limit, crash_limit);
        out[l] = e;
        mine |= e;
    }
    if (mine) atomicOr(&any, 1);
    __syncthreads();
    if (threadIdx.x == 0) en_any[b] = any != 0;
}

template <int MODEL>
int launch_guards(const void* flat, int B, int lanes, int n_lanes, int R,
                  int V, int M, int OPS, int NHDR, int timer_limit,
                  int np_limit, int crash_limit, const void* planes,
                  const void* lane_action,
                  const void* lane_param, const void* halt, void* en,
                  void* en_any, void* stream) {
    if (B > 0) {
        const size_t smem = (size_t)lanes * sizeof(int);
        if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
        cudaStream_t st = (cudaStream_t)stream;
        KLAUNCH_SMEM(guards_kernel<MODEL>, B, THREADS, smem, st,
            (const int*)flat, lanes, n_lanes, R, V, M, OPS, NHDR,
            timer_limit, np_limit, crash_limit, (const int*)planes,
            (const int*)lane_action, (const int*)lane_param,
            (const long long*)halt, (uint8_t*)en, (uint8_t*)en_any);
    }
    return (int)cudaGetLastError();
}

}  // namespace

// flat: [B, lanes] int32 state rows; crash_limit: CrashLimit (0 without
// recovery); planes: [N_PLANES] int32 plane offsets (GUARD_PLANES order;
// [N_FAMILY_PLANES] for the other models, -1 for a plane the model
// lacks); lane_action (family action ids),
// lane_param: [n_lanes] int32; halt: one int64 word or null; en:
// [B, n_lanes] uint8; en_any: [B] uint8.  One entry point a model, all
// with this signature.
#define TPUVSR_GUARDS_ENTRY(name, MODEL)                                  \
    TPUVSR_EXPORT int tpuvsr_##name##_guards(                             \
            const void* flat, int B, int lanes, int n_lanes, int R, int V, \
            int M, int OPS, int NHDR, int timer_limit, int np_limit,      \
            int crash_limit, const void* planes, const void* lane_action, \
            const void* lane_param, const void* halt, void* en,           \
            void* en_any, void* stream) {                                 \
        return launch_guards<MODEL>(flat, B, lanes, n_lanes, R, V, M, OPS, \
                                    NHDR, timer_limit, np_limit,          \
                                    crash_limit, planes, lane_action,     \
                                    lane_param, halt, en, en_any,         \
                                    stream);                              \
    }

TPUVSR_GUARDS_ENTRY(st03, MODEL_ST03)
TPUVSR_GUARDS_ENTRY(a01, MODEL_A01)
TPUVSR_GUARDS_ENTRY(i01, MODEL_I01)
TPUVSR_GUARDS_ENTRY(as04, MODEL_AS04)
TPUVSR_GUARDS_ENTRY(rr05, MODEL_RR05)
TPUVSR_GUARDS_ENTRY(al05, MODEL_AL05)
TPUVSR_GUARDS_ENTRY(cp06, MODEL_CP06)
