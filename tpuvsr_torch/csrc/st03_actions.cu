// K14: the transition relation (successors and invariants) of the ST03
// (VR_STATE_TRANSFER) family: ST03, A01 (VR_ASSUME_NEWVIEWCHANGE), I01
// (VR_INC_RESEND), AS04 (VR_APP_STATE), RR05 (VR_REPLICA_RECOVERY), AL05
// (VR_REPLICA_RECOVERY_ASYNC_LOG) and CP06 (VR_REPLICA_RECOVERY_CP).
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
// The family.  The kernel is a template on the model, with one entry
// point each (tpuvsr_st03_actions, tpuvsr_a01_actions,
// tpuvsr_i01_actions, tpuvsr_as04_actions, tpuvsr_rr05_actions,
// tpuvsr_al05_actions, tpuvsr_cp06_actions), and replaces the action and
// invariant functions of tpuvsr/models/a01_kernel.py:53-117,
// i01_kernel.py:78-397, as04_kernel.py:76-346, rr05_kernel.py:88-313,
// al05_kernel.py:60-168 and cp06_kernel.py:155-759 as well.  A model's
// deltas are if-constexpr branches in the ST03 actions, so ST03's
// instantiation does ST03's work alone.  The family's planes follow
// N_ST03_PLANES (enum FamilyPlane: I01's third sent flag and DVC tracker,
// AS04's DVC slots and app plane, RR05's nonce, response slots and crash
// counter, AL05's prefix ceilings; the host's table gives -1 for a plane
// the model lacks, which is never read), its new actions follow
// N_ST03_ACTIONS (FamilyAction: I01's ResendSVC, RR05's five recovery
// actions), and its invariants follow N_INVARIANTS (FamilyInvariant).  A host-built table maps each
// model's action index to its family id (A01 drops the three
// state-transfer actions and I01 adds ResendSVC, so their ids do not
// line up with ST03's; AS04's PrimaryExecuteOp takes ExecuteOp's), and
// inv_mask carries the family's invariant bits.
//
// The deltas, by model.  A01: log entries are packed value_id << 8 |
// view (ReceiveClientRequest writes one, ExecuteOp reads the value id
// back, and the invariants look a value up by it), TimerSendSVC is
// blocked for the primary whatever its status, and ReceiveSV takes any
// view not below the replica's.  I01 (on A01): a view change adopts
// view + 1, the three sent flags, ResendSVC, the DVC tracker with
// replacement semantics (update_tracker), SendSV from the tracker's
// valid entries, ReceiveMatchingDVC whatever the status, no primary
// exemption in ReceivePrepareMsg.  AS04: every commit-advancing action
// appends the newly committed ops to the app plane (exec_ops), commit is
// never lowered, DVCs are counted in per-source slots cleared on every
// view adoption, and a second, different DVC from one source sets
// ERR_DVC_OVERFLOW.  RR05 (on AS04): packed entries as A01's, a fourth
// status (Recovering, 3) that TimerSendSVC, ReceiveHigherSVC,
// ReceiveHigherDVC and ReceiveSV exclude, and the recovery sub-protocol:
// Crash (wipe, a fresh nonce one above the largest RecoveryMsg x in the
// bag, a RecoveryMsg broadcast), ReceiveRecoveryMsg (a Normal replica
// answers; the primary attaches its log), ReceiveRecoveryResponseMsg (a
// per-source slot; a different second response sets ERR_REC_OVERFLOW),
// CompleteRecovery (the has-log response of the highest view) and
// RetryRecovery (a new nonce when no response can come).  AL05 (on
// RR05): plain entries again, a Crash lane per (replica, surviving
// prefix length), a response that carries the primary's suffix above
// the crashed replica's floor, and a CompleteRecovery that splices the
// replica's own prefix under it.  CP06 (on RR05, no RetryRecovery; its
// cp_* functions): plain entries and NoOp (V + 1) for a GC'd slot, an
// 11-column header (H_FLAG, H_CP) and a checkpoint plane m_cp that the
// record being sent carries too (rc: equality compares it, send stores
// it), a checkpoint lane dimension C = OPS + 1 (SendDVC and Crash lane
// i * C + cp, ReceiveGetState and ReceiveGetCheckpointMsg
// k * R * C + i * C + cp, ReceiveRecoveryMsg k * C + cp), replies and
// DoViewChanges in two forms (a checkpoint below cp and the suffix
// above it, or a suffix from first_op), ApplyCheckpoint, WinningDVC's
// checkpoint tie-break, GetCheckpoint -> NewCheckpoint -> Recovery, and
// invariants that read a NoOp slot through the app state (OpOf).
//
// The entry encoding switches twice down the chain (AS04 plain, RR05
// packed, AL05 and CP06 plain), so it is a property of its own
// (PACKED_ENTRIES), apart from A01's assume-mode guards (A01_LIKE), AS04's
// app state (APP_STATE), the recovery sub-protocol (RECOVERY) and CP06's
// checkpoints (CHECKPOINTS).
//
// K18, the state predicates (tpuvsr_<model>_state_pred, one entry point
// a model in the same template scheme), is in this file too, so that one
// definition of each invariant (St::invariants<MODEL>) serves K14's
// successors and the states themselves.  It replaces the batched
// invariant and predicate calls of the JAX liveness graph
// (tpuvsr/engine/device_liveness.py:383 _run_batched via :394
// batch_predicate) over the family's predicates (st03_kernel.py:911-954
// and the subclasses', e.g. as04_kernel.py:348, i01_kernel.py:399,
// cp06_kernel.py:757) and the engines' check of a state's own
// invariants.  For each of N flat rows it writes one int32 whose bit b
// is set iff entry b of the model's INVARIANT_FNS holds, for the bits of
// mask; fbit[b] is that entry's family bit (FamilyInvariant order), one
// St::invariants<MODEL> call a bit.  Bound and design as K18 of
// csrc/vsr_actions.cu: the bytes of the planes read, one thread a state
// on its row where it lies.
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

// the family's planes beyond ST03's (FAMILY_PLANES order)
enum FamilyPlane {
    P_SENT_SVC = N_ST03_PLANES, P_DVC, P_DVC_VIEW, P_DVC_LNV, P_DVC_OP,
    P_DVC_COMMIT, P_DVC_LOG, P_APP, P_REC_NUMBER, P_REC, P_REC_VIEW,
    P_REC_HAS_LOG, P_REC_LOG, P_REC_OP, P_REC_COMMIT, P_REC_CEIL,
    P_AUX_RESTART, P_DVC_CPN, P_DVC_CP, P_REC_FLAG, P_REC_FIRST, P_REC_CP,
    P_REC_CPN, P_M_CP, N_FAMILY_PLANES
};

// the family's actions beyond ST03's (FAMILY_ACTIONS order)
enum FamilyAction {
    A_RESEND_SVC = N_ST03_ACTIONS, A_CRASH, A_RECEIVE_RECOVERY,
    A_RECEIVE_RECOVERY_RESPONSE, A_COMPLETE_RECOVERY, A_RETRY_RECOVERY,
    A_RECEIVE_GET_CHECKPOINT, A_RECEIVE_NEW_CHECKPOINT, N_FAMILY_ACTIONS
};

// the family's invariants beyond ST03's (FAMILY_INVARIANTS order)
enum FamilyInvariant {
    I_NO_REPLICA_MORE_THAN_ONE_VIEW_AHEAD_OF_MAJORITY = N_INVARIANTS,
    I_RECEIVED_DVCS_ALL_SAME_VIEW, I_NO_APP_STATE_DIVERGENCE,
    I_COMMIT_NUMBER_MATCHES_APP_STATE, N_FAMILY_INVARIANTS
};

// the models (one instantiation and entry point each)
enum Model {
    MODEL_ST03, MODEL_A01, MODEL_I01, MODEL_AS04, MODEL_RR05, MODEL_AL05,
    MODEL_CP06
};

// A01's assume-mode guards (A01, I01)
template <int MODEL>
constexpr bool A01_LIKE = MODEL == MODEL_A01 || MODEL == MODEL_I01;
// log entries packed value_id << 8 | view (A01, I01, RR05)
template <int MODEL>
constexpr bool PACKED_ENTRIES = A01_LIKE<MODEL> || MODEL == MODEL_RR05;
// AS04's app state and DVC slots (AS04 and the models on it)
template <int MODEL>
constexpr bool APP_STATE = MODEL == MODEL_AS04 || MODEL == MODEL_RR05 ||
                           MODEL == MODEL_AL05 || MODEL == MODEL_CP06;
// the crash-recovery sub-protocol (RR05, AL05, CP06)
template <int MODEL>
constexpr bool RECOVERY =
    MODEL == MODEL_RR05 || MODEL == MODEL_AL05 || MODEL == MODEL_CP06;
// CP06's checkpoints: NoOp entries, a checkpoint lane dimension, the
// checkpoint fields of records and slots
template <int MODEL>
constexpr bool CHECKPOINTS = MODEL == MODEL_CP06;

// the codec's encodings (models/st03.py, models/vsr.py)
constexpr int NORMAL = 0, VIEWCHANGE = 1, STATETRANSFER = 2;
constexpr int RECOVERING = 3;               // the family's (models/rr05.py)
constexpr int M_PREPARE = 1, M_PREPAREOK = 2, M_SVC = 3, M_DVC = 4,
              M_SV = 5, M_GETSTATE = 6, M_NEWSTATE = 7, M_RECOVERY = 8,
              M_RECOVERYRESP = 9, M_GETCP = 10, M_NEWCP = 11;
constexpr int H_TYPE = 0, H_VIEW = 1, H_OP = 2, H_COMMIT = 3, H_DEST = 4,
              H_SRC = 5, H_X = 6, H_FIRST = 7, H_LNV = 8, N_ROWHDR = 9;
constexpr int H_FLAG = 9, H_CP = 10;        // CP06's header (NHDR 11)
constexpr int ANYDEST = -1;
constexpr int ERR_BAG_OVERFLOW = 1, ERR_DVC_OVERFLOW = 2,
              ERR_REC_OVERFLOW = 4;
constexpr int ENTRY_VIEW_BITS = 8;          // packed log entries
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

__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }

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
// record being sent (header rh, entry re, log rl and, for CP06, the
// checkpoint rc) and the touch list.
struct St {
    int* s;
    const int* off;
    int R, V, M, OPS, NHDR;
    int* mh;                        // [NHDR]
    int* rh;                        // [NHDR]
    int re;
    int* rl;                        // [OPS]
    int* rc;                        // [OPS], null without m_cp (not CP06)
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
    // a family [R, R] plane at (i, j), and the DVC log of slot (i, j)
    __device__ int& slot(int p, int i, int j) const {
        return s[off[p] + i * R + j];
    }
    __device__ int* dvc_log(int i, int j) const {
        return &s[off[P_DVC_LOG] + (i * R + j) * OPS];
    }
    __device__ int* app_row(int i) const { return &s[off[P_APP] + i * OPS]; }
    // the log of RR05's response slot (i, j)
    __device__ int* rec_log(int i, int j) const {
        return &s[off[P_REC_LOG] + (i * R + j) * OPS];
    }
    // CP06's checkpoint planes: of bag slot k, of DVC slot (i, j), of
    // response slot (i, j)
    __device__ int* m_cp(int k) const { return &s[off[P_M_CP] + k * OPS]; }
    __device__ int* dvc_cp(int i, int j) const {
        return &s[off[P_DVC_CP] + (i * R + j) * OPS];
    }
    __device__ int* rec_cp(int i, int j) const {
        return &s[off[P_REC_CP] + (i * R + j) * OPS];
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
        if (rc)
            for (int o = 0; o < OPS; ++o) rc[o] = 0;
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
        if (rc) {
            const int* c = m_cp(m);
            for (int o = 0; o < OPS; ++o)
                if (c[o] != rc[o]) return false;
        }
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
            if (rc) {
                int* c = m_cp(idx);
                for (int o = 0; o < OPS; ++o) c[o] = rc[o];
            }
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

    // ResetSentVars (I01's clears its third flag too)
    template <int MODEL>
    __device__ void reset_sent(int i) {
        if constexpr (MODEL == MODEL_I01) at(P_SENT_SVC, i) = 0;
        at(P_SENT_DVC, i) = 0;
        at(P_SENT_SV, i) = 0;
    }

    // -- I01's DVC tracker (I01:245-250) --------------------------------
    __device__ void clear_tracker(int i) {
        for (int j = 0; j < R; ++j) {
            slot(P_DVC, i, j) = 0;
            slot(P_DVC_VIEW, i, j) = 0;
            slot(P_DVC_LNV, i, j) = 0;
            slot(P_DVC_OP, i, j) = 0;
            slot(P_DVC_COMMIT, i, j) = 0;
            int* l = dvc_log(i, j);
            for (int o = 0; o < OPS; ++o) l[o] = 0;
        }
    }

    // UpdateDVCsTracker: with pred, drop the entries below vn and the
    // one from src_j (their fields to 0), then write the carrier into
    // slot src_j; without, only the fields of empty slots go to 0 (the
    // plain version's keep mask is then the occupancy)
    __device__ void update_tracker(int i, int vn, int src_j, int view,
                                   int lnv, int op, int commit,
                                   const int* log, bool pred) {
        for (int j = 0; j < R; ++j) {
            const bool had = slot(P_DVC, i, j) == 1;
            const bool keep = pred ? had && slot(P_DVC_VIEW, i, j) >= vn &&
                                         j != src_j
                                   : had;
            slot(P_DVC, i, j) = keep;
            if (keep) continue;
            slot(P_DVC_VIEW, i, j) = 0;
            slot(P_DVC_LNV, i, j) = 0;
            slot(P_DVC_OP, i, j) = 0;
            slot(P_DVC_COMMIT, i, j) = 0;
            int* l = dvc_log(i, j);
            for (int o = 0; o < OPS; ++o) l[o] = 0;
        }
        if (!pred) return;
        slot(P_DVC, i, src_j) = 1;
        slot(P_DVC_VIEW, i, src_j) = view;
        slot(P_DVC_LNV, i, src_j) = lnv;
        slot(P_DVC_OP, i, src_j) = op;
        slot(P_DVC_COMMIT, i, src_j) = commit;
        int* l = dvc_log(i, src_j);
        for (int o = 0; o < OPS; ++o) l[o] = log[o];
    }

    // -- AS04's DVC slots and app plane ---------------------------------
    // ResetVcVars' slot wipe (CP06's clears the checkpoint fields too)
    template <int MODEL>
    __device__ void clear_dvc(int i) {
        for (int j = 0; j < R; ++j) {
            slot(P_DVC, i, j) = 0;
            slot(P_DVC_LNV, i, j) = 0;
            slot(P_DVC_OP, i, j) = 0;
            slot(P_DVC_COMMIT, i, j) = 0;
            int* l = dvc_log(i, j);
            for (int o = 0; o < OPS; ++o) l[o] = 0;
            if constexpr (CHECKPOINTS<MODEL>) {
                slot(P_DVC_CPN, i, j) = 0;
                int* c = dvc_cp(i, j);
                for (int o = 0; o < OPS; ++o) c[o] = 0;
            }
        }
    }

    // set-union a DVC into slot (i, j): an equal record changes nothing,
    // a different one from the same source sets ERR_DVC_OVERFLOW
    __device__ void dvc_slot_add(int i, int j, int lnv, int op, int commit,
                                 const int* log, bool pred) {
        int* l = dvc_log(i, j);
        bool same = slot(P_DVC, i, j) == 1 && slot(P_DVC_LNV, i, j) == lnv &&
                    slot(P_DVC_OP, i, j) == op &&
                    slot(P_DVC_COMMIT, i, j) == commit;
        for (int o = 0; o < OPS && same; ++o) same = l[o] == log[o];
        const bool collide = pred && slot(P_DVC, i, j) == 1 && !same;
        if (pred) {
            slot(P_DVC, i, j) = 1;
            slot(P_DVC_LNV, i, j) = lnv;
            slot(P_DVC_OP, i, j) = op;
            slot(P_DVC_COMMIT, i, j) = commit;
            for (int o = 0; o < OPS; ++o) l[o] = log[o];
        }
        if (collide) at(P_ERR, 0) |= ERR_DVC_OVERFLOW;
    }

    // CP06: AS04's union (its collision test reads neither checkpoint
    // field), then the slot's checkpoint number and checkpoint
    __device__ void dvc_slot_add_cp(int i, int j, int lnv, int op,
                                    int commit, const int* log,
                                    const int* cp, int cpn, bool pred) {
        dvc_slot_add(i, j, lnv, op, commit, log, pred);
        if (!pred) return;
        slot(P_DVC_CPN, i, j) = cpn;
        int* c = dvc_cp(i, j);
        for (int o = 0; o < OPS; ++o) c[o] = cp[o];
    }

    // MaybeExecuteOps (AS04:277-282): past the commit, append lp[old..new)
    // to the app plane and raise the commit; never lower it
    __device__ void exec_ops(int i, const int* lp, int new_commit) {
        const int old = at(P_COMMIT, i);
        if (!(new_commit > old)) return;
        int* app = app_row(i);
        for (int o = 0; o < OPS; ++o)
            if (o >= old && o < new_commit) app[o] = lp[o];
        at(P_COMMIT, i) = new_commit;
    }

    // -- RR05's recovery slots ------------------------------------------
    // _clear_rec (AL05's clears the prefix ceilings too)
    template <int MODEL>
    __device__ void clear_rec(int i) {
        for (int j = 0; j < R; ++j) {
            slot(P_REC, i, j) = 0;
            slot(P_REC_VIEW, i, j) = 0;
            slot(P_REC_HAS_LOG, i, j) = 0;
            slot(P_REC_OP, i, j) = 0;
            slot(P_REC_COMMIT, i, j) = 0;
            if constexpr (MODEL == MODEL_AL05) slot(P_REC_CEIL, i, j) = 0;
            int* l = rec_log(i, j);
            for (int o = 0; o < OPS; ++o) l[o] = 0;
            if constexpr (CHECKPOINTS<MODEL>) {
                slot(P_REC_FLAG, i, j) = 0;
                slot(P_REC_FIRST, i, j) = 0;
                slot(P_REC_CPN, i, j) = 0;
                int* c = rec_cp(i, j);
                for (int o = 0; o < OPS; ++o) c[o] = 0;
            }
        }
    }

    // UniqueNumber (RR05:826-835): the largest x of the RecoveryMsgs in
    // the bag (0 for any other slot), plus one
    __device__ int unique_number() const {
        int u = INT_MIN;
        for (int m = 0; m < M; ++m)
            u = imax(u, at(P_M_PRESENT, m) == 1 &&
                            hdr(m, H_TYPE) == M_RECOVERY ? hdr(m, H_X) : 0);
        return wadd(u, 1);
    }

    // _best_rec (RR05:924-931): the first has-log response in the
    // highest view of all the responses (0 when none; *any says)
    __device__ int best_rec(int i, bool* any) const {
        int vmax = INT_MIN;
        for (int j = 0; j < R; ++j)
            vmax = imax(vmax, slot(P_REC, i, j) == 1 ? slot(P_REC_VIEW, i, j)
                                                      : -1);
        for (int j = 0; j < R; ++j)
            if (slot(P_REC, i, j) == 1 && slot(P_REC_HAS_LOG, i, j) == 1 &&
                    slot(P_REC_VIEW, i, j) == vmax) {
                *any = true;
                return j;
            }
        *any = false;
        return 0;
    }

    // a majority of the replicas have responded
    __device__ bool rec_quorum(int i) const {
        int n = 0;
        for (int j = 0; j < R; ++j) n += slot(P_REC, i, j) == 1;
        return n > R / 2;
    }

    // processed (count-0) mtype records addressed to replica i in its
    // view (_processed)
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

    // -- CP06's checkpoint helpers ------------------------------------------
    // HighestGCedOp (CP06:346-354): the largest 1-based position of a
    // NoOp entry (id V + 1), 0 when none
    __device__ int hgc(const int* l) const {
        int h = 0;
        for (int o = 0; o < OPS; ++o)
            if (l[o] == V + 1) h = o + 1;
        return h;
    }

    // LogSuffix re-based at 0 into out: source positions first - 1 on,
    // zero past the log's end
    __device__ void log_suffix(const int* l, int first, int* out) const {
        for (int o = 0; o < OPS; ++o) {
            const long long at = (long long)o + first - 1;
            out[o] = at < OPS ? l[clipl(at, 0, OPS - 1)] : 0;
        }
    }

    // cp_plane into out: the app state of replica i below position cp
    __device__ void checkpoint(int i, int cp, int* out) const {
        const int* app = app_row(i);
        for (int o = 0; o < OPS; ++o) out[o] = o < cp ? app[o] : 0;
    }

    // ApplyCheckpoint (CP06:383-402): NoOp below cpn, the suffix (re-based
    // at 0) up to opn, the app state the checkpoint below cpn and the
    // suffix up to new_commit; op and commit set (sfx and cp are not the
    // replica's log or app)
    __device__ void apply_checkpoint(int i, const int* sfx, const int* cp,
                                     int cpn, int opn, int new_commit) {
        int* l = log_row(i);
        int* app = app_row(i);
        for (int o = 0; o < OPS; ++o) {
            const int v = sfx[clipl((long long)o - cpn, 0, OPS - 1)];
            l[o] = o < cpn ? V + 1 : (o < opn ? v : 0);
            app[o] = o < cpn ? cp[o] : (o < new_commit ? v : 0);
        }
        at(P_OP, i) = opn;
        at(P_COMMIT, i) = new_commit;
    }

    // the log a NewState installs: own below first_op - 1, the suffix
    // (re-based at 0) up to op, into out (out may be own)
    __device__ void splice(const int* own, const int* sfx, int first,
                           int op, int* out) const {
        const int f1 = wsub(first, 1);
        for (int o = 0; o < OPS; ++o)
            out[o] = o < f1 ? own[o]
                : o < op ? sfx[clipl((long long)o - f1, 0, OPS - 1)] : 0;
    }

    // -- the invariants on this (the successor's) row ----------------------
    // OpOf (CP06:1219-1222): a NoOp log slot defers to the app state
    template <int MODEL>
    __device__ int op_of(int r, int o) const {
        const int e = log_row(r)[o];
        if constexpr (CHECKPOINTS<MODEL>)
            if (e == V + 1) return app_row(r)[o];
        return e;
    }

    // replica r's log holds an entry of value v (packed entries: by the
    // value id of the entry; CP06: through OpOf)
    template <int MODEL>
    __device__ int has_op(int r, int v) const {
        for (int o = 0; o < OPS; ++o) {
            const int e = op_of<MODEL>(r, o);
            const int vid = PACKED_ENTRIES<MODEL> ? e >> ENTRY_VIEW_BITS : e;
            if (vid == v + 1) return 1;
        }
        return 0;
    }

    template <int MODEL>
    __device__ bool invariants(int mask, int timer_limit) const {
        bool ok = true;
        if (mask & (1 << I_NO_LOG_DIVERGENCE))
            for (int a = 0; a < R; ++a)
                for (int b = 0; b < R; ++b)
                    for (int o = 0; o < OPS; ++o)
                        if (o < at(P_COMMIT, a) && o < at(P_COMMIT, b) &&
                                op_of<MODEL>(a, o) != op_of<MODEL>(b, o))
                            ok = false;
        if (mask & (1 << I_ACKNOWLEDGED_WRITE_NOT_LOST))
            for (int v = 0; v < V; ++v) {
                if (at(P_AUX_ACKED, v) != 2) continue;
                int n = 0;
                for (int r = 0; r < R; ++r) n += has_op<MODEL>(r, v);
                ok = ok && n > 0;
            }
        if (mask & (1 << I_ACKNOWLEDGED_WRITES_EXIST_ON_MAJORITY))
            for (int v = 0; v < V; ++v) {
                if (at(P_AUX_ACKED, v) != 2) continue;
                int n = 0;
                for (int r = 0; r < R; ++r) n += has_op<MODEL>(r, v);
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
        if (mask & (1 << I_NO_REPLICA_MORE_THAN_ONE_VIEW_AHEAD_OF_MAJORITY))
            // no replica with a majority of the others more than one view
            // behind it (I01:789-795)
            for (int r = 0; r < R; ++r) {
                int n = 0;
                for (int j = 0; j < R; ++j)
                    n += j != r && at(P_VIEW, j) < wsub(at(P_VIEW, r), 1);
                ok = ok && !(n > R / 2);
            }
        if (mask & (1 << I_RECEIVED_DVCS_ALL_SAME_VIEW))
            // no replica in a view change with tracker entries of two
            // views (I01:797-804)
            for (int r = 0; r < R; ++r) {
                bool mixed = false;
                for (int a = 0; a < R; ++a)
                    for (int b = 0; b < R; ++b)
                        mixed = mixed || (slot(P_DVC, r, a) == 1 &&
                                          slot(P_DVC, r, b) == 1 &&
                                          slot(P_DVC_VIEW, r, a) !=
                                              slot(P_DVC_VIEW, r, b));
                ok = ok && !(at(P_STATUS, r) == VIEWCHANGE && mixed);
            }
        if (mask & (1 << I_NO_APP_STATE_DIVERGENCE))
            // no two replicas, both committed at an op, whose app entries
            // differ there while the first's log agrees with its app
            // (AS04:852-865); CP06's asks no agreement of the log and
            // also fails on a committed NoOp app entry (CP06:1234-1240)
            for (int a = 0; a < R; ++a)
                for (int o = 0; o < OPS; ++o) {
                    if (!(o < at(P_COMMIT, a))) continue;
                    if (CHECKPOINTS<MODEL> && app_row(a)[o] == V + 1)
                        ok = false;
                    for (int b = 0; b < R; ++b)
                        if (o < at(P_COMMIT, b) &&
                                app_row(a)[o] != app_row(b)[o] &&
                                (CHECKPOINTS<MODEL> ||
                                 log_row(a)[o] == app_row(a)[o]))
                            ok = false;
                }
        if (mask & (1 << I_COMMIT_NUMBER_MATCHES_APP_STATE))
            // CP06:1279-1281 on the planes: app nonzero exactly below
            // the commit
            for (int r = 0; r < R; ++r)
                for (int o = 0; o < OPS; ++o)
                    ok = ok && (app_row(r)[o] != 0) == (o < at(P_COMMIT, r));
        // TestInv holds
        return ok;
    }
};

// ----------------------------------------------------------------------
// the actions (ST03:293-776 and the family's deltas): each updates the
// row in place, in the plain version's order, and returns the enabled
// bit
// ----------------------------------------------------------------------
template <int MODEL>
__device__ bool timer_send_svc(St& g, int i, int timer_limit) {
    const int r = i + 1;
    bool en = g.at(P_AUX_SVC, 0) < timer_limit && g.can_progress(i);
    if constexpr (A01_LIKE<MODEL>) {
        // blocked for the primary whatever its status (A01:411)
        en = en && primary(g.at(P_VIEW, i), g.R) != r;
        if constexpr (MODEL == MODEL_I01)      // NotInPhaseSVC
            en = en && (g.at(P_SENT_SVC, i) == 0 ||
                        g.at(P_SENT_DVC, i) == 1);
    } else {
        en = en && !g.normal_primary(i, r);
    }
    if constexpr (RECOVERY<MODEL>) en = en && g.at(P_STATUS, i) != RECOVERING;
    const int new_view = wadd(g.at(P_VIEW, i), 1);
    g.at(P_VIEW, i) = new_view;
    g.at(P_STATUS, i) = VIEWCHANGE;
    g.reset_sent<MODEL>(i);
    if constexpr (MODEL == MODEL_I01) g.at(P_SENT_SVC, i) = 1;
    g.at(P_AUX_SVC, 0) = wadd(g.at(P_AUX_SVC, 0), 1);
    g.row(M_SVC, new_view, 0, 0, 0, r, 0, 0);
    g.broadcast(r);
    if constexpr (APP_STATE<MODEL>) g.clear_dvc<MODEL>(i);
    return en;
}

// ReceiveHigherSVC / ReceiveHigherDVC (ST03:537-556, 616-635); I01
// adopts view + 1 (I01:455, 572) and tracks the DVC; AS04 resets its DVC
// slots and seeds them with the carrier DVC (AS04:667); RR05's receiver
// is not Recovering (RR05:606, 688)
template <int MODEL>
__device__ bool receive_higher(St& g, int k, int mtype) {
    const int i = g.msg_lane(k), r = g.mh[H_DEST];
    const int j = clipi(wsub(g.mh[H_SRC], 1), 0, g.R - 1);
    bool en = g.recv_en(k, mtype) && g.can_progress(i) &&
              g.mh[H_VIEW] > g.at(P_VIEW, i);
    if constexpr (RECOVERY<MODEL>) en = en && g.at(P_STATUS, i) != RECOVERING;
    const int new_view = MODEL == MODEL_I01 ? wadd(g.at(P_VIEW, i), 1)
                                            : g.mh[H_VIEW];
    g.at(P_VIEW, i) = new_view;
    g.at(P_STATUS, i) = VIEWCHANGE;
    g.reset_sent<MODEL>(i);
    if constexpr (MODEL == MODEL_I01) {
        g.at(P_SENT_SVC, i) = 1;
        if (mtype == M_DVC)
            g.update_tracker(i, new_view, j, g.mh[H_VIEW], g.mh[H_LNV],
                             g.mh[H_OP], g.mh[H_COMMIT], g.m_log(k), en);
    }
    if constexpr (APP_STATE<MODEL>) {
        g.clear_dvc<MODEL>(i);
        if (mtype == M_DVC) {
            if constexpr (CHECKPOINTS<MODEL>)
                g.dvc_slot_add_cp(i, j, g.mh[H_LNV], g.mh[H_OP],
                                  g.mh[H_COMMIT], g.m_log(k), g.m_cp(k),
                                  g.mh[H_CP], true);
            else
                g.dvc_slot_add(i, j, g.mh[H_LNV], g.mh[H_OP],
                               g.mh[H_COMMIT], g.m_log(k), true);
        }
    }
    g.discard(k);
    g.row(M_SVC, new_view, 0, 0, 0, r, 0, 0);
    g.broadcast(r);
    return en;
}

// ReceiveMatchingSVC / ReceiveMatchingDVC (ST03:558-575, 637-654); AS04
// asks sent_dvc = FALSE of the SVC (AS04:601) and registers the DVC in
// its slots; I01 registers the DVC whatever the status, in its tracker
template <int MODEL>
__device__ bool receive_matching(St& g, int k, int mtype) {
    const int i = g.msg_lane(k);
    const int j = clipi(wsub(g.mh[H_SRC], 1), 0, g.R - 1);
    const int view = g.at(P_VIEW, i);
    bool en = g.recv_en(k, mtype) && g.can_progress(i) &&
              g.mh[H_VIEW] == view;
    if (!(MODEL == MODEL_I01 && mtype == M_DVC))
        en = en && g.at(P_STATUS, i) == VIEWCHANGE;
    if (APP_STATE<MODEL> && mtype == M_SVC)
        en = en && g.at(P_SENT_DVC, i) == 0;
    if constexpr (MODEL == MODEL_I01)
        if (mtype == M_DVC)
            g.update_tracker(i, view, j, g.mh[H_VIEW], g.mh[H_LNV],
                             g.mh[H_OP], g.mh[H_COMMIT], g.m_log(k), en);
    g.discard(k);
    if constexpr (CHECKPOINTS<MODEL>) {
        if (mtype == M_DVC)
            g.dvc_slot_add_cp(i, j, g.mh[H_LNV], g.mh[H_OP], g.mh[H_COMMIT],
                              g.m_log(k), g.m_cp(k), g.mh[H_CP], en);
    } else if constexpr (APP_STATE<MODEL>) {
        if (mtype == M_DVC)
            g.dvc_slot_add(i, j, g.mh[H_LNV], g.mh[H_OP], g.mh[H_COMMIT],
                           g.m_log(k), en);
    }
    return en;
}

// SendDVC (ST03:577-614), lane i; the new primary's own DVC also enters
// I01's tracker and AS04's slots.  CP06 (CP06:785-816): lane i * C + cp,
// cp in HighestGCedOp + 1 .. commit, the DVC carrying the checkpoint
// (the app state below cp) and the log suffix above it
template <int MODEL>
__device__ bool send_dvc(St& g, int lane) {
    int i = lane, cp = 0;
    if constexpr (CHECKPOINTS<MODEL>) {
        i = lane / (g.OPS + 1);
        cp = lane - i * (g.OPS + 1);
    }
    const int R = g.R, r = i + 1;
    const int view = g.at(P_VIEW, i), prim = primary(view, R);
    int tomb = 0;
    for (int m = 0; m < g.M; ++m) tomb += g.tombstone(m, i, M_SVC);
    const int* l = g.log_row(i);
    bool en = g.can_progress(i) && g.at(P_STATUS, i) == VIEWCHANGE &&
              g.at(P_SENT_DVC, i) == 0 && tomb >= R / 2;
    if constexpr (CHECKPOINTS<MODEL>)
        en = en && cp >= g.hgc(l) + 1 && cp <= g.at(P_COMMIT, i);
    g.at(P_SENT_DVC, i) = 1;
    g.row(M_DVC, view, g.at(P_OP, i), g.at(P_COMMIT, i), prim, r, 0,
          g.at(P_LNV, i));
    if constexpr (CHECKPOINTS<MODEL>) {
        g.rh[H_CP] = cp;
        g.log_suffix(l, cp + 1, g.rl);
        g.checkpoint(i, cp, g.rc);
    } else {
        for (int o = 0; o < g.OPS; ++o) g.rl[o] = l[o];
    }
    // the new primary's own DVC is born processed (SendAsReceived)
    g.send(true, prim == r ? 0 : 1);
    if constexpr (MODEL == MODEL_I01)
        g.update_tracker(i, view, i, view, g.at(P_LNV, i), g.at(P_OP, i),
                         g.at(P_COMMIT, i), l, prim == r && en);
    if constexpr (CHECKPOINTS<MODEL>)
        g.dvc_slot_add_cp(i, i, g.at(P_LNV, i), g.at(P_OP, i),
                          g.at(P_COMMIT, i), g.rl, g.rc, cp, prim == r && en);
    else if constexpr (APP_STATE<MODEL>)
        g.dvc_slot_add(i, i, g.at(P_LNV, i), g.at(P_OP, i),
                       g.at(P_COMMIT, i), l, prim == r && en);
    return en;
}

// the HighestLog CHOOSE: among the candidates, the maximal (last normal
// view, op number) pair, ties to the least (commit, log, source), the
// first such; cand(t), the pair, the commit, the log and the source of
// candidate t (the bag's slots for ST03 and A01, the DVC slots of the
// replica for I01 and AS04)
template <typename Cand, typename Lnv, typename Op, typename Commit,
          typename Log, typename Src>
__device__ int highest(int n, int OPS, Cand cand, Lnv lnv, Op op,
                       Commit commit, Log log, Src src) {
    int best_pair = INT_MIN;
    auto pair = [&](int t) { return wadd(wmul(lnv(t), OPS + 1), op(t)); };
    for (int t = 0; t < n; ++t) best_pair = imax(best_pair,
                                                 cand(t) ? pair(t) : -1);
    auto key = [&](int t, int w) {
        if (w == 0) return commit(t);
        if (w <= OPS) return log(t)[w - 1];
        return src(t);
    };
    int best = -1;
    for (int t = 0; t < n; ++t) {
        if (!(cand(t) && pair(t) == best_pair)) continue;
        bool less = best < 0;
        for (int w = 0; w < OPS + 2 && !less; ++w) {
            const int a = key(t, w), b = key(best, w);
            if (a != b) {
                less = a < b;
                break;
            }
        }
        if (less) best = t;
    }
    return best < 0 ? 0 : best;
}

template <int MODEL>
__device__ bool send_sv(St& g, int i) {
    const int R = g.R, OPS = g.OPS, r = i + 1;
    const int view = g.at(P_VIEW, i);
    int n_valid = 0, new_cn = INT_MIN, new_vn = view, new_on;
    if constexpr (MODEL == MODEL_I01 || APP_STATE<MODEL>) {
        // the replica's DVC slots: I01's valid (view >= own) tracker
        // entries (I01:610-645), AS04's recv_dvc set (AS04:697-727)
        auto cand = [&](int j) {
            return g.slot(P_DVC, i, j) == 1 &&
                   (APP_STATE<MODEL> ||
                    g.slot(P_DVC_VIEW, i, j) >= view);
        };
        new_vn = INT_MIN;
        for (int j = 0; j < R; ++j) {
            n_valid += cand(j);
            new_cn = imax(new_cn, cand(j) ? g.slot(P_DVC_COMMIT, i, j) : -1);
            if constexpr (MODEL == MODEL_I01)
                new_vn = imax(new_vn,
                              cand(j) ? g.slot(P_DVC_VIEW, i, j) : -1);
        }
        const int best = highest(
            R, OPS, cand, [&](int j) { return g.slot(P_DVC_LNV, i, j); },
            [&](int j) { return g.slot(P_DVC_OP, i, j); },
            [&](int j) { return g.slot(P_DVC_COMMIT, i, j); },
            [&](int j) { return (const int*)g.dvc_log(i, j); },
            [&](int j) { return j + 1; });
        if constexpr (APP_STATE<MODEL>) new_vn = view;
        new_on = g.slot(P_DVC_OP, i, best);
        g.row(M_SV, new_vn, new_on, new_cn, 0, r, 0, 0);
        const int* bl = g.dvc_log(i, best);
        for (int o = 0; o < OPS; ++o) g.rl[o] = bl[o];
    } else {
        // HighestLog over the valid DVC tombstones (ST03:676-697)
        auto cand = [&](int m) { return g.tombstone(m, i, M_DVC); };
        for (int m = 0; m < g.M; ++m) {
            n_valid += cand(m);
            new_cn = imax(new_cn, cand(m) ? g.hdr(m, H_COMMIT) : -1);
        }
        const int best = highest(
            g.M, OPS, cand, [&](int m) { return g.hdr(m, H_LNV); },
            [&](int m) { return g.hdr(m, H_OP); },
            [&](int m) { return g.hdr(m, H_COMMIT); },
            [&](int m) { return (const int*)g.m_log(m); },
            [&](int m) { return g.hdr(m, H_SRC); });
        new_on = g.hdr(best, H_OP);
        g.row(M_SV, view, new_on, new_cn, 0, r, 0, 0);
        const int* bl = g.m_log(best);
        for (int o = 0; o < OPS; ++o) g.rl[o] = bl[o];
    }
    const bool en = g.can_progress(i) && g.at(P_STATUS, i) == VIEWCHANGE &&
                    g.at(P_SENT_SV, i) == 0 && n_valid >= R / 2 + 1;
    g.at(P_STATUS, i) = NORMAL;
    int* l = g.log_row(i);
    for (int o = 0; o < OPS; ++o) l[o] = g.rl[o];
    if constexpr (APP_STATE<MODEL>) {
        // HighestCommitNumber executes the ops up to it; the commit is
        // never lowered (the SV still carries new_cn)
        g.exec_ops(i, g.rl, new_cn);
    } else {
        g.at(P_COMMIT, i) = new_cn;
    }
    g.at(P_OP, i) = new_on;
    for (int j = 0; j < R; ++j) g.peer(i, j) = 0;
    g.at(P_SENT_SV, i) = 1;
    g.at(P_LNV, i) = new_vn;
    if constexpr (MODEL == MODEL_I01) {
        g.at(P_VIEW, i) = new_vn;
        g.clear_tracker(i);
    }
    if constexpr (APP_STATE<MODEL>) g.clear_dvc<MODEL>(i);
    g.broadcast(r);
    return en;
}

template <int MODEL>
__device__ bool receive_sv(St& g, int k) {
    const int i = g.msg_lane(k), r = g.mh[H_DEST];
    const int hv = g.mh[H_VIEW], v = g.at(P_VIEW, i);
    bool en = g.recv_en(k, M_SV) && g.can_progress(i);
    if constexpr (A01_LIKE<MODEL>)
        en = en && hv >= v;                 // A01:621-624
    else
        en = en && ((hv == v && g.at(P_STATUS, i) == VIEWCHANGE) || hv > v);
    if constexpr (RECOVERY<MODEL>)          // RR05:798
        en = en && g.at(P_STATUS, i) != RECOVERING;
    const int old_commit = g.at(P_COMMIT, i);
    g.at(P_STATUS, i) = NORMAL;
    g.at(P_VIEW, i) = hv;
    if constexpr (CHECKPOINTS<MODEL>) {
        // ApplyCheckpoint of the StartView's checkpoint and suffix
        // (CP06:939-971)
        g.apply_checkpoint(i, g.m_log(k), g.m_cp(k), g.mh[H_CP], g.mh[H_OP],
                           g.mh[H_COMMIT]);
    } else {
        int* l = g.log_row(i);
        const int* ml = g.m_log(k);
        for (int o = 0; o < g.OPS; ++o) l[o] = ml[o];
        if constexpr (APP_STATE<MODEL>)
            g.exec_ops(i, l, g.mh[H_COMMIT]);
        else
            g.at(P_COMMIT, i) = g.mh[H_COMMIT];
        g.at(P_OP, i) = g.mh[H_OP];
    }
    g.at(P_LNV, i) = hv;
    g.reset_sent<MODEL>(i);
    if constexpr (MODEL == MODEL_I01) g.clear_tracker(i);
    if constexpr (APP_STATE<MODEL>) g.clear_dvc<MODEL>(i);
    g.discard(k);
    g.row(M_PREPAREOK, hv, g.mh[H_OP], 0, primary(hv, g.R), r, 0, 0);
    g.send(old_commit < g.mh[H_OP], 1);
    return en;
}

template <int MODEL>
__device__ bool receive_client_request(St& g, int lane) {
    const int i = lane / g.V, vid = lane - i * g.V + 1, r = i + 1;
    const bool en = g.can_progress(i) && g.normal_primary(i, r) &&
                    g.at(P_AUX_ACKED, vid - 1) == 0;
    const int opn = wadd(g.at(P_OP, i), 1);
    // packed entries value_id << 8 | view (A01:287-289, RR05:306-309)
    const int entry = PACKED_ENTRIES<MODEL>
        ? (vid << ENTRY_VIEW_BITS) | g.at(P_VIEW, i) : vid;
    g.log_row(i)[clipi(wsub(opn, 1), 0, g.OPS - 1)] = entry;
    g.at(P_OP, i) = opn;
    g.at(P_AUX_ACKED, vid - 1) = 1;
    g.row(M_PREPARE, g.at(P_VIEW, i), opn, g.at(P_COMMIT, i), 0, r, 0, 0);
    g.re = entry;
    g.broadcast(r);
    return en;
}

template <int MODEL>
__device__ bool receive_prepare(St& g, int k) {
    const int i = g.msg_lane(k), r = g.mh[H_DEST];
    const int view = g.at(P_VIEW, i);
    // I01 has no primary exemption (I01:311-323)
    const bool en = g.recv_en(k, M_PREPARE) && g.can_progress(i) &&
                    (MODEL == MODEL_I01 || !g.normal_primary(i, r)) &&
                    g.at(P_STATUS, i) == NORMAL && g.mh[H_VIEW] == view &&
                    g.mh[H_OP] == wadd(g.at(P_OP, i), 1);
    g.log_row(i)[clipi(wsub(g.mh[H_OP], 1), 0, g.OPS - 1)] =
        g.at(P_M_ENTRY, k);
    g.at(P_OP, i) = g.mh[H_OP];
    if constexpr (APP_STATE<MODEL>)
        g.exec_ops(i, g.log_row(i), g.mh[H_COMMIT]);
    else
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

// ExecuteOp (AS04, RR05, AL05: PrimaryExecuteOp, AS04:420-437)
template <int MODEL>
__device__ bool execute_op(St& g, int i) {
    const int r = i + 1;
    const int opn = wadd(g.at(P_COMMIT, i), 1);
    int n = 0;
    for (int j = 0; j < g.R; ++j) n += g.peer(i, j) >= opn;
    const bool en = g.can_progress(i) && g.normal_primary(i, r) &&
                    g.at(P_COMMIT, i) < g.at(P_OP, i) && n >= g.R / 2;
    const int code = g.log_row(i)[clipi(wsub(opn, 1), 0, g.OPS - 1)];
    const int vid = PACKED_ENTRIES<MODEL> ? code >> ENTRY_VIEW_BITS : code;
    if constexpr (APP_STATE<MODEL>)
        g.exec_ops(i, g.log_row(i), opn);
    else
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

template <int MODEL>
__device__ bool receive_new_state(St& g, int k) {
    const int i = g.msg_lane(k);
    const bool en = g.recv_en(k, M_NEWSTATE) && g.can_progress(i) &&
                    g.at(P_STATUS, i) == STATETRANSFER &&
                    g.mh[H_VIEW] > g.at(P_VIEW, i);
    // the new log over 1..m.op_number: the replica's own prefix below
    // first_op, the message's suffix (stored re-based at 0) from there
    int* l = g.log_row(i);
    g.splice(l, g.m_log(k), g.mh[H_FIRST], g.mh[H_OP], l);
    g.at(P_STATUS, i) = NORMAL;
    g.at(P_VIEW, i) = g.mh[H_VIEW];
    g.at(P_LNV, i) = g.mh[H_VIEW];
    g.at(P_OP, i) = g.mh[H_OP];
    if constexpr (APP_STATE<MODEL>)
        g.exec_ops(i, l, g.mh[H_COMMIT]);
    else
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

// I01's ResendSVC (I01:505-517), lane i * R + peer: the SVC of the
// replica's view to the peer again, when none to it is undelivered
// (count 1) and none came back from it in this view
__device__ bool resend_svc(St& g, int lane) {
    const int i = lane / g.R, p = lane - i * g.R, r = i + 1, peer = p + 1;
    const int view = g.at(P_VIEW, i);
    bool undelivered = false, back = false;
    for (int m = 0; m < g.M; ++m) {
        if (g.at(P_M_PRESENT, m) != 1 || g.hdr(m, H_TYPE) != M_SVC ||
                g.hdr(m, H_VIEW) != view)
            continue;
        const int dest = g.hdr(m, H_DEST), src = g.hdr(m, H_SRC);
        undelivered = undelivered || (dest == peer && src == r &&
                                      g.at(P_M_COUNT, m) == 1);
        back = back || (dest == r && src == peer);
    }
    const bool en = g.can_progress(i) && r != peer &&
                    g.at(P_SENT_SVC, i) == 1 && !undelivered && !back;
    g.row(M_SVC, view, 0, 0, peer, r, 0, 0);
    g.send(true, 1);
    return en;
}

// -- RR05's recovery sub-protocol (RR05:837-983) and AL05's forms
// (AL05:851-977) ----------------------------------------------------------

// Crash, lane i (AL05: i * (OPS + 1) + last_op, the length of the log
// prefix that survives): the replica wiped to Recovering with a fresh
// nonce, a RecoveryMsg broadcast (AL05's carries the floor min(commit,
// last_op) as its op)
template <int MODEL>
__device__ bool crash(St& g, int lane, int crash_limit) {
    int i = lane, last_op = 0;
    if constexpr (MODEL == MODEL_AL05) {
        i = lane / (g.OPS + 1);
        last_op = lane - i * (g.OPS + 1);
    }
    const int r = i + 1;
    bool en = g.at(P_AUX_RESTART, 0) < crash_limit && g.can_progress(i);
    if constexpr (MODEL == MODEL_AL05) en = en && last_op <= g.at(P_OP, i);
    const int u = g.unique_number();
    const int floor = imin(g.at(P_COMMIT, i), last_op);
    g.at(P_STATUS, i) = RECOVERING;
    int* l = g.log_row(i);
    int* app = g.app_row(i);
    for (int o = 0; o < g.OPS; ++o) {
        if (!(MODEL == MODEL_AL05 && o < last_op)) l[o] = 0;
        app[o] = 0;
    }
    g.at(P_VIEW, i) = 0;
    g.at(P_OP, i) = last_op;
    g.at(P_COMMIT, i) = 0;
    for (int j = 0; j < g.R; ++j) g.peer(i, j) = 0;
    g.at(P_LNV, i) = 0;
    g.reset_sent<MODEL>(i);
    g.clear_dvc<MODEL>(i);
    g.clear_rec<MODEL>(i);
    g.at(P_REC_NUMBER, i) = u;
    g.at(P_AUX_RESTART, 0) = wadd(g.at(P_AUX_RESTART, 0), 1);
    g.row(M_RECOVERY, 0, MODEL == MODEL_AL05 ? floor : 0, 0, 0, r, 0, 0);
    g.rh[H_X] = u;
    g.broadcast(r);
    return en;
}

// ReceiveRecoveryMsg: a Normal replica answers the nonce; the primary
// attaches its log, op and commit (RR05), or its log above the crashed
// replica's floor, re-based at 0, with first = the floor (AL05); a
// backup's answer has op = commit = -1 (Nil) and no log
template <int MODEL>
__device__ bool receive_recovery(St& g, int k) {
    const int i = g.msg_lane(k), r = g.mh[H_DEST];
    const bool en = g.recv_en(k, M_RECOVERY) && g.can_progress(i) &&
                    g.at(P_STATUS, i) == NORMAL;
    const bool prim = g.normal_primary(i, r);
    const int floor = g.mh[H_OP];
    const int* l = g.log_row(i);
    const int first = MODEL == MODEL_AL05 && prim ? floor : 0;
    g.row(M_RECOVERYRESP, g.at(P_VIEW, i), prim ? g.at(P_OP, i) : -1,
          prim ? g.at(P_COMMIT, i) : -1, g.mh[H_SRC], r, first, 0);
    g.rh[H_X] = g.mh[H_X];
    if constexpr (MODEL == MODEL_AL05) {
        const int n = imax(wsub(g.at(P_OP, i), floor), 0);
        for (int o = 0; o < g.OPS; ++o)
            g.rl[o] = prim && o < n
                ? l[clipl((long long)o + floor, 0, g.OPS - 1)] : 0;
    } else {
        for (int o = 0; o < g.OPS; ++o) g.rl[o] = prim ? l[o] : 0;
    }
    g.discard(k);
    g.send(true, 1);
    return en;
}

// ReceiveRecoveryResponseMsg: the response into the receiver's slot for
// its source (AL05: and its prefix ceiling); a different record there
// already sets ERR_REC_OVERFLOW
template <int MODEL>
__device__ bool receive_recovery_response(St& g, int k) {
    const int i = g.msg_lane(k);
    const int j = clipi(wsub(g.mh[H_SRC], 1), 0, g.R - 1);
    const bool en = g.recv_en(k, M_RECOVERYRESP) && g.can_progress(i) &&
                    g.at(P_REC_NUMBER, i) == g.mh[H_X] &&
                    g.at(P_STATUS, i) == RECOVERING;
    const bool collide = en && g.slot(P_REC, i, j) == 1 &&
                         (g.slot(P_REC_VIEW, i, j) != g.mh[H_VIEW] ||
                          g.slot(P_REC_OP, i, j) != g.mh[H_OP]);
    g.slot(P_REC, i, j) = 1;
    g.slot(P_REC_VIEW, i, j) = g.mh[H_VIEW];
    g.slot(P_REC_HAS_LOG, i, j) = g.mh[H_OP] >= 0;
    int* l = g.rec_log(i, j);
    const int* ml = g.m_log(k);
    for (int o = 0; o < g.OPS; ++o) l[o] = ml[o];
    g.slot(P_REC_OP, i, j) = g.mh[H_OP];
    g.slot(P_REC_COMMIT, i, j) = g.mh[H_COMMIT];
    if (collide) g.at(P_ERR, 0) |= ERR_REC_OVERFLOW;
    g.discard(k);
    if constexpr (MODEL == MODEL_AL05)
        g.slot(P_REC_CEIL, i, j) = g.mh[H_OP] >= 0 ? g.mh[H_FIRST] : 0;
    return en;
}

// CompleteRecovery, lane i: with a majority of responses, the has-log
// response of the highest view installed (AL05: the replica's own
// prefix below min(ceil, op) under the response's suffix), its
// committed ops executed, the slots cleared
template <int MODEL>
__device__ bool complete_recovery(St& g, int i) {
    bool any;
    const int j = g.best_rec(i, &any);
    const bool en = g.can_progress(i) && g.at(P_STATUS, i) == RECOVERING &&
                    g.rec_quorum(i) && any;
    const int rv = g.slot(P_REC_VIEW, i, j), m_op = g.slot(P_REC_OP, i, j);
    const int m_commit = g.slot(P_REC_COMMIT, i, j);
    const int* rlog = g.rec_log(i, j);
    int* l = g.log_row(i);
    if constexpr (MODEL == MODEL_AL05) {
        const int ceil = g.slot(P_REC_CEIL, i, j);
        for (int o = 0; o < g.OPS; ++o)
            g.rl[o] = o < imin(ceil, m_op) ? l[o]
                : o < m_op ? rlog[clipl((long long)o - ceil, 0, g.OPS - 1)]
                           : 0;
    } else {
        for (int o = 0; o < g.OPS; ++o) g.rl[o] = rlog[o];
    }
    g.at(P_STATUS, i) = NORMAL;
    g.at(P_VIEW, i) = rv;
    g.at(P_LNV, i) = rv;
    for (int o = 0; o < g.OPS; ++o) l[o] = g.rl[o];
    g.at(P_OP, i) = m_op;
    g.exec_ops(i, g.rl, m_commit);
    g.clear_rec<MODEL>(i);
    return en;
}

// RetryRecovery, lane i (RR05:951-983): a majority of responses, none
// with a log, and nothing with the replica's nonce that can still bring
// one (a RecoveryMsg whose receiver can progress, or a response, present
// and undelivered): the slots cleared, a fresh nonce broadcast
template <int MODEL>
__device__ bool retry_recovery(St& g, int i) {
    bool any;
    g.best_rec(i, &any);
    const int x = g.at(P_REC_NUMBER, i);
    bool pending = false;
    for (int m = 0; m < g.M; ++m) {
        if (g.at(P_M_PRESENT, m) != 1 || g.at(P_M_COUNT, m) <= 0 ||
                g.hdr(m, H_X) != x)
            continue;
        const int t = g.hdr(m, H_TYPE);
        const int d = clipi(wsub(g.hdr(m, H_DEST), 1), 0, g.R - 1);
        pending = pending || (t == M_RECOVERY && g.can_progress(d)) ||
                  t == M_RECOVERYRESP;
    }
    const bool en = g.can_progress(i) && g.at(P_STATUS, i) == RECOVERING &&
                    g.rec_quorum(i) && !any && !pending;
    const int u = g.unique_number();
    g.clear_rec<MODEL>(i);
    g.at(P_REC_NUMBER, i) = u;
    g.row(M_RECOVERY, 0, 0, 0, 0, i + 1, 0, 0);
    g.rh[H_X] = u;
    g.broadcast(i + 1);
    return en;
}

// -- CP06's checkpointed view change, state transfer and recovery
// (CP06:644-712, 785-1170) -------------------------------------------------
// A checkpoint lane dimension of C = OPS + 1: SendDVC and Crash lane
// i * C + cp, ReceiveGetState and ReceiveGetCheckpointMsg lane
// k * R * C + i * C + cp, ReceiveRecoveryMsg lane k * C + cp.

// WinningDVC (CP06:885-896): among replica i's DVC slots, the maximal
// (lnv, op), ties to the least (checkpoint, commit, cp_number,
// log_suffix keyed (cp_number + 1 + position) * 64 + entry, source), the
// first such (0 when none)
__device__ int winning_dvc(const St& g, int i) {
    const int R = g.R, OPS = g.OPS;
    auto cand = [&](int j) { return g.slot(P_DVC, i, j) == 1; };
    auto pair = [&](int j) {
        return wadd(wmul(g.slot(P_DVC_LNV, i, j), OPS + 1),
                    g.slot(P_DVC_OP, i, j));
    };
    int best_pair = INT_MIN;
    for (int j = 0; j < R; ++j)
        best_pair = imax(best_pair, cand(j) ? pair(j) : -1);
    auto key = [&](int j, int w) {
        if (w < OPS) return g.dvc_cp(i, j)[w];
        if (w == OPS) return g.slot(P_DVC_COMMIT, i, j);
        const int cpn = g.slot(P_DVC_CPN, i, j);
        if (w == OPS + 1) return cpn;
        if (w < 2 * OPS + 2) {
            const int o = w - OPS - 2;
            return o < wsub(g.slot(P_DVC_OP, i, j), cpn)
                ? wadd(wmul(wadd(wadd(cpn, 1), o), 64), g.dvc_log(i, j)[o])
                : 0;
        }
        return j + 1;
    };
    int best = -1;
    for (int j = 0; j < R; ++j) {
        if (!(cand(j) && pair(j) == best_pair)) continue;
        bool less = best < 0;
        for (int w = 0; w < 2 * OPS + 3 && !less; ++w) {
            const int a = key(j, w), b = key(best, w);
            if (a != b) {
                less = a < b;
                break;
            }
        }
        if (less) best = j;
    }
    return best < 0 ? 0 : best;
}

// SendSV, lane i (CP06:898-937): WinningDVC's checkpoint and suffix
// applied, HighestCommitNumber the commit, the StartView broadcast
template <int MODEL>
__device__ bool cp_send_sv(St& g, int i) {
    const int R = g.R, r = i + 1, view = g.at(P_VIEW, i);
    int n = 0, new_cn = INT_MIN;
    for (int j = 0; j < R; ++j) {
        const bool has = g.slot(P_DVC, i, j) == 1;
        n += has;
        new_cn = imax(new_cn, has ? g.slot(P_DVC_COMMIT, i, j) : -1);
    }
    const bool en = g.can_progress(i) && g.at(P_STATUS, i) == VIEWCHANGE &&
                    g.at(P_SENT_SV, i) == 0 && n >= R / 2 + 1;
    const int j = winning_dvc(g, i);
    const int w_cpn = g.slot(P_DVC_CPN, i, j), w_op = g.slot(P_DVC_OP, i, j);
    g.row(M_SV, view, w_op, new_cn, 0, r, 0, 0);
    g.rh[H_CP] = w_cpn;
    const int* wl = g.dvc_log(i, j);
    const int* wc = g.dvc_cp(i, j);
    for (int o = 0; o < g.OPS; ++o) {
        g.rl[o] = wl[o];
        g.rc[o] = wc[o];
    }
    g.at(P_STATUS, i) = NORMAL;
    g.apply_checkpoint(i, g.rl, g.rc, w_cpn, w_op, new_cn);
    for (int jj = 0; jj < R; ++jj) g.peer(i, jj) = 0;
    g.at(P_SENT_SV, i) = 1;
    g.at(P_LNV, i) = view;
    g.clear_dvc<MODEL>(i);
    g.broadcast(r);
    return en;
}

// ReceiveGetState (CP06:644-680): a checkpoint reply (flag 1) when the
// replica's log is GC'd at m.op + 1, one lane per cp; else the suffix
// reply on the cp = 0 lane
__device__ bool cp_receive_get_state(St& g, int lane) {
    const int C = g.OPS + 1, RC = g.R * C;
    const int k = lane / RC, rest = lane - k * RC, i = rest / C;
    const int cp = rest - i * C, r = i + 1;
    g.msg_lane(k);
    const int dest = g.mh[H_DEST], op_i = g.at(P_OP, i);
    const int commit_i = g.at(P_COMMIT, i);
    const int* l = g.log_row(i);
    const bool base = g.at(P_M_PRESENT, k) == 1 && g.at(P_M_COUNT, k) > 0 &&
                      g.mh[H_TYPE] == M_GETSTATE &&
                      (dest == r || (dest == ANYDEST && g.mh[H_SRC] != r)) &&
                      g.can_progress(i) && g.at(P_STATUS, i) == NORMAL &&
                      g.at(P_VIEW, i) == g.mh[H_VIEW] && op_i > g.mh[H_OP];
    const bool gced = l[clipi(g.mh[H_OP], 0, g.OPS - 1)] == g.V + 1;
    const bool en = base && (gced ? cp >= g.hgc(l) + 1 && cp <= commit_i
                                  : cp == 0);
    const int first_ls = wadd(g.mh[H_OP], 1);
    g.row(M_NEWSTATE, g.at(P_VIEW, i), op_i, gced ? cp : commit_i,
          g.mh[H_SRC], r, gced ? 0 : first_ls, 0);
    g.rh[H_FLAG] = gced;
    g.rh[H_CP] = gced ? cp : 0;
    g.log_suffix(l, gced ? cp + 1 : first_ls, g.rl);
    if (gced) g.checkpoint(i, cp, g.rc);
    g.discard(k);
    g.send(true, 1);
    return en;
}

// ReceiveNewState (CP06:682-712): to a StateTransfer replica of the
// message's view; flag 1 applies the checkpoint, flag 0 splices the
// replica's prefix below first_op under the suffix
template <int MODEL>
__device__ bool cp_receive_new_state(St& g, int k) {
    const int i = g.msg_lane(k);
    const bool en = g.recv_en(k, M_NEWSTATE) && g.can_progress(i) &&
                    g.at(P_STATUS, i) == STATETRANSFER &&
                    g.at(P_VIEW, i) == g.mh[H_VIEW];
    if (g.mh[H_FLAG] == 1) {
        g.apply_checkpoint(i, g.m_log(k), g.m_cp(k), g.mh[H_CP], g.mh[H_OP],
                           g.mh[H_COMMIT]);
    } else {
        int* l = g.log_row(i);
        g.splice(l, g.m_log(k), g.mh[H_FIRST], g.mh[H_OP], l);
        g.exec_ops(i, l, g.mh[H_COMMIT]);
        g.at(P_OP, i) = g.mh[H_OP];
    }
    g.at(P_STATUS, i) = NORMAL;
    g.at(P_VIEW, i) = g.mh[H_VIEW];
    g.at(P_LNV, i) = g.mh[H_VIEW];
    g.discard(k);
    return en;
}

// Crash, lane i * C + cp (CP06:985-1009): the log NoOp below cp, the app
// state kept below cp, op = commit = cp, Recovering with a fresh nonce,
// and the GetCheckpoint sent once (SendOnce: not while its record is in
// the bag at all)
template <int MODEL>
__device__ bool cp_crash(St& g, int lane, int crash_limit) {
    const int C = g.OPS + 1, i = lane / C, cp = lane - i * C, r = i + 1;
    g.row(M_GETCP, 0, 0, 0, ANYDEST, r, 0, 0);
    const bool en = g.at(P_AUX_RESTART, 0) < crash_limit &&
                    cp <= g.at(P_COMMIT, i) && !g.any_eq();
    const int u = g.unique_number();
    g.at(P_STATUS, i) = RECOVERING;
    int* l = g.log_row(i);
    int* app = g.app_row(i);
    for (int o = 0; o < g.OPS; ++o) {
        l[o] = o < cp ? g.V + 1 : 0;
        if (!(o < cp)) app[o] = 0;
    }
    g.at(P_VIEW, i) = 0;
    g.at(P_OP, i) = cp;
    g.at(P_COMMIT, i) = cp;
    for (int j = 0; j < g.R; ++j) g.peer(i, j) = 0;
    g.at(P_LNV, i) = 0;
    g.reset_sent<MODEL>(i);
    g.clear_dvc<MODEL>(i);
    g.clear_rec<MODEL>(i);
    g.at(P_REC_NUMBER, i) = u;
    g.at(P_AUX_RESTART, 0) = wadd(g.at(P_AUX_RESTART, 0), 1);
    g.send(true, 1);
    return en;
}

// ReceiveGetCheckpointMsg, lane k * R * C + i * C + cp (CP06:1017-1043):
// a replica not Recovering answers with its app state below cp
__device__ bool cp_receive_get_checkpoint(St& g, int lane) {
    const int C = g.OPS + 1, RC = g.R * C;
    const int k = lane / RC, rest = lane - k * RC, i = rest / C;
    const int cp = rest - i * C, r = i + 1;
    g.msg_lane(k);
    const int dest = g.mh[H_DEST];
    const bool en = g.at(P_M_PRESENT, k) == 1 && g.at(P_M_COUNT, k) > 0 &&
                    g.mh[H_TYPE] == M_GETCP &&
                    (dest == r || (dest == ANYDEST && g.mh[H_SRC] != r)) &&
                    g.can_progress(i) && g.at(P_STATUS, i) != RECOVERING &&
                    cp <= g.at(P_COMMIT, i);
    g.row(M_NEWCP, 0, 0, 0, g.mh[H_SRC], r, 0, 0);
    g.rh[H_CP] = cp;
    g.checkpoint(i, cp, g.rc);
    g.discard(k);
    g.send(true, 1);
    return en;
}

// ReceiveNewCheckpointMsg (CP06:1051-1079): the Recovering receiver takes
// the checkpoint (log NoOp below cp_number, op = commit = cp_number) and
// broadcasts a RecoveryMsg with a fresh nonce and op = cp_number
__device__ bool cp_receive_new_checkpoint(St& g, int k) {
    const int i = g.msg_lane(k), r = g.mh[H_DEST];
    const bool en = g.recv_en(k, M_NEWCP) && g.can_progress(i) &&
                    g.at(P_STATUS, i) == RECOVERING;
    const int cpn = g.mh[H_CP];
    const int u = g.unique_number();
    int* l = g.log_row(i);
    int* app = g.app_row(i);
    const int* c = g.m_cp(k);
    for (int o = 0; o < g.OPS; ++o) {
        l[o] = o < cpn ? g.V + 1 : 0;
        app[o] = c[o];
    }
    g.at(P_OP, i) = cpn;
    g.at(P_COMMIT, i) = cpn;
    g.discard(k);
    g.row(M_RECOVERY, 0, cpn, 0, 0, r, 0, 0);
    g.rh[H_X] = u;
    g.broadcast(r);
    return en;
}

// ReceiveRecoveryMsg, lane k * C + cp (CP06:1081-1105): a Normal replica
// answers; the primary with its log GC'd at m.op + 1 in the checkpoint
// form (one lane per cp), the primary otherwise with its suffix from
// m.op + 1, a backup with the Nil form (commit = first = -1)
__device__ bool cp_receive_recovery(St& g, int lane) {
    const int C = g.OPS + 1, k = lane / C, cp = lane - k * C;
    const int i = g.msg_lane(k), r = g.mh[H_DEST];
    const int op_i = g.at(P_OP, i), commit_i = g.at(P_COMMIT, i);
    const int m_op = g.mh[H_OP];
    const int* l = g.log_row(i);
    const bool base = g.recv_en(k, M_RECOVERY) &&
                      g.at(P_STATUS, i) == NORMAL;
    const bool prim = g.normal_primary(i, r);
    const bool gced = op_i > m_op &&
                      l[clipi(m_op, 0, g.OPS - 1)] == g.V + 1;
    const bool pg = prim && gced;
    const bool en = base && (pg ? cp >= g.hgc(l) + 1 && cp <= commit_i
                                : cp == 0);
    const int first_ls = wadd(m_op, 1);
    g.row(M_RECOVERYRESP, g.at(P_VIEW, i), op_i,
          !prim ? -1 : gced ? cp : commit_i, g.mh[H_SRC], r,
          !prim ? -1 : gced ? 0 : first_ls, 0);
    g.rh[H_X] = g.mh[H_X];
    g.rh[H_FLAG] = pg;
    g.rh[H_CP] = pg ? cp : 0;
    if (prim) g.log_suffix(l, gced ? cp + 1 : first_ls, g.rl);
    if (pg) g.checkpoint(i, cp, g.rc);
    g.discard(k);
    g.send(true, 1);
    return en;
}

// ReceiveRecoveryResponseMsg (CP06:1107-1121): the response, in any of
// its forms, into the Recovering receiver's slot for its source; a
// different record there already sets ERR_REC_OVERFLOW
__device__ bool cp_receive_recovery_response(St& g, int k) {
    const int i = g.msg_lane(k);
    const int j = clipi(wsub(g.mh[H_SRC], 1), 0, g.R - 1);
    const bool en = g.recv_en(k, M_RECOVERYRESP) &&
                    g.at(P_REC_NUMBER, i) == g.mh[H_X] &&
                    g.at(P_STATUS, i) == RECOVERING;
    const bool collide = en && g.slot(P_REC, i, j) == 1 &&
                         (g.slot(P_REC_VIEW, i, j) != g.mh[H_VIEW] ||
                          g.slot(P_REC_OP, i, j) != g.mh[H_OP]);
    g.slot(P_REC, i, j) = 1;
    g.slot(P_REC_VIEW, i, j) = g.mh[H_VIEW];
    g.slot(P_REC_OP, i, j) = g.mh[H_OP];
    g.slot(P_REC_HAS_LOG, i, j) =
        !(g.mh[H_FIRST] == -1 && g.mh[H_COMMIT] == -1);
    g.slot(P_REC_FLAG, i, j) = g.mh[H_FLAG];
    g.slot(P_REC_FIRST, i, j) = g.mh[H_FLAG] == 1 ? wadd(g.mh[H_CP], 1)
                                                  : g.mh[H_FIRST];
    g.slot(P_REC_CPN, i, j) = g.mh[H_CP];
    g.slot(P_REC_COMMIT, i, j) = g.mh[H_COMMIT];
    int* rl = g.rec_log(i, j);
    int* rc = g.rec_cp(i, j);
    const int* ml = g.m_log(k);
    const int* mc = g.m_cp(k);
    for (int o = 0; o < g.OPS; ++o) {
        rl[o] = ml[o];
        rc[o] = mc[o];
    }
    if (collide) g.at(P_ERR, 0) |= ERR_REC_OVERFLOW;
    g.discard(k);
    return en;
}

// CompleteRecovery, lane i (CP06:1138-1170): with a majority of
// responses, the has-log one of the highest view installed, in its form
// (flag 1: ApplyCheckpoint; flag 0: the replica's prefix below first_op
// under the suffix, its committed ops executed), the slots cleared
template <int MODEL>
__device__ bool cp_complete_recovery(St& g, int i) {
    bool any;
    const int j = g.best_rec(i, &any);
    const bool en = g.at(P_STATUS, i) == RECOVERING && g.rec_quorum(i) &&
                    any;
    const int rv = g.slot(P_REC_VIEW, i, j), m_op = g.slot(P_REC_OP, i, j);
    const int m_commit = g.slot(P_REC_COMMIT, i, j);
    if (g.slot(P_REC_FLAG, i, j) == 1) {
        g.apply_checkpoint(i, g.rec_log(i, j), g.rec_cp(i, j),
                           g.slot(P_REC_CPN, i, j), m_op, m_commit);
    } else {
        int* l = g.log_row(i);
        g.splice(l, g.rec_log(i, j), g.slot(P_REC_FIRST, i, j), m_op, l);
        g.exec_ops(i, l, m_commit);
        g.at(P_OP, i) = m_op;
    }
    g.at(P_STATUS, i) = NORMAL;
    g.at(P_VIEW, i) = rv;
    g.at(P_LNV, i) = rv;
    g.clear_rec<MODEL>(i);
    return en;
}

// the replica a lane's action mutates (lane_replica), from the parent
template <int MODEL>
__device__ int lane_replica(const St& g, int a, int lane) {
    if constexpr (CHECKPOINTS<MODEL>) {
        const int C = g.OPS + 1;
        switch (a) {
        case A_SEND_DVC: case A_CRASH:
            return lane / C;
        case A_RECEIVE_GET_STATE: case A_RECEIVE_GET_CHECKPOINT:
            return (lane % (g.R * C)) / C;
        case A_RECEIVE_RECOVERY:
            return clipi(wsub(g.hdr(lane / C, H_DEST), 1), 0, g.R - 1);
        }
    }
    switch (a) {
    case A_TIMER_SEND_SVC: case A_SEND_DVC: case A_SEND_SV:
    case A_EXECUTE_OP: case A_COMPLETE_RECOVERY: case A_RETRY_RECOVERY:
        return lane;
    case A_CRASH:
        return MODEL == MODEL_AL05 ? lane / (g.OPS + 1) : lane;
    case A_NO_PROGRESS_CHANGE:
        return 0;
    case A_RECEIVE_CLIENT_REQUEST:
        return lane / g.V;
    case A_RECEIVE_GET_STATE:
        return lane % g.R;
    case A_RESEND_SVC:
        return lane / g.R;
    default:
        return clipi(wsub(g.hdr(lane, H_DEST), 1), 0, g.R - 1);
    }
}

// a: the family action id
template <int MODEL>
__device__ bool apply(St& g, int a, int lane, int timer_limit, int np_limit,
                      int crash_limit) {
    if constexpr (CHECKPOINTS<MODEL>) {
        switch (a) {
        case A_SEND_SV: return cp_send_sv<MODEL>(g, lane);
        case A_RECEIVE_GET_STATE: return cp_receive_get_state(g, lane);
        case A_RECEIVE_NEW_STATE: return cp_receive_new_state<MODEL>(g, lane);
        case A_CRASH: return cp_crash<MODEL>(g, lane, crash_limit);
        case A_RECEIVE_GET_CHECKPOINT:
            return cp_receive_get_checkpoint(g, lane);
        case A_RECEIVE_NEW_CHECKPOINT:
            return cp_receive_new_checkpoint(g, lane);
        case A_RECEIVE_RECOVERY: return cp_receive_recovery(g, lane);
        case A_RECEIVE_RECOVERY_RESPONSE:
            return cp_receive_recovery_response(g, lane);
        case A_COMPLETE_RECOVERY: return cp_complete_recovery<MODEL>(g, lane);
        }
    }
    switch (a) {
    case A_TIMER_SEND_SVC: return timer_send_svc<MODEL>(g, lane,
                                                        timer_limit);
    case A_RECEIVE_HIGHER_SVC: return receive_higher<MODEL>(g, lane, M_SVC);
    case A_RECEIVE_MATCHING_SVC:
        return receive_matching<MODEL>(g, lane, M_SVC);
    case A_SEND_DVC: return send_dvc<MODEL>(g, lane);
    case A_RECEIVE_HIGHER_DVC: return receive_higher<MODEL>(g, lane, M_DVC);
    case A_RECEIVE_MATCHING_DVC:
        return receive_matching<MODEL>(g, lane, M_DVC);
    case A_SEND_SV: return send_sv<MODEL>(g, lane);
    case A_RECEIVE_SV: return receive_sv<MODEL>(g, lane);
    case A_RECEIVE_CLIENT_REQUEST:
        return receive_client_request<MODEL>(g, lane);
    case A_RECEIVE_PREPARE: return receive_prepare<MODEL>(g, lane);
    case A_RECEIVE_PREPARE_OK: return receive_prepare_ok(g, lane);
    case A_EXECUTE_OP: return execute_op<MODEL>(g, lane);
    case A_SEND_GET_STATE: return send_get_state(g, lane);
    case A_RECEIVE_GET_STATE: return receive_get_state(g, lane);
    case A_RECEIVE_NEW_STATE: return receive_new_state<MODEL>(g, lane);
    case A_NO_PROGRESS_CHANGE: return no_progress_change(g, lane, np_limit);
    case A_RESEND_SVC: return resend_svc(g, lane);
    }
    if constexpr (RECOVERY<MODEL> && !CHECKPOINTS<MODEL>) {
        switch (a) {
        case A_CRASH: return crash<MODEL>(g, lane, crash_limit);
        case A_RECEIVE_RECOVERY: return receive_recovery<MODEL>(g, lane);
        case A_RECEIVE_RECOVERY_RESPONSE:
            return receive_recovery_response<MODEL>(g, lane);
        case A_COMPLETE_RECOVERY: return complete_recovery<MODEL>(g, lane);
        case A_RETRY_RECOVERY: return retry_recovery<MODEL>(g, lane);
        }
    }
    return false;
}

template <int MODEL>
__global__ void actions_kernel(
        const int* __restrict__ flat, int lanes,
        const int* __restrict__ pidx, const int* __restrict__ aid,
        const int* __restrict__ lane_of, const int* __restrict__ planes,
        const int* __restrict__ amap, int R, int V, int M, int OPS,
        int NHDR, int timer_limit, int np_limit, int crash_limit,
        int inv_mask, const long long* __restrict__ halt,
        int* __restrict__ succ,
        uint8_t* __restrict__ en2, int* __restrict__ err,
        int* __restrict__ ts, int* __restrict__ tn, int* __restrict__ ri,
        uint8_t* __restrict__ iok) {
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
        g.rc = CHECKPOINTS<MODEL> ? g.rl + OPS : nullptr;
        g.ts = g.rl + 2 * OPS;
        g.re = 0;
        for (int t = 0; t <= R; ++t) g.ts[t] = -1;
        g.tn = 0;
        const int a = amap[aid[n]], lane = lane_of[n];
        ri[n] = lane_replica<MODEL>(g, a, lane);
        en2[n] = apply<MODEL>(g, a, lane, timer_limit, np_limit,
                              crash_limit);
        err[n] = g.at(P_ERR, 0);
        for (int t = 0; t <= R; ++t) ts[n * (R + 1) + t] = g.ts[t];
        tn[n] = g.tn;
        iok[n] = g.invariants<MODEL>(inv_mask, timer_limit);
    }
    __syncthreads();
    int* dst = succ + n * lanes;
    for (int l = threadIdx.x; l < lanes; l += blockDim.x) dst[l] = row[l];
}

// K18: one thread a state, on its row where it lies; no action runs, so
// the scratch of St stays unset
template <int MODEL>
__global__ void state_pred_kernel(
        const int* __restrict__ flat, int lanes, int N,
        const int* __restrict__ planes, const int* __restrict__ fbit,
        int nbits, int R, int V, int M, int OPS, int NHDR, int timer_limit,
        int mask, int* __restrict__ out) {
    const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (n >= N) return;
    St g;
    g.s = const_cast<int*>(flat + n * lanes);
    g.off = planes;
    g.R = R; g.V = V; g.M = M; g.OPS = OPS; g.NHDR = NHDR;
    g.mh = g.rh = g.rl = g.rc = g.ts = nullptr;
    g.re = g.tn = 0;
    int bits = 0;
    for (int b = 0; b < nbits; ++b)
        if (mask >> b & 1)
            bits |= (g.invariants<MODEL>(1 << fbit[b], timer_limit) ? 1 : 0)
                    << b;
    out[n] = bits;
}

template <int MODEL>
int launch_state_pred(const void* flat, int lanes, int N, const void* planes,
                      const void* fbit, int nbits, int R, int V, int M,
                      int OPS, int NHDR, int timer_limit, int mask,
                      void* out, void* stream) {
    if (nbits > N_FAMILY_INVARIANTS || (nbits < 31 && (mask >> nbits)))
        return (int)cudaErrorInvalidValue;
    if (N > 0) {
        cudaStream_t st = (cudaStream_t)stream;
        KLAUNCH(state_pred_kernel<MODEL>, tpuvsr_blocks(N, THREADS), THREADS,
            st, (const int*)flat, lanes, N, (const int*)planes,
            (const int*)fbit, nbits, R, V, M, OPS, NHDR, timer_limit, mask,
            (int*)out);
    }
    return (int)cudaGetLastError();
}

template <int MODEL>
int launch_actions(const void* flat, int lanes, const void* pidx,
                   const void* aid, const void* lane, int N,
                   const void* planes, const void* amap, int R, int V,
                   int M, int OPS, int NHDR, int timer_limit, int np_limit,
                   int crash_limit, int inv_mask, const void* halt,
                   void* succ, void* en2, void* err, void* ts, void* tn,
                   void* ri, void* iok, void* stream) {
    if (N > 0) {
        // the row and the scratch words of one block
        const size_t smem = (size_t)(lanes + 2 * NHDR + 2 * OPS + R + 1) *
                            sizeof(int);
        if (NHDR < (CHECKPOINTS<MODEL> ? H_CP + 1 : N_ROWHDR) ||
                smem > 48 * 1024)
            return (int)cudaErrorInvalidValue;
        cudaStream_t st = (cudaStream_t)stream;
        KLAUNCH_SMEM(actions_kernel<MODEL>, N, THREADS, smem, st,
            (const int*)flat, lanes, (const int*)pidx, (const int*)aid,
            (const int*)lane, (const int*)planes, (const int*)amap, R, V,
            M, OPS, NHDR, timer_limit, np_limit, crash_limit, inv_mask,
            (const long long*)halt, (int*)succ, (uint8_t*)en2, (int*)err,
            (int*)ts, (int*)tn, (int*)ri, (uint8_t*)iok);
    }
    return (int)cudaGetLastError();
}

}  // namespace

// flat: [T, lanes] int32 parent rows; pidx, aid, lane: [N] int32 work
// queue (aid: the model's action index); planes: [N_ST03_PLANES] int32
// plane offsets (ALL_KEYS order; [N_FAMILY_PLANES] for the other models,
// -1 for a plane the model lacks); amap: the model's action index ->
// family action id; crash_limit: CrashLimit (0 without recovery);
// inv_mask: family invariant bits; halt: one int64
// word or null; succ: [N, lanes] int32; en2, iok: [N] uint8; err, tn,
// ri: [N] int32; ts: [N, R + 1] int32.  One entry point a model, all
// with this signature.
#define TPUVSR_ACTIONS_ENTRY(name, MODEL)                                 \
    TPUVSR_EXPORT int tpuvsr_##name##_actions(                            \
            const void* flat, int lanes, const void* pidx, const void* aid, \
            const void* lane, int N, const void* planes, const void* amap, \
            int R, int V, int M, int OPS, int NHDR, int timer_limit,      \
            int np_limit, int crash_limit, int inv_mask, const void* halt, \
            void* succ, void* en2, void* err, void* ts, void* tn,         \
            void* ri, void* iok, void* stream) {                          \
        return launch_actions<MODEL>(                                     \
            flat, lanes, pidx, aid, lane, N, planes, amap, R, V, M, OPS,  \
            NHDR, timer_limit, np_limit, crash_limit, inv_mask, halt,     \
            succ, en2, err, ts, tn, ri, iok, stream);                     \
    }

TPUVSR_ACTIONS_ENTRY(st03, MODEL_ST03)
TPUVSR_ACTIONS_ENTRY(a01, MODEL_A01)
TPUVSR_ACTIONS_ENTRY(i01, MODEL_I01)
TPUVSR_ACTIONS_ENTRY(as04, MODEL_AS04)
TPUVSR_ACTIONS_ENTRY(rr05, MODEL_RR05)
TPUVSR_ACTIONS_ENTRY(al05, MODEL_AL05)
TPUVSR_ACTIONS_ENTRY(cp06, MODEL_CP06)

// K18.  flat: [N, lanes] int32 rows; planes: as K14's; fbit: [nbits]
// int32, the family bit (FamilyInvariant order) of each entry of the
// model's INVARIANT_FNS; mask: bits of INVARIANT_FNS to evaluate; out:
// [N] int32, bit b set iff entry b holds (bits outside mask 0).  One
// entry point a model, all with this signature.
#define TPUVSR_STATE_PRED_ENTRY(name, MODEL)                              \
    TPUVSR_EXPORT int tpuvsr_##name##_state_pred(                         \
            const void* flat, int lanes, int N, const void* planes,       \
            const void* fbit, int nbits, int R, int V, int M, int OPS,    \
            int NHDR, int timer_limit, int mask, void* out,               \
            void* stream) {                                               \
        return launch_state_pred<MODEL>(                                  \
            flat, lanes, N, planes, fbit, nbits, R, V, M, OPS, NHDR,      \
            timer_limit, mask, out, stream);                              \
    }

TPUVSR_STATE_PRED_ENTRY(st03, MODEL_ST03)
TPUVSR_STATE_PRED_ENTRY(a01, MODEL_A01)
TPUVSR_STATE_PRED_ENTRY(i01, MODEL_I01)
TPUVSR_STATE_PRED_ENTRY(as04, MODEL_AS04)
TPUVSR_STATE_PRED_ENTRY(rr05, MODEL_RR05)
TPUVSR_STATE_PRED_ENTRY(al05, MODEL_AL05)
TPUVSR_STATE_PRED_ENTRY(cp06, MODEL_CP06)
