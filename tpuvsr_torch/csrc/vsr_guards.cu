// K6: the VSR guard matrix.
//
// Replaces tpuvsr/engine/device_bfs.py:_guard_matrix (:398), the vmapped
// sweep of the 19 guards of tpuvsr/models/vsr_kernel.py:805-930 over
// every (state, lane) of a batch.  The port's plain version is the loop
// over VSRKernel._guard_fns (models/vsr_kernel.py); this kernel computes
// the same [B, n_lanes] enabled matrix (lane-table order: action-major,
// then the action's lane parameter) and en_any[b] = OR over the row.
//
// What bounds it on the H100: neither bytes nor operations at the
// engine's sizes (a tile of 128 rows of 1,339 lanes, 475 guard lanes at
// MAX_MSGS 32): each row is read once (about 5 KB) and each guard is a
// handful of compares, except SendGetState's SendOnce test, which scans
// the row's M message slots for every (slot, destination) lane.  A
// launch is latency-bound.
//
// Design.  One block per state row: the block copies the row into
// shared memory (coalesced), then each thread evaluates the guards of
// its lanes from shared memory, the lane -> (action, parameter) pair
// read from the host-built lane tables, the planes located by the
// host-built plane-offset table (enum Plane below, GUARD_PLANES in
// models/vsr_kernel.py).  en_any is an OR across the block.  Integer
// arithmetic wraps as int32 does in PyTorch (view - 1, op + 1, ...);
// torch.remainder's floor modulo is kept for the primary of a view.
//
// With a halt word (the fused pass's carry) the kernel does nothing
// while it is set.
#include "common.cuh"

namespace {

enum Plane {
    P_STATUS, P_VIEW, P_OP, P_COMMIT, P_LOG_LEN, P_PEER_OP, P_CT, P_SVC,
    P_DVC, P_SENT_DVC, P_SENT_SV, P_REC_NUMBER, P_REC, P_REC_HAS_LOG,
    P_M_PRESENT, P_M_COUNT, P_M_HDR, P_M_ENTRY, P_M_LOG, P_M_LOG_LEN,
    P_M_HAS_LOG, P_AUX_SVC, P_AUX_RESTART, P_AUX_ACKED, N_PLANES
};

// the codec's encodings (models/vsr.py)
constexpr int NORMAL = 0, VIEWCHANGE = 1, RECOVERING = 2;
constexpr int M_PREPARE = 1, M_PREPAREOK = 2, M_SVC = 3, M_DVC = 4,
              M_SV = 5, M_GETSTATE = 6, M_NEWSTATE = 7, M_RECOVERY = 8,
              M_RECOVERYRESP = 9;
constexpr int H_TYPE = 0, H_VIEW = 1, H_OP = 2, H_COMMIT = 3, H_DEST = 4,
              H_SRC = 5, H_X = 6, H_FIRST = 7, H_LNV = 8;
constexpr int T_EXEC = 2;
constexpr int THREADS = 128;

struct Row {
    const int* s;       // the state row in shared memory
    const int* off;     // plane offsets
    int R, V, M, C, OPS, NHDR, NENT;

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

// the replica a message slot is addressed to, clipped into range
__device__ __forceinline__ int dest_rep(const Row& g, int k) {
    return clipi(wadd(g.hdr(k, H_DEST), -1), 0, g.R - 1);
}

__device__ __forceinline__ bool recv(const Row& g, int k) {
    return g.at(P_M_PRESENT, k) == 1 && g.at(P_M_COUNT, k) > 0;
}

// recv & type == mtype, and the slot's view against its receiver's
// view: cmp < 0 "greater", 0 "equal", > 0 "greater or equal"
__device__ bool recv_view(const Row& g, int k, int mtype, int cmp) {
    if (!recv(g, k) || g.hdr(k, H_TYPE) != mtype) return false;
    const int hv = g.hdr(k, H_VIEW), v = g.at(P_VIEW, dest_rep(g, k));
    return cmp < 0 ? hv > v : (cmp == 0 ? hv == v : hv >= v);
}

__device__ bool rep_primary(const Row& g, int r) {
    return primary(g.at(P_VIEW, r), g.R) == r + 1;
}

// a GetState record that SendOnce would find: type GetState, zero
// commit/x/first/lnv, zero entry, log and log length, no log
__device__ bool getstate_base(const Row& g, int s) {
    if (g.at(P_M_PRESENT, s) != 1 || g.hdr(s, H_TYPE) != M_GETSTATE ||
            g.hdr(s, H_COMMIT) != 0 || g.hdr(s, H_X) != 0 ||
            g.hdr(s, H_FIRST) != 0 || g.hdr(s, H_LNV) != 0 ||
            g.at(P_M_LOG_LEN, s) != 0 || g.at(P_M_HAS_LOG, s) != 0)
        return false;
    for (int e = 0; e < g.NENT; ++e)
        if (g.at(P_M_ENTRY, s * g.NENT + e) != 0) return false;
    const int nlog = g.OPS * g.NENT;
    for (int e = 0; e < nlog; ++e)
        if (g.at(P_M_LOG, s * nlog + e) != 0) return false;
    return true;
}

__device__ bool send_get_state(const Row& g, int k, int d) {
    const int r = g.hdr(k, H_DEST), i = dest_rep(g, k);
    const int view_i = g.at(P_VIEW, i);
    if (!(recv(g, k) && g.hdr(k, H_TYPE) == M_PREPARE &&
          primary(view_i, g.R) != r && g.at(P_STATUS, i) == NORMAL &&
          g.hdr(k, H_VIEW) > view_i &&
          g.hdr(k, H_OP) > wadd(g.at(P_OP, i), 1) && r != d + 1))
        return false;
    const int c = g.at(P_COMMIT, i), ll = g.at(P_LOG_LEN, i);
    const int trunc = c < ll ? c : ll;
    for (int s = 0; s < g.M; ++s)
        if (getstate_base(g, s) && g.hdr(s, H_VIEW) == g.hdr(k, H_VIEW) &&
                g.hdr(s, H_OP) == trunc && g.hdr(s, H_SRC) == r &&
                g.hdr(s, H_DEST) == d + 1)
            return false;
    return true;
}

__device__ bool guard(const Row& g, int a, int p, int timer_limit,
                      int restart_limit) {
    const int R = g.R;
    switch (a) {
    case 0:     // TimerSendSVC, lane r
        return g.at(P_AUX_SVC, 0) < timer_limit && !rep_primary(g, p);
    case 1:     // ReceiveHigherSVC, lane k
        return recv_view(g, p, M_SVC, -1);
    case 2:     // ReceiveMatchingSVC
        return recv_view(g, p, M_SVC, 0) &&
               g.at(P_STATUS, dest_rep(g, p)) == VIEWCHANGE;
    case 3: {   // SendDVC, lane r
        long long sum = 0;
        for (int j = 0; j < R; ++j) sum += g.at(P_SVC, p * R + j);
        return g.at(P_STATUS, p) == VIEWCHANGE &&
               g.at(P_SENT_DVC, p) == 0 && sum >= R / 2;
    }
    case 4:     // ReceiveHigherDVC
        return recv_view(g, p, M_DVC, -1);
    case 5:     // ReceiveMatchingDVC
        return recv_view(g, p, M_DVC, 0);
    case 6: {   // SendSV, lane r
        int n = 0;
        for (int j = 0; j < R; ++j) n += g.at(P_DVC, p * R + j) == 1;
        return g.at(P_STATUS, p) == VIEWCHANGE &&
               g.at(P_SENT_SV, p) == 0 && n >= R / 2 + 1;
    }
    case 7:     // ReceiveSV
        return recv_view(g, p, M_SV, 1);
    case 8: {   // ReceiveClientRequest, lane r * V + v
        const int r = p / g.V, v = p - r * g.V;
        return rep_primary(g, r) && g.at(P_STATUS, r) == NORMAL &&
               g.at(P_CT, r * g.C * 3 + T_EXEC) == 1 &&
               g.at(P_AUX_ACKED, v) == 0;
    }
    case 9: {   // ReceivePrepareMsg
        const int i = dest_rep(g, p);
        return recv_view(g, p, M_PREPARE, 0) &&
               g.at(P_STATUS, i) == NORMAL &&
               g.hdr(p, H_OP) == wadd(g.at(P_OP, i), 1);
    }
    case 10: {  // ReceivePrepareOkMsg
        const int i = dest_rep(g, p);
        const int j = clipi(wadd(g.hdr(p, H_SRC), -1), 0, R - 1);
        return recv_view(g, p, M_PREPAREOK, 0) &&
               primary(g.at(P_VIEW, i), R) == g.hdr(p, H_DEST) &&
               g.at(P_STATUS, i) == NORMAL &&
               g.hdr(p, H_OP) > g.at(P_PEER_OP, i * R + j);
    }
    case 11: {  // ExecuteOp, lane r
        const int opn = wadd(g.at(P_COMMIT, p), 1);
        int n = 0;
        for (int j = 0; j < R; ++j) n += g.at(P_PEER_OP, p * R + j) >= opn;
        return rep_primary(g, p) && g.at(P_STATUS, p) == NORMAL &&
               g.at(P_COMMIT, p) < g.at(P_OP, p) && n >= R / 2;
    }
    case 12:    // SendGetState, lane k * R + (destination - 1)
        return send_get_state(g, p / R, p - (p / R) * R);
    case 13: {  // ReceiveGetState
        const int i = dest_rep(g, p);
        return recv_view(g, p, M_GETSTATE, 0) &&
               g.at(P_STATUS, i) == NORMAL &&
               g.at(P_OP, i) > g.hdr(p, H_OP);
    }
    case 14: {  // ReceiveNewState
        const int i = dest_rep(g, p);
        return recv_view(g, p, M_NEWSTATE, 0) &&
               g.at(P_STATUS, i) == NORMAL &&
               g.at(P_OP, i) == wadd(g.hdr(p, H_FIRST), -1);
    }
    case 15:    // RestartEmpty, lane r
        return g.at(P_AUX_RESTART, 0) < restart_limit;
    case 16:    // ReceivesRecoveryMsg
        return recv(g, p) && g.hdr(p, H_TYPE) == M_RECOVERY &&
               g.at(P_STATUS, dest_rep(g, p)) == NORMAL;
    case 17: {  // ReceivesRecoveryResponseMsg
        const int i = dest_rep(g, p);
        return recv(g, p) && g.hdr(p, H_TYPE) == M_RECOVERYRESP &&
               g.at(P_REC_NUMBER, i) == g.hdr(p, H_X) &&
               g.at(P_STATUS, i) == RECOVERING;
    }
    case 18: {  // CompleteRecovery, lane r
        int n = 0;
        bool cand = false;
        for (int j = 0; j < R; ++j) {
            const bool got = g.at(P_REC, p * R + j) == 1;
            n += got;
            cand = cand || (got && g.at(P_REC_HAS_LOG, p * R + j) == 1);
        }
        return g.at(P_STATUS, p) == RECOVERING && n > R / 2 && cand;
    }
    }
    return false;
}

__global__ void guards_kernel(const int* __restrict__ flat, int lanes,
                              int n_lanes, int R, int V, int M, int C,
                              int OPS, int NHDR, int NENT, int timer_limit,
                              int restart_limit,
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
    Row g{row, planes, R, V, M, C, OPS, NHDR, NENT};
    int mine = 0;
    uint8_t* out = en + (size_t)b * n_lanes;
    for (int l = threadIdx.x; l < n_lanes; l += blockDim.x) {
        const bool e = guard(g, lane_action[l], lane_param[l], timer_limit,
                             restart_limit);
        out[l] = e;
        mine |= e;
    }
    if (mine) atomicOr(&any, 1);
    __syncthreads();
    if (threadIdx.x == 0) en_any[b] = any != 0;
}

}  // namespace

// flat: [B, lanes] int32 state rows; planes: [N_PLANES] int32 plane
// offsets; lane_action, lane_param: [n_lanes] int32; halt: one int64
// word or null; en: [B, n_lanes] uint8; en_any: [B] uint8.
TPUVSR_EXPORT int tpuvsr_vsr_guards(const void* flat, int B, int lanes,
                                    int n_lanes, int R, int V, int M, int C,
                                    int OPS, int NHDR, int NENT,
                                    int timer_limit, int restart_limit,
                                    const void* planes,
                                    const void* lane_action,
                                    const void* lane_param, const void* halt,
                                    void* en, void* en_any, void* stream) {
    if (B > 0) {
        const size_t smem = (size_t)lanes * sizeof(int);
        if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
        cudaStream_t st = (cudaStream_t)stream;
        KLAUNCH_SMEM(guards_kernel, B, THREADS, smem, st,
            (const int*)flat, lanes, n_lanes, R, V, M, C, OPS, NHDR, NENT,
            timer_limit, restart_limit, (const int*)planes,
            (const int*)lane_action, (const int*)lane_param,
            (const long long*)halt, (uint8_t*)en, (uint8_t*)en_any);
    }
    return (int)cudaGetLastError();
}
