// K11: the FPSet's gid column — store, and the read-only probe that
// serves both lookup_gids and query_core.
//
// Replaces tpuvsr/engine/fpset.py:store_gids (:223), lookup_gids
// (:270) and query_core (:193); insert_gids (:256) is K1 then this
// store, and grow (:289-333) rebuilds the column through it.  The
// table is K1's slots[CAP, 5] uint32 layout (tag, row0, row1, row2,
// claim), probed from _slot_hash of the keyed fingerprint (word 0
// remapped 0 -> 1), at most 64 probes (the chain of common.cuh,
// tpuvsr_keyed and tpuvsr_probe, which K17 shares); the gid column is
// a separate int32[CAP] array, -1 where nothing was stored.
//
//   store   each masked lane walks its chain until it meets its own
//           (tag, row0..2) and writes its gid into the column at that
//           slot; like the JAX loop it does not stop at an empty slot
//           (a fingerprint is stored before its gid, so it is found
//           first), and a lane not found in 64 probes writes nothing.
//           Two masked lanes with one fingerprint race for the slot:
//           either gid may stay (the JAX scatter lets any writer win).
//   probe   each masked lane walks its chain until its own slot (found)
//           or an empty slot (absent).  With a gid column it writes the
//           found slot's gid, else -1 (lookup_gids); without one it
//           writes fresh = absent and raises the overflow word for a
//           lane unresolved after 64 probes (query_core).
//
// What bounds it on the H100: one to a few random reads a lane of the
// 16 bytes (tag, row0..2) of a 20-byte slot row (the claim word is not
// read), plus a 4-byte column read or write, over a table of up to
// 1.3 GB: memory latency.  The least time is the bytes the lanes need
// (fingerprint in, 16 bytes of one slot row and one column word each,
// result out) over the memory rate.
//
// Design.  One thread per lane, no shared state: the store runs after
// K1's insert has finished (stream order), so every row it reads is
// published, and a lookup that must see a tile's stores is a launch of
// its own after the store's.
#include "common.cuh"

namespace {

__global__ void store_gids_kernel(const uint32_t* __restrict__ slots,
                                  uint32_t capm, int* __restrict__ vals,
                                  const uint32_t* __restrict__ fps,
                                  const int* __restrict__ gids,
                                  const uint8_t* __restrict__ mask,
                                  int n) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n || !mask[i]) return;
    uint32_t k[4];
    tpuvsr_keyed(fps, i, k);
    const uint32_t h = tpuvsr_slot_hash(k[0], k[1], k[2], k[3]);
    for (int t = 0; t < TPUVSR_MAX_PROBES; ++t) {
        const uint32_t idx = (h + (uint32_t)t) & capm;
        if (tpuvsr_slot_is(slots + 5 * (size_t)idx, k)) {
            vals[idx] = gids[i];
            return;
        }
    }
}

__global__ void probe_kernel(const uint32_t* __restrict__ slots,
                             uint32_t capm, const int* __restrict__ vals,
                             const uint32_t* __restrict__ fps,
                             const uint8_t* __restrict__ mask, int n,
                             int* __restrict__ out_gid,
                             uint8_t* __restrict__ out_fresh,
                             int* __restrict__ overflow) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    if (vals) out_gid[i] = -1;
    else out_fresh[i] = 0;
    if (!mask[i]) return;
    uint32_t k[4];
    tpuvsr_keyed(fps, i, k);
    const long long idx = tpuvsr_probe(slots, capm, k);
    if (idx >= 0) {
        if (vals) out_gid[i] = vals[idx];
    } else if (idx == -1) {
        if (!vals) out_fresh[i] = 1;
    } else if (!vals) {
        atomicExch(overflow, 1);
    }
}

}  // namespace

// slots: [cap, 5] uint32 (cap a power of two); vals: [cap] int32;
// fps: [n, 4] uint32; gids: [n] int32; mask: [n] uint8.
TPUVSR_EXPORT int tpuvsr_fpset_store_gids(const void* slots, long long cap,
                                          void* vals, const void* fps,
                                          const void* gids,
                                          const void* mask, int n,
                                          void* stream) {
    if (n > 0) {
        const int threads = 256;
        KLAUNCH(store_gids_kernel, tpuvsr_blocks(n, threads), threads,
                (cudaStream_t)stream, (const uint32_t*)slots,
                (uint32_t)(cap - 1), (int*)vals, (const uint32_t*)fps,
                (const int*)gids, (const uint8_t*)mask, n);
    }
    return (int)cudaGetLastError();
}

// lookup (vals given): out_gid [n] int32, out_fresh and overflow unused;
// query (vals null): out_fresh [n] uint8 and one int32 overflow word
// (the wrapper zeroes it), out_gid unused.
TPUVSR_EXPORT int tpuvsr_fpset_probe(const void* slots, long long cap,
                                     const void* vals, const void* fps,
                                     const void* mask, int n,
                                     void* out_gid, void* out_fresh,
                                     void* overflow, void* stream) {
    if (n > 0) {
        const int threads = 256;
        KLAUNCH(probe_kernel, tpuvsr_blocks(n, threads), threads,
                (cudaStream_t)stream, (const uint32_t*)slots,
                (uint32_t)(cap - 1), (const int*)vals,
                (const uint32_t*)fps, (const uint8_t*)mask, n,
                (int*)out_gid, (uint8_t*)out_fresh, (int*)overflow);
    }
    return (int)cudaGetLastError();
}
