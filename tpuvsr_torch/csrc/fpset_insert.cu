// K1: FPSet batch insert into the device-resident fingerprint table.
//
// Replaces tpuvsr/engine/fpset.py:insert_core (with _keyed and
// _slot_hash).  The table is the JAX package's slots[CAP, 5] uint32
// layout: (tag, row0, row1, row2, claim), tag = fingerprint word 0
// remapped 0 -> 1 (0 marks an empty slot), claim = the batch lane that
// inserted the slot.  Linear probing from _slot_hash of the keyed
// fingerprint, at most MAX_PROBES = 64 probes.
//
// What bounds it on the H100: random 20-byte row reads and writes, one
// or a few per lane, spread over a table of up to 1.3 GB (2^26 slots) —
// memory latency, not bandwidth or arithmetic.  The least time is the
// bytes it must move (each lane's fingerprint and mask read, its row
// written when fresh) over the memory rate.
//
// Design.  One thread per lane.  The JAX version claims with one
// scatter and re-reads to name the winner (claim-then-verify, all
// lanes in lock step).  A thread here claims a slot with an atomic
// compare-and-swap instead, so no lane waits for the others:
//   1. claim: CAS the slot's claim word from 0 to BUSY (0xFFFFFFFF,
//      never a lane id); if the tag is still 0 the slot is ours: write
//      row0..2, fence, publish the tag, fence, store our lane id in the
//      claim word (fresh).  If the tag was set meanwhile (an occupied
//      slot whose claim word holds lane id 0), restore the claim word;
//   2. a lane that meets an occupied slot waits until its claim word
//      is not BUSY (the writer has published row0..2), then compares
//      (tag, row0..2): equal means duplicate, else it probes on.
// Two lanes with equal fingerprints follow one probe chain, so the one
// that loses the claim always meets the winner's slot and resolves as
// a duplicate: exactly one lane per distinct new fingerprint is fresh.
// A lane unresolved after 64 probes sets the overflow flag and inserts
// nothing.  Which of two lanes with EQUAL fingerprints is fresh depends
// on the order the claims land (the engine dedups a batch before it
// inserts, so its batches hold no equal fingerprints).
#include "common.cuh"

namespace {

constexpr uint32_t BUSY = 0xFFFFFFFFu;
constexpr int MAX_PROBES = 64;

__global__ void fpset_insert_kernel(uint32_t* __restrict__ slots,
                                    uint32_t capm,
                                    const uint32_t* __restrict__ fps,
                                    const uint8_t* __restrict__ mask,
                                    int n, uint8_t* __restrict__ fresh,
                                    int* __restrict__ overflow) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    fresh[i] = 0;
    if (!mask[i]) return;
    uint32_t k0 = fps[4 * (size_t)i + 0];
    const uint32_t k1 = fps[4 * (size_t)i + 1];
    const uint32_t k2 = fps[4 * (size_t)i + 2];
    const uint32_t k3 = fps[4 * (size_t)i + 3];
    if (k0 == 0) k0 = 1;                        // _keyed: 0 marks empty
    const uint32_t h = tpuvsr_slot_hash(k0, k1, k2, k3);
    for (int t = 0; t < MAX_PROBES; ++t) {
        uint32_t* row = slots + 5 * (size_t)((h + (uint32_t)t) & capm);
        uint32_t tag = tpuvsr_load(row);
        if (tag == 0) {
            uint32_t old = atomicCAS(row + 4, 0u, BUSY);
            if (old != 0u) {
                // another lane is claiming (BUSY) or the slot is
                // occupied: look again at this slot
                --t;
                continue;
            }
            __threadfence();
            tag = tpuvsr_load(row);
            if (tag == 0) {
                row[1] = k1;
                row[2] = k2;
                row[3] = k3;
                __threadfence();
                atomicExch(row, k0);
                __threadfence();
                atomicExch(row + 4, (uint32_t)i);
                fresh[i] = 1;
                return;
            }
            // occupied by a lane whose id is 0: give the claim word back
            atomicExch(row + 4, 0u);
        }
        __threadfence();
        while (tpuvsr_load(row + 4) == BUSY) {
        }
        __threadfence();
        if (tag == k0 && tpuvsr_load(row + 1) == k1 &&
                tpuvsr_load(row + 2) == k2 && tpuvsr_load(row + 3) == k3) {
            return;                                  // duplicate
        }
    }
    atomicExch(overflow, 1);
}

}  // namespace

// slots: [cap, 5] uint32 (cap a power of two); fps: [n, 4] uint32;
// mask, fresh: [n] uint8; overflow: one int32, set to 1 when some
// masked lane stayed unresolved (the wrapper zeroes it).
TPUVSR_EXPORT int tpuvsr_fpset_insert(void* slots, long long cap,
                                      const void* fps, const void* mask,
                                      int n, void* fresh, void* overflow,
                                      void* stream) {
    if (n > 0) {
        const int threads = 256;
        KLAUNCH(fpset_insert_kernel, tpuvsr_blocks(n, threads), threads,
                (cudaStream_t)stream, (uint32_t*)slots,
                (uint32_t)(cap - 1), (const uint32_t*)fps,
                (const uint8_t*)mask, n, (uint8_t*)fresh, (int*)overflow);
    }
    return (int)cudaGetLastError();
}
