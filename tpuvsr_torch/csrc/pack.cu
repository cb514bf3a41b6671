// K4: packed frontier encoding, pack and unpack.
//
// Replaces tpuvsr/engine/pack.py:PackSpec.pack and PackSpec.unpack.
// A dense state is a flat row of int32 lanes; lane l keeps bits[l] bits
// of (value - lo[l]) at bit position start[l] of a little-endian stream
// of uint32 words (a lane may straddle two words).  The JAX version
// builds each word with a segment_sum of disjoint shifted fields; the
// sum of disjoint fields is their OR.
//
// What bounds it on the H100: bytes.  Pack reads 4 x lanes bytes and
// writes 4 x words bytes per state (1,900 -> 476 at the defect layout);
// unpack the reverse.  Per-lane work is a few shifts.
//
// Design.  Pack: one thread per (state, word) ORs the fields that land
// in its word, listed by a word -> (lane, low/high part) table built on
// the host (word_ptr, word_lane, word_part); it writes whole words, so
// it can scatter straight into a row of the next-frontier buffer
// (dest[b] = output row, -1 = skip), as the fused commit's scatter
// does.  The JAX version masks a value to its lane's width with no
// check; here a packed field whose biased value has bits outside its
// mask sets the one-word flag oob (a race of equal writes), which the
// engines read with their next host read and fail the run on, so a
// value never wraps unseen.  Unpack: one thread per (state, lane) reads
// the one or two words its field spans, from frontier row rows[b] (the
// gather of the tile's states is fused in), and writes the int32 lane.
#include "common.cuh"

namespace {

__global__ void pack_kernel(const int* __restrict__ flat, int B, int lanes,
                            int words, const int* __restrict__ lo,
                            const uint32_t* __restrict__ lmask,
                            const uint32_t* __restrict__ off,
                            const uint32_t* __restrict__ hishift,
                            const int* __restrict__ word_ptr,
                            const int* __restrict__ word_lane,
                            const uint8_t* __restrict__ word_part,
                            const int* __restrict__ dest,
                            uint32_t* __restrict__ out,
                            int* __restrict__ oob) {
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= (long long)B * words) return;
    const int b = (int)(t / words), w = (int)(t % words);
    const int row = dest ? dest[b] : b;
    if (row < 0) return;
    const int* st = flat + (size_t)b * lanes;
    uint32_t acc = 0, wide = 0;
    for (int e = word_ptr[w]; e < word_ptr[w + 1]; ++e) {
        const int l = word_lane[e];
        const uint32_t raw = (uint32_t)st[l] - (uint32_t)lo[l];
        const uint32_t v = raw & lmask[l];
        wide |= raw & ~lmask[l];
        acc |= word_part[e] ? ((v >> hishift[l]) >> 1) : (v << off[l]);
    }
    out[(size_t)row * words + w] = acc;
    if (wide) *oob = 1;
}

__global__ void unpack_kernel(const uint32_t* __restrict__ packed,
                              const long long* __restrict__ rows, int B,
                              int lanes, int words,
                              const int* __restrict__ lo,
                              const uint32_t* __restrict__ lmask,
                              const int* __restrict__ widx,
                              const uint32_t* __restrict__ off,
                              const uint32_t* __restrict__ hishift,
                              int* __restrict__ flat) {
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= (long long)B * lanes) return;
    const int b = (int)(t / lanes), l = (int)(t % lanes);
    const long long row = rows ? rows[b] : b;
    const uint32_t* src = packed + (size_t)row * words;
    const int w = widx[l];
    const uint32_t w0 = src[w];
    const uint32_t w1 = src[w + 1 < words ? w + 1 : words - 1];
    const uint32_t v = ((w0 >> off[l]) | ((w1 << hishift[l]) << 1)) & lmask[l];
    flat[(size_t)b * lanes + l] = (int)(v + (uint32_t)lo[l]);
}

}  // namespace

// flat: [B, lanes] int32 -> out rows dest[b] (or b when dest is null)
// of a [rows, words] uint32 buffer; rows with dest[b] < 0 are skipped.
// oob: one int32 word, set to 1 when a packed value lies outside its
// lane's bound (never cleared here).
TPUVSR_EXPORT int tpuvsr_pack(const void* flat, int B, int lanes, int words,
                              const void* lo, const void* lmask,
                              const void* off, const void* hishift,
                              const void* word_ptr, const void* word_lane,
                              const void* word_part, const void* dest,
                              void* out, void* oob, void* stream) {
    if (B > 0) {
        const int threads = 128;
        KLAUNCH(pack_kernel, tpuvsr_blocks((long long)B * words, threads),
                threads, (cudaStream_t)stream, (const int*)flat, B, lanes,
                words, (const int*)lo, (const uint32_t*)lmask,
                (const uint32_t*)off, (const uint32_t*)hishift,
                (const int*)word_ptr, (const int*)word_lane,
                (const uint8_t*)word_part, (const int*)dest, (uint32_t*)out,
                (int*)oob);
    }
    return (int)cudaGetLastError();
}

// packed: [N, words] uint32; rows: [B] int64 row indices (or null for
// rows 0..B-1) -> flat [B, lanes] int32.
TPUVSR_EXPORT int tpuvsr_unpack(const void* packed, const void* rows, int B,
                                int lanes, int words, const void* lo,
                                const void* lmask, const void* widx,
                                const void* off, const void* hishift,
                                void* flat, void* stream) {
    if (B > 0) {
        const int threads = 256;
        KLAUNCH(unpack_kernel, tpuvsr_blocks((long long)B * lanes, threads),
                threads, (cudaStream_t)stream, (const uint32_t*)packed,
                (const long long*)rows, B, lanes, words, (const int*)lo,
                (const uint32_t*)lmask, (const int*)widx,
                (const uint32_t*)off, (const uint32_t*)hishift, (int*)flat);
    }
    return (int)cudaGetLastError();
}
