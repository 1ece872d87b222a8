// Byte pattern mark for Hopper (sm_90a).
//
// Replaces the TPU kernel gpu_mapreduce_tpu/ops/pallas/match.py
// :: _mark_kernel (launched by mark_pallas; XLA twin mark_xla).
//
// What it computes: over a byte buffer of n bytes, one int8 per byte:
// 1 where the pattern starts at byte i, else 0.  Bytes past n read as 0,
// as mark_xla's zero concat and the TPU kernel's zero padding make them,
// so a pattern that ends in '\0' matches at the tail.  Any pattern period
// is fine, and patterns of 1 to 128 bytes are taken: 128 is the reach of
// the TPU kernel's one-row (128-lane) halo.
//
// The TPU kernel widens every byte to an int32 lane of a [256, 128] block
// and builds each shifted view from two 128-lane rolls, with the next
// block's first row as a halo.  None of that carries over.
//
// The math is the word mark's (csrc/mark_words.cu) with every alignment
// kept: over the little-endian u32 words w of the buffer, byte 4i+a is a
// hit iff (w[i+j] ^ val[a][j]) & mask[a][j] == 0 for every j < nw, with
// nw = (len(pattern)+6)/4 words and the tables the wrapper builds
// (ops/cuda/match._alignment_tables).  Each alignment writes its own
// output byte, so two alignments of one word may both match.  Words 0
// and 1 are tested for all four alignments in registers (the whole
// pattern when nw <= 2); the rest only for the candidates that survive
// them, which on text are the rare places where the pattern's first 5 to
// 8 bytes occur.
//
// Bound on an H100 SXM: memory.  It reads n bytes and writes n bytes, 2n
// in all (~0.16 ms for the 256 MB corpus at 3.35 TB/s), and does about 25
// integer operations a word.  One thread a byte with one-byte loads is
// bound by load/store instructions instead.  So a warp owns a span of
// 2 KB as 4 rows of 32 16-byte chunks: a thread loads its chunk of each
// row with one 16-byte load and stores its 16 codes with one 16-byte
// store, and each of those warp instructions covers 512 contiguous bytes.
// The word after a chunk (the prefilter's halo) comes from the next lane
// by __shfl_down_sync, or for lane 31 from lane 0's chunk of the next row
// by __shfl_sync; the last chunk of a span, and a chunk whose successor
// is past the last whole chunk, load it themselves (zero past n).  The
// prefilter's tables are read from the kernel parameters at indices
// known at compile time; the candidates' loop reads the rest from a copy
// in shared memory, so nothing is copied to a stack frame and the kernel
// is one function for every pattern length.  The hits of a span live in
// one 64-bit mask a thread until they are spread to bytes for the store.
// A persistent grid of a few blocks a SM runs a grid-stride loop over
// spans.  Chunks start at the first 16-byte boundary of `buf`; the up to
// 15 bytes before it (a view such as buf[1:]) and the up to 15 after the
// last whole chunk are done one byte a thread by block 0 in the same
// launch.  Nothing reads past byte n-1.  The caller places `out` so that
// out + head is 16-byte aligned.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_PAT 128       // pattern bytes (ops/cuda/match.MAX_PAT)
#define MAX_NW ((MAX_PAT + 6) / 4)   // 33 words
#define CHUNK 16          // bytes a thread loads and stores at once
#define ROWS 4            // chunks a thread owns in its warp's span
#define SPAN_CHUNKS (32 * ROWS)      // a warp's span: 2 KB
#define THREADS 256
#define BLOCKS_PER_SM 4
#define FULL_MASK 0xFFFFFFFFu

struct MarkTables {
    uint32_t mask[4][MAX_NW];   // 0xFF at the pattern's byte positions
    uint32_t val[4][MAX_NW];    // the pattern's bytes, already & mask
};

// The little-endian word of bytes off..off+3, zero past n, byte by byte.
__device__ __forceinline__ uint32_t word_at(const uint8_t* buf, int64_t n,
                                            int64_t off) {
    uint32_t v = 0u;
#pragma unroll
    for (int b = 0; b < 4; ++b)
        if (off + b < n) v |= (uint32_t)__ldg(buf + off + b) << (8 * b);
    return v;
}

// The same at a 4-byte aligned `off`: one load when the word is whole.
__device__ __forceinline__ uint32_t aligned_word(const uint8_t* buf,
                                                 int64_t n, int64_t off) {
    return off + 4 <= n
        ? __ldg(reinterpret_cast<const uint32_t*>(buf + off))
        : word_at(buf, n, off);
}

// Bit a set when words 0 and 1 of alignment a match at the window w0, w1.
__device__ __forceinline__ uint32_t prefilter(uint32_t w0, uint32_t w1,
                                              const MarkTables& t) {
    uint32_t bits = 0u;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
        const uint32_t miss = ((w0 ^ t.val[a][0]) & t.mask[a][0])
                              | ((w1 ^ t.val[a][1]) & t.mask[a][1]);
        bits |= (miss == 0u ? 1u : 0u) << a;
    }
    return bits;
}

__global__ void __launch_bounds__(THREADS)
mark_bytes_kernel(const uint8_t* __restrict__ buf, int8_t* __restrict__ out,
                  int64_t n, int64_t head, int nw, const MarkTables t) {
    __shared__ uint32_t smask[4][MAX_NW];
    __shared__ uint32_t sval[4][MAX_NW];
    if (threadIdx.x == 0) {
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int j = 0; j < MAX_NW; ++j) {
                smask[a][j] = t.mask[a][j];
                sval[a][j] = t.val[a][j];
            }
    }
    __syncthreads();
    const int64_t nchunks = (n - head) / CHUNK;
    const int64_t tail = head + nchunks * CHUNK;
    if (blockIdx.x == 0) {                      // scalar head and tail
        const int64_t r = threadIdx.x;
        const int64_t i = r < head ? r : tail + (r - head);
        if (i < n && (r < head || i >= tail)) {
            bool hit = true;
            for (int j = 0; j < nw && hit; ++j)
                hit = ((word_at(buf, n, i + 4 * j) ^ sval[0][j])
                       & smask[0][j]) == 0u;
            out[i] = hit ? (int8_t)1 : (int8_t)0;
        }
    }
    const uint4* b4 = reinterpret_cast<const uint4*>(buf + head);
    uint4* o4 = reinterpret_cast<uint4*>(out + head);
    const int lane = threadIdx.x & 31;
    const int64_t nwarps = (int64_t)gridDim.x * (THREADS / 32);
    const int64_t warp = (int64_t)blockIdx.x * (THREADS / 32)
                         + (threadIdx.x >> 5);
    const int64_t nspans = (nchunks + SPAN_CHUNKS - 1) / SPAN_CHUNKS;
    // uniform trip count across the warp, so the full-mask shuffles are valid
    for (int64_t s = warp; s < nspans; s += nwarps) {
        const int64_t c0 = s * SPAN_CHUNKS + lane;   // chunk of row 0
        uint4 v[ROWS];
#pragma unroll
        for (int q = 0; q < ROWS; ++q)
            v[q] = c0 + 32 * q < nchunks ? __ldg(b4 + c0 + 32 * q)
                                         : make_uint4(0u, 0u, 0u, 0u);
        // bit 16q + 4i + a: the pattern may start at byte a of word i of
        // row q's chunk
        uint64_t hits = 0u;
#pragma unroll
        for (int q = 0; q < ROWS; ++q) {
            const int64_t c = c0 + 32 * q;
            uint32_t next = __shfl_down_sync(FULL_MASK, v[q].x, 1);
            if (q + 1 < ROWS) {
                const uint32_t wrap = __shfl_sync(FULL_MASK, v[q + 1].x, 0);
                if (lane == 31) next = wrap;
            }
            if (c < nchunks) {
                if ((lane == 31 && q + 1 == ROWS) || c + 1 >= nchunks)
                    next = aligned_word(buf, n, head + CHUNK * (c + 1));
                const uint64_t row = prefilter(v[q].x, v[q].y, t)
                    | prefilter(v[q].y, v[q].z, t) << 4
                    | prefilter(v[q].z, v[q].w, t) << 8
                    | prefilter(v[q].w, next, t) << 12;
                hits |= row << (16 * q);
            }
        }
        // words 2..nw-1 for the candidates
        uint64_t cand = nw > 2 ? hits : 0u;
        while (cand != 0u) {
            const int b = __ffsll((long long)cand) - 1;
            cand &= cand - 1;
            const int a = b & 3;
            const int64_t k = 4 * (c0 + 32 * (b >> 4)) + ((b >> 2) & 3);
            for (int j = 2; j < nw; ++j) {
                const uint32_t x = aligned_word(buf, n, head + 4 * (k + j));
                if (((x ^ sval[a][j]) & smask[a][j]) != 0u) {
                    hits &= ~(1ull << b);
                    break;
                }
            }
        }
#pragma unroll
        for (int q = 0; q < ROWS; ++q) {
            if (c0 + 32 * q < nchunks) {
                uint32_t h[4];
#pragma unroll
                for (int i = 0; i < 4; ++i)   // the 4 bits to 4 bytes
                    h[i] = ((uint32_t)(hits >> (16 * q + 4 * i)) & 0xFu)
                           * 0x204081u & 0x01010101u;
                o4[c0 + 32 * q] = make_uint4(h[0], h[1], h[2], h[3]);
            }
        }
    }
}

// masks, vals: host arrays [4][nw] row-major, nw = (len+6)/4 for a
// pattern of len bytes (1 <= len <= MAX_PAT).  `out` must be 16-byte
// aligned at the first 16-byte boundary of `buf` (out + head, head = the
// bytes before it), else cudaErrorMisalignedAddress.
// Launches on `stream` of device `dev` and returns cudaGetLastError() (0
// on success); does not synchronise.
extern "C" int mark_bytes_launch(const void* buf, void* out, int64_t n,
                                 const uint32_t* masks, const uint32_t* vals,
                                 int len, int dev, void* stream) {
    if (len < 1 || len > MAX_PAT || n < 0) return (int)cudaErrorInvalidValue;
    const int nw = (len + 6) / 4;
    if (n == 0) return (int)cudaSuccess;
    int64_t head = (int64_t)((16 - ((uintptr_t)buf & 15)) & 15);
    if (head > n) head = n;
    if (((uintptr_t)((int8_t*)out + head) & 15) != 0)
        return (int)cudaErrorMisalignedAddress;
    cudaError_t err = cudaSetDevice(dev);
    if (err != cudaSuccess) return (int)err;
    MarkTables t = {};
    for (int a = 0; a < 4; ++a)
        for (int j = 0; j < nw; ++j) {
            t.mask[a][j] = masks[a * nw + j];
            t.val[a][j] = vals[a * nw + j] & masks[a * nw + j];
        }
    int nsm = 0;
    cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
    if (nsm <= 0) nsm = 132;
    const int64_t nspans = ((n - head) / CHUNK + SPAN_CHUNKS - 1)
                           / SPAN_CHUNKS;
    const int64_t need = (nspans + THREADS / 32 - 1) / (THREADS / 32);
    const int64_t cap = (int64_t)nsm * BLOCKS_PER_SM;
    const int blocks = (int)(need < 1 ? 1 : need < cap ? need : cap);
    mark_bytes_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)buf, (int8_t*)out, n, head, nw, t);
    return (int)cudaGetLastError();
}
