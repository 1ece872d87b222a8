// Word-packed pattern mark for Hopper (sm_90a).
//
// Replaces the TPU kernel gpu_mapreduce_tpu/ops/pallas/match.py
// :: _mark_words_kernel (launched by mark_words_pallas).
//
// What it computes: over a buffer of m little-endian u32 words, one int8
// per word.  0 means no match; a+1 means the pattern starts at byte
// 4*i+a.  Alignment a matches when the masked compares
//   (w[i+j] & mask[a][j]) == val[a][j]   for every j < nw
// all hold (mask 0 past the pattern's bytes); nw = (len(pattern)+6)/4
// words (3 for `<a href="`).  Words past m read as 0.  Alignments are
// tested from 3 down to 0 and the last hit is kept, so the lowest
// alignment wins (the caller checks that the pattern's minimal period is
// >= 4, so at most one alignment can match).
//
// The TPU kernel's shape came from the TPU: [512,128] blocks, 128-lane
// rolls for the next-word views, a next-block halo through a second
// BlockSpec, and paging at 4 Mi words to dodge a Mosaic limit.  None of
// that carries over.
//
// Bound on an H100 SXM: the kernel reads 4m bytes and writes m bytes and
// does about 30 integer operations per word, so it is memory-bound: at the
// main path's m ~ 68 M words (256 MB corpus) that is ~341 MB, ~0.10 ms at
// 3.35 TB/s.  With one thread a word, nw 4-byte loads and a 1-byte store
// a word would bind it on load/store instructions, not bytes.  So a
// thread owns a tile of 16 consecutive words: four 16-byte loads,
// the nw-1 halo words taken from the next lane's first words by
// __shfl_down_sync (lane 31, and the last tile, load their halo
// themselves), the 16 codes computed in registers with the alignment
// tables from the kernel parameters (nw is a template parameter, so the
// compares unroll), and one 16-byte store.  A grid-stride loop over tiles
// covers any m.  Tiles start at the first 16-byte boundary of `words`; the
// up to 3 words before it (a view such as words[1:]) and the ragged tail
// (fewer than 16 words) are done one word a thread by block 0 in the same
// launch.  The caller places `out` so that out + head is 16-byte aligned.
// Left for later work: the compaction that follows (torch.nonzero over
// the int8 mask) reads the mask again; fusing it here would save that.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_NW 8   // patterns up to 4*MAX_NW-6 = 26 bytes
#define TILE 16    // words a thread owns
#define THREADS 256
#define FULL_MASK 0xFFFFFFFFu

struct MarkTables {
    uint32_t mask[4][MAX_NW];   // 0xFF at the pattern's byte positions
    uint32_t val[4][MAX_NW];    // the pattern's bytes, already & mask
};

// The code of the word whose window is x[0..NW).
template <int NW>
__device__ __forceinline__ uint32_t match_code(const uint32_t (&x)[NW],
                                               const MarkTables& t) {
    uint32_t code = 0;
#pragma unroll
    for (int a = 3; a >= 0; --a) {
        uint32_t miss = 0;
#pragma unroll
        for (int j = 0; j < NW; ++j)
            miss |= (x[j] ^ t.val[a][j]) & t.mask[a][j];
        if (miss == 0) code = (uint32_t)(a + 1);
    }
    return code;
}

template <int NW>
__global__ void __launch_bounds__(THREADS)
mark_words_kernel(const uint32_t* __restrict__ words, int8_t* __restrict__ out,
                  int64_t m, int64_t head, const MarkTables t) {
    constexpr int HALO = NW - 1;
    const int64_t ntiles = (m - head) / TILE;
    const int64_t tail = head + ntiles * TILE;
    if (blockIdx.x == 0) {                      // scalar head and tail
        const int64_t r = threadIdx.x;
        const int64_t g = r < head ? r : tail + (r - head);
        if (g < m && (r < head || g >= tail)) {
            uint32_t x[NW];
#pragma unroll
            for (int j = 0; j < NW; ++j)
                x[j] = g + j < m ? __ldg(words + g + j) : 0u;
            out[g] = (int8_t)match_code<NW>(x, t);
        }
    }
    const uint4* w4 = reinterpret_cast<const uint4*>(words + head);
    uint4* o4 = reinterpret_cast<uint4*>(out + head);
    const int lane = threadIdx.x & 31;
    const int64_t nwarps = (int64_t)gridDim.x * (THREADS / 32);
    const int64_t warp = (int64_t)blockIdx.x * (THREADS / 32)
                         + (threadIdx.x >> 5);
    // uniform trip count across the warp, so the full-mask shuffle is valid
    for (int64_t base = warp * 32; base < ntiles; base += nwarps * 32) {
        const int64_t tile = base + lane;
        const bool live = tile < ntiles;
        uint32_t w[TILE + HALO];
#pragma unroll
        for (int q = 0; q < TILE / 4; ++q) {
            const uint4 v = live ? __ldg(w4 + TILE / 4 * tile + q)
                                 : make_uint4(0u, 0u, 0u, 0u);
            w[4 * q] = v.x;
            w[4 * q + 1] = v.y;
            w[4 * q + 2] = v.z;
            w[4 * q + 3] = v.w;
        }
#pragma unroll
        for (int j = 0; j < HALO; ++j)
            w[TILE + j] = __shfl_down_sync(FULL_MASK, w[j], 1);
        if (live && (lane == 31 || tile + 1 == ntiles)) {
            const int64_t g = head + (tile + 1) * TILE;
#pragma unroll
            for (int j = 0; j < HALO; ++j)
                w[TILE + j] = g + j < m ? __ldg(words + g + j) : 0u;
        }
        if (live) {
            uint32_t packed[4] = {0u, 0u, 0u, 0u};
#pragma unroll
            for (int i = 0; i < TILE; ++i) {
                uint32_t x[NW];
#pragma unroll
                for (int j = 0; j < NW; ++j) x[j] = w[i + j];
                packed[i / 4] |= match_code<NW>(x, t) << (8 * (i % 4));
            }
            o4[tile] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
        }
    }
}

template <int NW>
static cudaError_t launch(const uint32_t* words, int8_t* out, int64_t m,
                          int64_t head, const MarkTables& t, int nsm,
                          cudaStream_t stream) {
    const int64_t ntiles = (m - head) / TILE;
    const int64_t need = (ntiles + THREADS - 1) / THREADS;
    const int64_t cap = (int64_t)nsm * 8;
    const int blocks = (int)(need < 1 ? 1 : need < cap ? need : cap);
    mark_words_kernel<NW><<<blocks, THREADS, 0, stream>>>(words, out, m,
                                                          head, t);
    return cudaGetLastError();
}

// masks, vals: host arrays [4][nw] row-major.  `out` must be 16-byte
// aligned at the first 16-byte boundary of `words` (out + head, head =
// the words before it).  Launches on `stream` of device `dev` and returns
// cudaGetLastError() (0 on success); does not synchronise.
extern "C" int mark_words_launch(const void* words, void* out, int64_t m,
                                 const uint32_t* masks, const uint32_t* vals,
                                 int nw, int dev, void* stream) {
    if (nw < 2 || nw > MAX_NW || m < 0 || ((uintptr_t)words & 3) != 0)
        return (int)cudaErrorInvalidValue;
    if (m == 0) return (int)cudaSuccess;
    int64_t head = (int64_t)((16 - ((uintptr_t)words & 15)) & 15) / 4;
    if (head > m) head = m;
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
    const uint32_t* w = (const uint32_t*)words;
    int8_t* o = (int8_t*)out;
    cudaStream_t st = (cudaStream_t)stream;
    switch (nw) {
        case 2: return (int)launch<2>(w, o, m, head, t, nsm, st);
        case 3: return (int)launch<3>(w, o, m, head, t, nsm, st);
        case 4: return (int)launch<4>(w, o, m, head, t, nsm, st);
        case 5: return (int)launch<5>(w, o, m, head, t, nsm, st);
        case 6: return (int)launch<6>(w, o, m, head, t, nsm, st);
        case 7: return (int)launch<7>(w, o, m, head, t, nsm, st);
        default: return (int)launch<8>(w, o, m, head, t, nsm, st);
    }
}
