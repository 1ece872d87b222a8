// Word-packed pattern mark for Hopper (sm_90a).
//
// Replaces the TPU kernel gpu_mapreduce_tpu/ops/pallas/match.py
// :: _mark_words_kernel (launched by mark_words_pallas).
//
// What it computes: over a buffer of m little-endian u32 words, one int8
// per word.  0 means no match; a+1 means the pattern starts at byte
// 4*i+a.  Alignment a matches when the masked compares
//   (w[i+j] & mask[a][j]) == val[a][j]   for every j < nw with mask != 0
// all hold; nw = (len(pattern)+6)/4 words (3 for `<a href="`).  Words past
// m read as 0.  Alignments are tested from 3 down to 0 and the last hit
// is kept, so the lowest alignment wins (the caller checks that the
// pattern's minimal period is >= 4, so at most one alignment can match).
//
// The TPU kernel's shape came from the TPU: [512,128] blocks, 128-lane
// rolls for the next-word views, a next-block halo through a second
// BlockSpec, and paging at 4 Mi words to dodge a Mosaic limit.  None of
// that carries over.  Here one thread computes one output word in a
// grid-stride loop over an int64 index, so one launch covers any m.
//
// Bound on an H100 SXM: the kernel reads 4m bytes and writes m bytes and
// does about 30 integer operations per word, so it is memory-bound: at the
// main path's m ~ 67 M words (256 MB corpus) that is ~335 MB, ~0.10 ms at
// 3.35 TB/s.  This first version is simple and right, and leaves speed on
// the table for later work:
//   * each thread loads nw 4-byte words, nw-1 of them also loaded by its
//     neighbours (the L1 absorbs most of that); 16-byte vector loads with
//     the halo kept in registers would cut the load instructions 4x;
//   * the compaction that follows (torch.nonzero over the int8 mask) reads
//     the mask again; fusing it here (a block-local count, then a
//     decoupled-lookback scan, starts kept ascending) would save that pass.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_NW 8   // patterns up to 4*MAX_NW-6 = 26 bytes

struct MarkTables {
    uint32_t mask[4][MAX_NW];   // 0xFF at the pattern's byte positions
    uint32_t val[4][MAX_NW];    // the pattern's bytes, already & mask
    int nw;
};

__global__ void mark_words_kernel(const uint32_t* __restrict__ words,
                                  int8_t* __restrict__ out, int64_t m,
                                  const MarkTables t) {
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < m;
         i += stride) {
        uint32_t win[MAX_NW];
#pragma unroll
        for (int j = 0; j < MAX_NW; ++j)
            win[j] = (j < t.nw && i + j < m) ? __ldg(words + i + j) : 0u;
        int8_t code = 0;
#pragma unroll
        for (int a = 3; a >= 0; --a) {
            bool hit = true;
#pragma unroll
            for (int j = 0; j < MAX_NW; ++j) {
                const uint32_t mk = t.mask[a][j];
                if (mk != 0u) hit = hit && ((win[j] & mk) == t.val[a][j]);
            }
            if (hit) code = (int8_t)(a + 1);
        }
        out[i] = code;
    }
}

// masks, vals: host arrays [4][nw] row-major.  Launches on `stream` of
// device `dev` and returns cudaGetLastError() (0 on success); does not
// synchronise.
extern "C" int mark_words_launch(const void* words, void* out, int64_t m,
                                 const uint32_t* masks, const uint32_t* vals,
                                 int nw, int dev, void* stream) {
    if (nw < 1 || nw > MAX_NW || m < 0) return (int)cudaErrorInvalidValue;
    if (m == 0) return (int)cudaSuccess;
    cudaError_t err = cudaSetDevice(dev);
    if (err != cudaSuccess) return (int)err;
    MarkTables t = {};
    for (int a = 0; a < 4; ++a)
        for (int j = 0; j < nw; ++j) {
            t.mask[a][j] = masks[a * nw + j];
            t.val[a][j] = vals[a * nw + j] & masks[a * nw + j];
        }
    t.nw = nw;
    int nsm = 0;
    cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
    const int threads = 256;
    const int64_t need = (m + threads - 1) / threads;
    const int64_t cap = (int64_t)(nsm > 0 ? nsm : 132) * 16;  // 16 blocks/SM
    const int blocks = (int)(need < cap ? need : cap);
    mark_words_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)words, (int8_t*)out, m, t);
    return (int)cudaGetLastError();
}
