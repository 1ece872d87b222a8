// Byte-per-lane pattern mark for Hopper (sm_90a).
//
// Replaces the TPU kernel gpu_mapreduce_tpu/ops/pallas/match.py
// :: _mark_kernel (launched by mark_pallas; XLA twin mark_xla).
//
// What it computes: over a byte buffer of n bytes, one int8 per byte:
// 1 where the pattern starts at byte i, else 0.  Bytes past n read as 0,
// as mark_xla's zero concat and the TPU kernel's zero padding make them,
// so a pattern that ends in '\0' matches at the tail.  Any pattern
// period is fine (the word-packed kernel, csrc/mark_words.cu, refuses
// periods below 4; this is the tier those patterns take).
//
// The TPU kernel widens every byte to an int32 lane of a [256, 128] block
// and builds each shifted view from two 128-lane rolls, with the next
// block's first row as a halo.  None of that carries over.  Here one
// thread computes one output byte in a grid-stride loop over an int64
// index and compares len(pattern) bytes; neighbouring threads read
// neighbouring bytes, so the loads coalesce and the L1 serves the
// overlap.  The pattern travels by value in a parameter struct.
//
// Bound on an H100 SXM: memory.  It reads n bytes and writes n bytes, 2n
// in all (~0.16 ms for the 256 MB corpus at 3.35 TB/s).  This first
// version issues len(pattern) one-byte loads per output byte; loading 16
// bytes a thread with a len(pattern)-1 byte halo would cut the load
// instructions by about that factor, and is left to later work.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_PAT 64

struct Pattern {
    uint8_t bytes[MAX_PAT];
    int len;
};

__global__ void mark_bytes_kernel(const uint8_t* __restrict__ buf,
                                  int8_t* __restrict__ out, int64_t n,
                                  const Pattern p) {
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += stride) {
        bool hit = true;
        for (int j = 0; j < p.len && hit; ++j) {
            const uint8_t b = (i + j < n) ? __ldg(buf + i + j) : (uint8_t)0;
            hit = (b == p.bytes[j]);
        }
        out[i] = hit ? (int8_t)1 : (int8_t)0;
    }
}

// Launches on `stream` of device `dev` and returns cudaGetLastError()
// (0 on success); does not synchronise.
extern "C" int mark_bytes_launch(const void* buf, void* out, int64_t n,
                                 const uint8_t* pattern, int len, int dev,
                                 void* stream) {
    if (len < 1 || len > MAX_PAT || n < 0) return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaSuccess;
    cudaError_t err = cudaSetDevice(dev);
    if (err != cudaSuccess) return (int)err;
    Pattern p = {};
    for (int j = 0; j < len; ++j) p.bytes[j] = pattern[j];
    p.len = len;
    int nsm = 0;
    cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
    const int threads = 256;
    const int64_t need = (n + threads - 1) / threads;
    const int64_t cap = (int64_t)(nsm > 0 ? nsm : 132) * 16;  // 16 blocks/SM
    const int blocks = (int)(need < cap ? need : cap);
    mark_bytes_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)buf, (int8_t*)out, n, p);
    return (int)cudaGetLastError();
}
