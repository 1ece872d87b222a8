// Open-addressed group table (count / exact sum per distinct key) for
// Hopper (sm_90a).
//
// Replaces the TPU kernel gpu_mapreduce_tpu/ops/pallas/group.py
// :: _seg_table_kernel (launched by segment_table <- segment_group_reduce
// <- parallel/group.fused_group_body).
//
// What it computes: for rows i < n of 64-bit keys (integer keys widened to
// 64 bits: unsigned zero-extended, signed sign-extended), a table of T
// slots (T a power of two) with linear probing from the slot hash
//   ((kl ^ kh * 0x9E3779B1) * 0x85EBCA6B) & (T-1)     (u32 arithmetic)
// of the key's hi/lo 32-bit limbs.  Per distinct key: occ = 1, the key, an
// int32 row count and, when `vals` is given, the mod-2^64 sum of the rows'
// 64-bit widened values.  A row that probes all T slots without finding its
// key or an empty slot adds 1 to cnt[T] (the overflow count the caller
// validates; more distinct keys than slots is the only way to get there).
// Slot positions depend on the order in which rows race, so they differ
// from the TPU kernel's; the epilogue (ops/segment.table_to_groups) orders
// the occupied slots by key, so its output does not.
//
// The TPU kernel walks the rows in order inside one program (a fori_loop),
// so nothing ever races.  Here every row is a thread, and claiming a slot is
// the hard part.  A slot's occ goes 0 -> 2 (claimed, key not yet
// published) by atomicCAS, the claimer stores the key, fences, and sets
// occ = 1.  A prober that reads occ == 2 spins until it reads 1, fences,
// and then compares the key.  So every key value (0 and 2^64-1 included)
// is an ordinary key, and a key never lands in two slots: two rows with
// one key walk the same slot sequence, and the first empty slot on it is
// claimed by exactly one of them.  Counts use atomicAdd on int32; sums
// atomicAdd on unsigned long long, which wraps mod 2^64 exactly as the TPU
// kernel's limb carry does, so integer results are exact in any order.
//
// Bound on an H100 SXM: memory.  Each row reads its 8-byte key (and 8-byte
// value) once, and touches one random 32-byte sector of a table that at
// the uniform IntCount shape (T = 2^26, ~1 GB of slots) is far larger than
// the 50 MB L2; the table's state is written once.  About 2.1 GB for 33.5 M
// rows, ~0.64 ms at 3.35 TB/s.  This first version is simple and right and
// leaves two things to later work: a hot key (under the zipf shape a
// quarter of all rows carry key 1) sends all its atomics to one address,
// which warp-level pre-aggregation of equal keys (__match_any_sync) would
// cut 32x; and a table that fits could live in shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

typedef unsigned long long u64;

__device__ __forceinline__ uint32_t slot_hash(u64 k) {
    const uint32_t kh = (uint32_t)(k >> 32);
    const uint32_t kl = (uint32_t)k;
    return (kl ^ (kh * 0x9E3779B1u)) * 0x85EBCA6Bu;
}

__global__ void seg_table_kernel(const u64* __restrict__ keys,
                                 const u64* __restrict__ vals, int64_t n,
                                 uint32_t mask, u64* tkey, int* occ,
                                 int* cnt, u64* tsum) {
    volatile int* vocc = occ;
    volatile u64* vkey = tkey;
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += stride) {
        const u64 k = keys[i];
        uint32_t s = slot_hash(k) & mask;
        int64_t slot = -1;
        for (uint32_t step = 0; step <= mask; ++step) {
            int o = vocc[s];
            if (o == 0) {
                o = atomicCAS(occ + s, 0, 2);
                if (o == 0) {                 // claimed: publish the key
                    vkey[s] = k;
                    __threadfence();
                    atomicExch(occ + s, 1);
                    slot = s;
                    break;
                }
            }
            while (o == 2) o = vocc[s];       // another row is publishing
            __threadfence();
            if (vkey[s] == k) {
                slot = s;
                break;
            }
            s = (s + 1) & mask;
        }
        if (slot < 0) {
            atomicAdd(cnt + (int64_t)mask + 1, 1);   // overflow slot T
            continue;
        }
        atomicAdd(cnt + slot, 1);
        if (vals != nullptr) atomicAdd(tsum + slot, vals[i]);
    }
}

// keys, vals: n 64-bit widened values (vals may be null: count only).
// tkey, occ, cnt, tsum: T+1 slots each, occ/cnt/tsum zeroed by the caller
// (tsum null when vals is).  Launches on `stream` of device `dev` and
// returns cudaGetLastError() (0 on success); does not synchronise.
extern "C" int seg_table_launch(const void* keys, const void* vals, int64_t n,
                                int64_t T, void* tkey, void* occ, void* cnt,
                                void* tsum, int dev, void* stream) {
    if (n < 0 || T < 1 || T > (1ll << 31) || (T & (T - 1)) != 0 ||
        (vals == nullptr) != (tsum == nullptr))
        return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaSuccess;
    cudaError_t err = cudaSetDevice(dev);
    if (err != cudaSuccess) return (int)err;
    int nsm = 0;
    cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
    const int threads = 256;
    const int64_t need = (n + threads - 1) / threads;
    const int64_t cap = (int64_t)(nsm > 0 ? nsm : 132) * 16;  // 16 blocks/SM
    const int blocks = (int)(need < cap ? need : cap);
    seg_table_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const u64*)keys, (const u64*)vals, n, (uint32_t)(T - 1), (u64*)tkey,
        (int*)occ, (int*)cnt, (u64*)tsum);
    return (int)cudaGetLastError();
}
