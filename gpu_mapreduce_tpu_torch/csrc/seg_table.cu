// Open-addressed group table (count / exact sum per distinct key) for
// Hopper (sm_90a).
//
// Replaces the TPU kernel gpu_mapreduce_tpu/ops/pallas/group.py
// :: _seg_table_kernel (launched by segment_table <- segment_group_reduce
// <- parallel/group.fused_group_body).
//
// What it computes: for rows i < n of 64-bit keys (integer keys widened to
// 64 bits: unsigned zero-extended, signed sign-extended), one group per
// distinct key with an int32 row count and, when `vals` is given, the
// mod-2^64 sum of the rows' 64-bit widened values.  Layout, T+2 slots of
// 16 bytes {u64 key; u32 count; u32 spare}:
//   * slots [0, T): linear probing from the slot hash
//       ((kl ^ kh * 0x9E3779B1) * 0x85EBCA6B) & (T-1)   (u32 arithmetic)
//     of the key's hi/lo 32-bit limbs; an empty slot holds the sentinel
//     key EMPTY = 2^64-1;
//   * slot T, the side slot: the group of key 2^64-1 itself, which never
//     probes, so every key value stays an ordinary key;
//   * slot T+1, the meta slot: its count is the number of rows whose key
//     found no slot (probed all T; read only as > 0, as the fuser does),
//     its spare the number of entries in `claimed`.
// Sums live beside the slots in u64 sums[T+2].  `claimed` lists the index
// of every slot that holds a group (the side slot included), in no order,
// and `claimed_keys` their keys, so the epilogue
// (ops/segment.table_to_groups) touches g entries, never all T slots.
// Slot positions and the list order depend on how rows race, so they
// differ from the TPU kernel's; the epilogue sorts the groups by key, so
// its output does not.
//
// The TPU kernel walks the rows in order inside one program (a fori_loop),
// so nothing races.  Here rows are threads, and what bounds the kernel on
// an H100 SXM is memory: each row reads its 8-byte key (and value) once;
// at the uniform IntCount shape (T = 2^26, a 1 GB table, far beyond the
// 50 MB L2) each row also touches one random 32-byte sector.  About 2.1 GB
// for 33.5 M rows, ~0.64 ms at 3.35 TB/s.  At the zipf shape the table
// fits the L2 and the limit is contention: a quarter of the rows carry one
// key.  What the design does about it:
//   1. one 16-byte slot and one claim instruction: a row reads the slot's
//      key; on EMPTY it claims with one 64-bit atomicCAS(key, EMPTY, k)
//      (EMPTY back: claimed; k back: found; else step on), then adds to
//      the count in the same sector (an L2 hit).  A key, once written,
//      never changes, so no occupancy word, fence or spin is needed, and
//      one key never takes two slots: rows of one key walk one probe
//      sequence, and its first EMPTY slot is claimed by exactly one CAS;
//   2. warp pre-aggregation: __match_any_sync on the key; one leader per
//      distinct key in the warp inserts once with the peers' count (and
//      their values summed by shuffles, exact mod 2^64);
//   3. a front table for hot keys: each block of a persistent grid keeps
//      FRONT_SLOTS keys in shared memory; a leader probes it FRONT_PROBES
//      steps and adds there with shared-memory atomics, or goes to the
//      global table.  At block end each front group is inserted globally
//      once.  Under zipf(1.3) most rows stop in the front table, and key
//      1's global counter takes one add per block instead of millions;
//   4. compaction in the kernel: whoever claims a slot appends its index
//      and key to the lists.  A warp buffers its claims for CLAIM_ROUNDS
//      rounds in registers and appends them with one atomicAdd on the list's
//      counter: at the uniform shape almost every row claims, and one
//      returning atomic a warp a round, all on that one address, would
//      hold every warp up.
// The grid is persistent: as many blocks of THREADS as fit on each SM.
// With the front table's 48 KB of shared memory that is 1,024 threads an
// SM; more threads in flight do not make the uniform shape's random
// slot accesses faster.

#include <cuda_runtime.h>
#include <stdint.h>

typedef unsigned long long u64;

#define EMPTY_KEY 0xFFFFFFFFFFFFFFFFull
#define FULL_MASK 0xFFFFFFFFu
#define THREADS 256
#define FRONT_SLOTS 4096        // shared-memory slots a block
#define FRONT_PROBES 4
#define CLAIM_ROUNDS 8          // rounds a warp buffers its claims

struct __align__(16) Slot {
    u64 key;
    unsigned int count;
    unsigned int spare;
};

__device__ __forceinline__ uint32_t slot_hash(u64 k) {
    const uint32_t kh = (uint32_t)(k >> 32);
    const uint32_t kl = (uint32_t)k;
    return (kl ^ (kh * 0x9E3779B1u)) * 0x85EBCA6Bu;
}

// Add c rows (and their sum s) of key k to the global table.  Returns
// true when this call claimed a new group, whose slot index is then *at.
template <bool SUM>
__device__ __forceinline__ bool insert_global(Slot* slots, u64* sums,
                                              uint32_t mask, u64 k,
                                              unsigned int c, u64 s,
                                              uint32_t* at) {
    const uint32_t side = mask + 1;
    if (k == EMPTY_KEY) {
        const unsigned int old = atomicAdd(&slots[side].count, c);
        if (SUM) atomicAdd(sums + side, s);
        *at = side;
        return old == 0;
    }
    uint32_t h = slot_hash(k) & mask;
    for (uint32_t step = 0; step <= mask; ++step) {
        u64 cur = *(volatile u64*)&slots[h].key;
        bool claimed = false;
        if (cur == EMPTY_KEY) {
            cur = atomicCAS(&slots[h].key, EMPTY_KEY, k);
            claimed = cur == EMPTY_KEY;
        }
        if (claimed || cur == k) {
            atomicAdd(&slots[h].count, c);
            if (SUM) atomicAdd(sums + h, s);
            *at = h;
            return claimed;
        }
        h = (h + 1) & mask;
    }
    atomicAdd(&slots[side + 1].count, c);        // no slot: overflow
    return false;
}

// Add c rows (and s) of key k (not EMPTY) to the block's front table;
// false when FRONT_PROBES slots from its home hold other keys.
template <bool SUM>
__device__ __forceinline__ bool insert_front(u64* fkey, unsigned int* fcnt,
                                             u64* fsum, u64 k,
                                             unsigned int c, u64 s) {
    uint32_t h = slot_hash(k) & (FRONT_SLOTS - 1);
#pragma unroll
    for (int p = 0; p < FRONT_PROBES; ++p) {
        u64 cur = *(volatile u64*)&fkey[h];
        if (cur == EMPTY_KEY) {
            cur = atomicCAS(&fkey[h], EMPTY_KEY, k);
            if (cur == EMPTY_KEY) cur = k;       // claimed
        }
        if (cur == k) {
            atomicAdd(&fcnt[h], c);
            if (SUM) atomicAdd(&fsum[h], s);
            return true;
        }
        h = (h + 1) & (FRONT_SLOTS - 1);
    }
    return false;
}

// Sum of v over the lanes in `peers` (mod 2^64).  Every lane calls it.
__device__ __forceinline__ u64 peer_sum(unsigned int peers, u64 v) {
    const int lane = threadIdx.x & 31;
    const unsigned int rounds = __reduce_max_sync(FULL_MASK, __popc(peers));
    unsigned int rest = peers;
    u64 s = 0;
    for (unsigned int r = 0; r < rounds; ++r) {
        const int src = rest ? __ffs(rest) - 1 : lane;
        const u64 x = __shfl_sync(FULL_MASK, v, src);
        if (rest) {
            s += x;
            rest &= rest - 1;
        }
    }
    return s;
}

// Where claims go: the list of claimed slots and, beside it, their keys,
// with the list's counter.
struct ClaimList {
    unsigned int* count;
    int* slot;
    u64* key;
};

// A warp's claims (slot and key), buffered in registers for CLAIM_ROUNDS
// rounds (a lane claims at most one slot a round), then appended to the
// list with one atomicAdd on its counter.  Every lane calls add() and
// flush().
struct ClaimBuffer {
    uint32_t slot[CLAIM_ROUNDS];
    u64 key[CLAIM_ROUNDS];
    int n = 0;
    int rounds = 0;

    __device__ __forceinline__ void add(bool claimed_now, uint32_t at, u64 k,
                                        const ClaimList& out) {
#pragma unroll
        for (int j = 0; j < CLAIM_ROUNDS; ++j)
            if (j == n && claimed_now) {
                slot[j] = at;
                key[j] = k;
            }
        n += claimed_now;
        if (++rounds == CLAIM_ROUNDS) flush(out);
    }

    __device__ __forceinline__ void flush(const ClaimList& out) {
        const int lane = threadIdx.x & 31;
        int upto = n;                    // claims of lanes 0..lane
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int y = __shfl_up_sync(FULL_MASK, upto, d);
            if (lane >= d) upto += y;
        }
        const int total = __shfl_sync(FULL_MASK, upto, 31);
        if (total > 0) {                 // uniform across the warp
            unsigned int base = 0;
            if (lane == 0) base = atomicAdd(out.count, (unsigned int)total);
            base = __shfl_sync(FULL_MASK, base, 0) + (upto - n);
#pragma unroll
            for (int j = 0; j < CLAIM_ROUNDS; ++j)
                if (j < n) {
                    out.slot[base + j] = (int)slot[j];
                    out.key[base + j] = key[j];
                }
        }
        n = 0;
        rounds = 0;
    }
};

// What one launch works on (see seg_table_launch).
struct TableArgs {
    const u64* keys;
    const u64* vals;
    int64_t n;
    uint32_t mask;              // T - 1
    Slot* slots;
    u64* sums;
    int* claimed;
    u64* claimed_keys;
};

template <bool SUM>
__global__ void __launch_bounds__(THREADS)
seg_table_kernel(const TableArgs a) {
    const u64* __restrict__ keys = a.keys;
    const u64* __restrict__ vals = a.vals;
    const int64_t n = a.n;
    const uint32_t mask = a.mask;
    Slot* slots = a.slots;
    u64* sums = a.sums;
    extern __shared__ __align__(16) unsigned char smem[];
    u64* fkey = (u64*)smem;
    unsigned int* fcnt = (unsigned int*)(fkey + FRONT_SLOTS);
    u64* fsum = (u64*)(fcnt + FRONT_SLOTS);
    const ClaimList out = {&slots[mask + 2].spare, a.claimed, a.claimed_keys};
    for (int s = threadIdx.x; s < FRONT_SLOTS; s += THREADS) {
        fkey[s] = EMPTY_KEY;
        fcnt[s] = 0;
        if (SUM) fsum[s] = 0;
    }
    __syncthreads();
    const int lane = threadIdx.x & 31;
    const int64_t nwarps = (int64_t)gridDim.x * (THREADS / 32);
    const int64_t warp = (int64_t)blockIdx.x * (THREADS / 32)
                         + (threadIdx.x >> 5);
    ClaimBuffer buf;
    // the trip count is uniform across the warp: every lane runs every
    // round, rows past n sit out, so full-mask warp primitives are valid
    for (int64_t base = warp * 32; base < n; base += nwarps * 32) {
        const int64_t i = base + lane;
        const bool valid = i < n;
        const u64 k = valid ? keys[i] : 0;
        u64 v = (SUM && valid) ? vals[i] : 0;
        const unsigned int live = __ballot_sync(FULL_MASK, valid);
        const unsigned int peers = __match_any_sync(FULL_MASK, k) & live;
        const bool lead = valid && __ffs(peers) - 1 == lane;
        const unsigned int c = __popc(peers);
        if (SUM) v = peer_sum(peers, v);
        bool claimed_now = false;
        uint32_t at = 0;
        if (lead && !(k != EMPTY_KEY &&
                      insert_front<SUM>(fkey, fcnt, fsum, k, c, v)))
            claimed_now = insert_global<SUM>(slots, sums, mask, k, c, v, &at);
        buf.add(claimed_now, at, k, out);
    }
    __syncthreads();
    for (int s0 = 0; s0 < FRONT_SLOTS; s0 += THREADS) {
        const int s = s0 + threadIdx.x;
        const u64 k = fkey[s];
        bool claimed_now = false;
        uint32_t at = 0;
        if (k != EMPTY_KEY)
            claimed_now = insert_global<SUM>(slots, sums, mask, k, fcnt[s],
                                             SUM ? fsum[s] : 0, &at);
        buf.add(claimed_now, at, k, out);
    }
    buf.flush(out);
}

// Every slot EMPTY with count 0 (one 16-byte store a slot), every sum 0.
__global__ void seg_table_init(uint4* slots, u64* sums, int64_t nslots) {
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
         i < nslots; i += stride) {
        slots[i] = make_uint4(FULL_MASK, FULL_MASK, 0u, 0u);
        if (sums != nullptr) sums[i] = 0;
    }
}

template <bool SUM>
static cudaError_t launch(const TableArgs& a, int nsm, cudaStream_t stream) {
    auto kernel = seg_table_kernel<SUM>;
    const int smem = FRONT_SLOTS * (8 + 4 + (SUM ? 8 : 0));
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        THREADS, smem);
    if (err != cudaSuccess) return err;
    const int64_t need = (a.n + THREADS - 1) / THREADS;
    const int64_t cap = (int64_t)nsm * (per_sm > 0 ? per_sm : 1);
    const int blocks = (int)(need < cap ? need : cap);
    kernel<<<blocks, THREADS, smem, stream>>>(a);
    return cudaGetLastError();
}

// keys, vals: n 64-bit widened values (vals null: count only).  slots:
// T+2 16-byte slots; sums: T+2 u64 (null when vals is); claimed,
// claimed_keys: room for min(n, T) + 1 slot indices and keys.  The kernel
// initialises the table itself.  Launches on `stream` of device `dev` and returns
// cudaGetLastError() (0 on success); does not synchronise.
extern "C" int seg_table_launch(const void* keys, const void* vals, int64_t n,
                                int64_t T, void* slots, void* sums,
                                void* claimed, void* claimed_keys, int dev,
                                void* stream) {
    if (n < 0 || T < 1 || T > (1ll << 31) || (T & (T - 1)) != 0 ||
        (n > 0 && (vals == nullptr) != (sums == nullptr)) ||
        ((uintptr_t)slots & 15) != 0)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(dev);
    if (err != cudaSuccess) return (int)err;
    int nsm = 0;
    cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
    if (nsm <= 0) nsm = 132;
    cudaStream_t st = (cudaStream_t)stream;
    const int64_t nslots = T + 2;
    const int64_t init_need = (nslots + 255) / 256;
    const int64_t init_cap = (int64_t)nsm * 16;
    seg_table_init<<<(int)(init_need < init_cap ? init_need : init_cap), 256,
                     0, st>>>((uint4*)slots, (u64*)sums, nslots);
    err = cudaGetLastError();
    if (err != cudaSuccess || n == 0) return (int)err;
    const TableArgs a = {(const u64*)keys, (const u64*)vals, n,
                         (uint32_t)(T - 1), (Slot*)slots, (u64*)sums,
                         (int*)claimed, (u64*)claimed_keys};
    err = sums != nullptr ? launch<true>(a, nsm, st)
                          : launch<false>(a, nsm, st);
    return (int)err;
}
