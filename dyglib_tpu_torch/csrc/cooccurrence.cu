// Per-row co-occurrence counts:
//   out[r, i] = #{ j : q[r, i] == k[r, j] }   (as float)
// for q (R, Lq) and k (R, Lk) int32 ids, Lq and Lk independent; any int32
// is an id (0 is not special here).
//
// Replaces dyglib_tpu/ops/pallas/cooccurrence.py::_kernel, which compares
// every query with every key, Lq x Lk compares a row: the TPU's vector
// unit does that in wide lanes, but at Lq = Lk = 2048 it is 4.2 M compares
// a row, 5.9 G for the 1400 rows of one DyGFormer batch. Here a row's keys
// are counted instead, O(Lk + Lq) work a row. Two paths; the wrapper picks
// one by Lk (ops/cooccurrence.py ALL_PAIRS_MAX_LK, set from the measured
// crossover of the two, PERF.md):
//
//   * table (long rows): one block a row. The keys go into an
//     open-addressed hash table in shared memory, kTableKeys keys at a
//     time: each slot is one 64-bit word, (count << 32) | key, and 0 marks
//     an empty slot (an occupied slot's count is at least 1), so no id
//     needs to be kept free as a sentinel. A key is inserted by atomicCAS
//     on the word and counted by a 64-bit atomicAdd of n << 32. Equal keys
//     of a warp are merged first (__match_any_sync): one atomic per
//     distinct key a warp, so a row of one repeated id (CanParl's pads fill
//     half of every row) costs 32 atomics a chunk, not 2048 on one word.
//     Slots are probed linearly from a multiplicative hash; the table has
//     twice the slots of the keys it holds, so it is at most half full and
//     every probe ends. The slots (a power of two, 64 to 4096) are sized
//     by the wrapper to the row's keys. Then every query looks its id up
//     and adds the count it finds; keys past one table are counted chunk
//     by chunk, each chunk's counts added to the query's running count in
//     out (integers below 2^24: exact in f32, in any order).
//   * all pairs (short rows, wikipedia's L = 32): one warp a row; each lane
//     holds one key of a 32-key chunk in a register and the warp
//     broadcasts them (__shfl_sync) to the lanes' queries. At L = 32 the
//     table took 0.0032-0.0035 ms a launch on an H100 and this path
//     0.0019-0.0021 (PERF.md §6).
//
// Bound on an H100 at CanParl (one launch of 600 rows with q = k, one of
// 800 rows; L = 2048): 34.4 MB of ids and counts, 10.3 us at 3.35 TB/s.
#include "common.cuh"

namespace {

constexpr int kTableKeys = 2048;  // keys a table holds (ops/cooccurrence.py TABLE_KEYS)
constexpr int kTableThreads = 256;
constexpr int kPairWarps = 8;     // rows a block on the all-pairs path
constexpr unsigned kFullMask = 0xffffffffu;

// The top log2(slots) bits of key * 2^32 / phi (Fibonacci hashing).
__device__ __forceinline__ unsigned slot_of(int key, unsigned slot_mask) {
  return static_cast<unsigned>(key) * 0x9E3779B1u >> __clz(slot_mask);
}

// Counts ids[0 .. n) into the table (slot_mask + 1 slots, all 0); every
// thread of the block calls it (n is the same in each).
__device__ __forceinline__ void insert_keys(unsigned long long* table, unsigned slot_mask,
                                            const int* __restrict__ ids, int n) {
  const int lane = threadIdx.x % 32;
  for (int j0 = 0; j0 < n; j0 += blockDim.x) {
    const int j = j0 + threadIdx.x;
    const bool has = j < n;
    const int key = has ? ids[j] : 0;
    const unsigned active = __ballot_sync(kFullMask, has);
    const unsigned same = __match_any_sync(kFullMask, key) & active;
    if (!has || lane != __ffs(same) - 1) continue;
    const unsigned long long add = static_cast<unsigned long long>(__popc(same)) << 32;
    const unsigned long long word = add | static_cast<unsigned>(key);
    for (unsigned s = slot_of(key, slot_mask);; s = (s + 1) & slot_mask) {
      unsigned long long cur = table[s];
      if (cur == 0) {
        cur = atomicCAS(&table[s], 0ull, word);
        if (cur == 0) break;  // claimed, with its count
      }
      if (static_cast<unsigned>(cur) == static_cast<unsigned>(key)) {
        atomicAdd(&table[s], add);
        break;
      }
    }
  }
}

__device__ __forceinline__ int lookup(const unsigned long long* table, unsigned slot_mask,
                                      int key) {
  for (unsigned s = slot_of(key, slot_mask);; s = (s + 1) & slot_mask) {
    const unsigned long long cur = table[s];
    if (cur == 0) return 0;
    if (static_cast<unsigned>(cur) == static_cast<unsigned>(key))
      return static_cast<int>(cur >> 32);
  }
}

// One block a row; dynamic shared memory: the table, slot_mask + 1 words.
__global__ void __launch_bounds__(kTableThreads)
    cooccurrence_table_kernel(const int* __restrict__ q, const int* __restrict__ k,
                              float* __restrict__ out, int lq, int lk, unsigned slot_mask) {
  extern __shared__ unsigned long long table[];
  const size_t r = blockIdx.x;
  const int* qrow = q + r * lq;
  const int* krow = k + r * lk;
  float* orow = out + r * lq;
  for (int k0 = 0; k0 < lk || k0 == 0; k0 += kTableKeys) {
    for (unsigned s = threadIdx.x; s <= slot_mask; s += blockDim.x) table[s] = 0;
    __syncthreads();
    insert_keys(table, slot_mask, krow + k0, min(kTableKeys, lk - k0));
    __syncthreads();
    for (int i = threadIdx.x; i < lq; i += blockDim.x) {
      const float c = static_cast<float>(lookup(table, slot_mask, qrow[i]));
      orow[i] = k0 == 0 ? c : orow[i] + c;
    }
    __syncthreads();  // the table is cleared for the next chunk
  }
}

// One warp a row: keys 32 at a time in registers, broadcast to the
// lanes' queries.
__global__ void __launch_bounds__(32 * kPairWarps)
    cooccurrence_pairs_kernel(const int* __restrict__ q, const int* __restrict__ k,
                              float* __restrict__ out, int rows, int lq, int lk) {
  const size_t r = static_cast<size_t>(blockIdx.x) * kPairWarps + threadIdx.x / 32;
  if (r >= static_cast<size_t>(rows)) return;  // a whole warp leaves
  const int lane = threadIdx.x % 32;
  const int* qrow = q + r * lq;
  const int* krow = k + r * lk;
  for (int i0 = 0; i0 < lq; i0 += 32) {
    const int i = i0 + lane;
    const int qv = i < lq ? qrow[i] : 0;
    int count = 0;
    for (int j0 = 0; j0 < lk; j0 += 32) {
      const int n = min(32, lk - j0);
      const int kv = lane < n ? krow[j0 + lane] : 0;
      for (int s = 0; s < n; ++s) count += __shfl_sync(kFullMask, kv, s) == qv;
    }
    if (i < lq) out[r * lq + i] = static_cast<float>(count);
  }
}

}  // namespace

// q: (rows, lq) int32; k: (rows, lk) int32; out: (rows, lq) f32.
// all_pairs: 1 for the warp-per-row path, 0 for the table path, whose
// table has slots slots (a power of two, at least 64 and twice min(lk,
// kTableKeys)).
DYGLIB_API int cooccurrence_forward(const int* q, const int* k, float* out, int rows, int lq,
                                    int lk, int all_pairs, int slots, cudaStream_t stream) {
  if (rows == 0 || lq == 0) return 0;
  if (all_pairs) {
    const int blocks = (rows + kPairWarps - 1) / kPairWarps;
    cooccurrence_pairs_kernel<<<blocks, 32 * kPairWarps, 0, stream>>>(q, k, out, rows, lq, lk);
    return static_cast<int>(cudaGetLastError());
  }
  if (slots < 64 || slots < 2 * min(lk, kTableKeys) || (slots & (slots - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int longest = max(lq, min(lk, kTableKeys));
  const int threads = min(kTableThreads, (longest + 31) / 32 * 32);
  const size_t smem = sizeof(unsigned long long) * slots;
  cooccurrence_table_kernel<<<rows, threads, smem, stream>>>(
      q, k, out, lq, lk, static_cast<unsigned>(slots - 1));
  return static_cast<int>(cudaGetLastError());
}
