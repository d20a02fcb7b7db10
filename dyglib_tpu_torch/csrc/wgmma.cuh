// Hopper's asynchronous building blocks for the bf16 forwards of the
// patch projection (patch_projection_bf16.cu) and the time channel
// (time_channel.cu): TMA tile loads into a ring of shared-memory stages
// that mbarriers hand from one producer warp to the consumer warpgroups,
// and wgmma.mma_async m64n56k16 (bf16 operands, f32 sums) on them.
//
//   * TMA (cp.async.bulk.tensor.2d) copies a (rows x 64) bf16 box, 128
//     bytes a row, into shared memory in the 128-byte swizzle (16-byte
//     chunk c of row r lands at chunk c ^ (r % 8)), the layout that a
//     K-major wgmma operand descriptor with the 128-byte swizzle names.
//     The tensor maps are encoded on the host for each launch
//     (cuTensorMapEncodeTiled, fetched from the driver through the runtime:
//     no -lcuda) and passed by value as __grid_constant__ kernel arguments.
//     Rows and columns past the tensor's extent arrive as zeros.
//   * A stage's mbarrier "full" counts the TMA bytes (arrive.expect_tx);
//     "empty" counts the consumer warps that are done with the stage. The
//     producer waits on "empty" before it reloads a stage; parities flip
//     at each pass over the ring.
//   * wgmma: one warpgroup (4 warps) multiplies a 64-row tile by the
//     56-column B stage, 16 deep, asynchronously. B always comes from
//     shared memory; A from shared memory (the patch projection's x) or
//     from registers (the time channel's Phi, computed in the fragment's
//     layout: warp w of the group holds rows 16 w + g and 16 w + g + 8 of
//     the tile, lane g = lane / 4, t = lane % 4, at k 2t, 2t + 1, 2t + 8,
//     2t + 9, as mma.sync.m16n8k16's A fragment). The accumulator of
//     (row 16 w + g + 8 (q / 2), column 8 j + 2t + q % 2) is d[4 j + q].
// The weights of both forwards are f32 parameters; pack_weight converts
// them once a launch into a padded bf16 (columns, K) copy that TMA reads.
// Where a block's share of W is two stages at most (the time channel at
// wikipedia's 112 padded K), the block converts it into its ring itself
// (load_packed_pairs, store_packed_pairs): no second launch, no scratch.
#pragma once

#include <cuda.h>
#include <cstdint>

#include "bf16_mma.cuh"

namespace dyglib {
namespace wgmma {

constexpr int kTileN = 56;           // one column tile: ced 50 in seven n8 blocks
constexpr int kAcc = kTileN / 2;     // f32 accumulators a thread for m64n56
constexpr int kStageK = 64;          // bf16 values of one 128-byte swizzled row
constexpr int kStep = 16;            // wgmma's depth
constexpr int kRowBytes = 2 * kStageK;
constexpr int kWStageBytes = 8192;   // 56 rows x 128 B, padded to 1024-byte alignment
constexpr int kWBoxBytes = kTileN * kRowBytes;

// ---- host: tensor maps

// A 2-D bf16 tensor map: `rows` rows of `cols` values, `row_bytes` apart
// (a multiple of 16), read in boxes of 64 values x box_rows rows with the
// 128-byte swizzle; zeros past the extent.
inline cudaError_t encode_map(CUtensorMap* map, const void* base, uint64_t cols, uint64_t rows,
                              uint64_t row_bytes, uint32_t box_rows) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static const Encode encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<Encode>(fn)
               : nullptr;
  }();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kStageK), box_rows};
  const cuuint32_t elems[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
                            dims, strides, box, elems, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// ---- the weights in bf16, once a launch

// dst[n * ld + kp] = bf16(W[k, n]) (to nearest even, as torch's
// .to(bfloat16)) with k = j * slot_in + f for kp = j * slot_out + f; zero
// where f >= slot_in, k >= k_total or n >= ced. W is at w[k * w_sk + n *
// w_sn]. The patch projection packs one slot (slot_in = slot_out =
// k_total), the time channel its patch slots padded from Dt to dt_pad.
__global__ void __launch_bounds__(256)
    pack_weight_kernel(const float* __restrict__ w, int w_sk, int w_sn, int ced, int k_total,
                       int slot_in, int slot_out, unsigned short* __restrict__ dst, int n_rows,
                       int ld) {
  const size_t count = static_cast<size_t>(n_rows) * ld;
  for (size_t e = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; e < count;
       e += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int n = static_cast<int>(e / ld), kp = static_cast<int>(e % ld);
    const int j = kp / slot_out, f = kp - j * slot_out;
    const int k = j * slot_in + f;
    const bool in = n < ced && f < slot_in && k < k_total;
    dst[e] = in ? bf16::to_bits(w[static_cast<size_t>(k) * w_sk + static_cast<size_t>(n) * w_sn])
                : static_cast<unsigned short>(0);
  }
}

inline cudaError_t pack_weight(const float* w, int w_sk, int w_sn, int ced, int k_total,
                               int slot_in, int slot_out, unsigned short* dst, int n_rows, int ld,
                               cudaStream_t stream) {
  const size_t count = static_cast<size_t>(n_rows) * ld;
  const int blocks = static_cast<int>(count < 1024 * 256 ? (count + 255) / 256 : 1024);
  pack_weight_kernel<<<blocks, 256, 0, stream>>>(w, w_sk, w_sn, ced, k_total, slot_in, slot_out,
                                                 dst, n_rows, ld);
  return cudaGetLastError();
}

// ---- device: barriers and copies

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// after the barriers' init, before any thread uses them (then __syncthreads)
__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void bar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// returns once the barrier's phase of this parity has completed (a fresh
// barrier's phase 1 counts as completed: the producer's first pass)
__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (done == 0);
}

// the box of `map` at (column c0, row r0) into dst, counted on bar
__device__ __forceinline__ void tma_load(const CUtensorMap& map, void* dst, uint64_t* bar, int c0,
                                         int r0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(smem_u32(bar)), "r"(c0), "r"(r0)
      : "memory");
}

// The byte offset of (row, value v) in a stage of 128-byte rows in the
// 128-byte swizzle, as TMA lays a box out (the stage 1024-byte aligned)
__device__ __forceinline__ int swizzled(int row, int v) {
  return row * kRowBytes + (((v / 8) ^ (row % 8)) * 16) + (v % 8) * 2;
}

// What TMA would bring from the packed W^T (pack_weight's values),
// converted by the block's kThreads threads instead: `stages` (at most
// kStages) boxes of 56 columns (n0 + 0..55) x 64 values (kp0 + 64 s +
// 0..63). Box row r (= 56 s + n) is 32 pairs of values; thread t takes
// pair t % 32 of rows t / 32 + u * kThreads / 32 into pair[u], so its
// values' K is the same in every row of a stage and is worked out once a
// stage. Every load is issued before the first store, so that their
// latencies overlap.
template <int kThreads, int kStages, int kPer>
__device__ __forceinline__ void load_packed_pairs(unsigned (&pair)[kPer], int stages,
                                                  const float* __restrict__ w, int w_sk,
                                                  int w_sn, int ced, int k_total, int slot_in,
                                                  int slot_out, int n0, int kp0) {
  constexpr int kPairs = kStageK / 2, kRows = kThreads / kPairs;
  static_assert(kThreads % kPairs == 0 && kPer * kRows >= kStages * kTileN, "whole rows");
  const int v = 2 * (threadIdx.x % kPairs), r0 = threadIdx.x / kPairs;
  int src[kStages][2];  // W's k of this thread's two values at each stage, -1 for a zero
#pragma unroll
  for (int s = 0; s < kStages; ++s)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kp = kp0 + s * kStageK + v + h;
      const int j = kp / slot_out, f = kp - j * slot_out, k = j * slot_in + f;
      src[s][h] = s < stages && f < slot_in && k < k_total ? k : -1;
    }
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int r = r0 + u * kRows, s = r / kTileN, n = n0 + r % kTileN;
    unsigned p = 0u;
#pragma unroll
    for (int q = 0; q < kStages; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (q == s && n < ced && src[q][h] >= 0)
          p |= static_cast<unsigned>(bf16::to_bits(
                   w[static_cast<size_t>(src[q][h]) * w_sk + static_cast<size_t>(n) * w_sn]))
               << (16 * h);
    pair[u] = p;
  }
}

// ... and the pairs into ring stages stage_bytes apart, in the 128-byte
// swizzle; each thread's writes fenced for wgmma's reads (the asynchronous
// proxy), which follow a barrier
template <int kThreads, int kPer>
__device__ __forceinline__ void store_packed_pairs(const unsigned (&pair)[kPer], int stages,
                                                   unsigned char* ring, int stage_bytes) {
  constexpr int kPairs = kStageK / 2, kRows = kThreads / kPairs;
  const int v = 2 * (threadIdx.x % kPairs), r0 = threadIdx.x / kPairs;
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int r = r0 + u * kRows, s = r / kTileN, n = r % kTileN;
    if (s < stages)
      *reinterpret_cast<unsigned*>(ring + s * stage_bytes + swizzled(n, v)) = pair[u];
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- device: wgmma

// K-major operand in the 128-byte swizzle: rows of 128 bytes, 8-row groups
// 1024 bytes apart (the base 1024-byte aligned); the k16 step i of a stage
// is the descriptor + 2 i (32 bytes further, in 16-byte units).
__device__ __forceinline__ uint64_t desc_sw128(const void* tile) {
  return static_cast<uint64_t>((smem_u32(tile) & 0x3FFFF) >> 4) | (uint64_t{1} << 16) |
         (uint64_t{1024 >> 4} << 32) | (uint64_t{1} << 62);
}

__device__ __forceinline__ void fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }

__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// returns when at most kPending of this warpgroup's committed groups run
template <int kPending>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// keeps the compiler from moving the accumulators' reads and writes across
// an asynchronous wgmma's start or its wait
template <int kN>
__device__ __forceinline__ void hold(float (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d = (scale_d ? d : 0) + A (64 x 16, shared memory) B (16 x 56)
__device__ __forceinline__ void mma_ss(float (&d)[kAcc], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %30, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n56k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27}, %28, %29, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27])
      : "l"(a), "l"(b), "r"(scale_d));
}

// the same with A from registers (four packed bf16 pairs a thread)
__device__ __forceinline__ void mma_rs(float (&d)[kAcc], const unsigned (&a)[4], uint64_t b,
                                       int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %33, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n56k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27}, {%28, %29, %30, %31}, %32, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// acc += part, on the CUDA cores (to nearest): each stage's products sum in
// fresh accumulators, as the mma.sync kernels' (patch_gemm.cuh says why)
template <int kN>
__device__ __forceinline__ void add(float (&acc)[kN], const float (&part)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) acc[i] += part[i];
}

// ---- m64n64: the time channel's bf16 backward (time_channel_bf16_bwd.cuh),
// whose tiles are 64 entries by a 64-wide stage: its 64 rows (dPhi) or its
// 64 columns (dW). The accumulators of (row 16 w + g + 8 (q / 2), column
// 8 j + 2t + q % 2) are d[4 j + q], j < 8, as m64n56's.

constexpr int kAcc64 = 32;  // f32 accumulators a thread for m64n64

// MN-major operand in the 128-byte swizzle: rows of 128 bytes, each one k
// index of 64 consecutive n values; 8-row (8-k) groups 1024 bytes apart
// (the base 1024-byte aligned). With n 64, one 128-byte row spans the
// whole operand, so only the 8-k groups' offset matters; it is set in both
// offset fields. The k16 step i of a stage is the descriptor + 128 i (16
// rows, 2048 bytes further, in 16-byte units).
__device__ __forceinline__ uint64_t desc_mn_sw128(const void* tile) {
  return static_cast<uint64_t>((smem_u32(tile) & 0x3FFFF) >> 4) | (uint64_t{1024 >> 4} << 16) |
         (uint64_t{1024 >> 4} << 32) | (uint64_t{1} << 62);
}

// The m64n64 accumulators as asm operands: read and written (kAdd: d +=
// A B) or written only (d = A B: the first step of a fresh sum, so that
// the registers are free before it)
#define DYGLIB_WG_ACC64(c)                                                                  \
  c(d[0]), c(d[1]), c(d[2]), c(d[3]), c(d[4]), c(d[5]), c(d[6]), c(d[7]), c(d[8]), c(d[9]), \
      c(d[10]), c(d[11]), c(d[12]), c(d[13]), c(d[14]), c(d[15]), c(d[16]), c(d[17]),       \
      c(d[18]), c(d[19]), c(d[20]), c(d[21]), c(d[22]), c(d[23]), c(d[24]), c(d[25]),       \
      c(d[26]), c(d[27]), c(d[28]), c(d[29]), c(d[30]), c(d[31])
#define DYGLIB_WG_D64                                                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "

// d = (kAdd ? d : 0) + A (64 x 16) B (16 x 64), both from shared memory,
// K-major
template <bool kAdd>
__device__ __forceinline__ void mma_ss64(float (&d)[kAcc64], uint64_t a, uint64_t b) {
  if constexpr (kAdd)
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " DYGLIB_WG_D64
                 "%32, %33, p, 1, 1, 0, 0;\n}\n"
                 : DYGLIB_WG_ACC64("+f")
                 : "l"(a), "l"(b), "r"(1));
  else
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " DYGLIB_WG_D64
                 "%32, %33, p, 1, 1, 0, 0;\n}\n"
                 : DYGLIB_WG_ACC64("=f")
                 : "l"(a), "l"(b), "r"(0));
}

// d = (kAdd ? d : 0) + A (registers, four packed bf16 pairs a thread) B
// (16 x 64, shared memory, MN-major: imm-trans-b 1)
template <bool kAdd>
__device__ __forceinline__ void mma_rs64_mn(float (&d)[kAcc64], const unsigned (&a)[4],
                                            uint64_t b) {
  if constexpr (kAdd)
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " DYGLIB_WG_D64
                 "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
                 : DYGLIB_WG_ACC64("+f")
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  else
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " DYGLIB_WG_D64
                 "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
                 : DYGLIB_WG_ACC64("=f")
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(0));
}

#undef DYGLIB_WG_D64
#undef DYGLIB_WG_ACC64

// A warpgroup's 64 x 56 accumulators to dst rows row0 + 0..63 (below
// row_end), columns col0 + 0..55 (below col_end): put(pointer offset,
// column, value) writes one.
template <class Put>
__device__ __forceinline__ void store(const float (&acc)[kAcc], int row0, int row_end, int col0,
                                      int col_end, size_t ld, const Put& put) {
  const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int q = 0; q < kAcc; ++q) {
    const int r = row0 + 16 * warp + g + 8 * ((q % 4) / 2);
    const int c = col0 + 8 * (q / 4) + 2 * t + q % 2;
    if (r < row_end && c < col_end) put(static_cast<size_t>(r) * ld + c, c, acc[q]);
  }
}

}  // namespace wgmma
}  // namespace dyglib
