// The per-head products of TGAT's attention kernels on Hopper's tensor
// cores, f32-accurate: the tile under head_project_kernel and
// head_combine_kernel (attention_core.cuh) and head_weight_grad_kernel
// (attention_bwd.cuh).
//
// What it replaces. The Pallas kernels (dyglib_tpu/ops/pallas/{temporal,
// gathered,window}_attention.py) project every kv row into key and val
// and contract dkey, dval with kv and W. Reassociated (attention_core.cuh,
// attention_bwd.cuh), those products become three per-head products over
// the queries, with hd = dq / heads:
//   head_project      qk[r, h] = Wk_h q3_h[r]    (m x kv_dim, depth hd)
//   head_combine      out_h[r] = Av[r, h] Wv_h   (m x hd, depth kv_dim)
//   head_weight_grad  dW[:, h] = sum_r Ak[r, h]^T q3_h[r]
//                                                (kv_dim x hd, depth m)
//
// What bounds them on an H100. At TGAT's layer 1, hop 1 (m = 12,000
// queries, kv_dim = 444, dq = 272, 2 heads) each is 2.90 G operations:
// 17.6 us at the 165 T/s of a float32-accurate product (three TF32 passes
// at 495 T/s), 43 us at the 67 T/s of the f32 CUDA cores. Each moves
// ~56 MB (the (m, heads, kv_dim) side, 42.6 MB, the (m, dq) side, 13.1 MB,
// W 0.5 MB; the weight gradient's chunk partial sums ~9 MB more): 16.8 us
// at 3.35 TB/s. So the operations and the bytes bound them about equally,
// and only the tensor cores bring the operations down to the bytes.
// mma.sync itself peaks at ~320 T/s of TF32 on the card (measured), ~107
// T/s in three passes: 27 us a product. The tile reaches ~77-85 us a
// product, held by its staging and latency, not by the tensor cores (one
// pass instead of three was only ~25% faster; PERF.md).
//
// Each product splits every operand in registers, v = tf32(v) + (v -
// tf32(v)), and sums lo*hi + hi*lo + hi*hi in f32 (patch_gemm.cuh's
// split_tf32, mma_tf32 and multiply_stage), so the results keep f32
// agreement; W is split in the blocks that read it, not by a pass of its
// own.
//
// The design:
//   * mma.sync m16n8k8 TF32, its fragments loaded register by register
//     from shared memory, so that one code path reads every layout the
//     three products meet: an operand's stage is copied in the order it
//     lies in memory, [row][k] where k is its fast axis (36 floats a row,
//     4 mod 32) and [k][row] where the row is (a stride 8 mod 16 floats,
//     e.g. 72 or 136), and both give each warp's fragment reads 32 distinct
//     banks. head_project reads q3 (or dout) k-fast and W's head columns in
//     either stride order; head_combine reads Av (Ak) k-fast at a row
//     stride of heads x kv_dim; head_weight_grad reduces over the rows, the
//     slow axis of both Ak (Av) and q3 (dout), so both its operands are
//     [k][row]. wgmma takes TF32 operands K-major only: of these products
//     only head_combine on nn.Linear's weight layout has both operands
//     K-major, and the weight gradient would need a transposing stage; so
//     all three stay on mma.sync, one path.
//   * A block is 4 warps: 4, 2 or 1 along its 128, 64 or 32 rows, each warp
//     32 rows by kNF n8 fragments, and the others (1, 2 or 4 along K)
//     splitting each stage's depth, their sums added in order of the
//     split through shared memory at the end. kNF is 7 for head_project
//     (kv_dim 444 in 8 blocks of 56 columns, 448) and 9 for the other two
//     (hd = 136 in 2 blocks of 72, 144). Columns past the output's are
//     zeros in shared memory, never in device memory. The rows follow the
//     shapes (ops/_plan.py::head_plan): at m = 12,000 head_project takes
//     128 and head_combine 64 (376 blocks of 128 would leave the second
//     round of the card's block slots 42% full); at m = 600 fewer, where
//     128 would leave SMs without a block; the weight gradient's tile
//     kv_dim with the least padding (64: 448).
//   * Operands stream through a 3-stage ring of cp.async copies, 16 bytes
//     each where every operand's row stride, head offset and address allow
//     it (kVec 4), else 4 bytes (kVec 1), one template argument a launch.
//     The copies zero-fill past the ragged edges (rows, columns, the end of
//     the reduction), so the edges are masked in shared memory; 8-deep
//     steps wholly past the reduction's end are skipped. A 4-stage ring,
//     registers capped for three blocks an SM, and 8-byte fragment reads
//     measured no faster (PERF.md).
//   * Results leave by 8-byte stores of each lane's column pair: head_project
//     writes 42.6 MB a product.
//   * The weight gradient's rows are cut into chunks (ops/_plan.py), whose
//     partial sums weight_grad.cuh's strided_sum adds in a fixed order. Every
//     sum has a fixed order and there are no atomics: two runs give
//     identical bits.
#pragma once

#include <cstdint>
#include <initializer_list>
#include <type_traits>

#include "patch_gemm.cuh"

namespace dyglib {
namespace head_gemm {

using patch_gemm::kTileK;

constexpr int kRing = 3;              // stages of the ring
constexpr int kKStride = kTileK + 4;  // [row][k] stages
constexpr int kProjectNF = 7;         // head_project's n8 fragments a block (HEAD_PROJECT_N)
constexpr int kHeadNF = 9;            // head_combine's and head_weight_grad's (HEAD_TILE_N)

// The row stride of a [k][row] stage of `cols` floats: the least >= cols
// that is 8 mod 16 (t * stride + g then hits 32 distinct banks).
constexpr int mn_stride(int cols) { return cols + ((8 - cols % 16) % 16 + 16) % 16; }
static_assert(kKStride % 32 == 4 && mn_stride(56) == 56 && mn_stride(72) == 72 &&
                  mn_stride(128) == 136 && mn_stride(32) == 40,
              "conflict-free fragment reads");

// X(i, k) = p[i * ld + k] where k is the fast axis, else p[k * ld + i].
struct Operand {
  const float* p;
  int ld;
};

// A block is kThreads = 128 threads: kWarpsM warps of 32 rows (kRows =
// 32 kWarpsM) by kWarpsK warps that split each stage's depth. Its tile is
// kRows by kCols = 8 kNF; A's stage [row][k] where kAKFast, else [k][row],
// and B's [column][k] where kBKFast, else [k][column].
template <int kWarpsM, int kNF, bool kAKFast, bool kBKFast>
struct Shape {
  static constexpr int kThreads = 128;
  static constexpr int kWarpsK = kThreads / 32 / kWarpsM;
  static constexpr int kRows = 32 * kWarpsM;
  static constexpr int kCols = 8 * kNF;
  static constexpr int kAStride = kAKFast ? kKStride : mn_stride(kRows);
  static constexpr int kBStride = kBKFast ? kKStride : mn_stride(kCols);
  static constexpr int kAFloats = kAKFast ? kRows * kAStride : kTileK * kAStride;
  static constexpr int kStageFloats = kAFloats + (kBKFast ? kCols * kBStride : kTileK * kBStride);
  // the accumulators the warps past the first along K hand over, [warp][element][lane]
  static constexpr int kAccFloats = 2 * kNF * 4;
  static constexpr int kHandFloats = (kWarpsK - 1) * kWarpsM * kAccFloats * 32;
  static_assert(kWarpsM * kWarpsK * 32 == kThreads && kTileK % (8 * kWarpsK) == 0,
                "whole warps, whole 8-deep steps a warp");
  static_assert(kHandFloats <= kRing * kStageFloats, "the hand-over fits the ring");
};

// Dynamic shared memory of a kernel whose blocks take either B layout.
template <int kWarpsM, int kNF, bool kAKFast>
constexpr size_t smem_bytes() {
  constexpr int a = Shape<kWarpsM, kNF, kAKFast, true>::kStageFloats;
  constexpr int b = Shape<kWarpsM, kNF, kAKFast, false>::kStageFloats;
  return sizeof(float) * kRing * (a > b ? a : b);
}

// Writes a warp's 32 x 8 kNF accumulators to dst (row stride ld), rows
// row0 + ... below row_end, columns col0 + ... below col_end: each lane's
// two adjacent columns by one 8-byte store where dst and ld allow it (the
// accumulator of (mt, nf) holds (row g, cols 2t, 2t + 1) and (g + 8, the
// same)).
template <int kNF>
__device__ __forceinline__ void store(const float (&acc)[2][kNF][4], float* dst, size_t ld,
                                      int row0, int row_end, int col0, int col_end) {
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const bool pairs = ((reinterpret_cast<uintptr_t>(dst) & 7) | (ld & 1)) == 0;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row0 + mt * 16 + g + half * 8;
      if (r >= row_end) continue;
#pragma unroll
      for (int nf = 0; nf < kNF; ++nf) {
        const int c = col0 + nf * 8 + 2 * t;
        float* p = dst + r * ld + c;
        const float v0 = acc[mt][nf][half * 2], v1 = acc[mt][nf][half * 2 + 1];
        if (pairs && c + 1 < col_end) {
          *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
        } else {
          if (c < col_end) p[0] = v0;
          if (c + 1 < col_end) p[1] = v1;
        }
      }
    }
}

// out(i, j) = the sum over k in [k_begin, k_end) of A(i, k) B(k, j), for
// the block's tile at (row0, col0), i < rows and j < cols (elements past
// them count as zero), written to out[i * ld_out + j]. Every thread of the
// block calls it; smem holds kRing stages. Warp (mi, kw) multiplies rows
// 32 mi + ... over the kw-th part of each stage's depth; the first warp of
// each row group then adds the others' sums in order of kw, and stores.
template <int kWarpsM, int kNF, bool kAKFast, bool kBKFast, int kVec>
__device__ __forceinline__ void product(float* smem, const Operand a, int rows, const Operand b,
                                        int cols, int k_begin, int k_end, int row0, int col0,
                                        float* out, size_t ld_out) {
  using S = Shape<kWarpsM, kNF, kAKFast, kBKFast>;
  namespace pg = patch_gemm;
  constexpr int kPart = kTileK / S::kWarpsK;  // depth a warp takes of a stage
  const int tiles = (k_end - k_begin + kTileK - 1) / kTileK;
  const int warp = threadIdx.x / 32;
  const int warp_mi = warp % kWarpsM, warp_k = warp / kWarpsM;
  const int warp_m = warp_mi * 32, k_off = warp_k * kPart;

  const auto load = [&](int tile, float* stage) {
    const int k0 = k_begin + tile * kTileK;
    if constexpr (kAKFast)
      pg::stage_tile<S::kThreads, S::kRows, kTileK, S::kAStride, kVec>(stage, a.p, a.ld, row0,
                                                                       rows, k0, k_end);
    else
      pg::stage_tile<S::kThreads, kTileK, S::kRows, S::kAStride, kVec>(stage, a.p, a.ld, k0,
                                                                       k_end, row0, rows);
    float* bs = stage + S::kAFloats;
    if constexpr (kBKFast)
      pg::stage_tile<S::kThreads, S::kCols, kTileK, S::kBStride, kVec>(bs, b.p, b.ld, col0, cols,
                                                                       k0, k_end);
    else
      pg::stage_tile<S::kThreads, kTileK, S::kCols, S::kBStride, kVec>(bs, b.p, b.ld, k0, k_end,
                                                                       col0, cols);
  };
  float acc[2][kNF][4] = {};
  int tile = 0;
  const auto multiply = [&](const float* stage) {
    const float* as = stage;
    const float* bs = stage + S::kAFloats;
    const int depth = min(k_end - k_begin - kTileK * tile++ - k_off, kPart);
    if (depth <= 0) return;
    pg::multiply_stage(
        [&](int mt, int r, int k) {
          const int i = warp_m + mt * 16 + r;
          k += k_off;
          return kAKFast ? as[i * S::kAStride + k] : as[k * S::kAStride + i];
        },
        [&](int nf, int k, int c) {
          const int j = nf * 8 + c;
          k += k_off;
          return kBKFast ? bs[j * S::kBStride + k] : bs[k * S::kBStride + j];
        },
        acc, depth);
  };
  pg::pipeline<S::kStageFloats, kRing>(smem, tiles, load, multiply);

  if constexpr (S::kWarpsK > 1) {
    const int lane = threadIdx.x % 32;
    __syncthreads();  // the ring is consumed: its memory takes the hand-over
    float* hand = smem + warp_mi * S::kAccFloats * 32 + lane;
    constexpr int kSlot = kWarpsM * S::kAccFloats * 32;
    if (warp_k > 0) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nf = 0; nf < kNF; ++nf)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            hand[(warp_k - 1) * kSlot + ((mt * kNF + nf) * 4 + i) * 32] = acc[mt][nf][i];
    }
    __syncthreads();
    if (warp_k > 0) return;
    for (int w = 0; w < S::kWarpsK - 1; ++w)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nf = 0; nf < kNF; ++nf)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][nf][i] += hand[w * kSlot + ((mt * kNF + nf) * 4 + i) * 32];
  }
  store(acc, out, ld_out, row0 + warp_m, rows, col0, cols);
}

// Whether every operand of a launch takes 16-byte copies: hd and kv_dim
// multiples of 4 (the row strides and head offsets) and 16-byte aligned
// addresses.
inline bool vector_copies(int kv_dim, int hd, std::initializer_list<const void*> ptrs) {
  bool ok = kv_dim % 4 == 0 && hd % 4 == 0;
  for (const void* p : ptrs) ok = ok && (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  return ok;
}

// f(warps_m, vec), with warps_m = rows / 32 (the warps along the rows of
// a 128-thread block) and vec (4 or 1) as std::integral_constant: the
// instantiation a plan picks.
template <class F>
cudaError_t dispatch(int rows, bool vec, const F& f) {
  using W4 = std::integral_constant<int, 4>;
  using W2 = std::integral_constant<int, 2>;
  using W1 = std::integral_constant<int, 1>;
  switch (rows) {
    case 128:
      return vec ? f(W4{}, W4{}) : f(W4{}, W1{});
    case 64:
      return vec ? f(W2{}, W4{}) : f(W2{}, W1{});
    case 32:
      return vec ? f(W1{}, W4{}) : f(W1{}, W1{});
    default:
      return cudaErrorInvalidValue;
  }
}

// Launch kKernel on grid with the dynamic shared memory `smem` (128
// threads), raising the kernel's shared-memory limit first where smem
// passes 48 KB, at every launch, as the query kernels' launches do.
template <auto kKernel, class... Args>
cudaError_t launch(dim3 grid, size_t smem, cudaStream_t stream, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kKernel<<<grid, 128, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace head_gemm
}  // namespace dyglib
