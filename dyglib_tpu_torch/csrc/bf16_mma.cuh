// bf16 products on Hopper's tensor cores, for the bf16 variants of the
// time channel (time_products.cuh's Bf16) and the patch projection
// (patch_projection_bf16.cu): mma.sync m16n8k16 with bf16 operands and f32
// accumulation, one pass. That is the TPU kernels' own math (bf16 operands,
// f32 sums: dyglib_tpu/ops/pallas/time_channel.py and patch_projection.py),
// which the split-TF32 loops of patch_gemm.cuh run three passes to avoid:
// the bf16 variants serve a model that computes in bf16, where those
// passes would buy accuracy the model throws away. bf16 mma runs at twice
// TF32's rate (989 against 495 T/s on an H100 SXM) and needs one pass
// instead of three.
//
// The fragments of m16n8k16 (g = lane / 4, t = lane % 4), each register
// two bf16 values, the lower k in the low half:
//   A (16 x 16, row): a0 (row g, k 2t, 2t + 1), a1 (row g + 8, the same k),
//                     a2 (row g, k 2t + 8, 2t + 9), a3 (row g + 8, those k)
//   B (16 x 8, col):  b0 (k 2t, 2t + 1, col g), b1 (k 2t + 8, 2t + 9, col g)
//   C (16 x 8):       as m16n8k8's: (row g, cols 2t, 2t + 1), (row g + 8, ...)
// so the accumulators, the ring (pg::pipeline) and the f32 stores
// (pg::store_tile) of patch_gemm.cuh serve unchanged. Operands that lie in
// device memory as f32 (the weights, the time channel's dout) are staged as
// f32 and rounded to bf16 (to nearest even, as torch's .to(bfloat16)) when
// their fragments are built; operands that lie there as bf16 (the patch
// projection's x and dout) are staged as bf16 by stage_tile below, half
// the bytes.
// Each stage's products sum into fresh registers that are added to the
// running sum on the CUDA cores, as in patch_gemm.cuh (the tensor cores'
// adds round toward zero).
#pragma once

#include "patch_gemm.cuh"

namespace dyglib {
namespace bf16 {

namespace pg = patch_gemm;

constexpr int kStep = 16;  // the mma's depth
// A stage row of bf16 values [k] (pg::kTileK of them) padded to 20 words:
// 20 = 20 mod 32, so the A fragment reads (row g, word t) hit 32 banks
constexpr int kRowWords = pg::kTileK / 2 + 4;
static_assert(pg::kTileK % kStep == 0, "whole mma steps a stage");

// bits of v rounded to bf16, to nearest even
__device__ __forceinline__ unsigned short to_bits(float v) {
  unsigned short h;
  asm("cvt.rn.bf16.f32 %0, %1;\n" : "=h"(h) : "f"(v));
  return h;
}

__device__ __forceinline__ float from_bits(unsigned short h) {
  return __uint_as_float(static_cast<unsigned>(h) << 16);
}

__device__ __forceinline__ float round(float v) { return from_bits(to_bits(v)); }

// lo and hi rounded to bf16 and packed, lo in the low half (cvt's first
// source goes to the high half)
__device__ __forceinline__ unsigned pack(float lo, float hi) {
  unsigned d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// two bf16 values already in bits, lo in the low half
__device__ __forceinline__ unsigned pack_bits(unsigned short lo, unsigned short hi) {
  return static_cast<unsigned>(lo) | (static_cast<unsigned>(hi) << 16);
}

constexpr unsigned kOnes = 0x3f803f80u;  // (1, 1) in bf16

__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                    unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// dst[r * kStride + c] = src[(r0 + r) * ld + c0 + c] for the kRows x kCols
// tile of bf16 values (kStride in values), kVec values a copy: 8, 4 or 2
// by cp.async (16, 8 or 4 bytes; the entry points pick the widest that the
// row stride and the address allow), 1 by a plain load (a row stride or an
// address that is not 4-byte aligned; cp.async has no 2-byte copy).
// Zero at rows >= r_end or columns >= c_end, where the copy is short.
template <int kThreads, int kRows, int kCols, int kStride, int kVec>
__device__ __forceinline__ void stage_tile(unsigned short* dst,
                                           const unsigned short* __restrict__ src, int ld,
                                           int r0, int r_end, int c0, int c_end) {
  static_assert(kCols % kVec == 0 && (kStride * 2) % 16 == 0, "whole, aligned copies");
  constexpr int kPerRow = kCols / kVec;
  constexpr int kCopies = kRows * kPerRow;
  constexpr int kPer = (kCopies + kThreads - 1) / kThreads;
  constexpr int kGroup = kPer > 8 ? 4 : kPer;  // as in pg::stage_tile
#pragma unroll 1
  for (int i0 = 0; i0 < kPer; i0 += kGroup) {
#pragma unroll
    for (int i = i0; i < i0 + kGroup; ++i) {
      const int e = threadIdx.x + i * kThreads;
      if (kCopies % (kThreads * kGroup) != 0 && e >= kCopies) break;
      const int r = e / kPerRow;
      const int c = (e % kPerRow) * kVec;
      const int gr = r0 + r, gc = c0 + c;
      const int n = gr < r_end ? min(max(c_end - gc, 0), kVec) : 0;
      unsigned short* d = dst + r * kStride + c;
      if constexpr (kVec == 1) {
        *d = n > 0 ? src[static_cast<size_t>(gr) * ld + gc] : static_cast<unsigned short>(0);
      } else {
        const unsigned short* s = n > 0 ? src + static_cast<size_t>(gr) * ld + gc : src;
        pg::copy_async<2 * kVec>(reinterpret_cast<float*>(d), reinterpret_cast<const float*>(s),
                                 2 * n);
      }
    }
  }
}

// One stage's products for this warp (two m16 tiles x pg::kNFrag n8
// fragments, pg::kTileK deep), added to acc. a_pair(mt, row, k) and
// b_pair(nf, k, col) return the packed pair (k, k + 1) of A(row, .) and
// B(., col).
template <class APair, class BPair>
__device__ __forceinline__ void multiply_stage(const APair& a_pair, const BPair& b_pair,
                                               float (&acc)[2][pg::kNFrag][4]) {
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  float part[2][pg::kNFrag][4] = {};
#pragma unroll
  for (int kk = 0; kk < pg::kTileK; kk += kStep) {
    unsigned a[2][4], b[pg::kNFrag][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) a[mt][i] = a_pair(mt, g + 8 * (i % 2), kk + 2 * t + 8 * (i / 2));
#pragma unroll
    for (int nf = 0; nf < pg::kNFrag; ++nf)
#pragma unroll
      for (int i = 0; i < 2; ++i) b[nf][i] = b_pair(nf, kk + 2 * t + 8 * i, g);
#pragma unroll
    for (int nf = 0; nf < pg::kNFrag; ++nf)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) mma(part[mt][nf], a[mt], b[nf][0], b[nf][1]);
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nf = 0; nf < pg::kNFrag; ++nf)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nf][i] += part[mt][nf][i];
}

// A bf16 linear layer's output roundings (the JAX package's
// TorchLinear(dtype=bfloat16): the product rounded to bf16, then its sum
// with the bias rounded to bf16, rounded again), in bits.
__device__ __forceinline__ unsigned short linear_out(float product, float bias) {
  return to_bits(round(product) + round(bias));
}

// out[i] = linear_out(partial[0][i] + partial[1][i] + ... (in that order),
// bias[i % ced]): pg::sum_partials_kernel for a bf16 output.
__global__ void __launch_bounds__(256)
    sum_partials_kernel(const float* __restrict__ partial, const float* __restrict__ bias,
                        unsigned short* __restrict__ out, int count, size_t n, int ced) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float s = partial[i];
    for (int z = 1; z < count; ++z) s += partial[z * n + i];
    out[i] = linear_out(s, bias[i % ced]);
  }
}

inline cudaError_t launch_sum_partials(const float* partial, const float* bias,
                                       unsigned short* out, int count, size_t n, int ced,
                                       cudaStream_t stream) {
  const int blocks = static_cast<int>(n < 4096 * 256 ? (n + 255) / 256 : 4096);
  sum_partials_kernel<<<blocks, 256, 0, stream>>>(partial, bias, out, count, n, ced);
  return cudaGetLastError();
}

}  // namespace bf16
}  // namespace dyglib
