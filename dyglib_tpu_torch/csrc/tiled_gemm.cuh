// One output tile of  out = A @ B  in float32 on CUDA cores.
//
// A is never read from a tensor by this code: a loader functor yields
// A(i, k), so the same tile serves the attention kernels' per-head
// products: row-major operands and, in the backward's weight gradients,
// transposed ones (attention_bwd.cuh). Each A loader declares a
// compile-time `k_fast`: true when consecutive k are consecutive
// addresses (then consecutive threads stage consecutive k of one row),
// false when consecutive i are; either way a warp's reads are coalesced.
//
// B(k, c) is read at b[k * b_sk + c * b_sn]: row-major (K, N), or the
// transpose of nn.Linear's row-major (N, K) weight, with no copy either
// way; consecutive threads take consecutive addresses of B in either
// layout. The template argument BOrder fixes that staging order at
// compile time where the layout is known (kBRowMajor: consecutive c are
// consecutive addresses); kBByStrides picks it at run time from b_sk (a
// compile-time order for the forward's W measured slower). B is a raw
// pointer, not a loader struct (a struct there made the forward kernels
// slower), read through the read-only data cache (__ldg): every block of
// a projection reads all of W.
//
// Tiling: a block of 256 threads owns kBM rows x kBN columns of the
// output and walks its k range in kBK-deep slices. Each slice of A and of
// B is staged in shared memory; each thread then accumulates a kTM x kTN
// micro-tile whose rows and columns are strided by 16, so that
// neighbouring threads read neighbouring shared-memory banks and write
// neighbouring output columns. Accumulation is f32 fmaf over k in
// ascending order.
#pragma once

#include "common.cuh"

namespace dyglib {

constexpr int kBM = 64;  // the Python wrappers size scratch by this (ops/_build.py TILE_ROWS)
constexpr int kBN = 64;
constexpr int kBK = 16;
constexpr int kTM = 4;
constexpr int kTN = 4;
constexpr int kThreadRows = kBM / kTM;  // 16
constexpr int kThreadCols = kBN / kTN;  // 16
constexpr int kThreads = kThreadRows * kThreadCols;  // 256
static_assert(kBM * kBK % kThreads == 0 && kBK * kBN % kThreads == 0,
              "each thread stages a whole number of elements per slice");

// A(i, k) = p[i * ld + k] of a row-major matrix.
struct RowMajorLoader {
  static constexpr bool k_fast = true;
  const float* __restrict__ p;
  int ld;

  __device__ __forceinline__ float operator()(int i, int k) const {
    return p[static_cast<size_t>(i) * ld + k];
  }
};

enum BOrder { kBByStrides, kBRowMajor };

// acc = sum over k in [k_begin, k_end) of A(row0 + i, k) * B(k, col0 + j)
// for this thread's micro-tile: rows row0 + ty + i * 16, columns
// col0 + tx + j * 16 (ty = threadIdx.x / 16, tx = threadIdx.x % 16).
// Elements past `rows`, `n` or `k_end` count as zero.
template <BOrder kBOrder, class ALoader>
__device__ __forceinline__ void gemm_tile(const ALoader& load_a, const float* __restrict__ b,
                                          int b_sk, int b_sn, int rows, int n, int k_begin,
                                          int k_end, int row0, int col0,
                                          float (&acc)[kTM][kTN]) {
  __shared__ float a_s[kBK][kBM + 1];
  __shared__ float b_s[kBK][kBN + 1];
  const bool b_k_fast = kBOrder == kBByStrides && b_sk == 1;
  const int tid = threadIdx.x;
  const int ty = tid / kThreadCols;
  const int tx = tid % kThreadCols;

#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
#pragma unroll
    for (int s = 0; s < kBM * kBK / kThreads; ++s) {
      const int e = tid + s * kThreads;
      const int r = load_a.k_fast ? e / kBK : e % kBM;
      const int kk = load_a.k_fast ? e % kBK : e / kBM;
      const int gr = row0 + r, gk = k0 + kk;
      a_s[kk][r] = (gr < rows && gk < k_end) ? load_a(gr, gk) : 0.f;
    }
#pragma unroll
    for (int s = 0; s < kBK * kBN / kThreads; ++s) {
      const int e = tid + s * kThreads;
      const int kk = b_k_fast ? e % kBK : e / kBN;
      const int c = b_k_fast ? e / kBK : e % kBN;
      const int gk = k0 + kk, gc = col0 + c;
      b_s[kk][c] = (gk < k_end && gc < n)
                       ? __ldg(b + static_cast<size_t>(gk) * b_sk + static_cast<size_t>(gc) * b_sn)
                       : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float av[kTM], bv[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) av[i] = a_s[kk][ty + i * kThreadRows];
#pragma unroll
      for (int j = 0; j < kTN; ++j) bv[j] = b_s[kk][tx + j * kThreadCols];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

}  // namespace dyglib
