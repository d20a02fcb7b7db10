// Weight and bias gradients of a projection  out = A @ W + bias, summed
// over its rows, deterministically:
//
//   dW_ext (K + 1, n) = [A | 1]^T @ dout,  rows 0..K-1 = dW, row K = dbias
//
// A(r, i) is the forward's input (a feature functor, i < K), dout (rows, n)
// row-major. The ones column turns dbias = sum_r dout[r] into one more
// output row of the same product.
//
// The sum runs over every row of the forward (19,200 at the CanParl
// training shapes). A Pallas grid carries such a sum from one step to the
// next in its output block; Hopper's blocks run in no order, so it is
// split instead. The choice here is a deterministic two-pass reduction,
// not float atomics, so that two runs give bit-identical gradients:
//   pass 1: block (i tile, column tile, row chunk z) sums its chunk's
//           rows into partial[z] (K + 1, n), scratch the wrapper allocates;
//   pass 2: strided_sum adds the chunks in a fixed order.
// The chunk size is the wrapper's (ops/_build.py weight_grad_chunk_rows):
// enough chunks that pass 1 fills the card.
#pragma once

#include "tiled_gemm.cuh"

namespace dyglib {

// A^T with a ones row appended: T(i, r) = A(r, i) for i < K, 1 for i == K.
// Consecutive i of the features read here are consecutive addresses (or
// consecutive lanes of one computed row), so the staging walks i fastest.
template <class Feature>
struct TransposedWithOnes {
  static constexpr bool k_fast = false;
  Feature feature;
  int k_total;

  __device__ __forceinline__ float operator()(int i, int r) const {
    return i < k_total ? feature(r, i) : 1.f;
  }
};

template <class Feature>
__global__ void __launch_bounds__(kThreads)
    weight_grad_partial_kernel(Feature feature, const float* __restrict__ dout,
                               float* __restrict__ partial, int rows, int k_total, int n,
                               int chunk_rows) {
  const int r_begin = blockIdx.z * chunk_rows;
  const int r_end = min(rows, r_begin + chunk_rows);
  const int out_rows = k_total + 1;
  const int row0 = blockIdx.x * kBM;
  const int col0 = blockIdx.y * kBN;
  float acc[kTM][kTN];
  gemm_tile<kBRowMajor>(TransposedWithOnes<Feature>{feature, k_total}, dout, n, 1, out_rows, n,
                        r_begin, r_end, row0, col0, acc);
  float* out = partial + static_cast<size_t>(blockIdx.z) * out_rows * n;
  const int ty = threadIdx.x / kThreadCols;
  const int tx = threadIdx.x % kThreadCols;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = row0 + ty + i * kThreadRows;
    if (r >= out_rows) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int c = col0 + tx + j * kThreadCols;
      if (c < n) out[static_cast<size_t>(r) * n + c] = acc[i][j];
    }
  }
}

// out[c] = sum over s < count of in[s * cols + c]. Lane y of a column
// adds s = y, y + kLanes, ... in order; the lanes are then combined by a
// fixed tree. Two layouts, chosen by launch_strided_sum from (count, cols)
// alone, so the order is fixed by the shape: deterministic.
//   * kSumCols columns a block, kSumLanes lanes each: coalesced, for the
//     wide outputs of a weight gradient's chunk partials;
//   * one column a block, kColumnLanes lanes: for many rows of few columns
//     (a parameter's per-query or per-tile partial sums), where
//     ceil(cols / kSumCols) blocks would leave most of the card idle.
constexpr int kSumCols = 32;
constexpr int kSumLanes = 32;
constexpr int kColumnLanes = 256;
// fewer blocks of kSumCols columns than this (one an H100 SM) and more rows
// than kSumLanes: one block a column
constexpr int kSumFillBlocks = 132;

template <int kCols, int kLanes>
__global__ void __launch_bounds__(kCols * kLanes)
    strided_sum_kernel(const float* __restrict__ in, float* __restrict__ out, int count,
                       int cols) {
  __shared__ float part[kLanes][kCols + 1];
  const int c = blockIdx.x * kCols + threadIdx.x;
  float s = 0.f;
  if (c < cols)
    for (int i = threadIdx.y; i < count; i += kLanes) s += in[static_cast<size_t>(i) * cols + c];
  part[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
#pragma unroll
  for (int h = kLanes / 2; h > 0; h >>= 1) {
    if (threadIdx.y < h) part[threadIdx.y][threadIdx.x] += part[threadIdx.y + h][threadIdx.x];
    __syncthreads();
  }
  if (threadIdx.y == 0 && c < cols) out[c] = part[0][threadIdx.x];
}

inline cudaError_t launch_strided_sum(const float* in, float* out, int count, int cols,
                                      cudaStream_t stream) {
  const int blocks = (cols + kSumCols - 1) / kSumCols;
  if (blocks < kSumFillBlocks && count > kSumLanes)
    strided_sum_kernel<1, kColumnLanes>
        <<<cols, dim3(1, kColumnLanes), 0, stream>>>(in, out, count, cols);
  else
    strided_sum_kernel<kSumCols, kSumLanes>
        <<<blocks, dim3(kSumCols, kSumLanes), 0, stream>>>(in, out, count, cols);
  return cudaGetLastError();
}

// Both passes: dw_ext (k_total + 1, n) from partial (ceil(rows / chunk_rows),
// k_total + 1, n). With no rows the gradient is zero.
template <class Feature>
inline cudaError_t launch_weight_grad(Feature feature, const float* dout, float* partial,
                                      float* dw_ext, int rows, int k_total, int n,
                                      int chunk_rows, cudaStream_t stream) {
  const int out_rows = k_total + 1;
  if (rows == 0)
    return cudaMemsetAsync(dw_ext, 0, sizeof(float) * out_rows * static_cast<size_t>(n), stream);
  const int chunks = (rows + chunk_rows - 1) / chunk_rows;
  const dim3 grid((out_rows + kBM - 1) / kBM, (n + kBN - 1) / kBN, chunks);
  weight_grad_partial_kernel<<<grid, kThreads, 0, stream>>>(feature, dout, partial, rows,
                                                            k_total, n, chunk_rows);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_strided_sum(partial, dw_ext, chunks, out_rows * n, stream);
}

}  // namespace dyglib
