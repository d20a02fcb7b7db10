// The second pass of the port's deterministic sums over rows.
//
// A sum over every row of a forward (a weight gradient over 240,000 kv
// rows, dtw and dtb over every position) is split into row chunks: Hopper's
// blocks run in no order, where a Pallas grid carries such a sum from one
// step to the next in its output block. Each chunk's block writes its
// partial sum to scratch the wrapper allocates, and strided_sum adds the
// chunks in a fixed order, not by float atomics, so that two runs give
// bit-identical gradients. Its users: the time channel's and the Phi
// projection's backward (time_channel_bwd.cuh), the patch projection's
// (patch_projection.cu) and the attention backward's weight gradients
// (attention_bwd.cuh, whose chunks ops/_plan.py head_plan sizes).
#pragma once

#include "common.cuh"

namespace dyglib {

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

}  // namespace dyglib
