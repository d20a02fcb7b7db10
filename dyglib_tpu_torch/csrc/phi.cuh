// The cosine time features Phi of the TimeEncoder, computed where they are
// consumed:
//   theta = dt * tw[f] + tb[f],  Phi = cos(theta)
//
// theta is rounded exactly as PyTorch's separate multiply and add round it
// (no fused multiply-add), and cosf is the accurate function: dt reaches
// 1e6 and more, where one rounding more or less moves theta by up to
// ulp(1e6) = 0.06 rad, and where the fast __cosf is wrong.
//
// The backward of  out = Phi @ W (+ bias) on the f32 tile:
// launch_phi_backward, the Phi projection's (phi_projection.cu, patch 1,
// no bias). The time channel has kernels of its own (time_channel.cu).
#pragma once

#include "weight_grad.cuh"

namespace dyglib {

__device__ __forceinline__ float theta_of(float dt, float tw, float tb) {
  return __fadd_rn(__fmul_rn(dt, tw), tb);
}

// A(r, k) = Phi(r, j, f) for k = j * dt_dim + f, the patch-flattened time
// features of patch rows r = (m, p) of dt (M, L), L = P * patch:
//   Phi(r, j, f) = cos(theta(dt[r * patch + j], f))
// (phi_projection: patch 1). Staged k-fast: a warp reads one (r, j) slot's
// dt as a broadcast and consecutive tw / tb.
struct PhiLoader {
  static constexpr bool k_fast = true;
  const float* __restrict__ dt;
  const float* __restrict__ tw;
  const float* __restrict__ tb;
  int patch;
  int dt_dim;

  __device__ __forceinline__ float operator()(int r, int k) const {
    const int j = k / dt_dim;
    const int f = k - j * dt_dim;
    const size_t idx = static_cast<size_t>(r) * patch + j;
    return cosf(theta_of(dt[idx], tw[f], tb[f]));
  }
};

// dPhi tile (rows row0.., columns col0.. of K) = dout @ W^T, then per
// column the block's sums of c = -dPhi * sin(theta) and c * dt
// into part_tw / part_tb (n_row_tiles, K) at row blockIdx.x. W^T(c, kc) =
// W(kc, c) is read through the forward's strides, swapped. sinf is the
// accurate function, for the reason cosf is.
__global__ void __launch_bounds__(kThreads)
    phi_param_grad_kernel(PhiLoader phi, const float* __restrict__ dout,
                          const float* __restrict__ w, int w_sk, int w_sn,
                          float* __restrict__ part_tw, float* __restrict__ part_tb, int rows,
                          int ced) {
  const int k_total = phi.patch * phi.dt_dim;
  const int row0 = blockIdx.x * kBM;
  const int col0 = blockIdx.y * kBN;
  float acc[kTM][kTN];
  gemm_tile<kBByStrides>(RowMajorLoader{dout, ced}, w, w_sn, w_sk, rows, k_total, 0, ced, row0,
                         col0, acc);

  __shared__ float red_tw[kThreadRows][kBN];
  __shared__ float red_tb[kThreadRows][kBN];
  const int ty = threadIdx.x / kThreadCols;
  const int tx = threadIdx.x % kThreadCols;
#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    const int col = col0 + tx + j * kThreadCols;
    float s_tw = 0.f, s_tb = 0.f;
    if (col < k_total) {
      const int slot = col / phi.dt_dim;
      const int f = col - slot * phi.dt_dim;
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const int r = row0 + ty + i * kThreadRows;
        if (r >= rows) continue;
        const float d = phi.dt[static_cast<size_t>(r) * phi.patch + slot];
        const float c = acc[i][j] * -sinf(theta_of(d, phi.tw[f], phi.tb[f]));
        s_tb += c;
        s_tw += c * d;
      }
    }
    red_tw[ty][tx + j * kThreadCols] = s_tw;
    red_tb[ty][tx + j * kThreadCols] = s_tb;
  }
  __syncthreads();
  if (threadIdx.x < kBN) {
    const int col = col0 + threadIdx.x;
    if (col < k_total) {
      float s_tw = 0.f, s_tb = 0.f;
      for (int y = 0; y < kThreadRows; ++y) {
        s_tw += red_tw[y][threadIdx.x];
        s_tb += red_tb[y][threadIdx.x];
      }
      part_tw[static_cast<size_t>(blockIdx.x) * k_total + col] = s_tw;
      part_tb[static_cast<size_t>(blockIdx.x) * k_total + col] = s_tb;
    }
  }
}

// Given dout (rows, ced): dw_ext (patch * dt_dim + 1, ced) = [Phi | 1]^T @
// dout (rows 0..K-1 = dW, row K = dbias; weight_grad.cuh: Phi is
// recomputed by the loader, never saved) and dtw, dtb (dt_dim). Scratch:
// partial (ceil(rows / chunk_rows), K + 1, ced), part_tw and part_tb
// (ceil(rows / 64), K). Deterministic: both sums are two-pass.
inline cudaError_t launch_phi_backward(const PhiLoader& phi, const float* w, int w_sk,
                                int w_sn, const float* dout, float* dw_ext, float* dtw, float* dtb,
                                float* partial, float* part_tw, float* part_tb, int rows, int ced,
                                int chunk_rows, cudaStream_t stream) {
  if (ced == 0 || phi.dt_dim == 0) return cudaSuccess;
  const int k_total = phi.patch * phi.dt_dim;
  cudaError_t err =
      launch_weight_grad(phi, dout, partial, dw_ext, rows, k_total, ced, chunk_rows, stream);
  if (err != cudaSuccess) return err;
  if (rows == 0) {
    err = cudaMemsetAsync(dtw, 0, sizeof(float) * phi.dt_dim, stream);
    if (err == cudaSuccess) err = cudaMemsetAsync(dtb, 0, sizeof(float) * phi.dt_dim, stream);
    return err;
  }
  const int row_tiles = (rows + kBM - 1) / kBM;
  const dim3 grid(row_tiles, (k_total + kBN - 1) / kBN);
  phi_param_grad_kernel<<<grid, kThreads, 0, stream>>>(phi, dout, w, w_sk, w_sn, part_tw,
                                                                part_tb, rows, ced);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // part (row_tiles, patch, dt_dim) summed over its first two axes
  err = launch_strided_sum(part_tw, dtw, row_tiles * phi.patch, phi.dt_dim, stream);
  if (err != cudaSuccess) return err;
  return launch_strided_sum(part_tb, dtb, row_tiles * phi.patch, phi.dt_dim, stream);
}

}  // namespace dyglib
