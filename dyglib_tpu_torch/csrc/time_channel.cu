// DyGFormer's fused time channel:
//   out[r, :] = bias + sum_j sum_f Phi(r, j, f) * W[j * Dt + f, :]
//   Phi(r, j, f) = valid[r * patch + j] ? cos(theta) : 0
//   theta = dt[r * patch + j] * tw[f] + tb[f]
// for patch rows r = (m, p) of dt/valid (M, L), L = P * patch.
//
// Forward: replaces dyglib_tpu/ops/pallas/time_channel.py::_fwd_kernel.
// Phi is computed slice by slice into shared memory by the tile's A loader
// and contracted at once against the staged slice of W; the (M, L, Dt)
// masked feature tensor never reaches device memory.
//
// Backward: replaces ::_bwd_kernel. Given dout (rows, ced):
//   dW = Phi^T @ dout, dbias = sum_r dout[r]    (weight_grad.cuh: Phi is
//       recomputed by the same loader, never saved; deterministic two-pass)
//   dPhi = dout @ W^T, and per (r, j, f) with valid set:
//       c = -dPhi * sin(theta);  dtb[f] += c;  dtw[f] += c * dt
//   (one GEMM tile per (64 rows, 64 columns of K) whose epilogue applies
//   the sine and sums its 64 rows per column into scratch; strided_sum
//   then adds the row tiles and patch slots in a fixed order)
// No gradient for dt or valid.
//
// theta and Phi come from phi.cuh (exact rounding of the argument, the
// accurate cosf); sinf is the accurate function too, for the same reason.
#include "phi.cuh"
#include "weight_grad.cuh"

namespace {

using dyglib::theta_of;
using PhiLoader = dyglib::PhiLoaderT<true>;

__global__ void __launch_bounds__(dyglib::kThreads)
    time_channel_fwd_kernel(PhiLoader phi, const float* __restrict__ w, int w_sk, int w_sn,
                            const float* __restrict__ bias, float* __restrict__ out,
                            int rows, int k_total, int ced) {
  dyglib::gemm_bias_tile(phi, w, w_sk, w_sn, bias, out, rows, k_total, ced);
}

// dPhi tile (rows row0.., columns col0.. of K) = dout @ W^T, then per
// column the block's sums of c and c * dt into part_tw / part_tb
// (n_row_tiles, K) at row blockIdx.x. W^T(c, kc) = W(kc, c) is read
// through the forward's strides, swapped.
__global__ void __launch_bounds__(dyglib::kThreads)
    time_param_grad_kernel(PhiLoader phi, const float* __restrict__ dout,
                           const float* __restrict__ w, int w_sk, int w_sn,
                           float* __restrict__ part_tw, float* __restrict__ part_tb, int rows,
                           int ced) {
  using namespace dyglib;
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
        const size_t idx = static_cast<size_t>(r) * phi.patch + slot;
        if (!phi.valid[idx]) continue;
        const float d = phi.dt[idx];
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

}  // namespace

// dt: (rows * patch) f32; valid: (rows * patch) bool; tw, tb: (dt_dim) f32;
// w: (patch * dt_dim, ced) f32 with element strides (w_sk, w_sn); bias: (ced)
// f32; out: (rows, ced) f32.
DYGLIB_API int time_channel_forward(const float* dt, const bool* valid, const float* tw,
                                    const float* tb, const float* w, int w_sk, int w_sn,
                                    const float* bias, float* out, int rows, int patch,
                                    int dt_dim, int ced, cudaStream_t stream) {
  if (rows == 0 || ced == 0) return 0;
  const dim3 grid((rows + dyglib::kBM - 1) / dyglib::kBM, (ced + dyglib::kBN - 1) / dyglib::kBN);
  time_channel_fwd_kernel<<<grid, dyglib::kThreads, 0, stream>>>(
      PhiLoader{dt, valid, tw, tb, patch, dt_dim}, w, w_sk, w_sn, bias, out, rows,
      patch * dt_dim, ced);
  return static_cast<int>(cudaGetLastError());
}

// As the forward, plus dout: (rows, ced) f32. Outputs: dw_ext
// (patch * dt_dim + 1, ced) f32 (rows 0..K-1 = dW, row K = dbias); dtw, dtb
// (dt_dim) f32. Scratch: partial (ceil(rows / chunk_rows), K + 1, ced),
// part_tw and part_tb (ceil(rows / 64), K), all f32.
DYGLIB_API int time_channel_backward(const float* dt, const bool* valid, const float* tw,
                                     const float* tb, const float* w, int w_sk, int w_sn,
                                     const float* dout, float* dw_ext, float* dtw, float* dtb,
                                     float* partial, float* part_tw, float* part_tb, int rows,
                                     int patch, int dt_dim, int ced, int chunk_rows,
                                     cudaStream_t stream) {
  if (ced == 0 || dt_dim == 0) return 0;
  const int k_total = patch * dt_dim;
  const PhiLoader phi{dt, valid, tw, tb, patch, dt_dim};
  cudaError_t err = dyglib::launch_weight_grad(phi, dout, partial, dw_ext, rows, k_total, ced,
                                               chunk_rows, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows == 0) {
    err = cudaMemsetAsync(dtw, 0, sizeof(float) * dt_dim, stream);
    if (err == cudaSuccess) err = cudaMemsetAsync(dtb, 0, sizeof(float) * dt_dim, stream);
    return static_cast<int>(err);
  }
  const int row_tiles = (rows + dyglib::kBM - 1) / dyglib::kBM;
  const dim3 grid(row_tiles, (k_total + dyglib::kBN - 1) / dyglib::kBN);
  time_param_grad_kernel<<<grid, dyglib::kThreads, 0, stream>>>(phi, dout, w, w_sk, w_sn,
                                                                 part_tw, part_tb, rows, ced);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // part (row_tiles, patch, dt_dim) summed over its first two axes
  err = dyglib::launch_strided_sum(part_tw, dtw, row_tiles * patch, dt_dim, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(dyglib::launch_strided_sum(part_tb, dtb, row_tiles * patch, dt_dim,
                                                     stream));
}
