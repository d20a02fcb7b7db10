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
//   (phi.cuh launch_phi_backward: one GEMM tile per (64 rows, 64 columns
//   of K) whose epilogue applies the sine and sums its 64 rows per column
//   into scratch; strided_sum then adds the row tiles and patch slots in a
//   fixed order)
// No gradient for dt or valid.
//
// theta and Phi come from phi.cuh (exact rounding of the argument, the
// accurate cosf); sinf is the accurate function too, for the same reason.
#include "phi.cuh"

namespace {

using PhiLoader = dyglib::PhiLoaderT<true>;

__global__ void __launch_bounds__(dyglib::kThreads)
    time_channel_fwd_kernel(PhiLoader phi, const float* __restrict__ w, int w_sk, int w_sn,
                            const float* __restrict__ bias, float* __restrict__ out,
                            int rows, int k_total, int ced) {
  dyglib::gemm_bias_tile(phi, w, w_sk, w_sn, bias, out, rows, k_total, ced);
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
  return static_cast<int>(dyglib::launch_phi_backward(
      PhiLoader{dt, valid, tw, tb, patch, dt_dim}, w, w_sk, w_sn, dout, dw_ext, dtw, dtb, partial,
      part_tw, part_tb, rows, ced, chunk_rows, stream));
}
