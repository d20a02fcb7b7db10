// TGAT's fused time-feature projection:
//   out[r, :] = sum_f cos(dt[r] * tw[f] + tb[f]) * w[f, :]
// Replaces dyglib_tpu/ops/pallas/phi_projection.py::_fwd_kernel. The time
// channel's product at patch 1 with no mask and no bias, on the f32 tile:
// phi.cuh's A loader computes Phi slice by slice in shared memory, so it
// never reaches device memory.
//
// Backward: replaces ::_bwd_kernel. dw = Phi^T @ dout and, through dPhi =
// dout @ w^T and -sin(theta), dtw and dtb (phi.cuh launch_phi_backward,
// the same loader and the deterministic two-pass sums of weight_grad.cuh).
// dt gets no gradient.
#include "phi.cuh"

namespace {

using dyglib::PhiLoader;

__global__ void __launch_bounds__(dyglib::kThreads)
    phi_projection_kernel(PhiLoader phi, const float* __restrict__ w, int w_sk, int w_sn,
                          float* __restrict__ out, int rows, int dq) {
  using namespace dyglib;
  float acc[kTM][kTN];
  const int row0 = blockIdx.x * kBM;
  const int col0 = blockIdx.y * kBN;
  gemm_tile<kBByStrides>(phi, w, w_sk, w_sn, rows, dq, 0, phi.dt_dim, row0, col0, acc);
  const int ty = threadIdx.x / kThreadCols;
  const int tx = threadIdx.x % kThreadCols;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = row0 + ty + i * kThreadRows;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int c = col0 + tx + j * kThreadCols;
      if (c < dq) out[static_cast<size_t>(r) * dq + c] = acc[i][j];
    }
  }
}

}  // namespace

// dt: (rows) f32; tw, tb: (dt_dim) f32; w: (dt_dim, dq) f32 with element
// strides (w_sk, w_sn); out: (rows, dq) f32.
DYGLIB_API int phi_projection_forward(const float* dt, const float* tw, const float* tb,
                                      const float* w, int w_sk, int w_sn, float* out, int rows,
                                      int dt_dim, int dq, cudaStream_t stream) {
  if (rows == 0 || dq == 0) return 0;
  const dim3 grid((rows + dyglib::kBM - 1) / dyglib::kBM, (dq + dyglib::kBN - 1) / dyglib::kBN);
  phi_projection_kernel<<<grid, dyglib::kThreads, 0, stream>>>(
      PhiLoader{dt, tw, tb, 1, dt_dim}, w, w_sk, w_sn, out, rows, dq);
  return static_cast<int>(cudaGetLastError());
}

// As the forward, plus dout: (rows, dq) f32. Outputs: dw_ext (dt_dim + 1,
// dq) f32 (rows 0..dt_dim-1 = dw; the last, sum_r dout[r], is unused);
// dtw, dtb (dt_dim) f32. Scratch: partial (ceil(rows / chunk_rows), dt_dim +
// 1, dq), part_tw and part_tb (ceil(rows / 64), dt_dim), all f32.
DYGLIB_API int phi_projection_backward(const float* dt, const float* tw, const float* tb,
                                       const float* w, int w_sk, int w_sn, const float* dout,
                                       float* dw_ext, float* dtw, float* dtb, float* partial,
                                       float* part_tw, float* part_tb, int rows, int dt_dim,
                                       int dq, int chunk_rows, cudaStream_t stream) {
  return static_cast<int>(dyglib::launch_phi_backward(
      PhiLoader{dt, tw, tb, 1, dt_dim}, w, w_sk, w_sn, dout, dw_ext, dtw, dtb, partial,
      part_tw, part_tb, rows, dq, chunk_rows, stream));
}
