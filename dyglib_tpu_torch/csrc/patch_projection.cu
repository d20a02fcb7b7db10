// DyGFormer's frozen-channel patch projection:
//   out[r, :] = bias + x[r] @ W,  x[r] = the (patch, D) rows of patch r,
// reading x (M, Lp, D) row-major against W viewed (patch, D, ced).
//
// Forward: replaces dyglib_tpu/ops/pallas/patch_projection.py::_fwd_kernel.
// In a row-major layout patch r's (patch, D) block is one contiguous run of
// patch * D floats, so the tile's A loader reads x in place; no
// (M, P, patch * D) repack is ever written.
//
// Backward: replaces ::_bwd_kernel. dW = patches(x)^T @ dout and
// dbias = sum_r dout[r], by the deterministic two-pass reduction of
// weight_grad.cuh (x read in place again). No dx: x holds rows of the
// frozen feature tables.
#include "weight_grad.cuh"

namespace {

__global__ void __launch_bounds__(dyglib::kThreads)
    patch_projection_fwd_kernel(dyglib::RowMajorLoader x, const float* __restrict__ w, int w_sk,
                                int w_sn, const float* __restrict__ bias,
                                float* __restrict__ out, int rows, int k_total, int ced) {
  dyglib::gemm_bias_tile(x, w, w_sk, w_sn, bias, out, rows, k_total, ced);
}

}  // namespace

// x: (rows, k_total) f32 with k_total = patch * D; w: (k_total, ced) f32
// with element strides (w_sk, w_sn); bias: (ced) f32; out: (rows, ced) f32.
DYGLIB_API int patch_projection_forward(const float* x, const float* w, int w_sk, int w_sn,
                                        const float* bias, float* out, int rows, int k_total,
                                        int ced, cudaStream_t stream) {
  if (rows == 0 || ced == 0) return 0;
  const dim3 grid((rows + dyglib::kBM - 1) / dyglib::kBM, (ced + dyglib::kBN - 1) / dyglib::kBN);
  patch_projection_fwd_kernel<<<grid, dyglib::kThreads, 0, stream>>>(
      dyglib::RowMajorLoader{x, k_total}, w, w_sk, w_sn, bias, out, rows, k_total, ced);
  return static_cast<int>(cudaGetLastError());
}

// x: (rows, k_total) f32; dout: (rows, ced) f32; dw_ext: (k_total + 1, ced)
// f32, rows 0..k_total-1 = dW, row k_total = dbias; partial:
// (ceil(rows / chunk_rows), k_total + 1, ced) f32 scratch.
DYGLIB_API int patch_projection_backward(const float* x, const float* dout, float* dw_ext,
                                         float* partial, int rows, int k_total, int ced,
                                         int chunk_rows, cudaStream_t stream) {
  if (ced == 0) return 0;
  return static_cast<int>(dyglib::launch_weight_grad(dyglib::RowMajorLoader{x, k_total},
                                                     dout, partial, dw_ext, rows, k_total, ced,
                                                     chunk_rows, stream));
}
