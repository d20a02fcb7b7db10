// DyGFormer's frozen-channel patch projection:
//   out[r, :] = bias + x[r] @ W,  x[r] = the (patch, D) rows of patch r,
// reading x (M, Lp, D) row-major against W viewed (patch, D, ced).
//
// Replaces dyglib_tpu/ops/pallas/patch_projection.py::_fwd_kernel. In a
// row-major layout patch r's (patch, D) block is one contiguous run of
// patch * D floats, so the tile's A loader reads x in place; no
// (M, P, patch * D) repack is ever written.
#include "tiled_gemm.cuh"

namespace {

struct RowLoader {
  const float* __restrict__ x;
  int k_total;

  __device__ __forceinline__ float operator()(int r, int k) const {
    return x[static_cast<size_t>(r) * k_total + k];
  }
};

__global__ void __launch_bounds__(dyglib::kThreads)
    patch_projection_fwd_kernel(RowLoader x, const float* __restrict__ w, int w_sk, int w_sn,
                                const float* __restrict__ bias, float* __restrict__ out,
                                int rows, int k_total, int ced) {
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
      RowLoader{x, k_total}, w, w_sk, w_sn, bias, out, rows, k_total, ced);
  return static_cast<int>(cudaGetLastError());
}
