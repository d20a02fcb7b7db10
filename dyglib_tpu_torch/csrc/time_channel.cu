// DyGFormer's fused time channel:
//   out[r, :] = bias + sum_j sum_f Phi(r, j, f) * W[j * Dt + f, :]
//   Phi(r, j, f) = valid[r * patch + j] ? cos(dt[r * patch + j] * tw[f] + tb[f]) : 0
// for patch rows r = (m, p) of dt/valid (M, L), L = P * patch.
//
// Replaces dyglib_tpu/ops/pallas/time_channel.py::_fwd_kernel. Phi is
// computed slice by slice into shared memory by the tile's A loader and
// contracted at once against the staged slice of W; the (M, L, Dt) masked
// feature tensor never reaches device memory. The argument is rounded
// exactly as PyTorch's separate multiply and add round it (no fused
// multiply-add), and cosf is the accurate cosine: dt reaches 1e6 and more,
// where the fast __cosf is wrong.
#include "tiled_gemm.cuh"

namespace {

struct PhiLoader {
  const float* __restrict__ dt;
  const bool* __restrict__ valid;
  const float* __restrict__ tw;
  const float* __restrict__ tb;
  int patch;
  int dt_dim;

  __device__ __forceinline__ float operator()(int r, int k) const {
    const int j = k / dt_dim;
    const int f = k - j * dt_dim;
    const size_t idx = static_cast<size_t>(r) * patch + j;
    const float theta = __fadd_rn(__fmul_rn(dt[idx], tw[f]), tb[f]);
    return valid[idx] ? cosf(theta) : 0.f;
  }
};

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
