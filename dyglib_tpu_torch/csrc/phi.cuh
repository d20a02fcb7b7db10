// The cosine time features Phi of the TimeEncoder, computed where they are
// consumed:
//   theta = dt * tw[f] + tb[f],  Phi = cos(theta)
//
// theta is rounded exactly as PyTorch's separate multiply and add round it
// (no fused multiply-add), and cosf is the accurate function: dt reaches
// 1e6 and more, where one rounding more or less moves theta by up to
// ulp(1e6) = 0.06 rad, and where the fast __cosf is wrong.
#pragma once

#include "tiled_gemm.cuh"

namespace dyglib {

__device__ __forceinline__ float theta_of(float dt, float tw, float tb) {
  return __fadd_rn(__fmul_rn(dt, tw), tb);
}

// A(r, k) = Phi(r, j, f) for k = j * dt_dim + f, the patch-flattened time
// features of patch rows r = (m, p) of dt / valid (M, L), L = P * patch:
//   Phi(r, j, f) = cos(theta(dt[r * patch + j], f))
// zeroed where valid[r * patch + j] is false when kMasked (the time
// channel), unmasked otherwise (phi_projection, patch 1; valid unused).
// Staged k-fast: a warp reads one (r, j) slot's dt and valid as a
// broadcast and consecutive tw / tb.
template <bool kMasked>
struct PhiLoaderT {
  static constexpr bool k_fast = true;
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
    const float theta = theta_of(dt[idx], tw[f], tb[f]);
    if constexpr (kMasked) return valid[idx] ? cosf(theta) : 0.f;
    return cosf(theta);
  }
};

}  // namespace dyglib
