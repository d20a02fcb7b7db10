// The argument of the TimeEncoder's cosine time features Phi, computed
// where they are consumed:
//   theta = dt * tw[f] + tb[f],  Phi = cos(theta)
//
// theta is rounded exactly as PyTorch's separate multiply and add round it
// (no fused multiply-add): dt reaches 1e6 and more, where one rounding more
// or less moves theta by up to ulp(1e6) = 0.06 rad. Every kernel that
// computes Phi (the time channel, the Phi projection, TGAT's attention)
// takes its cosine, and -sin where it needs one, from cos_reduced.cuh:
// cosf's and -sinf's bits without their slow path.
#pragma once

#include "common.cuh"

namespace dyglib {

__device__ __forceinline__ float theta_of(float dt, float tw, float tb) {
  return __fadd_rn(__fmul_rn(dt, tw), tb);
}

}  // namespace dyglib
