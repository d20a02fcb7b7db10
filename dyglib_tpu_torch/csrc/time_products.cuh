// The products of the time channel's split-TF32 kernels (time_channel.cu's
// forward, time_channel_bwd.cuh's backward, which the Phi projection's
// backward shares); the kernels are templates on this policy and keep
// everything else (the blocks, the W ring, Phi in registers with
// cos_reduced.cuh's cosines, the backward's Phi/-sin pairing and the
// fixed-order partial sums):
//   SplitTf32: f32-exact. mma.sync m16n8k8 in split TF32 as the patch
//     projection (patch_gemm.cuh): every operand v = hi + lo, three passes
//     lo*hi, hi*lo, hi*hi, f32 sums. The f32 model's kernels.
// (The bf16 model's time channel runs on wgmma: time_channel.cu's forward
// and time_channel_bf16_bwd.cuh.)
// It gives the forward:
//   kStep: its k-step (8): a patch slot's Dt features are padded to a
//     multiple of it, so that no step straddles two slots;
//   kFeatures, feature(t, c): the features of a step that thread (g, t)'s
//     A fragment holds, c < kFeatures (for each of its 4 rows);
//   forward_step: one k-step of Phi (phi[mt][h][c], rows 16 mt + 8 h + g)
//     times a W stage [column][k], added to part;
// and the backward:
//   kDStride, kWStride: the backward's dout stage's row stride and W's
//     (its tile: pg::kTileN columns);
//   dphi_product: dPhi (16 entries x 32 rows, 8 rows a step nt) = W dout^T
//     over the tile's columns, for the steps with a valid row (any: the
//     ballot of the stage's rows);
//   dw_step(nt): dW += Phi^T dout over the 8 rows of step nt, in the order
//     2t, 2t + 1. phi[nt][r] holds (entry g + 8 (r / 2), row 8 nt + 2t +
//     r % 2), the layout of dPhi's accumulators, so that one theta gives
//     Phi for dW and -sin for dPhi's epilogue.
#pragma once

#include "patch_gemm.cuh"

namespace dyglib {
namespace time_products {

namespace pg = patch_gemm;

struct SplitTf32 {
  static constexpr int kStep = 8, kFeatures = 2;
  static constexpr int kDStride = pg::kTileN + 12;  // 68
  static constexpr int kWStride = pg::kTileN + 4;   // 60
  // 4 mod 8 floats: the fragment reads (rows g, columns t) and (rows 2t +
  // b, columns g) hit 32 distinct banks
  static_assert(kDStride % 8 == 4 && kWStride % 8 == 4, "conflict-free fragment reads");

  __device__ static int feature(int t, int c) { return t + 4 * c; }

  __device__ static void forward_step(float (&part)[2][pg::kNFrag][4],
                                      const float (&phi)[2][2][kFeatures], const float* stage,
                                      int kk, int g, int t) {
    // register i of m-tile mt: row h = i % 2, feature c = i / 2
    unsigned a_hi[2][4], a_lo[2][4], b_hi[pg::kNFrag][2], b_lo[pg::kNFrag][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const pg::Split s = pg::split_tf32(phi[mt][i % 2][i / 2]);
        a_hi[mt][i] = s.hi, a_lo[mt][i] = s.lo;
      }
#pragma unroll
    for (int nf = 0; nf < pg::kNFrag; ++nf)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const pg::Split s = pg::split_tf32(stage[(nf * 8 + g) * pg::kFwdStride + kk + t + 4 * i]);
        b_hi[nf][i] = s.hi, b_lo[nf][i] = s.lo;
      }
#pragma unroll
    for (int nf = 0; nf < pg::kNFrag; ++nf)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) pg::mma_tf32(part[mt][nf], a_lo[mt], b_hi[nf][0], b_hi[nf][1]);
#pragma unroll
    for (int nf = 0; nf < pg::kNFrag; ++nf)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) pg::mma_tf32(part[mt][nf], a_hi[mt], b_lo[nf][0], b_lo[nf][1]);
#pragma unroll
    for (int nf = 0; nf < pg::kNFrag; ++nf)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) pg::mma_tf32(part[mt][nf], a_hi[mt], b_hi[nf][0], b_hi[nf][1]);
  }

  __device__ static void dphi_product(float (&dphi)[4][4], const float* w_s, const float* stage,
                                      int wl, unsigned any, int g, int t) {
#pragma unroll
    for (int kk = 0; kk < pg::kTileN; kk += 8) {
      unsigned w_hi[4], w_lo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const pg::Split sp =
            pg::split_tf32(w_s[(wl + g + 8 * (i % 2)) * kWStride + kk + t + 4 * (i / 2)]);
        w_hi[i] = sp.hi, w_lo[i] = sp.lo;
      }
      // B(c, row) fragments, split; then the three passes, each over all
      // steps (mma.sync is issued in program order: no pass waits on the
      // one before it for the same accumulator)
      pg::Split b[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float* drow = stage + (8 * nt + g) * kDStride + kk + t;
        b[nt][0] = pg::split_tf32(drow[0]), b[nt][1] = pg::split_tf32(drow[4]);
      }
#pragma unroll
      for (int pass = 0; pass < 3; ++pass)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          if (((any >> (8 * nt)) & 0xffu) == 0u) continue;
          // lo*hi, hi*lo, hi*hi
          const unsigned b0 = pass == 1 ? b[nt][0].lo : b[nt][0].hi;
          const unsigned b1 = pass == 1 ? b[nt][1].lo : b[nt][1].hi;
          pg::mma_tf32(dphi[nt], pass == 0 ? w_lo : w_hi, b0, b1);
        }
    }
  }

  __device__ static void dw_step(float (&part)[pg::kNFrag][4], const float (&phi)[4][4],
                                 const float* stage, int nt, unsigned any, int g, int t) {
    if (((any >> (8 * nt)) & 0xffu) == 0u) return;
    // register r: (entry g + 8 (r % 2), row 2t + r / 2 of the step)
    unsigned a_hi[4], a_lo[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const pg::Split sp = pg::split_tf32(phi[nt][2 * (r % 2) + r / 2]);
      a_hi[r] = sp.hi, a_lo[r] = sp.lo;
    }
    const float* d0 = stage + (8 * nt + 2 * t) * kDStride + g;
    pg::Split b[pg::kNFrag][2];
#pragma unroll
    for (int nf = 0; nf < pg::kNFrag; ++nf)
      b[nf][0] = pg::split_tf32(d0[8 * nf]), b[nf][1] = pg::split_tf32(d0[kDStride + 8 * nf]);
#pragma unroll
    for (int nf = 0; nf < pg::kNFrag; ++nf) pg::mma_tf32(part[nf], a_lo, b[nf][0].hi, b[nf][1].hi);
#pragma unroll
    for (int nf = 0; nf < pg::kNFrag; ++nf) pg::mma_tf32(part[nf], a_hi, b[nf][0].lo, b[nf][1].lo);
#pragma unroll
    for (int nf = 0; nf < pg::kNFrag; ++nf) pg::mma_tf32(part[nf], a_hi, b[nf][0].hi, b[nf][1].hi);
  }
};

}  // namespace time_products
}  // namespace dyglib
