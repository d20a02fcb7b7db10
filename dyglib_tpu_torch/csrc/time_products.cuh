// The products of the time channel's kernels (time_channel.cu's forward,
// time_channel_bwd.cuh's backward), one policy per arithmetic; the kernels
// are templates on it and keep everything else (the blocks, the W ring,
// Phi in registers with cos_reduced.cuh's cosines, the backward's
// Phi/-sin pairing and the fixed-order partial sums):
//   SplitTf32: f32-exact. mma.sync m16n8k8 in split TF32 as the patch
//     projection (patch_gemm.cuh): every operand v = hi + lo, three passes
//     lo*hi, hi*lo, hi*hi, f32 sums. The f32 model's kernels.
//   Bf16: the JAX kernels' math (dyglib_tpu/ops/pallas/time_channel.py):
//     Phi, W and dout rounded to bf16, one mma.sync m16n8k16 pass
//     (bf16_mma.cuh), f32 sums. A model built with compute_dtype bfloat16.
// Each policy gives:
//   kStep: the forward's k-step (8 or 16): a patch slot's Dt features are
//     padded to a multiple of it, so that no step straddles two slots;
//   kFeatures, feature(t, c): the features of a step that thread (g, t)'s
//     A fragment holds, c < kFeatures (for each of its 4 rows);
//   forward_step: one k-step of Phi (phi[mt][h][c], rows 16 mt + 8 h + g)
//     times a W stage [column][k], added to part;
//   kCols, kDStride, kWStride: the backward's dout tile width (56 padded
//     to the step; zero past 56), its stage's row stride and W's;
//   dphi_product: dPhi (16 entries x 32 rows, 8 rows a step nt) = W dout^T
//     over the tile's columns, for the steps with a valid row (any: the
//     ballot of the stage's rows);
//   dw_step(nt): dW += Phi^T dout over the rows of step nt (SplitTf32: its
//     8 rows, in the order 2t, 2t + 1; Bf16: at odd nt, the 16 rows of
//     steps nt - 1 and nt). phi[nt][r] holds (entry g + 8 (r / 2), row
//     8 nt + 2t + r % 2), the layout of dPhi's accumulators, so that one
//     theta gives Phi for dW and -sin for dPhi's epilogue.
#pragma once

#include "bf16_mma.cuh"
#include "patch_gemm.cuh"

namespace dyglib {
namespace time_products {

namespace pg = patch_gemm;

struct SplitTf32 {
  static constexpr int kStep = 8, kFeatures = 2;
  static constexpr int kCols = pg::kTileN;      // 56
  static constexpr int kDStride = kCols + 12;   // 68
  static constexpr int kWStride = kCols + 4;    // 60
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
    for (int kk = 0; kk < kCols; kk += 8) {
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

struct Bf16 {
  static constexpr int kStep = bf16::kStep, kFeatures = 4;
  static constexpr int kCols = 64;              // the 56 columns padded to 4 steps
  static constexpr int kDStride = kCols + 8;    // 72
  static constexpr int kWStride = kCols + 8;    // 72
  // 8 mod 32 floats: the 8-byte pair reads (row g, column 2t) hit distinct
  // banks in each half warp
  static_assert(kDStride % 32 == 8 && kWStride % 32 == 8, "conflict-free pair reads");

  // c = 2 q + j -> 2t + j + 8 q
  __device__ static int feature(int t, int c) { return 2 * t + c % 2 + 8 * (c / 2); }

  __device__ static void forward_step(float (&part)[2][pg::kNFrag][4],
                                      const float (&phi)[2][2][kFeatures], const float* stage,
                                      int kk, int g, int t) {
    // register i of m-tile mt: row h = i % 2, features (2t, 2t + 1) + 8 (i / 2)
    unsigned a[2][4], b[pg::kNFrag][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[mt][i] = bf16::pack(phi[mt][i % 2][2 * (i / 2)], phi[mt][i % 2][2 * (i / 2) + 1]);
#pragma unroll
    for (int nf = 0; nf < pg::kNFrag; ++nf)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float* p = stage + (nf * 8 + g) * pg::kFwdStride + kk + 2 * t + 8 * i;
        b[nf][i] = bf16::pack(p[0], p[1]);
      }
#pragma unroll
    for (int nf = 0; nf < pg::kNFrag; ++nf)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) bf16::mma(part[mt][nf], a[mt], b[nf][0], b[nf][1]);
  }

  __device__ static void dphi_product(float (&dphi)[4][4], const float* w_s, const float* stage,
                                      int wl, unsigned any, int g, int t) {
#pragma unroll
    for (int kk = 0; kk < kCols; kk += kStep) {
      unsigned wa[4];  // register i: entry g + 8 (i % 2), columns (2t, 2t + 1) + 8 (i / 2)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 v = *reinterpret_cast<const float2*>(
            w_s + (wl + g + 8 * (i % 2)) * kWStride + kk + 2 * t + 8 * (i / 2));
        wa[i] = bf16::pack(v.x, v.y);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        if (((any >> (8 * nt)) & 0xffu) == 0u) continue;
        const float* drow = stage + (8 * nt + g) * kDStride + kk + 2 * t;
        const float2 b0 = *reinterpret_cast<const float2*>(drow);
        const float2 b1 = *reinterpret_cast<const float2*>(drow + 8);
        bf16::mma(dphi[nt], wa, bf16::pack(b0.x, b0.y), bf16::pack(b1.x, b1.y));
      }
    }
  }

  __device__ static void dw_step(float (&part)[pg::kNFrag][4], const float (&phi)[4][4],
                                 const float* stage, int nt, unsigned any, int g, int t) {
    if (nt % 2 == 0) return;
    const int s = nt / 2;  // rows 16 s .. 16 s + 15
    if (((any >> (16 * s)) & 0xffffu) == 0u) return;
    // register i: entry g + 8 (i % 2), rows (2t, 2t + 1) + 8 (i / 2) + 16 s,
    // i.e. the accumulators (2 (i % 2), 2 (i % 2) + 1) of step 2 s + i / 2
    unsigned pa[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = 2 * s + i / 2, r = 2 * (i % 2);
      pa[i] = bf16::pack(phi[n][r], phi[n][r + 1]);
    }
#pragma unroll
    for (int nf = 0; nf < pg::kNFrag; ++nf) {
      const float* d0 = stage + (16 * s + 2 * t) * kDStride + nf * 8 + g;
      bf16::mma(part[nf], pa, bf16::pack(d0[0], d0[kDStride]),
                bf16::pack(d0[8 * kDStride], d0[9 * kDStride]));
    }
  }
};

}  // namespace time_products
}  // namespace dyglib
