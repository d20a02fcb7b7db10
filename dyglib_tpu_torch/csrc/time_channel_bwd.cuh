// The backward of a projection of cosine time features, for DyGFormer's
// time channel (time_channel.cu) and TGAT's Phi projection
// (phi_projection.cu, its patch 1 with no mask and no bias). Given dout
// (rows, ced):
//   dW = Phi^T @ dout,  dbias = sum_r dout[r]      (kMasked: the time channel)
//   dPhi = dout @ W^T, and per (r, j, f) with valid set (every position
//   without kMasked):
//       c = dPhi * -sin(theta);  dtb[f] += c;  dtw[f] += c * dt
// in one kernel, both products in split TF32 on mma.sync as the time
// channel's forward (patch_gemm.cuh: every operand v = hi + lo, three
// passes lo*hi, hi*lo, hi*hi, f32 sums; or, for the time channel's bf16
// variant, one bf16 pass on Phi, dout and W rounded to bf16: the Product
// policy of time_products.cuh), dbias on the CUDA cores from the
// same dout stages (the first entry tile's blocks; as a column of ones in
// the product it left one warp a chunk's whole dbias product where few
// positions are valid, and as a separate column sum it cost wikipedia's
// launch 28%, PERF.md).
// At CanParl (19,200 rows, K = 6400, ced 50) the two products are 24.6 G
// operations, 73.7 G in three TF32 passes: 0.149 ms at 495 T/s, the bound
// (its 13 MB take 4 us; its 98 M (cosine, sine) pairs 0.05 ms at the SFU's
// rate). A block owns 16 kWarps padded K entries (Dt padded to dt_pad per
// slot) and one 56-column tile of dout, and streams a chunk of rows
// through a 4-stage cp.async ring of dout, 32 rows a stage, with kWarps
// warps of 16 entries. Each thread holds two entries (g and g + 8 of its
// warp's 16: one 8-entry group each, so each entry's slot is the whole
// warp's) and, per 8-row step, two rows: 2t and 2t + 1. The dW product reduces over rows in that order (a
// permutation of its depth), so that the (row, entry) pairs of a thread's
// A fragment are exactly those its dPhi accumulator fragment holds: one
// theta, reduced once by cos_reduced.cuh's sincos_reduced, gives Phi for
// dW and -sin for dPhi's epilogue. Phi is never stored; dPhi never leaves
// registers: c and c * dt are summed per entry over the thread's rows,
// then over its quad's lanes by a fixed butterfly, into part (one row of
// [dtw's | dtb's] per (row chunk, column tile, patch slot): c is linear in
// dPhi, so a column tile's share is summed alone).
// dt and valid come one row a lane (a row's slot of each group), loaded a
// stage ahead; valid becomes a warp ballot a group, so that every choice
// to skip is the warp's own: no cosine for an m-tile's 8 rows with no
// valid position there, no product for 8 rows with none, nothing for a
// stage with none (without kMasked, a row is valid where it lies in the
// chunk). W (the block's entries x 56 columns) is staged once. Each 32-row
// stage sums dW into fresh registers (the tensor cores' adds round toward
// zero) added on the CUDA cores; dPhi is 56 deep, one fresh sum. 8 warps
// of one m16 tile each (128 registers a thread, two blocks an SM) ran 21%
// faster than 4 warps of two (255 registers, one block); splitting dout
// once a stage for all warps gained 1.5% and was left out (PERF.md). The
// row chunks (the wrappers' plans, ops/_plan.py::best_plan) are summed by
// a second pass in a fixed order, and dtw, dtb by a third, one launch for
// both (weight_grad.cuh's strided_sum): two runs give identical bits. No
// gradient for dt or valid.
//
// theta comes from phi.cuh (exact rounding of the argument); the cosines
// are cos_reduced.cuh's, cosf's bits, and -sin is -sinf's.
#pragma once

#include "cos_reduced.cuh"
#include "patch_gemm.cuh"
#include "phi.cuh"
#include "time_products.cuh"
#include "weight_grad.cuh"

namespace dyglib {
namespace time_bwd {

namespace pg = patch_gemm;

// grid (entry tiles, column tiles, row chunks)
// A warp owns one m16 tile of entries (16, two 8-entry groups) and all 56
// columns: 28 dW accumulators and their fresh stage sums a thread, and 16
// of dPhi, so that two blocks of 8 warps fit an SM's registers (128 a
// thread). The products are the Product policy's (time_products.cuh:
// SplitTf32, or Bf16 for the bf16 variant, whose dout tile and W are
// padded to 64 columns and whose dW step takes 16 rows).
constexpr int kGroups = 2;                 // 8-entry groups a warp
constexpr int kRows = pg::kTileK;          // rows a stage

template <int kWarps, class Product>
struct Block {
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kEntries = 16 * kWarps;  // padded K entries a block
  static constexpr int kStageFloats = kRows * Product::kDStride;
  // 65,536 bytes at 8 warps in split TF32, 73,728 in bf16
  static constexpr size_t kSmemBytes =
      sizeof(float) * (kEntries * Product::kWStride + pg::kStages * kStageFloats);
};

struct Args {
  const float* dt;     // (rows * patch)
  const bool* valid;   // (rows * patch); unread without kMasked
  const float* tw;     // (dt_dim)
  const float* tb;     // (dt_dim)
  const float* w;      // (patch * dt_dim, ced) at w[k * w_sk + c * w_sn]
  const float* dout;   // (rows, ced)
  float* dw_dst;       // dw_ext (K [+ 1], ced) with one chunk, else partial (chunks, K [+ 1], ced)
  float* part;         // (chunks * column tiles * patch, 2, dt_dim): dtw's sums, dtb's
  int rows, patch, dt_dim, dt_pad, ced, w_sk, w_sn;
  int chunk_rows;      // a multiple of kRows
};

// kDVec: floats per copy of dout (2 or 1). kMasked (the time channel):
// positions masked by valid, and dbias as dW_ext's row K (the first entry
// tile's blocks); without it (the Phi projection) neither.
template <int kDVec, bool kMasked, int kWarps, class Product>
__global__ void __launch_bounds__(Block<kWarps, Product>::kThreads, 2)
    time_bwd_kernel(const Args a) {
  using B = Block<kWarps, Product>;
  constexpr int kCols = Product::kCols, kDStride = Product::kDStride;
  constexpr int kWStride = Product::kWStride;
  static_assert(!kMasked || kWarps == 8, "dbias's row groups take 256 threads");
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);  // (B::kEntries, kWStride)
  float* ring = w_s + B::kEntries * kWStride;
  const int k_total = a.patch * a.dt_dim;
  const int kp_end = a.patch * a.dt_pad;
  const int e0 = blockIdx.x * B::kEntries, n0 = blockIdx.y * pg::kTileN;
  // columns past the tile's 56 (a padded tile) are staged as zeros; an
  // unpadded tile needs no bound of its own (and holds no register for it)
  const auto n_end = [&] { return kCols > pg::kTileN ? min(a.ced, n0 + pg::kTileN) : a.ced; };
  const int r_begin = blockIdx.z * a.chunk_rows;
  const int r_end = min(a.rows, r_begin + a.chunk_rows);
  const int tiles = (r_end - r_begin + kRows - 1) / kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;

  // W's rows of the block's entries, zero at the padding and past the
  // tile's 56 columns
  for (int i = threadIdx.x; i < B::kEntries * kCols; i += B::kThreads) {
    const int e = i % B::kEntries, c = i / B::kEntries;
    const int kp = e0 + e, j = kp / a.dt_pad, f = kp - j * a.dt_pad;
    const bool in = kp < kp_end && f < a.dt_dim && n0 + c < n_end();
    const size_t at =
        static_cast<size_t>(j * a.dt_dim + f) * a.w_sk + static_cast<size_t>(n0 + c) * a.w_sn;
    w_s[e * kWStride + c] = in ? a.w[at] : 0.f;
  }  // read after the pipeline's first barrier

  // this thread's entries, h = 0, 1 -> we + 8 h + g
  const int wl = 16 * warp;  // the warp's first entry in the block
  const int we = e0 + wl;
  int slot[kGroups];
  bool real[kGroups];
  float tw_e[kGroups], tb_e[kGroups];
#pragma unroll
  for (int i = 0; i < kGroups; ++i) {
    const int kp = we + 8 * i + g;
    slot[i] = (we + 8 * i) / a.dt_pad;  // the group's: dt_pad is a multiple of 8
    const int f = kp - slot[i] * a.dt_pad;
    real[i] = kp < kp_end && f < a.dt_dim;
    tw_e[i] = real[i] ? a.tw[f] : 0.f;
    tb_e[i] = real[i] ? a.tb[f] : 0.f;
  }

  // dt and valid of row r_begin + 32 tile + lane at each group's slot
  // (groups of one slot share one load); the next stage's loaded ahead
  float d_next[kGroups];
  bool v_next[kGroups];
  const auto fetch = [&](int tile) {
    const int r = r_begin + tile * kRows + lane;
#pragma unroll
    for (int i = 0; i < kGroups; ++i) {
      if (i > 0 && slot[i] == slot[i - 1]) {  // warp-uniform
        d_next[i] = d_next[i - 1], v_next[i] = v_next[i - 1];
        continue;
      }
      const bool in = tile < tiles && r < r_end && slot[i] < a.patch;
      const size_t idx = static_cast<size_t>(r) * a.patch + slot[i];
      v_next[i] = in && (!kMasked || a.valid[idx]);
      d_next[i] = in ? a.dt[idx] : 0.f;
    }
  };
  fetch(0);

  const auto load = [&](int tile, float* stage) {
    pg::stage_tile<B::kThreads, kRows, kCols, kDStride, kDVec>(
        stage, a.dout, a.ced, r_begin + tile * kRows, r_end, n0, n_end());
  };

  float acc[pg::kNFrag][4] = {};
  float s_tw[kGroups] = {}, s_tb[kGroups] = {};
  // dbias, in the first entry tile's blocks: thread (bq, bc) sums column
  // bc of the stages' rows 8 bq .. 8 bq + 7 (rows past the chunk are zero)
  const bool bias_block = kMasked && blockIdx.x == 0;
  const int bc = threadIdx.x % 64, bq = threadIdx.x / 64;
  float s_bias = 0.f;
  int tile = 0;
  const auto multiply = [&](const float* stage) {
    if (bias_block && bc < pg::kTileN)
#pragma unroll
      for (int i = 0; i < 8; ++i) s_bias += stage[(8 * bq + i) * kDStride + bc];
    unsigned vm[kGroups];
    float d_cur[kGroups];
#pragma unroll
    for (int i = 0; i < kGroups; ++i)
      vm[i] = __ballot_sync(0xffffffffu, v_next[i]), d_cur[i] = d_next[i];
    fetch(++tile);
    unsigned any = 0u;
#pragma unroll
    for (int i = 0; i < kGroups; ++i) any |= vm[i];
    if (any == 0u) return;  // Phi and c are zero on all 32 rows

    // dPhi (16 entries x 32 rows) = W dout^T, 8 rows a step nt, for the
    // steps with a valid position
    float dphi[4][4] = {};
    Product::dphi_product(dphi, w_s, stage, wl, any, g, t);

    // accumulator r of step nt holds (entry g + 8 (r / 2), row 8 nt + 2t +
    // r % 2): Phi there for dW, and dPhi's epilogue c = dPhi * -sin summed
    // per entry
    float part[pg::kNFrag][4] = {};
    float phi[4][4] = {};
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      // cosines and sines only for 8 rows with a valid position (a
      // warp-wide choice: any is a ballot)
      const bool live = ((any >> (8 * nt)) & 0xffu) != 0u;
      float x[4], cv[4] = {}, sv[4] = {}, d[4];
      bool v[4];
      if (live) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int h = r / 2, row = 8 * nt + 2 * t + r % 2;
          d[r] = __shfl_sync(0xffffffffu, d_cur[h], row);
          v[r] = real[h] && ((vm[h] >> row) & 1u);
          x[r] = theta_of(d[r], tw_e[h], tb_e[h]);
        }
        sincos_reduced<4>(x, cv, sv);
#pragma unroll
        for (int r = 0; r < 4; ++r) phi[nt][r] = v[r] ? cv[r] : 0.f;
      }
      Product::dw_step(part, phi, stage, nt, any, g, t);
      if (live) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float c = v[r] ? dphi[nt][r] * sv[r] : 0.f;
          s_tb[r / 2] += c;
          s_tw[r / 2] += c * d[r];
        }
      }
    }
#pragma unroll
    for (int nf = 0; nf < pg::kNFrag; ++nf)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nf][i] += part[nf][i];
  };
  pg::pipeline<B::kStageFloats>(ring, tiles, load, multiply);

  // dW_ext rows: (j, f) -> j * dt_dim + f, padding none; row K = dbias, its
  // four row groups added in a fixed order
  float* dst = a.dw_dst + static_cast<size_t>(blockIdx.z) * (k_total + kMasked) * a.ced;
  if (bias_block) {
    __syncthreads();  // every warp is done with the ring
    if (bc < pg::kTileN) ring[bq * pg::kTileN + bc] = s_bias;
    __syncthreads();
    const float* q = ring + bc;
    if (bq == 0 && bc < pg::kTileN && n0 + bc < a.ced)
      dst[static_cast<size_t>(k_total) * a.ced + n0 + bc] =
          (q[0] + q[pg::kTileN]) + (q[2 * pg::kTileN] + q[3 * pg::kTileN]);
  }
  // accumulator of fragment nf: (entry g + 8 h, columns nf * 8 + 2t + jj)
#pragma unroll
  for (int h = 0; h < kGroups; ++h) {
    if (!real[h]) continue;
    const int f = we + 8 * h + g - slot[h] * a.dt_pad;
    const int row = slot[h] * a.dt_dim + f;
#pragma unroll
    for (int nf = 0; nf < pg::kNFrag; ++nf)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int c = n0 + nf * 8 + 2 * t + jj;
        if (c < a.ced) dst[static_cast<size_t>(row) * a.ced + c] = acc[nf][2 * h + jj];
      }
  }
  // the quad's four lanes (t) hold one entry's sums over other rows: a
  // fixed butterfly, then lane t = 0 writes them
  const size_t part_row = static_cast<size_t>(blockIdx.z * gridDim.y + blockIdx.y) * a.patch;
#pragma unroll
  for (int i = 0; i < kGroups; ++i) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      s_tw[i] += __shfl_xor_sync(0xffffffffu, s_tw[i], off);
      s_tb[i] += __shfl_xor_sync(0xffffffffu, s_tb[i], off);
    }
    if (t == 0 && real[i]) {
      float* part = a.part + (part_row + slot[i]) * 2 * a.dt_dim;
      const int f = we + 8 * i + g - slot[i] * a.dt_pad;
      part[f] = s_tw[i];
      part[a.dt_dim + f] = s_tb[i];
    }
  }
}

// One launch of the kernel. Above 48 KB of shared memory it opts in once,
// at its first launch (outside any CUDA-graph capture that replays it
// later).
template <int kDVec, bool kMasked, int kWarps, class Product>
cudaError_t launch_kernel(dim3 grid, const Args& args, cudaStream_t stream) {
  using B = Block<kWarps, Product>;
  static const cudaError_t opt_in =
      cudaFuncSetAttribute(time_bwd_kernel<kDVec, kMasked, kWarps, Product>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(B::kSmemBytes));
  if (opt_in != cudaSuccess) return opt_in;
  time_bwd_kernel<kDVec, kMasked, kWarps, Product>
      <<<grid, B::kThreads, B::kSmemBytes, stream>>>(args);
  return cudaGetLastError();
}

// The whole backward: the kernel, then the row chunks' dW partial sums
// (partial: (chunks, K [+ 1 with kMasked], ced), with more than one chunk) added in a
// fixed order into dw_ext, and part's rows into dt_grads (2, dt_dim): dtw,
// then dtb. a.dw_dst and a.part are set here from dw_ext and part. d_vec:
// floats per copy of dout (2 or 1, the wrapper's alignment check). With no
// rows every gradient is zero.
template <bool kMasked, int kWarps, class Product = time_products::SplitTf32>
cudaError_t backward(Args a, float* dw_ext, float* dt_grads, float* partial, float* part,
                     int d_vec, cudaStream_t stream) {
  if (a.ced == 0) return cudaSuccess;
  const int k_total = a.patch * a.dt_dim;
  const size_t dw_floats = static_cast<size_t>(k_total + kMasked) * a.ced;
  cudaError_t err;
  if (a.rows == 0) {
    err = cudaMemsetAsync(dw_ext, 0, sizeof(float) * dw_floats, stream);
    if (err == cudaSuccess)
      err = cudaMemsetAsync(dt_grads, 0, sizeof(float) * 2 * a.dt_dim, stream);
    return err;
  }
  if (a.dt_dim < 1 || a.dt_pad < a.dt_dim || a.dt_pad % 8 != 0 || a.chunk_rows <= 0 ||
      a.chunk_rows % kRows != 0)
    return cudaErrorInvalidValue;
  const int chunks = (a.rows + a.chunk_rows - 1) / a.chunk_rows;
  const int col_tiles = (a.ced + pg::kTileN - 1) / pg::kTileN;
  a.dw_dst = chunks == 1 ? dw_ext : partial;
  a.part = part;
  const int entries = Block<kWarps, Product>::kEntries;
  const dim3 grid((a.patch * a.dt_pad + entries - 1) / entries, col_tiles, chunks);
  err = d_vec >= 2 ? launch_kernel<2, kMasked, kWarps, Product>(grid, a, stream)
                   : launch_kernel<1, kMasked, kWarps, Product>(grid, a, stream);
  if (err != cudaSuccess) return err;
  if (chunks > 1) {
    err = chunks <= pg::kMaxElementwisePartials
              ? pg::launch_sum_partials(partial, nullptr, dw_ext, chunks, dw_floats, a.ced, stream)
              : launch_strided_sum(partial, dw_ext, chunks, static_cast<int>(dw_floats), stream);
    if (err != cudaSuccess) return err;
  }
  // part (chunks * column tiles * patch, 2, dt_dim) summed over its first axis
  return launch_strided_sum(part, dt_grads, chunks * col_tiles * a.patch, 2 * a.dt_dim, stream);
}

}  // namespace time_bwd
}  // namespace dyglib
