// DyGFormer's fused time channel:
//   out[r, :] = bias + sum_j sum_f Phi(r, j, f) * W[j * Dt + f, :]
//   Phi(r, j, f) = valid[r * patch + j] ? cos(theta) : 0
//   theta = dt[r * patch + j] * tw[f] + tb[f]
// for patch rows r = (m, p) of dt/valid (M, L), L = P * patch.
//
// Forward: replaces dyglib_tpu/ops/pallas/time_channel.py::_fwd_kernel.
// Walks the patch slots j as the TPU kernel does, each slot's Dt features
// padded to dt_pad (a multiple of 8, the mma k-step), so that no k-step
// straddles two slots and a row's dt and valid are one load a slot. On
// the tensor cores, in split TF32 as the patch projection (patch_gemm.cuh):
// every operand v = hi + lo, three mma.sync passes lo*hi, hi*lo, hi*hi,
// each 32-deep stage summed into fresh registers and added to the running
// sum on the CUDA cores. Phi never leaves registers: each thread computes
// the elements of Phi that its A fragment holds (4 rows x 2 features a
// k-step) with cos_reduced.cuh's cosine, splits them and multiplies; W
// streams through a 4-stage cp.async ring, staged [column][padded k],
// zero at the padding. One block owns 128 rows and 56 columns (ced 50 in
// one column tile: each cosine computed once a launch); K may be split
// (the wrapper's plan) into partial sums added in a fixed order by a
// second pass, so two runs give identical bits.
// Masking: a warp takes the cosines of an m-tile (16 rows x 8 features a
// k-step) only where one of its rows is valid there, and zeroes the
// masked elements after: a branch per element, even one that computes
// nothing, cost more than the cosines it skips (PERF.md §6).
//
// Backward: replaces ::_bwd_kernel. Given dout (rows, ced): dW = Phi^T @
// dout, dbias = sum_r dout[r], and through dPhi = dout @ W^T and
// -sin(theta) at the valid positions, dtw and dtb; one split-TF32 kernel
// for both products, shared with the Phi projection's backward and
// described in time_channel_bwd.cuh (here with the mask and dbias).
//
// theta comes from phi.cuh (exact rounding of the argument); the forward's
// cosines are cos_reduced.cuh's, cosf's bits.
#include "cos_reduced.cuh"
#include "patch_gemm.cuh"
#include "phi.cuh"
#include "time_channel_bwd.cuh"

namespace pg = dyglib::patch_gemm;

namespace {

constexpr int kFwdWarps = 4;
constexpr int kFwdThreads = 32 * kFwdWarps;
constexpr int kFwdTileM = pg::kWarpM * kFwdWarps;         // 128 rows a block
constexpr int kStageFloats = pg::kTileN * pg::kFwdStride;  // W stage [column][k], 56 x 36
constexpr int kCopiesPerThread = pg::kTileN * pg::kTileK / kFwdThreads;
static_assert(kFwdThreads % pg::kTileK == 0 && kCopiesPerThread * kFwdThreads ==
              pg::kTileN * pg::kTileK, "a thread stages one k of every fourth column");

struct ForwardArgs {
  const float* dt;     // (rows * patch)
  const bool* valid;   // (rows * patch)
  const float* tw;     // (dt_dim)
  const float* tb;     // (dt_dim)
  const float* w;      // (patch * dt_dim, ced) at w[k * w_sk + c * w_sn]
  const float* bias;   // (ced)
  float* dst;          // out (rows, ced) with one split, else partial (splits, rows, ced)
  int rows, patch, dt_dim, dt_pad, ced, w_sk, w_sn;
  int k_chunk;         // padded K (patch * dt_pad) per split, a multiple of kTileK
};

// grid (row tiles, column tiles, K splits); dynamic shared memory: the
// ring, then tw and tb padded to dt_pad with zeros.
__global__ void __launch_bounds__(kFwdThreads) time_channel_fwd_kernel(const ForwardArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* tw_s = smem + pg::kStages * kStageFloats;
  float* tb_s = tw_s + a.dt_pad;
  for (int f = threadIdx.x; f < a.dt_pad; f += kFwdThreads) {
    tw_s[f] = f < a.dt_dim ? a.tw[f] : 0.f;
    tb_s[f] = f < a.dt_dim ? a.tb[f] : 0.f;
  }  // read after the pipeline's first barrier
  const int m0 = blockIdx.x * kFwdTileM, n0 = blockIdx.y * pg::kTileN;
  const int kp_begin = blockIdx.z * a.k_chunk;
  const int kp_end = min(a.patch * a.dt_pad, kp_begin + a.k_chunk);
  const int tiles = (kp_end - kp_begin + pg::kTileK - 1) / pg::kTileK;
  const int warp_m = (threadIdx.x / 32) * pg::kWarpM;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;

  // thread stages k = threadIdx % 32 of columns threadIdx / 32 + 4 i
  const int my_k = threadIdx.x % pg::kTileK, my_n = threadIdx.x / pg::kTileK;
  const auto load = [&](int tile, float* stage) {
    const int kp = kp_begin + tile * pg::kTileK + my_k;
    const int j = kp / a.dt_pad;
    const int f = kp - j * a.dt_pad;
    const bool k_in = kp < kp_end && f < a.dt_dim;
    const float* wk = a.w + static_cast<size_t>(j * a.dt_dim + f) * a.w_sk;
#pragma unroll
    for (int i = 0; i < kCopiesPerThread; ++i) {
      const int n = my_n + i * (kFwdThreads / pg::kTileK);
      const bool in = k_in && n0 + n < a.ced;
      const float* src = in ? wk + static_cast<size_t>(n0 + n) * a.w_sn : a.w;
      pg::copy_async<4>(stage + n * pg::kFwdStride + my_k, src, in ? 4 : 0);
    }
  };

  // This thread's four rows of A, (mt, h) -> m0 + warp_m + 16 mt + 8 h + g,
  // and their dt and valid at slot `slot` (the next slot's loaded ahead).
  // The k-step walks (slot, f0) forward 8 features at a time: kp_begin is
  // a multiple of 32 and dt_pad of 8, so no step straddles two slots.
  int slot = kp_begin / a.dt_pad;
  int f0 = kp_begin - slot * a.dt_pad;
  float dt_r[2][2], dt_next[2][2];
  bool valid_r[2][2], valid_next[2][2];
  const auto load_slot = [&](int j, float (&d)[2][2], bool (&v)[2][2]) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + warp_m + 16 * mt + 8 * h + g;
        const bool in = r < a.rows && j < a.patch;
        const size_t idx = static_cast<size_t>(r) * a.patch + j;
        v[mt][h] = in && a.valid[idx];
        d[mt][h] = in ? a.dt[idx] : 0.f;
      }
  };
  load_slot(slot, dt_r, valid_r);
  load_slot(slot + 1, dt_next, valid_next);

  int kp = kp_begin;
  float acc[2][pg::kNFrag][4] = {};
  const auto multiply = [&](const float* stage) {
    float part[2][pg::kNFrag][4] = {};
#pragma unroll
    for (int kk = 0; kk < pg::kTileK; kk += 8) {
      // past kp_end (a last, partial stage) Phi is 0 and W was staged 0
      const bool live = kp + kk < kp_end;
      float tw_c[2], tb_c[2];
      bool f_in[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int f = f0 + t + 4 * c;
        tw_c[c] = tw_s[f], tb_c[c] = tb_s[f], f_in[c] = live && f < a.dt_dim;
      }
      unsigned a_hi[2][4], a_lo[2][4], b_hi[pg::kNFrag][2], b_lo[pg::kNFrag][2];
      // theta of the A fragment's elements, (mt, i) at 4 mt + i: row h =
      // i % 2, feature c = i / 2; cosines only for an m-tile in which some
      // lane has a valid row (a warp-wide choice: see cos_reduced)
      float theta[8], cv[8] = {};
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int mt = e / 4, h = e % 2, c = (e % 4) / 2;
        theta[e] = dyglib::theta_of(dt_r[mt][h], tw_c[c], tb_c[c]);
      }
      bool need[2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        need[mt] = live && __any_sync(0xffffffffu, valid_r[mt][0] || valid_r[mt][1]);
      if (need[0] && need[1]) {
        dyglib::cos_reduced<8>(theta, cv);
      } else {
        if (need[0]) dyglib::cos_reduced<4>(theta, cv);
        if (need[1]) dyglib::cos_reduced<4>(theta + 4, cv + 4);
      }
      float phi[2][4];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int mt = e / 4, h = e % 2, c = (e % 4) / 2;
        phi[mt][e % 4] = valid_r[mt][h] && f_in[c] ? cv[e] : 0.f;
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const pg::Split s = pg::split_tf32(phi[mt][i]);
          a_hi[mt][i] = s.hi, a_lo[mt][i] = s.lo;
        }
#pragma unroll
      for (int nf = 0; nf < pg::kNFrag; ++nf)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const pg::Split s =
              pg::split_tf32(stage[(nf * 8 + g) * pg::kFwdStride + kk + t + 4 * i]);
          b_hi[nf][i] = s.hi, b_lo[nf][i] = s.lo;
        }
#pragma unroll
      for (int nf = 0; nf < pg::kNFrag; ++nf)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          pg::mma_tf32(part[mt][nf], a_lo[mt], b_hi[nf][0], b_hi[nf][1]);
#pragma unroll
      for (int nf = 0; nf < pg::kNFrag; ++nf)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          pg::mma_tf32(part[mt][nf], a_hi[mt], b_lo[nf][0], b_lo[nf][1]);
#pragma unroll
      for (int nf = 0; nf < pg::kNFrag; ++nf)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          pg::mma_tf32(part[mt][nf], a_hi[mt], b_hi[nf][0], b_hi[nf][1]);
      f0 += 8;
      if (f0 == a.dt_pad) {  // the next slot: its rows were loaded ahead
        f0 = 0, ++slot;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            dt_r[mt][h] = dt_next[mt][h];
            valid_r[mt][h] = valid_next[mt][h];
          }
        load_slot(slot + 1, dt_next, valid_next);
      }
    }
    kp += pg::kTileK;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nf = 0; nf < pg::kNFrag; ++nf)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nf][i] += part[mt][nf][i];
  };
  pg::pipeline<kStageFloats>(smem, tiles, load, multiply);

  // one split: the output itself, bias added here; else this split's partial
  float* dst = a.dst + static_cast<size_t>(blockIdx.z) * a.rows * a.ced;
  pg::store_tile(acc, dst, a.ced, m0 + warp_m, a.rows, n0, a.ced,
                 gridDim.z == 1 ? a.bias : nullptr);
}

}  // namespace

// dt: (rows * patch) f32; valid: (rows * patch) bool; tw, tb: (dt_dim) f32;
// w: (patch * dt_dim, ced) f32 with element strides (w_sk, w_sn); bias: (ced)
// f32; out: (rows, ced) f32. dt_pad: dt_dim rounded up to a multiple of 8.
// k_chunk: padded K (patch * dt_pad) per split, a multiple of 32; with
// more than one split, partial holds (splits, rows, ced) f32.
DYGLIB_API int time_channel_forward(const float* dt, const bool* valid, const float* tw,
                                    const float* tb, const float* w, int w_sk, int w_sn,
                                    const float* bias, float* out, float* partial, int rows,
                                    int patch, int dt_dim, int dt_pad, int ced, int k_chunk,
                                    cudaStream_t stream) {
  if (rows == 0 || ced == 0) return 0;
  if (dt_pad < dt_dim || dt_pad % 8 != 0 || k_chunk <= 0 || k_chunk % pg::kTileK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int splits = (patch * dt_pad + k_chunk - 1) / k_chunk;
  const ForwardArgs args{dt, valid, tw, tb, w, bias, splits == 1 ? out : partial, rows, patch,
                         dt_dim, dt_pad, ced, w_sk, w_sn, k_chunk};
  const size_t smem = sizeof(float) * (pg::kStages * kStageFloats + 2 * dt_pad);
  cudaError_t err;
  if (smem > 48 * 1024) {  // past the default: opt in (Dt above 2112)
    err = cudaFuncSetAttribute(time_channel_fwd_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((rows + kFwdTileM - 1) / kFwdTileM, (ced + pg::kTileN - 1) / pg::kTileN,
                  splits);
  time_channel_fwd_kernel<<<grid, kFwdThreads, smem, stream>>>(args);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return static_cast<int>(pg::launch_sum_partials(partial, bias, out, splits,
                                                  static_cast<size_t>(rows) * ced, ced, stream));
}

// As the forward, plus dout: (rows, ced) f32. Outputs: dw_ext
// (patch * dt_dim + 1, ced) f32 (rows 0..K-1 = dW, row K = dbias); dt_grads
// (2, dt_dim) f32: dtw, then dtb. chunk_rows: rows per partial sum, a
// multiple of 32; with more than one chunk, partial holds (chunks, K + 1,
// ced) f32. part: (chunks * ceil(ced / 56) * patch, 2, dt_dim) f32. d_vec:
// floats per copy of dout (2 or 1, the wrapper's alignment check).
DYGLIB_API int time_channel_backward(const float* dt, const bool* valid, const float* tw,
                                     const float* tb, const float* w, int w_sk, int w_sn,
                                     const float* dout, float* dw_ext, float* dt_grads,
                                     float* partial, float* part, int rows, int patch, int dt_dim,
                                     int dt_pad, int ced, int chunk_rows, int d_vec,
                                     cudaStream_t stream) {
  const dyglib::time_bwd::Args args{dt,   valid, tw,     tb,     w,   dout, nullptr, nullptr,
                                    rows, patch, dt_dim, dt_pad, ced, w_sk, w_sn, chunk_rows};
  return static_cast<int>(dyglib::time_bwd::backward<true, 8>(args, dw_ext, dt_grads,
                                                                   partial, part, d_vec, stream));
}
