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
// The bf16 variants (a model built with compute_dtype bfloat16; the
// time_channel_bf16_* entry points) keep the JAX kernels' math instead:
// Phi, W and dout rounded to bf16, f32 sums and f32 outputs, each patch
// slot's Dt padded to a multiple of 16 in the forward.
//   * The backward is a kernel of its own on wgmma
//     (time_channel_bf16_bwd.cuh): 128 entries of K a block on the M side
//     of both products, dPhi^T = W dout^T from shared memory, whose
//     accumulators are the register A fragment of dW = Phi^T dout (Phi and
//     -sin from one theta), and one bf16 dout tile, converted by a
//     producer warp, read K-major by the first product and MN-major by
//     the second.
//   * The forward is its own kernel on Hopper's asynchronous units
//     (wgmma.cuh). W is converted to bf16 once a launch
//     (wgmma::pack_weight: W^T, each slot's features padded with zeros),
//     and one producer warp streams its (56 x 64) boxes by TMA into a
//     4-stage ring. Where a split's W is two stages at most (wikipedia's
//     112 padded K), the kResident instantiation has each block convert
//     its boxes into the ring before it starts instead: no second launch
//     and no scratch, where the forward is launch-bound. Two consumer
//     warpgroups, 64 rows each, compute Phi in
//     registers, straight into wgmma's A-fragment layout (the elements
//     each thread's A registers hold, with the same theta, cosine, mask
//     and bf16 rounding as before), and multiply with wgmma m64n56k16, A
//     from registers: the cosines of the next k16 step are computed while
//     the current step's wgmma runs (commit, then wait_group 1 before its
//     fragment is rewritten), so the product no longer takes turns with
//     the trigonometry. The products accumulate on the tensor cores through
//     a split (92 k16 steps at CanParl; their adds round toward zero: at
//     most 92 f32 ulps of the running sum, ~1e-5 of sum|terms|, where the
//     card shows ~1e-7); the K split (ops/time_channel.py::
//     wgmma_forward_plan) and its fixed-order second pass keep two runs
//     bitwise equal. A warp whose 16 rows have no valid position in a slot
//     computes no cosine there; a slot's last step skips the cosines of its
//     upper 8 features where they are padding for every lane; a warp takes
//     cosf's fast path without testing each argument (cos_reduced's votes)
//     where a bound on its valid arguments allows it.
// Bounds at CanParl (rows 19,200, K = 6400, ced 50) in bf16: the forward's
// 12.3 G operations take 0.012 ms at 989 T/s and its 98 M cosines 0.023 ms
// at the SFU's rate (bound by the cosines; the cosine here is not the
// SFU's but cos_reduced's instructions on the CUDA cores, PERF.md states
// that floor too); the backward's 24.6 G operations 0.025 ms and its
// (cosine, sine) pairs 0.047 ms.
//
// theta comes from phi.cuh (exact rounding of the argument); the forward's
// cosines are cos_reduced.cuh's, cosf's bits.
#include "cos_reduced.cuh"
#include "patch_gemm.cuh"
#include "phi.cuh"
#include "time_channel_bf16_bwd.cuh"
#include "time_channel_bwd.cuh"
#include "time_products.cuh"
#include "wgmma.cuh"

namespace pg = dyglib::patch_gemm;
namespace tp = dyglib::time_products;
namespace wg = dyglib::wgmma;

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
template <class Product>
__global__ void __launch_bounds__(kFwdThreads) time_channel_fwd_kernel(const ForwardArgs a) {
  constexpr int kF = Product::kFeatures;
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
  // The k-step walks (slot, f0) forward kStep features at a time: kp_begin
  // is a multiple of 32 and dt_pad of kStep, so no step straddles two slots.
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
    for (int kk = 0; kk < pg::kTileK; kk += Product::kStep) {
      // past kp_end (a last, partial stage) Phi is 0 and W was staged 0
      const bool live = kp + kk < kp_end;
      float tw_c[kF], tb_c[kF];
      bool f_in[kF];
#pragma unroll
      for (int c = 0; c < kF; ++c) {
        const int f = f0 + Product::feature(t, c);
        tw_c[c] = tw_s[f], tb_c[c] = tb_s[f], f_in[c] = live && f < a.dt_dim;
      }
      // theta of the A fragment's elements, (mt, h, c) at (2 mt + h) kF +
      // c; cosines only for an m-tile in which some lane has a valid row
      // (a warp-wide choice: see cos_reduced)
      constexpr int kE = 4 * kF;
      float theta[kE], cv[kE] = {};
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const int mt = e / (2 * kF), h = (e / kF) % 2, c = e % kF;
        theta[e] = dyglib::theta_of(dt_r[mt][h], tw_c[c], tb_c[c]);
      }
      bool need[2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        need[mt] = live && __any_sync(0xffffffffu, valid_r[mt][0] || valid_r[mt][1]);
      if (need[0] && need[1]) {
        dyglib::cos_reduced<kE>(theta, cv);
      } else {
        if (need[0]) dyglib::cos_reduced<kE / 2>(theta, cv);
        if (need[1]) dyglib::cos_reduced<kE / 2>(theta + kE / 2, cv + kE / 2);
      }
      float phi[2][2][kF];
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const int mt = e / (2 * kF), h = (e / kF) % 2, c = e % kF;
        phi[mt][h][c] = valid_r[mt][h] && f_in[c] ? cv[e] : 0.f;
      }
      Product::forward_step(part, phi, stage, kk, g, t);
      f0 += Product::kStep;
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

template <class Product>
cudaError_t forward(const ForwardArgs& args, float* out, float* partial, int splits,
                    cudaStream_t stream) {
  const size_t smem = sizeof(float) * (pg::kStages * kStageFloats + 2 * args.dt_pad);
  cudaError_t err;
  if (smem > 48 * 1024) {  // past the default: opt in (Dt above 2112)
    err = cudaFuncSetAttribute(time_channel_fwd_kernel<Product>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((args.rows + kFwdTileM - 1) / kFwdTileM,
                  (args.ced + pg::kTileN - 1) / pg::kTileN, splits);
  time_channel_fwd_kernel<Product><<<grid, kFwdThreads, smem, stream>>>(args);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return pg::launch_sum_partials(partial, args.bias, out, splits,
                                 static_cast<size_t>(args.rows) * args.ced, args.ced, stream);
}

template <class Product>
int forward_entry(const float* dt, const bool* valid, const float* tw, const float* tb,
                  const float* w, int w_sk, int w_sn, const float* bias, float* out,
                  float* partial, int rows, int patch, int dt_dim, int dt_pad, int ced,
                  int k_chunk, cudaStream_t stream) {
  if (rows == 0 || ced == 0) return 0;
  if (dt_pad < dt_dim || dt_pad % Product::kStep != 0 || k_chunk <= 0 ||
      k_chunk % pg::kTileK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int splits = (patch * dt_pad + k_chunk - 1) / k_chunk;
  const ForwardArgs args{dt, valid, tw, tb, w, bias, splits == 1 ? out : partial, rows, patch,
                         dt_dim, dt_pad, ced, w_sk, w_sn, k_chunk};
  return static_cast<int>(forward<Product>(args, out, partial, splits, stream));
}

// ---- the bf16 forward on wgmma: grid (row tiles of 128, column tiles, K splits)

constexpr int kBfStages = 4;
constexpr int kBfConsumers = 256;              // two warpgroups of 64 rows
constexpr int kBfThreads = kBfConsumers + 32;  // and one producer warp
constexpr int kBfTileM = 128;
constexpr int kBfRingBytes = kBfStages * wg::kWStageBytes;
constexpr int kBfStep = wg::kStep;  // patch slots padded to a multiple of it
constexpr int kBfSteps = wg::kStageK / kBfStep;  // k16 steps a stage
// the kResident kernel: a split's W is this many stages at most, which the
// block's threads convert, this many pairs (of bf16 values) each
constexpr int kBfResidentStages = 2;
constexpr int kBfResidentPairs =
    (kBfResidentStages * wg::kTileN + kBfThreads / 32 - 1) / (kBfThreads / 32);

// the ring (1024-byte aligned), a full and an empty barrier a stage, then
// tw and tb padded to dt_pad with zeros, then each k16 step's largest |tw|
// and |tb|
inline size_t bf16_forward_smem(int dt_pad) {
  return 1024 + kBfRingBytes + 2 * kBfStages * sizeof(uint64_t) +
         2 * sizeof(float) * (dt_pad + dt_pad / kBfStep);
}

struct Bf16ForwardArgs {
  CUtensorMap w_map;   // packed W^T (col tiles * 56, kp_pad) bf16: boxes of 64 x 56
                       // (kResident: unused)
  const float* w;      // (patch * dt_dim, ced) f32 at w[k * w_sk + n * w_sn]
  int w_sk, w_sn;
  const float* dt;     // (rows * patch)
  const bool* valid;   // (rows * patch)
  const float* tw;     // (dt_dim)
  const float* tb;     // (dt_dim)
  const float* bias;   // (ced)
  float* dst;          // out (rows, ced) with one split, else partial (splits, rows, ced)
  int rows, patch, dt_dim, dt_pad, ced;
  int k_chunk;         // padded K (patch * dt_pad) per split, a multiple of 64
};

template <bool kResident>
__global__ void __launch_bounds__(kBfThreads, 2)
    time_channel_bf16_fwd_kernel(const __grid_constant__ Bf16ForwardArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kBfRingBytes);
  uint64_t* empty = full + kBfStages;
  float* tw_s = reinterpret_cast<float*>(empty + kBfStages);
  float* tb_s = tw_s + a.dt_pad;
  float* tw_max = tb_s + a.dt_pad;  // per k16 step of a slot: max |tw| and |tb|
  float* tb_max = tw_max + a.dt_pad / kBfStep;
  for (int f = threadIdx.x; f < a.dt_pad; f += kBfThreads) {
    tw_s[f] = f < a.dt_dim ? a.tw[f] : 0.f;
    tb_s[f] = f < a.dt_dim ? a.tb[f] : 0.f;
  }
  for (int k = threadIdx.x; k < a.dt_pad / kBfStep; k += kBfThreads) {
    float mw = 0.f, mb = 0.f;
    for (int f = k * kBfStep; f < min(a.dt_dim, (k + 1) * kBfStep); ++f)
      mw = fmaxf(mw, fabsf(a.tw[f])), mb = fmaxf(mb, fabsf(a.tb[f]));
    tw_max[k] = mw, tb_max[k] = mb;
  }
  const int m0 = blockIdx.x * kBfTileM, n0 = blockIdx.y * wg::kTileN;
  const int kp_begin = blockIdx.z * a.k_chunk;
  const int kp_end = min(a.patch * a.dt_pad, kp_begin + a.k_chunk);
  const int tiles = (kp_end - kp_begin + wg::kStageK - 1) / wg::kStageK;
  if constexpr (kResident) {
    unsigned pairs[kBfResidentPairs];
    wg::load_packed_pairs<kBfThreads, kBfResidentStages>(pairs, tiles, a.w, a.w_sk, a.w_sn,
                                                         a.ced, a.patch * a.dt_dim, a.dt_dim,
                                                         a.dt_pad, n0, kp_begin);
    wg::store_packed_pairs<kBfThreads>(pairs, tiles, ring, wg::kWStageBytes);
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kBfStages; ++s) {
      wg::bar_init(full + s, 1);
      wg::bar_init(empty + s, kBfConsumers / 32);
    }
    wg::bar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kBfConsumers) {  // the producer warp: one lane starts every copy
    if (!kResident && threadIdx.x == kBfConsumers) {
      for (int t = 0; t < tiles; ++t) {
        const int s = t % kBfStages;
        if (t >= kBfStages) wg::bar_wait(empty + s, (t / kBfStages - 1) & 1);
        wg::bar_expect_tx(full + s, wg::kWBoxBytes);
        wg::tma_load(a.w_map, ring + s * wg::kWStageBytes, full + s,
                     kp_begin + t * wg::kStageK, n0);
      }
    }
    return;
  }

  // a consumer thread's rows: row0 and row0 + 8 of its warpgroup's 64
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int group_row = m0 + 64 * (threadIdx.x / 128);
  const int row0 = group_row + 16 * ((threadIdx.x / 32) % 4) + g;

  // dt and valid of this thread's rows at the current slot, and the next
  // slot's, loaded a slot ahead
  const auto load_slot = [&](int j, float (&d)[2], bool (&v)[2]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 8 * h;
      const bool in = r < a.rows && j < a.patch;
      const size_t idx = static_cast<size_t>(r) * a.patch + j;
      v[h] = in && a.valid[idx];
      d[h] = in ? a.dt[idx] : 0.f;
    }
  };
  // the next k16 step to compute: `left` steps of the split remain, at
  // feature f0 of patch slot `slot` (kp_begin and dt_pad are multiples of
  // 16, so no step straddles two slots)
  int slot = kp_begin / a.dt_pad;
  int f0 = kp_begin - slot * a.dt_pad;
  int left = (kp_end - kp_begin) / kBfStep;
  float dt_r[2], dt_next[2];
  bool valid_r[2], valid_next[2];
  // per slot, for the warp: whether any of its 16 rows is valid, the
  // largest valid |dt|, and each A register's mask of rows (half words)
  bool any_valid;
  float dt_max;
  unsigned row_mask[2];
  const auto enter_slot = [&] {
    any_valid = __any_sync(0xffffffffu, valid_r[0] || valid_r[1]);
    float m = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m = fmaxf(m, valid_r[h] ? fabsf(dt_r[h]) : 0.f);
      row_mask[h] = valid_r[h] ? 0xffffffffu : 0u;
    }
    dt_max = __uint_as_float(__reduce_max_sync(0xffffffffu, __float_as_uint(m)));
  };
  load_slot(slot, dt_r, valid_r);
  load_slot(slot + 1, dt_next, valid_next);
  enter_slot();

  // Phi of the next k16 step in the A fragment: register i holds row h = i
  // % 2 at features (2t, 2t + 1) + 8 (i / 2) of the step, packed to bf16;
  // zero past the split's end, at padded features and masked positions.
  // Element e = 4 p + 2 h + q is row h at feature f0 + 2t + q + 8 p.
  const auto phi = [&](unsigned (&frag)[4]) {
    if (left == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) frag[i] = 0u;
      return;
    }
    const float2 tw_p[2] = {*reinterpret_cast<const float2*>(tw_s + f0 + 2 * t4),
                            *reinterpret_cast<const float2*>(tw_s + f0 + 2 * t4 + 8)};
    const float2 tb_p[2] = {*reinterpret_cast<const float2*>(tb_s + f0 + 2 * t4),
                            *reinterpret_cast<const float2*>(tb_s + f0 + 2 * t4 + 8)};
    // the step's upper 8 features are padding for every lane (a slot's
    // last step when Dt % 16 <= 8): their cosines are skipped
    const bool upper = f0 + 8 < a.dt_dim;
    float theta[8], cv[8] = {};
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int p = e / 4, h = (e / 2) % 2, q = e % 2;
      theta[e] = dyglib::theta_of(dt_r[h], q ? tw_p[p].y : tw_p[p].x,
                                  q ? tb_p[p].y : tb_p[p].x);
    }
    if (any_valid) {
      // cosf's fast path for the whole warp where a bound on its valid
      // arguments allows it: every valid |theta| is within a few f32
      // roundings of |dt| |tw| + |tb| (the warp's largest valid |dt|, the
      // step's largest |tw| and |tb|), so a rounded bound of at most 105000
      // keeps it below cos_small's limit of 105615 (masked elements are
      // discarded); else cos_reduced's exact test of each argument
      const int k = f0 / kBfStep;
      if (__fadd_rn(__fmul_rn(dt_max, tw_max[k]), tb_max[k]) <= 105000.f) {
#pragma unroll
        for (int e = 0; e < 4; ++e) cv[e] = dyglib::cos_small(theta[e]);
        if (upper) {
#pragma unroll
          for (int e = 4; e < 8; ++e) cv[e] = dyglib::cos_small(theta[e]);
        }
      } else if (upper) {
        dyglib::cos_reduced<8>(theta, cv);
      } else {
        dyglib::cos_reduced<4>(theta, cv);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int h = i % 2, p = i / 2;
      const int f = f0 + 2 * t4 + 8 * p;  // its features f, f + 1
      const unsigned cols = f + 1 < a.dt_dim ? 0xffffffffu : f < a.dt_dim ? 0xffffu : 0u;
      frag[i] = dyglib::bf16::pack(cv[4 * p + 2 * h], cv[4 * p + 2 * h + 1]) & cols &
                row_mask[h];
    }
    --left;
    f0 += kBfStep;
    if (f0 == a.dt_pad) {  // the next slot: its rows were loaded ahead
      f0 = 0, ++slot;
#pragma unroll
      for (int h = 0; h < 2; ++h) dt_r[h] = dt_next[h], valid_r[h] = valid_next[h];
      load_slot(slot + 1, dt_next, valid_next);
      enter_slot();
    }
  };

  // Step by step: a step's wgmma runs while the next step's Phi is
  // computed (wait_group 1 before a fragment is rewritten); a stage's W box
  // is released once the wait has seen its last product done (kResident:
  // the ring is full from the start). No other
  // instruction writes the accumulators until the last wait (the first
  // product starts them from zero): ptxas would serialise the wgmmas
  // otherwise.
  float acc[wg::kAcc];
  unsigned frag0[4], frag1[4];
  phi(frag0);
  for (int t = 0; t < tiles; ++t) {
    const int s = t % kBfStages;
    if (!kResident) wg::bar_wait(full + s, (t / kBfStages) & 1);
    const uint64_t b = wg::desc_sw128(ring + s * wg::kWStageBytes);
#pragma unroll
    for (int i = 0; i < kBfSteps; i += 2) {
      wg::fence();
      wg::mma_rs(acc, frag0, b + 2 * i, t > 0 || i > 0);
      wg::commit();
      wg::wait<1>();
      if (i == 0 && t > 0 && lane == 0) wg::bar_arrive(empty + (t - 1) % kBfStages);
      phi(frag1);
      wg::fence();
      wg::mma_rs(acc, frag1, b + 2 * (i + 1), 1);
      wg::commit();
      wg::wait<1>();
      phi(frag0);
    }
  }
  wg::wait<0>();
  wg::hold(acc);

  // one split: the output itself, bias added here; else this split's partial
  const bool one = gridDim.z == 1;
  float* dst = a.dst + static_cast<size_t>(blockIdx.z) * a.rows * a.ced;
  wg::store(acc, group_row, a.rows, n0, a.ced, a.ced,
            [&](size_t i, int c, float v) { dst[i] = one ? v + a.bias[c] : v; });
}

}  // namespace

// dt: (rows * patch) f32; valid: (rows * patch) bool; tw, tb: (dt_dim) f32;
// w: (patch * dt_dim, ced) f32 with element strides (w_sk, w_sn); bias: (ced)
// f32; out: (rows, ced) f32. dt_pad: dt_dim rounded up to a multiple of 8.
// k_chunk: padded K (patch * dt_pad) per split,
// a multiple of 32; with more than one split, partial holds (splits, rows,
// ced) f32.
DYGLIB_API int time_channel_forward(const float* dt, const bool* valid, const float* tw,
                                    const float* tb, const float* w, int w_sk, int w_sn,
                                    const float* bias, float* out, float* partial, int rows,
                                    int patch, int dt_dim, int dt_pad, int ced, int k_chunk,
                                    cudaStream_t stream) {
  return forward_entry<tp::SplitTf32>(dt, valid, tw, tb, w, w_sk, w_sn, bias, out, partial,
                                      rows, patch, dt_dim, dt_pad, ced, k_chunk, stream);
}

// The bf16 forward (#1'): the arguments of time_channel_forward with
// dt_pad a multiple of 16 and k_chunk a multiple of 64, and w16: scratch
// for the packed W^T, (ceil(ced / 56) * 56, kp_pad) bf16, kp_pad = patch *
// dt_pad rounded up to a multiple of 64 (in 16-byte aligned memory); null
// where k_chunk is at most 128 (the blocks convert W themselves).
DYGLIB_API int time_channel_bf16_forward(const float* dt, const bool* valid, const float* tw,
                                         const float* tb, const float* w, int w_sk, int w_sn,
                                         const float* bias, float* out, float* partial,
                                         unsigned short* w16, int rows, int patch, int dt_dim,
                                         int dt_pad, int ced, int k_chunk, cudaStream_t stream) {
  if (rows == 0 || ced == 0) return 0;
  if (dt_pad < dt_dim || dt_pad % kBfStep != 0 || k_chunk <= 0 || k_chunk % wg::kStageK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int kp_total = patch * dt_pad;
  const int col_tiles = (ced + wg::kTileN - 1) / wg::kTileN;
  const int n_pad = col_tiles * wg::kTileN;
  const int kp_pad = (kp_total + wg::kStageK - 1) / wg::kStageK * wg::kStageK;
  const int splits = (kp_total + k_chunk - 1) / k_chunk;
  const bool resident = k_chunk <= kBfResidentStages * wg::kStageK;
  Bf16ForwardArgs args{};
  cudaError_t err = cudaSuccess;
  if (!resident) {
    if (w16 == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    err = wg::pack_weight(w, w_sk, w_sn, ced, patch * dt_dim, dt_dim, dt_pad, w16, n_pad, kp_pad,
                          stream);
    if (err == cudaSuccess)
      err = wg::encode_map(&args.w_map, w16, kp_pad, n_pad, 2ull * kp_pad, wg::kTileN);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  args.w = w, args.w_sk = w_sk, args.w_sn = w_sn;
  args.dt = dt, args.valid = valid, args.tw = tw, args.tb = tb, args.bias = bias;
  args.dst = splits == 1 ? out : partial;
  args.rows = rows, args.patch = patch, args.dt_dim = dt_dim, args.dt_pad = dt_pad;
  args.ced = ced, args.k_chunk = k_chunk;
  const size_t smem = bf16_forward_smem(dt_pad);
  const auto kernel =
      resident ? time_channel_bf16_fwd_kernel<true> : time_channel_bf16_fwd_kernel<false>;
  if (smem > 48 * 1024) {  // past the default: opt in (Dt above 1792)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((rows + kBfTileM - 1) / kBfTileM, col_tiles, splits);
  kernel<<<grid, kBfThreads, smem, stream>>>(args);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return static_cast<int>(pg::launch_sum_partials(partial, bias, out, splits,
                                                  static_cast<size_t>(rows) * ced, ced, stream));
}

// As the forward, plus dout: (rows, ced) f32. dt_pad: dt_dim rounded up to
// a multiple of 8. Outputs: dw_ext (patch * dt_dim + 1, ced) f32 (rows
// 0..K-1 = dW, row K = dbias); dt_grads (2, dt_dim) f32: dtw, then dtb.
// chunk_rows: rows per partial sum, a multiple of 32; with more than one
// chunk, partial holds (chunks, K + 1, ced) f32. part: (chunks * ceil(ced /
// 56) * patch, 2, dt_dim) f32. d_vec: floats per copy of dout (2 or 1, the
// wrapper's alignment check).
DYGLIB_API int time_channel_backward(const float* dt, const bool* valid, const float* tw,
                                     const float* tb, const float* w, int w_sk, int w_sn,
                                     const float* dout, float* dw_ext, float* dt_grads,
                                     float* partial, float* part, int rows, int patch, int dt_dim,
                                     int dt_pad, int ced, int chunk_rows, int d_vec,
                                     cudaStream_t stream) {
  const dyglib::time_bwd::Args args{dt,   valid, tw,     tb,     w,   dout, nullptr, nullptr,
                                    rows, patch, dt_dim, dt_pad, ced, w_sk, w_sn, chunk_rows};
  return static_cast<int>(dyglib::time_bwd::backward<true, 8>(args, dw_ext, dt_grads, partial,
                                                              part, d_vec, stream));
}

// The bf16 backward (#1b', time_channel_bf16_bwd.cuh): the arguments of
// time_channel_backward, with dt_pad the kernel's entry layout (each patch
// slot's Dt features dt_pad apart: dt_dim itself, or dt_dim padded where
// 128 entries would span more than 8 slots), chunk_rows a multiple of 64,
// and part (chunks * ceil(ced / 64) * patch, 2, dt_dim) f32.
DYGLIB_API int time_channel_bf16_backward(const float* dt, const bool* valid, const float* tw,
                                          const float* tb, const float* w, int w_sk, int w_sn,
                                          const float* dout, float* dw_ext, float* dt_grads,
                                          float* partial, float* part, int rows, int patch,
                                          int dt_dim, int dt_pad, int ced, int chunk_rows,
                                          int d_vec, cudaStream_t stream) {
  const dyglib::time_bwd_bf16::Args args{dt,     valid,  tw,  tb,   w,    dout,      nullptr,
                                         nullptr, rows,  patch, dt_dim, dt_pad, ced, w_sk,
                                         w_sn,   chunk_rows};
  return static_cast<int>(
      dyglib::time_bwd_bf16::backward(args, dw_ext, dt_grads, partial, part, d_vec, stream));
}
