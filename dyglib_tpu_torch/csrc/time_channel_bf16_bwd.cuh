// The bf16 backward of DyGFormer's time channel (#1b', a model built with
// compute_dtype bfloat16), on Hopper's wgmma. Replaces
// dyglib_tpu/ops/pallas/time_channel.py::_bwd_kernel, whose math it keeps:
// given dout (rows, ced) f32,
//   Phi = where(valid, cos theta), theta = dt * tw[f] + tb[f] (phi.cuh),
//   Phi, dout and W rounded to bf16 (to nearest even),
//   dW = Phi^T dout and dPhi = dout W^T, each summed in f32,
//   c = where(valid, dPhi * -sin theta), dtb[f] = sum c, dtw[f] = sum c * dt,
//   dbias = sum_r dout[r], summed in f32 from the f32 dout,
// with f32 outputs (time_channel.cu's time_channel_bf16_backward).
//
// Entries on the M side of both products, one dout tile for both:
//   * A block owns kEntries = 128 entries of K = patch x Dt (each patch
//     slot's Dt features at dt_pad apart: the wrapper lays them out
//     unpadded, dt_pad = Dt, where the block's slots stay few), one
//     64-column tile of dout, and a chunk of rows, which is the reduction.
//     Two consumer warpgroups own 64 entries each; a producer warpgroup
//     fills a 4-stage ring of 64-row stages.
//   * The producers convert each stage's dout rows from f32 into bf16 in
//     the 128-byte swizzle (64 rows x 128 bytes, TMA's layout; the f32 dout
//     is read once a block, mostly from L2, and no bf16 copy is written or
//     launched for), sum the f32 values into dbias (the first entry tile's
//     blocks), and stage dt and valid of the stage's rows at the block's
//     slots: dt (zero where not valid), a bit mask of valid rows and the
//     largest valid |dt| of each slot. Each producer thread starts all its
//     loads of a stage at once, a stage ahead, into registers.
//   * dPhi^T (64 entries x 64 rows) = W_tile (64 entries x 64 columns) x
//     dout_stage^T: wgmma m64n64k16, A and B from shared memory, both
//     K-major, four k16 steps over the columns into fresh accumulators.
//     W_tile is converted once by the block from the f32 W (either layout)
//     into a resident bf16 tile in the same swizzle.
//   * Those accumulators are, thread by thread, the (entry, row) pairs of
//     wgmma's register-A fragment for dW (d[8 s .. 8 s + 7] are the A
//     registers of k16 step s: wgmma.cuh's fragment layout), so one theta a
//     pair gives both -sin (for c, from the f32 dPhi) and cos (Phi, packed
//     to bf16 straight into A): one reduction by cos_reduced.cuh, nothing
//     staged.
//   * dW (64 entries x 64 columns) += Phi^T dout_stage: wgmma m64n64k16
//     with A from registers and B = the same shared-memory dout tile read
//     MN-major (imm-trans-b 1: row r of the stage is the k index, 16 rows
//     a step, 2048 bytes on). Each stage sums into fresh accumulators that
//     are added on the CUDA cores (the tensor cores' adds round toward
//     zero), while the next stage's dPhi product runs.
//   * c and c * dt are summed per entry over the thread's rows, then over
//     its quad by a fixed butterfly, into part (one row of [dtw's | dtb's]
//     per (row chunk, column tile, patch slot): c is linear in dPhi, so a
//     column tile's share is summed alone).
// Skips are whole-warpgroup or whole-warp: no product and no trigonometry
// for a stage with no valid position at the warpgroup's slots, no
// trigonometry for a warp's 16-row step with none at its entries' slots.
// A block takes cosf's fast path without testing each argument where a
// bound on its valid arguments allows it (|theta| <= |dt| |tw| + |tb| +
// roundings, with the stage's largest valid |dt| at the block's slots and
// the block's largest |tw| and |tb|), else the double reduction of
// cos_reduced.cuh for the arguments past 105615, and sincosf past 2^40.
// The choice is the block's, not each warp's: the warps whose entries hold
// the first features (tw near 1) need the double path in every stage, and
// a block waits for its slowest warp; with every warp on one path the SM's
// instruction slots are shared evenly (PERF.md).
// The row chunks (ops/time_channel.py::wgmma_backward_plan) are summed by a
// second pass in a fixed order, and dtw, dtb by a third (weight_grad.cuh's
// strided_sum): two runs give identical bits.
//
// Bounds at CanParl (rows 19,200, K = 6400, ced 50): the two products are
// 24.6 G operations, 0.025 ms at 989 T/s; the 98 M valid (cosine, sine)
// pairs 0.047 ms at the SFU's rate (here they are cos_reduced's
// instructions on the CUDA cores; PERF.md states that floor too); 13 MB,
// 4 us. The time goes to the CUDA cores' instructions per (entry, row)
// pair (scripts/time_bwd_split.py counts them).
#pragma once

#include <type_traits>

#include "cos_reduced.cuh"
#include "patch_gemm.cuh"
#include "phi.cuh"
#include "weight_grad.cuh"
#include "wgmma.cuh"

namespace dyglib {
namespace time_bwd_bf16 {

namespace wg = wgmma;

constexpr int kGroups = 2;                  // consumer warpgroups
constexpr int kEntries = 64 * kGroups;      // entries a block
constexpr int kConsumers = 128 * kGroups;
constexpr int kProducers = 128;             // and one producer warpgroup
constexpr int kThreads = kConsumers + kProducers;
constexpr int kCols = wg::kStageK;          // a column tile: one 128-byte bf16 row
constexpr int kRows = 64;                   // rows a stage
constexpr int kStages = 4;
constexpr int kMaxSlots = 8;                // patch slots a block's entries may span
constexpr int kAcc = wg::kAcc64;            // 64 x 64 f32 accumulators: 32 a thread
constexpr int kStageBytes = kRows * wg::kRowBytes;  // 8192
constexpr int kWBytes = 64 * wg::kRowBytes;         // a warpgroup's W tile
constexpr int kBand = kRows / (kProducers / 32);    // rows of a stage a producer warp converts
// the ring, the W tiles, each stage's dt (kMaxSlots x kRows floats), valid
// masks (two words a slot) and largest |dt| (one a slot), the producer
// warps' dbias sums, the block's largest |tw| and |tb|, the barriers
// (8-byte aligned: the sizes before them are multiples of 8); 1024 bytes
// of slack for the swizzle's alignment
constexpr size_t kSmemBytes = 1024 + kStages * kStageBytes + kGroups * kWBytes +
                              kStages * kMaxSlots * (4 * kRows + 8 + 4) +
                              4 * kProducers / 32 * kCols + 8 + 2 * kStages * 8;
static_assert(kStageBytes % 1024 == 0 && kWBytes % 1024 == 0, "swizzle-aligned tiles");

// The patch slots that kEntries entries at dt_pad apart may span
inline int slots_bound(int dt_pad) {
  return kEntries % dt_pad == 0 ? kEntries / dt_pad : (kEntries - 1) / dt_pad + 2;
}

struct Args {
  const float* dt;     // (rows * patch)
  const bool* valid;   // (rows * patch)
  const float* tw;     // (dt_dim)
  const float* tb;     // (dt_dim)
  const float* w;      // (patch * dt_dim, ced) at w[k * w_sk + c * w_sn]
  const float* dout;   // (rows, ced)
  float* dw_dst;       // dw_ext (K + 1, ced) with one chunk, else partial (chunks, K + 1, ced)
  float* part;         // (chunks * column tiles * patch, 2, dt_dim): dtw's sums, dtb's
  int rows, patch, dt_dim, dt_pad, ced, w_sk, w_sn;
  int chunk_rows;      // a multiple of kRows
};

// cos and -sin of a thread's 8 pairs of one k16 step, cos_reduced.cuh's
// bits (cosf's and -sinf's): each argument reduced as cosf's fast path
// reduces it; where the block's bound does not allow that path for all
// (!kFast), the double reduction for the arguments past 105615; both
// polynomials once (sincos_quadrants); and for arguments past 2^40, inf
// or nan (where any lane has one), sincosf, in a loop of its own over a
// copy, so that the arguments stay in registers.
template <bool kFast>
__device__ __forceinline__ void sincos_pairs(const float (&x)[8], float (&cv)[8],
                                             float (&ms)[8]) {
  float r[8];
  int q[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) reduce_small(x[i], r[i], q[i]);
  bool huge = false;
  if constexpr (!kFast) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float rl;
      int ql;
      reduce_large(x[i], rl, ql);
      const bool small = fabsf(x[i]) < kSmallLimit;
      r[i] = small ? r[i] : rl;
      q[i] = small ? q[i] : ql;
      huge = huge || !(fabsf(x[i]) < kReducedLimit);
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) sincos_quadrants(r[i], q[i], cv[i], ms[i]);
  if (!kFast && __any_sync(0xffffffffu, huge)) {
    float xl[8], cl[8], ml[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) xl[i] = x[i], cl[i] = cv[i], ml[i] = ms[i];
#pragma unroll 1
    for (int i = 0; i < 8; ++i) {
      if (fabsf(xl[i]) < kReducedLimit) continue;
      float sv;
      sincosf(xl[i], &sv, cl + i);
      ml[i] = -sv;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) cv[i] = cl[i], ms[i] = ml[i];
  }
}

// dPhi^T = W_tile dout_stage^T, four k16 steps over the columns, fresh
// (the first step only writes the accumulators)
__device__ __forceinline__ void dphi_product(float (&dphi)[kAcc], uint64_t w_desc,
                                             uint64_t d_desc) {
  wg::fence();
  wg::mma_ss64<false>(dphi, w_desc, d_desc);
#pragma unroll
  for (int i = 1; i < kCols / wg::kStep; ++i)
    wg::mma_ss64<true>(dphi, w_desc + 2 * i, d_desc + 2 * i);
  wg::commit();
}

// part = Phi^T dout_stage, four k16 steps of 16 rows (the stage read
// MN-major: 2048 bytes, 128 descriptor units, a step), fresh
__device__ __forceinline__ void dw_product(float (&part)[kAcc], const unsigned (&a)[4][4],
                                           uint64_t d_desc) {
  constexpr int kStepUnits = 16 * wg::kRowBytes >> 4;
  wg::fence();
  wg::mma_rs64_mn<false>(part, a[0], d_desc);
#pragma unroll
  for (int i = 1; i < kRows / wg::kStep; ++i)
    wg::mma_rs64_mn<true>(part, a[i], d_desc + kStepUnits * i);
  wg::commit();
}

// grid (entry tiles, column tiles, row chunks). kDVec: floats per load of
// dout (2 or 1).
template <int kDVec>
__global__ void __launch_bounds__(kThreads, 1) bf16_bwd_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the ring 1024-byte aligned, as an offset from smem_raw (so that the
  // compiler keeps every access in the shared address space)
  unsigned char* ring = smem_raw + ((1024u - (wg::smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* w_tile = ring + kStages * kStageBytes;
  float* dt_s = reinterpret_cast<float*>(w_tile + kGroups * kWBytes);  // [stage][slot][row]
  unsigned* mask_s = reinterpret_cast<unsigned*>(dt_s + kStages * kMaxSlots * kRows);
  float* dtmax_s = reinterpret_cast<float*>(mask_s + kStages * kMaxSlots * 2);
  float* bias_s = dtmax_s + kStages * kMaxSlots;  // [producer warp][column]
  float* bound_s = bias_s + kProducers / 32 * kCols;  // the block's largest |tw|, |tb|
  uint64_t* full = reinterpret_cast<uint64_t*>(bound_s + 2);
  uint64_t* empty = full + kStages;

  const int k_total = a.patch * a.dt_dim;
  const int kp_end = a.patch * a.dt_pad;
  const int e0 = blockIdx.x * kEntries, n0 = blockIdx.y * kCols;
  const int j0 = e0 / a.dt_pad;  // the block's first slot
  const int slots = min(a.patch - 1, (min(e0 + kEntries, kp_end) - 1) / a.dt_pad) - j0 + 1;
  const int r_begin = blockIdx.z * a.chunk_rows;
  const int r_end = min(a.rows, r_begin + a.chunk_rows);
  const int tiles = (r_end - r_begin + kRows - 1) / kRows;

  // W's rows of the block's entries in bf16, zero at padded entries and
  // past ced: pair p of entry e holds columns n0 + 2p, 2p + 1
  for (int i = threadIdx.x; i < kEntries * (kCols / 2); i += kThreads) {
    const int e = i / (kCols / 2), p = i % (kCols / 2);
    const int kp = e0 + e, j = kp / a.dt_pad, f = kp - j * a.dt_pad;
    const bool in = kp < kp_end && f < a.dt_dim;
    const float* wk = a.w + static_cast<size_t>(j * a.dt_dim + f) * a.w_sk;
    const int c = n0 + 2 * p;
    const float lo = in && c < a.ced ? wk[static_cast<size_t>(c) * a.w_sn] : 0.f;
    const float hi = in && c + 1 < a.ced ? wk[static_cast<size_t>(c + 1) * a.w_sn] : 0.f;
    *reinterpret_cast<unsigned*>(w_tile + (e / 64) * kWBytes + wg::swizzled(e % 64, 2 * p)) =
        bf16::pack(lo, hi);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (threadIdx.x < 32) {  // the block's largest |tw| and |tb|, for the fast path's bound
    float mw = 0.f, mb = 0.f;
    for (int e = threadIdx.x; e < kEntries; e += 32) {
      const int kp = e0 + e, j = kp / a.dt_pad, f = kp - j * a.dt_pad;
      if (kp < kp_end && f < a.dt_dim)
        mw = fmaxf(mw, fabsf(a.tw[f])), mb = fmaxf(mb, fabsf(a.tb[f]));
    }
    mw = __uint_as_float(__reduce_max_sync(0xffffffffu, __float_as_uint(mw)));
    mb = __uint_as_float(__reduce_max_sync(0xffffffffu, __float_as_uint(mb)));
    if (threadIdx.x == 0) bound_s[0] = mw, bound_s[1] = mb;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      wg::bar_init(full + s, kProducers);
      wg::bar_init(empty + s, kConsumers / 32);
    }
    wg::bar_init_fence();
  }
  __syncthreads();

  const int lane = threadIdx.x % 32;
  float* dst = a.dw_dst + static_cast<size_t>(blockIdx.z) * (k_total + 1) * a.ced;
  if (threadIdx.x >= kConsumers) {
    // The producer warpgroup. Warp pw converts rows kBand pw .. + kBand - 1
    // of each stage, lane l columns n0 + 2l, 2l + 1 (and sums them into
    // dbias in the first entry tile's blocks), and stages dt and valid at
    // slots pw and pw + 4, lane l rows l and 32 + l. Every load of a stage
    // is started at once, a stage ahead: into registers while the consumers
    // still hold the ring slot they go to.
    const int pw = (threadIdx.x - kConsumers) / 32;
    const int c = n0 + 2 * lane;
    const bool c_in = c < a.ced, c1_in = c + 1 < a.ced;
    // this lane's bytes in a swizzled row r: chunk (l / 4) ^ (r % 8)
    int off[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) off[k] = (((lane / 4) ^ k) * 16) + (lane % 4) * 4;
    float b0 = 0.f, b1 = 0.f;
    float2 v[kBand];
    float dv[2][2];
    bool vv[2][2];
    const auto fetch = [&](int t) {
      const int r0 = r_begin + t * kRows;
      const float* src = a.dout + static_cast<size_t>(r0 + kBand * pw) * a.ced + c;
#pragma unroll
      for (int i = 0; i < kBand; ++i, src += a.ced) {
        const bool in = r0 + kBand * pw + i < r_end && c_in;
        if constexpr (kDVec == 2) {
          v[i] = in ? *reinterpret_cast<const float2*>(src) : make_float2(0.f, 0.f);
        } else {
          v[i].x = in ? src[0] : 0.f;
          v[i].y = in && c1_in ? src[1] : 0.f;
        }
      }
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + 32 * h + lane, sl = pw + 4 * q;
          const bool in = sl < slots && r < r_end;
          const size_t idx = static_cast<size_t>(r) * a.patch + j0 + sl;
          vv[q][h] = in && a.valid[idx];
          dv[q][h] = in ? a.dt[idx] : 0.f;
        }
    };
    fetch(0);
    for (int t = 0; t < tiles; ++t) {
      const int s = t % kStages;
      if (t >= kStages) wg::bar_wait(empty + s, (t / kStages - 1) & 1);
      unsigned char* band = ring + s * kStageBytes + kBand * pw * wg::kRowBytes;
#pragma unroll
      for (int i = 0; i < kBand; ++i) {
        *reinterpret_cast<unsigned*>(band + i * wg::kRowBytes + off[i % 8]) =
            bf16::pack(v[i].x, v[i].y);
        b0 += v[i].x, b1 += v[i].y;
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int sl = pw + 4 * q;
        if (sl >= slots) break;
        float m = 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float d = vv[q][h] ? dv[q][h] : 0.f;
          dt_s[(s * kMaxSlots + sl) * kRows + 32 * h + lane] = d;
          const unsigned bits = __ballot_sync(0xffffffffu, vv[q][h]);
          if (lane == 0) mask_s[(s * kMaxSlots + sl) * 2 + h] = bits;
          m = fmaxf(m, fabsf(d));
        }
        m = __uint_as_float(__reduce_max_sync(0xffffffffu, __float_as_uint(m)));
        if (lane == 0) dtmax_s[s * kMaxSlots + sl] = m;
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      wg::bar_arrive(full + s);
      if (t + 1 < tiles) fetch(t + 1);
    }
    if (blockIdx.x == 0) {  // dbias as dW_ext's row K: each warp's rows, then the warps in order
      bias_s[pw * kCols + 2 * lane] = b0;
      bias_s[pw * kCols + 2 * lane + 1] = b1;
      asm volatile("bar.sync 1, %0;\n" ::"n"(kProducers) : "memory");
      if (pw == 0) {
        float s0 = bias_s[2 * lane], s1 = bias_s[2 * lane + 1];
#pragma unroll
        for (int w = 1; w < kProducers / 32; ++w)
          s0 += bias_s[w * kCols + 2 * lane], s1 += bias_s[w * kCols + 2 * lane + 1];
        if (c_in) dst[static_cast<size_t>(k_total) * a.ced + c] = s0;
        if (c1_in) dst[static_cast<size_t>(k_total) * a.ced + c + 1] = s1;
      }
    }
    return;
  }

  // A consumer thread: warpgroup `group`, warp `warp` of it; its entries
  // h = 0, 1 are the warpgroup's 16 warp + g + 8 h (the accumulators'
  // rows), its rows in step s (16 rows) 16 s + 8 jj + 2t + b (columns).
  const int group = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int g = lane / 4, t4 = lane % 4;
  int sl[2], row[2];
  bool real[2];
  float tw_e[2], tb_e[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kp = e0 + 64 * group + 16 * warp + g + 8 * h;
    const int j = kp / a.dt_pad, f = kp - j * a.dt_pad;
    real[h] = kp < kp_end && f < a.dt_dim;
    sl[h] = real[h] ? j - j0 : 0;
    row[h] = j * a.dt_dim + f;
    tw_e[h] = real[h] ? a.tw[f] : 0.f;
    tb_e[h] = real[h] ? a.tb[f] : 0.f;
  }
  // the warpgroup's slots (the same in its four warps)
  const int g_first = e0 + 64 * group;
  const bool group_real = g_first < kp_end;
  const int gs0 = group_real ? g_first / a.dt_pad - j0 : 0;
  const int gs1 = group_real ? min(a.patch - 1, (min(g_first + 64, kp_end) - 1) / a.dt_pad) - j0
                             : -1;

  const uint64_t w_desc = wg::desc_sw128(w_tile + group * kWBytes);
  float acc[kAcc] = {}, part[kAcc], dphi[kAcc];
  unsigned a_frag[4][4];
  float s_tw[2] = {}, s_tb[2] = {};
  int pending = -1;  // the stage whose dW product is in flight
  for (int t = 0; t < tiles; ++t) {
    const int s = t % kStages;
    wg::bar_wait(full + s, (t / kStages) & 1);
    const unsigned char* stage = ring + s * kStageBytes;
    const unsigned* masks = mask_s + s * kMaxSlots * 2;
    unsigned any = 0u;
    for (int q = gs0; q <= gs1; ++q) any |= masks[2 * q] | masks[2 * q + 1];
    const bool live = any != 0u;
    const uint64_t d_desc = wg::desc_sw128(stage);
    if (live) dphi_product(dphi, w_desc, d_desc);
    wg::wait<0>();
    if (pending >= 0) {  // the previous stage's dW is done: add it, free its stage
      wg::hold(part);
      wg::add(acc, part);
      __syncwarp();
      if (lane == 0) wg::bar_arrive(empty + pending);
      pending = -1;
    }
    if (!live) {
      __syncwarp();
      if (lane == 0) wg::bar_arrive(empty + s);
      continue;
    }
    wg::hold(dphi);

    // this thread's valid rows at each entry's slot, shifted by 2t (bit
    // 16 s' + 8 jj + b of half s / 2 is row 32 (s / 2) + that + 2t), and
    // the warp's union (which 16-row steps have work)
    unsigned m[2][2], wm[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
      for (int h = 0; h < 2; ++h) m[h][hf] = real[h] ? masks[2 * sl[h] + hf] : 0u;
      wm[hf] = __reduce_or_sync(0xffffffffu, m[0][hf] | m[1][hf]);
#pragma unroll
      for (int h = 0; h < 2; ++h) m[h][hf] >>= 2 * t4;
    }
    const float* dts = dt_s + s * kMaxSlots * kRows;
    // cosf's fast path for the whole block where the stage's largest valid
    // |dt| at the block's slots allows it with the block's largest |tw|
    // and |tb| (one choice for every warp: a block waits for its slowest)
    float dmax = 0.f;
    for (int q = 0; q < slots; ++q) dmax = fmaxf(dmax, dtmax_s[s * kMaxSlots + q]);
    const bool fast = __fadd_rn(__fmul_rn(dmax, bound_s[0]), bound_s[1]) <= 105000.f;

    // the stage's four k16 steps, compiled once for each path (kFast):
    // each copy is straight-line code over its own path
    const auto steps = [&](auto fast_path) {
      constexpr bool kFast = decltype(fast_path)::value;
#pragma unroll
      for (int st = 0; st < kRows / wg::kStep; ++st) {
        // pair p = 4 jj + 2 h + b: entry h, row 16 st + 8 jj + 2t + b, its
        // dPhi in dphi[8 st + p]
        const int hf = st / 2, base = 16 * (st % 2);
        if (((wm[hf] >> base) & 0xffffu) == 0u) {
#pragma unroll
          for (int i = 0; i < 4; ++i) a_frag[st][i] = 0u;
          continue;
        }
        float d[8], x[8], cv[8], ms[8];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float2 v = *reinterpret_cast<const float2*>(
                dts + sl[h] * kRows + 16 * st + 8 * jj + 2 * t4);
            d[4 * jj + 2 * h] = v.x, d[4 * jj + 2 * h + 1] = v.y;
          }
#pragma unroll
        for (int p = 0; p < 8; ++p) {
          const int h = (p / 2) % 2;
          x[p] = theta_of(d[p], tw_e[h], tb_e[h]);
        }
        sincos_pairs<kFast>(x, cv, ms);
        float phi[8];
#pragma unroll
        for (int p = 0; p < 8; ++p) {
          const int jj = p / 4, h = (p / 2) % 2, b = p % 2;
          const bool v = (m[h][hf] >> (base + 8 * jj + b)) & 1u;
          const float c = v ? dphi[8 * st + p] * ms[p] : 0.f;
          s_tb[h] += c;
          s_tw[h] += c * d[p];
          phi[p] = v ? cv[p] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) a_frag[st][i] = bf16::pack(phi[2 * i], phi[2 * i + 1]);
      }
    };
    if (fast)
      steps(std::true_type{});
    else
      steps(std::false_type{});
    dw_product(part, a_frag, wg::desc_mn_sw128(stage));
    pending = s;
  }
  wg::wait<0>();
  if (pending >= 0) {
    wg::hold(part);
    wg::add(acc, part);
  }

  // dW_ext rows (j, f) -> j * dt_dim + f: accumulator 4 j' + q is entry
  // h = q / 2, column n0 + 8 j' + 2t + q % 2
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int h = (i % 4) / 2, c = n0 + 8 * (i / 4) + 2 * t4 + i % 2;
    if (real[h] && c < a.ced) dst[static_cast<size_t>(row[h]) * a.ced + c] = acc[i];
  }
  // the quad's four lanes hold one entry's sums over other rows: a fixed
  // butterfly, then lane t = 0 writes them
  const size_t part_row = static_cast<size_t>(blockIdx.z * gridDim.y + blockIdx.y) * a.patch;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      s_tw[h] += __shfl_xor_sync(0xffffffffu, s_tw[h], off);
      s_tb[h] += __shfl_xor_sync(0xffffffffu, s_tb[h], off);
    }
    if (t4 == 0 && real[h]) {
      const int j = sl[h] + j0, f = row[h] - j * a.dt_dim;
      float* p = a.part + (part_row + j) * 2 * a.dt_dim;
      p[f] = s_tw[h];
      p[a.dt_dim + f] = s_tb[h];
    }
  }
}

// The whole backward: the kernel, then the row chunks' dW partial sums
// (partial: (chunks, K + 1, ced), with more than one chunk) added in a
// fixed order into dw_ext, and part's rows into dt_grads (2, dt_dim): dtw,
// then dtb. d_vec: floats per load of dout (2 or 1, the wrapper's
// alignment check). With no rows every gradient is zero. The kernel opts
// in to its shared memory once, at its first launch; the function is
// static, so that its flag is this library's own even where another
// build of it is loaded in the same process.
static cudaError_t backward(Args a, float* dw_ext, float* dt_grads, float* partial, float* part,
                            int d_vec, cudaStream_t stream) {
  if (a.ced == 0) return cudaSuccess;
  const int k_total = a.patch * a.dt_dim;
  const size_t dw_floats = static_cast<size_t>(k_total + 1) * a.ced;
  cudaError_t err;
  if (a.rows == 0) {
    err = cudaMemsetAsync(dw_ext, 0, sizeof(float) * dw_floats, stream);
    if (err == cudaSuccess)
      err = cudaMemsetAsync(dt_grads, 0, sizeof(float) * 2 * a.dt_dim, stream);
    return err;
  }
  if (a.dt_dim < 1 || a.dt_pad < a.dt_dim || min(a.patch, slots_bound(a.dt_pad)) > kMaxSlots ||
      a.chunk_rows <= 0 || a.chunk_rows % kRows != 0)
    return cudaErrorInvalidValue;
  const int chunks = (a.rows + a.chunk_rows - 1) / a.chunk_rows;
  const int col_tiles = (a.ced + kCols - 1) / kCols;
  a.dw_dst = chunks == 1 ? dw_ext : partial;
  a.part = part;
  const auto kernel = d_vec >= 2 ? bf16_bwd_kernel<2> : bf16_bwd_kernel<1>;
  static const cudaError_t opt_in[2] = {
      cudaFuncSetAttribute(bf16_bwd_kernel<1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(kSmemBytes)),
      cudaFuncSetAttribute(bf16_bwd_kernel<2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(kSmemBytes))};
  if (opt_in[d_vec >= 2] != cudaSuccess) return opt_in[d_vec >= 2];
  const dim3 grid((a.patch * a.dt_pad + kEntries - 1) / kEntries, col_tiles, chunks);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (chunks > 1) {
    err = chunks <= patch_gemm::kMaxElementwisePartials
              ? patch_gemm::launch_sum_partials(partial, nullptr, dw_ext, chunks, dw_floats,
                                                a.ced, stream)
              : launch_strided_sum(partial, dw_ext, chunks, static_cast<int>(dw_floats), stream);
    if (err != cudaSuccess) return err;
  }
  // part (chunks * column tiles * patch, 2, dt_dim) summed over its first axis
  return launch_strided_sum(part, dt_grads, chunks * col_tiles * a.patch, 2 * a.dt_dim, stream);
}

}  // namespace time_bwd_bf16
}  // namespace dyglib
