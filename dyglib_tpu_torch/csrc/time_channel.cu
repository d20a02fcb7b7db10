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
// Backward: replaces ::_bwd_kernel. Given dout (rows, ced):
//   dW = Phi^T @ dout,  dbias = sum_r dout[r]
//   dPhi = dout @ W^T, and per (r, j, f) with valid set:
//       c = dPhi * -sin(theta);  dtb[f] += c;  dtw[f] += c * dt
// in one kernel, both products in split TF32 on mma.sync as the forward's,
// dbias on the CUDA cores from the same dout stages (the first entry
// tile's blocks; as a column of ones in the product it left one warp a
// chunk's whole dbias product where few positions are valid, and as a
// separate column sum it cost wikipedia's launch 28%, PERF.md).
// At CanParl (19,200 rows, K = 6400, ced 50) the two products are 24.6 G
// operations, 73.7 G in three TF32 passes: 0.149 ms at 495 T/s, the bound
// (its 13 MB take 4 us; its 98 M (cosine, sine) pairs 0.05 ms at the SFU's
// rate). A block owns 128 padded K entries (Dt padded to dt_pad per slot)
// and one 56-column tile of dout, and streams a chunk of rows through a
// 4-stage cp.async ring of dout, 32 rows a stage, with 8 warps of 16
// entries. Each thread holds two entries (g and g + 8 of its warp's 16:
// one 8-entry group each, so each entry's slot is the whole warp's) and,
// per 8-row step, two rows: 2t and 2t + 1. The dW product reduces over
// rows in that order (a permutation of its depth), so that the (row,
// entry) pairs of a thread's A fragment are exactly those its dPhi
// accumulator fragment holds: one theta, reduced once by cos_reduced.cuh's
// sincos_reduced, gives Phi for dW and -sin for dPhi's epilogue. Phi is
// never stored; dPhi never leaves registers: c and c * dt are summed per
// entry over the thread's rows, then over its quad's lanes by a fixed
// butterfly, into part (one row of [dtw's | dtb's] per (row chunk, column
// tile, patch slot): c is linear in dPhi, so a column tile's share is
// summed alone).
// dt and valid come one row a lane (a row's slot of each group), loaded a
// stage ahead; valid becomes a warp ballot a group, so that every choice
// to skip is the warp's own: no cosine for an m-tile's 8 rows with no
// valid position there, no product for 8 rows with none, nothing for a
// stage with none. W (the block's 128 entries x 56 columns) is staged
// once. Each 32-row stage sums dW into fresh registers (the tensor cores'
// adds round toward zero) added on the CUDA cores; dPhi is 56 deep, one
// fresh sum. 8 warps of one m16 tile each (128 registers a thread, two
// blocks an SM) ran 21% faster than 4 warps of two (255 registers, one
// block); splitting dout once a stage for all warps gained 1.5% and was
// left out (PERF.md). The row chunks (the wrapper's plan,
// ops/_plan.py::best_plan) are summed by a second pass in a fixed order,
// and dtw, dtb by a third, one launch for both (weight_grad.cuh's
// strided_sum): two runs give identical bits. No gradient for dt
// or valid.
//
// theta comes from phi.cuh (exact rounding of the argument); both passes'
// cosines are cos_reduced.cuh's, cosf's bits, and -sin is -sinf's.
#include "cos_reduced.cuh"
#include "patch_gemm.cuh"
#include "phi.cuh"

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

namespace {

// ---- backward: grid (entry tiles, column tiles, row chunks)

// A warp owns one m16 tile of entries (16) and all 56 columns: 28 dW
// accumulators and their fresh stage sums a thread, and 16 of dPhi, so
// that two blocks of 8 warps fit an SM's registers (128 a thread).
constexpr int kMT = 1;                             // m16 tiles a warp
constexpr int kGroups = 2 * kMT;                   // 8-entry groups a warp
constexpr int kBwdWarps = 8;
constexpr int kBwdThreads = 32 * kBwdWarps;
constexpr int kBwdEntries = 16 * kMT * kBwdWarps;  // 128 padded K entries a block
constexpr int kBwdRows = pg::kTileK;               // rows a stage
constexpr int kDStride = pg::kTileN + 12;          // dout stage [row][column], 68
constexpr int kWStride = pg::kTileN + 4;           // W [entry][column], 60
constexpr int kBwdStageFloats = kBwdRows * kDStride;
constexpr size_t kBwdSmemBytes =
    sizeof(float) * (kBwdEntries * kWStride + pg::kStages * kBwdStageFloats);  // 65,536
// Both strides are 4 mod 8 floats: the fragment reads (rows g, columns t)
// and (rows 2t + b, columns g) hit 32 distinct banks.
static_assert(kDStride % 8 == 4 && kWStride % 8 == 4, "conflict-free fragment reads");

struct BackwardArgs {
  const float* dt;     // (rows * patch)
  const bool* valid;   // (rows * patch)
  const float* tw;     // (dt_dim)
  const float* tb;     // (dt_dim)
  const float* w;      // (patch * dt_dim, ced) at w[k * w_sk + c * w_sn]
  const float* dout;   // (rows, ced)
  float* dw_dst;       // dw_ext (K + 1, ced) with one chunk, else partial (chunks, K + 1, ced)
  float* part;         // (chunks * column tiles * patch, 2, dt_dim): dtw's sums, dtb's
  int rows, patch, dt_dim, dt_pad, ced, w_sk, w_sn;
  int chunk_rows;      // a multiple of kBwdRows
};

// kDVec: floats per copy of dout (2 or 1).
template <int kDVec>
__global__ void __launch_bounds__(kBwdThreads, 2) time_channel_bwd_kernel(const BackwardArgs a) {
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);  // (kBwdEntries, kWStride)
  float* ring = w_s + kBwdEntries * kWStride;
  const int k_total = a.patch * a.dt_dim;
  const int kp_end = a.patch * a.dt_pad;
  const int e0 = blockIdx.x * kBwdEntries, n0 = blockIdx.y * pg::kTileN;
  const int r_begin = blockIdx.z * a.chunk_rows;
  const int r_end = min(a.rows, r_begin + a.chunk_rows);
  const int tiles = (r_end - r_begin + kBwdRows - 1) / kBwdRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;

  // W's rows of the block's entries, zero at the padding
  for (int i = threadIdx.x; i < kBwdEntries * pg::kTileN; i += kBwdThreads) {
    const int e = i % kBwdEntries, c = i / kBwdEntries;
    const int kp = e0 + e, j = kp / a.dt_pad, f = kp - j * a.dt_pad;
    const bool in = kp < kp_end && f < a.dt_dim && n0 + c < a.ced;
    const size_t at =
        static_cast<size_t>(j * a.dt_dim + f) * a.w_sk + static_cast<size_t>(n0 + c) * a.w_sn;
    w_s[e * kWStride + c] = in ? a.w[at] : 0.f;
  }  // read after the pipeline's first barrier

  // this thread's entries, i = 2 mt + h -> we + 16 mt + 8 h + g = we + 8 i + g
  const int wl = 16 * kMT * warp;  // the warp's first entry in the block
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
    const int r = r_begin + tile * kBwdRows + lane;
#pragma unroll
    for (int i = 0; i < kGroups; ++i) {
      if (i > 0 && slot[i] == slot[i - 1]) {  // warp-uniform
        d_next[i] = d_next[i - 1], v_next[i] = v_next[i - 1];
        continue;
      }
      const bool in = tile < tiles && r < r_end && slot[i] < a.patch;
      const size_t idx = static_cast<size_t>(r) * a.patch + slot[i];
      v_next[i] = in && a.valid[idx];
      d_next[i] = in ? a.dt[idx] : 0.f;
    }
  };
  fetch(0);

  const auto load = [&](int tile, float* stage) {
    pg::stage_tile<kBwdThreads, kBwdRows, pg::kTileN, kDStride, kDVec>(
        stage, a.dout, a.ced, r_begin + tile * kBwdRows, r_end, n0, a.ced);
  };

  float acc[kMT][pg::kNFrag][4] = {};
  float s_tw[kGroups] = {}, s_tb[kGroups] = {};
  // dbias, in the first entry tile's blocks: thread (bq, bc) sums column
  // bc of the stages' rows 8 bq .. 8 bq + 7 (rows past the chunk are zero)
  const bool bias_block = blockIdx.x == 0;
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

    // dPhi (entries x rows) = W (entries x ced) dout^T, 8 rows a step nt,
    // for the steps with a valid position
    float dphi[4][kMT][4] = {};
#pragma unroll
    for (int kk = 0; kk < pg::kTileN; kk += 8) {
      unsigned w_hi[kMT][4], w_lo[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const pg::Split sp = pg::split_tf32(
              w_s[(wl + 16 * mt + g + 8 * (i % 2)) * kWStride + kk + t + 4 * (i / 2)]);
          w_hi[mt][i] = sp.hi, w_lo[mt][i] = sp.lo;
        }
      // B(c, row) fragments, split; then the three passes, each over all
      // steps and m-tiles (mma.sync is issued in program order: no pass
      // waits on the one before it for the same accumulator)
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
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt)
            pg::mma_tf32(dphi[nt][mt], pass == 0 ? w_lo[mt] : w_hi[mt], b0, b1);
        }
    }

    float part[kMT][pg::kNFrag][4] = {};
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      if (((any >> (8 * nt)) & 0xffu) == 0u) continue;
      // theta of the thread's (row, entry) pairs, q = 4 mt + 2 b + h for
      // row 8 nt + 2 t + b and entry i = 2 mt + h
      float x[4 * kMT], cv[4 * kMT] = {}, sv[4 * kMT] = {}, d[4 * kMT];
      bool v[4 * kMT];
#pragma unroll
      for (int q = 0; q < 4 * kMT; ++q) {
        const int mt = q / 4, b = (q / 2) % 2, i = 2 * mt + q % 2;
        const int row = 8 * nt + 2 * t + b;
        d[q] = __shfl_sync(0xffffffffu, d_cur[i], row);
        v[q] = real[i] && ((vm[i] >> row) & 1u);
        x[q] = dyglib::theta_of(d[q], tw_e[i], tb_e[i]);
      }
      // cosines and sines only for an m-tile with a valid position in
      // these 8 rows (a warp-wide choice: vm are ballots)
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
        if (((vm[2 * mt] | vm[2 * mt + 1]) >> (8 * nt)) & 0xffu)
          dyglib::sincos_reduced<4>(x + 4 * mt, cv + 4 * mt, sv + 4 * mt);
      // dW += Phi^T dout over this step's 8 rows: A(entry, row) fragments
      unsigned a_hi[kMT][4], a_lo[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          // register r holds (entry g + 8 (r % 2), row t + 4 (r / 2)) ->
          // h = r % 2, b = r / 2
          const int q = 4 * mt + 2 * (r / 2) + r % 2, i = 2 * mt + r % 2;
          const pg::Split sp = pg::split_tf32(v[q] ? cv[q] : 0.f);
          a_hi[mt][r] = sp.hi, a_lo[mt][r] = sp.lo;
        }
      const float* d0 = stage + (8 * nt + 2 * t) * kDStride + g;
      pg::Split b[pg::kNFrag][2];
#pragma unroll
      for (int nf = 0; nf < pg::kNFrag; ++nf)
        b[nf][0] = pg::split_tf32(d0[8 * nf]), b[nf][1] = pg::split_tf32(d0[kDStride + 8 * nf]);
#pragma unroll
      for (int nf = 0; nf < pg::kNFrag; ++nf)
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
          pg::mma_tf32(part[mt][nf], a_lo[mt], b[nf][0].hi, b[nf][1].hi);
#pragma unroll
      for (int nf = 0; nf < pg::kNFrag; ++nf)
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
          pg::mma_tf32(part[mt][nf], a_hi[mt], b[nf][0].lo, b[nf][1].lo);
#pragma unroll
      for (int nf = 0; nf < pg::kNFrag; ++nf)
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
          pg::mma_tf32(part[mt][nf], a_hi[mt], b[nf][0].hi, b[nf][1].hi);
      // dPhi's epilogue: accumulator r of (nt, mt) holds (entry g + 8 (r /
      // 2), row 2t + r % 2) -> h = r / 2, b = r % 2
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int q = 4 * mt + 2 * (r % 2) + r / 2, i = 2 * mt + r / 2;
          const float c = v[q] ? dphi[nt][mt][r] * sv[q] : 0.f;
          s_tb[i] += c;
          s_tw[i] += c * d[q];
        }
    }
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nf = 0; nf < pg::kNFrag; ++nf)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nf][i] += part[mt][nf][i];
  };
  pg::pipeline<kBwdStageFloats>(ring, tiles, load, multiply);

  // dW_ext rows: (j, f) -> j * dt_dim + f, padding none; row K = dbias, its
  // four row groups added in a fixed order
  float* dst = a.dw_dst + static_cast<size_t>(blockIdx.z) * (k_total + 1) * a.ced;
  if (bias_block) {
    __syncthreads();  // every warp is done with the ring
    if (bc < pg::kTileN) ring[bq * pg::kTileN + bc] = s_bias;
    __syncthreads();
    const float* q = ring + bc;
    if (bq == 0 && bc < pg::kTileN && n0 + bc < a.ced)
      dst[static_cast<size_t>(k_total) * a.ced + n0 + bc] =
          (q[0] + q[pg::kTileN]) + (q[2 * pg::kTileN] + q[3 * pg::kTileN]);
  }
#pragma unroll
  for (int i = 0; i < kGroups; ++i) {
    const int f = we + 8 * i + g - slot[i] * a.dt_pad;
    if (!real[i]) continue;
    const int row = slot[i] * a.dt_dim + f;
    const int mt = i / 2, h = i % 2;
#pragma unroll
    for (int nf = 0; nf < pg::kNFrag; ++nf)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int c = n0 + nf * 8 + 2 * t + jj;
        if (c < a.ced) dst[static_cast<size_t>(row) * a.ced + c] = acc[mt][nf][2 * h + jj];
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

// The backward kernel above 48 KB of shared memory opts in once, at its
// first launch (outside any CUDA-graph capture that replays it later).
template <int kDVec>
cudaError_t launch_backward(dim3 grid, const BackwardArgs& args, cudaStream_t stream) {
  static const cudaError_t opt_in =
      cudaFuncSetAttribute(time_channel_bwd_kernel<kDVec>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(kBwdSmemBytes));
  if (opt_in != cudaSuccess) return opt_in;
  time_channel_bwd_kernel<kDVec><<<grid, kBwdThreads, kBwdSmemBytes, stream>>>(args);
  return cudaGetLastError();
}

}  // namespace

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
  if (ced == 0) return 0;
  const int k_total = patch * dt_dim;
  const size_t dw_floats = static_cast<size_t>(k_total + 1) * ced;
  cudaError_t err;
  if (rows == 0) {
    err = cudaMemsetAsync(dw_ext, 0, sizeof(float) * dw_floats, stream);
    if (err == cudaSuccess)
      err = cudaMemsetAsync(dt_grads, 0, sizeof(float) * 2 * dt_dim, stream);
    return static_cast<int>(err);
  }
  if (dt_dim < 1 || dt_pad < dt_dim || dt_pad % 8 != 0 || chunk_rows <= 0 ||
      chunk_rows % kBwdRows != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (rows + chunk_rows - 1) / chunk_rows;
  const int col_tiles = (ced + pg::kTileN - 1) / pg::kTileN;
  const BackwardArgs args{dt,   valid, tw,     tb,     w,      dout, chunks == 1 ? dw_ext : partial,
                          part, rows,  patch, dt_dim, dt_pad, ced,  w_sk, w_sn, chunk_rows};
  const dim3 grid((patch * dt_pad + kBwdEntries - 1) / kBwdEntries, col_tiles, chunks);
  err = d_vec >= 2 ? launch_backward<2>(grid, args, stream)
                   : launch_backward<1>(grid, args, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (chunks > 1) {
    err = chunks <= pg::kMaxElementwisePartials
              ? pg::launch_sum_partials(partial, nullptr, dw_ext, chunks, dw_floats, ced, stream)
              : dyglib::launch_strided_sum(partial, dw_ext, chunks, static_cast<int>(dw_floats),
                                           stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // part (chunks * column tiles * patch, 2, dt_dim) summed over its first axis
  return static_cast<int>(
      dyglib::launch_strided_sum(part, dt_grads, chunks * col_tiles * patch, 2 * dt_dim, stream));
}
