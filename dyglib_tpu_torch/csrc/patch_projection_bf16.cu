// The bf16 variant of DyGFormer's frozen-channel patch projection (a model
// built with compute_dtype bfloat16):
//   out[r, :] = bf16(bf16(x[r] @ W) + bf16(bias)),  x[r] = the (patch, D) bf16
//   rows of patch r, W f32 rounded to bf16, the product summed in f32;
//   dW = patches(x)^T @ dout and dbias = sum_r dout[r] from bf16 dout, f32.
//
// Forward: replaces dyglib_tpu/ops/pallas/patch_projection.py::_fwd_kernel,
// whose math (bf16 x and W, f32 sums) it keeps, and rounds its output as
// the JAX package's bf16 frozen channel does: TorchLinear(dtype=bfloat16)
// on the patch-flattened rows (dyglib_tpu/models/dygformer.py, the bf16
// model's path), the product rounded to bf16, plus the bias rounded to
// bf16, rounded again.
// Backward: replaces ::_bwd_kernel: dW from bf16 x and bf16 dout (the
// forward's output is bf16, so its gradient is), summed in f32, as one
// product [x | 1]^T @ dout whose ones column gives dbias.
//
// What bounds them on an H100 (CanParl: rows 19,200, K = 11,008, ced 50):
// x read once, 423 MB in bf16, 0.126 ms at 3.35 TB/s; 21.1 G operations
// take 0.021 ms at 989 T/s. Bound by the bytes in both directions.
//
// The forward on Hopper's asynchronous units (wgmma.cuh): a block owns 256
// rows and 56 columns; one producer warp streams x's (256 x 64) boxes and
// W's (56 x 64) boxes by TMA into a 4-stage ring (40 KB a stage, three in
// flight while one is multiplied); two consumer warpgroups, 128 rows each,
// multiply every stage with wgmma m64n56k16 (A and B from shared memory in
// the 128-byte swizzle), each stage's four k16 steps into fresh f32
// accumulators that are added to the running sum on the CUDA cores. W is
// converted to bf16 once a launch (wgmma::pack_weight, 1.2 MB at CanParl),
// so a row tile reads 0.6 MB of bf16 W where staging f32 W and rounding it
// at each step (as the backward's design would) pulls 2.5 MB: 90 MB of W
// through shared memory a launch instead of 370. The reduction over K is split where that fills the card
// (ops/patch_projection.py::wgmma_forward_plan), into partial sums that a
// second pass adds in a fixed order, so two runs give identical bits.
// TMA needs x's row stride and address to be multiples of 16 bytes: where
// patch * D * 2 bytes is not (patch 1 or an odd patch at D = 172), the
// wrapper copies x into rows padded to a multiple of 8 values, which the
// tensor map's extent (K) keeps the kernel from reading.
//
// The backward: the split-TF32 kernels' design (patch_gemm.cuh) with one
// bf16 mma.sync m16n8k16 pass (bf16_mma.cuh): the same tiles (128 rows,
// 56 columns, 32-deep stages), the same 4-stage cp.async ring, the same
// reduction splits and fixed-order partial sums (ops/_plan.py), so two
// runs give identical bits. x and dout are staged as bf16, half the f32
// kernels' bytes.
#include "bf16_mma.cuh"
#include "weight_grad.cuh"
#include "wgmma.cuh"

namespace pg = dyglib::patch_gemm;
namespace bf = dyglib::bf16;
namespace wg = dyglib::wgmma;

namespace {

// ---- forward on wgmma: grid (row tiles of 256, column tiles, K splits)

constexpr int kWgTileM = 256;  // two consumer warpgroups, two m64 tiles each
constexpr int kWgStages = 4;
constexpr int kWgConsumers = 256;
constexpr int kWgThreads = kWgConsumers + 32;  // and one producer warp
constexpr int kXBoxBytes = kWgTileM * wg::kRowBytes;                 // 32,768
constexpr int kWgStageBytes = kXBoxBytes + wg::kWStageBytes;         // 40,960
// the ring, 1024-byte aligned, then a full and an empty barrier a stage
constexpr size_t kWgSmemBytes = 1024 + kWgStages * kWgStageBytes + 2 * kWgStages * 8;
static_assert(kXBoxBytes % 1024 == 0 && kWgStageBytes % 1024 == 0, "swizzle-aligned tiles");

struct WgForwardArgs {
  CUtensorMap x_map;     // x (rows, k_total) bf16, rows x_ld apart: boxes of 64 x 256
  CUtensorMap w_map;     // packed W^T (col tiles * 56, k_pad) bf16: boxes of 64 x 56
  const float* bias;     // (ced)
  unsigned short* out;   // (rows, ced) bf16, written with one split
  float* partial;        // (splits, rows, ced) f32 with more than one
  int rows, k_total, ced;
  int k_chunk;           // K per split, a multiple of 64
};

__global__ void __launch_bounds__(kWgThreads, 1)
    patch_forward_wgmma_kernel(const __grid_constant__ WgForwardArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kWgStages * kWgStageBytes);
  uint64_t* empty = full + kWgStages;
  const int m0 = blockIdx.x * kWgTileM, n0 = blockIdx.y * wg::kTileN;
  const int k_begin = blockIdx.z * a.k_chunk;
  const int k_end = min(a.k_total, k_begin + a.k_chunk);
  const int tiles = (k_end - k_begin + wg::kStageK - 1) / wg::kStageK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      wg::bar_init(full + s, 1);
      wg::bar_init(empty + s, kWgConsumers / 32);
    }
    wg::bar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kWgConsumers) {  // the producer warp: one lane starts every copy
    if (threadIdx.x == kWgConsumers) {
      for (int t = 0; t < tiles; ++t) {
        const int s = t % kWgStages;
        if (t >= kWgStages) wg::bar_wait(empty + s, (t / kWgStages - 1) & 1);
        unsigned char* stage = smem + s * kWgStageBytes;
        const int k0 = k_begin + t * wg::kStageK;
        wg::bar_expect_tx(full + s, kXBoxBytes + wg::kWBoxBytes);
        wg::tma_load(a.x_map, stage, full + s, k0, m0);
        wg::tma_load(a.w_map, stage + kXBoxBytes, full + s, k0, n0);
      }
    }
    return;
  }

  // a consumer warpgroup: rows 128 group + 0..127, m64 tiles 2 group, 2 group + 1
  const int group = threadIdx.x / 128;
  float acc[2][wg::kAcc] = {}, part[2][wg::kAcc];
  for (int t = 0; t < tiles; ++t) {
    const int s = t % kWgStages;
    wg::bar_wait(full + s, (t / kWgStages) & 1);
    const unsigned char* stage = smem + s * kWgStageBytes;
    const uint64_t a0 = wg::desc_sw128(stage + (2 * group) * 64 * wg::kRowBytes);
    const uint64_t a1 = wg::desc_sw128(stage + (2 * group + 1) * 64 * wg::kRowBytes);
    const uint64_t b = wg::desc_sw128(stage + kXBoxBytes);
    wg::hold(part[0]);
    wg::hold(part[1]);
    wg::fence();
#pragma unroll
    for (int i = 0; i < wg::kStageK / wg::kStep; ++i) {
      wg::mma_ss(part[0], a0 + 2 * i, b + 2 * i, i);
      wg::mma_ss(part[1], a1 + 2 * i, b + 2 * i, i);
    }
    wg::commit();
    wg::wait<0>();
    wg::hold(part[0]);
    wg::hold(part[1]);
    wg::add(acc[0], part[0]);
    wg::add(acc[1], part[1]);
    __syncwarp();
    if (threadIdx.x % 32 == 0) wg::bar_arrive(empty + s);
  }

  const bool one = gridDim.z == 1;
  float* partial = a.partial + static_cast<size_t>(blockIdx.z) * a.rows * a.ced;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
    wg::store(acc[mt], m0 + 128 * group + 64 * mt, a.rows, n0, a.ced, a.ced,
              [&](size_t i, int c, float v) {
                if (one)
                  a.out[i] = bf::linear_out(v, a.bias[c]);
                else
                  partial[i] = v;
              });
}

// ---- backward: grid (K + 1 tiles, column tiles, row chunks)

constexpr int kBwdWarps = 4;
constexpr int kBwdThreads = 32 * kBwdWarps;
constexpr int kBwdTileM = pg::kWarpM * kBwdWarps;  // 128 K entries a block
// stages [row][K entry] and [row][column] in bf16 values; 136 and 72
// values (68 and 36 words, = 4 mod 32) put the pair reads (rows 2t and
// 2t + 1, entries or columns g) on distinct banks
constexpr int kBwdXStride = kBwdTileM + 8;
constexpr int kBwdDStride = pg::kTileN + 16;
constexpr int kBwdXValues = pg::kTileK * kBwdXStride;
constexpr int kBwdStageFloats = (kBwdXValues + pg::kTileK * kBwdDStride) / 2;
constexpr size_t kBwdSmemBytes = sizeof(float) * pg::kStages * kBwdStageFloats;  // 53,248
static_assert(kBwdStageFloats % 4 == 0 && kBwdXValues % 8 == 0, "16-byte aligned stages");

struct BackwardArgs {
  const unsigned short* x;     // (rows, k_total) bf16 row-major
  const unsigned short* dout;  // (rows, ced) bf16 row-major
  float* dst;                  // dw_ext (k_total + 1, ced) with one chunk, else partial
  int rows, k_total, ced, chunk_rows;  // chunk_rows a multiple of kTileK
};

template <bool kOnes>
__device__ __forceinline__ void backward_stage(const unsigned short* stage, int warp_m,
                                               int m_base, int k_total,
                                               float (&acc)[2][pg::kNFrag][4]) {
  const unsigned short* xs = stage + warp_m;
  const unsigned short* ds = stage + kBwdXValues;
  bf::multiply_stage(
      [&](int mt, int m, int r) {
        const int col = mt * 16 + m;
        if (kOnes && m_base + col == k_total) return bf::kOnes;
        return bf::pack_bits(xs[r * kBwdXStride + col], xs[(r + 1) * kBwdXStride + col]);
      },
      [&](int nf, int r, int c) {
        const unsigned short* d = ds + r * kBwdDStride + nf * 8 + c;
        return bf::pack_bits(d[0], d[kBwdDStride]);
      },
      acc);
}

// kXVec, kDVec: bf16 values per copy of x and dout (8, 4, 2 or 1).
template <int kXVec, int kDVec>
__global__ void __launch_bounds__(kBwdThreads) patch_backward_bf16_kernel(const BackwardArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int m0 = blockIdx.x * kBwdTileM, n0 = blockIdx.y * pg::kTileN;
  const int r_begin = blockIdx.z * a.chunk_rows;
  const int r_end = min(a.rows, r_begin + a.chunk_rows);
  const int tiles = (r_end - r_begin + pg::kTileK - 1) / pg::kTileK;
  const int warp_m = (threadIdx.x / 32) * pg::kWarpM;
  const bool ones = m0 + kBwdTileM > a.k_total;  // this tile holds the dbias row

  const auto load = [&](int tile, float* stage) {
    const int r0 = r_begin + tile * pg::kTileK;
    unsigned short* s16 = reinterpret_cast<unsigned short*>(stage);
    bf::stage_tile<kBwdThreads, pg::kTileK, kBwdTileM, kBwdXStride, kXVec>(
        s16, a.x, a.k_total, r0, r_end, m0, a.k_total);
    bf::stage_tile<kBwdThreads, pg::kTileK, pg::kTileN, kBwdDStride, kDVec>(
        s16 + kBwdXValues, a.dout, a.ced, r0, r_end, n0, a.ced);
  };
  float acc[2][pg::kNFrag][4] = {};
  const auto multiply = [&](const float* stage) {
    const unsigned short* s16 = reinterpret_cast<const unsigned short*>(stage);
    if (ones)
      backward_stage<true>(s16, warp_m, m0 + warp_m, a.k_total, acc);
    else
      backward_stage<false>(s16, warp_m, m0 + warp_m, a.k_total, acc);
  };
  pg::pipeline<kBwdStageFloats>(smem, tiles, load, multiply);

  const int out_rows = a.k_total + 1;
  float* dst = a.dst + static_cast<size_t>(blockIdx.z) * out_rows * a.ced;
  pg::store_tile(acc, dst, a.ced, m0 + warp_m, out_rows, n0, a.ced, nullptr);
}

template <class Args>
cudaError_t launch(void (*kernel)(Args), dim3 grid, int threads, size_t smem,
                   cudaStream_t stream, const Args& args) {
  const cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (set != cudaSuccess) return set;
  kernel<<<grid, threads, smem, stream>>>(args);
  return cudaGetLastError();
}

template <int kXVec>
cudaError_t launch_backward_d(int d_vec, dim3 grid, cudaStream_t stream,
                              const BackwardArgs& args) {
  const auto go = [&](auto kernel) {
    return launch(kernel, grid, kBwdThreads, kBwdSmemBytes, stream, args);
  };
  switch (d_vec) {
    case 8: return go(patch_backward_bf16_kernel<kXVec, 8>);
    case 4: return go(patch_backward_bf16_kernel<kXVec, 4>);
    case 2: return go(patch_backward_bf16_kernel<kXVec, 2>);
    default: return go(patch_backward_bf16_kernel<kXVec, 1>);
  }
}

}  // namespace

// The forward. x: (rows, k_total) bf16, rows x_ld values apart, x_ld a
// multiple of 8 and x 16-byte aligned (TMA's rule for its row stride and
// address); w:
// (k_total, ced) f32 with element strides (w_sk, w_sn); bias: (ced) f32;
// out: (rows, ced) bf16; w16: scratch for the packed W^T, (ceil(ced / 56)
// * 56, ceil(k_total / 64) * 64) bf16. k_chunk: K per split, a multiple of
// 64; with more than one split, partial holds (splits, rows, ced) f32.
DYGLIB_API int patch_projection_bf16_forward(const unsigned short* x, int x_ld, const float* w,
                                             int w_sk, int w_sn, const float* bias,
                                             unsigned short* out, float* partial,
                                             unsigned short* w16, int rows, int k_total, int ced,
                                             int k_chunk, cudaStream_t stream) {
  if (rows == 0 || ced == 0) return 0;
  if (k_chunk <= 0 || k_chunk % wg::kStageK != 0 || k_total <= 0 || x_ld < k_total ||
      x_ld % 8 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int col_tiles = (ced + wg::kTileN - 1) / wg::kTileN;
  const int n_pad = col_tiles * wg::kTileN;
  const int k_pad = (k_total + wg::kStageK - 1) / wg::kStageK * wg::kStageK;
  cudaError_t err =
      wg::pack_weight(w, w_sk, w_sn, ced, k_total, k_total, k_total, w16, n_pad, k_pad, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  WgForwardArgs args{};
  err = wg::encode_map(&args.x_map, x, k_total, rows, 2ull * x_ld, kWgTileM);
  if (err == cudaSuccess)
    err = wg::encode_map(&args.w_map, w16, k_pad, n_pad, 2ull * k_pad, wg::kTileN);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int splits = (k_total + k_chunk - 1) / k_chunk;
  args.bias = bias, args.out = out, args.partial = partial;
  args.rows = rows, args.k_total = k_total, args.ced = ced, args.k_chunk = k_chunk;
  static const cudaError_t opted_in = cudaFuncSetAttribute(
      patch_forward_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kWgSmemBytes));  // once a process: past the 48 KB default
  if (opted_in != cudaSuccess) return static_cast<int>(opted_in);
  const dim3 grid((rows + kWgTileM - 1) / kWgTileM, col_tiles, splits);
  patch_forward_wgmma_kernel<<<grid, kWgThreads, kWgSmemBytes, stream>>>(args);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return static_cast<int>(bf::launch_sum_partials(partial, bias, out, splits,
                                                  static_cast<size_t>(rows) * ced, ced, stream));
}

// x: (rows, k_total) bf16; dout: (rows, ced) bf16; dw_ext: (k_total + 1,
// ced) f32, rows 0..k_total-1 = dW, row k_total = dbias; a block owns 128
// K entries. chunk_rows: rows per partial sum, a multiple of 32; with more
// than one chunk, partial holds (chunks, k_total + 1, ced) f32. x_vec,
// d_vec: bf16 values per copy (8, 4, 2 or 1).
DYGLIB_API int patch_projection_bf16_backward(const unsigned short* x, const unsigned short* dout,
                                              float* dw_ext, float* partial, int rows,
                                              int k_total, int ced, int chunk_rows, int x_vec,
                                              int d_vec, cudaStream_t stream) {
  if (ced == 0) return 0;
  const int out_rows = k_total + 1;
  if (rows == 0)
    return static_cast<int>(
        cudaMemsetAsync(dw_ext, 0, sizeof(float) * out_rows * static_cast<size_t>(ced), stream));
  if (chunk_rows <= 0 || chunk_rows % pg::kTileK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (rows + chunk_rows - 1) / chunk_rows;
  const BackwardArgs args{x, dout, chunks == 1 ? dw_ext : partial, rows, k_total, ced,
                          chunk_rows};
  const dim3 grid((out_rows + kBwdTileM - 1) / kBwdTileM, (ced + pg::kTileN - 1) / pg::kTileN,
                  chunks);
  cudaError_t err;
  switch (x_vec) {
    case 8: err = launch_backward_d<8>(d_vec, grid, stream, args); break;
    case 4: err = launch_backward_d<4>(d_vec, grid, stream, args); break;
    case 2: err = launch_backward_d<2>(d_vec, grid, stream, args); break;
    default: err = launch_backward_d<1>(d_vec, grid, stream, args); break;
  }
  if (err != cudaSuccess || chunks == 1) return static_cast<int>(err);
  if (chunks <= pg::kMaxElementwisePartials)
    return static_cast<int>(pg::launch_sum_partials(
        partial, nullptr, dw_ext, chunks, static_cast<size_t>(out_rows) * ced, ced, stream));
  return static_cast<int>(
      dyglib::launch_strided_sum(partial, dw_ext, chunks, out_rows * ced, stream));
}
