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
// The split-TF32 kernels' design (patch_gemm.cuh) with one bf16 mma.sync
// m16n8k16 pass (bf16_mma.cuh): the same tiles (128 or 64 rows, 56
// columns, 32-deep stages), the same 4-stage cp.async ring, the same
// reduction splits and fixed-order partial sums (ops/_plan.py), so two
// runs give identical bits. x and dout are staged as bf16, half the f32
// kernels' bytes; W as f32, rounded where its fragments are built.
//
// What bounds them on an H100 (CanParl: rows 19,200, K = 11,008, ced 50):
// x read once, 423 MB in bf16, 0.126 ms at 3.35 TB/s; 21.1 G operations
// take 0.021 ms at 989 T/s. Bound by the bytes in both directions.
#include "bf16_mma.cuh"
#include "weight_grad.cuh"

namespace pg = dyglib::patch_gemm;
namespace bf = dyglib::bf16;

namespace {

// ---- forward: grid (row tiles, column tiles, K splits)

template <int kWarps>
struct FwdTile {
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kTileM = pg::kWarpM * kWarps;
  static constexpr int kXWords = kTileM * bf::kRowWords;  // x stage [row][k] bf16
  // then W [n][k] f32 as the split-TF32 forward stages it
  static constexpr int kStageFloats = kXWords + pg::kTileN * pg::kFwdStride;
  // 73,216 bytes at 4 warps, 52,736 at 2
  static constexpr size_t kSmemBytes = sizeof(float) * pg::kStages * kStageFloats;
  static_assert(kStageFloats % 4 == 0 && kXWords % 4 == 0, "16-byte aligned stages");
};

struct ForwardArgs {
  const unsigned short* x;  // (rows, k_total) bf16 row-major
  const float* w;           // (k_total, ced) at w[k * w_sk + c * w_sn]
  const float* bias;        // (ced)
  unsigned short* out;      // (rows, ced) bf16, written with one split
  float* partial;           // (splits, rows, ced) f32 with more than one
  int rows, k_total, ced, w_sk, w_sn;
  int k_chunk;              // K per split, a multiple of kTileK
};

// kXVec: bf16 values per copy of x (8, 4, 2 or 1). kWVec: floats per copy
// of a K-major W (4 or 1), 0 for a row-major W (staged transposed).
template <int kWarps, int kXVec, int kWVec>
__global__ void __launch_bounds__(FwdTile<kWarps>::kThreads)
    patch_forward_bf16_kernel(const ForwardArgs a) {
  using T = FwdTile<kWarps>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int m0 = blockIdx.x * T::kTileM, n0 = blockIdx.y * pg::kTileN;
  const int k_begin = blockIdx.z * a.k_chunk;
  const int k_end = min(a.k_total, k_begin + a.k_chunk);
  const int tiles = (k_end - k_begin + pg::kTileK - 1) / pg::kTileK;
  const int warp_m = (threadIdx.x / 32) * pg::kWarpM;

  const auto load = [&](int tile, float* stage) {
    const int k0 = k_begin + tile * pg::kTileK;
    bf::stage_tile<T::kThreads, T::kTileM, pg::kTileK, 2 * bf::kRowWords, kXVec>(
        reinterpret_cast<unsigned short*>(stage), a.x, a.k_total, m0, a.rows, k0, k_end);
    float* ws = stage + T::kXWords;
    if constexpr (kWVec == 0)
      pg::stage_tile_transposed<T::kThreads, pg::kTileN, pg::kTileK, pg::kFwdStride>(
          ws, a.w, a.w_sk, n0, a.ced, k0, k_end);
    else
      pg::stage_tile<T::kThreads, pg::kTileN, pg::kTileK, pg::kFwdStride, kWVec>(
          ws, a.w, a.w_sn, n0, a.ced, k0, k_end);
  };
  float acc[2][pg::kNFrag][4] = {};
  const auto multiply = [&](const float* stage) {
    const unsigned* xs = reinterpret_cast<const unsigned*>(stage) + warp_m * bf::kRowWords;
    const float* ws = stage + T::kXWords;
    bf::multiply_stage(
        [&](int mt, int r, int k) { return xs[(mt * 16 + r) * bf::kRowWords + k / 2]; },
        [&](int nf, int k, int c) {
          const float* p = ws + (nf * 8 + c) * pg::kFwdStride + k;
          return bf::pack(p[0], p[1]);
        },
        acc);
  };
  pg::pipeline<T::kStageFloats>(smem, tiles, load, multiply);

  if (gridDim.z == 1)
    bf::store_tile(acc, a.out, a.ced, m0 + warp_m, a.rows, n0, a.ced, a.bias);
  else
    pg::store_tile(acc, a.partial + static_cast<size_t>(blockIdx.z) * a.rows * a.ced, a.ced,
                   m0 + warp_m, a.rows, n0, a.ced, nullptr);
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

template <int kWarps, int kXVec>
cudaError_t launch_forward_w(int w_vec, dim3 grid, cudaStream_t stream, const ForwardArgs& args) {
  using T = FwdTile<kWarps>;
  const auto go = [&](auto kernel) {
    return launch(kernel, grid, T::kThreads, T::kSmemBytes, stream, args);
  };
  if (w_vec == 4) return go(patch_forward_bf16_kernel<kWarps, kXVec, 4>);
  if (w_vec == 0) return go(patch_forward_bf16_kernel<kWarps, kXVec, 0>);
  return go(patch_forward_bf16_kernel<kWarps, kXVec, 1>);
}

template <int kWarps>
cudaError_t launch_forward(int x_vec, int w_vec, int rows, int ced, int splits,
                           cudaStream_t stream, const ForwardArgs& args) {
  using T = FwdTile<kWarps>;
  const dim3 grid((rows + T::kTileM - 1) / T::kTileM, (ced + pg::kTileN - 1) / pg::kTileN,
                  splits);
  switch (x_vec) {
    case 8: return launch_forward_w<kWarps, 8>(w_vec, grid, stream, args);
    case 4: return launch_forward_w<kWarps, 4>(w_vec, grid, stream, args);
    case 2: return launch_forward_w<kWarps, 2>(w_vec, grid, stream, args);
    default: return launch_forward_w<kWarps, 1>(w_vec, grid, stream, args);
  }
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

// x: (rows, k_total) bf16; w: (k_total, ced) f32 with element strides
// (w_sk, w_sn); bias: (ced) f32; out: (rows, ced) bf16. tile_m: rows of a
// block, 128 or 64. k_chunk: K per split, a multiple of 32; with more than
// one split, partial holds (splits, rows, ced) f32. x_vec: bf16 values per
// copy of x (8, 4, 2 or 1; the wrapper's alignment check); w_vec: floats
// per copy of a K-major W (4 or 1), 0 for a row-major W (w_sn == 1).
DYGLIB_API int patch_projection_bf16_forward(const unsigned short* x, const float* w, int w_sk,
                                             int w_sn, const float* bias, unsigned short* out,
                                             float* partial, int rows, int k_total, int ced,
                                             int tile_m, int k_chunk, int x_vec, int w_vec,
                                             cudaStream_t stream) {
  if (rows == 0 || ced == 0) return 0;
  if (k_chunk <= 0 || k_chunk % pg::kTileK != 0 || (tile_m != 128 && tile_m != 64))
    return static_cast<int>(cudaErrorInvalidValue);
  const int splits = (k_total + k_chunk - 1) / k_chunk;
  const ForwardArgs args{x, w, bias, out, partial, rows, k_total, ced, w_sk, w_sn, k_chunk};
  const cudaError_t err =
      tile_m == 128 ? launch_forward<4>(x_vec, w_vec, rows, ced, splits, stream, args)
                    : launch_forward<2>(x_vec, w_vec, rows, ced, splits, stream, args);
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
