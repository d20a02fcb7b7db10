// DyGFormer's frozen-channel patch projection:
//   out[r, :] = bias + x[r] @ W,  x[r] = the (patch, D) rows of patch r,
// reading x (M, Lp, D) row-major against W viewed (patch, D, ced).
//
// Forward: replaces dyglib_tpu/ops/pallas/patch_projection.py::_fwd_kernel.
// In a row-major layout patch r's (patch, D) block is one contiguous run of
// patch * D floats, so x is read in place as (rows, K = patch * D); no
// (M, P, patch * D) repack is ever written.
//
// Backward: replaces ::_bwd_kernel. dW = patches(x)^T @ dout and
// dbias = sum_r dout[r], as one product [x | 1]^T @ dout (x read in place
// again). No dx: x holds rows of the frozen feature tables.
//
// Both directions stream x once and are bound by its bytes on an H100
// (845 MB at CanParl, 0.254 ms); they run on the tensor cores with
// split-TF32 products that keep f32 accuracy, through a cp.async ring, with
// the reduction split so that the grid fills the card (patch_gemm.cuh has
// the design and the reasons). Partial sums are added in a fixed order:
// two runs give identical bits.
#include "patch_gemm.cuh"
#include "weight_grad.cuh"

namespace pg = dyglib::patch_gemm;

namespace {

// Launches kernel<<<grid, threads, smem bytes>>>(args) after raising its
// dynamic shared-memory limit; returns the error.
template <class Args>
cudaError_t launch(void (*kernel)(Args), dim3 grid, int threads, size_t smem,
                   cudaStream_t stream, const Args& args) {
  const cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (set != cudaSuccess) return set;
  kernel<<<grid, threads, smem, stream>>>(args);
  return cudaGetLastError();
}

template <int kWarps>
cudaError_t launch_forward(int x_vec, int w_vec, int rows, int ced, int splits,
                           cudaStream_t stream, const pg::ForwardArgs& args) {
  using T = pg::Tile<kWarps>;
  const dim3 grid((rows + T::kTileM - 1) / T::kTileM, (ced + pg::kTileN - 1) / pg::kTileN,
                  splits);
  const auto go = [&](auto kernel) {
    return launch(kernel, grid, T::kThreads, T::kFwdSmemBytes, stream, args);
  };
  if (x_vec == 4) {
    if (w_vec == 4) return go(pg::patch_forward_kernel<kWarps, 4, 4>);
    if (w_vec == 0) return go(pg::patch_forward_kernel<kWarps, 4, 0>);
    return go(pg::patch_forward_kernel<kWarps, 4, 1>);
  }
  if (w_vec == 4) return go(pg::patch_forward_kernel<kWarps, 1, 4>);
  if (w_vec == 0) return go(pg::patch_forward_kernel<kWarps, 1, 0>);
  return go(pg::patch_forward_kernel<kWarps, 1, 1>);
}

cudaError_t launch_backward(int x_vec, int d_vec, int out_rows, int ced, int chunks,
                            cudaStream_t stream, const pg::BackwardArgs& args) {
  constexpr int kWarps = 4;
  using T = pg::Tile<kWarps>;
  const dim3 grid((out_rows + T::kTileM - 1) / T::kTileM, (ced + pg::kTileN - 1) / pg::kTileN,
                  chunks);
  const auto go = [&](auto kernel) {
    return launch(kernel, grid, T::kThreads, T::kBwdSmemBytes, stream, args);
  };
  if (x_vec == 4)
    return d_vec >= 2 ? go(pg::patch_backward_kernel<kWarps, 4, 2>)
                      : go(pg::patch_backward_kernel<kWarps, 4, 1>);
  return d_vec >= 2 ? go(pg::patch_backward_kernel<kWarps, 1, 2>)
                    : go(pg::patch_backward_kernel<kWarps, 1, 1>);
}

}  // namespace

// x: (rows, k_total) f32; w: (k_total, ced) f32 with element strides
// (w_sk, w_sn); bias: (ced); out: (rows, ced). tile_m: rows of a block, 128
// or 64. k_chunk: K per split, a multiple of 32; with more than one split,
// partial holds (splits, rows, ced) f32. x_vec, w_vec: the widest copy the
// alignment allows, in floats (4, 2 or 1; the wrapper checks it); the
// kernels copy x and a K-major W 4 floats at a time where x_vec / w_vec is
// 4, else one. w_vec 0: a row-major W (w_sn == 1), staged transposed.
DYGLIB_API int patch_projection_forward(const float* x, const float* w, int w_sk, int w_sn,
                                        const float* bias, float* out, float* partial,
                                        int rows, int k_total, int ced, int tile_m,
                                        int k_chunk, int x_vec, int w_vec,
                                        cudaStream_t stream) {
  if (rows == 0 || ced == 0) return 0;
  if (k_chunk <= 0 || k_chunk % pg::kTileK != 0 || (tile_m != 128 && tile_m != 64))
    return static_cast<int>(cudaErrorInvalidValue);
  const int splits = (k_total + k_chunk - 1) / k_chunk;
  const pg::ForwardArgs args{x, w, bias, splits == 1 ? out : partial, rows, k_total, ced,
                             w_sk, w_sn, k_chunk};
  const cudaError_t err =
      tile_m == 128 ? launch_forward<4>(x_vec, w_vec, rows, ced, splits, stream, args)
                    : launch_forward<2>(x_vec, w_vec, rows, ced, splits, stream, args);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return static_cast<int>(pg::launch_sum_partials(partial, bias, out, splits,
                                                  static_cast<size_t>(rows) * ced, ced, stream));
}

// x: (rows, k_total) f32; dout: (rows, ced) f32; dw_ext: (k_total + 1, ced)
// f32, rows 0..k_total-1 = dW, row k_total = dbias; a block owns 128 K
// entries. chunk_rows: rows per partial sum, a multiple of 32;
// with more than one chunk, partial holds (chunks, k_total + 1, ced) f32.
// x_vec, d_vec: the widest copy the alignment allows (4, 2 or 1); x is
// copied 4 floats at a time or one, dout 2 or one.
DYGLIB_API int patch_projection_backward(const float* x, const float* dout, float* dw_ext,
                                         float* partial, int rows, int k_total, int ced,
                                         int chunk_rows, int x_vec, int d_vec,
                                         cudaStream_t stream) {
  if (ced == 0) return 0;
  const int out_rows = k_total + 1;
  if (rows == 0)
    return static_cast<int>(
        cudaMemsetAsync(dw_ext, 0, sizeof(float) * out_rows * static_cast<size_t>(ced), stream));
  if (chunk_rows <= 0 || chunk_rows % pg::kTileK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (rows + chunk_rows - 1) / chunk_rows;
  const pg::BackwardArgs args{x, dout, chunks == 1 ? dw_ext : partial, rows, k_total, ced,
                              chunk_rows};
  const cudaError_t err = launch_backward(x_vec, d_vec, out_rows, ced, chunks, stream, args);
  if (err != cudaSuccess || chunks == 1) return static_cast<int>(err);
  if (chunks <= pg::kMaxElementwisePartials)
    return static_cast<int>(pg::launch_sum_partials(
        partial, nullptr, dw_ext, chunks, static_cast<size_t>(out_rows) * ced, ced, stream));
  return static_cast<int>(
      dyglib::launch_strided_sum(partial, dw_ext, chunks, out_rows * ced, stream));
}
