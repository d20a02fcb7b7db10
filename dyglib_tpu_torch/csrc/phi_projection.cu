// TGAT's fused time-feature projection:
//   out[r, :] = sum_f cos(dt[r] * tw[f] + tb[f]) * w[f, :]
// for dt (rows), tw, tb (dt_dim) and w (dt_dim, dq): the time channel at
// patch 1 with no mask and no bias.
//
// Forward: replaces dyglib_tpu/ops/pallas/phi_projection.py::_fwd_kernel.
// What bounds it on an H100 at TGAT's layer 1, hop 1 (240,000 rows, Dt =
// 100, Dq = 272): its 261 MB of output take 0.078 ms at 3.35 TB/s; its
// product, 13.1 G operations, 0.196 ms on the f32 CUDA cores, runs here on
// the tensor cores in split TF32 as the time channel's (patch_gemm.cuh:
// every operand v = hi + lo, hi = tf32(v), three mma.sync passes lo*hi,
// hi*lo, hi*hi, f32 sums): 39.2 G operations, 0.079 ms at 495 T/s. One
// TF32 pass would miss the port's 1e-4 agreement
// (tests/test_torch_phi_projection.py).
// The design: each cosine is computed once a launch. A warp owns an m16
// tile of rows (16) and the accumulators of every column of its block's
// column group (up to kMaxTiles tiles of 56: Dq 272 is five, 140
// accumulators a thread; a kernel with one tile's, 84 registers, serves
// one-tile groups), and walks the whole depth, Dt padded to dt_pad,
// a multiple of 8, one mma k-step at a time: it computes the 16 x 8 Phi
// elements of the step's A fragment (4 a thread, cos_reduced.cuh's
// cosine: cosf's bits, no slow path), splits them, and multiplies them
// into every column; the next row tile follows. Its accumulators are one
// fresh sum over the whole depth (3 dt_pad / 8 tensor-core adds, 39 at Dt
// = 100: the adds round toward zero, which the depth keeps small) and are
// stored once, a pair of columns a lane. W is staged whole in shared
// memory once a block, its columns [n][k] with each 8-deep k-step's
// features t, t + 4 side by side (one 8-byte load gives a lane both
// halves of its B fragment) and a row stride that is an odd multiple of 8
// floats (those loads hit distinct banks), zero past dt_dim and dq, so
// the padded Phi elements multiply zeros. Blocks are persistent: a grid
// of row walkers (about one block an SM) and column groups, from the
// wrapper's plan (ops/phi_projection.py::forward_plan); where too few row
// tiles would leave SMs idle (R = 12,000) it gives each column tile a
// group of its own and each warp one row tile, and each group computes
// its rows' cosines again. Every output is one warp's sum in a fixed
// order: two runs give identical bits.
//
// Backward: replaces ::_bwd_kernel. dw = Phi^T @ dout and, through dPhi =
// dout @ w^T and -sin(theta), dtw and dtb: the time channel's backward
// kernel without its mask and dbias (time_channel_bwd.cuh): one
// split-TF32 kernel for both products, Phi and -sin from one reduction,
// then the row chunks' dw and the dtw, dtb partial sums in a fixed order.
// Its 78.3 G tensor operations take 0.158 ms at 495 T/s, its 261 MB of
// dout 0.078 ms. dt gets no gradient.
#include "cos_reduced.cuh"
#include "patch_gemm.cuh"
#include "phi.cuh"
#include "time_channel_bwd.cuh"

namespace pg = dyglib::patch_gemm;

namespace {

constexpr int kFwdWarps = 8;
constexpr int kFwdThreads = 32 * kFwdWarps;
constexpr int kMaxTiles = 5;  // column tiles of accumulators a warp holds
constexpr int kMaxSmemBytes = 232448;

struct ForwardArgs {
  const float* dt;  // (rows)
  const float* tw;  // (dt_dim)
  const float* tb;  // (dt_dim)
  const float* w;   // (dt_dim, dq) at w[k * w_sk + c * w_sn]
  float* out;       // (rows, dq)
  int rows, dt_dim, dt_pad, dq, w_sk, w_sn;
  int w_stride;     // shared-memory floats a column of W: >= dt_pad, an odd multiple of 8
  int tiles;        // column tiles a group, at most the kernel's kTiles
};

// W's shared-memory position of feature k within its column: an 8-deep
// k-step's features t and t + 4 (t < 4) at 2t and 2t + 1.
__device__ __forceinline__ int permuted(int k) {
  return (k & ~7) | ((k & 3) << 1) | ((k >> 2) & 1);
}

// grid (row walkers, column groups of a.tiles tiles); dynamic shared
// memory: W's group columns, then tw and tb padded to dt_pad with zeros.
// kTiles: the column tiles of accumulators a thread holds.
template <int kTiles>
__global__ void __launch_bounds__(kFwdThreads, 1) phi_fwd_kernel(const ForwardArgs a) {
  const int cols = a.tiles * pg::kTileN;
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);  // (cols, w_stride)
  float* tw_s = w_s + cols * a.w_stride;
  float* tb_s = tw_s + a.dt_pad;
  const int n0 = blockIdx.y * cols;
  const int staged = cols * a.dt_pad;
  if (a.w_sk == 1) {  // each column's features contiguous: consecutive threads along k
    for (int i = threadIdx.x; i < staged; i += kFwdThreads) {
      const int n = i / a.dt_pad, k = i - n * a.dt_pad;
      const bool in = k < a.dt_dim && n0 + n < a.dq;
      w_s[n * a.w_stride + permuted(k)] =
          in ? __ldg(a.w + k + static_cast<size_t>(n0 + n) * a.w_sn) : 0.f;
    }
  } else {  // rows contiguous: along columns
    for (int i = threadIdx.x; i < staged; i += kFwdThreads) {
      const int k = i / cols, n = i - k * cols;
      const bool in = k < a.dt_dim && n0 + n < a.dq;
      w_s[n * a.w_stride + permuted(k)] =
          in ? __ldg(a.w + static_cast<size_t>(k) * a.w_sk + n0 + n) : 0.f;
    }
  }
  for (int f = threadIdx.x; f < a.dt_pad; f += kFwdThreads) {
    tw_s[f] = f < a.dt_dim ? a.tw[f] : 0.f;
    tb_s[f] = f < a.dt_dim ? a.tb[f] : 0.f;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int tiles = min(a.tiles, (a.dq - n0 + pg::kTileN - 1) / pg::kTileN);
  const int m_tiles = (a.rows + 15) / 16;
  const int steps = a.dt_pad / 8;
  const int frag_stride = 8 * a.w_stride;          // floats from one n8 fragment to the next
  const float* wg = w_s + g * a.w_stride + 2 * t;  // the lane's column g, features t, t + 4
  const bool pairs = a.dq % 2 == 0;                // 8-byte output stores
  for (int mt = blockIdx.x * kFwdWarps + warp; mt < m_tiles; mt += gridDim.x * kFwdWarps) {
    const int r0 = 16 * mt + g;  // and r0 + 8
    const float d0 = r0 < a.rows ? __ldg(a.dt + r0) : 0.f;
    const float d1 = r0 + 8 < a.rows ? __ldg(a.dt + r0 + 8) : 0.f;
    float acc[kTiles][pg::kNFrag][4] = {};
#pragma unroll 1
    for (int s = 0; s < steps; ++s) {
      // the A fragment's Phi: (row g, feature t), (g + 8, t), (g, t + 4),
      // (g + 8, t + 4); past dt_dim tw, tb are 0 and W's rows zero
      const int f = 8 * s + t;
      const float tw0 = tw_s[f], tb0 = tb_s[f], tw1 = tw_s[f + 4], tb1 = tb_s[f + 4];
      const float x[4] = {dyglib::theta_of(d0, tw0, tb0), dyglib::theta_of(d1, tw0, tb0),
                          dyglib::theta_of(d0, tw1, tb1), dyglib::theta_of(d1, tw1, tb1)};
      float phi[4];
      dyglib::cos_reduced<4>(x, phi);
      unsigned a_hi[4], a_lo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const pg::Split sp = pg::split_tf32(phi[i]);
        a_hi[i] = sp.hi, a_lo[i] = sp.lo;
      }
      const float* ws = wg + 8 * s;
#pragma unroll
      for (int ct = 0; ct < kTiles; ++ct) {
        if (ct >= tiles) break;  // the group's last tile (warp-uniform)
        // one column tile: its seven B fragments split, then 7 lo*hi, 7
        // hi*lo, 7 hi*hi (independent products between two that chain)
        pg::Split b[pg::kNFrag][2];
#pragma unroll
        for (int nf = 0; nf < pg::kNFrag; ++nf) {
          const float2 v =
              *reinterpret_cast<const float2*>(ws + (ct * pg::kNFrag + nf) * frag_stride);
          b[nf][0] = pg::split_tf32(v.x), b[nf][1] = pg::split_tf32(v.y);
        }
#pragma unroll
        for (int nf = 0; nf < pg::kNFrag; ++nf)
          pg::mma_tf32(acc[ct][nf], a_lo, b[nf][0].hi, b[nf][1].hi);
#pragma unroll
        for (int nf = 0; nf < pg::kNFrag; ++nf)
          pg::mma_tf32(acc[ct][nf], a_hi, b[nf][0].lo, b[nf][1].lo);
#pragma unroll
        for (int nf = 0; nf < pg::kNFrag; ++nf)
          pg::mma_tf32(acc[ct][nf], a_hi, b[nf][0].hi, b[nf][1].hi);
      }
    }
    // accumulator (ct, nf) holds (row g, columns 2t, 2t + 1), then row g + 8
#pragma unroll
    for (int ct = 0; ct < kTiles; ++ct) {
      if (ct >= tiles) break;
#pragma unroll
      for (int nf = 0; nf < pg::kNFrag; ++nf) {
        const int c = n0 + (ct * pg::kNFrag + nf) * 8 + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + 8 * h;
          if (r >= a.rows || c >= a.dq) continue;
          float* o = a.out + static_cast<size_t>(r) * a.dq + c;
          if (pairs) {
            *reinterpret_cast<float2*>(o) = make_float2(acc[ct][nf][2 * h], acc[ct][nf][2 * h + 1]);
          } else {
            o[0] = acc[ct][nf][2 * h];
            if (c + 1 < a.dq) o[1] = acc[ct][nf][2 * h + 1];
          }
        }
      }
    }
  }
}

// One launch of phi_fwd_kernel<kTiles>; it may take up to the card's
// 232,448 bytes of shared memory, opted in once, at its first launch
// (outside any CUDA-graph capture that replays it later).
template <int kTiles>
cudaError_t launch_forward(dim3 grid, size_t smem, const ForwardArgs& args,
                           cudaStream_t stream) {
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      phi_fwd_kernel<kTiles>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes);
  if (opt_in != cudaSuccess) return opt_in;
  phi_fwd_kernel<kTiles><<<grid, kFwdThreads, smem, stream>>>(args);
  return cudaGetLastError();
}

}  // namespace

// dt: (rows) f32; tw, tb: (dt_dim) f32; w: (dt_dim, dq) f32 with element
// strides (w_sk, w_sn), one of them 1; out: (rows, dq) f32. dt_pad: dt_dim
// rounded up to a multiple of 8; w_stride: dt_pad rounded up to an odd
// multiple of 8. The plan (ops/phi_projection.py::forward_plan): `tiles`
// column tiles of 56 a group (1 to 5), `row_blocks` blocks a group.
// One-tile groups take the kernel with one tile's accumulators, the rest
// the one with kMaxTiles'.
DYGLIB_API int phi_projection_forward(const float* dt, const float* tw, const float* tb,
                                      const float* w, int w_sk, int w_sn, float* out, int rows,
                                      int dt_dim, int dt_pad, int w_stride, int dq, int tiles,
                                      int row_blocks, cudaStream_t stream) {
  if (rows == 0 || dq == 0) return 0;
  if (dt_pad < dt_dim || dt_pad % 8 != 0 || w_stride < dt_pad || w_stride % 16 != 8 ||
      tiles < 1 || tiles > kMaxTiles || row_blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int groups = (dq + tiles * pg::kTileN - 1) / (tiles * pg::kTileN);
  const size_t smem = sizeof(float) * (static_cast<size_t>(tiles) * pg::kTileN * w_stride +
                                       2 * static_cast<size_t>(dt_pad));
  if (smem > static_cast<size_t>(kMaxSmemBytes)) return static_cast<int>(cudaErrorInvalidValue);
  const ForwardArgs args{dt, tw, tb, w, out, rows, dt_dim, dt_pad, dq, w_sk, w_sn, w_stride,
                         tiles};
  const dim3 grid(row_blocks, groups);
  return static_cast<int>(tiles == 1 ? launch_forward<1>(grid, smem, args, stream)
                                     : launch_forward<kMaxTiles>(grid, smem, args, stream));
}

// As the forward, plus dout: (rows, dq) f32. Outputs: dw (dt_dim, dq) f32;
// dt_grads (2, dt_dim) f32: dtw, then dtb. chunk_rows: rows per partial
// sum, a multiple of 32; with more than one chunk, partial holds (chunks,
// dt_dim, dq) f32. part: (chunks * ceil(dq / 56), 2, dt_dim) f32. d_vec:
// floats per copy of dout (2 or 1). Blocks of 7 warps (112 padded entries:
// Dt = 100 is 104) ran 5-10% faster than the time channel's 8 (PERF.md).
DYGLIB_API int phi_projection_backward(const float* dt, const float* tw, const float* tb,
                                       const float* w, int w_sk, int w_sn, const float* dout,
                                       float* dw, float* dt_grads, float* partial, float* part,
                                       int rows, int dt_dim, int dt_pad, int dq, int chunk_rows,
                                       int d_vec, cudaStream_t stream) {
  const dyglib::time_bwd::Args args{dt,   nullptr, tw,     tb,     w,  dout, nullptr, nullptr,
                                    rows, 1,       dt_dim, dt_pad, dq, w_sk, w_sn,    chunk_rows};
  return static_cast<int>(dyglib::time_bwd::backward<false, 7>(
      args, dw, dt_grads, partial, part, d_vec, stream));
}
