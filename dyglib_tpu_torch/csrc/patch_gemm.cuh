// The patch projection's products on Hopper's tensor cores, f32-accurate:
//
//   forward   out (rows, ced)          = x (rows, K) @ W (K, ced) + bias
//   backward  dW_ext (K + 1, ced)      = [x | 1]^T @ dout (rows, ced)
//
// What bounds them on an H100. At CanParl (rows 19,200, K = 11,008,
// ced = 50) each direction streams x once: 845 MB, 0.254 ms at 3.35 TB/s.
// Its 21.1 G operations take 0.315 ms at the 67 T/s of the f32 CUDA
// cores, so no CUDA-core kernel reaches the memory floor; the tensor cores
// can. One TF32 product keeps ~11 bits of each operand and misses the
// port's 1e-4 agreement with f32 by ~9x at K = 11,008, so every operand is
// split, v = hi + lo with hi = tf32(v) (round to nearest) and lo = v - hi,
// which the tensor core truncates to TF32 (split_tf32 says how), and
// each product is lo*hi + hi*lo + hi*hi, accumulated in f32 small terms
// first (the lo*lo term is below f32's last bit); each stage's sum is
// added to the running one on the CUDA cores (multiply_stage says why).
// Three passes are 63 G tensor operations, 0.128 ms at 495 T/s: under the
// bytes floor, so the design's job is to keep x streaming.
//
// The design:
//   * mma.sync m16n8k8 TF32. Its fragments are loaded register by register
//     from shared memory, so one code path reads W in either layout and x
//     row-major in both directions (the backward reduces over x's slow
//     axis); wgmma would need K-major operands in its swizzled layouts.
//   * A block is 4 warps, 128 mma rows; the forward takes 2 warps, 64 rows,
//     where the wrapper's plan finds that they load the busiest SM less
//     (K = 172 at wikipedia: 300 blocks spread 19,200 rows more evenly
//     than 150). A warp owns 32 mma rows x all 56 columns (ced 50 padded to
//     seven n8 fragments with zeros in shared memory, never in device
//     memory): 56 f32 accumulators a thread, and each B fragment split
//     once serves two m16 fragments.
//   * The operands stream through a 4-stage ring of cp.async copies (three
//     stages in flight while one is multiplied): 16-byte copies where the
//     row stride and the address allow it, else 4 bytes (8 for dout), a
//     template argument that the entry point picks from the wrapper's
//     alignment check. Elements past the ragged edges (rows, K, ced)
//     are zero-filled by the copy itself (src-size 0 or short), so the
//     edges are masked in shared memory and nothing past them is read.
//   * Shared-memory row strides make each warp's fragment reads hit 32
//     distinct banks: 36 floats (= 4 mod 32) where a fragment's rows are
//     the lane group g and its columns the lane's t; 136 and 72 (= 8 mod
//     32) where the rows are t and the columns g.
//   * Waves: 19,200 rows are 150 tiles of 128 rows, 1.14 waves on 132 SMs.
//     The reduction is split instead (split-K in the forward, row chunks in
//     the backward), by the count the wrapper picks
//     (ops/_plan.py::best_plan): the one that least loads the
//     busiest SM, counting each unit's pipeline fill and the partial sums'
//     traffic. Two blocks of 106 KB fit an SM (three of 69 KB at 64
//     rows). Partial sums go to the wrapper's scratch and a second pass
//     adds them in a fixed order (one thread an output for a few partial
//     sums, adding the forward's bias once; weight_grad.cuh's
//     launch_strided_sum for many), so two runs give identical bits: no
//     atomics.
//   * The backward's ones column (dbias) is a constant 1 put into the A
//     fragment in registers; rows past a chunk's end have dout zero-filled,
//     so they add nothing.
#pragma once

#include <cstddef>

#include "common.cuh"

namespace dyglib {
namespace patch_gemm {

constexpr int kWarpM = 32;                // two m16 fragments a warp
constexpr int kTileN = 56;                // seven n8 fragments (ops/patch_projection.py TILE_N)
constexpr int kNFrag = kTileN / 8;
constexpr int kTileK = 32;                // reduction depth of one stage (TILE_K)
constexpr int kStages = 4;                // (STAGES)
constexpr int kFwdStride = kTileK + 4;    // x and W stages, [m or n][k]
constexpr int kBwdDStride = kTileN + 16;  // backward dout stage, [row][column]
static_assert(kFwdStride % 32 == 4 && kBwdDStride % 32 == 8, "conflict-free fragment reads");

// A block of kWarps warps owns kTileM = 32 kWarps mma rows (x rows in the
// forward, K entries in the backward): 128 or 64 (TILE_MS).
template <int kWarps>
struct Tile {
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kTileM = kWarpM * kWarps;
  static constexpr int kBwdXStride = kTileM + 8;  // backward x stage, [row][K entry]
  static constexpr int kFwdStageFloats = (kTileM + kTileN) * kFwdStride;
  static constexpr int kBwdStageFloats = kTileK * (kBwdXStride + kBwdDStride);
  // 105,984 and 106,496 bytes at 4 warps (two blocks an SM); the
  // forward's 69,120 at 2 (three)
  static constexpr size_t kFwdSmemBytes = sizeof(float) * kStages * kFwdStageFloats;
  static constexpr size_t kBwdSmemBytes = sizeof(float) * kStages * kBwdStageFloats;
  static_assert(kBwdXStride % 32 == 8, "conflict-free fragment reads");
};

// ---- asynchronous copies: global -> shared, zero-filling past src_bytes

template <int kBytes>
__device__ __forceinline__ void copy_async(float* dst, const float* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(src_bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src),
                 "n"(kBytes), "r"(src_bytes)
                 : "memory");
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// dst[r * kStride + c] = src[(r0 + r) * ld + c0 + c] for the kRows x kCols
// tile, kVec floats a copy by each of kThreads threads; zero at rows >=
// r_end or columns >= c_end.
template <int kThreads, int kRows, int kCols, int kStride, int kVec>
__device__ __forceinline__ void stage_tile(float* dst, const float* __restrict__ src, int ld,
                                           int r0, int r_end, int c0, int c_end) {
  constexpr int kPerRow = kCols / kVec;
  constexpr int kCopies = kRows * kPerRow;
  constexpr int kPer = (kCopies + kThreads - 1) / kThreads;
  // up to 8 copies a thread unrolled; more (one float a copy) in groups of
  // 4, so that their addresses do not all live in registers at once
  constexpr int kGroup = kPer > 8 ? 4 : kPer;
#pragma unroll 1
  for (int i0 = 0; i0 < kPer; i0 += kGroup) {
#pragma unroll
    for (int i = i0; i < i0 + kGroup; ++i) {
      const int e = threadIdx.x + i * kThreads;
      if (kCopies % (kThreads * kGroup) != 0 && e >= kCopies) break;
      const int r = e / kPerRow;
      const int c = (e % kPerRow) * kVec;
      const int gr = r0 + r, gc = c0 + c;
      const int n = gr < r_end ? min(max(c_end - gc, 0), kVec) : 0;
      const float* s = n > 0 ? src + static_cast<size_t>(gr) * ld + gc : src;
      copy_async<4 * kVec>(dst + r * kStride + c, s, 4 * n);
    }
  }
}

// dst[n * kStride + k] = src[(k0 + k) * ld + n0 + n]: a row-major (K, ced)
// W staged transposed, one float a copy, consecutive threads on
// consecutive columns; zero at columns >= n_end or k >= k_end.
template <int kThreads, int kRows, int kCols, int kStride>
__device__ __forceinline__ void stage_tile_transposed(float* dst, const float* __restrict__ src,
                                                      int ld, int n0, int n_end, int k0,
                                                      int k_end) {
  constexpr int kCopies = kRows * kCols;
  constexpr int kPer = (kCopies + kThreads - 1) / kThreads;
  constexpr int kGroup = kPer > 8 ? 4 : kPer;  // as in stage_tile
#pragma unroll 1
  for (int i0 = 0; i0 < kPer; i0 += kGroup) {
#pragma unroll
    for (int i = i0; i < i0 + kGroup; ++i) {
      const int e = threadIdx.x + i * kThreads;
      if (kCopies % (kThreads * kGroup) != 0 && e >= kCopies) break;
      const int k = e / kRows, n = e % kRows;
      const bool in = k0 + k < k_end && n0 + n < n_end;
      const float* s = in ? src + static_cast<size_t>(k0 + k) * ld + n0 + n : src;
      copy_async<4>(dst + n * kStride + k, s, in ? 4 : 0);
    }
  }
}

// ---- split-TF32 products

struct Split {
  unsigned hi, lo;
};

// hi = v rounded to TF32, to nearest with ties away from zero (what
// cvt.rna.tf32.f32 gives, in two integer operations at the full rate:
// half a TF32 ulp added to the magnitude bits, the 13 low bits cleared);
// lo = v - hi, exact in f32, whose low 13 bits the tensor core does not
// read (lo is truncated to TF32 there).
__device__ __forceinline__ Split split_tf32(float v) {
  const unsigned hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  return {hi, __float_as_uint(v - __uint_as_float(hi))};
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One stage's products for this warp over its first `depth` k (all
// kTileK by default; an 8-deep step that starts at or past depth is
// skipped), added to acc: kMF m16 blocks by kNF n8 blocks of mma tiles. The A fragment of m16 block mt
// holds (row g, col t), (g + 8, t), (g, t + 4), (g + 8, t + 4); the B
// fragment (row t, col g), (t + 4, g); g = lane / 4, t = lane % 4.
// a_at(mt, row, k) and b_at(nf, k, col) return shared-memory values. Each
// 8-deep step splits all its fragments first, then issues the kMF kNF
// lo*hi products, the kMF kNF hi*lo, the kMF kNF hi*hi (14 each for the
// patch projection's 2 x 7): independent products between two that chain
// on one accumulator.
// The tensor cores' f32 accumulation rounds toward zero, an error that
// grows with every add and always has the same sign; so a stage's 12
// products per output sum into fresh registers, and those are added to acc
// on the CUDA cores, rounded to nearest.
template <class AAt, class BAt, int kMF, int kNF>
__device__ __forceinline__ void multiply_stage(const AAt& a_at, const BAt& b_at,
                                               float (&acc)[kMF][kNF][4], int depth = kTileK) {
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  float part[kMF][kNF][4] = {};
#pragma unroll
  for (int kk = 0; kk < kTileK; kk += 8) {
    if (kk >= depth) break;
    unsigned a_hi[kMF][4], a_lo[kMF][4], b_hi[kNF][2], b_lo[kNF][2];
#pragma unroll
    for (int mt = 0; mt < kMF; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const Split s = split_tf32(a_at(mt, g + 8 * (i % 2), kk + t + 4 * (i / 2)));
        a_hi[mt][i] = s.hi, a_lo[mt][i] = s.lo;
      }
#pragma unroll
    for (int nf = 0; nf < kNF; ++nf)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const Split s = split_tf32(b_at(nf, kk + t + 4 * i, g));
        b_hi[nf][i] = s.hi, b_lo[nf][i] = s.lo;
      }
#pragma unroll
    for (int nf = 0; nf < kNF; ++nf)
#pragma unroll
      for (int mt = 0; mt < kMF; ++mt) mma_tf32(part[mt][nf], a_lo[mt], b_hi[nf][0], b_hi[nf][1]);
#pragma unroll
    for (int nf = 0; nf < kNF; ++nf)
#pragma unroll
      for (int mt = 0; mt < kMF; ++mt) mma_tf32(part[mt][nf], a_hi[mt], b_lo[nf][0], b_lo[nf][1]);
#pragma unroll
    for (int nf = 0; nf < kNF; ++nf)
#pragma unroll
      for (int mt = 0; mt < kMF; ++mt) mma_tf32(part[mt][nf], a_hi[mt], b_hi[nf][0], b_hi[nf][1]);
  }
#pragma unroll
  for (int mt = 0; mt < kMF; ++mt)
#pragma unroll
    for (int nf = 0; nf < kNF; ++nf)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nf][i] += part[mt][nf][i];
}

// Runs a ring of kRing stages over `tiles` stages: load(tile,
// stage_floats) issues one stage's copies, multiply(stage_floats) consumes
// it.
template <int kStageFloats, int kRing = kStages, class Load, class Multiply>
__device__ __forceinline__ void pipeline(float* smem, int tiles, const Load& load,
                                         const Multiply& multiply) {
#pragma unroll
  for (int s = 0; s < kRing - 1; ++s) {
    if (s < tiles) load(s, smem + s * kStageFloats);
    commit_copies();
  }
  for (int t = 0; t < tiles; ++t) {
    wait_copies<kRing - 2>();  // stage t has landed (this thread's copies)
    __syncthreads();           // ... and every thread's; stage t - 1 is consumed
    const int next = t + kRing - 1;
    if (next < tiles) load(next, smem + (next % kRing) * kStageFloats);
    commit_copies();
    multiply(smem + (t % kRing) * kStageFloats);
  }
  wait_copies<0>();
}

// Writes a warp's 32 x 56 accumulators to dst (row stride ld): rows
// row0 + ... below row_end, columns col0 + ... below col_end, plus
// add[column] when add is not null. The accumulator of (mt, nf) holds
// (row g, cols 2t, 2t + 1) and (row g + 8, the same cols).
__device__ __forceinline__ void store_tile(const float (&acc)[2][kNFrag][4], float* dst,
                                           size_t ld, int row0, int row_end, int col0,
                                           int col_end, const float* __restrict__ add) {
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row0 + mt * 16 + g + half * 8;
      if (r >= row_end) continue;
#pragma unroll
      for (int nf = 0; nf < kNFrag; ++nf)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = col0 + nf * 8 + 2 * t + j;
          if (c < col_end)
            dst[r * ld + c] = acc[mt][nf][half * 2 + j] + (add != nullptr ? add[c] : 0.f);
        }
    }
}

// ---- forward: grid (row tiles, column tiles, K splits)

struct ForwardArgs {
  const float* x;     // (rows, k_total) row-major
  const float* w;     // (k_total, ced) at w[k * w_sk + c * w_sn]
  const float* bias;  // (ced)
  float* dst;         // out (rows, ced) with one split, else partial (splits, rows, ced)
  int rows, k_total, ced, w_sk, w_sn;
  int k_chunk;        // K per split, a multiple of kTileK
};

// kXVec: floats per copy of x (4 or 1). kWVec: of a K-major W (w_sk == 1),
// 4 or 1; 0 for a row-major W (w_sn == 1), staged transposed.
template <int kWarps, int kXVec, int kWVec>
__global__ void __launch_bounds__(Tile<kWarps>::kThreads)
    patch_forward_kernel(const ForwardArgs a) {
  using T = Tile<kWarps>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int m0 = blockIdx.x * T::kTileM, n0 = blockIdx.y * kTileN;
  const int k_begin = blockIdx.z * a.k_chunk;
  const int k_end = min(a.k_total, k_begin + a.k_chunk);
  const int tiles = (k_end - k_begin + kTileK - 1) / kTileK;
  const int warp_m = (threadIdx.x / 32) * kWarpM;

  const auto load = [&](int tile, float* stage) {
    const int k0 = k_begin + tile * kTileK;
    stage_tile<T::kThreads, T::kTileM, kTileK, kFwdStride, kXVec>(stage, a.x, a.k_total, m0,
                                                                   a.rows, k0, k_end);
    float* ws = stage + T::kTileM * kFwdStride;
    if constexpr (kWVec == 0)
      stage_tile_transposed<T::kThreads, kTileN, kTileK, kFwdStride>(ws, a.w, a.w_sk, n0, a.ced,
                                                                      k0, k_end);
    else
      stage_tile<T::kThreads, kTileN, kTileK, kFwdStride, kWVec>(ws, a.w, a.w_sn, n0, a.ced, k0,
                                                                  k_end);
  };
  float acc[2][kNFrag][4] = {};
  const auto multiply = [&](const float* stage) {
    const float* xs = stage + warp_m * kFwdStride;
    const float* ws = stage + T::kTileM * kFwdStride;
    multiply_stage(
        [&](int mt, int r, int k) { return xs[(mt * 16 + r) * kFwdStride + k]; },
        [&](int nf, int k, int c) { return ws[(nf * 8 + c) * kFwdStride + k]; }, acc);
  };
  pipeline<T::kFwdStageFloats>(smem, tiles, load, multiply);

  // one split: the output itself, bias added here; else this split's partial
  float* dst = a.dst + static_cast<size_t>(blockIdx.z) * a.rows * a.ced;
  store_tile(acc, dst, a.ced, m0 + warp_m, a.rows, n0, a.ced, gridDim.z == 1 ? a.bias : nullptr);
}

// out[i] = partial[0][i] + partial[1][i] + ... (in that order) + bias[i %
// ced] where bias is not null: the second pass of a reduction split into a
// few partial sums, each output read in one thread.
__global__ void __launch_bounds__(256)
    sum_partials_kernel(const float* __restrict__ partial, const float* __restrict__ bias,
                        float* __restrict__ out, int count, size_t n, int ced) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float s = partial[i];
    for (int z = 1; z < count; ++z) s += partial[z * n + i];
    out[i] = bias != nullptr ? s + bias[i % ced] : s;
  }
}

// Up to this many partial sums, sum_partials_kernel adds them; more go to
// weight_grad.cuh's launch_strided_sum, which spreads each output's sum
// over 32 threads.
constexpr int kMaxElementwisePartials = 8;

inline cudaError_t launch_sum_partials(const float* partial, const float* bias, float* out,
                                       int count, size_t n, int ced, cudaStream_t stream) {
  const int blocks = static_cast<int>(n < 4096 * 256 ? (n + 255) / 256 : 4096);
  sum_partials_kernel<<<blocks, 256, 0, stream>>>(partial, bias, out, count, n, ced);
  return cudaGetLastError();
}

// ---- backward: grid (K + 1 tiles, column tiles, row chunks)

struct BackwardArgs {
  const float* x;     // (rows, k_total) row-major
  const float* dout;  // (rows, ced) row-major
  float* dst;         // dw_ext (k_total + 1, ced) with one chunk, else partial
  int rows, k_total, ced, chunk_rows;  // chunk_rows a multiple of kTileK
};

template <int kWarps, bool kOnes>
__device__ __forceinline__ void backward_stage(const float* stage, int warp_m, int m_base,
                                               int k_total, float (&acc)[2][kNFrag][4]) {
  using T = Tile<kWarps>;
  const float* xs = stage + warp_m;
  const float* ds = stage + kTileK * T::kBwdXStride;
  multiply_stage(
      [&](int mt, int m, int r) {
        const int col = mt * 16 + m;
        if (kOnes && m_base + col == k_total) return 1.f;
        return xs[r * T::kBwdXStride + col];
      },
      [&](int nf, int r, int c) { return ds[r * kBwdDStride + nf * 8 + c]; }, acc);
}

// kXVec: floats per copy of x (4 or 1); kDVec: of dout (2 or 1).
template <int kWarps, int kXVec, int kDVec>
__global__ void __launch_bounds__(Tile<kWarps>::kThreads)
    patch_backward_kernel(const BackwardArgs a) {
  using T = Tile<kWarps>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int m0 = blockIdx.x * T::kTileM, n0 = blockIdx.y * kTileN;
  const int r_begin = blockIdx.z * a.chunk_rows;
  const int r_end = min(a.rows, r_begin + a.chunk_rows);
  const int tiles = (r_end - r_begin + kTileK - 1) / kTileK;
  const int warp_m = (threadIdx.x / 32) * kWarpM;
  const bool ones = m0 + T::kTileM > a.k_total;  // this tile holds the dbias row

  const auto load = [&](int tile, float* stage) {
    const int r0 = r_begin + tile * kTileK;
    stage_tile<T::kThreads, kTileK, T::kTileM, T::kBwdXStride, kXVec>(stage, a.x, a.k_total, r0,
                                                                      r_end, m0, a.k_total);
    stage_tile<T::kThreads, kTileK, kTileN, kBwdDStride, kDVec>(
        stage + kTileK * T::kBwdXStride, a.dout, a.ced, r0, r_end, n0, a.ced);
  };
  float acc[2][kNFrag][4] = {};
  const auto multiply = [&](const float* stage) {
    if (ones)
      backward_stage<kWarps, true>(stage, warp_m, m0 + warp_m, a.k_total, acc);
    else
      backward_stage<kWarps, false>(stage, warp_m, m0 + warp_m, a.k_total, acc);
  };
  pipeline<T::kBwdStageFloats>(smem, tiles, load, multiply);

  const int out_rows = a.k_total + 1;
  float* dst = a.dst + static_cast<size_t>(blockIdx.z) * out_rows * a.ced;
  store_tile(acc, dst, a.ced, m0 + warp_m, out_rows, n0, a.ced, nullptr);
}

}  // namespace patch_gemm
}  // namespace dyglib
