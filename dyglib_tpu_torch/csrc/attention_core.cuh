// Single-query temporal attention over K neighbors, forward; the core of
// TGAT's attention kernels (temporal_attention.cu, gathered_attention.cu,
// window_attention.cu). For query m with projected query q3[m] (heads
// flattened, dq = heads * hd) and kv rows r = m * K + j (j < K), staged by
// the kernel's loader:
//   key = kv @ Wk, val = kv @ Wv                            (dq wide)
//   logit[h, j] = (q3_h[m] . key_h[r]) * scale, or -1e10 where mask[r] == 0
//   w[h, j] = softmax_j(logit[h]) * keep[m, h, j]           (-> scores)
//   out[m, h * hd + d] = sum_j w[h, j] * val[r, h * hd + d]
//
// Replaces the _fwd_kernels of dyglib_tpu/ops/pallas/{temporal,gathered,
// window}_attention.py. Those project every kv row into key and val: at
// TGAT's layer 1, hop 1 (240,000 kv rows of 444, Dq = 272) 116 G
// operations. Reassociated, as attention_bwd.cuh computes the backward, the
// same function never projects a kv row. With Wk_h, Wv_h the head-h columns:
//
//   qk[m, h] = Wk_h q3_h[m]                                  (kv_dim)
//   logit[h, j] = kv[r] . qk[m, h] * scale
//   Av[m, h] = sum_j w[h, j] kv[r],   out_h[m] = Av[m, h] Wv_h
//
// about 6.7 G operations at hop 1, where the ~330 MB of kv rows read are
// the bound. Three launches, in order, on the caller's stream:
//   1. head_project_kernel: qk (the split-TF32 tensor-core tile,
//      head_gemm.cuh);
//   2. attention_query_kernel: one block per query stages its K kv rows
//      once, through the loader (asynchronous copies all in flight
//      together, 16 bytes each where the widths allow; each Phi cosine
//      computed once while they land; the window mask applied in shared
//      memory), and its qk rows; then the logits (one warp per
//      (head, neighbor), lanes over columns, a fixed butterfly), mask,
//      softmax and keep (one thread per head; the scores where asked), and
//      Av (one thread per (head, column), neighbors in order);
//   3. head_combine_kernel: out = Av Wv_h (the tile).
// Every sum has a fixed order and there are no atomics: two runs give
// bit-identical outputs. The per-head products run on the tensor cores in
// split TF32 (f32-accurate), the query kernel in f32 on the CUDA cores.
// The pad logit is -1e10, not -inf: an all-padded row attends uniformly,
// as the plain version does.
//
// The two per-head products serve the backward too (attention_bwd.cuh).
#pragma once

#include <cstdint>

#include "cos_reduced.cuh"
#include "head_gemm.cuh"
#include "patch_gemm.cuh"
#include "phi.cuh"

namespace dyglib {

constexpr float kPadLogit = -1e10f;
constexpr int kQueryThreads = 256;
constexpr int kQueryWarps = kQueryThreads / 32;

// One per-head product over the queries: x, W (kv_dim, dq) at
// w[c * sk + col * sn], into out.
struct HeadOperand {
  const float* __restrict__ x;
  const float* __restrict__ w;
  int sk;
  int sn;
  float* __restrict__ out;
};

// blockIdx.z = which * heads + h, over a (which 0) and b (which 1); a grid
// of heads z-blocks computes a alone. x (m, dq) ->
// out[(r * heads + h) * kv_dim + c] = sum_d x[r, h hd + d] W[c, h hd + d]
// (head_gemm.cuh: 32 kWarpsM rows and 56 columns a block).
template <int kWarpsM, int kVec>
__global__ void __launch_bounds__(128)
    head_project_kernel(HeadOperand a, HeadOperand b, int m, int kv_dim, int dq, int heads) {
  namespace hg = head_gemm;
  extern __shared__ float4 head_smem[];
  float* smem = reinterpret_cast<float*>(head_smem);
  const int which = blockIdx.z / heads;
  const int h = blockIdx.z - which * heads;
  const HeadOperand p = which ? b : a;
  const int hd = dq / heads;
  const int row0 = blockIdx.x * 32 * kWarpsM;
  const int col0 = blockIdx.y * 8 * hg::kProjectNF;
  const hg::Operand x{p.x + h * hd, dq};
  float* out = p.out + static_cast<size_t>(h) * kv_dim;
  const size_t ld = static_cast<size_t>(heads) * kv_dim;
  // B(d, c) = W[c sk + (h hd + d) sn]: d fast in W's rows (sn 1), c fast in
  // nn.Linear's transposed weight (sk 1)
  if (p.sn == 1)
    hg::product<kWarpsM, hg::kProjectNF, true, true, kVec>(
        smem, x, m, {p.w + h * hd, p.sk}, kv_dim, 0, hd, row0, col0, out, ld);
  else
    hg::product<kWarpsM, hg::kProjectNF, true, false, kVec>(
        smem, x, m, {p.w + static_cast<size_t>(h) * hd * p.sn, p.sn}, kv_dim, 0, hd, row0, col0,
        out, ld);
}

// blockIdx.z = h: x (m, heads, kv_dim) ->
// out[r, h hd + d] = sum_c x[r, h, c] W[c, h hd + d], out (m, dq)
// (head_gemm.cuh: 32 kWarpsM rows and 72 columns a block).
template <int kWarpsM, int kVec>
__global__ void __launch_bounds__(128)
    head_combine_kernel(HeadOperand p, int m, int kv_dim, int dq, int heads) {
  namespace hg = head_gemm;
  extern __shared__ float4 head_smem[];
  float* smem = reinterpret_cast<float*>(head_smem);
  const int h = blockIdx.z;
  const int hd = dq / heads;
  const int row0 = blockIdx.x * 32 * kWarpsM;
  const int col0 = blockIdx.y * 8 * hg::kHeadNF;
  const hg::Operand x{p.x + static_cast<size_t>(h) * kv_dim, heads * kv_dim};
  const float* w = p.w + static_cast<size_t>(h) * hd * p.sn;
  // B(c, d) = W[c sk + (h hd + d) sn]: c fast in nn.Linear's transposed
  // weight (sk 1), d fast in W's rows (sn 1)
  if (p.sk == 1)
    hg::product<kWarpsM, hg::kHeadNF, true, true, kVec>(smem, x, m, {w, p.sn}, hd, 0, kv_dim,
                                                        row0, col0, p.out + h * hd, dq);
  else
    hg::product<kWarpsM, hg::kHeadNF, true, false, kVec>(smem, x, m, {w, p.sk}, hd, 0, kv_dim,
                                                         row0, col0, p.out + h * hd, dq);
}

// Launch head_project_kernel over a and, where b.x is not null, b, in
// blocks of `rows` rows.
inline cudaError_t launch_head_project(const HeadOperand& a, const HeadOperand& b, int m,
                                       int kv_dim, int dq, int heads, int rows,
                                       cudaStream_t stream) {
  const int hd = dq / heads;
  const int z = (b.x != nullptr ? 2 : 1) * heads;
  const bool vec = head_gemm::vector_copies(kv_dim, hd, {a.x, a.w, b.x, b.w});
  return head_gemm::dispatch(rows, vec, [&](auto warps, auto v) {
    constexpr int kW = decltype(warps)::value, kV = decltype(v)::value;
    const dim3 grid((m + 32 * kW - 1) / (32 * kW),
                    (kv_dim + 8 * head_gemm::kProjectNF - 1) / (8 * head_gemm::kProjectNF), z);
    return head_gemm::launch<head_project_kernel<kW, kV>>(
        grid, head_gemm::smem_bytes<kW, head_gemm::kProjectNF, true>(), stream, a, b, m, kv_dim,
        dq, heads);
  });
}

// Launch head_combine_kernel in blocks of `rows` rows.
inline cudaError_t launch_head_combine(const HeadOperand& p, int m, int kv_dim, int dq, int heads,
                                       int rows, cudaStream_t stream) {
  const int hd = dq / heads;
  const bool vec = head_gemm::vector_copies(kv_dim, hd, {p.x, p.w});
  return head_gemm::dispatch(rows, vec, [&](auto warps, auto v) {
    constexpr int kW = decltype(warps)::value, kV = decltype(v)::value;
    const dim3 grid((m + 32 * kW - 1) / (32 * kW),
                    (hd + 8 * head_gemm::kHeadNF - 1) / (8 * head_gemm::kHeadNF), heads);
    return head_gemm::launch<head_combine_kernel<kW, kV>>(
        grid, head_gemm::smem_bytes<kW, head_gemm::kHeadNF, true>(), stream, p, m, kv_dim, dq,
        heads);
  });
}

// dst[j * ld + c] = src[j * w + c] for rows x w floats, by asynchronous
// copies of all the block's threads (16 bytes where the widths and both
// addresses allow, else 4); with `scale`, a row whose scale is 0 is not
// read and lands as zeros (rescale_rows applies other scales). The caller
// commits and waits.
__device__ __forceinline__ void copy_rows_async(float* dst, int ld, const float* __restrict__ src,
                                                int rows, int w,
                                                const float* __restrict__ scale = nullptr) {
  const bool vec = w % 4 == 0 && ld % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) & 15) == 0;
  if (vec) {
    const int w4 = w / 4;
    for (int e = threadIdx.x; e < rows * w4; e += blockDim.x) {
      const int j = e / w4;
      const bool in = scale == nullptr || __ldg(scale + j) != 0.f;
      patch_gemm::copy_async<16>(dst + j * ld + 4 * (e - j * w4), in ? src + 4 * e : src,
                                 in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < rows * w; e += blockDim.x) {
      const int j = e / w;
      const bool in = scale == nullptr || __ldg(scale + j) != 0.f;
      patch_gemm::copy_async<4>(dst + j * ld + e - j * w, in ? src + e : src, in ? 4 : 0);
    }
  }
}

// After copy_rows_async with `scale` and a barrier: rows whose scale is
// neither 0 nor 1 multiplied by it (one warp a row; a row of scale 1 is
// itself, one of scale 0 landed as zeros). The caller synchronizes after
// it.
__device__ __forceinline__ void rescale_rows(float* dst, int ld, int rows, int w,
                                             const float* __restrict__ scale) {
  for (int j = threadIdx.x / 32; j < rows; j += blockDim.x / 32) {
    const float s = __ldg(scale + j);
    if (s == 0.f || s == 1.f) continue;
    for (int c = threadIdx.x % 32; c < w; c += 32) dst[j * ld + c] *= s;
  }
}

// The Phi columns of `rows` kv rows into shared memory at row stride ld:
// dst[j * ld + f] = cos(theta(dt[j], tw[f], tb[f])), each cosine once, by
// cos_reduced.cuh (cosf's bits without its slow path: dt reaches ~2.6e6).
// With msin (the backward), also msin[j * dt_dim + f] = -sin(theta) from
// the same reduction. A warp takes kPhiPer arguments a lane at a time and
// one path for them all, so every loop trip is warp-uniform.
constexpr int kPhiPer = 4;

__device__ __forceinline__ void stage_phi(float* dst, int ld, const float* __restrict__ dt,
                                          const float* __restrict__ tw,
                                          const float* __restrict__ tb, int rows, int dt_dim,
                                          float* msin = nullptr) {
  const int n = rows * dt_dim;
  const int lane = threadIdx.x % 32;
  for (int base = (threadIdx.x - lane) * kPhiPer; base < n; base += blockDim.x * kPhiPer) {
    float x[kPhiPer], c[kPhiPer], s[kPhiPer];
    int e = base + lane;
    int j = e / dt_dim, f = e - j * dt_dim;
    int js[kPhiPer], fs[kPhiPer];
#pragma unroll
    for (int i = 0; i < kPhiPer; ++i) {
      js[i] = j, fs[i] = f;
      x[i] = e < n ? theta_of(__ldg(dt + j), __ldg(tw + f), __ldg(tb + f)) : 0.f;
      e += 32, f += 32;
      while (f >= dt_dim) f -= dt_dim, ++j;
    }
    if (msin != nullptr)
      sincos_reduced<kPhiPer>(x, c, s);
    else
      cos_reduced<kPhiPer>(x, c);
#pragma unroll
    for (int i = 0; i < kPhiPer; ++i) {
      if (base + lane + 32 * i >= n) continue;
      dst[js[i] * ld + fs[i]] = c[i];
      if (msin != nullptr) msin[js[i] * dt_dim + fs[i]] = s[i];
    }
  }
}

struct AttentionParams {
  const float* __restrict__ q3;    // (m, dq)
  const float* __restrict__ mask;  // (m, k) f32, 1 = real neighbor
  const float* __restrict__ keep;  // (m, heads, k) f32 dropout keep, pre-scaled
  const float* __restrict__ wk;    // (kv_dim, dq) at wk[c * wk_sk + col * wk_sn]
  int wk_sk;
  int wk_sn;
  const float* __restrict__ wv;    // (kv_dim, dq) at wv[c * wv_sk + col * wv_sn]
  int wv_sk;
  int wv_sn;
  float* __restrict__ qk;          // scratch (m, heads, kv_dim), and av
  float* __restrict__ av;
  float* __restrict__ out;         // (m, dq)
  float* __restrict__ scores;      // (m, heads, k), or null
  int m;
  int k;
  int kv_dim;
  int dq;
  int heads;
  float scale;                     // (dq / heads) ** -0.5
  int project_rows;                // rows a block of head_project and head_combine takes
  int combine_rows;                // (ops/_plan.py::head_plan)
};

// AttentionParams over the wrapper's scratch (2, m, heads, kv_dim): qk, av.
inline AttentionParams attention_params(const float* q3, const float* mask, const float* keep,
                                        const float* wk, int wk_sk, int wk_sn, const float* wv,
                                        int wv_sk, int wv_sn, float* scratch, float* out,
                                        float* scores, int m, int k, int kv_dim, int dq,
                                        int heads, float scale, int project_rows,
                                        int combine_rows) {
  const size_t part = static_cast<size_t>(m) * heads * kv_dim;
  return AttentionParams{q3, mask, keep, wk, wk_sk, wk_sn, wv, wv_sk, wv_sn, scratch,
                         scratch + part, out, scores, m, k, kv_dim, dq, heads, scale,
                         project_rows, combine_rows};
}

// Shared memory of one query's forward block, in floats: kv rows (k,
// kv_dim), qk (heads, kv_dim), then the logits, turned into weights in
// place (heads, k).
__host__ __device__ inline size_t attention_fwd_smem_floats(int k, int kv_dim, int heads) {
  return static_cast<size_t>(k) * kv_dim + static_cast<size_t>(heads) * kv_dim +
         static_cast<size_t>(heads) * k;
}

// A Loader stages query m's k kv rows, row-major (k, kv_dim), into shared
// memory with every thread of the block, in three steps:
// copy_rows(kv, m, k, kv_dim) issues copy_rows_async of the rows it reads
// from memory; compute(kv, m, k, kv_dim, msin) computes the columns it
// computes (Phi, and with msin non-null its sines: the backward) while
// they land; rescale(kv, m, k, kv_dim), after the barrier, scales rows
// and returns whether it wrote anything. The forward and the backward
// (attention_bwd.cuh) stage alike.
template <class Loader>
__global__ void __launch_bounds__(kQueryThreads)
    attention_query_kernel(Loader loader, AttentionParams p) {
  extern __shared__ float4 fwd_smem[];  // 16-byte aligned for the vector stores
  const int m = blockIdx.x;
  const int k = p.k, kv_dim = p.kv_dim, heads = p.heads;
  float* kv_s = reinterpret_cast<float*>(fwd_smem);               // (k, kv_dim)
  float* qk_s = kv_s + static_cast<size_t>(k) * kv_dim;           // (heads, kv_dim)
  float* w_s = qk_s + static_cast<size_t>(heads) * kv_dim;        // (heads, k)
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const size_t qrow = static_cast<size_t>(m) * heads * kv_dim;

  // stage the query's kv rows and qk: every copy in flight at once, Phi
  // computed while they land
  copy_rows_async(qk_s, kv_dim, p.qk + qrow, heads, kv_dim);
  loader.copy_rows(kv_s, m, k, kv_dim);
  patch_gemm::commit_copies();
  loader.compute(kv_s, m, k, kv_dim, nullptr);
  patch_gemm::wait_copies<0>();
  __syncthreads();
  if (loader.rescale(kv_s, m, k, kv_dim)) __syncthreads();

  // logits: one warp per (head, neighbor), lanes over columns, then a
  // fixed butterfly
  for (int e = warp; e < heads * k; e += kQueryWarps) {
    const int h = e / k;
    const float* kvr = kv_s + static_cast<size_t>(e - h * k) * kv_dim;
    const float* qh = qk_s + static_cast<size_t>(h) * kv_dim;
    float lg = 0.f;
    for (int c = lane; c < kv_dim; c += 32) lg = fmaf(kvr[c], qh[c], lg);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) lg += __shfl_xor_sync(0xffffffffu, lg, off);
    if (lane == 0) w_s[e] = lg;
  }
  __syncthreads();

  // mask, softmax and keep: one thread per head
  for (int h = tid; h < heads; h += kQueryThreads) {
    const float* mrow = p.mask + static_cast<size_t>(m) * k;
    const size_t srow = (static_cast<size_t>(m) * heads + h) * k;
    float* s = w_s + h * k;
    float mx = __int_as_float(0xff800000);  // -inf
    for (int j = 0; j < k; ++j) {
      s[j] = mrow[j] > 0.f ? s[j] * p.scale : kPadLogit;
      mx = fmaxf(mx, s[j]);
    }
    float sum = 0.f;
    for (int j = 0; j < k; ++j) {
      s[j] = expf(s[j] - mx);
      sum += s[j];
    }
    for (int j = 0; j < k; ++j) {
      s[j] = s[j] / sum * p.keep[srow + j];
      if (p.scores != nullptr) p.scores[srow + j] = s[j];
    }
  }
  __syncthreads();

  // Av: one thread per (head, column), neighbors in order
  for (int e = tid; e < heads * kv_dim; e += kQueryThreads) {
    const int h = e / kv_dim;
    const int c = e - h * kv_dim;
    const float* wh = w_s + h * k;
    float v = 0.f;
    for (int j = 0; j < k; ++j) v = fmaf(wh[j], kv_s[static_cast<size_t>(j) * kv_dim + c], v);
    p.av[qrow + e] = v;
  }
}

// Launch the whole forward over p.m queries (the wrapper checks shapes and
// the shared-memory need: ops/_attention.py).
template <class Loader>
cudaError_t launch_attention_forward(const Loader& loader, const AttentionParams& p,
                                     cudaStream_t stream) {
  if (p.m == 0 || p.dq == 0) return cudaSuccess;
  // 1. qk
  cudaError_t err = launch_head_project(HeadOperand{p.q3, p.wk, p.wk_sk, p.wk_sn, p.qk},
                                        HeadOperand{}, p.m, p.kv_dim, p.dq, p.heads,
                                        p.project_rows, stream);
  if (err != cudaSuccess) return err;
  // 2. per query: weights, scores, Av
  const size_t smem = sizeof(float) * attention_fwd_smem_floats(p.k, p.kv_dim, p.heads);
  auto kernel = attention_query_kernel<Loader>;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<p.m, kQueryThreads, smem, stream>>>(loader, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // 3. out
  return launch_head_combine(HeadOperand{p.av, p.wv, p.wv_sk, p.wv_sn, p.out}, p.m, p.kv_dim,
                             p.dq, p.heads, p.combine_rows, stream);
}

}  // namespace dyglib
