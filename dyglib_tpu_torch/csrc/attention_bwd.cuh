// The backward of single-query temporal attention (attention_core.cuh), for
// TGAT's three attention kernels (temporal_attention.cu,
// gathered_attention.cu, window_attention.cu). Given the output's cotangent
// g (m, dq) and, for temporal attention, the scores' dscores (m, heads, K):
//
//   ds_d[h, j] = g_h . val_h[r] + dscores,   w = s * keep   (s: softmax)
//   dlog[h, j] = s * (ds_d * keep - sum_j ds_d * keep * s), 0 at pads, * scale
//   dq3_h = sum_j dlog key_h[r];  dWk = kv^T dkey, dkey[r] = dlog q3_h
//   dWv = kv^T dval, dval[r] = w g_h;  dkv[r] = dkey Wk^T + dval Wv^T
//
// Replaces the _bwd_kernels of dyglib_tpu/ops/pallas/{temporal,gathered,
// window}_attention.py. Those recompute key and val for every kv row and
// contract dkey and dval (R, dq) with kv and W: at TGAT's layer 1, hop 1
// (R = 240,000 rows of 444) about 258 G operations. Reassociated, the same
// function never projects a kv row. With Wk_h, Wv_h the head-h columns:
//
//   qk[m, h] = Wk_h q3_h[m],  gv[m, h] = Wv_h g_h[m]          (kv_dim each)
//   logit[h, j] = kv[r] . qk[m, h] * scale,  ds_d[h, j] = kv[r] . gv[m, h] + dscores
//   Ak[m, h] = sum_j dlog[h, j] kv[r],  Av[m, h] = sum_j w[h, j] kv[r]
//   dq3_h = Ak[m, h] Wk_h,  dWk[:, h] = sum_m Ak[m, h]^T q3_h[m],
//   dWv[:, h] = sum_m Av[m, h]^T g_h[m],
//   dkv[r] = sum_h dlog[h, j] qk[m, h] + w[h, j] gv[m, h]
//
// about 16 G operations at hop 1. Launches, in order, all on the caller's
// stream:
//   1. head_project_kernel: qk and gv (the split-TF32 tensor-core tile,
//      head_gemm.cuh; both per-head products live in attention_core.cuh,
//      shared with the forward);
//   2. attention_bwd_query_kernel: one block of 256 threads per query
//      stages its K kv rows and its qk, gv rows once, all by asynchronous
//      copies in flight together (16 bytes each where the widths allow),
//      and computes Phi's cosines (cos_reduced.cuh), and for the gathered
//      and window kernels -sin of the same arguments from the same
//      reduction, into shared memory while they land; forms logits and ds_d (one warp per (head, neighbor), a fixed
//      butterfly), the softmax and its backward (one warp per head, lanes
//      over neighbors, fixed butterflies for the max, the sum and the
//      total), Ak and Av; then hands dlog, w, qk, gv and the sines to the
//      kernel's KvGrad, which writes what that kernel returns of dkv: all
//      of it for temporal attention; for the gathered and window kernels
//      c = dkv * -sin(theta) on the Phi columns, by every thread into
//      shared memory, then per-query sums of c and c * dt (their feature
//      rows get no gradient);
//   3. head_combine_kernel: dq3 = Ak Wk_h (the tile);
//   4. head_weight_grad_kernel + strided_sum, twice: dWk and dWv, summed
//      over row chunks (the tile again) into scratch and then in a fixed
//      order (the deterministic two-pass reduction of weight_grad.cuh, no
//      atomics);
//   5. KvGrad::finish: the gathered and window kernels' dtw, dtb, summed
//      over queries in a fixed order (strided_sum: a block a feature).
// Every sum has a fixed order: two runs give bit-identical gradients. The
// per-head products run on the tensor cores in split TF32 (f32-accurate),
// the rest in f32 on the CUDA cores.
//
// What bounds the query kernel: at TGAT's layer 1, hop 1 (12,000 queries
// of 20 rows of 444) it reads ~330 MB of kv rows and ~170 MB of qk, gv, ak
// and av, a bytes floor of ~0.15 ms; its ~5 G operations are not the
// limit, and cutting its instructions (16-byte shared loads, no integer
// divides) moved nothing on an H100. Staging every row by asynchronous
// copies in flight together, with Phi and the sines computed meanwhile,
// took the gathered kernel's from 0.50 to 0.45 ms; one-warp-per-head
// softmax and sines from the cosine's reduction took it from 1.18 to 0.50
// (PERF.md, scripts/time_tgat_kernels.py).
#pragma once

#include "attention_core.cuh"
#include "patch_gemm.cuh"
#include "weight_grad.cuh"

namespace dyglib {

constexpr int kBwdThreads = kQueryThreads;  // 256, as the forward
constexpr int kBwdWarps = kBwdThreads / 32;

struct AttentionBwdParams {
  const float* __restrict__ q3;       // (m, dq)
  const float* __restrict__ mask;     // (m, k)
  const float* __restrict__ keep;     // (m, heads, k)
  const float* __restrict__ wk;       // (kv_dim, dq) at wk[c * wk_sk + col * wk_sn]
  int wk_sk;
  int wk_sn;
  const float* __restrict__ wv;
  int wv_sk;
  int wv_sn;
  const float* __restrict__ dout;     // (m, dq)
  const float* __restrict__ dscores;  // (m, heads, k), or null (zeros)
  float* __restrict__ qk;             // scratch (m, heads, kv_dim), and gv, ak, av
  float* __restrict__ gv;
  float* __restrict__ ak;
  float* __restrict__ av;
  float* __restrict__ partial;        // scratch (ceil(m / chunk_rows), kv_dim, dq)
  float* __restrict__ dq3;            // (m, dq)
  float* __restrict__ dwk;            // (kv_dim, dq)
  float* __restrict__ dwv;            // (kv_dim, dq)
  int m;
  int k;
  int kv_dim;
  int dq;
  int heads;
  float scale;
  int project_rows;  // rows a block of head_project, head_combine and head_weight_grad takes
  int combine_rows;  // (ops/_plan.py::head_plan)
  int grad_rows;
  int chunk_rows;
};

// blockIdx.z = chunk * heads + h: partial[chunk, c, h hd + d] = sum over the
// chunk's rows r of a[r, h, c] x[r, h hd + d] (a = ak with x = q3 for dWk,
// av with dout for dWv; head_gemm.cuh: 32 kWarpsM rows of kv_dim and 72
// columns a block, both operands staged [r][...]).
template <int kWarpsM, int kVec>
__global__ void __launch_bounds__(128)
    head_weight_grad_kernel(const float* __restrict__ a, const float* __restrict__ x,
                            float* __restrict__ partial, int m, int kv_dim, int dq, int heads,
                            int chunk_rows) {
  namespace hg = head_gemm;
  extern __shared__ float4 head_smem[];
  float* smem = reinterpret_cast<float*>(head_smem);
  const int chunk = blockIdx.z / heads;
  const int h = blockIdx.z - chunk * heads;
  const int hd = dq / heads;
  const int r_begin = chunk * chunk_rows;
  const int r_end = min(m, r_begin + chunk_rows);
  hg::product<kWarpsM, hg::kHeadNF, false, false, kVec>(
      smem, {a + static_cast<size_t>(h) * kv_dim, heads * kv_dim}, kv_dim, {x + h * hd, dq}, hd,
      r_begin, r_end, blockIdx.x * 32 * kWarpsM, blockIdx.y * 8 * hg::kHeadNF,
      partial + static_cast<size_t>(chunk) * kv_dim * dq + h * hd, dq);
}

// Shared memory of one query's block, in floats: kv rows (k, kv_dim), qk and
// gv (heads, kv_dim each), then s, ds, w and dlog (heads, k each), then the
// Phi columns' -sin (k, sin_cols; sin_cols = 0 where the KvGrad needs none).
// ops/_attention.py::check_shared_memory mirrors it.
__host__ __device__ inline size_t attention_bwd_smem_floats(int k, int kv_dim, int heads,
                                                             int sin_cols) {
  return static_cast<size_t>(k) * kv_dim + 2 * static_cast<size_t>(heads) * kv_dim +
         4 * static_cast<size_t>(heads) * k + static_cast<size_t>(k) * sin_cols;
}

// What a KvGrad sees of one query m after step 2: the staged rows, the
// per-(head, neighbor) dlog and w and the Phi columns' -sin, all in shared
// memory.
struct QueryGrads {
  const float* kv;    // (k, kv_dim)
  const float* qk;    // (heads, kv_dim)
  const float* gv;    // (heads, kv_dim)
  const float* dlog;  // (heads, k)
  const float* w;     // (heads, k)
  float* msin;        // (k, sin_cols), the KvGrad's to overwrite
  int m;
  int k;
  int kv_dim;
  int heads;

  // dkv[m * k + j, c] = sum_h dlog[h, j] qk[h, c] + w[h, j] gv[h, c]
  __device__ __forceinline__ float dkv(int j, int c) const {
    float s = 0.f;
    for (int h = 0; h < heads; ++h)
      s += dlog[h * k + j] * qk[h * kv_dim + c] + w[h * k + j] * gv[h * kv_dim + c];
    return s;
  }
};

// The same value in every lane of the warp, combined by a fixed butterfly.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// ALoader stages as attention_query_kernel's Loader does
// (attention_core.cuh), here with msin: the Phi columns' -sin.
template <class ALoader, class KvGrad>
__global__ void __launch_bounds__(kBwdThreads)
    attention_bwd_query_kernel(ALoader load_a, KvGrad kv_grad, AttentionBwdParams p) {
  extern __shared__ float4 bwd_smem[];  // 16-byte aligned for the vector stores
  const int m = blockIdx.x;
  const int k = p.k, kv_dim = p.kv_dim, heads = p.heads;
  float* kv_s = reinterpret_cast<float*>(bwd_smem);        // (k, kv_dim)
  float* qk_s = kv_s + static_cast<size_t>(k) * kv_dim;    // (heads, kv_dim)
  float* gv_s = qk_s + static_cast<size_t>(heads) * kv_dim;
  float* s_s = gv_s + static_cast<size_t>(heads) * kv_dim;  // (heads, k)
  float* ds_s = s_s + heads * k;
  float* w_s = ds_s + heads * k;
  float* dlog_s = w_s + heads * k;
  float* msin_s = dlog_s + heads * k;                      // (k, sin_cols)
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const size_t row0 = static_cast<size_t>(m) * k;
  const size_t qrow = static_cast<size_t>(m) * heads * kv_dim;

  // stage the query's kv rows, qk and gv: every copy in flight at once,
  // Phi (and its sines) computed while they land
  copy_rows_async(qk_s, kv_dim, p.qk + qrow, heads, kv_dim);
  copy_rows_async(gv_s, kv_dim, p.gv + qrow, heads, kv_dim);
  load_a.copy_rows(kv_s, m, k, kv_dim);
  patch_gemm::commit_copies();
  load_a.compute(kv_s, m, k, kv_dim, kv_grad.sin_cols() > 0 ? msin_s : nullptr);
  patch_gemm::wait_copies<0>();
  __syncthreads();
  if (load_a.rescale(kv_s, m, k, kv_dim)) __syncthreads();

  // logits and ds_d: one warp per (head, neighbor), lanes over columns,
  // then a fixed butterfly
  for (int e = warp; e < heads * k; e += kBwdWarps) {
    const int h = e / k;
    const float* kvr = kv_s + static_cast<size_t>(e - h * k) * kv_dim;
    const float* qh = qk_s + static_cast<size_t>(h) * kv_dim;
    const float* gh = gv_s + static_cast<size_t>(h) * kv_dim;
    float lg = 0.f, dd = 0.f;
    for (int c = lane; c < kv_dim; c += 32) {
      lg = fmaf(kvr[c], qh[c], lg);
      dd = fmaf(kvr[c], gh[c], dd);
    }
    lg = warp_sum(lg);
    dd = warp_sum(dd);
    if (lane == 0) {
      s_s[e] = lg;
      ds_s[e] = dd;
    }
  }
  __syncthreads();

  // softmax, keep and dlog: one warp per head, each lane its neighbors j =
  // lane, lane + 32, ...; the max, the sum and the total by fixed butterflies
  const float* mrow = p.mask + row0;
  for (int h = warp; h < heads; h += kBwdWarps) {
    const size_t hrow = (static_cast<size_t>(m) * heads + h) * k;
    float* s = s_s + h * k;
    float* ds = ds_s + h * k;
    float mx = __int_as_float(0xff800000);  // -inf
    for (int j = lane; j < k; j += 32) {
      s[j] = mrow[j] > 0.f ? s[j] * p.scale : kPadLogit;
      mx = fmaxf(mx, s[j]);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < k; j += 32) {
      s[j] = expf(s[j] - mx);
      sum += s[j];
    }
    sum = warp_sum(sum);
    float total = 0.f;
    for (int j = lane; j < k; j += 32) {
      s[j] /= sum;
      float d = ds[j];
      if (p.dscores != nullptr) d += p.dscores[hrow + j];
      ds[j] = d * p.keep[hrow + j];
      total += ds[j] * s[j];
    }
    total = warp_sum(total);
    for (int j = lane; j < k; j += 32) {
      w_s[h * k + j] = s[j] * p.keep[hrow + j];
      dlog_s[h * k + j] = mrow[j] > 0.f ? s[j] * (ds[j] - total) * p.scale : 0.f;
    }
  }
  __syncthreads();

  // Ak, Av: one thread per (head, column), neighbors in order
  for (int e = tid; e < heads * kv_dim; e += kBwdThreads) {
    const int h = e / kv_dim;
    const int c = e - h * kv_dim;
    float a = 0.f, v = 0.f;
    for (int j = 0; j < k; ++j) {
      const float x = kv_s[static_cast<size_t>(j) * kv_dim + c];
      a = fmaf(dlog_s[h * k + j], x, a);
      v = fmaf(w_s[h * k + j], x, v);
    }
    p.ak[qrow + e] = a;
    p.av[qrow + e] = v;
  }

  kv_grad(QueryGrads{kv_s, qk_s, gv_s, dlog_s, w_s, msin_s, m, k, kv_dim, heads});
}

// Launch the whole backward for p.m > 0 queries (the wrapper checks shapes
// and the shared-memory need: ops/_attention.py).
template <class ALoader, class KvGrad>
cudaError_t launch_attention_backward(const ALoader& load_a, const KvGrad& kv_grad,
                                      const AttentionBwdParams& p, cudaStream_t stream) {
  const int hd = p.dq / p.heads;
  // 1. qk, gv
  cudaError_t err = launch_head_project(HeadOperand{p.q3, p.wk, p.wk_sk, p.wk_sn, p.qk},
                                        HeadOperand{p.dout, p.wv, p.wv_sk, p.wv_sn, p.gv}, p.m,
                                        p.kv_dim, p.dq, p.heads, p.project_rows, stream);
  if (err != cudaSuccess) return err;
  // 2. per query
  const size_t smem =
      sizeof(float) * attention_bwd_smem_floats(p.k, p.kv_dim, p.heads, kv_grad.sin_cols());
  auto kernel = attention_bwd_query_kernel<ALoader, KvGrad>;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<p.m, kBwdThreads, smem, stream>>>(load_a, kv_grad, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // 3. dq3
  err = launch_head_combine(HeadOperand{p.ak, p.wk, p.wk_sk, p.wk_sn, p.dq3}, p.m, p.kv_dim, p.dq,
                            p.heads, p.combine_rows, stream);
  if (err != cudaSuccess) return err;
  // 4. dWk, dWv: chunk partial sums, then a fixed-order sum (the second
  // pass reads the scratch before the next first pass writes it: one stream)
  const int chunks = (p.m + p.chunk_rows - 1) / p.chunk_rows;
  const float* pairs[2][2] = {{p.ak, p.q3}, {p.av, p.dout}};
  float* dws[2] = {p.dwk, p.dwv};
  for (int i = 0; i < 2; ++i) {
    const bool vec = head_gemm::vector_copies(p.kv_dim, hd, {pairs[i][0], pairs[i][1]});
    err = head_gemm::dispatch(p.grad_rows, vec, [&](auto warps, auto v) {
      constexpr int kW = decltype(warps)::value, kV = decltype(v)::value;
      const dim3 grid((p.kv_dim + 32 * kW - 1) / (32 * kW),
                      (hd + 8 * head_gemm::kHeadNF - 1) / (8 * head_gemm::kHeadNF),
                      chunks * p.heads);
      return head_gemm::launch<head_weight_grad_kernel<kW, kV>>(
          grid, head_gemm::smem_bytes<kW, head_gemm::kHeadNF, false>(), stream, pairs[i][0],
          pairs[i][1], p.partial, p.m, p.kv_dim, p.dq, p.heads, p.chunk_rows);
    });
    if (err != cudaSuccess) return err;
    err = launch_strided_sum(p.partial, dws[i], chunks, p.kv_dim * p.dq, stream);
    if (err != cudaSuccess) return err;
  }
  // 5. the KvGrad's own reduction
  return kv_grad.finish(p.m, stream);
}

// KvGrad of temporal attention: all of dkv, split into the gradients of its
// three parts, one thread per (neighbor, column).
struct KvPartsGrad {
  float* __restrict__ dnbr;   // (m * k, dn)
  float* __restrict__ dedge;  // (m * k, de)
  float* __restrict__ dphi;   // (m * k, dt)
  int dn;
  int de;
  int dt;

  __host__ __device__ int sin_cols() const { return 0; }

  __device__ void operator()(const QueryGrads& q) const {
    for (int e = threadIdx.x; e < q.k * q.kv_dim; e += kBwdThreads) {
      const int j = e / q.kv_dim;
      int c = e - j * q.kv_dim;
      const float v = q.dkv(j, c);
      const size_t r = static_cast<size_t>(q.m) * q.k + j;
      if (c < dn) {
        dnbr[r * dn + c] = v;
      } else if ((c -= dn) < de) {
        dedge[r * de + c] = v;
      } else {
        dphi[r * dt + c - de] = v;
      }
    }
  }

  cudaError_t finish(int, cudaStream_t) const { return cudaSuccess; }
};

// AttentionBwdParams over the wrapper's scratch (4, m, heads, kv_dim): qk,
// gv, ak, av in that order.
inline AttentionBwdParams attention_bwd_params(
    const float* q3, const float* mask, const float* keep, const float* wk, int wk_sk, int wk_sn,
    const float* wv, int wv_sk, int wv_sn, const float* dout, const float* dscores,
    float* scratch, float* partial, float* dq3, float* dwk, float* dwv, int m, int k, int kv_dim,
    int dq, int heads, float scale, int project_rows, int combine_rows, int grad_rows,
    int chunk_rows) {
  const size_t part = static_cast<size_t>(m) * heads * kv_dim;
  return AttentionBwdParams{q3, mask, keep, wk, wk_sk, wk_sn, wv, wv_sk, wv_sn, dout, dscores,
                            scratch, scratch + part, scratch + 2 * part, scratch + 3 * part,
                            partial, dq3, dwk, dwv, m, k, kv_dim, dq, heads, scale, project_rows,
                            combine_rows, grad_rows, chunk_rows};
}

// KvGrad of the gathered and window kernels: dPhi = the last dt_dim columns
// of dkv, c = dPhi * -sin(theta), the sines staged by the loader beside Phi
// (cos_reduced.cuh, the forward's rounding of theta); every thread forms c
// in place of the sines, then per query and feature part[m, 0, f] = sum_j c
// * dt and part[m, 1, f] = sum_j c (neighbors in order); dtw, dtb = the
// sums over queries (weight_grad.cuh's strided_sum, one launch for both,
// at these shapes one block a column, fixed order).
struct PhiParamGrad {
  const float* __restrict__ dt;  // (m * k)
  float* __restrict__ part;      // scratch (m, 2, dt_dim)
  float* __restrict__ dt_grads;  // (2, dt_dim): dtw, dtb
  int dt_dim;

  __host__ __device__ int sin_cols() const { return dt_dim; }

  __device__ void operator()(const QueryGrads& q) const {
    const int f0 = q.kv_dim - dt_dim;
    for (int e = threadIdx.x; e < q.k * dt_dim; e += kBwdThreads) {
      const int j = e / dt_dim;
      q.msin[e] *= q.dkv(j, f0 + e - j * dt_dim);
    }
    __syncthreads();
    const float* dtq = dt + static_cast<size_t>(q.m) * q.k;
    for (int f = threadIdx.x; f < dt_dim; f += kBwdThreads) {
      float s_tw = 0.f, s_tb = 0.f;
      for (int j = 0; j < q.k; ++j) {
        const float c = q.msin[j * dt_dim + f];
        s_tb += c;
        s_tw += c * dtq[j];
      }
      float* row = part + static_cast<size_t>(q.m) * 2 * dt_dim;
      row[f] = s_tw;
      row[dt_dim + f] = s_tb;
    }
  }

  cudaError_t finish(int m, cudaStream_t stream) const {
    return launch_strided_sum(part, dt_grads, m, 2 * dt_dim, stream);
  }
};

}  // namespace dyglib
