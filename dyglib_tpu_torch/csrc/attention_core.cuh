// Single-query temporal attention over K neighbors, for a block of
// queries; the core of TGAT's attention kernels (temporal_attention.cu,
// gathered_attention.cu, window_attention.cu). For query m with projected
// query q3[m] (heads flattened, dq = heads * hd) and kv rows
// r = m * K + j (j < K), given by the kernel's A loader:
//   key = kv @ Wk, val = kv @ Wv                           (dq wide)
//   logit[h, j] = (q3_h[m] . key_h[r]) * scale, or -1e10 where mask[r] == 0
//   w[h, j] = softmax_j(logit[h]) * keep[m, h, j]           (-> scores)
//   out[m, h * hd + d] = sum_j w[h, j] * val[r, h * hd + d]
//
// A block of kThreads owns floor(kBM / K) queries: kv rows row0 .. row0 +
// nq * K of one kBM-row tile (60 of 64 at K = 20). Key and val are produced
// 64 columns at a time by the shared tile (tiled_gemm.cuh), which stages
// the kv slice through the loader and the weight slice through its
// strides, and are consumed at once from shared memory:
//   1. each key column tile is multiplied by q3 and summed per (row, head)
//      into `logits` (one thread per row, in column order);
//   2. one thread per (query, head) turns its K logits into weights (mask,
//      max, exp, sum, divide, keep) and writes the scores;
//   3. each val column tile is weighted and summed over the query's K rows
//      (one thread per (query, column), in row order) into out.
// Neither key nor val reaches device memory; every sum has a fixed order,
// so two runs give identical outputs. The pad logit is -1e10, not -inf:
// an all-padded row attends uniformly, as the plain version does.
#pragma once

#include "phi.cuh"

namespace dyglib {

constexpr float kPadLogit = -1e10f;

struct AttentionParams {
  const float* __restrict__ q3;    // (m, dq)
  const float* __restrict__ mask;  // (m, k) f32, 1 = real neighbor
  const float* __restrict__ keep;  // (m, heads, k) f32 dropout keep, pre-scaled
  const float* __restrict__ wk;    // (kv_dim, dq) at wk[kk * wk_sk + c * wk_sn]
  int wk_sk;
  int wk_sn;
  const float* __restrict__ wv;    // (kv_dim, dq) at wv[kk * wv_sk + c * wv_sn]
  int wv_sk;
  int wv_sn;
  float* __restrict__ out;         // (m, dq)
  float* __restrict__ scores;      // (m, heads, k), or null
  int m;
  int k;
  int kv_dim;
  int dq;
  int heads;
  float scale;                     // (dq / heads) ** -0.5
};

// Dynamic shared memory: kBM * heads floats (the block's logits, then its
// attention weights).
template <class ALoader>
__global__ void __launch_bounds__(kThreads)
    attention_kernel(ALoader load_a, AttentionParams p) {
  extern __shared__ float logits[];  // [row * heads + h]
  __shared__ float buf[kBM][kBN + 1];
  const int group = kBM / p.k;
  const int q0 = blockIdx.x * group;
  const int nq = min(group, p.m - q0);
  const int row0 = q0 * p.k;
  const int nrows = nq * p.k;
  const int hd = p.dq / p.heads;
  const int tid = threadIdx.x;
  const int ty = tid / kThreadCols;
  const int tx = tid % kThreadCols;
  for (int e = tid; e < kBM * p.heads; e += kThreads) logits[e] = 0.f;
  float acc[kTM][kTN];

  // 1. key tiles -> logits (rows past nrows stage as zeros)
  for (int col0 = 0; col0 < p.dq; col0 += kBN) {
    gemm_tile<kBByStrides>(load_a, p.wk, p.wk_sk, p.wk_sn, row0 + nrows, p.dq, 0, p.kv_dim,
                           row0, col0, acc);
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int lr = ty + i * kThreadRows;
      const float* q = p.q3 + static_cast<size_t>(q0 + min(lr, nrows - 1) / p.k) * p.dq;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int c = col0 + tx + j * kThreadCols;
        buf[lr][tx + j * kThreadCols] = (lr < nrows && c < p.dq) ? acc[i][j] * __ldg(q + c) : 0.f;
      }
    }
    __syncthreads();
    if (tid < nrows) {
      const int cols = min(kBN, p.dq - col0);
      for (int cl = 0; cl < cols; ++cl) logits[tid * p.heads + (col0 + cl) / hd] += buf[tid][cl];
    }
    __syncthreads();
  }

  // 2. logits -> attention weights, per (query, head)
  for (int e = tid; e < nq * p.heads; e += kThreads) {
    const int g = e / p.heads;
    const int h = e - g * p.heads;
    const size_t qm = static_cast<size_t>(q0 + g);
    const float* mrow = p.mask + qm * p.k;
    const float* krow = p.keep + (qm * p.heads + h) * p.k;
    float* lrow = logits + g * p.k * p.heads + h;  // element j at j * heads
    float mx = __int_as_float(0xff800000);  // -inf
    for (int j = 0; j < p.k; ++j) {
      const float l = mrow[j] > 0.f ? lrow[j * p.heads] * p.scale : kPadLogit;
      lrow[j * p.heads] = l;
      mx = fmaxf(mx, l);
    }
    float sum = 0.f;
    for (int j = 0; j < p.k; ++j) {
      const float ex = expf(lrow[j * p.heads] - mx);
      lrow[j * p.heads] = ex;
      sum += ex;
    }
    for (int j = 0; j < p.k; ++j) {
      const float w = lrow[j * p.heads] / sum * krow[j];
      lrow[j * p.heads] = w;
      if (p.scores != nullptr) p.scores[(qm * p.heads + h) * p.k + j] = w;
    }
  }
  __syncthreads();

  // 3. val tiles, weighted -> out
  for (int col0 = 0; col0 < p.dq; col0 += kBN) {
    gemm_tile<kBByStrides>(load_a, p.wv, p.wv_sk, p.wv_sn, row0 + nrows, p.dq, 0, p.kv_dim,
                           row0, col0, acc);
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int lr = ty + i * kThreadRows;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int c = col0 + tx + j * kThreadCols;
        buf[lr][tx + j * kThreadCols] =
            (lr < nrows && c < p.dq) ? acc[i][j] * logits[lr * p.heads + c / hd] : 0.f;
      }
    }
    __syncthreads();
    const int cols = min(kBN, p.dq - col0);
    for (int e = tid; e < nq * kBN; e += kThreads) {
      const int g = e / kBN;
      const int cl = e - g * kBN;
      if (cl >= cols) continue;
      float s = 0.f;
      for (int j = 0; j < p.k; ++j) s += buf[g * p.k + j][cl];
      p.out[static_cast<size_t>(q0 + g) * p.dq + col0 + cl] = s;
    }
    __syncthreads();
  }
}

// Launch over all p.m queries; 1 <= k <= kBM and dq % heads == 0 are the
// caller's to check (ops/_attention.py).
template <class ALoader>
cudaError_t launch_attention(const ALoader& load_a, const AttentionParams& p,
                             cudaStream_t stream) {
  if (p.m == 0 || p.dq == 0) return cudaSuccess;
  const int group = kBM / p.k;
  const unsigned blocks = static_cast<unsigned>((p.m + group - 1) / group);
  attention_kernel<ALoader><<<blocks, kThreads, sizeof(float) * kBM * p.heads, stream>>>(load_a, p);
  return cudaGetLastError();
}

}  // namespace dyglib
