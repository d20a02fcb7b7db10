// TGAT's fused single-query temporal attention over precomputed kv parts:
//   kv[r] = [nbr[r] || edge[r] || phi[r]]   for kv rows r = m * K + j
// then masked softmax, keep and weighted sum, reassociated so that no kv
// row is projected (attention_core.cuh); writes out (m, dq) and the scores
// (m, heads, K).
//
// Replaces dyglib_tpu/ops/pallas/temporal_attention.py::_fwd_kernel. The
// JAX kernel concatenates the three parts in VMEM; here the loader stages
// each column range of a query's K rows from its own tensor (three
// contiguous blocks, 16-byte asynchronous copies where the widths allow),
// so the concatenation never exists in device memory.
//
// Backward: replaces ::_bwd_kernel (attention_bwd.cuh, the same loader):
// dq3, the three parts' gradients dnbr, dedge, dphi, and dWk, dWv, from the
// output's cotangent and the scores'.
#include "attention_bwd.cuh"

namespace {

struct KvLoader {
  const float* __restrict__ nbr;   // (rows, dn)
  const float* __restrict__ edge;  // (rows, de)
  const float* __restrict__ phi;   // (rows, dt)
  int dn;
  int de;
  int dt;

  // query m's k rows into kv (k, dn + de + dt) in shared memory
  // (attention_core.cuh): all three parts by asynchronous copies; Phi is an
  // input here, so nothing is computed
  __device__ __forceinline__ void copy_rows(float* kv, int m, int k, int kv_dim) const {
    const size_t r0 = static_cast<size_t>(m) * k;
    dyglib::copy_rows_async(kv, kv_dim, nbr + r0 * dn, k, dn);
    dyglib::copy_rows_async(kv + dn, kv_dim, edge + r0 * de, k, de);
    dyglib::copy_rows_async(kv + dn + de, kv_dim, phi + r0 * dt, k, dt);
  }

  __device__ __forceinline__ void compute(float*, int, int, int, float*) const {}

  __device__ __forceinline__ bool rescale(float*, int, int, int) const { return false; }
};

}  // namespace

// q3: (m, dq); nbr, edge, phi: (m, k, dn / de / dt); mask: (m, k); keep:
// (m, heads, k); wk, wv: (dn + de + dt, dq) by element strides; scratch:
// (2, m, heads, dn + de + dt); out: (m, dq); scores: (m, heads, k). All f32.
// project_rows, combine_rows: the rows a block of the per-head products
// takes (ops/_plan.py::head_plan).
DYGLIB_API int temporal_attention_forward(const float* q3, const float* nbr, const float* edge,
                                          const float* phi, const float* mask, const float* keep,
                                          const float* wk, int wk_sk, int wk_sn, const float* wv,
                                          int wv_sk, int wv_sn, float* scratch, float* out,
                                          float* scores, int m, int k, int dn, int de, int dt,
                                          int dq, int heads, float scale, int project_rows,
                                          int combine_rows, cudaStream_t stream) {
  const dyglib::AttentionParams p = dyglib::attention_params(
      q3, mask, keep, wk, wk_sk, wk_sn, wv, wv_sk, wv_sn, scratch, out, scores, m, k,
      dn + de + dt, dq, heads, scale, project_rows, combine_rows);
  return static_cast<int>(
      dyglib::launch_attention_forward(KvLoader{nbr, edge, phi, dn, de, dt}, p, stream));
}

// As the forward, plus dout: (m, dq); dscores: (m, heads, k) or null.
// Outputs: dq3 (m, dq); dnbr, dedge, dphi (m, k, dn / de / dt); dwk, dwv
// (dn + de + dt, dq). Scratch: (4, m, heads, dn + de + dt) and partial
// (ceil(m / chunk_rows), dn + de + dt, dq). All f32; m > 0. The plan:
// project_rows, combine_rows, grad_rows and chunk_rows (ops/_plan.py).
DYGLIB_API int temporal_attention_backward(
    const float* q3, const float* nbr, const float* edge, const float* phi, const float* mask,
    const float* keep, const float* wk, int wk_sk, int wk_sn, const float* wv, int wv_sk,
    int wv_sn, const float* dout, const float* dscores, float* scratch, float* partial,
    float* dq3, float* dnbr, float* dedge, float* dphi, float* dwk, float* dwv, int m, int k,
    int dn, int de, int dt, int dq, int heads, float scale, int project_rows, int combine_rows,
    int grad_rows, int chunk_rows, cudaStream_t stream) {
  const dyglib::AttentionBwdParams p = dyglib::attention_bwd_params(
      q3, mask, keep, wk, wk_sk, wk_sn, wv, wv_sk, wv_sn, dout, dscores, scratch, partial, dq3,
      dwk, dwv, m, k, dn + de + dt, dq, heads, scale, project_rows, combine_rows, grad_rows,
      chunk_rows);
  return static_cast<int>(dyglib::launch_attention_backward(
      KvLoader{nbr, edge, phi, dn, de, dt}, dyglib::KvPartsGrad{dnbr, dedge, dphi, dn, de, dt}, p,
      stream));
}
