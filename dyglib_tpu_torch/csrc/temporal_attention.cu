// TGAT's fused single-query temporal attention over precomputed kv parts:
//   kv[r] = [nbr[r] || edge[r] || phi[r]]   for kv rows r = m * K + j
// then key, val, masked softmax, keep and weighted sum in shared memory
// (attention_core.cuh); writes out (m, dq) and the scores (m, heads, K).
//
// Replaces dyglib_tpu/ops/pallas/temporal_attention.py::_fwd_kernel. The
// JAX kernel concatenates the three parts in VMEM; here the A loader reads
// each column range from its own tensor, so the concatenation never
// exists anywhere.
//
// Backward: replaces ::_bwd_kernel (attention_bwd.cuh, the same loader):
// dq3, the three parts' gradients dnbr, dedge, dphi, and dWk, dWv, from the
// output's cotangent and the scores'.
#include "attention_bwd.cuh"

namespace {

struct KvLoader {
  static constexpr bool k_fast = true;
  const float* __restrict__ nbr;   // (rows, dn)
  const float* __restrict__ edge;  // (rows, de)
  const float* __restrict__ phi;   // (rows, dt)
  int dn;
  int de;
  int dt;

  __device__ __forceinline__ float operator()(int r, int c) const {
    if (c < dn) return nbr[static_cast<size_t>(r) * dn + c];
    c -= dn;
    if (c < de) return edge[static_cast<size_t>(r) * de + c];
    return phi[static_cast<size_t>(r) * dt + c - de];
  }
};

}  // namespace

// q3: (m, dq); nbr, edge, phi: (m, k, dn / de / dt); mask: (m, k); keep:
// (m, heads, k); wk, wv: (dn + de + dt, dq) by element strides; out: (m,
// dq); scores: (m, heads, k). All f32.
DYGLIB_API int temporal_attention_forward(const float* q3, const float* nbr, const float* edge,
                                          const float* phi, const float* mask, const float* keep,
                                          const float* wk, int wk_sk, int wk_sn, const float* wv,
                                          int wv_sk, int wv_sn, float* out, float* scores, int m,
                                          int k, int dn, int de, int dt, int dq, int heads,
                                          float scale, cudaStream_t stream) {
  const dyglib::AttentionParams p{q3,  mask,   keep, wk, wk_sk,        wk_sn, wv,    wv_sk, wv_sn,
                                  out, scores, m,    k,  dn + de + dt, dq,    heads, scale};
  return static_cast<int>(
      dyglib::launch_attention(KvLoader{nbr, edge, phi, dn, de, dt}, p, stream));
}

// As the forward, plus dout: (m, dq); dscores: (m, heads, k) or null.
// Outputs: dq3 (m, dq); dnbr, dedge, dphi (m, k, dn / de / dt); dwk, dwv
// (dn + de + dt, dq). Scratch: (4, m, heads, dn + de + dt) and partial
// (ceil(m / chunk_rows), dn + de + dt, dq). All f32; m > 0.
DYGLIB_API int temporal_attention_backward(
    const float* q3, const float* nbr, const float* edge, const float* phi, const float* mask,
    const float* keep, const float* wk, int wk_sk, int wk_sn, const float* wv, int wv_sk,
    int wv_sn, const float* dout, const float* dscores, float* scratch, float* partial,
    float* dq3, float* dnbr, float* dedge, float* dphi, float* dwk, float* dwv, int m, int k,
    int dn, int de, int dt, int dq, int heads, float scale, int chunk_rows, cudaStream_t stream) {
  const dyglib::AttentionBwdParams p = dyglib::attention_bwd_params(
      q3, mask, keep, wk, wk_sk, wk_sn, wv, wv_sk, wv_sn, dout, dscores, scratch, partial, dq3,
      dwk, dwv, m, k, dn + de + dt, dq, heads, scale, chunk_rows);
  return static_cast<int>(dyglib::launch_attention_backward(
      KvLoader{nbr, edge, phi, dn, de, dt}, dyglib::KvPartsGrad{dnbr, dedge, dphi, dn, de, dt}, p,
      stream));
}
