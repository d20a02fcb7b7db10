// TGAT's post-gather fused attention at layer 1:
//   kv[r] = [feat_n[r] || feat_e[r] || cos(dt[r] * tw + tb)]   r = m * K + j
// then masked softmax, keep and weighted sum, reassociated so that no kv
// row is projected (attention_core.cuh); writes out (m, dq).
//
// Replaces dyglib_tpu/ops/pallas/gathered_attention.py::_fwd_kernel. The
// gathered node and edge rows arrive as two slabs, and a query's K rows are
// contiguous in each (K * 688 bytes at 172 columns): the loader stages
// them by 16-byte asynchronous copies and computes Phi in shared memory
// while they land, each cosine once (phi.cuh rounding; cos_reduced.cuh's
// cosine, cosf's bits without its slow path), so neither the time features nor the concatenation nor
// key and val reach device memory. No mask in the loader: gathered pad
// rows are already the zero id-0 rows.
//
// Backward: replaces ::_bwd_kernel (attention_bwd.cuh, the same loader,
// which stages -sin of each Phi argument beside Phi): dq3, dWk, dWv, and
// dtw, dtb through the Phi columns; the feature slabs get no gradient.
#include "attention_bwd.cuh"

namespace {

struct GatheredLoader {
  const float* __restrict__ feat_n;  // (rows, dn)
  const float* __restrict__ feat_e;  // (rows, de)
  const float* __restrict__ dt;      // (rows)
  const float* __restrict__ tw;      // (dt_dim)
  const float* __restrict__ tb;      // (dt_dim)
  int dn;
  int de;

  // query m's k rows into kv (k, kv_dim) in shared memory
  // (attention_core.cuh): the slabs' rows by asynchronous copies; Phi, and
  // in the backward -sin of each argument into msin (k, dt_dim), computed
  // while they land
  __device__ __forceinline__ void copy_rows(float* kv, int m, int k, int kv_dim) const {
    const size_t r0 = static_cast<size_t>(m) * k;
    dyglib::copy_rows_async(kv, kv_dim, feat_n + r0 * dn, k, dn);
    dyglib::copy_rows_async(kv + dn, kv_dim, feat_e + r0 * de, k, de);
  }

  __device__ __forceinline__ void compute(float* kv, int m, int k, int kv_dim,
                                          float* msin) const {
    dyglib::stage_phi(kv + dn + de, kv_dim, dt + static_cast<size_t>(m) * k, tw, tb, k,
                      kv_dim - dn - de, msin);
  }

  __device__ __forceinline__ bool rescale(float*, int, int, int) const { return false; }
};

}  // namespace

// q3: (m, dq); feat_n, feat_e: (m * k, dn / de); dt, mask: (m, k); tw, tb:
// (dt_dim); keep: (m, heads, k); wk, wv: (dn + de + dt_dim, dq) by element
// strides; scratch: (2, m, heads, dn + de + dt_dim); out: (m, dq). All f32.
DYGLIB_API int gathered_attention_forward(const float* q3, const float* feat_n,
                                          const float* feat_e, const float* dt, const float* tw,
                                          const float* tb, const float* mask, const float* keep,
                                          const float* wk, int wk_sk, int wk_sn, const float* wv,
                                          int wv_sk, int wv_sn, float* scratch, float* out, int m,
                                          int k, int dn, int de, int dt_dim, int dq, int heads,
                                          float scale, int project_rows, int combine_rows,
                                          cudaStream_t stream) {
  const dyglib::AttentionParams p = dyglib::attention_params(
      q3, mask, keep, wk, wk_sk, wk_sn, wv, wv_sk, wv_sn, scratch, out, nullptr, m, k,
      dn + de + dt_dim, dq, heads, scale, project_rows, combine_rows);
  return static_cast<int>(dyglib::launch_attention_forward(
      GatheredLoader{feat_n, feat_e, dt, tw, tb, dn, de}, p, stream));
}

// As the forward, plus dout: (m, dq). Outputs: dq3 (m, dq); dwk, dwv
// (dn + de + dt_dim, dq); dt_grads (2, dt_dim): dtw, then dtb. Scratch:
// (4, m, heads, dn + de + dt_dim), partial (ceil(m / chunk_rows), dn + de +
// dt_dim, dq), part (m, 2, dt_dim). All f32; m > 0. The plan as
// temporal_attention_backward's.
DYGLIB_API int gathered_attention_backward(
    const float* q3, const float* feat_n, const float* feat_e, const float* dt, const float* tw,
    const float* tb, const float* mask, const float* keep, const float* wk, int wk_sk, int wk_sn,
    const float* wv, int wv_sk, int wv_sn, const float* dout, float* scratch, float* partial,
    float* part, float* dq3, float* dwk, float* dwv, float* dt_grads, int m, int k, int dn,
    int de, int dt_dim, int dq, int heads, float scale, int project_rows, int combine_rows,
    int grad_rows, int chunk_rows, cudaStream_t stream) {
  const dyglib::AttentionBwdParams p = dyglib::attention_bwd_params(
      q3, mask, keep, wk, wk_sk, wk_sn, wv, wv_sk, wv_sn, dout, nullptr, scratch, partial, dq3,
      dwk, dwv, m, k, dn + de + dt_dim, dq, heads, scale, project_rows, combine_rows, grad_rows,
      chunk_rows);
  return static_cast<int>(dyglib::launch_attention_backward(
      GatheredLoader{feat_n, feat_e, dt, tw, tb, dn, de},
      dyglib::PhiParamGrad{dt, part, dt_grads, dt_dim}, p, stream));
}
