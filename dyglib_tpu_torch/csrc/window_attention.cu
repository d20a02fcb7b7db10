// TGAT's window-gather fused attention at layer 1:
//   kv[r] = [table[starts[m] + j] * mask[r] || cos(dt[r] * tw + tb)]   r = m * K + j
// then masked softmax, keep and weighted sum, reassociated so that no kv
// row is projected (attention_core.cuh); writes out (m, dq).
//
// Replaces dyglib_tpu/ops/pallas/window_attention.py::_fwd_kernel (_core).
// Under the recent strategy a query's K neighbors are K consecutive rows
// of the entry-ordered table (graph/csr.py feat_entry, packed row-major,
// dn + de columns), one contiguous block (K * 1376 bytes at 344 columns):
// the loader stages exactly those rows by 16-byte asynchronous copies,
// times the mask in shared memory (a masked row is not read and stages as
// zeros, as gathered id-0 rows are), and computes Phi there while they
// land, each cosine once (phi.cuh rounding; cos_reduced.cuh's cosine,
// cosf's bits without its slow path). No aligned superset windows, keep
// rescale or zero weight rows: those are Mosaic DMA aids. Every
// starts[m] + j lies inside the table (the caller clamps the starts).
//
// Backward: replaces ::_bwd_kernel (attention_bwd.cuh, the same loader,
// which stages -sin of each Phi argument beside Phi): dq3, dWk, dWv, and
// dtw, dtb through the Phi columns; the table gets no gradient.
#include "attention_bwd.cuh"

namespace {

struct WindowLoader {
  const float* __restrict__ table;  // (t_rows, width)
  const int* __restrict__ starts;   // (m)
  const float* __restrict__ mask;   // (m * k)
  const float* __restrict__ dt;     // (m * k)
  const float* __restrict__ tw;     // (dt_dim)
  const float* __restrict__ tb;     // (dt_dim)
  int width;

  // query m's k rows into kv (k, width + dt_dim) in shared memory
  // (attention_core.cuh): the window's rows by asynchronous copies (masked
  // rows unread, zero); Phi, and in the backward -sin of each argument into
  // msin (k, dt_dim), computed while they land; then the rows of a mask
  // other than 0 or 1 scaled
  __device__ __forceinline__ void copy_rows(float* kv, int m, int k, int kv_dim) const {
    dyglib::copy_rows_async(kv, kv_dim, table + static_cast<size_t>(starts[m]) * width, k,
                            width, mask + static_cast<size_t>(m) * k);
  }

  __device__ __forceinline__ void compute(float* kv, int m, int k, int kv_dim,
                                          float* msin) const {
    dyglib::stage_phi(kv + width, kv_dim, dt + static_cast<size_t>(m) * k, tw, tb, k,
                      kv_dim - width, msin);
  }

  __device__ __forceinline__ bool rescale(float* kv, int m, int k, int kv_dim) const {
    dyglib::rescale_rows(kv, kv_dim, k, width, mask + static_cast<size_t>(m) * k);
    return true;
  }
};

}  // namespace

// q3: (m, dq); table: (t_rows, width); starts: (m) int32; dt, mask: (m, k);
// tw, tb: (dt_dim); keep: (m, heads, k); wk, wv: (width + dt_dim, dq) by
// element strides; scratch: (2, m, heads, width + dt_dim); out: (m, dq).
// All f32 but starts.
DYGLIB_API int window_attention_forward(const float* q3, const float* table, const int* starts,
                                        const float* dt, const float* tw, const float* tb,
                                        const float* mask, const float* keep, const float* wk,
                                        int wk_sk, int wk_sn, const float* wv, int wv_sk,
                                        int wv_sn, float* scratch, float* out, int m, int k,
                                        int width, int dt_dim, int dq, int heads, float scale,
                                        int project_rows, int combine_rows, cudaStream_t stream) {
  const dyglib::AttentionParams p = dyglib::attention_params(
      q3, mask, keep, wk, wk_sk, wk_sn, wv, wv_sk, wv_sn, scratch, out, nullptr, m, k,
      width + dt_dim, dq, heads, scale, project_rows, combine_rows);
  return static_cast<int>(dyglib::launch_attention_forward(
      WindowLoader{table, starts, mask, dt, tw, tb, width}, p, stream));
}

// As the forward, plus dout: (m, dq). Outputs: dq3 (m, dq); dwk, dwv
// (width + dt_dim, dq); dt_grads (2, dt_dim): dtw, then dtb. Scratch: (4,
// m, heads, width + dt_dim), partial (ceil(m / chunk_rows), width + dt_dim,
// dq), part (m, 2, dt_dim). All f32 but starts; m > 0. The plan as
// temporal_attention_backward's.
DYGLIB_API int window_attention_backward(
    const float* q3, const float* table, const int* starts, const float* dt, const float* tw,
    const float* tb, const float* mask, const float* keep, const float* wk, int wk_sk, int wk_sn,
    const float* wv, int wv_sk, int wv_sn, const float* dout, float* scratch, float* partial,
    float* part, float* dq3, float* dwk, float* dwv, float* dt_grads, int m, int k, int width,
    int dt_dim, int dq, int heads, float scale, int project_rows, int combine_rows,
    int grad_rows, int chunk_rows, cudaStream_t stream) {
  const dyglib::AttentionBwdParams p = dyglib::attention_bwd_params(
      q3, mask, keep, wk, wk_sk, wk_sn, wv, wv_sk, wv_sn, dout, nullptr, scratch, partial, dq3,
      dwk, dwv, m, k, width + dt_dim, dq, heads, scale, project_rows, combine_rows, grad_rows,
      chunk_rows);
  return static_cast<int>(dyglib::launch_attention_backward(
      WindowLoader{table, starts, mask, dt, tw, tb, width},
      dyglib::PhiParamGrad{dt, part, dt_grads, dt_dim}, p, stream));
}
