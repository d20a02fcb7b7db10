// TGAT's window-gather fused attention at layer 1:
//   kv[r] = [table[starts[m] + j] * mask[r] || cos(dt[r] * tw + tb)]   r = m * K + j
// then masked softmax, keep and weighted sum, reassociated so that no kv
// row is projected (attention_core.cuh); writes out (m, dq).
//
// Replaces dyglib_tpu/ops/pallas/window_attention.py::_fwd_kernel (_core).
// Under the recent strategy a query's K neighbors are K consecutive rows
// of the entry-ordered table (graph/csr.py feat_entry, packed row-major,
// dn + de columns), one contiguous block (K * 1376 bytes at 344 columns):
// the loader stages exactly those rows with 16-byte loads, times the mask
// in shared memory (a masked row is not read and stages as zeros, as
// gathered id-0 rows are), and computes Phi there, each cosine once
// (phi.cuh rounding, accurate cosf). No aligned superset windows, keep
// rescale or zero weight rows: those are Mosaic DMA aids. Every
// starts[m] + j lies inside the table (the caller clamps the starts).
//
// Backward: replaces ::_bwd_kernel (attention_bwd.cuh, the same loader):
// dq3, dWk, dWv, and dtw, dtb through the Phi columns; the table gets no
// gradient.
#include "attention_bwd.cuh"

namespace {

struct WindowLoader {
  const float* __restrict__ table;  // (t_rows, width)
  const int* __restrict__ starts;   // (m)
  const float* __restrict__ mask;   // (m * k)
  const float* __restrict__ dt;     // (m * k)
  const float* __restrict__ tw;     // (dt_dim)
  const float* __restrict__ tb;     // (dt_dim)
  int k;
  int width;

  __device__ __forceinline__ float operator()(int r, int c) const {
    if (c < width) {
      const int q = r / k;
      const size_t row = static_cast<size_t>(starts[q]) + (r - q * k);
      return table[row * width + c] * mask[r];
    }
    c -= width;
    return cosf(dyglib::theta_of(dt[r], tw[c], tb[c]));
  }

  // query m's k rows into kv (k, width + dt_dim) in shared memory
  __device__ __forceinline__ void stage(float* kv, int m, int k, int kv_dim) const {
    const size_t r0 = static_cast<size_t>(m) * k;
    dyglib::stage_rows(kv, kv_dim, table + static_cast<size_t>(starts[m]) * width, k, width,
                       mask + r0);
    dyglib::stage_phi(kv + width, kv_dim, dt + r0, tw, tb, k, kv_dim - width);
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
                                        cudaStream_t stream) {
  const dyglib::AttentionParams p =
      dyglib::attention_params(q3, mask, keep, wk, wk_sk, wk_sn, wv, wv_sk, wv_sn, scratch, out,
                               nullptr, m, k, width + dt_dim, dq, heads, scale);
  return static_cast<int>(dyglib::launch_attention_forward(
      WindowLoader{table, starts, mask, dt, tw, tb, k, width}, p, stream));
}

// As the forward, plus dout: (m, dq). Outputs: dq3 (m, dq); dwk, dwv
// (width + dt_dim, dq); dtw, dtb (dt_dim). Scratch: (4, m, heads, width +
// dt_dim), partial (ceil(m / chunk_rows), width + dt_dim, dq), part_tw and
// part_tb (m, dt_dim). All f32 but starts; m > 0.
DYGLIB_API int window_attention_backward(
    const float* q3, const float* table, const int* starts, const float* dt, const float* tw,
    const float* tb, const float* mask, const float* keep, const float* wk, int wk_sk, int wk_sn,
    const float* wv, int wv_sk, int wv_sn, const float* dout, float* scratch, float* partial,
    float* part_tw, float* part_tb, float* dq3, float* dwk, float* dwv, float* dtw, float* dtb,
    int m, int k, int width, int dt_dim, int dq, int heads, float scale, int chunk_rows,
    cudaStream_t stream) {
  const dyglib::AttentionBwdParams p = dyglib::attention_bwd_params(
      q3, mask, keep, wk, wk_sk, wk_sn, wv, wv_sk, wv_sn, dout, nullptr, scratch, partial, dq3,
      dwk, dwv, m, k, width + dt_dim, dq, heads, scale, chunk_rows);
  return static_cast<int>(dyglib::launch_attention_backward(
      WindowLoader{table, starts, mask, dt, tw, tb, k, width},
      dyglib::PhiParamGrad{dt, tw, tb, part_tw, part_tb, dtw, dtb, dt_dim}, p, stream));
}
