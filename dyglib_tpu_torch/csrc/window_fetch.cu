// DyGFormer's entry-window feature fetch:
//   for sequence position l of row m, src = tgt[m]                 (l == 0)
//                                          starts[m] + l - 1      (1 <= l <= counts[m])
//                                          none                   (otherwise)
//   node_out[m, l, :] = table[src, :dn]        (zeros without a src)
//   edge_out[m, l, :] = table[src, dn:dn+de]
// from the entry-ordered packed table (rows, dn + de) row-major
// (graph/csr.py feat_entry): the recent window of a row is a contiguous
// run of table rows, and row tgt[m] is the target's (node_feat || 0) row.
//
// Replaces dyglib_tpu/ops/pallas/window_fetch.py::_kernel. That kernel
// works around Mosaic's DMA rules with a 128-lane slab layout and a
// packed output; here the node and edge columns go to two contiguous
// outputs, exactly the tensors the gather path builds, so the rest of the
// network is the gather path's and the two paths agree bitwise. A block
// owns one row m and kPositions sequence positions; its threads walk the
// (position, 16-byte vector) pairs, so a warp reads consecutive vectors of
// one table row and writes consecutive vectors of one output row. Rows
// past counts[m] are never read (no guard-row reads past the window), and
// zeros are written without a load. Bound by bytes: the outputs
// (M, L, dn + de) f32 are written once, the valid rows read once.
#include "common.cuh"

namespace {

constexpr int kPositions = 16;
constexpr int kThreads = 256;

template <int kVec>
struct VecOf;
template <>
struct VecOf<4> {
  using type = float4;
  __device__ static float4 zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
};
template <>
struct VecOf<1> {
  using type = float;
  __device__ static float zero() { return 0.f; }
};

// kVec floats per access: 4 (16-byte loads and stores) when dn and de are
// multiples of 4, else 1.
template <int kVec>
__global__ void __launch_bounds__(kThreads)
    window_fetch_kernel(const float* __restrict__ table, const int* __restrict__ tgt,
                        const int* __restrict__ starts, const int* __restrict__ counts,
                        float* __restrict__ node_out, float* __restrict__ edge_out,
                        int seq_len, int tiles, int dn, int de) {
  using V = typename VecOf<kVec>::type;
  const int m = blockIdx.x / tiles;
  const int l0 = (blockIdx.x - m * tiles) * kPositions;
  const int width = dn + de;
  const int nv = dn / kVec;
  const int row_vecs = width / kVec;
  const int positions = min(kPositions, seq_len - l0);
  const int t = tgt[m], start = starts[m], count = counts[m];
  for (int e = threadIdx.x; e < positions * row_vecs; e += kThreads) {
    const int p = e / row_vecs;
    const int v = e - p * row_vecs;
    const int l = l0 + p;
    const int src = l == 0 ? t : (l - 1 < count ? start + l - 1 : -1);
    V val = VecOf<kVec>::zero();
    if (src >= 0) val = reinterpret_cast<const V*>(table + static_cast<size_t>(src) * width)[v];
    const size_t pos = static_cast<size_t>(m) * seq_len + l;
    if (v < nv)
      reinterpret_cast<V*>(node_out + pos * dn)[v] = val;
    else
      reinterpret_cast<V*>(edge_out + pos * de)[v - nv] = val;
  }
}

}  // namespace

// table: (table_rows, dn + de) f32; tgt, starts, counts: (m) int32 absolute
// table rows; node_out: (m, seq_len, dn) f32; edge_out: (m, seq_len, de) f32.
DYGLIB_API int window_fetch_forward(const float* table, const int* tgt, const int* starts,
                                    const int* counts, float* node_out, float* edge_out, int m,
                                    int seq_len, int dn, int de, cudaStream_t stream) {
  if (m == 0 || seq_len == 0) return 0;
  const int tiles = (seq_len + kPositions - 1) / kPositions;
  const dim3 grid(static_cast<unsigned>(m) * tiles);
  if (dn % 4 == 0 && de % 4 == 0)
    window_fetch_kernel<4><<<grid, kThreads, 0, stream>>>(table, tgt, starts, counts, node_out,
                                                          edge_out, seq_len, tiles, dn, de);
  else
    window_fetch_kernel<1><<<grid, kThreads, 0, stream>>>(table, tgt, starts, counts, node_out,
                                                          edge_out, seq_len, tiles, dn, de);
  return static_cast<int>(cudaGetLastError());
}
