// Native host-side temporal-CSR builder.
//
// Replaces the numpy path in dyglib_tpu_torch/graph/csr.py (interleave + stable
// argsort, O(E log E)) with a single-pass counting sort, O(E). The entry
// order contract is identical to the reference adjacency build
// (utils/utils.py:96-103): edges are visited in stream (chronological)
// order and each edge appends its src-side entry before its dst-side
// entry, so every node's segment is chronological with ties broken by
// edge order and src-entry-before-dst-entry.
//
// Build: g++ -O3 -shared -fPIC -o _csr_native.so csr_builder.cpp
// (done automatically, once, by dyglib_tpu_torch/native/__init__.py).

#include <cstdint>

extern "C" {

// All output buffers are allocated by the caller:
//   offsets: num_nodes + 1 int64
//   nbr/eid_out: 2 * num_edges int32
//   ts_out: 2 * num_edges double
void build_temporal_csr(const int64_t* src, const int64_t* dst,
                        const int64_t* eid, const double* ts,
                        int64_t num_edges, int64_t num_nodes,
                        int64_t* offsets, int32_t* nbr, int32_t* eid_out,
                        double* ts_out) {
  for (int64_t n = 0; n <= num_nodes; ++n) offsets[n] = 0;
  for (int64_t e = 0; e < num_edges; ++e) {
    ++offsets[src[e] + 1];
    ++offsets[dst[e] + 1];
  }
  for (int64_t n = 0; n < num_nodes; ++n) offsets[n + 1] += offsets[n];

  // cursor[n] = next free slot in node n's segment; reuse a scratch pass
  // over offsets by tracking cursors in a separate stack allocation would
  // need num_nodes memory anyway, so the caller passes none and we keep a
  // local heap block.
  int64_t* cursor = new int64_t[num_nodes];
  for (int64_t n = 0; n < num_nodes; ++n) cursor[n] = offsets[n];

  for (int64_t e = 0; e < num_edges; ++e) {
    const int64_t s = src[e], d = dst[e];
    int64_t p = cursor[s]++;
    nbr[p] = static_cast<int32_t>(d);
    eid_out[p] = static_cast<int32_t>(eid[e]);
    ts_out[p] = ts[e];
    p = cursor[d]++;
    nbr[p] = static_cast<int32_t>(s);
    eid_out[p] = static_cast<int32_t>(eid[e]);
    ts_out[p] = ts[e];
  }
  delete[] cursor;
}

}  // extern "C"
