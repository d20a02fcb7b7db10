// Per-row co-occurrence counts:
//   out[r, i] = #{ j : q[r, i] == k[r, j] }   (as float)
// for q (R, Lq) and k (R, Lk) int32 ids, Lq and Lk independent.
//
// Replaces dyglib_tpu/ops/pallas/cooccurrence.py::_kernel. A block owns
// row r and a tile of query positions, one per thread; row r's keys stream
// through shared memory in chunks, and every thread compares its query
// against each staged key (a broadcast read). No padding sentinels are
// needed: positions past Lq are masked, and keys are read only below Lk.
#include "common.cuh"

namespace {

constexpr int kKeyChunk = 2048;
constexpr int kMaxThreads = 256;

__global__ void __launch_bounds__(kMaxThreads)
    cooccurrence_kernel(const int* __restrict__ q, const int* __restrict__ k,
                        float* __restrict__ out, int lq, int lk) {
  __shared__ int k_s[kKeyChunk];
  const size_t r = blockIdx.x;
  const int i = blockIdx.y * blockDim.x + threadIdx.x;
  const int qv = i < lq ? q[r * lq + i] : 0;
  const int* krow = k + r * lk;
  int count = 0;
  for (int k0 = 0; k0 < lk; k0 += kKeyChunk) {
    const int n = min(kKeyChunk, lk - k0);
    for (int t = threadIdx.x; t < n; t += blockDim.x) k_s[t] = krow[k0 + t];
    __syncthreads();
#pragma unroll 8
    for (int t = 0; t < n; ++t) count += (k_s[t] == qv);
    __syncthreads();
  }
  if (i < lq) out[r * lq + i] = static_cast<float>(count);
}

}  // namespace

// q: (rows, lq) int32; k: (rows, lk) int32; out: (rows, lq) f32.
DYGLIB_API int cooccurrence_forward(const int* q, const int* k, float* out, int rows, int lq,
                                    int lk, cudaStream_t stream) {
  if (rows == 0 || lq == 0) return 0;
  const int threads = min(kMaxThreads, (lq + 31) / 32 * 32);
  const dim3 grid(rows, (lq + threads - 1) / threads);
  cooccurrence_kernel<<<grid, threads, 0, stream>>>(q, k, out, lq, lk);
  return static_cast<int>(cudaGetLastError());
}
