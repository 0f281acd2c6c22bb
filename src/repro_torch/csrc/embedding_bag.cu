// Embedding row gather: out[n, :] = table[ids[n], :].
//
// Replaces src/repro/kernels/embedding_bag/kernel.py, gather_rows_kernel
// (body _gather_kernel) with its lane padding in
// src/repro/kernels/embedding_bag/ops.py (gather_rows). The TPU kernel walks
// the ids one grid step at a time and DMAs one (1, D) row per step, after
// the op pads the whole table to 128 lanes. Here one thread per output
// element: neighbouring threads write neighbouring floats, so stores are
// coalesced whatever D is (a row is 40 bytes at D = 10), and the table is
// read in place, unpadded.
// Ids follow jnp.take: -V <= id < 0 counts from the end, and an id outside
// [-V, V) gives a row of NaN. The kernel never reads outside the table.
// Bound on the H100: bytes. The ids, the rows they name and the output.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__global__ void gather_rows_tile(const float* __restrict__ table,
                                 const int32_t* __restrict__ ids,
                                 float* __restrict__ out, int64_t v,
                                 int64_t d, int64_t total) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x
           + threadIdx.x; t < total; t += stride) {
    const int64_t n = t / d;
    const int64_t c = t - n * d;
    int64_t id = ids[n];
    if (id < 0) id += v;
    out[t] = (id >= 0 && id < v) ? __ldg(table + id * d + c) : NAN;
  }
}

}  // namespace

extern "C" {

// table: (v, d) float32, ids: (n,) int32, out: (n, d) float32.
// Returns cudaGetLastError().
int embedding_gather_rows(const void* table, const void* ids, void* out,
                          long long v, long long d, long long n,
                          void* stream) {
  const int64_t total = static_cast<int64_t>(n) * d;
  if (total <= 0) return 0;
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;   // grid-stride beyond
  gather_rows_tile<<<static_cast<unsigned>(blocks), threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const int32_t*>(ids),
      static_cast<float*>(out), v, d, total);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
