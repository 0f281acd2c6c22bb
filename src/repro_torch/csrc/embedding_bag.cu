// Embedding row gather: out[n, :] = table[ids[n], :], and the weighted bag
// sum out[b, :] = sum_j w[b, j] * table[ids[b, j], :].
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
//
// The bag sum replaces src/repro/kernels/embedding_bag/kernel.py,
// bag_sum_kernel (body _bag_kernel), whose grid walks (bag, slot) in order
// and carries the float32 sum in VMEM scratch from slot to slot. Here one
// block per bag, its threads across D: each thread walks the bag's slots
// in order and keeps its column's float32 sum in a register, then writes
// it once in the table's type. Weights default to 1 (a NULL pointer). Ids
// follow jnp.take as the gather does (an id outside [-V, V) gives NaN).
// The table is read in place, unpadded. Bound on the H100: bytes (the ids,
// the weights, the distinct rows named and the output).
#include <cuda_bf16.h>
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

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T>
__global__ void bag_sum_block(const T* __restrict__ table,
                              const int32_t* __restrict__ ids,
                              const float* __restrict__ weights,
                              T* __restrict__ out, int64_t v, int64_t d,
                              int64_t bag) {
  const int64_t b = blockIdx.x;
  const int32_t* bag_ids = ids + b * bag;
  const float* bag_w = weights == nullptr ? nullptr : weights + b * bag;
  for (int64_t c = threadIdx.x; c < d; c += blockDim.x) {
    float acc = 0.0f;
    for (int64_t j = 0; j < bag; ++j) {
      int64_t id = __ldg(bag_ids + j);
      if (id < 0) id += v;
      const float w = bag_w == nullptr ? 1.0f : __ldg(bag_w + j);
      const float row = (id >= 0 && id < v) ? to_float(table[id * d + c])
                                            : NAN;
      acc += row * w;
    }
    store(out + b * d + c, acc);
  }
}

template <typename T>
int bag_launch(const void* table, const void* ids, const void* weights,
               void* out, long long v, long long d, long long b,
               long long bag, void* stream) {
  if (b <= 0 || d <= 0) return 0;
  if (b > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  int threads = static_cast<int>(((d + 31) / 32) * 32);
  if (threads > 256) threads = 256;
  bag_sum_block<T><<<static_cast<unsigned>(b), threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(table), static_cast<const int32_t*>(ids),
      static_cast<const float*>(weights), static_cast<T*>(out), v, d, bag);
  return static_cast<int>(cudaGetLastError());
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

// table: (v, d) float32 (dtype 0) or bfloat16 (dtype 1); ids: (b, bag)
// int32; weights: (b, bag) float32 or NULL (all 1); out: (b, d) of the
// table's type. Returns cudaGetLastError().
int embedding_bag_sum(const void* table, const void* ids, const void* weights,
                      void* out, long long v, long long d, long long b,
                      long long bag, int dtype, void* stream) {
  if (dtype == 0)
    return bag_launch<float>(table, ids, weights, out, v, d, b, bag, stream);
  if (dtype == 1)
    return bag_launch<__nv_bfloat16>(table, ids, weights, out, v, d, b, bag,
                                     stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
