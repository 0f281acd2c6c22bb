// Embedding row gather: out[n, :] = table[ids[n], :], and the weighted bag
// sum out[b, :] = sum_j w[b, j] * table[ids[b, j], :].
//
// The gather replaces src/repro/kernels/embedding_bag/kernel.py,
// gather_rows_kernel (body _gather_kernel) with its lane padding in
// src/repro/kernels/embedding_bag/ops.py (gather_rows). The TPU kernel walks
// the ids one grid step at a time and DMAs one (1, D) row per step, after
// the op pads the whole table to 128 lanes. Here the table is read in
// place, unpadded, and a warp moves a tile of 32 rows: each lane loads one
// id, once, and the lanes that copy a row take its table row from that lane
// by shuffle. The lanes walk the tile's 32 x D elements in vectors of W
// floats, the widest access that the row's alignment allows (W = 4 where
// D % 4 == 0, 2 where D is even: 8-byte loads of the 40-byte rows at
// D = 10, else 1), with 32-bit index arithmetic inside the tile, and store
// them straight into the tile's output, one contiguous span of 32 x D
// floats. Ids follow jnp.take: -V <= id < 0 counts from the end, and an id
// outside [-V, V) gives a row of NaN. The kernel never reads outside the
// table (the row is 64-bit: V may exceed 2^31).
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

constexpr int kGatherWarps = 4;      // warps per block, a 32-row tile each
constexpr int kGatherUnroll = 4;     // vectors in flight per lane

template <int W> struct FloatVec;
template <> struct FloatVec<1> { using type = float; };
template <> struct FloatVec<2> { using type = float2; };
template <> struct FloatVec<4> { using type = float4; };

template <int W>
__device__ __forceinline__ typename FloatVec<W>::type nan_vec() {
  typename FloatVec<W>::type x;
  float* el = reinterpret_cast<float*>(&x);
#pragma unroll
  for (int q = 0; q < W; ++q) el[q] = NAN;
  return x;
}

template <int W>
__global__ void __launch_bounds__(kGatherWarps * 32)
gather_rows_warp(const float* __restrict__ table,
                 const int32_t* __restrict__ ids, float* __restrict__ out,
                 int64_t v, int d, int64_t n) {
  using Vec = typename FloatVec<W>::type;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t base =
      (static_cast<int64_t>(blockIdx.x) * kGatherWarps + warp) * 32;
  if (base >= n) return;             // whole warps leave together
  const int rows = n - base < 32 ? static_cast<int>(n - base) : 32;
  // this lane's table row, from its id loaded once; -1 for no row
  int64_t row = -1;
  if (lane < rows) {
    int64_t id = ids[base + lane];
    if (id < 0) id += v;
    if (id >= 0 && id < v) row = id;
  }
  const int per = d / W;             // vectors per row
  const int total = rows * per;      // vectors in the tile
  Vec* dst = reinterpret_cast<Vec*>(out + base * d);
  for (int s0 = 0; s0 < total; s0 += 32 * kGatherUnroll) {
    Vec x[kGatherUnroll];
#pragma unroll
    for (int u = 0; u < kGatherUnroll; ++u) {
      const int s = s0 + u * 32 + lane;
      const int r = s < total ? s / per : 0;
      const int64_t rr = __shfl_sync(0xffffffffu, row, r);
      const int c = s - r * per;
      x[u] = s < total && rr >= 0
                 ? __ldg(reinterpret_cast<const Vec*>(table + rr * d) + c)
                 : nan_vec<W>();
    }
#pragma unroll
    for (int u = 0; u < kGatherUnroll; ++u) {
      const int s = s0 + u * 32 + lane;
      if (s < total) dst[s] = x[u];
    }
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
  if (n <= 0 || d <= 0) return 0;
  if (d > 0x7fffffffLL / 32) return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t t = reinterpret_cast<uintptr_t>(table);
  const uintptr_t o = reinterpret_cast<uintptr_t>(out);
  const int w = d % 4 == 0 && t % 16 == 0 && o % 16 == 0   ? 4
                : d % 2 == 0 && t % 8 == 0 && o % 8 == 0 ? 2
                                                           : 1;
  const int64_t tiles = (n + 31) / 32;
  const int64_t blocks = (tiles + kGatherWarps - 1) / kGatherWarps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* tb = static_cast<const float*>(table);
  const int32_t* id = static_cast<const int32_t*>(ids);
  float* ob = static_cast<float*>(out);
  const int di = static_cast<int>(d);
  if (w == 4)
    gather_rows_warp<4><<<grid, kGatherWarps * 32, 0, s>>>(tb, id, ob, v, di,
                                                           n);
  else if (w == 2)
    gather_rows_warp<2><<<grid, kGatherWarps * 32, 0, s>>>(tb, id, ob, v, di,
                                                           n);
  else
    gather_rows_warp<1><<<grid, kGatherWarps * 32, 0, s>>>(tb, id, ob, v, di,
                                                           n);
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
