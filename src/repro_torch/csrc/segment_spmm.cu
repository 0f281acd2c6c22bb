// Segment sum of edge messages into receiver nodes:
//   out[v, :] = sum over live edges e with recv[e] == v of values[e, :].
//
// Replaces src/repro/kernels/segment_spmm/kernel.py, segment_spmm_kernel
// (body _spmm_kernel), with the sort and masking of
// src/repro/kernels/segment_spmm/ops.py (segment_spmm), which stays in the
// Python wrapper here. The TPU kernel turns the scatter into one-hot
// matmuls over a (node block x edge block) grid and skips the blocks whose
// receiver range misses the node block. On this card that grid would be
// N/128 x E/512 = 2.4e9 blocks at ogbn-products, almost all skipped, and a
// grid step carries no sum to the next. Here the edges arrive sorted by
// receiver, so each node owns one contiguous edge range: one warp per
// (node, 32-column chunk of D) finds its range by two 32-ary searches of
// the sorted receivers (each step, the 32 lanes probe 32 positions and a
// ballot keeps the interval that holds the boundary: 6 dependent loads for
// 64M edges) and sums the rows of the range in edge order in float32,
// lane c on column c of the chunk, then rounds once to the output type.
// The sum is deterministic (no atomics), needs no padding of E or N, and
// never reads an edge outside a node's range: masked edges carry a
// receiver past every node, or, with a mask pointer, are skipped.
// Offsets are 64-bit: at ogbn-products' second GCN layer E * D = 3.0e9.
// Bound on the H100: bytes (every message read once, the output written
// once). A hub node's range is summed by one warp, serially, so its time
// is that of its loads' latency: each lane keeps 32 rows in flight on a
// long range (then 8, then 1 for the tail), still added in edge order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;           // warps per block

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// First index i in [0, e) with recv[i] >= key (e if none), by the whole
// warp; every lane returns the same value.
__device__ __forceinline__ int64_t lower_bound_warp(
    const int32_t* __restrict__ recv, int64_t e, int32_t key, int lane) {
  int64_t lo = 0, hi = e;            // answer in [lo, hi]
  while (hi - lo > 32) {
    const int64_t step = (hi - lo + 31) / 32;
    const int64_t p = lo + lane * step;
    const bool less = p < hi && __ldg(recv + p) < key;
    const int k = __popc(__ballot_sync(0xffffffffu, less));
    if (k == 0) return lo;           // recv[lo] >= key
    const int64_t top = lo + static_cast<int64_t>(k) * step;
    lo = lo + static_cast<int64_t>(k - 1) * step + 1;
    hi = top < hi ? top : hi;
  }
  const int64_t p = lo + lane;
  const bool less = p < hi && __ldg(recv + p) < key;
  return lo + __popc(__ballot_sync(0xffffffffu, less));
}

// acc += rows [*i, *i + W * floor((last - *i) / W)) of column ``src``, in
// order, W loads issued before the first add.
template <int W, typename T>
__device__ __forceinline__ void sum_rows(const T* __restrict__ src,
                                         int64_t d, int64_t* i, int64_t last,
                                         float* acc) {
  for (; *i + W <= last; *i += W) {
    float v[W];
#pragma unroll
    for (int u = 0; u < W; ++u) v[u] = to_float(src[(*i + u) * d]);
#pragma unroll
    for (int u = 0; u < W; ++u) *acc += v[u];
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
segment_sum_warp(const T* __restrict__ values,
                 const int32_t* __restrict__ recv,
                 const uint8_t* __restrict__ mask, T* __restrict__ out,
                 int64_t e, int64_t d, int64_t n, int64_t n_chunks) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = static_cast<int64_t>(blockIdx.x) * kWarps
                       + (threadIdx.x >> 5);
  if (warp >= n * n_chunks) return;  // whole warps leave together
  const int64_t node = warp / n_chunks;
  const int64_t col = (warp - node * n_chunks) * 32 + lane;
  const int64_t first = lower_bound_warp(recv, e, static_cast<int32_t>(node),
                                         lane);
  const int64_t last = lower_bound_warp(recv, e,
                                        static_cast<int32_t>(node + 1), lane);
  if (col >= d) return;
  const T* src = values + col;
  float acc = 0.0f;
  int64_t i = first;
  if (mask == nullptr) {
    sum_rows<32>(src, d, &i, last, &acc);
    sum_rows<8>(src, d, &i, last, &acc);
    sum_rows<1>(src, d, &i, last, &acc);
  } else {
    for (; i < last; ++i) {
      if (mask[i]) acc += to_float(src[i * d]);
    }
  }
  store(out + node * d + col, acc);
}

template <typename T>
int launch(const void* values, const void* recv, const void* mask, void* out,
           long long e, long long d, long long n, void* stream) {
  if (n <= 0 || d <= 0) return 0;
  const int64_t n_chunks = (d + 31) / 32;
  const int64_t warps = static_cast<int64_t>(n) * n_chunks;
  const int64_t blocks = (warps + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  segment_sum_warp<T><<<static_cast<unsigned>(blocks), kWarps * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(values), static_cast<const int32_t*>(recv),
      static_cast<const uint8_t*>(mask), static_cast<T*>(out), e, d, n,
      n_chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// values: (e, d) float32 (dtype 0) or bfloat16 (dtype 1), rows sorted by
// recv; recv: (e,) int32, non-decreasing; mask: (e,) bool or NULL (every
// edge live); out: (n, d) of the values' type, every element written.
// Returns cudaGetLastError().
int segment_spmm_sorted(const void* values, const void* recv,
                        const void* mask, void* out, long long e,
                        long long d, long long n, int dtype, void* stream) {
  if (dtype == 0)
    return launch<float>(values, recv, mask, out, e, d, n, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(values, recv, mask, out, e, d, n, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
