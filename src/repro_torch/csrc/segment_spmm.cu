// Segment sum of edge messages into receiver nodes:
//   out[v, :] = sum over live edges e with recv[e] == v of values[e, :].
//
// Replaces src/repro/kernels/segment_spmm/kernel.py, segment_spmm_kernel
// (body _spmm_kernel). The TPU op sorts the edges by receiver, copies the
// values into that order, and turns the scatter into one-hot matmuls over a
// (node block x edge block) grid that skips the blocks whose receiver range
// misses the node block; its sort and block-range tables stand in
// ops.py's segment_plan here, built once per graph: `order` (the stable
// sort of the live receivers), `offsets` (node v owns the sorted positions
// [offsets[v], offsets[v + 1])) and a piece table.
//
// Bound on the H100: bytes (every live message read once, the order read
// once, the output written once). What the design does about what held
// the first version back:
// - No sorted copy: the kernel reads row order[i] of the values in place,
//   so the op moves no (E, D) copy (12.1 GB at ogbn-products' GCN layer 2).
// - No searches: a task reads its range from `offsets` (two loads) where
//   the first version ran two 32-ary searches of all E receivers per warp.
// - Split hubs: a node whose range is longer than `piece` edges is summed
//   in pieces of at most `piece` edges, each its own task, into float32
//   scratch; a second kernel adds a node's pieces in piece order and rounds
//   once. A node of at most `piece` edges is summed and written directly.
//   So a 459,110-edge hub no longer sets the kernel's time, and the sum
//   has a fixed order: no atomics, the same bits on every call.
// - Thread mapping by D. Narrow rows (D <= 128): a warp per task, L =
//   min(32, next power of two >= D) lanes across a row's columns (up to 4
//   columns a lane), 32 / L rows side by side, 4 rows in flight a warp
//   (or 32 / L); the warp loads 32 order entries at once and passes each
//   to its row's lanes by shuffle; the 32 / L partial sums meet in a fixed
//   xor-shuffle tree. Wide rows (D > 128): a block per (task, column
//   chunk), one thread per 16 bytes of the row (float4, or 8 bfloat16)
//   where D fills whole 16-byte vectors and the pointers are 16-byte
//   aligned, else one element a thread; each thread adds its task's rows
//   in edge order.
// Sums are float32 for float32 and bfloat16 values; offsets are 64-bit
// (E * D = 3.0e9 at ogbn-products' second GCN layer).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;            // narrow: warps per block, a task each
constexpr int kMaxK = 4;             // narrow: columns a lane holds
constexpr int kNarrowD = 32 * kMaxK;
constexpr int kUnroll = 4;           // wide: rows in flight per thread
constexpr int kWideThreads = 256;    // wide: most threads per block
constexpr int kCombineThreads = 128;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// V consecutive elements at p as floats: 16-byte loads when V > 1 (the
// caller guarantees the alignment), else one element.
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* __restrict__ p,
                                         float (&x)[V]) {
  if constexpr (V == 1) {
    x[0] = to_float(*p);
  } else {
    constexpr int kPer = 16 / sizeof(T);
    static_assert(V % kPer == 0, "whole 16-byte vectors");
#pragma unroll
    for (int h = 0; h < V / kPer; ++h) {
      const uint4 raw = reinterpret_cast<const uint4*>(p)[h];
      const T* el = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int q = 0; q < kPer; ++q) x[h * kPer + q] = to_float(el[q]);
    }
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* __restrict__ p,
                                          const float (&x)[V]) {
  if constexpr (V == 1) {
    *p = from_float<T>(x[0]);
  } else {
    constexpr int kPer = 16 / sizeof(T);
    static_assert(V % kPer == 0, "whole 16-byte vectors");
#pragma unroll
    for (int h = 0; h < V / kPer; ++h) {
      uint4 raw;
      T* el = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int q = 0; q < kPer; ++q) el[q] = from_float<T>(x[h * kPer + q]);
      reinterpret_cast<uint4*>(p)[h] = raw;
    }
  }
}

// Task t < n is node t, summed here unless its range is longer than
// `piece` (then false); task n + p is piece p. Sets the sorted range.
__device__ __forceinline__ bool task_range(
    int64_t task, int64_t n, int64_t piece,
    const int64_t* __restrict__ offsets,
    const int32_t* __restrict__ piece_node,
    const int64_t* __restrict__ piece_start, int64_t* first, int64_t* last) {
  if (task < n) {
    *first = offsets[task];
    *last = offsets[task + 1];
    return *last - *first <= piece;
  }
  const int64_t p = task - n;
  const int64_t end = offsets[static_cast<int64_t>(piece_node[p]) + 1];
  *first = piece_start[p];
  *last = *first + piece < end ? *first + piece : end;
  return true;
}

template <typename T, int L>
__global__ void __launch_bounds__(kWarps * 32)
segment_sum_narrow(const T* __restrict__ values,
                   const int32_t* __restrict__ order,
                   const int64_t* __restrict__ offsets,
                   const int32_t* __restrict__ piece_node,
                   const int64_t* __restrict__ piece_start,
                   float* __restrict__ scratch, T* __restrict__ out, int d,
                   int64_t n, int64_t n_tasks, int64_t piece) {
  constexpr int R = 32 / L;          // rows side by side
  // rows a lane loads at once: a warp keeps 4 rows in flight (R if more),
  // the fastest of U = 2, 4 and 8 at D 16 and 47 on an NVIDIA H100 80GB
  // HBM3 at 700 W
  constexpr int U = R >= 4 ? 1 : 4 / R;
  const int lane = threadIdx.x & 31;
  const int g = lane / L;            // this lane's row of the R
  const int c0 = lane % L;           // its first column
  const int64_t task = static_cast<int64_t>(blockIdx.x) * kWarps
                       + (threadIdx.x >> 5);
  if (task >= n_tasks) return;       // whole warps leave together
  int64_t first, last;
  if (!task_range(task, n, piece, offsets, piece_node, piece_start, &first,
                  &last))
    return;                          // summed in pieces
  const int k = (d - c0 + L - 1) / L;  // columns c0, c0 + L, ... below d
  float acc[kMaxK];
#pragma unroll
  for (int q = 0; q < kMaxK; ++q) acc[q] = 0.0f;
  for (int64_t base = first; base < last; base += 32) {
    const int cnt = last - base < 32 ? static_cast<int>(last - base) : 32;
    const int32_t mine = lane < cnt ? order[base + lane] : 0;
    for (int j = 0; j < cnt; j += R * U) {
      const T* src[U];
      bool ok[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int at = j + u * R + g;
        const int32_t row = __shfl_sync(0xffffffffu, mine, at & 31);
        ok[u] = at < cnt;
        src[u] = values + static_cast<int64_t>(row) * d + c0;
      }
      float v[U][kMaxK];
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int q = 0; q < kMaxK; ++q)
          v[u][q] = ok[u] && q < k ? to_float(src[u][q * L]) : 0.0f;
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int q = 0; q < kMaxK; ++q)
          if (ok[u] && q < k) acc[q] += v[u][q];
    }
  }
#pragma unroll
  for (int off = L; off < 32; off <<= 1)
#pragma unroll
    for (int q = 0; q < kMaxK; ++q)
      acc[q] += __shfl_xor_sync(0xffffffffu, acc[q], off);
  if (g != 0) return;
#pragma unroll
  for (int q = 0; q < kMaxK; ++q) {
    if (q >= k) break;
    const int64_t col = c0 + q * L;
    if (task < n)
      out[task * d + col] = from_float<T>(acc[q]);
    else
      scratch[(task - n) * d + col] = acc[q];
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kWideThreads)
segment_sum_wide(const T* __restrict__ values,
                 const int32_t* __restrict__ order,
                 const int64_t* __restrict__ offsets,
                 const int32_t* __restrict__ piece_node,
                 const int64_t* __restrict__ piece_start,
                 float* __restrict__ scratch, T* __restrict__ out, int64_t d,
                 int64_t n, int64_t piece) {
  const int64_t task = blockIdx.x;
  int64_t first, last;
  if (!task_range(task, n, piece, offsets, piece_node, piece_start, &first,
                  &last))
    return;
  const int64_t col =
      (static_cast<int64_t>(blockIdx.y) * blockDim.x + threadIdx.x) * V;
  if (col >= d) return;
  float acc[V];
#pragma unroll
  for (int q = 0; q < V; ++q) acc[q] = 0.0f;
  int64_t i = first;
  for (; i + kUnroll <= last; i += kUnroll) {
    float v[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      load_vec<T, V>(values + static_cast<int64_t>(order[i + u]) * d + col,
                     v[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int q = 0; q < V; ++q) acc[q] += v[u][q];
  }
  for (; i < last; ++i) {
    float v[V];
    load_vec<T, V>(values + static_cast<int64_t>(order[i]) * d + col, v);
#pragma unroll
    for (int q = 0; q < V; ++q) acc[q] += v[q];
  }
  if (task < n)
    store_vec<T, V>(out + task * d + col, acc);
  else
    store_vec<float, V>(scratch + (task - n) * d + col, acc);
}

// out[split_node[s]] = the sum of the node's pieces' partial sums in piece
// order, rounded once.
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
segment_combine(const float* __restrict__ scratch,
                const int32_t* __restrict__ split_node,
                const int64_t* __restrict__ split_pieces, T* __restrict__ out,
                int64_t d) {
  const int64_t s = blockIdx.x;
  const int64_t col =
      static_cast<int64_t>(blockIdx.y) * blockDim.x + threadIdx.x;
  if (col >= d) return;
  const int64_t p1 = split_pieces[s + 1];
  float acc = 0.0f;
  int64_t p = split_pieces[s];
  constexpr int kU = 8;
  for (; p + kU <= p1; p += kU) {
    float v[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) v[u] = scratch[(p + u) * d + col];
#pragma unroll
    for (int u = 0; u < kU; ++u) acc += v[u];
  }
  for (; p < p1; ++p) acc += scratch[p * d + col];
  out[static_cast<int64_t>(split_node[s]) * d + col] = from_float<T>(acc);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T>
int launch(const void* values_, const void* order_, const void* offsets_,
           const void* piece_node_, const void* piece_start_,
           const void* split_node_, const void* split_pieces_,
           void* scratch_, void* out_, int64_t d, int64_t n,
           int64_t n_pieces, int64_t n_split, int64_t piece,
           cudaStream_t stream) {
  if (n <= 0 || d <= 0) return 0;
  const T* values = static_cast<const T*>(values_);
  const int32_t* order = static_cast<const int32_t*>(order_);
  const int64_t* offsets = static_cast<const int64_t*>(offsets_);
  const int32_t* piece_node = static_cast<const int32_t*>(piece_node_);
  const int64_t* piece_start = static_cast<const int64_t*>(piece_start_);
  float* scratch = static_cast<float*>(scratch_);
  T* out = static_cast<T*>(out_);
  const int64_t tasks = n + n_pieces;
  if (d <= kNarrowD) {
    const int64_t blocks = (tasks + kWarps - 1) / kWarps;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(static_cast<unsigned>(blocks));
    const int di = static_cast<int>(d);
#define NARROW(L)                                                           \
  segment_sum_narrow<T, L><<<grid, kWarps * 32, 0, stream>>>(               \
      values, order, offsets, piece_node, piece_start, scratch, out, di, n, \
      tasks, piece)
    if (d <= 1) NARROW(1);
    else if (d <= 2) NARROW(2);
    else if (d <= 4) NARROW(4);
    else if (d <= 8) NARROW(8);
    else if (d <= 16) NARROW(16);
    else NARROW(32);
#undef NARROW
  } else {
    constexpr int kVec = 16 / sizeof(T);
    const bool vec = d % kVec == 0 && aligned16(values) && aligned16(out)
                     && aligned16(scratch);
    const int64_t cols = vec ? d / kVec : d;
    const int64_t chunks = (cols + kWideThreads - 1) / kWideThreads;
    const int64_t per = (cols + chunks - 1) / chunks;
    const int threads = static_cast<int>((per + 31) / 32 * 32);
    if (tasks > 0x7fffffffLL || chunks > 65535)
      return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(static_cast<unsigned>(tasks),
                    static_cast<unsigned>(chunks));
    if (vec)
      segment_sum_wide<T, kVec><<<grid, threads, 0, stream>>>(
          values, order, offsets, piece_node, piece_start, scratch, out, d,
          n, piece);
    else
      segment_sum_wide<T, 1><<<grid, threads, 0, stream>>>(
          values, order, offsets, piece_node, piece_start, scratch, out, d,
          n, piece);
  }
  if (n_split > 0) {
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
    const int threads = d < kCombineThreads
                            ? static_cast<int>((d + 31) / 32 * 32)
                            : kCombineThreads;
    const int64_t chunks = (d + threads - 1) / threads;
    if (n_split > 0x7fffffffLL || chunks > 65535)
      return static_cast<int>(cudaErrorInvalidValue);
    segment_combine<T><<<dim3(static_cast<unsigned>(n_split),
                              static_cast<unsigned>(chunks)),
                         threads, 0, stream>>>(
        scratch, static_cast<const int32_t*>(split_node_),
        static_cast<const int64_t*>(split_pieces_), out, d);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// values: (e, d) float32 (dtype 0) or bfloat16 (dtype 1), read in place;
// order: (e,) int32; offsets: (n + 1,) int64; piece_node, piece_start:
// (n_pieces,) int32 and int64; split_node: (n_split,) int32; split_pieces:
// (n_split + 1,) int64 (ops.segment_plan's table for pieces of at most
// `piece` edges); scratch: (n_pieces, d) float32; out: (n, d) of the
// values' type, every element written. Returns cudaGetLastError().
int segment_spmm_plan(const void* values, const void* order,
                      const void* offsets, const void* piece_node,
                      const void* piece_start, const void* split_node,
                      const void* split_pieces, void* scratch, void* out,
                      long long e, long long d, long long n,
                      long long n_pieces, long long n_split, long long piece,
                      int dtype, void* stream) {
  (void)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(values, order, offsets, piece_node, piece_start,
                         split_node, split_pieces, scratch, out, d, n,
                         n_pieces, n_split, piece, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(values, order, offsets, piece_node,
                                 piece_start, split_node, split_pieces,
                                 scratch, out, d, n, n_pieces, n_split,
                                 piece, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
