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
// and carries the float32 sum in VMEM scratch from slot to slot. Here a
// warp takes a bag, or several where a row is narrow: kernel.bag_plan
// gives each row `lanes` lanes, each reading one vector of W elements (the
// widest access the row's alignment allows: 8-byte loads of the 40-byte
// float32 rows at D = 10, 5 lanes a row), and `rows` rows a step (6 at
// D = 10), so that a warp step reads rows x D elements of different slots.
// The bag's ids and weights are loaded once, coalesced, a lane a slot, and
// handed to the lanes that read the row by shuffle; each lane keeps
// kBagUnroll loads in flight and its float32 sums in registers. The rows'
// partial sums are then added by a fixed shuffle tree over the row slots
// of the step (p + off into p, off halving), so the result is
// deterministic: repeated launches are bit-identical, with no atomics. The
// order of the sum differs from the reference's slot order. Weights
// default to 1 (a NULL pointer). Ids follow jnp.take as the gather does (an
// id outside [-V, V) gives NaN). The table is read in place, unpadded.
// Bound on the H100: bytes (the ids, the weights, the distinct rows named
// and the output); a row of 40 bytes spans two 32-byte sectors, so the
// sectors the distinct rows touch bound it more tightly.
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

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

constexpr int kBagWarps = 8;         // warps per block
constexpr int kBagUnroll = 8;        // row vectors in flight per lane
constexpr int kBagChunks = 2;        // chunks of ids a lane holds at once

// W elements of T as one load: 2, 4, 8 or 16 bytes.
template <int BYTES> struct Raw;
template <> struct Raw<2> { using type = uint16_t; };
template <> struct Raw<4> { using type = uint32_t; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<16> { using type = uint4; };

// 32-bit word i (a constant once unrolled) of a load.
__device__ __forceinline__ uint32_t word_of(uint16_t x, int) { return x; }
__device__ __forceinline__ uint32_t word_of(uint32_t x, int) { return x; }
__device__ __forceinline__ uint32_t word_of(const uint2& x, int i) {
  return i == 0 ? x.x : x.y;
}
__device__ __forceinline__ uint32_t word_of(const uint4& x, int i) {
  return i == 0 ? x.x : (i == 1 ? x.y : (i == 2 ? x.z : x.w));
}

// Element e of a load as float: a float32 is its word; a bfloat16 is the
// high half of a float32 (element 0 in a word's low half).
template <typename T> struct Elem;
template <> struct Elem<float> {
  template <typename V>
  __device__ __forceinline__ static float get(const V& x, int e) {
    return __uint_as_float(word_of(x, e));
  }
};
template <> struct Elem<__nv_bfloat16> {
  template <typename V>
  __device__ __forceinline__ static float get(const V& x, int e) {
    const uint32_t w = word_of(x, e >> 1);
    return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
  }
};

template <typename T, int W>
__device__ __forceinline__ void fma_vec(float (&acc)[W],
                                        const typename Raw<W * sizeof(T)>::type& x,
                                        float w) {
#pragma unroll
  for (int e = 0; e < W; ++e) acc[e] += Elem<T>::get(x, e) * w;
}

// out[b, :] = sum_j w[b, j] * table[ids[b, j], :]. Lane layout: bag group g
// = lane / (lanes * rows), in it row slot p and vector q; lanes past the
// groups idle. When a row has more than 32 vectors, lanes is 32, rows 1,
// and the warp walks the row in blocks of 32 vectors.
template <typename T, int W>
__global__ void __launch_bounds__(kBagWarps * 32)
bag_sum_warp(const T* __restrict__ table, const int32_t* __restrict__ ids,
             const float* __restrict__ weights, T* __restrict__ out,
             int64_t v, int d, int64_t b, int bag, int lanes, int rows,
             int groups) {
  using Vec = typename Raw<W * sizeof(T)>::type;
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      static_cast<int64_t>(blockIdx.x) * kBagWarps + (threadIdx.x >> 5);
  if (warp * groups >= b) return;    // whole warps leave together
  const int span = lanes * rows;     // a group's lanes, and its slots a chunk
  const int g = lane / span;
  const int t = lane - g * span;
  const int p = t / lanes;
  const int q = t - p * lanes;
  const int64_t bi = warp * groups + g;
  const bool mine = g < groups && bi < b;
  const int32_t* bag_ids = ids + (mine ? bi : 0) * bag;
  const float* bag_w =
      weights == nullptr ? nullptr : weights + (mine ? bi : 0) * bag;
  const int nvec = d / W;
  int top = 1;                       // the tree's first offset, doubled
  while (top < rows) top <<= 1;
  for (int v0 = 0; v0 < nvec; v0 += lanes) {
    const int qv = v0 + q;
    const bool reads = mine && qv < nvec;
    float acc[W];
#pragma unroll
    for (int e = 0; e < W; ++e) acc[e] = 0.0f;
    // a window of kBagChunks chunks of span slots: lane t of the group
    // holds slot w0 + ch * span + t of its bag (its row, -1 out of range)
    for (int w0 = 0; w0 < bag; w0 += kBagChunks * span) {
      int64_t id[kBagChunks];
      float wt[kBagChunks];
#pragma unroll
      for (int ch = 0; ch < kBagChunks; ++ch) {
        const int j = w0 + ch * span + t;
        id[ch] = -1;
        wt[ch] = 0.0f;
        if (mine && j < bag) {
          int64_t x = __ldg(bag_ids + j);
          if (x < 0) x += v;
          id[ch] = x < v ? x : -1;
          wt[ch] = bag_w == nullptr ? 1.0f : __ldg(bag_w + j);
        }
      }
      const int n = bag - w0 < kBagChunks * span ? bag - w0
                                                  : kBagChunks * span;
      const int steps = (n + rows - 1) / rows;
      // step s reads window slot s * rows + p = ch * span + within * rows
      // + p, with ch = s / lanes, held by lane within * rows + p
      for (int s0 = 0; s0 < steps; s0 += kBagUnroll) {
        Vec x[kBagUnroll];
        float xw[kBagUnroll];
        bool live[kBagUnroll], bad[kBagUnroll];
#pragma unroll
        for (int u = 0; u < kBagUnroll; ++u) {
          const int s = s0 + u;
          const int ch = s / lanes;
          const int within = s - ch * lanes;
          const int src = (g * span + within * rows + p) & 31;
          int64_t hid = id[0];
          float hw = wt[0];
#pragma unroll
          for (int c = 1; c < kBagChunks; ++c) {
            if (ch == c) {
              hid = id[c];
              hw = wt[c];
            }
          }
          const int64_t rid = __shfl_sync(0xffffffffu, hid, src);
          xw[u] = __shfl_sync(0xffffffffu, hw, src);
          live[u] = reads && s < steps && s * rows + p < n;
          bad[u] = live[u] && rid < 0;
          if (live[u] && rid >= 0)
            x[u] = __ldg(reinterpret_cast<const Vec*>(table + rid * d) + qv);
        }
#pragma unroll
        for (int u = 0; u < kBagUnroll; ++u) {
          if (bad[u]) {
#pragma unroll
            for (int e = 0; e < W; ++e) acc[e] = NAN;
          } else if (live[u]) {
            fma_vec<T, W>(acc, x[u], xw[u]);
          }
        }
      }
    }
    // the row slots' partial sums: p + off into p, off halving
    for (int off = top >> 1; off > 0; off >>= 1) {
#pragma unroll
      for (int e = 0; e < W; ++e) {
        const float o = __shfl_down_sync(0xffffffffu, acc[e], off * lanes);
        if (p < off && p + off < rows) acc[e] += o;
      }
    }
    if (reads && p == 0) {
      T* dst = out + bi * d + static_cast<int64_t>(qv) * W;
#pragma unroll
      for (int e = 0; e < W; ++e) store(dst + e, acc[e]);
    }
  }
}

template <typename T, int W>
int bag_launch(const void* table, const void* ids, const void* weights,
               void* out, long long v, long long d, long long b,
               long long bag, long long lanes, long long rows,
               long long groups, void* stream) {
  const long long warps = (b + groups - 1) / groups;
  const long long blocks = (warps + kBagWarps - 1) / kBagWarps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  bag_sum_warp<T, W><<<static_cast<unsigned>(blocks), kBagWarps * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(table), static_cast<const int32_t*>(ids),
      static_cast<const float*>(weights), static_cast<T*>(out), v,
      static_cast<int>(d), b, static_cast<int>(bag), static_cast<int>(lanes),
      static_cast<int>(rows), static_cast<int>(groups));
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
// table's type. w: elements a load; lanes, rows, groups: the lanes a row,
// rows a step and bags a warp (kernel.bag_plan). Returns
// cudaGetLastError().
int embedding_bag_sum(const void* table, const void* ids, const void* weights,
                      void* out, long long v, long long d, long long b,
                      long long bag, int dtype, long long w, long long lanes,
                      long long rows, long long groups, void* stream) {
  if (b <= 0 || d <= 0) return 0;
  const long long esize = dtype == 0 ? 4 : 2;
  const long long nvec = w > 0 ? d / w : 0;
  const uintptr_t align = static_cast<uintptr_t>(w * esize);
  if ((dtype != 0 && dtype != 1) || w < 1 || d % w != 0 || bag < 0
      || bag > 0x7fffffffLL || d > 0x7fffffffLL || lanes < 1 || rows < 1
      || groups < 1 || lanes * rows * groups > 32
      || (nvec <= 32 ? lanes != nvec : (lanes != 32 || rows != 1
                                         || groups != 1))
      || reinterpret_cast<uintptr_t>(table) % align != 0
      || reinterpret_cast<uintptr_t>(out) % align != 0
      || (ids == nullptr && bag > 0))
    return static_cast<int>(cudaErrorInvalidValue);
#define BAG_CASE(T, WIDTH)                                                  \
  return bag_launch<T, WIDTH>(table, ids, weights, out, v, d, b, bag, lanes, \
                              rows, groups, stream)
  if (dtype == 0) {
    if (w == 4) BAG_CASE(float, 4);
    if (w == 2) BAG_CASE(float, 2);
    if (w == 1) BAG_CASE(float, 1);
  } else {
    if (w == 8) BAG_CASE(__nv_bfloat16, 8);
    if (w == 4) BAG_CASE(__nv_bfloat16, 4);
    if (w == 2) BAG_CASE(__nv_bfloat16, 2);
    if (w == 1) BAG_CASE(__nv_bfloat16, 1);
  }
#undef BAG_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
