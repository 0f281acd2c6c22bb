// Merge-join candidate ranges and the expand-join compatibility matrix.
//
// kg_join_ranges replaces src/repro/kernels/kg_join/kernel.py,
// join_ranges_kernel (body _ranges_kernel) with its padding in
// src/repro/kernels/kg_join/ops.py (join_ranges). For every instance i,
// key block b and table-row key r:
//   lo[i, b, r] = #{c : keys[i, b, c] <  rkey[i, r]}
//   hi[i, b, r] = #{c : keys[i, b, c] <= rkey[i, r]}
// keys are sorted per block (invalid entries INT_MAX-padded) and rkey <
// INT_MAX, so both counts are a lower and an upper bound found by binary
// search: integer-identical to searchsorted left and right. The TPU kernel
// counts by comparing whole tiles because gathers are slow there; here one
// thread per (instance, block, row key) runs the two searches.
// Bound on the H100: bytes of keys read and of lo/hi written; the search
// reads about log2(C) keys per thread, most of them from L2 once a block's
// keys are warm. Staging key tiles in shared memory is left for later.
//
// kg_compat_matrix replaces src/repro/kernels/kg_join/kernel.py,
// compat_matrix_kernel (body _compat_kernel) with its padding in
// src/repro/kernels/kg_join/ops.py (compat_matrix):
//   out[i, r, c] = tmask[i, r] && mmask[i, c] && for every position pos with
//                  kind[i, pos] == 1: table[i, r, clip(col[i, pos])] ==
//                                     matches[i, c, pos]
// kind and col are data, so one kernel serves every plan of a bucket.
// Bound on the H100: bytes, dominated by the R x C output. Each block owns
// a 64 x 128 output tile: the (at most three) selected table columns of its
// rows, its match columns and both masks go to shared memory once, and each
// thread computes four neighbouring columns and writes them as one 32-bit
// store when the row stride allows it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void join_ranges(const int32_t* __restrict__ keys,
                            const int32_t* __restrict__ rkey,
                            int32_t* __restrict__ lo, int32_t* __restrict__ hi,
                            int64_t total, int64_t sb, int64_t c, int64_t r) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x
      + threadIdx.x;
  if (t >= total) return;
  const int64_t row = t / r;             // instance * sb + block
  const int64_t j = t - row * r;
  const int64_t inst = row / sb;
  const int32_t key = rkey[inst * r + j];
  const int32_t* k = keys + row * c;
  int64_t a = 0, b = c;
  while (a < b) {                        // first index with k >= key
    const int64_t m = (a + b) >> 1;
    if (k[m] < key) a = m + 1; else b = m;
  }
  const int64_t l = a;
  b = c;
  while (a < b) {                        // first index with k > key
    const int64_t m = (a + b) >> 1;
    if (k[m] <= key) a = m + 1; else b = m;
  }
  lo[t] = static_cast<int32_t>(l);
  hi[t] = static_cast<int32_t>(a);
}

constexpr int kRows = 64;      // output rows per block
constexpr int kCols = 128;     // output columns per block
constexpr int kVec = 4;        // columns per thread
constexpr int kThreadsX = kCols / kVec;   // 32
constexpr int kThreadsY = 8;

__global__ void compat_matrix(const int32_t* __restrict__ table,
                              const uint8_t* __restrict__ tmask,
                              const int32_t* __restrict__ matches,
                              const uint8_t* __restrict__ mmask,
                              const int32_t* __restrict__ kind,
                              const int32_t* __restrict__ col,
                              uint8_t* __restrict__ out,
                              int64_t r, int64_t v, int64_t c) {
  __shared__ int32_t tval[3][kRows];
  __shared__ uint8_t tm[kRows];
  __shared__ int32_t mval[3][kCols];
  __shared__ uint8_t mm[kCols];
  const int64_t inst = blockIdx.z;
  const int64_t r0 = static_cast<int64_t>(blockIdx.y) * kRows;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * kCols;
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  const int n_threads = kThreadsX * kThreadsY;

  bool use[3];
  int64_t cc[3];
#pragma unroll
  for (int pos = 0; pos < 3; ++pos) {
    use[pos] = kind[inst * 3 + pos] == 1;
    int64_t x = col[inst * 3 + pos];
    cc[pos] = x < 0 ? 0 : (x > v - 1 ? v - 1 : x);
  }
  for (int i = tid; i < kRows; i += n_threads) {
    const int64_t rr = r0 + i;
    const bool live = rr < r;
    tm[i] = live ? tmask[inst * r + rr] : 0;
#pragma unroll
    for (int pos = 0; pos < 3; ++pos)
      tval[pos][i] = live ? table[(inst * r + rr) * v + cc[pos]] : 0;
  }
  for (int i = tid; i < kCols; i += n_threads) {
    const int64_t ci = c0 + i;
    const bool live = ci < c;
    mm[i] = live ? mmask[inst * c + ci] : 0;
#pragma unroll
    for (int pos = 0; pos < 3; ++pos)
      mval[pos][i] = live ? matches[(inst * c + ci) * 3 + pos] : 0;
  }
  __syncthreads();

  const int cx = threadIdx.x * kVec;
  const int64_t cbase = c0 + cx;
  const bool wide = (c % kVec == 0) && (cbase + kVec <= c);
  for (int i = threadIdx.y; i < kRows; i += kThreadsY) {
    const int64_t rr = r0 + i;
    if (rr >= r) break;
    uint32_t word = 0;
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      bool ok = tm[i] && mm[cx + k];
#pragma unroll
      for (int pos = 0; pos < 3; ++pos)
        ok = ok && (!use[pos] || tval[pos][i] == mval[pos][cx + k]);
      word |= static_cast<uint32_t>(ok ? 1u : 0u) << (8 * k);
    }
    uint8_t* dst = out + (inst * r + rr) * c + cbase;
    if (wide) {
      *reinterpret_cast<uint32_t*>(dst) = word;
    } else {
      for (int k = 0; k < kVec && cbase + k < c; ++k)
        dst[k] = static_cast<uint8_t>((word >> (8 * k)) & 0xffu);
    }
  }
}

}  // namespace

extern "C" {

// keys: (instances * sb, c) int32, rkey: (instances, r) int32,
// lo/hi: (instances * sb, r) int32. Returns cudaGetLastError().
int kg_join_ranges(const void* keys, const void* rkey, void* lo, void* hi,
                   long long instances, long long sb, long long c,
                   long long r, void* stream) {
  const int64_t total = static_cast<int64_t>(instances) * sb * r;
  if (total <= 0 || c <= 0) return 0;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  join_ranges<<<static_cast<unsigned>(blocks), threads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(keys), static_cast<const int32_t*>(rkey),
      static_cast<int32_t*>(lo), static_cast<int32_t*>(hi), total, sb, c, r);
  return static_cast<int>(cudaGetLastError());
}

// table: (instances, r, v) int32, tmask: (instances, r) uint8,
// matches: (instances, c, 3) int32, mmask: (instances, c) uint8,
// kind/col: (instances, 3) int32, out: (instances, r, c) uint8.
int kg_compat_matrix(const void* table, const void* tmask, const void* matches,
                     const void* mmask, const void* kind, const void* col,
                     void* out, long long instances, long long r, long long v,
                     long long c, void* stream) {
  if (instances <= 0 || r <= 0 || c <= 0) return 0;
  const int64_t gy = (r + kRows - 1) / kRows;
  const int64_t gx = (c + kCols - 1) / kCols;
  if (instances > 65535 || gy > 65535 || gx > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy),
            static_cast<unsigned>(instances));
  dim3 block(kThreadsX, kThreadsY);
  compat_matrix<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(table), static_cast<const uint8_t*>(tmask),
      static_cast<const int32_t*>(matches), static_cast<const uint8_t*>(mmask),
      static_cast<const int32_t*>(kind), static_cast<const int32_t*>(col),
      static_cast<uint8_t*>(out), r, v, c);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
