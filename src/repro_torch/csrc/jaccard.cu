// Q x Q Jaccard distance matrix over a (Q, F) 0/1 membership matrix.
//
// Replaces src/repro/kernels/jaccard/kernel.py, jaccard_distance_kernel
// (body _jaccard_kernel) with its padding in src/repro/kernels/jaccard/ops.py
// (jaccard_distance):
//   inter = m @ m^T, counts = m.sum(1), union = ci + cj - inter,
//   sim = union > 0 ? inter / max(union, 1e-30) : 1,
//   d = (1 - sim) * (i == j ? 0 : 1).
// The TPU kernel pads Q and F to 128-multiples and carries the partial
// intersections of a (128, 128) output tile across its sequential feature
// grid axis. Here one block owns a 128 x 128 output tile and loops over the
// feature axis itself in steps of 8, with both operand tiles (rows i and
// rows j) in shared memory; each of its 256 threads accumulates an 8 x 8
// register tile in float32 and applies the union/distance epilogue before
// the single store. Ragged edges load zeros and are masked at the store:
// nothing is padded or copied. A first pass takes the row counts (one warp
// per row).
// Exactness: for 0/1 inputs every intersection, count and union is an
// integer below 2^24, so float32 sums are exact in any order, and the
// division is IEEE (no fast-math): the result is bit-identical to the plain
// version.
// Bound on the H100: operations. 2 Q^2 F float32 multiply-adds against
// 4 Q^2 bytes written; tensor cores (0/1 is exact in bf16 or int8) and the
// symmetry of the output are left for later.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;   // output tile edge (rows i and rows j)
constexpr int kStep = 8;     // features per shared-memory step
constexpr int kThreads = 256;

__global__ void row_counts(const float* __restrict__ m,
                           float* __restrict__ counts, int64_t q, int64_t f) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (blockDim.x / 32)
      + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= q) return;
  const float* r = m + row * f;
  float s = 0.f;
  for (int64_t k = lane; k < f; k += 32) s += r[k];
  for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  if (lane == 0) counts[row] = s;
}

__global__ void __launch_bounds__(kThreads)
jaccard_tile(const float* __restrict__ m, const float* __restrict__ counts,
             float* __restrict__ out, int64_t q, int64_t f) {
  __shared__ __align__(16) float as[kStep][kTile];
  __shared__ __align__(16) float bs[kStep][kTile];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int64_t i0 = static_cast<int64_t>(blockIdx.y) * kTile;
  const int64_t j0 = static_cast<int64_t>(blockIdx.x) * kTile;
  // loader: each thread brings 4 consecutive features of one row of each
  // operand tile
  const int lr = tid / 2, lk = (tid % 2) * 4;
  const bool a_ok = i0 + lr < q, b_ok = j0 + lr < q;
  const float* a_row = m + (i0 + lr) * f;
  const float* b_row = m + (j0 + lr) * f;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int64_t k0 = 0; k0 < f; k0 += kStep) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int64_t k = k0 + lk + u;
      as[lk + u][lr] = (a_ok && k < f) ? a_row[k] : 0.f;
      bs[lk + u][lr] = (b_ok && k < f) ? b_row[k] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kStep; ++k) {
      // rows ty*4..+3 and 64+ty*4..+3; columns tx*4..+3 and 64+tx*4..+3
      const float4 a0 = *reinterpret_cast<const float4*>(&as[k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[k][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t gi = i0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (gi >= q) continue;
    const float ci = counts[gi];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int64_t gj = j0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (gj >= q) continue;
      const float inter = acc[i][j];
      const float uni = ci + counts[gj] - inter;
      const float sim = uni > 0.f ? inter / fmaxf(uni, 1e-30f) : 1.f;
      out[gi * q + gj] = (1.f - sim) * (gi == gj ? 0.f : 1.f);
    }
  }
}

}  // namespace

extern "C" {

// m: (q, f) float32, counts: (q,) float32 scratch, out: (q, q) float32.
// Returns cudaGetLastError().
int jaccard_distance(const void* m, void* counts, void* out, long long q,
                     long long f, void* stream) {
  if (q <= 0) return 0;
  if (f <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t tiles = (q + kTile - 1) / kTile;
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int warps = kThreads / 32;
  row_counts<<<static_cast<unsigned>((q + warps - 1) / warps), kThreads, 0,
               s>>>(static_cast<const float*>(m), static_cast<float*>(counts),
                    q, f);
  const int status = static_cast<int>(cudaGetLastError());
  if (status != 0) return status;
  dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(tiles));
  jaccard_tile<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(m), static_cast<const float*>(counts),
      static_cast<float*>(out), q, f);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
