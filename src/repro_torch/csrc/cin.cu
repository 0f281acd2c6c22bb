// Fused xDeepFM CIN layer:
//   out[b, k, d] = sum_h xk[b, h, d] * sum_f w[k, h, f] * x0[b, f, d].
//
// Replaces src/repro/kernels/cin/kernel.py, cin_layer_kernel (body
// _cin_kernel) with its padding in src/repro/kernels/cin/ops.py
// (cin_layer). The TPU kernel works per example: a (K*H, F) @ (F, D) MXU
// product, then a reduction over h, with B and K padded to its blocks.
// Here the layer is one product over the flattened reduction axis
// p = (h, f):
//   out[(b, d), k] = sum_p z[(b, d), p] * w[k, p],
//   z[(b, d), (h, f)] = xk[b, h, d] * x0[b, f, d],
// whose left operand z, the (B, H, F, D) outer product, is never stored
// in device memory: each block owns 64 rows (b, d) by 64 columns k, keeps
// the xk and x0 values of its 64 rows in shared memory, and per step of 16
// reduction slots builds that step's z tile in shared memory beside the
// (16, 64) tile of w streamed from device memory. Each of its 256 threads
// accumulates a 4 x 4 register tile in float32, one FMA per term in
// increasing p, and stores it once. Ragged edges (rows, k, p) load zeros
// and are masked at the store: nothing is padded.
// Bound on the H100: operations, 2 B K D H F float32 multiply-adds at the
// served shapes (the inputs and output are a few MB). Double-buffered
// loads and tensor cores are left for later; TF32 would not meet the
// layer's tolerance.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;     // (b, d) rows per block
constexpr int kCols = 64;     // k columns per block
constexpr int kStep = 16;     // reduction slots p per shared-memory step
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
cin_tile(const float* __restrict__ xk, const float* __restrict__ x0,
         const float* __restrict__ w, float* __restrict__ out, int64_t b_n,
         int h_n, int f_n, int d_n, int k_n) {
  extern __shared__ __align__(16) float smem[];
  float* zs = smem;                        // [kStep][kRows]
  float* ws = zs + kStep * kRows;          // [kStep][kCols]
  float* xks = ws + kStep * kCols;         // [h_n][kRows]
  float* x0s = xks + h_n * kRows;          // [f_n][kRows]
  const int tid = threadIdx.x;
  const int64_t rows = b_n * d_n;
  const int64_t hf = static_cast<int64_t>(h_n) * f_n;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const int n0 = blockIdx.y * kCols;

  // stage xk[b, :, d] and x0[b, :, d] of row ml = (b, d)
  const int ml = tid % kRows;
  {
    const int64_t mg = m0 + ml;
    const bool ok = mg < rows;
    const int64_t b = ok ? mg / d_n : 0;
    const int64_t d = ok ? mg - b * d_n : 0;
    const float* xkr = xk + b * h_n * d_n + d;
    const float* x0r = x0 + b * f_n * d_n + d;
    for (int h = tid / kRows; h < h_n; h += kThreads / kRows)
      xks[h * kRows + ml] = ok ? xkr[static_cast<int64_t>(h) * d_n] : 0.f;
    for (int f = tid / kRows; f < f_n; f += kThreads / kRows)
      x0s[f * kRows + ml] = ok ? x0r[static_cast<int64_t>(f) * d_n] : 0.f;
  }
  // z builder: row ml, slots zp + 4u of each step, tracked as (h, f)
  const int zp = tid / kRows;
  int zh[4], zf[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    zh[u] = (zp + 4 * u) / f_n;
    zf[u] = (zp + 4 * u) % f_n;
  }
  // w loader: column wn, slots wp..wp+3 of each step (contiguous in w)
  const int wn = tid / 4, wp = (tid % 4) * 4;
  const bool wn_ok = n0 + wn < k_n;
  const float* wr = w + static_cast<int64_t>(wn_ok ? n0 + wn : 0) * hf;
  // product: rows ty*4..+3, columns tx*4..+3
  const int tx = tid % 16, ty = tid / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  __syncthreads();

  for (int64_t p0 = 0; p0 < hf; p0 += kStep) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int pl = zp + 4 * u;
      zs[pl * kRows + ml] = p0 + pl < hf
          ? xks[zh[u] * kRows + ml] * x0s[zf[u] * kRows + ml] : 0.f;
      zf[u] += kStep;
      while (zf[u] >= f_n) {
        zf[u] -= f_n;
        ++zh[u];
      }
      const int64_t p = p0 + wp + u;
      ws[(wp + u) * kCols + wn] = (wn_ok && p < hf) ? wr[p] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int pl = 0; pl < kStep; ++pl) {
      const float4 a = *reinterpret_cast<const float4*>(&zs[pl * kRows
                                                          + ty * 4]);
      const float4 c = *reinterpret_cast<const float4*>(&ws[pl * kCols
                                                          + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], cv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t mg = m0 + ty * 4 + i;
    if (mg >= rows) continue;
    const int64_t b = mg / d_n;
    const int64_t d = mg - b * d_n;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < k_n) out[(b * k_n + n) * d_n + d] = acc[i][j];
    }
  }
}

// Dynamic shared memory of one block for h_n + f_n staged rows.
long long smem_bytes(long long h_n, long long f_n) {
  return (2LL * kStep * kRows + (h_n + f_n) * kRows)
      * static_cast<long long>(sizeof(float));
}

}  // namespace

extern "C" {

// xk: (b, h, d), x0: (b, f, d), w: (k, h, f), out: (b, k, d), all float32.
// Returns cudaGetLastError().
int cin_layer(const void* xk, const void* x0, const void* w, void* out,
              long long b_n, long long h_n, long long f_n, long long d_n,
              long long k_n, void* stream) {
  if (b_n <= 0 || k_n <= 0 || d_n <= 0) return 0;
  if (h_n <= 0 || f_n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t gx = (b_n * d_n + kRows - 1) / kRows;
  const int64_t gy = (k_n + kCols - 1) / kCols;
  const long long smem = smem_bytes(h_n, f_n);
  if (gx > 0x7fffffffLL || gy > 65535 || smem > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      cin_tile, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  cin_tile<<<grid, kThreads, static_cast<size_t>(smem),
             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xk), static_cast<const float*>(x0),
      static_cast<const float*>(w), static_cast<float*>(out), b_n,
      static_cast<int>(h_n), static_cast<int>(f_n), static_cast<int>(d_n),
      static_cast<int>(k_n));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
