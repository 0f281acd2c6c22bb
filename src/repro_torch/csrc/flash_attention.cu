// Flash attention with an online softmax, causal or not, over grouped KV
// heads:
//   out[b, h, s, :] = softmax_t(scale * q[b, h, s, :] . k[b, h / G, t, :]
//                               masked to t <= q_start + s) @ v[b, h / G]
//
// Replaces src/repro/kernels/flash_attention/kernel.py,
// flash_attention_kernel (body _flash_kernel), with the GQA repeat and the
// padding of src/repro/kernels/flash_attention/ops.py. The TPU kernel walks
// a sequential KV grid axis and carries the running max m, denominator l
// and accumulator acc across it in VMEM scratch. Here a block owns 16 * RM
// query rows of one (batch, KV head) and loops over the KV tiles itself,
// keeping m, l and acc in registers. Its rows are the flattened (g, s)
// pairs of the G = H / Hkv query heads that share the KV head, so every
// K and V tile is read once per KV head (never a repeated copy), and a
// decode step (S = 1) fills a block with its G heads.
//
// The causal skip of the TPU kernel is the loop's upper bound: a block
// stops after the last key its latest row sees, min(T, q_start + s + 1).
// q_start (the TPU kernel's static t_minus_s) is a run-time argument.
// Keys at or past T, keys in a row's future and rows past G * S are masked
// in the kernel (nothing is padded): a masked score is NEG_INF = -1e30 and
// its probability exactly 0, so a row whose tile is wholly masked adds
// nothing to l or acc. All four tensors are addressed through their
// strides (the head dim contiguous), so a KV cache kept as
// (B, T, Hkv, d) is read in place.
//
// K and V tiles are copied with cp.async in 8-byte chunks (all of a
// tile in flight at once) where the layout allows, else element by element.
// Scores, m, l and acc are float32 whatever the input type; the output is
// acc / max(l, 1e-30) cast to the input type, as in the TPU kernel.
// Bound on the H100: operations at prefill (2 B H S T d multiply-adds over
// the causal half), bytes (the KV cache) at decode. This first kernel runs
// its products on the CUDA cores in float32 (one FMA per term); tensor
// cores (wgmma), TMA loads and a decode split over T are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBK = 64;          // keys per tile
constexpr int kThreads = 256;    // 16 row groups x 16 lanes
constexpr int kMaxD = 128;       // head dims a thread's 2 x 4 columns cover
constexpr float kNegInf = -1e30f;

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Four consecutive shared-memory elements as floats.
__device__ __forceinline__ void load4(const float* p, float o[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float o[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  o[0] = a.x;
  o[1] = a.y;
  o[2] = b.x;
  o[3] = b.y;
}

// Reduce over the 16 lanes that share a row group (lanes of one half-warp).
__device__ __forceinline__ float lanes_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float lanes_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Asynchronous 8-byte copy into shared memory; zero-fills when !full.
__device__ __forceinline__ void copy8_async(void* dst, const void* src,
                                            bool full) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(d), "l"(src), "r"(full ? 8 : 0) : "memory");
}

struct Strides {
  int64_t qb, qh, qs, kb, kh, kt, vb, vh, vt, ob, oh, os;
};

// Shared memory of one block: the Q tile and the P tile in float32, the K
// and V tiles in the input type; rows of d_pad + 4 elements keep the
// vector reads of a quarter warp on distinct banks.
template <typename T>
size_t smem_bytes(int rows, int d_pad) {
  const size_t ld = static_cast<size_t>(d_pad) + 4;
  return rows * ld * sizeof(float) + rows * (kBK + 4) * sizeof(float)
      + 2 * kBK * ld * sizeof(T);
}

// Thread (ty, tx) owns rows ty * RM + i of the block, score columns
// tx + 16 j of each key tile and output columns 64 jj + 4 tx + e.
template <typename T, int RM>
__global__ void __launch_bounds__(kThreads)
flash_tile(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, T* __restrict__ out, Strides st,
           int hkv, int g_n, int s_n, int t_n, int d_n, int d_pad,
           int64_t q_start, int causal, float scale, int n_tiles,
           bool async8) {
  constexpr int kRows = 16 * RM;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = d_pad + 4;
  float* qs = reinterpret_cast<float*>(smem);              // [kRows][ld]
  float* ps = qs + kRows * ld;                              // [kRows][kBK+4]
  T* ks = reinterpret_cast<T*>(ps + kRows * (kBK + 4));     // [kBK][ld]
  T* vs = ks + kBK * ld;                                    // [kBK][ld]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int tile = n_tiles - 1 - static_cast<int>(blockIdx.x);  // long first
  const int64_t b = blockIdx.y / hkv;
  const int kvh = blockIdx.y % hkv;
  const int rows_n = g_n * s_n;
  const int r0 = tile * kRows;

  // last key + 1 that any live row of the tile sees
  int t_end = t_n;
  if (causal) {
    const int r_last = min(r0 + kRows, rows_n) - 1;
    const int s_max = r_last / s_n != r0 / s_n ? s_n - 1 : r_last % s_n;
    t_end = static_cast<int>(min(static_cast<int64_t>(t_n),
                                 q_start + s_max + 1));
  }

  // the Q tile, float32, zero past the live rows and the head dim
  for (int idx = tid; idx < kRows * d_pad; idx += kThreads) {
    const int r = idx / d_pad, c = idx - r * d_pad;
    const int row = r0 + r;
    float x = 0.f;
    if (row < rows_n && c < d_n) {
      const int g = row / s_n, s = row - g * s_n;
      x = to_float(q[b * st.qb + static_cast<int64_t>(kvh * g_n + g) * st.qh
                     + static_cast<int64_t>(s) * st.qs + c]);
    }
    qs[r * ld + c] = x;
  }
  // each owned row's last visible key (-1: a row past G * S sees none)
  int64_t lim[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = r0 + ty * RM + i;
    lim[i] = row >= rows_n ? -1
        : causal ? q_start + row % s_n : static_cast<int64_t>(t_n) - 1;
  }

  float m[RM], l[RM], acc[RM][8];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[i][e] = 0.f;
  }
  const T* kb = k + b * st.kb + kvh * st.kh;
  const T* vb = v + b * st.vb + kvh * st.vh;
  const T zero = from_float<T>(0.f);
  // a row group wholly past G * S (most of a decode block of 4 heads)
  // skips the products; its lanes still join the row reductions
  const bool busy = r0 + ty * RM < rows_n;

  for (int t0 = 0; t0 < t_end; t0 += kBK) {
    __syncthreads();   // the previous tile's K, V and P are consumed
    if (async8) {
      // every 8-byte chunk of both tiles in flight at once, zero-filled
      // past t_end and the head dim
      constexpr int kE = 8 / sizeof(T);
      const int chunks = d_pad / kE;
      for (int idx = tid; idx < kBK * chunks; idx += kThreads) {
        const int r = idx / chunks, c = (idx - r * chunks) * kE;
        const int t = t0 + r;
        const bool ok = t < t_end && c < d_n;
        const int64_t off = ok ? static_cast<int64_t>(t) : 0;
        copy8_async(&ks[r * ld + c], kb + off * st.kt + (ok ? c : 0), ok);
        copy8_async(&vs[r * ld + c], vb + off * st.vt + (ok ? c : 0), ok);
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");
    } else {
      for (int idx = tid; idx < kBK * d_pad; idx += kThreads) {
        const int r = idx / d_pad, c = idx - r * d_pad;
        const int t = t0 + r;
        const bool ok = t < t_end && c < d_n;
        ks[r * ld + c] = ok ? kb[static_cast<int64_t>(t) * st.kt + c] : zero;
        vs[r * ld + c] = ok ? vb[static_cast<int64_t>(t) * st.vt + c] : zero;
      }
    }
    __syncthreads();

    float sc[RM][4];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int c = 0; busy && c < d_pad; c += 4) {
      float kv[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) load4(&ks[(tx + 16 * j) * ld + c], kv[j]);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        float qv[4];
        load4(&qs[(ty * RM + i) * ld + c], qv);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sc[i][j] = fmaf(qv[e], kv[j][e], sc[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = t0 + tx + 16 * j;
        sc[i][j] = t < t_n && t <= lim[i] ? sc[i][j] * scale : kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], lanes_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = sc[i][j] == kNegInf ? 0.f : expf(sc[i][j] - m_new);
        ps[(ty * RM + i) * (kBK + 4) + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * alpha + lanes_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[i][e] *= alpha;
    }
    __syncthreads();

    const bool lo = tx * 4 < d_pad, hi = 64 + tx * 4 < d_pad;
    for (int c = 0; busy && c < kBK; c += 4) {
      float pv[RM][4];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        load4(&ps[(ty * RM + i) * (kBK + 4) + c], pv[i]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vv[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        if (lo) load4(&vs[(c + u) * ld + tx * 4], vv);
        if (hi) load4(&vs[(c + u) * ld + 64 + tx * 4], vv + 4);
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int e = 0; e < 8; ++e)
            acc[i][e] = fmaf(pv[i][u], vv[e], acc[i][e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = r0 + ty * RM + i;
    if (row >= rows_n) continue;
    const int g = row / s_n, s = row - g * s_n;
    T* o = out + b * st.ob + static_cast<int64_t>(kvh * g_n + g) * st.oh
        + static_cast<int64_t>(s) * st.os;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int c = (e < 4 ? 0 : 64) + tx * 4 + (e & 3);
      if (c < d_n) o[c] = from_float<T>(acc[i][e] * inv);
    }
  }
}

template <typename T, int RM>
int launch(const void* q, const void* k, const void* v, void* out,
           const Strides& st, long long b_n, long long hkv, long long g_n,
           long long s_n, long long t_n, long long d_n, long long q_start,
           int causal, float scale, cudaStream_t stream) {
  constexpr int kRows = 16 * RM;
  const long long n_tiles = (g_n * s_n + kRows - 1) / kRows;
  const int d_pad = static_cast<int>((d_n + 3) / 4 * 4);
  const size_t smem = smem_bytes<T>(kRows, d_pad);
  if (n_tiles > 0x7fffffffLL || b_n * hkv > 65535 || smem > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      flash_tile<T, RM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  // K and V in 8-byte chunks: both 8-byte aligned, strides and the head
  // dim whole chunks
  constexpr long long kE = 8 / sizeof(T);
  const bool async8 = reinterpret_cast<uintptr_t>(k) % 8 == 0
      && reinterpret_cast<uintptr_t>(v) % 8 == 0 && d_n % kE == 0
      && st.kb % kE == 0 && st.kh % kE == 0 && st.kt % kE == 0
      && st.vb % kE == 0 && st.vh % kE == 0 && st.vt % kE == 0;
  dim3 grid(static_cast<unsigned>(n_tiles), static_cast<unsigned>(b_n * hkv));
  flash_tile<T, RM><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), st,
      static_cast<int>(hkv), static_cast<int>(g_n), static_cast<int>(s_n),
      static_cast<int>(t_n), static_cast<int>(d_n), d_pad, q_start, causal,
      scale, static_cast<int>(n_tiles), async8);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out,
             const Strides& st, long long b_n, long long hkv, long long g_n,
             long long s_n, long long t_n, long long d_n, long long q_start,
             int causal, float scale, cudaStream_t stream) {
  // a decode step of at most 16 heads per KV head takes 16-row blocks
  if (g_n * s_n <= 16)
    return launch<T, 1>(q, k, v, out, st, b_n, hkv, g_n, s_n, t_n, d_n,
                        q_start, causal, scale, stream);
  return launch<T, 4>(q, k, v, out, st, b_n, hkv, g_n, s_n, t_n, d_n,
                      q_start, causal, scale, stream);
}

}  // namespace

extern "C" {

// q: (b, h, s, d), k and v: (b, hkv, t, d), out: (b, h, s, d), each given
// by its data pointer and the element strides of its first three dims
// (strides[0..11]: q, k, v, out); the last dim is contiguous. dtype 0 is
// float32, 1 bfloat16. h % hkv == 0, 1 <= d <= 128, t >= 1, and with
// causal, q_start >= 0 (row s sees keys t <= q_start + s). Returns
// cudaGetLastError().
int flash_attention(const void* q, const void* k, const void* v, void* out,
                    int dtype, long long b_n, long long h_n, long long hkv,
                    long long s_n, long long t_n, long long d_n,
                    const long long* strides, long long q_start, int causal,
                    float scale, void* stream) {
  if (b_n <= 0 || s_n <= 0) return 0;
  if (hkv <= 0 || h_n % hkv != 0 || t_n <= 0 || d_n <= 0 || d_n > kMaxD
      || (causal && q_start < 0) || h_n * s_n > 0x7fffffffLL
      || t_n > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{strides[0], strides[1], strides[2], strides[3],
                   strides[4], strides[5], strides[6], strides[7],
                   strides[8], strides[9], strides[10], strides[11]};
  const auto s = static_cast<cudaStream_t>(stream);
  const long long g_n = h_n / hkv;
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, st, b_n, hkv, g_n, s_n, t_n, d_n,
                           q_start, causal, scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, out, st, b_n, hkv, g_n, s_n, t_n,
                                   d_n, q_start, causal, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
