// Flash attention with an online softmax, causal or not, over grouped KV
// heads:
//   out[b, h, s, :] = softmax_t(scale * q[b, h, s, :] . k[b, h / G, t, :]
//                               masked to t <= q_start + s) @ v[b, h / G]
//
// Replaces src/repro/kernels/flash_attention/kernel.py:75,
// flash_attention_kernel (body _flash_kernel), with the GQA repeat and the
// padding of src/repro/kernels/flash_attention/ops.py. The TPU kernel walks
// a sequential KV grid axis and carries the running max m, denominator l
// and accumulator acc across it in VMEM scratch. Here a block loops over
// the KV tiles itself. Its query rows are the flattened (g, s) pairs of the
// G = H / Hkv query heads that share one (batch, KV head), so GQA reads no
// repeated copy of K and V. The causal skip of the TPU kernel is the loop's
// upper bound, min(T, q_start + s + 1) for the block's latest row, with
// q_start (the TPU kernel's static t_minus_s) a run-time argument. Keys at
// or past T, keys in a row's future and rows past G * S are masked in the
// kernel (nothing is padded in device memory): a masked score is
// NEG_INF = -1e30 and its probability exactly 0. All four tensors are
// addressed through their strides (the head dim contiguous), so a KV cache
// kept as (B, T, Hkv, d) is read in place. Scores, m, l and acc are float32
// whatever the input type; the output is acc / max(l, 1e-30) in the input
// type, as in the TPU kernel.
//
// Four routes; the wrapper (kernels/flash_attention/kernel.py, `plan`)
// picks one by shape and layout before the launch, and the entry refuses a
// route the shape does not fit:
//
// * flash_tile_wgmma (route "wgmma": bf16 prefill whose inputs take
//   16-byte copies, T >= 64): bound by operations (4 d per visible (row,
//   key) pair). A block owns 128 query rows: two consumer warpgroups of 64
//   rows and one producer warp. The producer's lane 0 streams 64-key K and
//   V tiles by TMA (a 5-d tensor map, 8-column groups of 64 keys x 16 B)
//   into a 4-stage ring guarded by full/empty mbarriers. Each warpgroup
//   runs S = Q K^T (wgmma m64n64k16, Q and K from shared memory) and
//   O += P V (wgmma m64n128k16, P from registers, V as a transposed B)
//   with float32 accumulators in registers, and waits on the ring on its
//   own, so one warpgroup's softmax overlaps the other's products. P is
//   not rounded to bf16 alone: it is split into P_hi = bf16(P) and
//   P_lo = bf16(P - P_hi), and both go into the same accumulator, so P
//   keeps about 16 bits (the plain version feeds float32 probabilities to
//   the value product); the value product costs twice for it. The grid is
//   (B x Hkv, row tiles), heads fastest, longest tiles first.
// * flash_tile_mma (route "mma": bf16 that TMA's boxes cannot take: head
//   dims a multiple of 4 but not 8, such as 100, T under 64 keys, 8-byte
//   aligned layouts): the same algorithm on mma.sync m16n8k16 with
//   ldmatrix; 8 warps own 128 rows, 64-key K and V tiles arrive by 16- or
//   8-byte cp.async into a 2-stage ring (one barrier per tile, the next
//   copies overlap this tile's work), 2 blocks per SM (128 registers), the
//   head dim zero-filled in shared memory to a multiple of 16, rows of
//   d + 8 elements so ldmatrix is free of bank conflicts.
// * flash_tile_split + flash_tile_combine (route "split": decode): bound by
//   bytes (the KV cache). When G * S <= 16 rows and B * Hkv blocks would
//   not fill the card, the keys [0, t_end) of each (batch, KV head) are
//   cut into n_split chunks (flash-decoding). Pass 1 runs a block per
//   (chunk, batch, KV head) and writes one float32 partial (m, l, acc[d])
//   per (row, chunk) to scratch from the wrapper: for bf16 with d a
//   multiple of 64 and 16-byte layouts flash_tile_split_mma, whose K and V
//   tiles arrive by TMA in 128-byte-swizzled boxes (boxes 16 bytes wide
//   left it far from the byte rate) and whose 4 warps each take 16 keys of a
//   64-key tile with the rows (zero-padded to 16) as one mma.sync A tile
//   and P split as above (4 rows x d MACs per 4 d bytes of K and V is far
//   below the tensor-core line; the tensor cores keep the instructions per
//   byte low); otherwise flash_tile_split, float32 on the CUDA cores, 4
//   warps x 8 keys x 4 lanes per key, K and V by cp.async. The warps of a
//   block merge in shared memory in warp order. Pass 2 merges a row's
//   chunks in chunk order 0..n-1, so the result does not depend on
//   scheduling; a chunk past a causal row's limit has l = 0 and m = -1e30
//   and adds nothing. Pass 2 also stores each row's log-sum-exp when
//   asked: a decode whose keys are split across ranks merges their
//   normalised outputs by it.
// * flash_tile<T, RM> (route "tile": float32, and bf16 that no copy
//   takes, such as odd head dims): a block owns 16 * RM rows, 16 lanes per
//   row group, products on the CUDA cores in float32 (TF32 would not meet
//   the float32 tolerance); K and V tiles by 8-byte cp.async or element
//   loads.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kBK = 64;          // keys per tile (flash_tile)
constexpr int kThreads = 256;    // 16 row groups x 16 lanes
constexpr int kMaxD = 128;       // largest head dim of every route
constexpr float kNegInf = -1e30f;

constexpr int kMmaRows = 128;     // flash_tile_mma: query rows per block
constexpr int kMmaKeys = 64;      // keys per tile
constexpr int kMmaThreads = 256;  // 8 warps x 16 rows
constexpr int kMmaStages = 2;     // K/V ring depth

constexpr int kSpKeys = 32;      // flash_tile_split: keys per tile
constexpr int kSpThreads = 128;  // 4 warps x 8 keys x 4 lanes
constexpr int kSpStages = 3;
constexpr int kSpRows = 16;      // most G * S rows a split block takes
constexpr int kSdKeys = 64;      // flash_tile_split_mma: keys per tile
constexpr int kSdThreads = 128;  // 4 warps x 16 keys of a tile
constexpr int kSdStages = 3;
constexpr int kCbThreads = 128;  // flash_tile_combine
constexpr float kLn2 = 0.6931471805599453f;

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) {
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
__device__ __forceinline__ void load4(const bf16* p, float o[4]) {
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

// Sixteen bytes of shared memory as floats: 4 float32 or 8 bfloat16.
template <typename T>
struct Vec16 {
  static constexpr int n = 16 / sizeof(T);
};
__device__ __forceinline__ void load16(const float* p, float o[4]) {
  load4(p, o);
}
__device__ __forceinline__ void load16(const bf16* p, float o[8]) {
  load4(p, o);
  load4(p + 4, o + 4);
}

// 2^x in one instruction (MUFU.EX2, about 2 ulp; results below 2^-126
// flush to 0): the bf16 routes' probabilities.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
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

// Asynchronous N-byte copy into shared memory; zero-fills when !full.
template <int N>
__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           bool full) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(full ? 16 : 0) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(d), "l"(src), "n"(N), "r"(full ? N : 0)
                 : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Stage rows [0, n_rows) of a row-strided slab into shared memory rows of
// ld elements, zero past `live` rows and from d_n to d_pad. vec is the
// bytes per cp.async (16, 8 or 4; d_n, d_pad, the stride and the address
// are whole chunks), or 0 for element loads.
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, int ld, const T* src,
                                           int64_t stride, int n_rows,
                                           int live, int d_n, int d_pad,
                                           int vec, int tid, int n_thr) {
  if (vec == 0) {
    for (int idx = tid; idx < n_rows * d_pad; idx += n_thr) {
      const int r = idx / d_pad, c = idx - r * d_pad;
      dst[r * ld + c] = r < live && c < d_n ? src[r * stride + c]
                                            : from_float<T>(0.f);
    }
    return;
  }
  const int e = vec / static_cast<int>(sizeof(T));
  const int chunks = d_pad / e;
  // chunk tid + i n_thr is (r, ci) without a division per chunk
  int r = tid / chunks, ci = tid - r * chunks;
  const int dr = n_thr / chunks, dc = n_thr - dr * chunks;
  while (r < n_rows) {
    const int c = ci * e;
    const bool ok = r < live && c < d_n;
    const T* s = ok ? src + r * stride + c : src;
    T* d = dst + r * ld + c;
    if (vec == 16) copy_async<16>(d, s, ok);
    else if (vec == 8) copy_async<8>(d, s, ok);
    else copy_async<4>(d, s, ok);
    r += dr;
    ci += dc;
    if (ci >= chunks) {
      ci -= chunks;
      ++r;
    }
  }
}

struct Strides {
  int64_t qb, qh, qs, kb, kh, kt, vb, vh, vt, ob, oh, os;
};

// The last key + 1 that any live row of rows [r0, r0 + n) sees.
__device__ __forceinline__ int block_t_end(int r0, int n, int rows_n,
                                           int s_n, int t_n,
                                           int64_t q_start, int causal) {
  if (!causal) return t_n;
  const int r_last = min(r0 + n, rows_n) - 1;
  const int s_max = r_last / s_n != r0 / s_n ? s_n - 1 : r_last % s_n;
  return static_cast<int>(min(static_cast<int64_t>(t_n),
                              q_start + s_max + 1));
}

// A row's last visible key (-1: a row past G * S sees none).
__device__ __forceinline__ int row_limit(int row, int rows_n, int s_n,
                                         int t_n, int64_t q_start,
                                         int causal) {
  if (row >= rows_n) return -1;
  if (!causal) return t_n - 1;
  return static_cast<int>(min(static_cast<int64_t>(t_n) - 1,
                              q_start + row % s_n));
}

// ---------------------------------------------------------------------------
// flash_tile: CUDA cores, any head dim and layout
// ---------------------------------------------------------------------------

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
  const int t_end = block_t_end(r0, kRows, rows_n, s_n, t_n, q_start,
                                causal);

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
  int lim[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i)
    lim[i] = row_limit(r0 + ty * RM + i, rows_n, s_n, t_n, q_start, causal);

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
  // a row group wholly past G * S (most of a decode block of 4 heads)
  // skips the products; its lanes still join the row reductions
  const bool busy = r0 + ty * RM < rows_n;

  for (int t0 = 0; t0 < t_end; t0 += kBK) {
    __syncthreads();   // the previous tile's K, V and P are consumed
    // every chunk of both tiles in flight at once, zero-filled past t_end
    // and the head dim
    const int vec = async8 ? 8 : 0;
    stage_rows(ks, ld, kb + static_cast<int64_t>(t0) * st.kt, st.kt, kBK,
               t_end - t0, d_n, d_pad, vec, tid, kThreads);
    stage_rows(vs, ld, vb + static_cast<int64_t>(t0) * st.vt, st.vt, kBK,
               t_end - t0, d_n, d_pad, vec, tid, kThreads);
    cp_commit();
    cp_wait<0>();
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
        sc[i][j] = t <= lim[i] ? sc[i][j] * scale : kNegInf;
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

// ---------------------------------------------------------------------------
// flash_tile_mma: bf16 tensor cores (mma.sync m16n8k16), prefill
// ---------------------------------------------------------------------------

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a)
               : "memory");
}
// c (16 x 8, float32) += a (16 x 16, bf16, row) b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
               "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
               : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0),
                 "r"(b1));
}
// Two float32 values as bf16 pairs hi = bf16(x) and lo = bf16(x - hi);
// the first value in the low half (the lower column of a fragment).
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 r = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

// Warp w owns block rows 16 w .. 16 w + 15; lane (gid = lane / 4,
// tig = lane % 4) holds rows 16 w + gid (a) and 16 w + gid + 8 (b) of every
// fragment: score columns 8 nt + 2 tig + {0, 1} of n-tile nt, output
// columns 8 n + 2 tig + {0, 1} of n-tile n.
__global__ void __launch_bounds__(kMmaThreads, 2)
flash_tile_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, bf16* __restrict__ out,
              Strides st, int hkv, int g_n, int s_n, int t_n, int d_n,
              int d16, int64_t q_start, int causal, float scale_log2,
              int n_tiles, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = d16 + 8;
  bf16* qs = reinterpret_cast<bf16*>(smem);                 // [rows][ld]
  bf16* ks = qs + kMmaRows * ld;                             // [stg][keys][ld]
  bf16* vs = ks + kMmaStages * kMmaKeys * ld;                 // [stg][keys][ld]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int tile = n_tiles - 1 - static_cast<int>(blockIdx.y);  // long first
  const int64_t b = blockIdx.x / hkv;
  const int kvh = blockIdx.x % hkv;
  const int rows_n = g_n * s_n;
  const int r0 = tile * kMmaRows;
  const int t_end = block_t_end(r0, kMmaRows, rows_n, s_n, t_n, q_start,
                                causal);
  const int n_kv = (t_end + kMmaKeys - 1) / kMmaKeys;

  // the Q tile, zero past the live rows and from d_n to d16
  {
    const int e = vec / 2, chunks = d16 / e;
    for (int idx = tid; idx < kMmaRows * chunks; idx += kMmaThreads) {
      const int r = idx / chunks, c = (idx - r * chunks) * e;
      const int row = r0 + r;
      const bool ok = row < rows_n && c < d_n;
      const bf16* src = q;
      if (ok) {
        const int g = row / s_n, s = row - g * s_n;
        src = q + b * st.qb + static_cast<int64_t>(kvh * g_n + g) * st.qh
            + static_cast<int64_t>(s) * st.qs + c;
      }
      if (vec == 16) copy_async<16>(qs + r * ld + c, src, ok);
      else copy_async<8>(qs + r * ld + c, src, ok);
    }
  }
  const bf16* kb = k + b * st.kb + kvh * st.kh;
  const bf16* vb = v + b * st.vb + kvh * st.vh;
  auto load_kv = [&](int j) {
    const int t0 = j * kMmaKeys, stg = j % kMmaStages;
    stage_rows(ks + stg * kMmaKeys * ld, ld,
               kb + static_cast<int64_t>(t0) * st.kt, st.kt, kMmaKeys,
               t_end - t0, d_n, d16, vec, tid, kMmaThreads);
    stage_rows(vs + stg * kMmaKeys * ld, ld,
               vb + static_cast<int64_t>(t0) * st.vt, st.vt, kMmaKeys,
               t_end - t0, d_n, d16, vec, tid, kMmaThreads);
  };
  // group j holds tile j (group 0 also Q); kMmaStages - 1 tiles ahead
#pragma unroll
  for (int j = 0; j < kMmaStages - 1; ++j) {
    if (j < n_kv) load_kv(j);
    cp_commit();
  }

  const int row_a = r0 + warp * 16 + gid, row_b = row_a + 8;
  const int lim_a = row_limit(row_a, rows_n, s_n, t_n, q_start, causal);
  const int lim_b = row_limit(row_b, rows_n, s_n, t_n, q_start, causal);
  const int lim_lo = min(lim_a, lim_b);
  int warp_lim = max(lim_a, lim_b);
#pragma unroll
  for (int off = 4; off < 32; off <<= 1)
    warp_lim = max(warp_lim, __shfl_xor_sync(0xffffffffu, warp_lim, off));
  const int nk = d16 / 16;       // 16-column chunks of the head dim

  float acc[kMaxD / 8][4];
#pragma unroll
  for (int n = 0; n < kMaxD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
  const bf16* qw = qs + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld
      + (lane >> 4) * 8;

  for (int j = 0; j < n_kv; ++j) {
    cp_wait<kMmaStages - 2>();   // tile j (and Q) landed for this thread
    // ... for every thread; and every warp is done with tile j - 1, whose
    // stage the next load takes: one barrier per tile
    __syncthreads();
    if (j + kMmaStages - 1 < n_kv) load_kv(j + kMmaStages - 1);
    cp_commit();
    const int t0 = j * kMmaKeys;
    if (t0 <= warp_lim) {
      const bf16* kt = ks + (j % kMmaStages) * kMmaKeys * ld;
      const bf16* vt = vs + (j % kMmaStages) * kMmaKeys * ld;
      float sc[kMmaKeys / 8][4];
#pragma unroll
      for (int nt = 0; nt < kMmaKeys / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
      // S = Q K^T: Q's A fragment from shared memory (registers are kept
      // for 2 blocks per SM); an x4 ldmatrix gives two key n-tiles' B
      // fragments
#pragma unroll
      for (int kk = 0; kk < kMaxD / 16; ++kk) {
        if (kk >= nk) break;
        uint32_t qa[4];
        ldsm_x4(qa, qw + kk * 16);
#pragma unroll
        for (int np = 0; np < kMmaKeys / 16; ++np) {
          uint32_t r[4];
          ldsm_x4(r, kt + (np * 16 + (lane & 7) + (lane >> 4) * 8) * ld
                        + kk * 16 + ((lane >> 3) & 1) * 8);
          mma_bf16(sc[2 * np], qa, r[0], r[1]);
          mma_bf16(sc[2 * np + 1], qa, r[2], r[3]);
        }
      }
      // scale to base 2, mask, row max over the quad
      const bool edge = t0 + kMmaKeys - 1 > lim_lo;
      float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
      for (int nt = 0; nt < kMmaKeys / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = t0 + nt * 8 + tig * 2 + (e & 1);
          float x = sc[nt][e] * scale_log2;
          if (edge && t > (e < 2 ? lim_a : lim_b)) x = kNegInf;
          sc[nt][e] = x;
          if (e < 2) mx_a = fmaxf(mx_a, x);
          else mx_b = fmaxf(mx_b, x);
        }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
      }
      // a row with no visible key yet keeps m = NEG_INF and subtracts 0,
      // so its masked scores give exactly 0 (2^-1e30)
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      const float mu_a = mn_a == kNegInf ? 0.f : mn_a;
      const float mu_b = mn_b == kNegInf ? 0.f : mn_b;
      const float al_a = ex2(m_a - mu_a), al_b = ex2(m_b - mu_b);
      m_a = mn_a;
      m_b = mn_b;
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int nt = 0; nt < kMmaKeys / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2(sc[nt][e] - (e < 2 ? mu_a : mu_b));
          sc[nt][e] = p;
          if (e < 2) sum_a += p;
          else sum_b += p;
        }
      l_a = l_a * al_a + sum_a;    // this lane's columns; summed at the end
      l_b = l_b * al_b + sum_b;
      if (al_a != 1.f || al_b != 1.f) {
#pragma unroll
        for (int n = 0; n < kMaxD / 8; ++n) {
          acc[n][0] *= al_a;
          acc[n][1] *= al_a;
          acc[n][2] *= al_b;
          acc[n][3] *= al_b;
        }
      }
      // O += P_hi V + P_lo V: score n-tiles 2 kc, 2 kc + 1 are the A
      // fragment of keys 16 kc .. 16 kc + 15; an x4 transposed ldmatrix
      // gives two output n-tiles' B fragments
#pragma unroll
      for (int kc = 0; kc < kMmaKeys / 16; ++kc) {
        uint32_t ph[4], pl[4];
        split_pair(sc[2 * kc][0], sc[2 * kc][1], ph[0], pl[0]);
        split_pair(sc[2 * kc][2], sc[2 * kc][3], ph[1], pl[1]);
        split_pair(sc[2 * kc + 1][0], sc[2 * kc + 1][1], ph[2], pl[2]);
        split_pair(sc[2 * kc + 1][2], sc[2 * kc + 1][3], ph[3], pl[3]);
#pragma unroll
        for (int nd = 0; nd < kMaxD / 16; ++nd) {
          if (nd >= nk) break;
          uint32_t r[4];
          ldsm_x4_t(r, vt + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8)
                               * ld + nd * 16 + (lane >> 4) * 8);
          mma_bf16(acc[2 * nd], ph, r[0], r[1]);
          mma_bf16(acc[2 * nd], pl, r[0], r[1]);
          mma_bf16(acc[2 * nd + 1], ph, r[2], r[3]);
          mma_bf16(acc[2 * nd + 1], pl, r[2], r[3]);
        }
      }
    }
  }
  cp_wait<0>();

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? row_b : row_a;
    if (row >= rows_n) continue;
    const int g = row / s_n, s = row - g * s_n;
    bf16* o = out + b * st.ob + static_cast<int64_t>(kvh * g_n + g) * st.oh
        + static_cast<int64_t>(s) * st.os;
    const float inv = 1.f / fmaxf(half ? l_b : l_a, 1e-30f);
#pragma unroll
    for (int n = 0; n < kMaxD / 8; ++n) {
      const int c = n * 8 + tig * 2;
      if (c < d_n) o[c] = __float2bfloat16(acc[n][2 * half] * inv);
      if (c + 1 < d_n) o[c + 1] = __float2bfloat16(acc[n][2 * half + 1] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// flash_tile_wgmma: bf16 tensor cores (wgmma) fed by TMA, prefill
// ---------------------------------------------------------------------------

// S (64 x 64, float32) = A (64 x 16, shared) B (16 x 64, shared), both
// K-major; scale_d = 0 starts the sum.
__device__ __forceinline__ void wgmma_qk(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31},"
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}
// O (64 x 128, float32) += A (64 x 16, registers) B (16 x 128, shared,
// MN-major: transposed).
__device__ __forceinline__ void wgmma_pv(float (&d)[64], const uint32_t a[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma (issue, wait).
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// Shared-memory descriptor of a no-swizzle (interleaved) operand of 8-row
// x 16-byte core matrices; lbo (K direction) and sbo (M or N direction)
// in bytes.
__device__ __forceinline__ uint64_t gmma_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return ((smem_u32(p) & 0x3FFFF) >> 4)
      | (static_cast<uint64_t>(lbo >> 4) << 16)
      | (static_cast<uint64_t>(sbo >> 4) << 32);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
// Spin until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
}
// One TMA copy of a 5-d box into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c1, int c3, int c4,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(0),
         "r"(c1), "r"(0), "r"(c3), "r"(c4), "r"(smem_u32(bar))
      : "memory");
}
// One TMA copy of a 4-d box into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load4(void* dst, const CUtensorMap* map,
                                          int c0, int c1, int c2, int c3,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3), "r"(smem_u32(bar))
      : "memory");
}
// Byte offset of element (r, c) in the Q tile: K-major, rows of d16
// elements, core matrix (r / 8, c / 8) of 8 rows x 16 B.
__device__ __forceinline__ int q_off(int r, int c, int d16) {
  return (r >> 3) * d16 * 16 + (c >> 3) * 128 + (r & 7) * 16 + (c & 7) * 2;
}

constexpr int kWgRows = 128;     // flash_tile_wgmma: 2 consumer warpgroups
constexpr int kWgKeys = 64;      // keys per tile
constexpr int kWgThreads = 288;  // 8 consumer warps + 1 producer warp
constexpr int kWgStages = 4;     // K/V ring depth

// K and V tiles land by TMA as 8-column groups of 64 keys x 16 B (group
// stride 1024 B): for S = Q K^T that is K-major B (LBO 1024, SBO 128), for
// O += P V MN-major B (LBO 128, SBO 1024). Consumer warpgroup w owns rows
// 64 w .. 64 w + 63 of the block; its warp v rows 16 v .. 16 v + 15, lane
// (gid, tig) rows + gid (a) and + gid + 8 (b), accumulator registers
// 4 j + e at columns 8 j + 2 tig + (e & 1). The two warpgroups wait on the
// ring's barriers on their own, so one's softmax overlaps the other's
// products.
__global__ void __launch_bounds__(kWgThreads, 1)
flash_tile_wgmma(const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv,
              const bf16* __restrict__ q, bf16* __restrict__ out,
              Strides st, int hkv, int g_n, int s_n, int t_n, int d_n,
              int d16, int64_t q_start, int causal, float scale_log2,
              int n_tiles) {
  extern __shared__ __align__(1024) unsigned char smem_wgmma[];
  const int q_bytes = kWgRows * d16 * 2, k_bytes = kWgKeys * d16 * 2;
  const int v_bytes = kWgKeys * kMaxD * 2;
  unsigned char* qs = smem_wgmma;
  unsigned char* ks = qs + q_bytes;                      // [stg] K tiles
  unsigned char* vs = ks + kWgStages * k_bytes;          // [stg] V tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(vs + kWgStages * v_bytes);
  uint64_t* empty = full + kWgStages;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = n_tiles - 1 - static_cast<int>(blockIdx.y);  // long first
  const int64_t b = blockIdx.x / hkv;
  const int kvh = blockIdx.x % hkv;
  const int rows_n = g_n * s_n;
  const int r0 = tile * kWgRows;
  const int t_end = block_t_end(r0, kWgRows, rows_n, s_n, t_n, q_start,
                                causal);
  const int n_kv = (t_end + kWgKeys - 1) / kWgKeys;
  const int d8 = d_n / 8;

  // the column groups TMA never writes (d8 .. d16 / 8 of K, d8 .. 15 of
  // V) stay zero in every stage
  {
    const int kz = d16 / 8 - d8, vz = kMaxD / 8 - d8;
    for (int idx = tid; idx < kWgStages * kWgKeys * (kz + vz);
         idx += kWgThreads) {
      const int stg = idx / (kWgKeys * (kz + vz));
      const int rest = idx - stg * kWgKeys * (kz + vz);
      const int grp = rest / kWgKeys, t = rest - grp * kWgKeys;
      unsigned char* base = grp < kz
          ? ks + stg * k_bytes + (d8 + grp) * 1024
          : vs + stg * v_bytes + (d8 + grp - kz) * 1024;
      *reinterpret_cast<uint4*>(base + t * 16) = make_uint4(0, 0, 0, 0);
    }
  }
  if (tid == 0) {
    for (int i = 0; i < kWgStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 8);      // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  if (warp == 8) {                  // the producer
    if (lane == 0) {
      const uint32_t bytes = 2u * kWgKeys * d_n * 2;
      for (int j = 0; j < n_kv; ++j) {
        const int stg = j % kWgStages;
        if (j >= kWgStages) mbar_wait(&empty[stg], (j / kWgStages - 1) & 1);
        mbar_expect_tx(&full[stg], bytes);
        tma_load(ks + stg * k_bytes, &tk, j * kWgKeys, kvh,
                 static_cast<int>(b), &full[stg]);
        tma_load(vs + stg * v_bytes, &tv, j * kWgKeys, kvh,
                 static_cast<int>(b), &full[stg]);
      }
    }
    return;
  }

  const int wg = warp >> 2, wtid = tid & 127;
  const int gid = lane >> 2, tig = lane & 3;
  // this warpgroup's 64 Q rows, zero past the live rows and from d_n to
  // d16 (16-byte copies; a lane per row of a core matrix)
  {
    const int chunks = d16 / 8;
    for (int idx = wtid; idx < 64 * chunks; idx += 128) {
      const int rest = idx >> 3, rg = rest / chunks;
      const int r = wg * 64 + rg * 8 + (idx & 7);
      const int c = (rest - rg * chunks) * 8;
      const int row = r0 + r;
      const bool ok = row < rows_n && c < d_n;
      const bf16* src = q;
      if (ok) {
        const int g = row / s_n, s = row - g * s_n;
        src = q + b * st.qb + static_cast<int64_t>(kvh * g_n + g) * st.qh
            + static_cast<int64_t>(s) * st.qs + c;
      }
      copy_async<16>(qs + q_off(r, c, d16), src, ok);
    }
    cp_commit();
    cp_wait<0>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
  }

  const int wr0 = r0 + wg * 64;
  const int wg_end = wr0 < rows_n
      ? block_t_end(wr0, 64, rows_n, s_n, t_n, q_start, causal) : 0;
  const int row_a = wr0 + (warp & 3) * 16 + gid, row_b = row_a + 8;
  const int lim_a = row_limit(row_a, rows_n, s_n, t_n, q_start, causal);
  const int lim_b = row_limit(row_b, rows_n, s_n, t_n, q_start, causal);
  const int lim_lo = min(lim_a, lim_b);
  const int nk = d16 / 16;
  const unsigned char* qw = qs + wg * 8 * d16 * 16;   // row 64 wg
  float acc[kMaxD / 2];
#pragma unroll
  for (int i = 0; i < kMaxD / 2; ++i) acc[i] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;

  for (int j = 0; j < n_kv; ++j) {
    const int stg = j % kWgStages;
    mbar_wait(&full[stg], (j / kWgStages) & 1);
    const int t0 = j * kWgKeys;
    if (t0 < wg_end) {
      const unsigned char* kt = ks + stg * k_bytes;
      const unsigned char* vt = vs + stg * v_bytes;
      float sc[kWgKeys / 2];
#pragma unroll
      for (int i = 0; i < kWgKeys / 2; ++i) sc[i] = 0.f;
      pin(sc);
      wg_fence();
      for (int kk = 0; kk < nk; ++kk)
        wgmma_qk(sc, gmma_desc(qw + kk * 256, 128, d16 * 16),
                 gmma_desc(kt + kk * 2048, 1024, 128), kk > 0);
      wg_commit();
      wg_wait0();
      pin(sc);

      const bool edge = t0 + kWgKeys - 1 > lim_lo;
      float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
      for (int i = 0; i < kWgKeys / 2; ++i) {
        const int t = t0 + (i >> 2) * 8 + tig * 2 + (i & 1);
        const bool hi_row = (i & 2) != 0;
        float x = sc[i] * scale_log2;
        if (edge && t > (hi_row ? lim_b : lim_a)) x = kNegInf;
        sc[i] = x;
        if (hi_row) mx_b = fmaxf(mx_b, x);
        else mx_a = fmaxf(mx_a, x);
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
      }
      // a row with no visible key yet keeps m = NEG_INF and subtracts 0,
      // so its masked scores give exactly 0
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      const float mu_a = mn_a == kNegInf ? 0.f : mn_a;
      const float mu_b = mn_b == kNegInf ? 0.f : mn_b;
      const float al_a = ex2(m_a - mu_a), al_b = ex2(m_b - mu_b);
      m_a = mn_a;
      m_b = mn_b;
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int i = 0; i < kWgKeys / 2; ++i) {
        const bool hi_row = (i & 2) != 0;
        const float p = ex2(sc[i] - (hi_row ? mu_b : mu_a));
        sc[i] = p;
        if (hi_row) sum_b += p;
        else sum_a += p;
      }
      l_a = l_a * al_a + sum_a;
      l_b = l_b * al_b + sum_b;
      if (al_a != 1.f || al_b != 1.f) {
#pragma unroll
        for (int i = 0; i < kMaxD / 2; ++i) acc[i] *= (i & 2) ? al_b : al_a;
      }
      // P's A fragments for keys 16 kc .. 16 kc + 15, hi and lo halves:
      // (row a, n-group 2 kc), (b, 2 kc), (a, 2 kc + 1), (b, 2 kc + 1)
      uint32_t ph[kWgKeys / 16][4], pl[kWgKeys / 16][4];
#pragma unroll
      for (int kc = 0; kc < kWgKeys / 16; ++kc)
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const int i = (2 * kc + (h >> 1)) * 4 + (h & 1) * 2;
          split_pair(sc[i], sc[i + 1], ph[kc][h], pl[kc][h]);
        }
      pin(acc);
      wg_fence();
#pragma unroll
      for (int kc = 0; kc < kWgKeys / 16; ++kc) {
        const uint64_t dv = gmma_desc(vt + kc * 256, 128, 1024);
        wgmma_pv(acc, ph[kc], dv);
        wgmma_pv(acc, pl[kc], dv);
      }
      wg_commit();
      wg_wait0();
      pin(acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stg]);
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? row_b : row_a;
    if (row >= rows_n) continue;
    const int g = row / s_n, s = row - g * s_n;
    bf16* o = out + b * st.ob + static_cast<int64_t>(kvh * g_n + g) * st.oh
        + static_cast<int64_t>(s) * st.os;
    const float inv = 1.f / fmaxf(half ? l_b : l_a, 1e-30f);
#pragma unroll
    for (int n = 0; n < kMaxD / 8; ++n) {
      const int c = n * 8 + tig * 2;
      if (c < d_n) o[c] = __float2bfloat16(acc[4 * n + 2 * half] * inv);
      if (c + 1 < d_n)
        o[c + 1] = __float2bfloat16(acc[4 * n + 2 * half + 1] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// flash_tile_split / flash_tile_combine: split-KV decode
// ---------------------------------------------------------------------------

// Partial record of one (batch x KV head, row, chunk): m, l, acc[d_pad].
__host__ __device__ __forceinline__ int64_t part_index(int64_t bh, int row,
                                                       int c, int rows_n,
                                                       int n_split,
                                                       int d_pad) {
  return ((bh * rows_n + row) * n_split + c) * (d_pad + 2);
}

// Block (c, b x Hkv): keys [c chunk, min((c + 1) chunk, t_end)). Warp w
// takes keys 8 w + lane / 4 of each 32-key tile, lane % 4 the 16-byte
// column units u = lane % 4 + 4 i of the scores; for the value product
// lane owns output columns 4 lane .. 4 lane + 3.
template <typename T>
__global__ void __launch_bounds__(kSpThreads)
flash_tile_split(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, float* __restrict__ part,
                 Strides st, int hkv, int g_n, int s_n, int t_n, int d_n,
                 int d_pad, int64_t q_start, int causal, float scale,
                 int chunk, int t_end, int vec) {
  constexpr int kE = Vec16<T>::n;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = d_pad + 4 * kE;   // 4 units of padding per row
  float* qs = reinterpret_cast<float*>(smem);               // [16][d_pad]
  T* ks = reinterpret_cast<T*>(qs + kSpRows * d_pad);       // [stg][32][ld]
  T* vs = ks + kSpStages * kSpKeys * ld;                    // [stg][32][ld]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_split = gridDim.x, c = blockIdx.x;
  const int64_t bh = blockIdx.y;
  const int64_t b = bh / hkv;
  const int kvh = static_cast<int>(bh % hkv);
  const int rows_n = g_n * s_n;
  const int c0 = c * chunk, c1 = min(c0 + chunk, t_end);
  const int n_kv = (c1 - c0 + kSpKeys - 1) / kSpKeys;

  const T* kb = k + b * st.kb + kvh * st.kh + static_cast<int64_t>(c0) * st.kt;
  const T* vb = v + b * st.vb + kvh * st.vh + static_cast<int64_t>(c0) * st.vt;
  auto load_kv = [&](int j) {
    const int t0 = j * kSpKeys, stg = j % kSpStages;
    stage_rows(ks + stg * kSpKeys * ld, ld,
               kb + static_cast<int64_t>(t0) * st.kt, st.kt, kSpKeys,
               c1 - c0 - t0, d_n, d_pad, vec, tid, kSpThreads);
    stage_rows(vs + stg * kSpKeys * ld, ld,
               vb + static_cast<int64_t>(t0) * st.vt, st.vt, kSpKeys,
               c1 - c0 - t0, d_n, d_pad, vec, tid, kSpThreads);
  };
#pragma unroll
  for (int j = 0; j < kSpStages - 1; ++j) {
    if (j < n_kv) load_kv(j);
    cp_commit();
  }
  // the rows' queries, float32, zero from d_n to d_pad
  for (int idx = tid; idx < kSpRows * d_pad; idx += kSpThreads) {
    const int r = idx / d_pad, cc = idx - r * d_pad;
    float x = 0.f;
    if (r < rows_n && cc < d_n) {
      const int g = r / s_n, s = r - g * s_n;
      x = to_float(q[b * st.qb + static_cast<int64_t>(kvh * g_n + g) * st.qh
                     + static_cast<int64_t>(s) * st.qs + cc]);
    }
    qs[idx] = x;
  }

  const int key = warp * 8 + (lane >> 2), dq = lane & 3;
  const int n_units = d_pad / kE;
  const int dcol = lane * 4;
  float m[kSpRows], l[kSpRows], acc[kSpRows][4];
  int lim[kSpRows];
#pragma unroll
  for (int i = 0; i < kSpRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    lim[i] = row_limit(i, rows_n, s_n, t_n, q_start, causal);
  }

  for (int j = 0; j < n_kv; ++j) {
    if (j + kSpStages - 1 < n_kv) load_kv(j + kSpStages - 1);
    cp_commit();
    cp_wait<kSpStages - 1>();
    __syncthreads();
    const T* kt = ks + (j % kSpStages) * kSpKeys * ld;
    const T* vt = vs + (j % kSpStages) * kSpKeys * ld;
    const int t = c0 + j * kSpKeys + key;

    float sc[kSpRows];
#pragma unroll
    for (int i = 0; i < kSpRows; ++i) sc[i] = 0.f;
    for (int u = dq; u < n_units; u += 4) {
      float kx[kE];
      load16(kt + key * ld + u * kE, kx);
#pragma unroll
      for (int i = 0; i < kSpRows; ++i) {
        if (i >= rows_n) break;
        float qv[kE];
#pragma unroll
        for (int e = 0; e < kE; e += 4) load4(qs + i * d_pad + u * kE + e,
                                              qv + e);
#pragma unroll
        for (int e = 0; e < kE; ++e) sc[i] = fmaf(qv[e], kx[e], sc[i]);
      }
    }
    float p[kSpRows];
#pragma unroll
    for (int i = 0; i < kSpRows; ++i) {
      if (i >= rows_n) break;
      float x = sc[i];
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      x = t < c1 && t <= lim[i] ? x * scale : kNegInf;
      float mx = x;
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      p[i] = x == kNegInf ? 0.f : expf(x - m_new);
      l[i] = l[i] * alpha + p[i];   // this lane's key; summed at the end
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] *= alpha;
    }
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      float vv[4] = {0.f, 0.f, 0.f, 0.f};
      if (dcol < d_pad) load4(vt + (warp * 8 + kk) * ld + dcol, vv);
#pragma unroll
      for (int i = 0; i < kSpRows; ++i) {
        if (i >= rows_n) break;
        const float pk = __shfl_sync(0xffffffffu, p[i], kk * 4);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = fmaf(pk, vv[e], acc[i][e]);
      }
    }
    __syncthreads();
  }
  cp_wait<0>();

  // merge the 4 warps in warp order through shared memory (the K/V ring)
  float* wm = reinterpret_cast<float*>(ks);                 // [4][16]
  float* wl = wm + 4 * kSpRows;                             // [4][16]
  float* wacc = wl + 4 * kSpRows;                           // [4][16][d_pad]
#pragma unroll
  for (int i = 0; i < kSpRows; ++i) {
    if (i >= rows_n) break;
    float li = l[i];   // over the lanes of one column unit: 8 keys
#pragma unroll
    for (int off = 4; off < 32; off <<= 1)
      li += __shfl_xor_sync(0xffffffffu, li, off);
    if (lane == 0) {
      wm[warp * kSpRows + i] = m[i];
      wl[warp * kSpRows + i] = li;
    }
    if (dcol < d_pad)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        wacc[(warp * kSpRows + i) * d_pad + dcol + e] = acc[i][e];
  }
  __syncthreads();
  for (int idx = tid; idx < rows_n * d_pad; idx += kSpThreads) {
    const int i = idx / d_pad, col = idx - i * d_pad;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < 4; ++w) mx = fmaxf(mx, wm[w * kSpRows + i]);
    float a = 0.f, li = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float f = expf(wm[w * kSpRows + i] - mx);
      a += wacc[(w * kSpRows + i) * d_pad + col] * f;
      li += wl[w * kSpRows + i] * f;
    }
    float* rec = part + part_index(bh, i, c, rows_n, n_split, d_pad);
    if (col == 0) {
      rec[0] = mx;
      rec[1] = li;
    }
    rec[2 + col] = a;
  }
}

// The bf16 split pass on the tensor cores: the rows of the KV head (at
// most 16, zero past G * S) are one 16-row A tile; warp w takes keys
// 16 w .. 16 w + 15 of each 64-key tile (two 8-key n-tiles of S = Q K^T,
// one 16-key k-chunk of O += P V, P split into bf16 hi and lo halves as in
// flash_tile_mma) and keeps its own (m, l, acc) in base 2; the warps merge
// in warp order and the partial's m is stored in natural-log units. K and
// V tiles arrive by TMA (thread 0 refills the ring after each barrier) as
// 64-column halves of 64 keys x 128 B with the 128-byte swizzle: key t,
// column c at (c / 64) 8192 + 128 t + 16 ((c % 64 / 8) ^ (t % 8))
// + 2 (c % 8) bytes, which ldmatrix reads 8 keys at a time free of bank
// conflicts.
__global__ void __launch_bounds__(kSdThreads)
flash_tile_split_mma(const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const bf16* __restrict__ q, float* __restrict__ part,
                     Strides st, int hkv, int g_n, int s_n, int t_n,
                     int d_n, int d16, int d_pad, int64_t q_start,
                     int causal, float scale_log2, int chunk, int t_end) {
  extern __shared__ __align__(1024) unsigned char smem_split[];
  const int tile_bytes = (d_n + 63) / 64 * 8192;
  const int ld = d16 + 8;
  unsigned char* ks = smem_split;                             // [stg]
  unsigned char* vs = ks + kSdStages * tile_bytes;            // [stg]
  bf16* qs = reinterpret_cast<bf16*>(vs + kSdStages * tile_bytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(qs + kSpRows * ld);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int n_split = gridDim.x, c = blockIdx.x;
  const int64_t bh = blockIdx.y;
  const int64_t b = bh / hkv;
  const int kvh = static_cast<int>(bh % hkv);
  const int rows_n = g_n * s_n;
  const int c0 = c * chunk, c1 = min(c0 + chunk, t_end);
  const int n_kv = (c1 - c0 + kSdKeys - 1) / kSdKeys;

  // the rows' queries, zero past rows_n and from d_n to d16
  for (int idx = tid; idx < kSpRows * (d16 / 8); idx += kSdThreads) {
    const int r = idx / (d16 / 8), cc = (idx - r * (d16 / 8)) * 8;
    const bool ok = r < rows_n && cc < d_n;
    const bf16* src = q;
    if (ok) {
      const int g = r / s_n, s = r - g * s_n;
      src = q + b * st.qb + static_cast<int64_t>(kvh * g_n + g) * st.qh
          + static_cast<int64_t>(s) * st.qs + cc;
    }
    copy_async<16>(qs + r * ld + cc, src, ok);
  }
  cp_commit();
  if (tid == 0) {
    for (int i = 0; i < kSdStages; ++i) mbar_init(&full[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cp_wait<0>();
  __syncthreads();
  auto load_kv = [&](int j) {
    const int stg = j % kSdStages;
    mbar_expect_tx(&full[stg], 2u * tile_bytes);
    for (int h = 0; h < tile_bytes / 8192; ++h) {
      tma_load4(ks + stg * tile_bytes + h * 8192, &tk, h * 64,
                c0 + j * kSdKeys, kvh, static_cast<int>(b), &full[stg]);
      tma_load4(vs + stg * tile_bytes + h * 8192, &tv, h * 64,
                c0 + j * kSdKeys, kvh, static_cast<int>(b), &full[stg]);
    }
  };
  if (tid == 0)
    for (int j = 0; j < kSdStages - 1 && j < n_kv; ++j) load_kv(j);

  const int lim_a = row_limit(gid, rows_n, s_n, t_n, q_start, causal);
  const int lim_b = row_limit(gid + 8, rows_n, s_n, t_n, q_start, causal);
  const int nk = d16 / 16;
  uint32_t qf[kMaxD / 16][4];
#pragma unroll
  for (int kk = 0; kk < kMaxD / 16; ++kk)
    if (kk < nk)
      ldsm_x4(qf[kk], qs + ((lane & 7) + ((lane >> 3) & 1) * 8) * ld
                          + kk * 16 + (lane >> 4) * 8);
  float acc[kMaxD / 8][4];
#pragma unroll
  for (int n = 0; n < kMaxD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
  // this lane's ldmatrix rows: keys of the warp's 16, and 8-column groups
  const int key_k = warp * 16 + (lane & 7) + (lane >> 4) * 8;
  const int grp_k = (lane >> 3) & 1;
  const int key_v = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int grp_v = lane >> 4;
  // byte offset of (key t, 8-column group g) in a swizzled tile
  auto swz = [](int t, int g) {
    return (g >> 3) * 8192 + t * 128 + (((g & 7) ^ (t & 7)) << 4);
  };

  for (int j = 0; j < n_kv; ++j) {
    const int stg = j % kSdStages;
    mbar_wait(&full[stg], (j / kSdStages) & 1);
    __syncthreads();   // every warp is done with tile j - 1 and its stage
    if (tid == 0 && j + kSdStages - 1 < n_kv) load_kv(j + kSdStages - 1);
    const unsigned char* kt = ks + stg * tile_bytes;
    const unsigned char* vt = vs + stg * tile_bytes;
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < kMaxD / 16; ++kk) {
      if (kk >= nk) break;
      uint32_t r[4];
      ldsm_x4(r, reinterpret_cast<const bf16*>(
                     kt + swz(key_k, 2 * kk + grp_k)));
      mma_bf16(sc[0], qf[kk], r[0], r[1]);
      mma_bf16(sc[1], qf[kk], r[2], r[3]);
    }
    const int tb = c0 + j * kSdKeys + warp * 16;
    float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = tb + nt * 8 + tig * 2 + (e & 1);
        float x = sc[nt][e] * scale_log2;
        if (t >= c1 || t > (e < 2 ? lim_a : lim_b)) x = kNegInf;
        sc[nt][e] = x;
        if (e < 2) mx_a = fmaxf(mx_a, x);
        else mx_b = fmaxf(mx_b, x);
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    // a row with no visible key yet keeps m = NEG_INF and subtracts 0
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float mu_a = mn_a == kNegInf ? 0.f : mn_a;
    const float mu_b = mn_b == kNegInf ? 0.f : mn_b;
    const float al_a = ex2(m_a - mu_a), al_b = ex2(m_b - mu_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pv = ex2(sc[nt][e] - (e < 2 ? mu_a : mu_b));
        sc[nt][e] = pv;
        if (e < 2) sum_a += pv;
        else sum_b += pv;
      }
    l_a = l_a * al_a + sum_a;
    l_b = l_b * al_b + sum_b;
    if (al_a != 1.f || al_b != 1.f) {
#pragma unroll
      for (int n = 0; n < kMaxD / 8; ++n) {
        acc[n][0] *= al_a;
        acc[n][1] *= al_a;
        acc[n][2] *= al_b;
        acc[n][3] *= al_b;
      }
    }
    uint32_t ph[4], pl[4];
    split_pair(sc[0][0], sc[0][1], ph[0], pl[0]);
    split_pair(sc[0][2], sc[0][3], ph[1], pl[1]);
    split_pair(sc[1][0], sc[1][1], ph[2], pl[2]);
    split_pair(sc[1][2], sc[1][3], ph[3], pl[3]);
#pragma unroll
    for (int nd = 0; nd < kMaxD / 16; ++nd) {
      if (nd >= nk) break;
      uint32_t r[4];
      ldsm_x4_t(r, reinterpret_cast<const bf16*>(
                       vt + swz(key_v, 2 * nd + grp_v)));
      mma_bf16(acc[2 * nd], ph, r[0], r[1]);
      mma_bf16(acc[2 * nd], pl, r[0], r[1]);
      mma_bf16(acc[2 * nd + 1], ph, r[2], r[3]);
      mma_bf16(acc[2 * nd + 1], pl, r[2], r[3]);
    }
  }
  __syncthreads();   // every warp is done with the ring (no copy in flight)

  // merge the 4 warps in warp order through shared memory (the ring)
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  float* wm = reinterpret_cast<float*>(ks);                 // [4][16]
  float* wl = wm + 4 * kSpRows;                             // [4][16]
  float* wacc = wl + 4 * kSpRows;                           // [4][16][d_pad]
  if (tig == 0) {
    wm[warp * kSpRows + gid] = m_a;
    wm[warp * kSpRows + gid + 8] = m_b;
    wl[warp * kSpRows + gid] = l_a;
    wl[warp * kSpRows + gid + 8] = l_b;
  }
#pragma unroll
  for (int n = 0; n < kMaxD / 8; ++n) {
    const int col = n * 8 + tig * 2;   // d_pad is a multiple of 8
    if (col >= d_pad) break;
    float* ra = wacc + (warp * kSpRows + gid) * d_pad + col;
    float* rb = ra + 8 * d_pad;
    ra[0] = acc[n][0];
    ra[1] = acc[n][1];
    rb[0] = acc[n][2];
    rb[1] = acc[n][3];
  }
  __syncthreads();
  for (int idx = tid; idx < rows_n * d_pad; idx += kSdThreads) {
    const int i = idx / d_pad, col = idx - i * d_pad;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < 4; ++w) mx = fmaxf(mx, wm[w * kSpRows + i]);
    float a = 0.f, li = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float f = exp2f(wm[w * kSpRows + i] - mx);
      a += wacc[(w * kSpRows + i) * d_pad + col] * f;
      li += wl[w * kSpRows + i] * f;
    }
    float* rec = part + part_index(bh, i, c, rows_n, n_split, d_pad);
    if (col == 0) {
      rec[0] = mx * kLn2;
      rec[1] = li;
    }
    rec[2 + col] = a;
  }
}

// Block (row, b x Hkv): merge the row's n_split partials in chunk order.
// Where lse is given, thread 0 also stores the row's float32 log-sum-exp
// of its scaled scores, m + log(l), at lse[(b h + head) s_n + s] (-inf
// where the row saw no key): what a split-KV decode across ranks combines.
template <typename T>
__global__ void __launch_bounds__(kCbThreads)
flash_tile_combine(const float* __restrict__ part, T* __restrict__ out,
                   float* __restrict__ lse, Strides st, int hkv, int g_n,
                   int s_n, int d_n, int d_pad, int n_split) {
  const int i = blockIdx.x, rows_n = gridDim.x;
  const int64_t bh = blockIdx.y;
  const int64_t b = bh / hkv;
  const int kvh = static_cast<int>(bh % hkv);
  const float* rec = part + part_index(bh, i, 0, rows_n, n_split, d_pad);
  const int rl = d_pad + 2;
  float mx = kNegInf;
  for (int c = 0; c < n_split; ++c) mx = fmaxf(mx, rec[c * rl]);
  float li = 0.f;
  for (int c = 0; c < n_split; ++c)
    li += rec[c * rl + 1] * expf(rec[c * rl] - mx);
  const float inv = 1.f / fmaxf(li, 1e-30f);
  const int g = i / s_n, s = i - g * s_n;
  if (lse != nullptr && threadIdx.x == 0)
    lse[(b * hkv * g_n + kvh * g_n + g) * static_cast<int64_t>(s_n) + s] =
        li > 0.f ? mx + logf(li)
                 : __int_as_float(static_cast<int>(0xff800000u));  // -inf
  T* o = out + b * st.ob + static_cast<int64_t>(kvh * g_n + g) * st.oh
      + static_cast<int64_t>(s) * st.os;
  for (int col = threadIdx.x; col < d_n; col += kCbThreads) {
    float a = 0.f;
    for (int c = 0; c < n_split; ++c)
      a += rec[c * rl + 2 + col] * expf(rec[c * rl] - mx);
    o[col] = from_float<T>(a * inv);
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

struct Shape {
  long long b_n, hkv, g_n, s_n, t_n, d_n, q_start;
  int causal;
  float scale;
};

// Whether cp.async copies of vec bytes can take a tensor: its address, the
// strides of its first three dims and the head dim whole chunks.
template <typename T>
bool takes_vec(int vec, const void* p, const int64_t* strides,
               long long d_n) {
  const long long e = vec / static_cast<long long>(sizeof(T));
  if (e < 1 || reinterpret_cast<uintptr_t>(p) % vec != 0 || d_n % e != 0)
    return false;
  for (int i = 0; i < 3; ++i)
    if (strides[i] % e != 0) return false;
  return true;
}

template <typename F>
cudaError_t set_smem(F* fn, size_t smem) {
  if (smem > 232448) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T, int RM>
int launch_tile(const void* q, const void* k, const void* v, void* out,
                const Strides& st, const Shape& sh, cudaStream_t stream) {
  constexpr int kRows = 16 * RM;
  const long long n_tiles = (sh.g_n * sh.s_n + kRows - 1) / kRows;
  const int d_pad = static_cast<int>((sh.d_n + 3) / 4 * 4);
  const size_t smem = smem_bytes<T>(kRows, d_pad);
  if (n_tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = set_smem(flash_tile<T, RM>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  // K and V in 8-byte chunks: both 8-byte aligned, strides and the head
  // dim whole chunks
  const bool async8 = takes_vec<T>(8, k, &st.kb, sh.d_n)
      && takes_vec<T>(8, v, &st.vb, sh.d_n);
  dim3 grid(static_cast<unsigned>(n_tiles),
            static_cast<unsigned>(sh.b_n * sh.hkv));
  flash_tile<T, RM><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), st,
      static_cast<int>(sh.hkv), static_cast<int>(sh.g_n),
      static_cast<int>(sh.s_n), static_cast<int>(sh.t_n),
      static_cast<int>(sh.d_n), d_pad, sh.q_start, sh.causal, sh.scale,
      static_cast<int>(n_tiles), async8);
  return static_cast<int>(cudaGetLastError());
}

int launch_mma(const void* q, const void* k, const void* v, void* out,
              const Strides& st, const Shape& sh, int vec,
              cudaStream_t stream) {
  // 16- or 8-byte copies of all three inputs
  if ((vec != 16 && vec != 8) || !takes_vec<bf16>(vec, q, &st.qb, sh.d_n)
      || !takes_vec<bf16>(vec, k, &st.kb, sh.d_n)
      || !takes_vec<bf16>(vec, v, &st.vb, sh.d_n))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_tiles = (sh.g_n * sh.s_n + kMmaRows - 1) / kMmaRows;
  const int d16 = static_cast<int>((sh.d_n + 15) / 16 * 16);
  const size_t smem = static_cast<size_t>(kMmaRows + 2 * kMmaStages * kMmaKeys)
      * (d16 + 8) * sizeof(bf16);
  if (n_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = set_smem(flash_tile_mma, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(static_cast<unsigned>(sh.b_n * sh.hkv),
            static_cast<unsigned>(n_tiles));
  flash_tile_mma<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), st,
      static_cast<int>(sh.hkv), static_cast<int>(sh.g_n),
      static_cast<int>(sh.s_n), static_cast<int>(sh.t_n),
      static_cast<int>(sh.d_n), d16, sh.q_start, sh.causal,
      sh.scale * 1.4426950408889634f, static_cast<int>(n_tiles), vec);
  return static_cast<int>(cudaGetLastError());
}

// cuTensorMapEncodeTiled through the runtime's driver entry point (no
// link against libcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &res)
            == cudaSuccess && res == cudaDriverEntryPointSuccess)
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &res) == cudaSuccess
        && res == cudaDriverEntryPointSuccess)
#endif
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The (8 elements, T keys, d / 8 groups, Hkv, B) view of a K or V tensor
// and its (8, 64, d / 8, 1, 1) box: one tile of 64 keys, group-major.
bool kv_map(CUtensorMap* map, const void* base, const int64_t* strides,
            const Shape& sh) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[5] = {8, static_cast<cuuint64_t>(sh.t_n),
                              static_cast<cuuint64_t>(sh.d_n / 8),
                              static_cast<cuuint64_t>(sh.hkv),
                              static_cast<cuuint64_t>(sh.b_n)};
  const cuuint64_t gstr[4] = {static_cast<cuuint64_t>(strides[2]) * 2, 16,
                              static_cast<cuuint64_t>(strides[1]) * 2,
                              static_cast<cuuint64_t>(strides[0]) * 2};
  const cuuint32_t box[5] = {8, kWgKeys, static_cast<cuuint32_t>(sh.d_n / 8),
                             1, 1};
  const cuuint32_t estr[5] = {1, 1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(base),
             dims, gstr, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The (d, T keys, Hkv, B) view of a K or V tensor and its (64, 64, 1, 1)
// box with the 128-byte swizzle: half a 128-column tile of 64 keys.
bool kv_map_swizzled(CUtensorMap* map, const void* base,
                     const int64_t* strides, const Shape& sh) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(sh.d_n),
                              static_cast<cuuint64_t>(sh.t_n),
                              static_cast<cuuint64_t>(sh.hkv),
                              static_cast<cuuint64_t>(sh.b_n)};
  const cuuint64_t gstr[3] = {static_cast<cuuint64_t>(strides[2]) * 2,
                              static_cast<cuuint64_t>(strides[1]) * 2,
                              static_cast<cuuint64_t>(strides[0]) * 2};
  const cuuint32_t box[4] = {64, kSdKeys, 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
             dims, gstr, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int launch_wgmma(const void* q, const void* k, const void* v, void* out,
              const Strides& st, const Shape& sh, cudaStream_t stream) {
  // whole 16-byte column groups of all three inputs, 64 keys or more
  if (sh.d_n % 8 != 0 || sh.t_n < kWgKeys
      || !takes_vec<bf16>(16, q, &st.qb, sh.d_n)
      || !takes_vec<bf16>(16, k, &st.kb, sh.d_n)
      || !takes_vec<bf16>(16, v, &st.vb, sh.d_n))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tk, tv;
  if (!kv_map(&tk, k, &st.kb, sh) || !kv_map(&tv, v, &st.vb, sh))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_tiles = (sh.g_n * sh.s_n + kWgRows - 1) / kWgRows;
  const int d16 = static_cast<int>((sh.d_n + 15) / 16 * 16);
  const size_t smem = static_cast<size_t>(kWgRows * d16 + kWgStages
                                          * kWgKeys * (d16 + kMaxD)) * 2
      + 2 * kWgStages * sizeof(uint64_t);
  if (n_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = set_smem(flash_tile_wgmma, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(static_cast<unsigned>(sh.b_n * sh.hkv),
            static_cast<unsigned>(n_tiles));
  flash_tile_wgmma<<<grid, kWgThreads, smem, stream>>>(
      tk, tv, static_cast<const bf16*>(q), static_cast<bf16*>(out), st,
      static_cast<int>(sh.hkv), static_cast<int>(sh.g_n),
      static_cast<int>(sh.s_n), static_cast<int>(sh.t_n),
      static_cast<int>(sh.d_n), d16, sh.q_start, sh.causal,
      sh.scale * 1.4426950408889634f, static_cast<int>(n_tiles));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_split(const void* q, const void* k, const void* v, void* out,
                 float* part, long long part_n, float* lse,
                 const Strides& st, const Shape& sh, int vec,
                 long long n_split, long long chunk, cudaStream_t stream) {
  const long long rows_n = sh.g_n * sh.s_n;
  const long long t_end = sh.causal
      ? (sh.t_n < sh.q_start + sh.s_n ? sh.t_n : sh.q_start + sh.s_n)
      : sh.t_n;
  const int d_pad = static_cast<int>((sh.d_n + 7) / 8 * 8);
  // the chunks cover [0, t_end), each one at least one key
  if (rows_n > kSpRows || n_split < 1 || n_split > 65535 || chunk < 1
      || n_split * chunk < t_end || (n_split - 1) * chunk >= t_end
      || (vec != 0 && (!takes_vec<T>(vec, k, &st.kb, sh.d_n)
                       || !takes_vec<T>(vec, v, &st.vb, sh.d_n)))
      || part == nullptr
      || part_n < sh.b_n * sh.hkv * rows_n * n_split * (d_pad + 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned bh = static_cast<unsigned>(sh.b_n * sh.hkv);
  const dim3 grid(static_cast<unsigned>(n_split), bh);
  cudaError_t e;
  // bf16 whose inputs take TMA's 16-byte column groups, 64 keys or more:
  // the tensor-core pass (chosen by shape; a tensor map that does not
  // encode fails the call)
  if (sizeof(T) == 2 && sh.d_n % 64 == 0 && sh.t_n >= kSdKeys
      && takes_vec<T>(16, q, &st.qb, sh.d_n)
      && takes_vec<T>(16, k, &st.kb, sh.d_n)
      && takes_vec<T>(16, v, &st.vb, sh.d_n)) {
    CUtensorMap tk, tv;
    if (!kv_map_swizzled(&tk, k, &st.kb, sh)
        || !kv_map_swizzled(&tv, v, &st.vb, sh))
      return static_cast<int>(cudaErrorInvalidValue);
    const int d16 = static_cast<int>((sh.d_n + 15) / 16 * 16);
    const size_t smem = 2 * kSdStages * static_cast<size_t>(sh.d_n / 64)
        * 8192 + kSpRows * (d16 + 8) * 2 + kSdStages * sizeof(uint64_t);
    e = set_smem(flash_tile_split_mma, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    flash_tile_split_mma<<<grid, kSdThreads, smem, stream>>>(
        tk, tv, static_cast<const bf16*>(q), part, st,
        static_cast<int>(sh.hkv), static_cast<int>(sh.g_n),
        static_cast<int>(sh.s_n), static_cast<int>(sh.t_n),
        static_cast<int>(sh.d_n), d16, d_pad, sh.q_start, sh.causal,
        sh.scale * 1.4426950408889634f, static_cast<int>(chunk),
        static_cast<int>(t_end));
  } else {
    const int ld = d_pad + 4 * Vec16<T>::n;
    const size_t smem = kSpRows * d_pad * sizeof(float)
        + 2 * kSpStages * kSpKeys * static_cast<size_t>(ld) * sizeof(T);
    e = set_smem(flash_tile_split<T>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    flash_tile_split<T><<<grid, kSpThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), part, st, static_cast<int>(sh.hkv),
        static_cast<int>(sh.g_n), static_cast<int>(sh.s_n),
        static_cast<int>(sh.t_n), static_cast<int>(sh.d_n), d_pad,
        sh.q_start, sh.causal, sh.scale, static_cast<int>(chunk),
        static_cast<int>(t_end), vec);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_tile_combine<T><<<dim3(static_cast<unsigned>(rows_n), bh),
                          kCbThreads, 0, stream>>>(
      part, static_cast<T*>(out), lse, st, static_cast<int>(sh.hkv),
      static_cast<int>(sh.g_n), static_cast<int>(sh.s_n),
      static_cast<int>(sh.d_n), d_pad, static_cast<int>(n_split));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out,
             float* part, long long part_n, float* lse, const Strides& st,
             const Shape& sh, int route, int vec, long long n_split,
             long long chunk, cudaStream_t stream) {
  if (route == 2)
    return launch_split<T>(q, k, v, out, part, part_n, lse, st, sh, vec,
                           n_split, chunk, stream);
  // only the split route's combine writes a log-sum-exp
  if (lse != nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (route == 1 || route == 3) {
    if constexpr (sizeof(T) == 2)
      return route == 1 ? launch_mma(q, k, v, out, st, sh, vec, stream)
                        : launch_wgmma(q, k, v, out, st, sh, stream);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (route != 0) return static_cast<int>(cudaErrorInvalidValue);
  // at most 16 rows per KV head (a decode step) take 16-row blocks
  if (sh.g_n * sh.s_n <= 16)
    return launch_tile<T, 1>(q, k, v, out, st, sh, stream);
  return launch_tile<T, 4>(q, k, v, out, st, sh, stream);
}

}  // namespace

extern "C" {

// q: (b, h, s, d), k and v: (b, hkv, t, d), out: (b, h, s, d), each given
// by its data pointer and the element strides of its first three dims
// (strides[0..11]: q, k, v, out); the last dim is contiguous. dtype 0 is
// float32, 1 bfloat16. h % hkv == 0, 1 <= d <= 128, t >= 1, and with
// causal, q_start >= 0 (row s sees keys t <= q_start + s). route 0 is
// flash_tile, 1 flash_tile_mma (bfloat16; vec 16 or 8 bytes per copy), 2
// the split-KV pair (h / hkv * s <= 16 rows; n_split chunks of `chunk`
// keys covering [0, t_end), vec 16, 8, 4 or 0 for element loads; part:
// float32 scratch of part_n >= b hkv rows n_split (round_up(d, 8) + 2)
// elements; lse, if not null, a contiguous float32 (b, h, s) that takes
// each row's log-sum-exp). A route the shape does not fit, and an lse
// with any other route, is refused. Returns cudaGetLastError().
int flash_attention(const void* q, const void* k, const void* v, void* out,
                    void* part, long long part_n, int dtype, long long b_n,
                    long long h_n, long long hkv, long long s_n,
                    long long t_n, long long d_n, const long long* strides,
                    long long q_start, int causal, float scale, int route,
                    int vec, long long n_split, long long chunk,
                    void* stream, void* lse) {
  if (b_n <= 0 || s_n <= 0) return 0;
  if (hkv <= 0 || h_n % hkv != 0 || t_n <= 0 || d_n <= 0 || d_n > kMaxD
      || (causal && q_start < 0) || h_n * s_n > 0x7fffffffLL
      || t_n > 0x7fffffffLL || b_n * hkv > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{strides[0], strides[1], strides[2], strides[3],
                   strides[4], strides[5], strides[6], strides[7],
                   strides[8], strides[9], strides[10], strides[11]};
  const Shape sh{b_n, hkv, h_n / hkv, s_n, t_n, d_n, q_start, causal, scale};
  const auto s = static_cast<cudaStream_t>(stream);
  auto* pf = static_cast<float*>(part);
  auto* lf = static_cast<float*>(lse);
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, pf, part_n, lf, st, sh, route, vec,
                           n_split, chunk, s);
  if (dtype == 1)
    return dispatch<bf16>(q, k, v, out, pf, part_n, lf, st, sh, route, vec,
                          n_split, chunk, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
