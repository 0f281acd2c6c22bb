// Q x Q Jaccard distance matrix over a (Q, F) 0/1 membership matrix.
//
// Replaces src/repro/kernels/jaccard/kernel.py:48, jaccard_distance_kernel
// (body _jaccard_kernel at :22) with its padding in
// src/repro/kernels/jaccard/ops.py:13 (jaccard_distance):
//   inter = m @ m^T, counts = m.sum(1), union = ci + cj - inter,
//   sim = union > 0 ? inter / max(union, 1e-30) : 1,
//   d = (1 - sim) * (i == j ? 0 : 1).
// The TPU kernel pads Q and F to 128-multiples and carries the partial
// intersections of a (128, 128) output tile across its sequential feature
// grid axis.
//
// Bound on the H100: operations. The intersections are Q (Q + 1) / 2 dot
// products of F (the output is symmetric), exact on int8 tensor cores for
// 0/1 operands; the Q x Q float32 write is the byte floor (0.32 ms at
// 16,380 queries). Two kernels:
// * jaccard_pack: one warp per row reads the float32 matrix once and
//   writes a zero-padded int8 copy (Q, Fp), Fp = F rounded up to 16 (16-byte
//   rows for TMA), and the row counts in int32; any value other than 0 or 1
//   sets a flag the wrapper raises on.
// * jaccard_tri: a block per 128 x 128 output tile (i, j) with i <= j only,
//   a linear block index mapped to the upper triangle of tiles (consecutive
//   blocks share the column tile j). A producer warp streams the rows of
//   tiles i and j (one tile on the diagonal) by TMA, 128 features at a time
//   as 128-byte rows under the 128-byte swizzle (a TMA request per whole
//   row, not per 16 bytes), into a 3-stage mbarrier ring; two consumer
//   warpgroups (64 rows of i each) run int8 wgmma m64n128k32 with int32
//   accumulators (exact), one stage's products in flight while the next
//   stage is waited on; two blocks share an SM. The epilogue converts the
//   counts to float32 (exact below 2^24) and applies the plain version's
//   float32 expressions in its order, with IEEE division: the result is
//   bit-identical to it. The distance tile is staged in shared memory (rows
//   of 129 floats, free of bank conflicts both ways) and stored twice, as
//   (i, j) and transposed as (j, i), each warp writing 128 contiguous bytes
//   with streaming stores; so the output is symmetric by construction.
//   Ragged Q and F load zeros (TMA fills outside the tensor) and are masked
//   at the store.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

using namespace hopper;

constexpr int kTile = 128;              // output tile edge
constexpr int kBK = 128;                // features (bytes) per ring stage
constexpr int kStages = 3;
constexpr int kTileBytes = kTile * kBK;  // one operand tile of a stage
constexpr int kThreads = 288;           // two consumer warpgroups + producer
constexpr int kConsumers = 256;
constexpr int kLdo = kTile + 1;         // staged distance row, in floats
constexpr int kPackThreads = 256;
constexpr long long kSmem = 2LL * kStages * kTileBytes
    + 2 * kStages * sizeof(uint64_t);

__global__ void __launch_bounds__(kPackThreads)
jaccard_pack(const float* __restrict__ m, int8_t* __restrict__ packed,
             int* __restrict__ counts, int* __restrict__ bad, int64_t q,
             int64_t f, int64_t fp) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kPackThreads / 32)
      + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= q) return;
  const float* r = m + row * f;
  int8_t* o = packed + row * fp;
  int c = 0;
  bool ok = true;
#pragma unroll 4
  for (int64_t k = lane; k < fp; k += 32) {
    const float v = k < f ? r[k] : 0.f;
    ok = ok && (v == 0.f || v == 1.f);
    const int one = v == 1.f;
    o[k] = static_cast<int8_t>(one);
    c += one;
  }
  for (int s = 16; s > 0; s >>= 1) c += __shfl_down_sync(0xffffffffu, c, s);
  ok = __all_sync(0xffffffffu, ok);
  if (lane == 0) {
    counts[row] = c;
    if (!ok) atomicOr(bad, 1);
  }
}

// D (64 x 128, int32) += A (64 x 32, s8, shared) B (32 x 128, s8, shared),
// both K-major.
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t da,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// Upper-triangle tile (bi, bj), bi <= bj, of linear index t: the tiles of
// column tile bj are t = bj (bj + 1) / 2 + bi.
__device__ __forceinline__ void triangle_tile(int64_t t, int& bi, int& bj) {
  int64_t j = static_cast<int64_t>((sqrt(8.0 * static_cast<double>(t) + 1.0)
                                    - 1.0) * 0.5);
  while ((j + 1) * (j + 2) / 2 <= t) ++j;
  while (j * (j + 1) / 2 > t) --j;
  bj = static_cast<int>(j);
  bi = static_cast<int>(t - j * (j + 1) / 2);
}

// An operand tile lands as 128 rows of its 128 features, 128 bytes a row
// under the 128-byte swizzle (K-major, sw128_desc; the k32 step kk starts
// 32 kk bytes into the row). Consumer warpgroup w owns rows 64 w .. 64 w + 63
// of tile i; its warp v rows 16 v .. + 15, lane (gid, tig) rows + gid and
// + gid + 8, accumulator registers 4 c + e at column 8 c + 2 tig + (e & 1)
// of tile j.
__global__ void __launch_bounds__(kThreads, 2)
jaccard_tri(const __grid_constant__ CUtensorMap tm,
            const int* __restrict__ counts, float* __restrict__ out,
            int64_t q, int n_k) {
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + 2 * kStages
                                               * kTileBytes);
  uint64_t* empty = full + kStages;
  int bi, bj;
  triangle_tile(blockIdx.x, bi, bj);
  const bool diag = bi == bj;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);  // lane 0 of each consumer warp
    }
    mbar_init_fence();
  }
  async_fence();
  __syncthreads();

  if (warp == kConsumers / 32) {             // the producer
    if (lane == 0) {
      const uint32_t bytes = (diag ? 1u : 2u) * kTileBytes;
      for (int s = 0; s < n_k; ++s) {
        const int stg = s % kStages;
        if (s >= kStages) mbar_wait(&empty[stg], (s / kStages - 1) & 1);
        unsigned char* a = smem + stg * 2 * kTileBytes;
        mbar_expect_tx(&full[stg], bytes);
        tma_load2(a, &tm, s * kBK, bi * kTile, &full[stg]);
        if (!diag)
          tma_load2(a + kTileBytes, &tm, s * kBK, bj * kTile, &full[stg]);
      }
    }
    return;
  }

  const int wg = warp >> 2;
  int acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
  for (int s = 0; s < n_k; ++s) {
    const int stg = s % kStages;
    mbar_wait(&full[stg], (s / kStages) & 1);
    const unsigned char* a = smem + stg * 2 * kTileBytes;
    const unsigned char* b = diag ? a : a + kTileBytes;
    pin(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk)
      wgmma_s8_n128(acc, sw128_desc(a + wg * 64 * kBK + kk * 32),
                    sw128_desc(b + kk * 32));
    wg_commit();
    wg_wait<1>();             // stage s - 1's products are done
    pin(acc);
    if (s > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(s - 1) % kStages]);
    }
  }
  wg_wait<0>();
  pin(acc);

  // the epilogue reuses the ring: every consumer is past its last product
  bar_sync(kConsumers);
  float* sd = reinterpret_cast<float*>(smem);     // [128][kLdo]
  const int gid = lane >> 2, tig = lane & 3;
  const int ra = wg * 64 + (warp & 3) * 16 + gid;
  const int64_t i0 = static_cast<int64_t>(bi) * kTile;
  const int64_t j0 = static_cast<int64_t>(bj) * kTile;
  float ci[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t gi = i0 + ra + 8 * h;
    ci[h] = gi < q ? static_cast<float>(counts[gi]) : 0.f;
  }
#pragma unroll
  for (int c = 0; c < kTile / 8; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = ra + 8 * (e >> 1), col = 8 * c + 2 * tig + (e & 1);
      const int64_t gi = i0 + r, gj = j0 + col;
      const float cj = gj < q ? static_cast<float>(counts[gj]) : 0.f;
      const float inter = static_cast<float>(acc[4 * c + e]);
      const float uni = ci[e >> 1] + cj - inter;
      const float sim = uni > 0.f ? inter / fmaxf(uni, 1e-30f) : 1.f;
      sd[r * kLdo + col] = (1.f - sim) * (gi == gj ? 0.f : 1.f);
    }
  }
  bar_sync(kConsumers);
  // (i, j): a warp per 32 columns of a row; (j, i): per 32 rows of a column
  for (int idx = tid; idx < kTile * kTile; idx += kConsumers) {
    const int r = idx >> 7, col = idx & 127;
    if (i0 + r < q && j0 + col < q)
      __stcs(out + (i0 + r) * q + j0 + col, sd[r * kLdo + col]);
  }
  if (!diag) {
    for (int idx = tid; idx < kTile * kTile; idx += kConsumers) {
      const int col = idx >> 7, r = idx & 127;
      if (i0 + r < q && j0 + col < q)
        __stcs(out + (j0 + col) * q + i0 + r, sd[r * kLdo + col]);
    }
  }
}

// The (Fp, Q) view of the packed matrix and its (128, 128) box: 128 rows
// of 128 features, each row 128 bytes under the 128-byte swizzle.
bool packed_map(CUtensorMap* map, const void* packed, long long q,
                long long fp) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(fp),
                              static_cast<cuuint64_t>(q)};
  const cuuint64_t gstr[1] = {static_cast<cuuint64_t>(fp)};
  const cuuint32_t box[2] = {kBK, kTile};
  const cuuint32_t estr[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(packed),
             dims, gstr, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" {

// m: (q, f) float32; packed: (q, fp) int8 scratch, fp = f rounded up to
// 16; counts: (q,) int32 scratch; bad: one int32, zeroed by the caller and
// set when m holds a value other than 0 or 1; out: (q, q) float32.
// Returns cudaGetLastError() (cudaErrorInvalidValue for shapes it refuses).
int jaccard_distance(const void* m, void* packed, void* counts, void* bad,
                     void* out, long long q, long long f, long long fp,
                     void* stream) {
  if (q <= 0) return 0;
  if (f <= 0 || fp < f || fp % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long t = (q + kTile - 1) / kTile;
  if (t * (t + 1) / 2 > 0x7fffffffLL || q > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tm;
  if (!packed_map(&tm, packed, q, fp))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows_per_block = kPackThreads / 32;
  jaccard_pack<<<static_cast<unsigned>((q + rows_per_block - 1)
                                       / rows_per_block),
                 kPackThreads, 0, s>>>(
      static_cast<const float*>(m), static_cast<int8_t*>(packed),
      static_cast<int*>(counts), static_cast<int*>(bad), q, f, fp);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  e = set_smem(jaccard_tri, kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  jaccard_tri<<<static_cast<unsigned>(t * (t + 1) / 2), kThreads, kSmem, s>>>(
      tm, static_cast<const int*>(counts), static_cast<float*>(out), q,
      static_cast<int>((fp + kBK - 1) / kBK));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
