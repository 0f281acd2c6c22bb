// Fused xDeepFM CIN layer:
//   out[b, k, d] = sum_h xk[b, h, d] * sum_f w[k, h, f] * x0[b, f, d].
//
// Replaces src/repro/kernels/cin/kernel.py:42, cin_layer_kernel (body
// _cin_kernel at :23) with its padding in src/repro/kernels/cin/ops.py:12
// (cin_layer). The TPU kernel works per example: a (K*H, F) @ (F, D) MXU
// product, then a reduction over h, with B and K padded to its blocks.
// Here the layer is one product over the flattened reduction axis
// p = (h, f):
//   out[(b, d), k] = sum_p z[(b, d), p] * w[k, p],
//   z[(b, d), (h, f)] = xk[b, h, d] * x0[b, f, d],
// whose left operand z, the (B, H, F, D) outer product, is never stored
// in device memory.
//
// Bound on the H100: operations, 2 B K D H F multiply-adds at the served
// shapes (the inputs and output are a few MB at batch 512). float32 on the
// CUDA cores runs at 67 TFLOP/s, and TF32 or bf16 alone on the tensor cores
// miss the layer's tolerance (atol 5e-4, rtol 1e-4). So each z value
// is formed in float32 and split into bf16 hi = bf16(z) and lo =
// bf16(z - hi), w likewise, and three bf16 products (hi hi, hi lo, lo hi)
// go into one float32 accumulator: float32-accurate work at a third of the
// bf16 rate. The reduction axis is walked as (f group of 8, h, f mod 8),
// h padded to even and f to a multiple of 8 (zeros; 2.6% more products at
// H = 200, F = 39), so that a k16 step is two h of one f group.
// * cin_split_w: a pre-pass splits w once per call into bf16 hi and lo in
//   that order, zero-padded to the ring's 32-slot stages and to the column
//   tile, written as each stage's core matrices (8 columns x 16 bytes), so
//   a stage is one contiguous bulk copy.
// * cin_wgmma<NT>: a block owns a row tile of 64 or 128 rows (b, d) (one
//   or two consumer warpgroups), made of whole examples when D fits (rows
//   (b, d) of EX examples x DS dims, d fastest), by NT = 72 or 200 columns
//   k (wgmma m64nNTk16: at K = 200 one tile builds each z value once;
//   kernel.plan splits the columns when the rows alone would not fill the
//   card). It stages the xk and x0 values of its rows in shared memory
//   (float32, rows of RT + 4 floats), builds z's A fragments straight into
//   registers in wgmma's A layout, split into hi and lo: a lane's two x0
//   values per row stay in registers for H / 2 steps, so a step costs it
//   four shared loads. The three products take B from a ring of w stages
//   that a producer warp keeps filled by bulk copies (TMA) under full/empty
//   mbarriers; a stage's six products run while the next stage's A
//   fragments are built (double-buffered; one wgmma group in flight). The
//   output tile is staged through shared memory (rows of NT + 1 floats) and
//   stored in out's (b, k, d) order, consecutive threads on consecutive
//   addresses. Ragged rows, columns and the padded axis load zeros (staged
//   rows and w padding) and are masked at the store.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

using namespace hopper;

typedef __nv_bfloat16 bf16;

constexpr int kSlots = 32;        // reduction slots p per ring stage (two
                                  // k16 steps)
constexpr int kSplitThreads = 256;
constexpr int kMaxStages = 8;

// Two float32 values as bf16 pairs hi = bf16(x) and lo = bf16(x - hi);
// the first value in the low half (the lower column of a fragment).
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 r = __floats2bfloat162_rn(__fsub_rn(x0, hf.x),
                                                 __fsub_rn(x1, hf.y));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

// D (64 x 72, float32) += A (64 x 16, bf16, registers) B (16 x 72, bf16,
// shared, K-major).
__device__ __forceinline__ void wgmma_rs(float (&d)[36], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35}, "
      "{%36, %37, %38, %39}, %40, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
// D (64 x 200, float32) += A (64 x 16, bf16, registers) B (16 x 200, bf16,
// shared, K-major).
__device__ __forceinline__ void wgmma_rs(float (&d)[100], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %105, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n200k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99}, "
      "{%100, %101, %102, %103}, %104, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Shared memory of cin_wgmma: the w ring at 0 (1024-aligned stages), then
// xk's staged rows [h2][ld] and x0's [f8][ld] (float32); the output tile
// [rows][nt + 1] reuses it from 0 after the products; the ring's full and
// empty barriers last.
struct Layout {
  int ld;
  long long xs, x0s, bars, total;
};
__host__ __device__ __forceinline__ Layout layout(int nt, int rows, int ring,
                                                  int h2, int f8) {
  Layout l;
  l.ld = rows + 4;
  l.xs = static_cast<long long>(ring) * nt * 128;
  l.x0s = l.xs + 4LL * h2 * l.ld;
  const long long in_end = l.x0s + 4LL * f8 * l.ld;
  const long long out_end = 4LL * rows * (nt + 1);
  l.bars = ((in_end > out_end ? in_end : out_end) + 7) / 8 * 8;
  l.total = l.bars + 16LL * ring;
  return l;
}

// w (k, h, f) float32 -> ws, over the padded reduction axis
// p = (fg h2 + h) 8 + e of f = 8 fg + e (fg < f8 / 8, h < h2): for each
// column tile ct and stage s of 32 slots, [hi, lo][k16 step j][8-slot half
// c][column n][8 slots] in bf16, zero past k_n, h_n and f_n. Thread idx =
// ((((ct np + s) 2 + j) 2 + c) nt + n) 8 + e.
__global__ void __launch_bounds__(kSplitThreads)
cin_split_w(const float* __restrict__ w, bf16* __restrict__ ws,
            int64_t total, int k_n, int h_n, int f_n, int h2, int nt,
            int np) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kSplitThreads
      + threadIdx.x;
  if (idx >= total) return;
  const int e = static_cast<int>(idx & 7);
  int64_t r = idx >> 3;
  const int n = static_cast<int>(r % nt);
  r /= nt;
  const int c = static_cast<int>(r & 1);
  r >>= 1;
  const int j = static_cast<int>(r & 1);
  r >>= 1;                                    // r = ct np + s
  const int64_t s = r % np, ct = r / np;
  const int64_t g = s * (kSlots / 8) + j * 2 + c;   // 8-slot group
  const int64_t fg = g / h2;
  const int h = static_cast<int>(g - fg * h2);
  const int64_t f = fg * 8 + e;
  const int64_t col = ct * nt + n;
  const float v = col < k_n && h < h_n && f < f_n
      ? w[(col * h_n + h) * f_n + f] : 0.f;
  const bf16 hi = __float2bfloat16_rn(v);
  const bf16 lo = __float2bfloat16_rn(__fsub_rn(v, __bfloat162float(hi)));
  const int64_t o = r * 64LL * nt + ((j * 2 + c) * nt + n) * 8 + e;
  ws[o] = hi;
  ws[o + 32LL * nt] = lo;
}

// The A fragments of one k16 step, hi and lo: slots 0-7 are (h, f0 .. f0 +
// 7) and slots 8-15 (h + 1, f0 .. f0 + 7), so this lane's slots 2 tig,
// 2 tig + 1 of each half share its x0 pair (ya for row ra, yb for rb, at
// f0 + 2 tig and + 1) and take xk at h and h + 1.
__device__ __forceinline__ void build_a(const float* xs, int ld, int ra,
                                        int rb, int h, const float (&ya)[2],
                                        const float (&yb)[2],
                                        uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
  const float xa0 = xs[h * ld + ra], xb0 = xs[h * ld + rb];
  const float xa1 = xs[(h + 1) * ld + ra], xb1 = xs[(h + 1) * ld + rb];
  split_pair(__fmul_rn(xa0, ya[0]), __fmul_rn(xa0, ya[1]), hi[0], lo[0]);
  split_pair(__fmul_rn(xb0, yb[0]), __fmul_rn(xb0, yb[1]), hi[1], lo[1]);
  split_pair(__fmul_rn(xa1, ya[0]), __fmul_rn(xa1, ya[1]), hi[2], lo[2]);
  split_pair(__fmul_rn(xb1, yb[0]), __fmul_rn(xb1, yb[1]), hi[3], lo[3]);
}

// x0 of this lane's two slots f, f + 1 of a step's halves, rows ra, rb.
__device__ __forceinline__ void load_y(const float* x0s, int ld, int ra,
                                       int rb, int f, float (&ya)[2],
                                       float (&yb)[2]) {
  ya[0] = x0s[f * ld + ra];
  ya[1] = x0s[(f + 1) * ld + ra];
  yb[0] = x0s[f * ld + rb];
  yb[1] = x0s[(f + 1) * ld + rb];
}

// Block: nc consumer warpgroups (rows 64 w .. 64 w + 63 of the tile; warp
// v rows 16 v .. + 15, lane (gid, tig) rows + gid and + gid + 8,
// accumulator registers 4 c + e at column 8 c + 2 tig + (e & 1)) and one
// producer warp. Row r of the tile is (b0 + r / ds, d0 + r % ds). A stage
// holds the B operand of two k16 steps: [hi, lo][step][8-slot half][n][8],
// K-major with LBO nt * 16 and SBO 128. The reduction axis runs over
// (f group, h, f mod 8) with h padded to h2 (even) and f to f8 (a multiple
// of 8), so a step is two h of one f group: a lane's x0 values stay in
// registers for h2 / 2 steps.
template <int NT>
__global__ void __launch_bounds__(288, 1)
cin_wgmma(const float* __restrict__ xk, const float* __restrict__ x0,
          const bf16* __restrict__ ws, float* __restrict__ out, int b_n,
          int h_n, int f_n, int d_n, int k_n, int ex, int ds, int tiles_d,
          int np, int ring, int h2, int f8, int nc) {
  extern __shared__ __align__(1024) unsigned char smem[];
  constexpr uint32_t kStageBytes = NT * 128;
  constexpr int kLdo = NT + 1;
  const int rows = 64 * nc, consumers = 128 * nc;
  const Layout lay = layout(NT, rows, ring, h2, f8);
  float* xs = reinterpret_cast<float*>(smem + lay.xs);
  float* x0s = reinterpret_cast<float*>(smem + lay.x0s);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bars);
  uint64_t* empty = full + ring;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bt = static_cast<int>(blockIdx.x) / tiles_d;
  const int b0 = bt * ex, d0 = (static_cast<int>(blockIdx.x) - bt * tiles_d)
      * ds;
  const int n0 = static_cast<int>(blockIdx.y) * NT;

  if (tid == 0) {
    for (int s = 0; s < ring; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], consumers / 32);  // lane 0 of each consumer warp
    }
    mbar_init_fence();
  }
  async_fence();
  __syncthreads();

  if (warp == consumers / 32) {              // the producer
    if (lane == 0) {
      const unsigned char* src = reinterpret_cast<const unsigned char*>(ws)
          + static_cast<int64_t>(blockIdx.y) * np * kStageBytes;
      for (int s = 0; s < np; ++s) {
        const int stg = s % ring;
        if (s >= ring) mbar_wait(&empty[stg], (s / ring - 1) & 1);
        mbar_expect_tx(&full[stg], kStageBytes);
        bulk_load(smem + stg * kStageBytes,
                  src + static_cast<int64_t>(s) * kStageBytes, kStageBytes,
                  &full[stg]);
      }
    }
    return;
  }

  // xs[h][r] = xk[b, h, d], x0s[f][r] = x0[b, f, d] of row r = (b, d); zero
  // past the live rows, from h_n to h2 and from f_n to f8
  {
    const int r = tid % rows;
    const int e = r / ds, dd = r - e * ds;
    const int b = b0 + e, d = d0 + dd;
    const bool ok = e < ex && b < b_n && d < d_n;
    const float* xkr = xk + (ok ? static_cast<int64_t>(b) * h_n * d_n + d : 0);
    const float* x0r = x0 + (ok ? static_cast<int64_t>(b) * f_n * d_n + d : 0);
    for (int h = tid / rows; h < h2; h += 2)
      xs[h * lay.ld + r] = ok && h < h_n
          ? xkr[static_cast<int64_t>(h) * d_n] : 0.f;
    for (int f = tid / rows; f < f8; f += 2)
      x0s[f * lay.ld + r] = ok && f < f_n
          ? x0r[static_cast<int64_t>(f) * d_n] : 0.f;
  }
  bar_sync(consumers);

  const int gid = lane >> 2, tig = lane & 3;
  const int ra = (warp >> 2) * 64 + (warp & 3) * 16 + gid, rb = ra + 8;
  const int fgs = f8 / 8;
  int h = 0, fg = 0;           // the next step's h and f group (uniform)
  float ya[2], yb[2];
  load_y(x0s, lay.ld, ra, rb, 2 * tig, ya, yb);
  float acc[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) acc[i] = 0.f;
  // A fragments [stage parity][step][register], hi and lo: the next stage's
  // are built while this stage's products run
  uint32_t ah[2][2][4], al[2][2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    build_a(xs, lay.ld, ra, rb, h, ya, yb, ah[0][j], al[0][j]);
    h += 2;
    if (h == h2) {
      h = 0;
      if (++fg < fgs) load_y(x0s, lay.ld, ra, rb, 8 * fg + 2 * tig, ya, yb);
      else ya[0] = ya[1] = yb[0] = yb[1] = 0.f;
    }
  }
  for (int s0 = 0; s0 < np; s0 += 2) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int s = s0 + u;
      if (s < np) {
        const int stg = s % ring;
        mbar_wait(&full[stg], (s / ring) & 1);
        const unsigned char* st = smem + stg * kStageBytes;
        pin(acc);
        pin(ah[u][0]);
        pin(ah[u][1]);
        pin(al[u][0]);
        pin(al[u][1]);
        wg_fence();
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const uint64_t dh = gmma_desc(st + j * NT * 32, NT * 16, 128);
          const uint64_t dl = gmma_desc(st + (2 + j) * NT * 32, NT * 16, 128);
          wgmma_rs(acc, ah[u][j], dh);
          wgmma_rs(acc, ah[u][j], dl);
          wgmma_rs(acc, al[u][j], dh);
        }
        wg_commit();
        // the stage before is done: its A registers and its ring slot free
        wg_wait<1>();
        pin(acc);
        pin(ah[1 - u][0]);
        pin(ah[1 - u][1]);
        pin(al[1 - u][0]);
        pin(al[1 - u][1]);
        if (s > 0) {
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[(s - 1) % ring]);
        }
        if (s + 1 < np) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            build_a(xs, lay.ld, ra, rb, h, ya, yb, ah[1 - u][j],
                    al[1 - u][j]);
            h += 2;
            if (h == h2) {
              h = 0;
              if (++fg < fgs)
                load_y(x0s, lay.ld, ra, rb, 8 * fg + 2 * tig, ya, yb);
              else
                ya[0] = ya[1] = yb[0] = yb[1] = 0.f;
            }
          }
        }
      }
    }
  }
  wg_wait<0>();
  pin(acc);

  // the output tile reuses the ring and the staged rows
  bar_sync(consumers);
  float* os = reinterpret_cast<float*>(smem);      // [rows][kLdo]
#pragma unroll
  for (int c = 0; c < NT / 8; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      os[((e & 2) ? rb : ra) * kLdo + 8 * c + 2 * tig + (e & 1)] =
          acc[4 * c + e];
  bar_sync(consumers);
  // out[b0 + e, n0 + n, d0 + dd] in (e, n, dd) order, dd fastest
  const int ev = min(ex, b_n - b0), dv = min(ds, d_n - d0);
  const int nv = min(NT, k_n - n0);
  const int total = ev * nv * dv;
  const int sd = consumers % dv, sq = consumers / dv;
  const int sn = sq % nv, se = sq / nv;
  int dd = tid % dv, n = (tid / dv) % nv, e = tid / dv / nv;
  for (int idx = tid; idx < total; idx += consumers) {
    out[(static_cast<int64_t>(b0 + e) * k_n + n0 + n) * d_n + d0 + dd] =
        os[(e * ds + dd) * kLdo + n];
    dd += sd;
    const int carry = dd >= dv;
    dd -= carry * dv;
    n += sn + carry;
    if (n >= nv) {
      n -= nv;
      ++e;
    }
    e += se;
  }
}

template <int NT>
int launch(const float* xk, const float* x0, const bf16* ws, float* out,
           int b_n, int h_n, int f_n, int d_n, int k_n, int ex, int ds,
           int tiles_d, long long row_tiles, long long col_tiles, int np,
           int ring, int h2, int f8, int nc, long long smem,
           cudaStream_t stream) {
  cudaError_t e = set_smem(cin_wgmma<NT>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(static_cast<unsigned>(row_tiles), static_cast<unsigned>(col_tiles));
  cin_wgmma<NT><<<grid, 128 * nc + 32, static_cast<size_t>(smem), stream>>>(
      xk, x0, ws, out, b_n, h_n, f_n, d_n, k_n, ex, ds, tiles_d, np, ring, h2,
      f8, nc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// xk: (b, h, d), x0: (b, f, d), w: (k, h, f), out: (b, k, d), all float32;
// ws: bf16 scratch of ceil(k / nt) * ceil(h2 f8 / 32) * nt * 64 elements
// (h2 = h rounded up to 2, f8 = f rounded up to 8). The
// plan (kernels/cin/kernel.py): rows 64 or 128 per block, nt 72 or 200
// columns, ex examples of ds dims per row tile (ex * ds <= rows), ring
// stages. Returns cudaGetLastError() (cudaErrorInvalidValue for a plan or
// shape it refuses).
int cin_layer(const void* xk, const void* x0, const void* w, void* ws,
              void* out, long long b_n, long long h_n, long long f_n,
              long long d_n, long long k_n, long long rows, long long nt,
              long long ex, long long ds, long long ring, void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (b_n <= 0 || k_n <= 0 || d_n <= 0) return 0;
  if (h_n <= 0 || f_n <= 0 || (nt != 72 && nt != 200)
      || (rows != 64 && rows != 128) || ds < 1 || ds > rows || ex < 1
      || ex * ds > rows || ring < 2 || ring > kMaxStages)
    return invalid;
  const long long h2 = (h_n + 1) / 2 * 2, f8 = (f_n + 7) / 8 * 8;
  const long long np = (h2 * f8 + kSlots - 1) / kSlots;
  const long long tiles_d = (d_n + ds - 1) / ds;
  const long long row_tiles = (b_n + ex - 1) / ex * tiles_d;
  const long long col_tiles = (k_n + nt - 1) / nt;
  const long long big = 0x7fffffffLL;
  if (b_n > big || k_n > big || d_n > big || h2 * f8 > big
      || row_tiles > big || col_tiles > 65535)
    return invalid;
  const Layout lay = layout(static_cast<int>(nt), static_cast<int>(rows),
                            static_cast<int>(ring), static_cast<int>(h2),
                            static_cast<int>(f8));
  if (lay.total > kSmemLimit) return invalid;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = col_tiles * np * 4 * nt * 8;
  cin_split_w<<<static_cast<unsigned>((total + kSplitThreads - 1)
                                      / kSplitThreads),
                kSplitThreads, 0, s>>>(
      static_cast<const float*>(w), static_cast<bf16*>(ws), total,
      static_cast<int>(k_n), static_cast<int>(h_n), static_cast<int>(f_n),
      static_cast<int>(h2), static_cast<int>(nt), static_cast<int>(np));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const float* a = static_cast<const float*>(xk);
  const float* b = static_cast<const float*>(x0);
  const bf16* c = static_cast<const bf16*>(ws);
  float* o = static_cast<float*>(out);
  const int nc = static_cast<int>(rows / 64);
  if (nt == 72)
    return launch<72>(a, b, c, o, static_cast<int>(b_n),
                      static_cast<int>(h_n), static_cast<int>(f_n),
                      static_cast<int>(d_n), static_cast<int>(k_n),
                      static_cast<int>(ex), static_cast<int>(ds),
                      static_cast<int>(tiles_d), row_tiles, col_tiles,
                      static_cast<int>(np), static_cast<int>(ring),
                      static_cast<int>(h2), static_cast<int>(f8), nc,
                      lay.total, s);
  return launch<200>(a, b, c, o, static_cast<int>(b_n), static_cast<int>(h_n),
                     static_cast<int>(f_n), static_cast<int>(d_n),
                     static_cast<int>(k_n), static_cast<int>(ex),
                     static_cast<int>(ds), static_cast<int>(tiles_d),
                     row_tiles, col_tiles, static_cast<int>(np),
                     static_cast<int>(ring), static_cast<int>(h2),
                     static_cast<int>(f8), nc, lay.total, s);
}

}  // extern "C"
