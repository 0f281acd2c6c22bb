// The expand join's compatibility predicate: its R x C matrix, and its
// select epilogue, which keeps the first k compatible pairs without the
// matrix.
//
// kg_compat_matrix replaces src/repro/kernels/kg_join/kernel.py,
// compat_matrix_kernel (body _compat_kernel) with its padding in
// src/repro/kernels/kg_join/ops.py (compat_matrix). For every instance i,
// table row r and match c:
//   ok(r, c) = tmask[r] && mmask[c] && for every position pos with
//              kind[pos] == 1: table[r, clip(col[pos], 0, V - 1)] ==
//                              matches[c, pos]
// kind and col are data, so one launch serves every plan of a bucket.
//
// kg_compat_select is what the engine does with that matrix
// (src/repro/engine/batch.py:_join_data): with n = R * C pairs in row-major
// (flat) order it writes keep[r] = any_c ok(r, c), and for the first
// k = min(cap, n) set pairs order[j] = r * C + c, omask[j] = 1;
// total = the number of set pairs; order[j] = n - 1 and omask[j] = 0 for
// total <= j < k: select_cap of the flattened matrix and its .any, bit for
// bit, with no R x C bytes written. On the TPU the matrix is a block in
// VMEM; on the card it would be device memory, written once and read back.
//
// Every launch evaluates ok through eval_words, so the matrix and the
// selection cannot drift apart. A warp takes 32 rows (a tile), one a lane,
// the row's used table values in registers; a block stages a chunk of
// segments of kSeg = 256 columns in shared memory once, with all its
// threads' loads in flight (the used positions' match values, and the mask
// as one bit a column), and each of its warps takes the chunk for its own
// tile. A lane folds 32 neighbouring columns into one 32-bit word, eight
// words a segment: shared loads are broadcasts (every lane reads the same
// column), one compare a used position chained in a predicate and one
// predicated add a pair, instantiated for 0 to 3 used positions, picked per
// instance. kernel.compat_plan sizes the blocks (tiles and segments) so
// that a launch has at least two blocks an SM.
//
// Bound on the H100: the matrix by its bytes (the R x C output). It goes
// through a per-warp transpose in shared memory, so that a lane stores 16
// columns as one 16-byte store (a warp two rows of 256 contiguous bytes)
// where the row's alignment allows, narrower stores at the ragged edge.
// The selection by its operations (the pair tests; it reads the inputs
// once and writes k slots). It takes three launches (two for k = 0, which
// the semijoin asks for):
//  - count: each (row, segment)'s set pairs by __popc, uint16, and where
//    they are one or two their columns (no order between blocks, so the
//    launch is as parallel as the matrix's); it also zeroes the scan's
//    tile status words;
//  - scan: a block per tile, claimed in order from a zeroed counter; it
//    sums its rows' counts, finds the tile's prefix by the decoupled
//    look-back of lookback.cuh, writes keep and each row's first slot, and
//    the last tile of an instance writes total and the tail;
//  - write: a block per (rw tiles, segment); a warp whose tile starts at or
//    past k leaves at once. A row of one or two pairs in the segment
//    writes them from the kept columns (the engine's joins are that
//    sparse); the block stages and evaluates the segment again only for
//    rows of more and, through the transpose, gives each of their pairs
//    its slot by a __popc of the word below it: consecutive slots from
//    consecutive lanes, a dense tile's segments on as many blocks.
// A one-launch route (a tile counting, looking back and writing in one
// block) was tried and dropped: its tiles claimed in order ran in waves
// behind the few that write (PERF.md, section 6).
#include <cuda_runtime.h>
#include <stdint.h>

#include "lookback.cuh"

namespace {

constexpr int kMaxLead = 4;          // leading dims after folding
constexpr int kMaxWarps = 8;         // tiles a block
constexpr int kMaxChunk = 4;         // segments a block stages
constexpr int kWords = 8;            // words a lane per segment
constexpr int kSeg = 32 * kWords;    // columns a segment
constexpr int kMaxSegs = 512;        // c <= 131,072
constexpr int kStride = kWords + 1;  // transpose row stride, odd: no conflict
constexpr int kInputs = 6;           // table, tmask, matches, mmask, kind, col
constexpr int kScanThreads = 128;
// a staged segment: three value rows, then its mask words
constexpr int kSegWords = 3 * kSeg + kWords;
// a warp's transpose buffer (the matrix and write launches)
constexpr int kTileWords = 32 * kStride;

enum Mode { kMatrix, kCount };

// Leading dims of the instances, row-major, with each input's stride per
// dim in its own elements (0 for a broadcast dim).
struct Lead {
  long long nd;
  long long size[kMaxLead];
  long long st[kInputs][kMaxLead];
};

struct Args {
  const int32_t* table;     // (…, r, v)
  const uint8_t* tmask;     // (…, r)
  const int32_t* matches;   // (…, c, 3)
  const uint8_t* mmask;     // (…, c)
  const int32_t* kind;      // (…, 3)
  const int32_t* col;       // (…, 3)
  long long t_r, t_v, tm_r, m_c, m_p, mm_c, k_p, c_p;   // inner strides
  Lead lead;
  uint8_t* out;             // matrix: (I, r, c)
  uint8_t* keep;            // select: (I, r)
  int32_t* order;           // select: (I, k)
  uint8_t* omask;           // select: (I, k)
  int32_t* total;           // select: (I,)
  uint16_t* counts;         // select: (I, nseg, r), each row's count a segment
  uint16_t* pos;            // select: (I, nseg, r), where a count is 1 or 2,
                            // its pairs' columns in the segment (8 bits each)
  int32_t* rowbase;         // select: (I, r), each row's first slot
  unsigned long long* status;   // select: tiles words, then the counter
  long long tiles;          // select: tiles of the launch
  int r, c, v, k;
  int nseg;                 // segments a row
  int tiles_per_inst;       // 32-row tiles an instance
  int rw;                   // tiles (warps) a block
  int sc;                   // segments a block stages
  int rblocks;              // blocks across an instance's tiles
  int chunks;               // blocks across a row's segments
};

// One instance's inputs and its used positions.
struct Inst {
  const int32_t* table;
  const uint8_t* tmask;
  const int32_t* matches;
  const uint8_t* mmask;
  int npos;
  int pos[3];               // the used positions, in order
  int colv[3];              // their table columns, clipped
};

__device__ __forceinline__ Inst instance(const Args& a, long long inst) {
  long long o[kInputs] = {0, 0, 0, 0, 0, 0};
  long long rest = inst;
#pragma unroll
  for (int d = kMaxLead - 1; d >= 0; --d) {
    if (d < a.lead.nd) {
      const long long i = rest % a.lead.size[d];
      rest /= a.lead.size[d];
#pragma unroll
      for (int q = 0; q < kInputs; ++q) o[q] += i * a.lead.st[q][d];
    }
  }
  Inst in;
  in.table = a.table + o[0];
  in.tmask = a.tmask + o[1];
  in.matches = a.matches + o[2];
  in.mmask = a.mmask + o[3];
  // the used positions in order, by selects (no indexing by a runtime
  // count, which would put the struct in local memory)
  const bool u0 = a.kind[o[4]] == 1;
  const bool u1 = a.kind[o[4] + a.k_p] == 1;
  const bool u2 = a.kind[o[4] + 2 * a.k_p] == 1;
  in.npos = static_cast<int>(u0) + static_cast<int>(u1) + static_cast<int>(u2);
  in.pos[0] = u0 ? 0 : (u1 ? 1 : 2);
  in.pos[1] = u0 && u1 ? 1 : 2;
  in.pos[2] = 2;
  int cv[3];
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    const int x = a.col[o[5] + p * a.c_p];
    cv[p] = x < 0 ? 0 : (x > a.v - 1 ? a.v - 1 : x);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i)
    in.colv[i] = in.pos[i] == 0 ? cv[0] : (in.pos[i] == 1 ? cv[1] : cv[2]);
  return in;
}

// Lane l's row r0 + l: live (in range and tmask set) and its used values.
__device__ __forceinline__ bool row_values(const Args& a, const Inst& in,
                                           int r, int (&tv)[3]) {
  const bool in_range = r < a.r;
#pragma unroll
  for (int i = 0; i < 3; ++i)
    tv[i] = in_range && i < in.npos
        ? in.table[r * a.t_r + in.colv[i] * a.t_v] : 0;
  return in_range && in.tmask[r * a.tm_r] != 0;
}

// Stage segments [s0, s0 + nsc) of the instance's columns: the used
// positions' values and the mask bits, four columns a thread in flight.
// Every thread of the block calls it; blockDim.x is a multiple of 32, so a
// warp's 32 columns are in one segment and its ballot packs their bits.
__device__ __forceinline__ void stage_chunk(const Args& a, const Inst& in,
                                            int s0, int nsc, int32_t* stage) {
  const int n = nsc * kSeg;
  const int step = blockDim.x;
  for (int j0 = threadIdx.x; j0 < n; j0 += 4 * step) {
    int32_t v[4][3];
    bool mk[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = j0 + u * step;
      const int c = s0 * kSeg + j;
      const bool ok = j < n && c < a.c;
      mk[u] = ok && in.mmask[c * a.mm_c] != 0;
#pragma unroll
      for (int i = 0; i < 3; ++i)
        v[u][i] = ok && i < in.npos
            ? in.matches[c * a.m_c + in.pos[i] * a.m_p] : 0;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = j0 + u * step;
      if (j < n) {                       // the same for the whole warp
        const int q = j / kSeg;
        const int x = j - q * kSeg;
        int32_t* sv = stage + q * kSegWords;
#pragma unroll
        for (int i = 0; i < 3; ++i)
          if (i < in.npos) sv[i * kSeg + x] = v[u][i];
        const unsigned word = __ballot_sync(kFull, mk[u]);
        if ((threadIdx.x & 31) == 0) sv[3 * kSeg + x / 32] = word;
      }
    }
  }
}

// Element u (a constant once unrolled) of an int4.
__device__ __forceinline__ int part(const int4& x, int u) {
  return u == 0 ? x.x : (u == 1 ? x.y : (u == 2 ? x.z : x.w));
}

// bits |= bit where tv[i] == x[i] for every i < NPOS: one compare a used
// position, chained in a predicate, and one predicated or.
template <int NPOS>
__device__ __forceinline__ void test_pair(uint32_t& bits, const int (&tv)[3],
                                          int x0, int x1, int x2,
                                          uint32_t bit) {
  if (NPOS == 1) {
    asm("{\n\t.reg .pred p;\n\tsetp.eq.s32 p, %1, %2;\n\t"
        "@p or.b32 %0, %0, %3;\n}"
        : "+r"(bits) : "r"(tv[0]), "r"(x0), "r"(bit));
  } else if (NPOS == 2) {
    asm("{\n\t.reg .pred p;\n\tsetp.eq.s32 p, %1, %2;\n\t"
        "setp.eq.and.s32 p, %3, %4, p;\n\t@p or.b32 %0, %0, %5;\n}"
        : "+r"(bits) : "r"(tv[0]), "r"(x0), "r"(tv[1]), "r"(x1), "r"(bit));
  } else {
    asm("{\n\t.reg .pred p;\n\tsetp.eq.s32 p, %1, %2;\n\t"
        "setp.eq.and.s32 p, %3, %4, p;\n\t"
        "setp.eq.and.s32 p, %5, %6, p;\n\t@p or.b32 %0, %0, %7;\n}"
        : "+r"(bits)
        : "r"(tv[0]), "r"(x0), "r"(tv[1]), "r"(x1), "r"(tv[2]), "r"(x2),
          "r"(bit));
  }
}

// The lane's row against a staged segment: w[m] bit j = ok(row, column
// 32 m + j of the segment).
template <int NPOS>
__device__ __forceinline__ void eval_words(const int32_t* sv,
                                           const uint32_t* smask,
                                           const int (&tv)[3], bool live,
                                           uint32_t (&w)[kWords]) {
#pragma unroll
  for (int m = 0; m < kWords; ++m) {
    uint32_t bits = NPOS == 0 ? 0xffffffffu : 0u;
    if (NPOS > 0) {
#pragma unroll
      for (int j = 0; j < 32; j += 4) {
        int4 x[3];
#pragma unroll
        for (int i = 0; i < NPOS; ++i)
          x[i] = *reinterpret_cast<const int4*>(sv + i * kSeg + 32 * m + j);
#pragma unroll
        for (int u = 0; u < 4; ++u)
          test_pair<NPOS>(bits, tv, part(x[0], u),
                          NPOS > 1 ? part(x[NPOS > 1 ? 1 : 0], u) : 0,
                          NPOS > 2 ? part(x[NPOS > 2 ? 2 : 0], u) : 0,
                          1u << (j + u));
      }
    }
    w[m] = live ? bits & smask[m] : 0u;
  }
}

__device__ __forceinline__ void eval_any(int npos, const int32_t* sv,
                                         const uint32_t* smask,
                                         const int (&tv)[3], bool live,
                                         uint32_t (&w)[kWords]) {
  switch (npos) {
    case 0: eval_words<0>(sv, smask, tv, live, w); break;
    case 1: eval_words<1>(sv, smask, tv, live, w); break;
    case 2: eval_words<2>(sv, smask, tv, live, w); break;
    default: eval_words<3>(sv, smask, tv, live, w); break;
  }
}

// Bits 0-3 of x as the bytes 0/1 of a word (little-endian: bit q -> byte q).
__device__ __forceinline__ uint32_t expand4(uint32_t x) {
  return ((x & 0xfu) * 0x00204081u) & 0x01010101u;
}

// Columns [c, c + n) of a row from the 16 bits h, n <= 16.
__device__ __forceinline__ void store16(uint8_t* dst, uint32_t h, int n) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(dst);
  if (n == 16 && (at & 15) == 0) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(
        expand4(h), expand4(h >> 4), expand4(h >> 8), expand4(h >> 12));
  } else if (n == 16 && (at & 3) == 0) {
    uint32_t* d4 = reinterpret_cast<uint32_t*>(dst);
#pragma unroll
    for (int q = 0; q < 4; ++q) d4[q] = expand4(h >> (4 * q));
  } else {
    for (int q = 0; q < n; ++q) dst[q] = static_cast<uint8_t>((h >> q) & 1u);
  }
}

// The set bits of a segment's words (flat index first + 32 m + lane) to
// the slots from base on while below k: lane j writes the pair of bit j.
__device__ __forceinline__ void write_pairs(const uint32_t (&word)[kWords],
                                            long long first, int base, int k,
                                            int32_t* order, uint8_t* omask) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int m = 0; m < kWords; ++m) {
    const int slot = base + __popc(word[m] & below);
    if (((word[m] >> lane) & 1u) && slot < k) {
      order[slot] = static_cast<int32_t>(first + 32 * m + lane);
      omask[slot] = 1;
    }
    base += __popc(word[m]);
  }
}

// The matrix and count launches: a block per (instance, rw tiles, chunk of
// sc segments), a warp a tile. The count launch keeps each (row, segment)'s
// count and, where it is 1 or 2, the pairs' columns.
template <int kMode>
__global__ void __launch_bounds__(kMaxWarps * 32)
compat_tiles(Args a) {
  extern __shared__ int4 smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long blk = blockIdx.x;
  const int chunk = static_cast<int>(blk % a.chunks);
  const long long rest = blk / a.chunks;
  const long long inst = rest / a.rblocks;
  const int local = static_cast<int>(rest % a.rblocks) * a.rw + warp;
  const int s0 = chunk * a.sc;
  const int nsc = a.nseg - s0 < a.sc ? a.nseg - s0 : a.sc;
  const int r0 = local * 32;
  const int r = r0 + lane;
  const bool tile = local < a.tiles_per_inst;
  if (kMode == kCount) {
    // the scan launch's status words and counter start at 0 (the grid has
    // more threads than instances x tiles + 1)
    const long long g = blk * blockDim.x + threadIdx.x;
    if (g <= a.tiles) a.status[g] = 0;
  }
  const Inst in = instance(a, inst);
  int32_t* stage = reinterpret_cast<int32_t*>(smem);
  uint32_t* tbuf = reinterpret_cast<uint32_t*>(stage + a.sc * kSegWords)
      + warp * kTileWords;
  stage_chunk(a, in, s0, nsc, stage);
  __syncthreads();
  if (!tile) return;                       // after the block's one barrier
  int tv[3];
  const bool live = row_values(a, in, r, tv);
  for (int q = 0; q < nsc; ++q) {
    const int s = s0 + q;
    const int32_t* sv = stage + q * kSegWords;
    uint32_t w[kWords];
    eval_any(in.npos, sv, reinterpret_cast<const uint32_t*>(sv + 3 * kSeg),
             tv, live, w);
    if (kMode == kCount) {
      int c = 0;
#pragma unroll
      for (int m = 0; m < kWords; ++m) c += __popc(w[m]);
      if (r < a.r) {
        const long long at = (inst * a.nseg + s) * a.r + r;
        a.counts[at] = static_cast<uint16_t>(c);
        if (c <= 2) {                      // the one or two columns
          unsigned p = 0;
          int found = 0;
#pragma unroll
          for (int m = 0; m < kWords; ++m) {
            for (unsigned x = w[m]; x != 0; x &= x - 1, ++found)
              p |= static_cast<unsigned>(32 * m + __ffs(x) - 1) << (8 * found);
          }
          a.pos[at] = static_cast<uint16_t>(p);
        }
      }
      continue;
    }
    __syncwarp();
#pragma unroll
    for (int m = 0; m < kWords; ++m) tbuf[lane * kStride + m] = w[m];
    __syncwarp();
    // store i: lanes 0-15 row 2 i, lanes 16-31 row 2 i + 1, 16 columns a
    // lane
    const int half = lane >> 4;
    const int piece = lane & 15;
    const int c = s * kSeg + 16 * piece;
    const int n = a.c - c < 16 ? a.c - c : 16;
#pragma unroll 4
    for (int i = 0; i < 16; ++i) {
      const int row = 2 * i + half;
      const int rr = r0 + row;
      if (rr < a.r && n > 0) {
        const uint32_t word = tbuf[row * kStride + (piece >> 1)];
        store16(a.out + (inst * a.r + rr) * static_cast<long long>(a.c) + c,
                (word >> (16 * (piece & 1))) & 0xffffu, n);
      }
    }
  }
}

// The write launch: a block per (instance, rw tiles, segment s), a warp a
// tile. A warp whose tile starts at or past k leaves; otherwise lane = row
// finds the row's first slot in the segment (its first slot in the tile
// plus its counts in the segments before s). A row of one or two pairs
// writes them from the columns the count launch kept; the block stages and
// evaluates the segment again only for rows of more.
__global__ void __launch_bounds__(kMaxWarps * 32)
compat_write_tiles(Args a) {
  extern __shared__ int4 smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long blk = blockIdx.x;
  const int s = static_cast<int>(blk % a.nseg);
  const long long rest = blk / a.nseg;
  const long long inst = rest / a.rblocks;
  const int local = static_cast<int>(rest % a.rblocks) * a.rw + warp;
  const int r0 = local * 32;
  const int r = r0 + lane;
  const int k = a.k;
  int base = k, cnt = 0;
  if (local < a.tiles_per_inst && a.rowbase[inst * a.r + r0] < k
      && r < a.r) {
    const uint16_t* counts = a.counts + inst * a.nseg * a.r + r;
    base = a.rowbase[inst * a.r + r];
    int before = 0;
#pragma unroll 8
    for (int q = 0; q < s; ++q) before += counts[q * a.r];
    base += before;
    cnt = counts[s * a.r];
  }
  int32_t* order = a.order + inst * k;
  uint8_t* omask = a.omask + inst * k;
  const long long first = static_cast<long long>(r) * a.c
      + static_cast<long long>(s) * kSeg;
  if (cnt > 0 && cnt <= 2 && base < k) {
    const unsigned p = a.pos[(inst * a.nseg + s) * a.r + r];
    order[base] = static_cast<int32_t>(first + (p & 255u));
    omask[base] = 1;
    if (cnt == 2 && base + 1 < k) {
      order[base + 1] = static_cast<int32_t>(first + (p >> 8));
      omask[base + 1] = 1;
    }
  }
  const bool big = cnt > 2 && base < k;
  if (!__syncthreads_or(big)) return;
  const Inst in = instance(a, inst);
  int32_t* stage = reinterpret_cast<int32_t*>(smem);
  uint32_t* tbuf = reinterpret_cast<uint32_t*>(stage + kSegWords)
      + warp * kTileWords;
  stage_chunk(a, in, s, 1, stage);
  __syncthreads();
  const unsigned rows = __ballot_sync(kFull, big);
  if (rows == 0) return;                   // after the block's last barrier
  int tv[3];
  const bool live = row_values(a, in, r, tv);
  uint32_t w[kWords];
  eval_any(in.npos, stage, reinterpret_cast<const uint32_t*>(stage + 3 * kSeg),
           tv, live, w);
#pragma unroll
  for (int m = 0; m < kWords; ++m) tbuf[lane * kStride + m] = w[m];
  __syncwarp();
  for (unsigned left = rows; left != 0; left &= left - 1) {
    const int row = __ffs(left) - 1;
    uint32_t word[kWords];
#pragma unroll
    for (int m = 0; m < kWords; ++m) word[m] = tbuf[row * kStride + m];
    write_pairs(word, __shfl_sync(kFull, first, row),
                __shfl_sync(kFull, base, row), k, order, omask);
  }
}

// order[j] = last and omask[j] = 0 for j in [from, k), by the block in
// 16-byte stores where the rows align (as kg_join.cu's select epilogue).
__device__ void fill_tail(int32_t* order, uint8_t* omask, int from, int k,
                          int32_t last) {
  if (from >= k) return;
  const int t = threadIdx.x, step = blockDim.x;
  int head = static_cast<int>(
      ((16 - (reinterpret_cast<uintptr_t>(order + from) & 15)) & 15) / 4);
  head = min(head, k - from);
  const int body = (k - from - head) / 4;
  for (int j = from + t; j < from + head; j += step) order[j] = last;
  int4* o4 = reinterpret_cast<int4*>(order + from + head);
  for (int q = t; q < body; q += step) o4[q] = make_int4(last, last, last, last);
  for (int j = from + head + 4 * body + t; j < k; j += step) order[j] = last;
  head = static_cast<int>(
      (16 - (reinterpret_cast<uintptr_t>(omask + from) & 15)) & 15);
  head = min(head, k - from);
  const int body16 = (k - from - head) / 16;
  for (int j = from + t; j < from + head; j += step) omask[j] = 0;
  uint4* m16 = reinterpret_cast<uint4*>(omask + from + head);
  for (int q = t; q < body16; q += step) m16[q] = make_uint4(0, 0, 0, 0);
  for (int j = from + head + 16 * body16 + t; j < k; j += step) omask[j] = 0;
}

// The scan launch: one tile a block, claimed in order. Warp 0 sums each
// row's counts (lane = row), looks back for the tile's prefix, and writes
// keep and each row's first slot; the instance's last tile writes total
// and, with every thread, the tail.
__global__ void __launch_bounds__(kScanThreads)
compat_scan_tiles(Args a) {
  __shared__ unsigned long long s_tile;
  __shared__ int s_total;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) s_tile = atomicAdd(a.status + a.tiles, 1ull);
  __syncthreads();
  const long long tile = s_tile;
  const long long inst = tile / a.tiles_per_inst;
  const int local = static_cast<int>(tile - inst * a.tiles_per_inst);
  if (threadIdx.x < 32) {
    const int r = local * 32 + lane;
    int rc = 0;
    if (r < a.r) {
      const uint16_t* counts = a.counts + inst * a.nseg * a.r + r;
#pragma unroll 8
      for (int q = 0; q < a.nseg; ++q) rc += counts[q * a.r];
      a.keep[inst * a.r + r] = rc > 0 ? 1 : 0;
    }
    int x = rc;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, x, d);
      if (lane >= d) x += y;
    }
    const int aggregate = __shfl_sync(kFull, x, 31);
    const int prefix = look_back(a.status, tile, local, aggregate);
    if (r < a.r) a.rowbase[inst * a.r + r] = prefix + x - rc;
    if (lane == 0) s_total = prefix + aggregate;
  }
  __syncthreads();
  if (local == a.tiles_per_inst - 1) {        // the instance's last tile
    const int tot = s_total;
    if (threadIdx.x == 0) a.total[inst] = tot;
    fill_tail(a.order + inst * a.k, a.omask + inst * a.k, tot, a.k,
              static_cast<int32_t>(static_cast<long long>(a.r) * a.c - 1));
  }
}

// Raise kernel K's dynamic shared-memory limit on the current device to
// what a launch needs: a host call made once for each larger size.
template <void (*K)(Args)>
cudaError_t allow_smem(long long bytes) {
  static long long allowed[64] = {};
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && bytes <= allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(K, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && dev < 64) allowed[dev] = bytes;
  return err;
}

// lead: nd, sizes, each input's strides (kMaxLead each), then the inner
// strides: table's row and column, tmask's, matches' row and position,
// mmask's, kind's and col's.
bool fill_args(Args& a, const void* table, const void* tmask,
               const void* matches, const void* mmask, const void* kind,
               const void* col, const long long* lead, long long instances,
               long long r, long long c, long long v, long long rw,
               long long sc) {
  if (table == nullptr || tmask == nullptr || matches == nullptr
      || mmask == nullptr || kind == nullptr || col == nullptr || r < 1
      || r > 0x7fffffffLL || c < 1 || c > static_cast<long long>(kMaxSegs)
      * kSeg || v < 1 || v > 0x7fffffffLL || rw < 1 || rw > kMaxWarps
      || sc < 1 || sc > kMaxChunk
      || lead[0] < 0 || lead[0] > kMaxLead)
    return false;
  a.table = static_cast<const int32_t*>(table);
  a.tmask = static_cast<const uint8_t*>(tmask);
  a.matches = static_cast<const int32_t*>(matches);
  a.mmask = static_cast<const uint8_t*>(mmask);
  a.kind = static_cast<const int32_t*>(kind);
  a.col = static_cast<const int32_t*>(col);
  a.lead.nd = lead[0];
  long long count = 1;
  for (int d = 0; d < kMaxLead; ++d) {
    a.lead.size[d] = lead[1 + d];
    for (int q = 0; q < kInputs; ++q)
      a.lead.st[q][d] = lead[1 + (1 + q) * kMaxLead + d];
    if (d < a.lead.nd) count *= a.lead.size[d];
  }
  if (count != instances) return false;
  const long long* inner = lead + 1 + (1 + kInputs) * kMaxLead;
  a.t_r = inner[0];
  a.t_v = inner[1];
  a.tm_r = inner[2];
  a.m_c = inner[3];
  a.m_p = inner[4];
  a.mm_c = inner[5];
  a.k_p = inner[6];
  a.c_p = inner[7];
  a.r = static_cast<int>(r);
  a.c = static_cast<int>(c);
  a.v = static_cast<int>(v);
  a.nseg = static_cast<int>((c + kSeg - 1) / kSeg);
  a.tiles_per_inst = static_cast<int>((r + 31) / 32);
  a.rw = static_cast<int>(rw);
  a.sc = static_cast<int>(sc);
  a.rblocks = (a.tiles_per_inst + a.rw - 1) / a.rw;
  a.chunks = (a.nseg + a.sc - 1) / a.sc;
  return true;
}

// A matrix or count launch: a block per (instance, rw tiles, chunk of sc
// segments).
template <int kMode>
cudaError_t launch_tiles(const Args& a, long long instances,
                         cudaStream_t st) {
  const long long blocks =
      instances * static_cast<long long>(a.rblocks) * a.chunks;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const long long bytes = (static_cast<long long>(a.sc) * kSegWords
      + (kMode == kCount ? 0 : static_cast<long long>(a.rw) * kTileWords)) * 4;
  const cudaError_t ok = allow_smem<compat_tiles<kMode>>(bytes);
  if (ok != cudaSuccess) return ok;
  compat_tiles<kMode><<<static_cast<unsigned>(blocks),
                        static_cast<unsigned>(a.rw * 32),
                        static_cast<size_t>(bytes), st>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The matrix: out (instances, r, c) uint8. rw tiles (of 32 rows) and sc
// segments (of 256 columns) a block, as kernel.compat_plan gives them.
// Returns cudaGetLastError() after the launch (0 = launched).
int kg_compat_matrix(const void* table, const void* tmask, const void* matches,
                     const void* mmask, const void* kind, const void* col,
                     const long long* lead, void* out, long long instances,
                     long long r, long long c, long long v, long long rw,
                     long long sc, void* stream) {
  if (instances <= 0) return 0;
  Args a = {};
  if (!fill_args(a, table, tmask, matches, mmask, kind, col, lead, instances,
                 r, c, v, rw, sc)
      || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  a.out = static_cast<uint8_t*>(out);
  return static_cast<int>(launch_tiles<kMatrix>(
      a, instances, static_cast<cudaStream_t>(stream)));
}

// The select epilogue: keep (instances, r) uint8, order (instances, k)
// int32, omask (instances, k) uint8, total (instances,) int32 for
// k <= r * c < 2^31. counts holds 2 * instances * segments * r uint16
// (the counts, then the columns of counts of 1 or 2), rowbase
// instances * r int32, status instances * ceil(r / 32) + 1 words (zeroed
// by the count launch). The count, scan and write launches, the last only
// for k > 0. Returns cudaGetLastError() after the launches.
int kg_compat_select(const void* table, const void* tmask, const void* matches,
                     const void* mmask, const void* kind, const void* col,
                     const long long* lead, void* keep, void* order,
                     void* omask, void* total, void* counts, void* rowbase,
                     void* status, long long instances, long long r,
                     long long c, long long v, long long k, long long rw,
                     long long sc, void* stream) {
  if (instances <= 0) return 0;
  Args a = {};
  if (!fill_args(a, table, tmask, matches, mmask, kind, col, lead, instances,
                 r, c, v, rw, sc)
      || r * c > 0x7fffffffLL || k < 0 || k > r * c || keep == nullptr
      || total == nullptr || counts == nullptr || rowbase == nullptr
      || status == nullptr
      || (k > 0 && (order == nullptr || omask == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  a.keep = static_cast<uint8_t*>(keep);
  a.order = static_cast<int32_t*>(order);
  a.omask = static_cast<uint8_t*>(omask);
  a.total = static_cast<int32_t*>(total);
  a.counts = static_cast<uint16_t*>(counts);
  a.pos = a.counts + instances * a.nseg * r;
  a.rowbase = static_cast<int32_t*>(rowbase);
  a.status = static_cast<unsigned long long*>(status);
  a.k = static_cast<int>(k);
  a.tiles = instances * a.tiles_per_inst;
  if (a.tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long writes =
      instances * static_cast<long long>(a.rblocks) * a.nseg;
  if (writes > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = launch_tiles<kCount>(a, instances, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  compat_scan_tiles<<<static_cast<unsigned>(a.tiles), kScanThreads, 0, st>>>(
      a);
  err = cudaGetLastError();
  if (err != cudaSuccess || k == 0) return static_cast<int>(err);
  const long long bytes =
      (kSegWords + static_cast<long long>(a.rw) * kTileWords) * 4;
  compat_write_tiles<<<static_cast<unsigned>(writes),
                       static_cast<unsigned>(a.rw * 32),
                       static_cast<size_t>(bytes), st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
