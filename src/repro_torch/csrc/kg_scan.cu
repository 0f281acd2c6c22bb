// One-pass masked triple-pattern scan (decoupled look-back) with two
// epilogues: the inclusive int32 hit count, or the stable compaction.
//
// Replaces: src/repro/kernels/kg_scan/kernel.py, scan_hits_kernel (body
// _scan_kernel) and the block stitching of src/repro/kernels/kg_scan/ops.py
// (scan_hits). The select epilogue also takes the place of the compaction
// that consumes that prefix sum, src/repro/engine/primitives.py
// select_from_cum / select_cap (cumsum, then a search for 1..k).
//
// Computes, for every instance i (a (request, shard) pair of the batched
// engine) and every row n of its block:
//   hit[i, n] = valid[i, n] && pattern(spo[i], eq[i]) matches triples[i, n]
//   cum[i, n] = hit[i, 0] + ... + hit[i, n]        (int32, inclusive)
// spo holds term ids, -1 = wildcard, -2 = never-match; eq gates the
// intra-pattern equalities over the position pairs (0,1), (0,2), (1,2).
// With triples == NULL the predicate is the mask itself (hit = valid).
// hit is written wherever its pointer is given (it needs the triples).
// Epilogue "cum" writes cum; with cum NULL there is no epilogue: the
// block writes hit and ends, with no count and no look-back. Epilogue
// "select" writes, for k <= n, idx[i, r - 1] = n for the
// set row of rank r <= k, total[i] = cum[i, n - 1], idx[i, j] = n - 1 for
// total <= j < k and sel[i, j] = j < total: select_from_cum(cum, k) bit
// for bit, with no cum.
//
// Bound on the H100: bytes. A row is read once (1 byte of valid, 12 of
// triples) and its outputs written once (1 byte of hit, 4 of cum; the
// select epilogue writes only the k selected positions), with a handful of
// integer operations. The design:
//  - One pass. A block claims its tile from a global counter (zeroed with
//    the status words by cudaMemsetAsync before each launch), so tiles are
//    taken in order and a block waits only on tiles that running blocks
//    hold: progress under any schedule and occupancy. It publishes its
//    tile's count at once, then warp 0 looks back over its predecessors
//    32 at a time, within its instance (tiles are numbered instance-major
//    and an instance's first tile publishes its inclusive prefix at once),
//    and publishes the tile's inclusive prefix. Flag and value travel as
//    one 64-bit word, stored with st.release.gpu and read with
//    ld.acquire.gpu (lookback.cuh, shared with kg_join.cu's select).
//  - Many rows a thread: a warp owns V segments of 512 consecutive rows,
//    and in each a lane owns 16 consecutive rows, read with one 16-byte
//    load of the mask (coalesced across the warp). The in-tile scan is
//    popcounts, warp shuffles and one shared-memory pass over the warps.
//    A block's loads are in flight only until its look-back, so large
//    instances take large tiles (up to 65,536 rows; kernel.plan picks V;
//    V 16 spills registers). Integer adds are exact: the result is the
//    same bit for bit whatever the tile.
//  - Coalesced writes: cum is written 32 consecutive rows a warp store,
//    each lane taking its row's owner's prefix and bits by shuffle; hit as
//    one 16-byte store a lane; the selection at its ranks.
//  - Broadcast reads: each leading dim comes with its stride per input, so
//    an expanded dim (stride 0) is read in place.
#include <cuda_runtime.h>
#include <stdint.h>

#include "lookback.cuh"

namespace {

constexpr int kMaxLead = 4;          // leading dims after folding
constexpr int kSegRows = 512;        // a warp's 32 lanes x 16 rows
constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;

// Leading dims of the instances, row-major, with each input's stride per
// dim in its own elements (0 for a broadcast dim).
struct Lead {
  long long nd;
  long long size[kMaxLead];
  long long valid[kMaxLead];
  long long triples[kMaxLead];
  long long spo[kMaxLead];
  long long eq[kMaxLead];
};

struct Args {
  const int32_t* triples;   // rows (…, n, 3), or NULL
  const uint8_t* valid;     // (…, n)
  const int32_t* spo;       // (…, 3), with triples
  const uint8_t* eq;        // (…, 3) or NULL
  uint8_t* hit;             // (I, n) or NULL
  int32_t* cum;             // (I, n), epilogue "cum" (k < 0)
  int32_t* idx;             // (I, k), epilogue "select" (k >= 0)
  uint8_t* sel;             // (I, k), epilogue "select"
  int32_t* total;           // (I,), epilogue "select"
  unsigned long long* status;   // tiles words, then the tile counter
  Lead lead;
  long long n, k, tiles_per_inst, tiles;
};

// One bit per byte of a 4-byte word: bit b set iff byte b is not 0.
__device__ __forceinline__ unsigned nonzero_bytes(unsigned x) {
  return ((x & 0xffu) != 0) | (((x & 0xff00u) != 0) << 1)
       | (((x & 0xff0000u) != 0) << 2) | (((x >> 24) != 0) << 3);
}

// Four bits to four 0/1 bytes.
__device__ __forceinline__ unsigned bytes_of(unsigned b) {
  return (b & 1u) | ((b & 2u) << 7) | ((b & 4u) << 14) | ((b & 8u) << 21);
}

// The pattern's verdict on one triple (the row's mask bit aside).
struct Pattern {
  int32_t s, p, o;
  bool never, e01, e02, e12;
  __device__ __forceinline__ bool operator()(int32_t t0, int32_t t1,
                                             int32_t t2) const {
    return !never && (s == -1 || t0 == s) && (p == -1 || t1 == p)
        && (o == -1 || t2 == o) && (!e01 || t0 == t1)
        && (!e02 || t0 == t2) && (!e12 || t1 == t2);
  }
};

// The exclusive sum of c over the lanes below this one; adds the warp's
// sum of c to run.
__device__ __forceinline__ int lane_prefix(int c, int lane, int& run) {
  int x = c;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  run += __shfl_sync(kFull, x, 31);
  return x - c;
}

// A block of blockDim.x threads scans one tile of blockDim.x * 16 * V
// rows: warp w owns rows [w * 512 V, (w + 1) * 512 V) of the tile, as V
// segments of 512; lane l owns rows 16 l .. 16 l + 15 of each segment.
template <int V>
__global__ void __launch_bounds__(kMaxThreads, 2) scan_tiles(Args a) {
  __shared__ unsigned long long s_tile;
  __shared__ int s_warp[kMaxWarps];
  __shared__ int s_prefix, s_total;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  if (threadIdx.x == 0) s_tile = atomicAdd(a.status + a.tiles, 1ull);
  __syncthreads();
  const long long tile = s_tile;
  const long long inst = tile / a.tiles_per_inst;
  const long long local = tile - inst * a.tiles_per_inst;

  long long ov = 0, ot = 0, os = 0, oe = 0;
  long long rest = inst;
#pragma unroll
  for (int d = kMaxLead - 1; d >= 0; --d) {
    if (d < a.lead.nd) {
      const long long i = rest % a.lead.size[d];
      rest /= a.lead.size[d];
      ov += i * a.lead.valid[d];
      ot += i * a.lead.triples[d];
      os += i * a.lead.spo[d];
      oe += i * a.lead.eq[d];
    }
  }
  const uint8_t* valid = a.valid + ov;
  const long long n = a.n;
  const long long first_row =
      (local * blockDim.x + warp * 32) * (16LL * V);   // the warp's rows

  // bits[v]: the hits of this lane's 16 rows of segment v (bit j = row j)
  unsigned bits[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const long long seg = first_row + v * kSegRows;
    const long long row0 = seg + 16 * lane;
    if (seg + kSegRows <= n
        && (reinterpret_cast<uintptr_t>(valid + seg) & 15) == 0) {
      const uint4 m = __ldg(reinterpret_cast<const uint4*>(valid + row0));
      bits[v] = nonzero_bytes(m.x) | (nonzero_bytes(m.y) << 4)
              | (nonzero_bytes(m.z) << 8) | (nonzero_bytes(m.w) << 12);
    } else {
      unsigned b = 0;
      for (int j = 0; j < 16; ++j)
        if (row0 + j < n && valid[row0 + j] != 0) b |= 1u << j;
      bits[v] = b;
    }
  }

  if (a.triples != nullptr) {
    Pattern pat;
    pat.s = a.spo[os + 0];
    pat.p = a.spo[os + 1];
    pat.o = a.spo[os + 2];
    pat.never = pat.s == -2 || pat.p == -2 || pat.o == -2;
    pat.e01 = pat.e02 = pat.e12 = false;
    if (a.eq != nullptr) {
      pat.e01 = a.eq[oe + 0] != 0;
      pat.e02 = a.eq[oe + 1] != 0;
      pat.e12 = a.eq[oe + 2] != 0;
    }
    const int32_t* rows = a.triples + ot;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const long long row0 = first_row + v * kSegRows + 16 * lane;
      // four rows (12 ints) at a time; rows whose mask bit is 0 are not read
      for (int g = 0; g < 4; ++g) {
        const unsigned live = (bits[v] >> (4 * g)) & 15u;
        if (live == 0) continue;
        const int32_t* t = rows + 3 * (row0 + 4 * g);
        int32_t x[12];
        if ((reinterpret_cast<uintptr_t>(t) & 15) == 0 && live == 15u) {
          const int4 q0 = __ldg(reinterpret_cast<const int4*>(t));
          const int4 q1 = __ldg(reinterpret_cast<const int4*>(t) + 1);
          const int4 q2 = __ldg(reinterpret_cast<const int4*>(t) + 2);
          x[0] = q0.x; x[1] = q0.y; x[2] = q0.z; x[3] = q0.w;
          x[4] = q1.x; x[5] = q1.y; x[6] = q1.z; x[7] = q1.w;
          x[8] = q2.x; x[9] = q2.y; x[10] = q2.z; x[11] = q2.w;
        } else {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const bool on = (live >> r) & 1u;
            x[3 * r + 0] = on ? t[3 * r + 0] : 0;
            x[3 * r + 1] = on ? t[3 * r + 1] : 0;
            x[3 * r + 2] = on ? t[3 * r + 2] : 0;
          }
        }
        unsigned keep = 0;
#pragma unroll
        for (int r = 0; r < 4; ++r)
          keep |= static_cast<unsigned>(
              pat(x[3 * r], x[3 * r + 1], x[3 * r + 2])) << r;
        bits[v] &= ~((live & ~keep) << (4 * g));
      }
    }
    if (a.hit != nullptr) {
      uint8_t* hit = a.hit + inst * n;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const long long seg = first_row + v * kSegRows;
        const long long row0 = seg + 16 * lane;
        if (seg + kSegRows <= n
            && (reinterpret_cast<uintptr_t>(hit + seg) & 15) == 0) {
          uint4 out;
          out.x = bytes_of(bits[v] & 15u);
          out.y = bytes_of((bits[v] >> 4) & 15u);
          out.z = bytes_of((bits[v] >> 8) & 15u);
          out.w = bytes_of((bits[v] >> 12) & 15u);
          *reinterpret_cast<uint4*>(hit + row0) = out;
        } else {
          for (int j = 0; j < 16; ++j)
            if (row0 + j < n) hit[row0 + j] = (bits[v] >> j) & 1u;
        }
      }
    }
  }
  if (a.k < 0 && a.cum == nullptr) return;   // hit only: no count needed

  int count = 0;
#pragma unroll
  for (int v = 0; v < V; ++v) count += __popc(bits[v]);
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) count += __shfl_xor_sync(kFull, count, d);

  // the tile's count, each warp's count before it, the tile's prefix
  if (lane == 0) s_warp[warp] = count;
  __syncthreads();
  if (warp == 0) {
    const int c = lane < n_warps ? s_warp[lane] : 0;
    int x = c;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, x, d);
      if (lane >= d) x += y;
    }
    const int aggregate = __shfl_sync(kFull, x, 31);
    if (lane < n_warps) s_warp[lane] = x - c;
    const int prefix = look_back(a.status, tile, local, aggregate);
    if (lane == 0) {
      s_prefix = prefix;
      s_total = prefix + aggregate;
    }
  }
  __syncthreads();
  // the hits before this lane's rows of each segment, segment by segment
  // (kept out of registers across the look-back)
  int before = s_prefix + s_warp[warp];

  if (a.k < 0) {
    // 32 consecutive rows a store: row 32 q + l of a segment belongs to
    // lane 2 q + l / 16, bit l % 16
    int32_t* cum = a.cum + inst * n;
    const unsigned le = (2u << (lane & 15)) - 1u;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const long long seg = first_row + v * kSegRows;
      if (seg >= n) break;
      int mine = before;    // the count before this lane's 16 rows
      mine += lane_prefix(__popc(bits[v]), lane, before);
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const int src = 2 * q + (lane >> 4);
        const int e = __shfl_sync(kFull, mine, src);
        const unsigned b = __shfl_sync(kFull, bits[v], src);
        const long long row = seg + 32 * q + lane;
        if (row < n) cum[row] = e + __popc(b & le);
      }
    }
    return;
  }

  // select: the set row of rank r <= k goes to idx[r - 1]
  int32_t* idx = a.idx + inst * a.k;
  uint8_t* sel = a.sel + inst * a.k;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    if (before >= a.k) break;
    int r = before;         // the rank of this lane's first hit, less 1
    r += lane_prefix(__popc(bits[v]), lane, before);
    unsigned b = bits[v];
    const long long row0 = first_row + v * kSegRows + 16 * lane;
    while (b != 0 && r < a.k) {
      const int j = __ffs(b) - 1;
      b &= b - 1;
      idx[r] = static_cast<int>(row0 + j);
      sel[r] = 1;
      ++r;
    }
  }
  if (local == a.tiles_per_inst - 1) {   // the instance's last tile
    const int tot = s_total;
    if (threadIdx.x == 0) a.total[inst] = tot;
    for (long long j = tot + threadIdx.x; j < a.k; j += blockDim.x) {
      idx[j] = static_cast<int>(n - 1);
      sel[j] = 0;
    }
  }
}

}  // namespace

extern "C" {

// lead: nd, then size, valid, triples, spo and eq strides (kMaxLead each).
// The epilogue: cum for k < 0 (none when cum is NULL: hit only), else idx,
// sel and total (k <= n); hit is written when given. A tile holds
// threads * 16 * vecs rows (vecs 1, 2, 4 or 8); status holds instances *
// tiles per instance + 1 words. Returns cudaGetLastError() after the
// launch (0 = launched).
int kg_scan(const void* triples, const void* valid, const void* spo,
            const void* eq, const long long* lead, void* hit, void* cum,
            void* idx, void* sel, void* total, long long k, void* status,
            long long instances, long long n, long long threads,
            long long vecs, void* stream) {
  if (instances <= 0 || n <= 0) return 0;
  if (instances > 65535 || n >= (1LL << 31) || threads < 32
      || threads > kMaxThreads || threads % 32 != 0
      || (vecs != 1 && vecs != 2 && vecs != 4 && vecs != 8)
      || (k < 0 && cum == nullptr && hit == nullptr) || k > n
      || (hit != nullptr && triples == nullptr)
      || (k >= 0 && (total == nullptr
                     || (k > 0 && (idx == nullptr || sel == nullptr))))
      || (triples != nullptr && spo == nullptr)
      || lead[0] < 0 || lead[0] > kMaxLead)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.triples = static_cast<const int32_t*>(triples);
  a.valid = static_cast<const uint8_t*>(valid);
  a.spo = static_cast<const int32_t*>(spo);
  a.eq = static_cast<const uint8_t*>(eq);
  a.hit = static_cast<uint8_t*>(hit);
  a.cum = static_cast<int32_t*>(cum);
  a.idx = static_cast<int32_t*>(idx);
  a.sel = static_cast<uint8_t*>(sel);
  a.total = static_cast<int32_t*>(total);
  a.status = static_cast<unsigned long long*>(status);
  a.lead.nd = lead[0];
  long long count = 1;
  for (int d = 0; d < kMaxLead; ++d) {
    a.lead.size[d] = lead[1 + d];
    a.lead.valid[d] = lead[1 + kMaxLead + d];
    a.lead.triples[d] = lead[1 + 2 * kMaxLead + d];
    a.lead.spo[d] = lead[1 + 3 * kMaxLead + d];
    a.lead.eq[d] = lead[1 + 4 * kMaxLead + d];
    if (d < a.lead.nd) count *= a.lead.size[d];
  }
  if (count != instances) return static_cast<int>(cudaErrorInvalidValue);
  const long long tile_rows = threads * 16 * vecs;
  a.n = n;
  a.k = k;
  a.tiles_per_inst = (n + tile_rows - 1) / tile_rows;
  a.tiles = instances * a.tiles_per_inst;
  if (a.tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t zeroed = cudaMemsetAsync(
      status, 0, (a.tiles + 1) * sizeof(unsigned long long), st);
  if (zeroed != cudaSuccess) return static_cast<int>(zeroed);
  const dim3 grid(static_cast<unsigned>(a.tiles));
  const dim3 block(static_cast<unsigned>(threads));
  switch (vecs) {
    case 1: scan_tiles<1><<<grid, block, 0, st>>>(a); break;
    case 2: scan_tiles<2><<<grid, block, 0, st>>>(a); break;
    case 4: scan_tiles<4><<<grid, block, 0, st>>>(a); break;
    default: scan_tiles<8><<<grid, block, 0, st>>>(a); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
