// Merge-join candidate ranges and their select epilogue.
//
// kg_join_ranges replaces src/repro/kernels/kg_join/kernel.py,
// join_ranges_kernel (body _ranges_kernel) with its padding in
// src/repro/kernels/kg_join/ops.py (join_ranges). For every instance i,
// key block b and table-row key r:
//   lo[i, b, r] = #{c : keys[i, b, c] <  rkey[i, r]}
//   hi[i, b, r] = #{c : keys[i, b, c] <= rkey[i, r]}
// keys are sorted per block (invalid entries INT_MAX-padded) and rkey <
// INT_MAX: integer-identical to searchsorted left and right. The TPU kernel
// counts by comparing whole tiles because gathers are slow there; here the
// counts are two searches in a tree of the block's keys in shared memory.
// With a mask, the second output is counts = tmask ? hi - lo : 0.
//
// kg_join_select is the merge join's expansion after the searches, which
// the JAX engine builds as a mask and compacts
// (src/repro/engine/batch.py:_join_merge, pair_ok then _select_cap, i.e.
// src/repro/engine/primitives.py select_cap). With K the fan-out cap and
// n = R * S_b * K pair slots laid out (row, block, slot), slot (r, b, w) is
// set iff w < min(counts[i, b, r], K). It writes lo, counts, and for the
// first k set slots of each instance order[i, j] = r * S_b * K + b * K + w,
// omask[i, j] = 1; total[i] = the number of set slots; order[i, j] = n - 1
// and omask[i, j] = 0 for total <= j < k: select_cap bit for bit, with no
// mask. A tile of rows sums its clipped counts in (row, block) order, finds
// the count before it by the decoupled look-back of lookback.cuh, and
// writes only its own slots.
//
// Bound on the H100: bytes (keys and row keys read once, lo and counts
// written once, the k selected slots), but a search is a chain of dependent
// loads, so the design is about shared memory:
//  - The tree. Level d of a key block of c keys (levels = bit length of c)
//    holds the keys at sorted positions p with p + 1 = (2 j + 1) <<
//    (levels - 1 - d), j = 0, 1, ...; positions past c are INT_MAX and not
//    stored. Shared memory keeps the levels one after another (the
//    Eytzinger order, cut to the c real keys), each closed by one INT_MAX
//    word that a node past the real ones reads (node min(j, count)), so the
//    first five levels of a warp's searches read at most 32 consecutive
//    words (no bank conflict) and the deeper ones scattered words (a few
//    ways), where a plain sorted array puts every probe of the first nine
//    levels into one bank. A search descends j -> 2 j + (key < row key):
//    branch-free, one load a level, a trip count fixed by c, and j at the
//    bottom is the count. The hi search shares lo's path (row key + 1
//    folded into the compare, <=) and loads only below the node where it
//    leaves it; a warp skips the load where no lane has left, so rows
//    whose key is absent load once. What remains binds the kernel: the
//    deep levels' scattered words, a few bank ways each.
//  - Staging. A block stages its key block once (16-byte loads, four in
//    flight a thread; 64 KB at 16,384 keys), through 32-bit shared-window
//    addresses, and searches a tile of row keys, eight a thread at a time.
//    Above the shared-memory budget only the top levels stay there (every
//    2^s-th key) and the last s levels read device memory, a window of 2^s
//    keys. kernel.plan picks s, the threads and the tiles.
//  - Broadcast reads: each leading dim comes with its stride per input, so
//    an expanded dim (stride 0) is read in place.
//  - The select epilogue is a second launch, after a search launch that
//    writes lo and the counts. A select tile loads its rows' clipped
//    counts of every key block into shared memory. Each warp owns a
//    contiguous run of the tile's (row, block) entries, 32 at a time: a
//    shuffle scan gives each entry its first slot, and the warp writes the
//    group's slots 32 consecutive ones a store, each lane finding its
//    entry by a binary search over the lanes' prefixes. The tile holding
//    the instance's total writes the tail of the cap in 16-byte stores.
//
// The expand join's compatibility matrix and its select epilogue are in
// kg_compat.cu.
#include <cuda_runtime.h>
#include <stdint.h>

#include "lookback.cuh"

namespace {

constexpr int kMaxLead = 4;          // leading dims after folding
constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxLevels = 32;       // c < 2^31
constexpr int kIlp = 8;              // row keys a thread searches at once
constexpr int32_t kIntMax = 0x7fffffff;

// Leading dims of the instances, row-major, with each input's stride per
// dim in its own elements (0 for a broadcast dim).
struct Lead {
  long long nd;
  long long size[kMaxLead];
  long long keys[kMaxLead];
  long long rkey[kMaxLead];
  long long tmask[kMaxLead];
};

struct Args {
  const int32_t* keys;      // (…, sb, c): block stride kb, c contiguous
  const int32_t* rkey;      // (…, r), r contiguous
  const uint8_t* tmask;     // (…, r) or NULL
  int32_t* lo;              // (I, sb, r)
  int32_t* hi;              // (I, sb, r): hi, or counts with tmask
  int32_t* counts;          // (I, sb, r), select
  int32_t* order;           // (I, k), select
  uint8_t* omask;           // (I, k), select
  int32_t* total;           // (I,), select
  unsigned long long* status;   // select: tiles words, then the counter
  Lead lead;
  long long kb;             // keys' block stride
  long long tiles;          // select: tiles of the launch
  int sb, c, r;
  int fan;                  // K, select
  int k;                    // selected slots per instance, select
  int levels;               // bit length of c
  int smem_levels;          // levels kept in shared memory: levels - shift
  int shift;                // staged keys: every 2^shift-th
  int rows_per_thread, tile_rows, tiles_per_inst;
};

struct Offsets {
  long long keys, rkey, tmask;
};

__device__ __forceinline__ Offsets lead_offsets(const Lead& lead,
                                                long long inst) {
  Offsets o{0, 0, 0};
  long long rest = inst;
#pragma unroll
  for (int d = kMaxLead - 1; d >= 0; --d) {
    if (d < lead.nd) {
      const long long i = rest % lead.size[d];
      rest /= lead.size[d];
      o.keys += i * lead.keys[d];
      o.rkey += i * lead.rkey[d];
      o.tmask += i * lead.tmask[d];
    }
  }
  return o;
}

// Shared memory through 32-bit shared-window addresses: a generic pointer
// makes the compiler rebuild the window's base before every access.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ int32_t lds(unsigned addr) {
  int32_t v;
  asm volatile("ld.shared.b32 %0, [%1];" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

// v = the word at addr where pred holds; v is kept where it does not.
__device__ __forceinline__ void lds_if(int32_t& v, unsigned addr, bool pred) {
  asm volatile("{\n\t.reg .pred p;\n\tsetp.ne.u32 p, %2, 0;\n\t"
               "@p ld.shared.b32 %0, [%1];\n}"
               : "+r"(v) : "r"(addr), "r"(static_cast<unsigned>(pred))
               : "memory");
}

__device__ __forceinline__ int32_t ldg_or(const int32_t* p, bool pred,
                                          int32_t fallback) {
  int32_t v = fallback;
  asm volatile("{\n\t.reg .pred p;\n\tsetp.ne.u32 p, %2, 0;\n\t"
               "@p ld.global.nc.b32 %0, [%1];\n}"
               : "+r"(v) : "l"(p), "r"(static_cast<unsigned>(pred)));
  return v;
}

__device__ __forceinline__ void sts(unsigned addr, int32_t v) {
  asm volatile("st.shared.b32 [%0], %1;" :: "r"(addr), "r"(v) : "memory");
}

// Real nodes on the level whose positions are (2 j + 1) << sh, less 1.
__device__ __forceinline__ unsigned level_count(int c, int sh) {
  return static_cast<unsigned>(((c >> sh) + 1) >> 1);
}

// s_off[d]: where level d starts in shared memory (in words), for d <
// smem_levels. A level holds its real nodes, then INT_MAX: a search reads
// node min(j, count), so a node past the real ones reads INT_MAX with no
// test. Warp 0 computes the offsets and writes the sentinels; the caller
// syncs.
__device__ __forceinline__ void level_offsets(const Args& a, unsigned tree,
                                              int* s_off) {
  if (threadIdx.x < 32) {
    const int d = threadIdx.x;
    const bool in_smem = d < a.smem_levels;
    const int n = in_smem
        ? static_cast<int>(level_count(a.c, a.levels - 1 - d)) + 1 : 0;
    int x = n;
#pragma unroll
    for (int e = 1; e < 32; e <<= 1) {
      const int y = __shfl_up_sync(kFull, x, e);
      if (d >= e) x += y;
    }
    s_off[d] = x - n;
    if (in_smem) sts(tree + 4u * (x - 1), kIntMax);
  }
}

// Key p (sorted position) to its tree slot: level levels - 1 - tz, index
// (p + 1) >> (tz + 1), tz the trailing zeros of p + 1.
__device__ __forceinline__ void place(unsigned tree, unsigned off_table,
                                      int levels, unsigned p, int32_t v) {
  const unsigned q = p + 1;
  const int tz = __ffs(q) - 1;
  const int off = lds(off_table + 4u * (levels - 1 - tz));
  sts(tree + 4u * (off + (q >> (tz + 1))), v);
}

// Stage the key block g (c keys) into its tree's shared-memory levels: all
// of it, or every 2^shift-th key; four loads in flight a thread. The
// caller syncs before and after.
__device__ void stage(const Args& a, const int32_t* g, unsigned tree,
                      unsigned off_table) {
  const int step = blockDim.x;
  if (a.shift == 0 && (a.c & 3) == 0
      && (reinterpret_cast<uintptr_t>(g) & 15) == 0) {
    const int4* g4 = reinterpret_cast<const int4*>(g);
    const int n4 = a.c >> 2;
    for (int q0 = threadIdx.x; q0 < n4; q0 += 4 * step) {
      int4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (q0 + u * step < n4) v[u] = __ldg(g4 + q0 + u * step);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int q = q0 + u * step;
        if (q < n4) {
          place(tree, off_table, a.levels, 4u * q + 0, v[u].x);
          place(tree, off_table, a.levels, 4u * q + 1, v[u].y);
          place(tree, off_table, a.levels, 4u * q + 2, v[u].z);
          place(tree, off_table, a.levels, 4u * q + 3, v[u].w);
        }
      }
    }
  } else {
    const int staged = a.c >> a.shift;
    for (int m0 = threadIdx.x + 1; m0 <= staged; m0 += 4 * step) {
      int32_t v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int m = m0 + u * step;
        v[u] = ldg_or(g + ((static_cast<long long>(m) << a.shift) - 1),
                      m <= staged, 0);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int m = m0 + u * step;
        if (m <= staged)
          place(tree, off_table, a.levels,
                (static_cast<unsigned>(m) << a.shift) - 1, v[u]);
      }
    }
  }
}

// lo[n] = #{keys < key[n]}, hi[n] = #{keys <= key[n]} in the tree over the
// key block g (top smem_levels levels at tree, the rest read from g). The
// hi search loads only where its node differs from lo's, and a warp skips
// the load where no lane's does. Every lane of the warp calls it.
__device__ __forceinline__ void search(const Args& a, unsigned tree,
                                       const int32_t* g,
                                       const int32_t (&key)[kIlp],
                                       int32_t (&lo)[kIlp],
                                       int32_t (&hi)[kIlp]) {
  unsigned jl[kIlp], jh[kIlp];
  int32_t vl[kIlp], vh[kIlp];
#pragma unroll
  for (int n = 0; n < kIlp; ++n) {
    jl[n] = jh[n] = 0;
    vh[n] = 0;
  }
  unsigned level = tree;                  // the level's first word
  int d = 0;
  for (; d < a.smem_levels; ++d) {
    const unsigned cnt = level_count(a.c, a.levels - 1 - d);
#pragma unroll
    for (int n = 0; n < kIlp; ++n)
      vl[n] = lds(level + 4u * min(jl[n], cnt));
    bool split = false;                   // a hi search has left lo's path
#pragma unroll
    for (int n = 0; n < kIlp; ++n) split |= jh[n] != jl[n];
    if (__any_sync(kFull, split)) {
#pragma unroll
      for (int n = 0; n < kIlp; ++n)
        lds_if(vh[n], level + 4u * min(jh[n], cnt), jh[n] != jl[n]);
    }
    level += 4u * (cnt + 1);
#pragma unroll
    for (int n = 0; n < kIlp; ++n) {
      if (jh[n] == jl[n]) vh[n] = vl[n];       // the same node
      jl[n] = 2 * jl[n] + (vl[n] < key[n] ? 1u : 0u);
      jh[n] = 2 * jh[n] + (vh[n] <= key[n] ? 1u : 0u);
    }
  }
  for (; d < a.levels; ++d) {             // the splitter route's last levels
    const int sh = a.levels - 1 - d;
    const unsigned cnt = level_count(a.c, sh);
#pragma unroll
    for (int n = 0; n < kIlp; ++n)
      vl[n] = ldg_or(g + (((2ull * jl[n] + 1) << sh) - 1), jl[n] < cnt,
                     kIntMax);
#pragma unroll
    for (int n = 0; n < kIlp; ++n)
      vh[n] = ldg_or(g + (((2ull * jh[n] + 1) << sh) - 1),
                     jh[n] != jl[n] && jh[n] < cnt, kIntMax);
#pragma unroll
    for (int n = 0; n < kIlp; ++n) {
      if (jh[n] == jl[n]) vh[n] = vl[n];
      jl[n] = 2 * jl[n] + (vl[n] < key[n] ? 1u : 0u);
      jh[n] = 2 * jh[n] + (vh[n] <= key[n] ? 1u : 0u);
    }
  }
  const unsigned c = static_cast<unsigned>(a.c);
#pragma unroll
  for (int n = 0; n < kIlp; ++n) {
    lo[n] = static_cast<int32_t>(jl[n] < c ? jl[n] : c);
    hi[n] = static_cast<int32_t>(jh[n] < c ? jh[n] : c);
  }
}

// One block: key block b of one instance against a tile of tile_rows row
// keys; thread t takes rows t + blockDim.x * q, q < rows_per_thread.
__global__ void __launch_bounds__(kMaxThreads) search_tiles(Args a) {
  extern __shared__ int4 smem[];
  __shared__ int s_off[kMaxLevels];
  const unsigned tree = smem_addr(smem);
  const int tile = blockIdx.x % a.tiles_per_inst;
  const long long row = blockIdx.x / a.tiles_per_inst;   // inst * sb + b
  const long long inst = row / a.sb;
  const long long b = row - inst * a.sb;
  const Offsets o = lead_offsets(a.lead, inst);
  const int32_t* g = a.keys + o.keys + b * a.kb;
  const int32_t* rkey = a.rkey + o.rkey;
  level_offsets(a, tree, s_off);
  __syncthreads();
  stage(a, g, tree, smem_addr(s_off));
  __syncthreads();
  const int r0 = tile * a.tile_rows + threadIdx.x;
  const int warp0 = tile * a.tile_rows + (threadIdx.x & ~31);
  for (int q0 = 0; q0 < a.rows_per_thread; q0 += kIlp) {
    // warp-uniform: search's votes need every lane
    if (warp0 + static_cast<int>(blockDim.x) * q0 >= a.r) break;
    int rr[kIlp];
    int32_t key[kIlp], lo[kIlp], hi[kIlp];
#pragma unroll
    for (int n = 0; n < kIlp; ++n) {
      rr[n] = r0 + blockDim.x * (q0 + n);
      const bool live = q0 + n < a.rows_per_thread && rr[n] < a.r;
      key[n] = live ? __ldg(rkey + rr[n]) : 0;
      if (!live) rr[n] = -1;
    }
    search(a, tree, g, key, lo, hi);
#pragma unroll
    for (int n = 0; n < kIlp; ++n) {
      if (rr[n] < 0) continue;
      const long long at = row * a.r + rr[n];
      a.lo[at] = lo[n];
      a.hi[at] = a.tmask == nullptr ? hi[n]
          : (a.tmask[o.tmask + rr[n]] != 0 ? hi[n] - lo[n] : 0);
    }
  }
}

// order[j] = last and omask[j] = 0 for j in [from, k), by the block in
// 16-byte stores where the rows align (the tail is most of the cap where
// few pairs join).
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

// The select epilogue over tiles of tile_rows rows, claimed in order, from
// the counts a search launch wrote.
__global__ void __launch_bounds__(kMaxThreads) select_tiles(Args a) {
  extern __shared__ int4 smem[];
  // the tile's clipped counts, entry e = row * sb + block
  const unsigned s_cnt = smem_addr(smem);
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
  const int local = static_cast<int>(tile - inst * a.tiles_per_inst);
  const int r0 = local * a.tile_rows;
  const int sb = a.sb;
  const int fan = a.fan;
  const int entries = a.tile_rows * sb;

  // a thread's rows_per_thread counts of each block, kIlp loads in flight
  for (int b = 0; b < sb; ++b) {
    const int32_t* counts = a.counts + (inst * sb + b) * a.r + r0;
    for (int q0 = 0; q0 < a.rows_per_thread; q0 += kIlp) {
      int cnt[kIlp];
#pragma unroll
      for (int n = 0; n < kIlp; ++n) {
        const int rl = threadIdx.x + blockDim.x * (q0 + n);
        cnt[n] = q0 + n < a.rows_per_thread && r0 + rl < a.r
            ? __ldg(counts + rl) : 0;
      }
#pragma unroll
      for (int n = 0; n < kIlp; ++n) {
        const int rl = threadIdx.x + blockDim.x * (q0 + n);
        if (q0 + n < a.rows_per_thread)
          sts(s_cnt + 4u * (rl * sb + b), cnt[n] < fan ? cnt[n] : fan);
      }
    }
  }
  __syncthreads();

  // warp w owns entries [w * seg, (w + 1) * seg), a multiple of 32
  const int seg = entries / n_warps;
  const int first = warp * seg;
  int sum = 0;
  for (int e = first + lane; e < first + seg; e += 32)
    sum += lds(s_cnt + 4u * e);
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) sum += __shfl_xor_sync(kFull, sum, d);
  if (lane == 0) s_warp[warp] = sum;
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

  // the warp's slots: entry e's run starts at its group's carry plus the
  // counts of the lanes below it
  const int k = a.k;
  int32_t* order = a.order + inst * k;
  uint8_t* omask = a.omask + inst * k;
  const long long value0 = static_cast<long long>(r0) * sb;
  int carry = s_prefix + s_warp[warp];
  for (int g0 = first; g0 < first + seg && carry < k; g0 += 32) {
    const int v = lds(s_cnt + 4u * (g0 + lane));
    int incl = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += y;
    }
    const int excl = incl - v;
    const int group = __shfl_sync(kFull, incl, 31);
    const int end = group < k - carry ? group : k - carry;
    for (int x0 = 0; x0 < end; x0 += 32) {
      const int x = x0 + lane;
      // the lane whose run holds slot x: the number of lanes with incl <= x
      int src = 0;
#pragma unroll
      for (int step = 16; step > 0; step >>= 1) {
        const int t = __shfl_sync(kFull, incl, src + step - 1);
        if (t <= x) src += step;
      }
      const int start = __shfl_sync(kFull, excl, src);
      if (x < end) {
        order[carry + x] = static_cast<int32_t>(
            (value0 + g0 + src) * fan + (x - start));
        omask[carry + x] = 1;
      }
    }
    carry += group;
  }
  if (local == a.tiles_per_inst - 1) {      // the instance's last tile
    const int tot = s_total;
    if (threadIdx.x == 0) a.total[inst] = tot;
    fill_tail(order, omask, tot, k,
              static_cast<int32_t>(static_cast<long long>(a.r) * sb * fan - 1));
  }
}

}  // namespace

namespace {

bool fill_args(Args& a, const void* keys, const void* rkey,
               const void* tmask, const long long* lead, long long instances,
               long long sb, long long c, long long r, long long kb,
               long long threads, long long rows_per_thread,
               long long shift) {
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0
      || rows_per_thread < 1 || rows_per_thread > 64 || sb < 1
      || sb > 65535 || c < 0 || c > 0x7fffffffLL || r < 1
      || r > 0x7fffffffLL || shift < 0
      || shift > 31 || (c >> shift) > (1LL << 20) || lead[0] < 0
      || lead[0] > kMaxLead || (keys == nullptr && c > 0) || rkey == nullptr)
    return false;
  a.keys = static_cast<const int32_t*>(keys);
  a.rkey = static_cast<const int32_t*>(rkey);
  a.tmask = static_cast<const uint8_t*>(tmask);
  a.lead.nd = lead[0];
  long long count = 1;
  for (int d = 0; d < kMaxLead; ++d) {
    a.lead.size[d] = lead[1 + d];
    a.lead.keys[d] = lead[1 + kMaxLead + d];
    a.lead.rkey[d] = lead[1 + 2 * kMaxLead + d];
    a.lead.tmask[d] = lead[1 + 3 * kMaxLead + d];
    if (d < a.lead.nd) count *= a.lead.size[d];
  }
  if (count != instances) return false;
  a.kb = kb;
  a.sb = static_cast<int>(sb);
  a.c = static_cast<int>(c);
  a.r = static_cast<int>(r);
  int levels = 0;
  while (levels < 31 && (c >> levels) != 0) ++levels;
  a.levels = levels;
  a.shift = static_cast<int>(shift);
  a.smem_levels = levels > a.shift ? levels - a.shift : 0;
  a.rows_per_thread = static_cast<int>(rows_per_thread);
  a.tile_rows = static_cast<int>(threads * rows_per_thread);
  a.tiles_per_inst = static_cast<int>((r + a.tile_rows - 1) / a.tile_rows);
  return true;
}

// The tree's shared-memory bytes, 16-byte aligned: the staged keys and a
// sentinel a level.
long long tree_bytes(const Args& a) {
  return (((static_cast<long long>(a.c) >> a.shift) + a.smem_levels) * 4
          + 15) / 16 * 16;
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

// search_tiles over instances x sb key blocks x row tiles.
cudaError_t launch_search(Args a, long long instances, long long threads,
                          cudaStream_t st) {
  const long long blocks = instances * a.sb * a.tiles_per_inst;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const long long bytes = tree_bytes(a);
  const cudaError_t ok = allow_smem<search_tiles>(bytes);
  if (ok != cudaSuccess) return ok;
  search_tiles<<<static_cast<unsigned>(blocks), static_cast<unsigned>(threads),
                 static_cast<size_t>(bytes), st>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// lead: nd, then size, keys, rkey and tmask strides (kMaxLead each, tmask's
// unread here), in elements. keys (…, sb, c) int32 with block stride kb,
// rkey (…, r) int32; lo and hi (instances, sb, r) int32. A block stages the
// tree of one key block (every 2^shift-th key) and searches threads *
// rows_per_thread row keys. Returns cudaGetLastError() after the launch
// (0 = launched).
int kg_join_ranges(const void* keys, const void* rkey, const long long* lead,
                   void* lo, void* hi, long long instances, long long sb,
                   long long c, long long r, long long kb, long long threads,
                   long long rows_per_thread, long long shift, void* stream) {
  if (instances <= 0 || r <= 0) return 0;
  Args a = {};
  if (!fill_args(a, keys, rkey, nullptr, lead, instances, sb, c, r, kb,
                 threads, rows_per_thread, shift)
      || lo == nullptr || hi == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  a.lo = static_cast<int32_t*>(lo);
  a.hi = static_cast<int32_t*>(hi);
  return static_cast<int>(launch_search(a, instances, threads,
                                        static_cast<cudaStream_t>(stream)));
}

// The select epilogue: lo and counts (instances, sb, r) int32, order
// (instances, k) int32, omask (instances, k) uint8, total (instances,)
// int32 for the fan-out cap fan, k <= r * sb * fan < 2^31. status holds
// instances * tiles per instance + 1 words (zeroed here). Two launches: a
// search launch writing lo and counts (search_rows_per_thread sets its
// tiles), then the select launch. Returns cudaGetLastError() after the
// launches.
int kg_join_select(const void* keys, const void* rkey, const void* tmask,
                   const long long* lead, void* lo, void* counts, void* order,
                   void* omask, void* total, void* status,
                   long long instances, long long sb, long long c,
                   long long r, long long kb, long long fan, long long k,
                   long long threads, long long rows_per_thread,
                   long long search_rows_per_thread, long long shift,
                   void* stream) {
  if (instances <= 0) return 0;
  Args a = {};
  if (!fill_args(a, keys, rkey, tmask, lead, instances, sb, c, r, kb,
                 threads, rows_per_thread, shift)
      || tmask == nullptr || fan < 1 || r * sb * fan > 0x7fffffffLL
      || search_rows_per_thread < 1 || search_rows_per_thread > 64
      || k < 0 || k > r * sb * fan || lo == nullptr || counts == nullptr
      || total == nullptr || status == nullptr
      || (k > 0 && (order == nullptr || omask == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  a.lo = static_cast<int32_t*>(lo);
  a.counts = static_cast<int32_t*>(counts);
  a.order = static_cast<int32_t*>(order);
  a.omask = static_cast<uint8_t*>(omask);
  a.total = static_cast<int32_t*>(total);
  a.status = static_cast<unsigned long long*>(status);
  a.fan = static_cast<int>(fan);
  a.k = static_cast<int>(k);
  a.tiles = instances * a.tiles_per_inst;
  if (a.tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args s = a;
  s.hi = a.counts;
  s.rows_per_thread = static_cast<int>(search_rows_per_thread);
  s.tile_rows = static_cast<int>(threads * search_rows_per_thread);
  s.tiles_per_inst = static_cast<int>((r + s.tile_rows - 1) / s.tile_rows);
  const cudaError_t searched = launch_search(s, instances, threads, st);
  if (searched != cudaSuccess) return static_cast<int>(searched);
  const cudaError_t zeroed = cudaMemsetAsync(
      status, 0, (a.tiles + 1) * sizeof(unsigned long long), st);
  if (zeroed != cudaSuccess) return static_cast<int>(zeroed);
  const long long bytes = static_cast<long long>(a.tile_rows) * sb * 4;
  const cudaError_t ok = allow_smem<select_tiles>(bytes);
  if (ok != cudaSuccess) return static_cast<int>(ok);
  select_tiles<<<static_cast<unsigned>(a.tiles), static_cast<unsigned>(threads),
                 static_cast<size_t>(bytes), st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
