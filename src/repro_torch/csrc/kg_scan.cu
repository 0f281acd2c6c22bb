// Fused masked triple-pattern scan with its int32 hit-count prefix sum.
//
// Replaces: src/repro/kernels/kg_scan/kernel.py, scan_hits_kernel (body
// _scan_kernel) and the block stitching of src/repro/kernels/kg_scan/ops.py
// (scan_hits).
//
// Computes, for every instance i (a (request, shard) pair of the batched
// engine) and every row n of its block:
//   hit[i, n] = valid[i, n] && pattern(spo[i], eq[i]) matches triples[i, n]
//   cum[i, n] = hit[i, 0] + ... + hit[i, n]        (int32, inclusive)
// spo holds term ids, -1 = wildcard, -2 = never-match; eq gates the
// intra-pattern equalities over the position pairs (0,1), (0,2), (1,2).
// With triples == NULL the predicate is the mask itself (hit = valid): the
// engine's stable compactions take their prefix sums through this form.
//
// Bound on the H100: bytes. A row costs 13 bytes read (12 of triples, 1 of
// valid) and 5 written (hit, cum) and a handful of integer operations, far
// below the card's operation rate. The design reads each row once with
// neighbouring threads on neighbouring rows, keeps the hit mask in
// registers between the predicate and the scan, and carries nothing across
// blocks (blocks run in no order): pass 1 scans each 1024-row tile in one
// block (warp shuffles, then one shared-memory pass over the 32 warp sums)
// and writes the tile total; pass 2 turns the tile totals of each instance
// into exclusive offsets; pass 3 adds them. int32 additions are exact and
// associative, so cum equals a sequential cumulative sum bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 1024;   // rows per block in passes 1 and 3

// Inclusive scan of one int per thread across the block (blockDim.x is a
// multiple of 32, at most 1024). wsum needs 32 ints of shared memory.
__device__ __forceinline__ int block_inclusive_scan(int x, int* wsum) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < n_warps ? wsum[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += y;
    }
    wsum[lane] = w;
  }
  __syncthreads();
  if (warp > 0) x += wsum[warp - 1];
  __syncthreads();   // wsum may be reused by the caller's next scan
  return x;
}

// Pass 1: grid (tiles, instances), kTile threads.
__global__ void scan_tiles(const int32_t* __restrict__ triples,
                           const uint8_t* __restrict__ valid,
                           const int32_t* __restrict__ spo,
                           const uint8_t* __restrict__ eq,
                           uint8_t* __restrict__ hit,
                           int32_t* __restrict__ cum,
                           int32_t* __restrict__ tile_sum,
                           int64_t n, int64_t tiles) {
  __shared__ int wsum[32];
  const int64_t inst = blockIdx.y;
  const int64_t tile = blockIdx.x;
  const int64_t row = tile * kTile + threadIdx.x;
  const int64_t at = inst * n + row;
  int h = 0;
  if (row < n) {
    bool v = valid[at] != 0;
    if (triples != nullptr) {
      const int32_t t0 = triples[at * 3 + 0];
      const int32_t t1 = triples[at * 3 + 1];
      const int32_t t2 = triples[at * 3 + 2];
      const int32_t s = spo[inst * 3 + 0];
      const int32_t p = spo[inst * 3 + 1];
      const int32_t o = spo[inst * 3 + 2];
      v = v && (s == -1 || t0 == s) && (p == -1 || t1 == p)
            && (o == -1 || t2 == o) && s != -2 && p != -2 && o != -2;
      if (eq != nullptr) {
        v = v && (!eq[inst * 3 + 0] || t0 == t1)
              && (!eq[inst * 3 + 1] || t0 == t2)
              && (!eq[inst * 3 + 2] || t1 == t2);
      }
      hit[at] = v ? 1 : 0;
    }
    h = v ? 1 : 0;
  }
  const int x = block_inclusive_scan(h, wsum);
  if (row < n) cum[at] = x;
  if (threadIdx.x == kTile - 1) tile_sum[inst * tiles + tile] = x;
}

// Pass 2: one block per instance turns its tile sums into exclusive
// offsets, in place, 1024 tiles at a time with a running carry.
__global__ void scan_tile_offsets(int32_t* __restrict__ tile_sum,
                                  int64_t tiles) {
  __shared__ int wsum[32];
  __shared__ int chunk_total;
  int32_t* ts = tile_sum + static_cast<int64_t>(blockIdx.x) * tiles;
  int carry = 0;
  for (int64_t start = 0; start < tiles; start += blockDim.x) {
    const int64_t i = start + threadIdx.x;
    const int v = i < tiles ? ts[i] : 0;
    const int x = block_inclusive_scan(v, wsum);
    if (i < tiles) ts[i] = carry + x - v;
    if (threadIdx.x == blockDim.x - 1) chunk_total = x;
    __syncthreads();
    carry += chunk_total;
    __syncthreads();
  }
}

// Pass 3: grid (tiles - 1, instances); tile 0 needs no offset.
__global__ void add_tile_offsets(int32_t* __restrict__ cum,
                                 const int32_t* __restrict__ tile_off,
                                 int64_t n, int64_t tiles) {
  const int64_t inst = blockIdx.y;
  const int64_t tile = blockIdx.x + 1;
  const int64_t row = tile * kTile + threadIdx.x;
  if (row < n) cum[inst * n + row] += tile_off[inst * tiles + tile];
}

}  // namespace

extern "C" {

// Scratch: tile_sum holds instances * tiles int32, tiles = ceil(n / 1024).
// Returns cudaGetLastError() after the launches (0 = launched).
int kg_scan_hits(const void* triples, const void* valid, const void* spo,
                 const void* eq, void* hit, void* cum, void* tile_sum,
                 long long instances, long long n, void* stream) {
  if (instances <= 0 || n <= 0) return 0;
  if (instances > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t tiles = (n + kTile - 1) / kTile;
  dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(instances));
  scan_tiles<<<grid, kTile, 0, st>>>(
      static_cast<const int32_t*>(triples), static_cast<const uint8_t*>(valid),
      static_cast<const int32_t*>(spo), static_cast<const uint8_t*>(eq),
      static_cast<uint8_t*>(hit), static_cast<int32_t*>(cum),
      static_cast<int32_t*>(tile_sum), n, tiles);
  if (tiles > 1) {
    scan_tile_offsets<<<static_cast<unsigned>(instances), 1024, 0, st>>>(
        static_cast<int32_t*>(tile_sum), tiles);
    dim3 grid3(static_cast<unsigned>(tiles - 1),
               static_cast<unsigned>(instances));
    add_tile_offsets<<<grid3, kTile, 0, st>>>(
        static_cast<int32_t*>(cum), static_cast<const int32_t*>(tile_sum), n,
        tiles);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
