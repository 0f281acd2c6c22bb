// Decoupled look-back across the tiles of one instance (kg_scan.cu's scan
// and kg_join.cu's select epilogue).
//
// Tiles are numbered instance-major and claimed in order from a counter
// zeroed before the launch, so a block waits only on tiles that running
// blocks hold. Each tile publishes its own count at once, then warp 0 walks
// back over its predecessors 32 at a time, within its instance (an
// instance's first tile publishes its inclusive prefix at once), and
// publishes the count through the tile. Flag and value travel as one 64-bit
// word, stored with st.release.gpu and read with ld.acquire.gpu.
#pragma once

#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kFlagAggregate = 1;   // the tile's own count
constexpr unsigned long long kFlagPrefix = 2;      // count through the tile

__device__ __forceinline__ void publish(unsigned long long* word,
                                        unsigned long long flag,
                                        unsigned value) {
  const unsigned long long w = (flag << 32) | value;
  asm volatile("st.release.gpu.global.b64 [%0], %1;"
               :: "l"(word), "l"(w) : "memory");
}

__device__ __forceinline__ unsigned long long observe(
    const unsigned long long* word) {
  unsigned long long w;
  asm volatile("ld.acquire.gpu.global.b64 %0, [%1];"
               : "=l"(w) : "l"(word) : "memory");
  return w;
}

// Warp 0 (all 32 lanes): publish the tile's count, find the count of the
// instance's entries before the tile, publish the count through the tile.
// Returns the count before the tile (the same in every lane).
__device__ int look_back(unsigned long long* status, long long tile,
                         long long local, int aggregate) {
  const int lane = threadIdx.x & 31;
  if (local == 0) {
    if (lane == 0) publish(status + tile, kFlagPrefix, aggregate);
    return 0;
  }
  if (lane == 0) publish(status + tile, kFlagAggregate, aggregate);
  const long long first = tile - local;    // the instance's first tile
  int exclusive = 0;
  for (long long end = tile;; end -= 32) {
    // lane l reads tile end - 1 - l; tiles before the instance count 0
    // (its first tile, nearer, holds a prefix)
    const long long j = end - 1 - lane;
    unsigned long long w = kFlagPrefix << 32;
    if (j >= first) {
      w = observe(status + j);
      while ((w >> 32) == 0) {
        __nanosleep(32);
        w = observe(status + j);
      }
    }
    const unsigned prefixed = __ballot_sync(kFull, (w >> 32) == kFlagPrefix);
    // the nearest tile with its prefix ends the walk; nearer ones add theirs
    const int stop = prefixed ? __ffs(prefixed) - 1 : 31;
    int v = lane <= stop ? static_cast<int>(static_cast<unsigned>(w)) : 0;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
    exclusive += v;
    if (prefixed) break;
  }
  if (lane == 0) publish(status + tile, kFlagPrefix, exclusive + aggregate);
  return exclusive;
}

}  // namespace
