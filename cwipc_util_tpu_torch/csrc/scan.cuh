// Block scans and the decoupled look-back, shared by the segmented reduce
// (segment_reduce.cu) and the compaction (compact.cu).
//
// Both are one launch over tiles of TILE points.  A block takes the next
// tile from a counter in device memory, so every tile it waits on belongs
// to a block that is already running.  It counts its items (run starts,
// kept points), ranks them with one block scan, publishes its count and
// resolves its offset by decoupled look-back (lookback_exclusive): warp 0
// reads the status words of the 32 tiles before it at once and stops at
// the nearest that holds an inclusive prefix.  A status word holds a flag
// (the tile's own count, or the count of it and every earlier tile) and
// the count, in one 64-bit word, so a reader that sees the flag sees the
// count.  The status words start at zero (the caller's memset).
// Everything has internal linkage: each .cu file gets its own copy.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 1024;  // points per tile
// a look-back status word: a flag in bit 62 (the tile's own count) or 63
// (the count of this and every earlier tile), the count in bits 0-31
constexpr unsigned long long LOOKBACK_AGG = 1ull << 62;
constexpr unsigned long long LOOKBACK_PREFIX = 1ull << 63;
constexpr unsigned long long LOOKBACK_VALUE = 0xffffffffull;

// Exclusive prefix sum of v over the NT threads of the block (NT a
// multiple of 32, at most 1024); *total receives the block's sum.  Every
// thread of the block must call it.
template <int NT>
__device__ __forceinline__ int block_exclusive_scan(int v, int* total) {
  static_assert(NT % 32 == 0 && NT <= 1024, "NT: whole warps, at most 32 of them");
  constexpr int NW = NT / 32;
  __shared__ int warp_sums[NW];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {  // one warp sum per lane
    int s = lane < NW ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < NW; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, d);
      if (lane >= d) s += y;
    }
    if (lane < NW) warp_sums[lane] = s;
  }
  __syncthreads();
  const int before = warp > 0 ? warp_sums[warp - 1] : 0;
  *total = warp_sums[NW - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return before + x - v;
}

// Called by the 32 lanes of one warp: publish the tile's count, find the
// count of every earlier tile, publish the inclusive prefix, and return
// the exclusive one to every lane.
__device__ __forceinline__ int lookback_exclusive(unsigned long long* status, int tile, int count) {
  const int lane = threadIdx.x & 31;
  volatile unsigned long long* st = status;
  if (lane == 0) st[tile] = (tile == 0 ? LOOKBACK_PREFIX : LOOKBACK_AGG) | static_cast<unsigned long long>(count);
  int prefix = 0;
  if (tile > 0) {
    // lane l reads tile hi - l: the nearest first
    for (int hi = tile - 1;; hi -= 32) {
      const int t = hi - lane;
      unsigned long long w = LOOKBACK_PREFIX;  // below tile 0: a prefix of 0
      if (t >= 0) {
        do {
          w = st[t];
        } while ((w & (LOOKBACK_AGG | LOOKBACK_PREFIX)) == 0);
      }
      const unsigned has_prefix = __ballot_sync(0xffffffffu, (w & LOOKBACK_PREFIX) != 0);
      const int stop = has_prefix != 0 ? __ffs(has_prefix) - 1 : 31;
      int v = lane <= stop ? static_cast<int>(w & LOOKBACK_VALUE) : 0;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      prefix += v;
      if (has_prefix != 0) break;
    }
    if (lane == 0) st[tile] = LOOKBACK_PREFIX | static_cast<unsigned long long>(prefix + count);
  }
  return prefix;
}

// The inclusive prefix of `tile` once it is published: the count of it and
// every earlier tile.
__device__ __forceinline__ int wait_prefix(const unsigned long long* status, int tile) {
  volatile const unsigned long long* st = status;
  unsigned long long w;
  while (((w = st[tile]) & LOOKBACK_PREFIX) == 0) __nanosleep(64);
  return static_cast<int>(w & LOOKBACK_VALUE);
}

}  // namespace

// Launch check shared by the C entry points: return the first error.
#define CWIPC_RETURN_IF_ERROR()                  \
  do {                                           \
    const cudaError_t e_ = cudaGetLastError();   \
    if (e_ != cudaSuccess) return (int)e_;       \
  } while (0)
