// Exclusive scans of 0/1 flags, shared by the segmented reduce
// (segment_reduce.cu) and the compaction (compact.cu).
//
// A device-wide scan is three launches over tiles of TILE points, one
// thread per point:
//   1. each tile counts its flags (__syncthreads_count);
//   2. one block scans the per-tile counts into per-tile offsets and writes
//      the grand total to a device scalar (scan_tile_counts);
//   3. each tile scans its flags again (block_exclusive_scan) and adds its
//      offset, which gives every point its rank.
// Everything has internal linkage: each .cu file gets its own copy.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 1024;  // points per tile = threads per block

// Exclusive prefix sum of v over the TILE threads of the block; *total
// receives the block's sum.  Every thread of the block must call it.
__device__ __forceinline__ int block_exclusive_scan(int v, int* total) {
  __shared__ int warp_sums[TILE / 32];
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
  if (warp == 0) {  // TILE / 32 == 32 warp sums: one per lane
    int s = warp_sums[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, d);
      if (lane >= d) s += y;
    }
    warp_sums[lane] = s;
  }
  __syncthreads();
  const int before = warp > 0 ? warp_sums[warp - 1] : 0;
  *total = warp_sums[TILE / 32 - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return before + x - v;
}

// One block of TILE threads: tile_offsets[t] = sum of tile_counts[< t],
// *total = sum of all.  Loops for more than TILE tiles.
__global__ void __launch_bounds__(TILE)
scan_tile_counts(const int* __restrict__ tile_counts, int ntiles,
                 int* __restrict__ tile_offsets, int* __restrict__ total) {
  int carry = 0;
  for (int base = 0; base < ntiles; base += TILE) {
    const int t = base + threadIdx.x;
    const int v = t < ntiles ? tile_counts[t] : 0;
    int sum;
    const int before = block_exclusive_scan(v, &sum);
    if (t < ntiles) tile_offsets[t] = carry + before;
    carry += sum;
  }
  if (threadIdx.x == 0) *total = carry;
}

}  // namespace

// Launch check shared by the C entry points: return the first error.
#define CWIPC_RETURN_IF_ERROR()                  \
  do {                                           \
    const cudaError_t e_ = cudaGetLastError();   \
    if (e_ != cudaSuccess) return (int)e_;       \
  } while (0)
