// Kernel 1: segmented reduction over the Morton-sorted voxel runs.
//
// Replaces cwipc_util_tpu/ops/pallas_segment_reduce.py:_kernel (the
// pallas_call at :278).  Input: the sorted stream of (Morton key, packed
// 10-bit in-voxel offsets, rgba); sentinel keys (INT32_MAX) are padding.
// Output: one column per run of equal keys, columns in run order —
//   rows[0..2] = sum of (q + 0.5) / 1024 per axis,   rows[3..5] = sum of r, g, b,
//   rows[6]    = point count,                        rows[7]    = OR of the tile bytes,
//   out_key    = the run's key,                      *nseg      = number of runs (not capped).
// Runs at or past ocap are dropped.
//
// Bound on the H100: memory and latency.  At the chain's shape it reads
// 12 MB (three int32 words for 1M points) and writes under 10 MB; there is
// no arithmetic to speak of.  The TPU kernel's sequential grid carried the
// open run from block to block; here blocks run in any order, so the run
// id comes from a device-wide scan of run-start flags (scan.cuh: count,
// scan of tile counts, block scan), and each point adds its values into
// its run's column with integer atomics.  Integer sums are exact in any
// order, so the result does not depend on the schedule, and the epilogue
// (2 * sum(q) + count) / 2048 reproduces the TPU kernel's exact f32 sums of
// (q + 0.5) / 1024 for runs under 8192 points.  Runs average ~5 points at
// the bench's 4 mm cells, so same-address atomic contention is small.
#include <cuda_runtime.h>

#include "scan.cuh"

namespace {

constexpr int SENTINEL = 0x7fffffff;
constexpr int NROWS = 8;

__device__ __forceinline__ int run_starts_at(const int* __restrict__ key, int i, int n) {
  if (i >= n) return 0;
  const int k = key[i];
  return k != SENTINEL && (i == 0 || key[i - 1] != k);
}

__global__ void __launch_bounds__(TILE)
count_runs(const int* __restrict__ key, int n, int* __restrict__ tile_counts) {
  const int i = blockIdx.x * TILE + threadIdx.x;
  const int c = __syncthreads_count(run_starts_at(key, i, n));
  if (threadIdx.x == 0) tile_counts[blockIdx.x] = c;
}

__global__ void __launch_bounds__(TILE)
accumulate_runs(const int* __restrict__ key, const int* __restrict__ fr,
                const int* __restrict__ rgba, int n,
                const int* __restrict__ tile_offsets, int ocap,
                unsigned* __restrict__ acc, int* __restrict__ out_key) {
  const int i = blockIdx.x * TILE + threadIdx.x;
  const int start = run_starts_at(key, i, n);
  int unused;
  const int before = block_exclusive_scan(start, &unused);
  if (i >= n) return;
  const int k = key[i];
  if (k == SENTINEL) return;
  // run id = run starts at or before i, minus one
  const int run = tile_offsets[blockIdx.x] + before + start - 1;
  if (run >= ocap) return;
  const unsigned q = static_cast<unsigned>(fr[i]);
  const unsigned c = static_cast<unsigned>(rgba[i]);
  atomicAdd(&acc[0 * ocap + run], (q >> 20) & 1023u);
  atomicAdd(&acc[1 * ocap + run], (q >> 10) & 1023u);
  atomicAdd(&acc[2 * ocap + run], q & 1023u);
  atomicAdd(&acc[3 * ocap + run], (c >> 16) & 0xFFu);
  atomicAdd(&acc[4 * ocap + run], (c >> 8) & 0xFFu);
  atomicAdd(&acc[5 * ocap + run], c & 0xFFu);
  atomicAdd(&acc[6 * ocap + run], 1u);
  atomicOr(&acc[7 * ocap + run], c >> 24);
  if (start) out_key[run] = k;
}

__global__ void finish_runs(const unsigned* __restrict__ acc, int ocap, float* __restrict__ rows) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= ocap) return;
  const unsigned cnt = acc[6 * ocap + j];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    // sum of (q + 0.5) / 1024 = (2 * sum(q) + count) / 2048: one rounding
    const long long twice = 2LL * acc[r * ocap + j] + cnt;
    rows[r * ocap + j] = __ll2float_rn(twice) * (1.0f / 2048.0f);
  }
#pragma unroll
  for (int r = 3; r < NROWS; ++r) rows[r * ocap + j] = __uint2float_rn(acc[r * ocap + j]);
}

}  // namespace

extern "C" int cwipc_segment_reduce(const int* key, const int* fr, const int* rgba, int n, int ocap,
                                    unsigned* acc, int* tile_counts, int* tile_offsets,
                                    float* rows, int* out_key, int* nseg, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int ntiles = (n + TILE - 1) / TILE;
  cudaMemsetAsync(acc, 0, sizeof(unsigned) * NROWS * static_cast<size_t>(ocap), stream);
  cudaMemsetAsync(out_key, 0, sizeof(int) * static_cast<size_t>(ocap), stream);
  CWIPC_RETURN_IF_ERROR();
  if (ntiles > 0) {
    count_runs<<<ntiles, TILE, 0, stream>>>(key, n, tile_counts);
    CWIPC_RETURN_IF_ERROR();
  }
  scan_tile_counts<<<1, TILE, 0, stream>>>(tile_counts, ntiles, tile_offsets, nseg);
  CWIPC_RETURN_IF_ERROR();
  if (ntiles > 0) {
    accumulate_runs<<<ntiles, TILE, 0, stream>>>(key, fr, rgba, n, tile_offsets, ocap, acc, out_key);
    CWIPC_RETURN_IF_ERROR();
  }
  if (ocap > 0) {
    finish_runs<<<(ocap + 255) / 256, 256, 0, stream>>>(acc, ocap, rows);
    CWIPC_RETURN_IF_ERROR();
  }
  return 0;
}

// Message for a cudaError_t returned by any entry point of the library.
extern "C" const char* cwipc_kernels_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
