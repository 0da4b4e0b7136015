// Kernel 1: segmented reduction over the Morton-sorted voxel runs.
//
// Replaces cwipc_util_tpu/ops/pallas_segment_reduce.py:_kernel (the
// pallas_call at :278).  Input: the sorted stream of (Morton key, packed
// 10-bit in-voxel offsets, rgba); sentinel keys (INT32_MAX) are padding.
// Output: one column per run of equal keys, columns in run order —
//   rows[0..2] = sum of (q + 0.5) / 1024 per axis,   rows[3..5] = sum of r, g, b,
//   rows[6]    = point count,                        rows[7]    = OR of the tile bytes,
//   out_key    = the run's key,                      *nseg      = number of runs (not capped).
// Runs at or past ocap are dropped; columns from nseg on read zero.
//
// Bound on the H100: memory.  It must read the keys, offsets and colours
// (12 bytes a point) and write 36 bytes a run: about 20 MB, 6 us, at the
// chain's 1M points; there is no arithmetic to speak of.  The TPU kernel's
// sequential grid carried the open run from block to block; here blocks
// run in any order.  One call is a memset and one launch:
//   1. the memset zeroes the run count, a tile counter and one 64-bit
//      look-back status word per tile (scan.cuh);
//   2. a block of THREADS threads takes the next tile of TILE points from
//      the counter (ITEMS consecutive points a thread), flags the run
//      starts, ranks them with one block scan, and resolves the tile's run
//      offset by decoupled look-back before any long work, so no tile ever
//      waits on a walk;
//   3. the tile owns the runs that start in it.  It skips its leading
//      points that continue the previous tile's run; each thread sums its
//      consecutive points of one run in registers and adds the sums into
//      shared memory by local run index (integer atomics in shared memory,
//      at most TILE runs x 8 rows); the owner of the tile's last run walks
//      on past the tile's end until the key changes, the sentinel or n,
//      with 64-bit sums: warp 0 reads the next 32 points, and the block
//      reads on TILE points a step only while all of them continue;
//   4. consecutive threads write the tile's runs to consecutive columns,
//      once, as final values: (2 * sum(q) + count) / 2048 rounded once for
//      the f32 rows 0-2, which reproduces the TPU kernel's exact f32 sums of
//      (q + 0.5) / 1024 for runs under 8192 points; rows 3-7 as exact
//      integers; the last tile writes the run count;
//   5. ceil(ocap / ZERO_COLS) more blocks, whose tile ids come after every
//      real tile's, wait for the last tile's inclusive prefix (the run
//      count) and zero the columns from it to ocap.
// Integer sums are exact in any order, so the result does not depend on
// the schedule.  No atomic operation touches device memory but the tile
// counter.  Worst case: a run of all n points is walked by one block, at
// one memory latency per TILE points (about 1 ms for 1M points).
#include <cuda_runtime.h>

#include "scan.cuh"  // TILE, block_exclusive_scan, lookback_exclusive, wait_prefix, CWIPC_RETURN_IF_ERROR

namespace {

constexpr int SENTINEL = 0x7fffffff;
constexpr int NROWS = 8;
constexpr int THREADS = 256;
constexpr int ITEMS = TILE / THREADS;  // consecutive points a thread
constexpr int ZERO_COLS = 4096;        // columns a tail block zeroes
constexpr unsigned FULL = 0xffffffffu;

// the seven integer sums of one point: q per axis, r, g, b, and the count
__device__ __forceinline__ void add_point(unsigned (&s)[7], unsigned& tile_or, unsigned q, unsigned c) {
  s[0] += (q >> 20) & 1023u;
  s[1] += (q >> 10) & 1023u;
  s[2] += q & 1023u;
  s[3] += (c >> 16) & 0xFFu;
  s[4] += (c >> 8) & 0xFFu;
  s[5] += c & 0xFFu;
  s[6] += 1u;
  tile_or |= c >> 24;
}

__global__ void __launch_bounds__(THREADS, 4)
segment_reduce_lookback(const int* __restrict__ key, const int* __restrict__ fr, const int* __restrict__ rgba,
                        int n, int ocap, int ntiles, float* __restrict__ rows, int* __restrict__ out_key,
                        int* __restrict__ nseg, int* __restrict__ counter, unsigned long long* status) {
  __shared__ unsigned sums[NROWS][TILE];  // by local run: 7 sums and the tile OR
  __shared__ int run_key[TILE];
  __shared__ unsigned long long walk[7];  // the last run's sums past the tile
  __shared__ unsigned walk_or;
  __shared__ int tile_id, exclusive, walk_more, walk_stop, walk_key;
  const int tid = threadIdx.x;
  if (tid == 0) tile_id = atomicAdd(counter, 1);
  __syncthreads();
  const int tile = tile_id;

  if (tile >= ntiles) {  // a tail block: zero the columns [run count, ocap) of its range
    __shared__ int total;
    if (tid == 0) total = ntiles > 0 ? wait_prefix(status, ntiles - 1) : 0;
    __syncthreads();
    const int lo = max((tile - ntiles) * ZERO_COLS, total);
    const int hi = min((tile - ntiles + 1) * ZERO_COLS, ocap);
    for (int c = lo + tid; c < hi; c += THREADS) {
#pragma unroll
      for (int r = 0; r < NROWS; ++r) rows[static_cast<size_t>(r) * ocap + c] = 0.0f;
      out_key[c] = 0;
    }
    return;
  }

  // flag the run starts among the thread's ITEMS consecutive points
  const int i0 = tile * TILE + tid * ITEMS;
  int prev = i0 > 0 && i0 <= n ? key[i0 - 1] : SENTINEL;
  int k[ITEMS];
  unsigned q[ITEMS], c[ITEMS];
  unsigned start = 0u;  // bit it: point i0 + it starts a run
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const bool in = i0 + it < n;
    k[it] = in ? key[i0 + it] : SENTINEL;
    q[it] = in ? static_cast<unsigned>(fr[i0 + it]) : 0u;  // in flight during the scan and look-back
    c[it] = in ? static_cast<unsigned>(rgba[i0 + it]) : 0u;
    if (k[it] != SENTINEL && (i0 + it == 0 || k[it] != prev)) start |= 1u << it;
    prev = k[it];
  }
  int nruns;
  const int before = block_exclusive_scan<THREADS>(__popc(start), &nruns);
  const int lane = tid & 31;
  if (tid < 32) {  // warp 0: the look-back
    const int prefix = lookback_exclusive(status, tile, nruns);
    if (lane == 0) {
      exclusive = prefix;
      if (tile == ntiles - 1) *nseg = prefix + nruns;
    }
  } else if (tid >= THREADS - 32) {
    // the last warp, meanwhile: the walk's first 32 points past the tile,
    // if the tile's last point is in its last run and a point follows it
    const int kl = __shfl_sync(FULL, k[ITEMS - 1], 31);
    const bool walk_on = nruns > 0 && kl != SENTINEL && (tile + 1) * TILE < n;
    const int j = (tile + 1) * TILE + lane;
    const bool inb = walk_on && j < n;
    const int kj = inb ? key[j] : SENTINEL;
    const unsigned qj = inb ? static_cast<unsigned>(fr[j]) : 0u;  // loaded with the key, not after it
    const unsigned cj = inb ? static_cast<unsigned>(rgba[j]) : 0u;
    const unsigned brk = __ballot_sync(FULL, !(inb && kj == kl));
    const int len = brk != 0 ? __ffs(brk) - 1 : 32;
    unsigned s[7] = {0u, 0u, 0u, 0u, 0u, 0u, 0u};
    unsigned tor = 0u;
    if (lane < len) add_point(s, tor, qj, cj);
#pragma unroll
    for (int r = 0; r < 7; ++r) {
      unsigned v = s[r];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
      if (lane == 0) walk[r] = v;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) tor |= __shfl_xor_sync(FULL, tor, o);
    if (lane == 0) {
      walk_or = tor;
      walk_more = len == 32;
      walk_key = kl;
      walk_stop = TILE;
    }
  }
  for (int col = tid; col < nruns; col += THREADS) {
#pragma unroll
    for (int r = 0; r < NROWS; ++r) sums[r][col] = 0u;
  }
  __syncthreads();

  // the tile's runs: register sums over the thread's points of one run,
  // added into shared memory when the run changes
  {
    unsigned s[7] = {0u, 0u, 0u, 0u, 0u, 0u, 0u};
    unsigned tor = 0u;
    int run = before - 1;  // local run of the point before; -1: the previous tile's
    int cur = -1;
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      if ((start >> it) & 1u) run_key[++run] = k[it];
      if (k[it] == SENTINEL || run < 0) continue;
      if (run != cur) {
        if (cur >= 0) {
#pragma unroll
          for (int r = 0; r < 7; ++r) atomicAdd(&sums[r][cur], s[r]);
          atomicOr(&sums[7][cur], tor);
        }
#pragma unroll
        for (int r = 0; r < 7; ++r) s[r] = 0u;
        tor = 0u;
        cur = run;
      }
      add_point(s, tor, q[it], c[it]);
    }
    if (cur >= 0) {
#pragma unroll
      for (int r = 0; r < 7; ++r) atomicAdd(&sums[r][cur], s[r]);
      atomicOr(&sums[7][cur], tor);
    }
  }
  // ... and the block reads on, TILE points a step, while all continue
  if (walk_more) {
    const int kl = walk_key;
    unsigned long long s64[7] = {0ull, 0ull, 0ull, 0ull, 0ull, 0ull, 0ull};
    unsigned tor = 0u;
    for (long long base = static_cast<long long>(tile + 1) * TILE + 32;; base += TILE) {
      bool in[ITEMS];
      bool all = true;
#pragma unroll
      for (int it = 0; it < ITEMS; ++it) {  // strided: coalesced, all loads in flight
        const long long j = base + it * THREADS + tid;
        in[it] = j < n && key[j] == kl;
        q[it] = j < n ? static_cast<unsigned>(fr[j]) : 0u;  // loaded with the key, not after it
        c[it] = j < n ? static_cast<unsigned>(rgba[j]) : 0u;
        all = all && in[it];
      }
      int upto = TILE;  // the step's points before the first that leaves the run
      if (!__syncthreads_and(all)) {
#pragma unroll
        for (int it = 0; it < ITEMS; ++it) {
          if (!in[it]) atomicMin(&walk_stop, it * THREADS + tid);
        }
        __syncthreads();
        upto = walk_stop;
      }
#pragma unroll
      for (int it = 0; it < ITEMS; ++it) {
        if (it * THREADS + tid < upto) {
          unsigned s[7] = {0u, 0u, 0u, 0u, 0u, 0u, 0u};
          add_point(s, tor, q[it], c[it]);
#pragma unroll
          for (int r = 0; r < 7; ++r) s64[r] += s[r];
        }
      }
      if (upto < TILE) break;
    }
#pragma unroll
    for (int r = 0; r < 7; ++r) {
      unsigned long long v = s64[r];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
      if ((tid & 31) == 0) atomicAdd(&walk[r], v);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) tor |= __shfl_xor_sync(FULL, tor, o);
    if ((tid & 31) == 0) atomicOr(&walk_or, tor);
  }
  __syncthreads();

  // write the tile's runs, each column once
  for (int j = tid; j < nruns; j += THREADS) {
    const int col = exclusive + j;
    if (col >= ocap) break;
    const bool last = j == nruns - 1;
    unsigned long long s[7];
#pragma unroll
    for (int r = 0; r < 7; ++r) s[r] = sums[r][j] + (last ? walk[r] : 0ull);
    const unsigned tor = sums[7][j] | (last ? walk_or : 0u);
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      // sum of (q + 0.5) / 1024 = (2 * sum(q) + count) / 2048: one rounding
      rows[static_cast<size_t>(r) * ocap + col] = __ull2float_rn(2ull * s[r] + s[6]) * (1.0f / 2048.0f);
    }
#pragma unroll
    for (int r = 3; r < 7; ++r) rows[static_cast<size_t>(r) * ocap + col] = __ull2float_rn(s[r]);
    rows[static_cast<size_t>(7) * ocap + col] = __uint2float_rn(tor);
    out_key[col] = run_key[j];
  }
}

}  // namespace

// work: the one buffer of ops/segment_reduce.py:segment_plan(n, ocap), in
// int32 words: rows f32 [8][ocap], the run keys [ocap] at 8 ocap, the run
// count at 9 ocap, the tile counter at 9 ocap + 1, then from the first even
// word after them one 64-bit status word per tile of TILE points.  One
// memset (from the run count on), then one launch.
extern "C" int cwipc_segment_reduce(const int* key, const int* fr, const int* rgba, int n, int ocap, int* work,
                                    void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n < 0 || n > 0x7fffffff - 2 * TILE || ocap < 0 || ocap > (0x7fffffff - 3) / 9) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int ntiles = (n + TILE - 1) / TILE;
  const int zblocks = (ocap + ZERO_COLS - 1) / ZERO_COLS;
  const size_t nseg_at = 9 * static_cast<size_t>(ocap);
  const size_t status_at = (nseg_at + 3) / 2 * 2;
  const size_t words = status_at + 2 * static_cast<size_t>(ntiles);
  const cudaError_t e = cudaMemsetAsync(work + nseg_at, 0, (words - nseg_at) * sizeof(int), stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (ntiles + zblocks > 0) {
    segment_reduce_lookback<<<ntiles + zblocks, THREADS, 0, stream>>>(
        key, fr, rgba, n, ocap, ntiles, reinterpret_cast<float*>(work), work + 8 * static_cast<size_t>(ocap),
        work + nseg_at, work + nseg_at + 1, reinterpret_cast<unsigned long long*>(work + status_at));
    CWIPC_RETURN_IF_ERROR();
  }
  return 0;
}

// Message for a cudaError_t returned by any entry point of the library.
extern "C" const char* cwipc_kernels_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
