// A profiling probe of kernel 4's earlier design: one block per query
// column.  It is on no path; chip_smoke.py runs it on the bench planes
// beside csrc/cols_select.cu (the strip design that replaced it), holds
// its result to that kernel's, and reads its phase profile.
//
// The design, as it ran until the strip design replaced it: the block finds
// each ring column's occupancy bound (a shared atomicMax per slot of the
// 77 ring columns), takes their prefix in thread 0, stages the occupied
// slots' x, y, z packed in shared memory (3 + warps) * 77 * cap floats,
// then one warp per query slot writes its candidates' d2 bit patterns to
// its own buffer, bisects the k-th smallest between the least and the
// largest finite one (one compare per candidate and one __reduce_add_sync
// a step) and forms the tie-rule sum.  Caps above MAX_CAP do not fit.
// The contract is kernel 4's (csrc/cols_select.cu).
//
// Thread 0 of each block adds clock64 spans to prof (5 words): [0] the
// occupancy bounds, [1] their prefix, [2] the staging, [3] the selection,
// and [4] counts the blocks.
#include <cuda_runtime.h>

#include "scan.cuh"  // CWIPC_RETURN_IF_ERROR

namespace {

constexpr int M = 4;                // ring radius in columns
constexpr int SIDE = 2 * M + 1;     // 9
constexpr int NCOLS = SIDE * SIDE;  // 81, of which the 4 corners are skipped
constexpr int RING_COLS = NCOLS - 4;
constexpr int CENTER = NCOLS / 2;
constexpr int MAX_WARPS = 4;
constexpr int MAX_CAP = 160;  // one warp's staged ring and d2 buffer fit in 227 KB
constexpr float F32_MAX = 3.402823466e+38f;
constexpr float HALF_MAX = 0.5f * F32_MAX;
constexpr int INF_BITS = 0x7f800000;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ bool corner(int j) {
  return j == 0 || j == SIDE - 1 || j == NCOLS - SIDE || j == NCOLS - 1;
}

// plane row of ring column j around the query's plane row
__device__ __forceinline__ int ring_row(int qrow, int j, int gz) {
  return qrow + (j / SIDE - M) * gz + (j % SIDE - M);
}

__global__ void __launch_bounds__(MAX_WARPS * 32)
cols_select_column(const float* __restrict__ xs, const float* __restrict__ ys, const float* __restrict__ zs,
                   int cap, int gz, int k, int row0, float* __restrict__ sums, float* __restrict__ kth,
                   unsigned long long* __restrict__ prof) {
  const long long t0 = clock64();
  extern __shared__ float smem[];
  __shared__ int occ[NCOLS];
  __shared__ int base[NCOLS + 1];
  const int ring = RING_COLS * cap;  // staged candidates at most
  float* cx = smem;
  float* cy = cx + ring;
  float* cz = cy + ring;
  int* d2buf = reinterpret_cast<int*>(cz + ring);

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int nwarps = nthreads >> 5;
  const int q = blockIdx.x;  // output row
  const int qrow = row0 + q + M * gz + M;
  float* out_s = sums + static_cast<size_t>(q) * cap;
  float* out_k = kth + static_cast<size_t>(q) * cap;

  // an empty query column: nothing to select
  int mine = 0;
  for (int s = tid; s < cap; s += nthreads) mine |= xs[static_cast<size_t>(qrow) * cap + s] < HALF_MAX;
  if (!__syncthreads_or(mine)) {
    for (int s = tid; s < cap; s += nthreads) {
      out_s[s] = 0.0f;
      out_k[s] = F32_MAX;
    }
    if (tid == 0) {
      atomicAdd(&prof[0], static_cast<unsigned long long>(clock64() - t0));
      atomicAdd(&prof[4], 1ull);
    }
    return;
  }

  // 1. occupancy bounds, their prefix, and the packed staging
  for (int j = tid; j < NCOLS; j += nthreads) occ[j] = 0;
  __syncthreads();
  for (int p = tid; p < NCOLS * cap; p += nthreads) {
    const int j = p / cap, s = p - j * cap;
    if (corner(j)) continue;
    if (xs[static_cast<size_t>(ring_row(qrow, j, gz)) * cap + s] < HALF_MAX) atomicMax(&occ[j], s + 1);
  }
  __syncthreads();
  const long long t1 = clock64();
  if (tid == 0) {
    int acc = 0;
    for (int j = 0; j < NCOLS; ++j) {
      base[j] = acc;
      acc += occ[j];
    }
    base[NCOLS] = acc;
  }
  __syncthreads();
  const long long t2 = clock64();
  for (int p = tid; p < NCOLS * cap; p += nthreads) {
    const int j = p / cap, s = p - j * cap;
    if (s >= occ[j]) continue;
    const size_t a = static_cast<size_t>(ring_row(qrow, j, gz)) * cap + s;
    const int c = base[j] + s;
    cx[c] = xs[a];
    cy[c] = ys[a];
    cz[c] = zs[a];
  }
  __syncthreads();
  const long long t3 = clock64();

  const int ncand = base[NCOLS];
  const int lane = tid & 31;
  int* d2w = d2buf + (tid >> 5) * ring;
  for (int sq = tid >> 5; sq < cap; sq += nwarps) {
    const int self = base[CENTER] + sq;
    if (sq >= occ[CENTER] || !(cx[self] < HALF_MAX)) {
      if (lane == 0) {
        out_s[sq] = 0.0f;
        out_k[sq] = F32_MAX;
      }
      continue;
    }
    const float qx = cx[self], qy = cy[self], qz = cz[self];

    // 2. squared distances as int32 patterns; +inf for self and empties
    int nfin = 0, lo = INF_BITS, hi = 0;
    for (int c = lane; c < ncand; c += 32) {
      int b = INF_BITS;
      if (c != self && cx[c] < HALF_MAX) {
        const float dx = __fsub_rn(qx, cx[c]);
        const float dy = __fsub_rn(qy, cy[c]);
        const float dz = __fsub_rn(qz, cz[c]);
        b = __float_as_int(__fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz)));
        if (b < INF_BITS) {
          ++nfin;
          lo = min(lo, b);
          hi = max(hi, b);
        } else {
          b = INF_BITS;
        }
      }
      d2w[c] = b;
    }
    __syncwarp();
    nfin = __reduce_add_sync(FULL, nfin);

    float s = 0.0f, kth_d = F32_MAX;
    int below = 0;
    if (nfin < k) {
      // fewer than k candidates: the caller recomputes this query
      for (int c = lane; c < ncand; c += 32) {
        const int b = d2w[c];
        if (b < INF_BITS) s += __fsqrt_rn(__int_as_float(b));
      }
    } else {
      // 3. smallest v with count(d2 <= v) >= k; count(<= hi) >= k and
      //    count(<= lo - 1) < k hold throughout
      lo = __reduce_min_sync(FULL, lo);
      hi = __reduce_max_sync(FULL, hi);
      while (lo < hi) {
        const int mid = lo + ((hi - lo) >> 1);
        int cnt = 0;
        for (int c = lane; c < ncand; c += 32) cnt += d2w[c] <= mid;
        if (__reduce_add_sync(FULL, cnt) >= k) {
          hi = mid;
        } else {
          lo = mid + 1;
        }
      }
      // 4. the tie-rule sum
      kth_d = __fsqrt_rn(__int_as_float(lo));
      for (int c = lane; c < ncand; c += 32) {
        const int b = d2w[c];
        if (b < lo) {
          s += __fsqrt_rn(__int_as_float(b));
          ++below;
        }
      }
      below = __reduce_add_sync(FULL, below);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
    if (lane == 0) {
      out_s[sq] = nfin < k ? s : s + static_cast<float>(k - below) * kth_d;
      out_k[sq] = kth_d;
    }
    __syncwarp();  // d2w is rewritten for the warp's next query
  }
  __syncthreads();
  if (tid == 0) {
    atomicAdd(&prof[0], static_cast<unsigned long long>(t1 - t0));
    atomicAdd(&prof[1], static_cast<unsigned long long>(t2 - t1));
    atomicAdd(&prof[2], static_cast<unsigned long long>(t3 - t2));
    atomicAdd(&prof[3], static_cast<unsigned long long>(clock64() - t3));
    atomicAdd(&prof[4], 1ull);
  }
}

size_t smem_bytes(int cap, int nwarps) {
  return static_cast<size_t>(3 + nwarps) * RING_COLS * cap * sizeof(float);
}

}  // namespace

// prof: 5 zeroed 64-bit words (not null).
extern "C" int cwipc_cols_select_column_probe(const float* xs, const float* ys, const float* zs, int cap,
                                              int gz, int k, int row0, int nrows, float* sums, float* kth,
                                              unsigned long long* prof, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (cap < 1 || cap > MAX_CAP || k < 1 || gz < 1 || row0 < 0 || nrows < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nrows == 0) return 0;
  // as many warps (query slots in flight) as fit beside the staged ring
  constexpr size_t SMEM_LIMIT = 227 * 1024 - 1024;  // less the static arrays
  int nwarps = MAX_WARPS;
  while (nwarps > 1 && smem_bytes(cap, nwarps) > SMEM_LIMIT) --nwarps;
  const size_t smem = smem_bytes(cap, nwarps);
  if (smem > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {  // above 48 KB only after opting in, per device
    const cudaError_t e = cudaFuncSetAttribute(cols_select_column, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cols_select_column<<<nrows, nwarps * 32, smem, stream>>>(xs, ys, zs, cap, gz, k, row0, sums, kth, prof);
  CWIPC_RETURN_IF_ERROR();
  return 0;
}
