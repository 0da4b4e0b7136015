// Kernel 5: cross-cloud nearest neighbour over the (y, z) column grid.
//
// Replaces cwipc_util_tpu/ops/pallas_nn.py:_nn_kernel (the pallas_call at
// :246; wrapper nn_select_pallas :171).  The spec is the plain version,
// cwipc_util_tpu_torch/ops/nn_select.py:nn_select_plain.
//
// Input: the padded coordinate planes (x, y, z) of a reference cloud
// [prows, cap_r] and of a query cloud [prows, cap_q], built by
// ops/cols_knn.py:_cols_build on one grid.  Plane row off + p holds the
// slots of column p (p < gy*gz), off = 4*gz + 4 rows of F32_MAX pad both
// ends, and an empty slot holds F32_MAX.  For every query slot (p, s):
//   * d2: the minimum of ((dx*dx) + (dy*dy)) + (dz*dz), dx = c - q, over
//     the reference slots of the 77 ring columns around p (9x9 minus the 4
//     corners, dy-major, dz-minor), rounded op by op (__fsub_rn, __fmul_rn,
//     __fadd_rn: nvcc would otherwise contract to FMA), so it is bit-equal
//     to the plain version's;
//   * cid: ring_index * ceil8(cap_r) + slot_row of that candidate, the
//     smallest id among equal d2;
//   * an empty query slot, or a ring with no reference point: d2 F32_MAX,
//     cid INT32_MAX.
//
// Bound on the H100: the planes are read from L2 and each block reads its
// ring once, so bytes are far below the bandwidth bound; the work is
// (staged candidates) x (occupied query slots) d2 evaluations, a few
// instructions each.  The design keeps that count and the shared-memory
// footprint small, not the instruction rate high (a first, simple kernel):
//   1. one block per query column, one thread per query slot (blockDim =
//      cap_q rounded up to a warp);
//   2. the block finds each ring column's occupancy bound (one past its
//      last occupied slot; columns are rank-compacted, so this is their
//      count) and stages only those slots, packed with their ids, in
//      shared memory: a few occupied of cap_r slots per column;
//   3. a ring with more than STAGE occupied slots (dense scenes at cap
//      96/128) is staged in passes, each thread keeping its running
//      lexicographic (d2, id) minimum in registers, so every cap the host
//      chooser can pick fits in 32 KB of shared memory;
//   4. each thread scans the staged candidates; all threads of a warp read
//      the same candidate, a shared-memory broadcast.
// The TPU kernel's transposed lane layout, tiled DMA slabs and static
// occupancy tiers were workarounds for that machine and are not carried
// over; none changes a result.
#include <cuda_runtime.h>

#include "scan.cuh"  // CWIPC_RETURN_IF_ERROR

namespace {

constexpr int M = 4;                // ring radius in columns
constexpr int SIDE = 2 * M + 1;     // 9
constexpr int NCOLS = SIDE * SIDE;  // 81, of which the 4 corners are skipped
constexpr int MAX_CAP_Q = 1024;     // one thread per query slot
constexpr int STAGE = 2048;         // candidates staged per pass (32 KB)
constexpr float F32_MAX = 3.402823466e+38f;
constexpr float HALF_MAX = 0.5f * F32_MAX;
constexpr int INT32_MAX_ = 0x7fffffff;

__device__ __forceinline__ bool corner(int j) {
  return j == 0 || j == SIDE - 1 || j == NCOLS - SIDE || j == NCOLS - 1;
}

// ring index (0..76) of the non-corner column j of the 9x9 square: the
// corners before j are skipped
__device__ __forceinline__ int ring_index(int j) {
  return j - (j > 0) - (j > SIDE - 1) - (j > NCOLS - SIDE);
}

__global__ void nn_select(const float* __restrict__ rx, const float* __restrict__ ry,
                          const float* __restrict__ rz, const float* __restrict__ qx,
                          const float* __restrict__ qy, const float* __restrict__ qz, int cap_r,
                          int cap_q, int gz, float* __restrict__ d2_out, int* __restrict__ cid_out) {
  __shared__ int occ[NCOLS];
  __shared__ int base[NCOLS + 1];
  __shared__ float cx[STAGE];
  __shared__ float cy[STAGE];
  __shared__ float cz[STAGE];
  __shared__ int cid[STAGE];

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int p = blockIdx.x;  // query column
  const int off = M * gz + M;
  const int qrow = off + p;
  const int capp_r = (cap_r + 7) / 8 * 8;

  // this thread's query slot
  const bool mine = tid < cap_q;
  const size_t qa = static_cast<size_t>(qrow) * cap_q + tid;
  const float px = mine ? qx[qa] : F32_MAX;
  const bool live = px < HALF_MAX;
  const float py = live ? qy[qa] : 0.0f;
  const float pz = live ? qz[qa] : 0.0f;

  float best = F32_MAX;
  int best_id = INT32_MAX_;
  // an empty query column: nothing to search
  if (__syncthreads_or(live)) {
    // 1. occupancy bounds of the ring columns and their prefix
    for (int j = tid; j < NCOLS; j += nthreads) occ[j] = 0;
    __syncthreads();
    for (int a = tid; a < NCOLS * cap_r; a += nthreads) {
      const int j = a / cap_r, s = a - j * cap_r;
      if (corner(j)) continue;
      const int row = qrow + (j / SIDE - M) * gz + (j % SIDE - M);
      if (rx[static_cast<size_t>(row) * cap_r + s] < HALF_MAX) atomicMax(&occ[j], s + 1);
    }
    __syncthreads();
    if (tid == 0) {
      int acc = 0;
      for (int j = 0; j < NCOLS; ++j) {
        base[j] = acc;
        acc += occ[j];
      }
      base[NCOLS] = acc;
    }
    __syncthreads();
    const int ncand = base[NCOLS];

    // 2./3. stage the packed candidates, STAGE at a time, and scan them
    float b2 = __int_as_float(0x7f800000);  // +inf: no candidate yet
    for (int c0 = 0; c0 < ncand; c0 += STAGE) {
      const int c1 = min(c0 + STAGE, ncand);
      for (int a = tid; a < NCOLS * cap_r; a += nthreads) {
        const int j = a / cap_r, s = a - j * cap_r;
        if (s >= occ[j]) continue;  // corners have occ 0
        const int c = base[j] + s;
        if (c < c0 || c >= c1) continue;
        const int row = qrow + (j / SIDE - M) * gz + (j % SIDE - M);
        const size_t ra = static_cast<size_t>(row) * cap_r + s;
        cx[c - c0] = rx[ra];
        cy[c - c0] = ry[ra];
        cz[c - c0] = rz[ra];
        cid[c - c0] = ring_index(j) * capp_r + s;
      }
      __syncthreads();
      if (live) {
        for (int c = 0; c < c1 - c0; ++c) {
          const float dx = __fsub_rn(cx[c], px);
          const float dy = __fsub_rn(cy[c], py);
          const float dz = __fsub_rn(cz[c], pz);
          const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
          // an empty slot inside a column's prefix has F32_MAX coordinates
          // and an infinite d; the plain version masks it out the same way
          if (cx[c] < HALF_MAX && d < __int_as_float(0x7f800000) &&
              (d < b2 || (d == b2 && cid[c] < best_id))) {
            b2 = d;
            best_id = cid[c];
          }
        }
      }
      __syncthreads();  // the stage is rewritten by the next pass
    }
    if (best_id != INT32_MAX_) best = b2;
  }
  if (mine) {
    const size_t o = static_cast<size_t>(p) * cap_q + tid;
    d2_out[o] = best;
    cid_out[o] = best_id;
  }
}

}  // namespace

extern "C" int cwipc_nn_select(const float* rx, const float* ry, const float* rz, const float* qx,
                               const float* qy, const float* qz, int cap_r, int cap_q, int gz,
                               int gyz, float* d2, int* cid, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (cap_r < 1 || cap_q < 1 || cap_q > MAX_CAP_Q || gz < 1 || gyz < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (gyz == 0) return 0;
  const int threads = (cap_q + 31) / 32 * 32;
  nn_select<<<gyz, threads, 0, stream>>>(rx, ry, rz, qx, qy, qz, cap_r, cap_q, gz, d2, cid);
  CWIPC_RETURN_IF_ERROR();
  return 0;
}
