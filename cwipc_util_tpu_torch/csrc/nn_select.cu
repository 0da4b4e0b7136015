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
// Bound on the H100: neither bytes nor operations at the registration
// flow's shapes (a few us each); a ring kernel is bound by how often it
// restages the same reference columns and how many lanes sit idle.  The
// strip design:
//   1. a block of 512 threads takes STRIP = 8 consecutive query columns (a
//      strip in flat column order; the ring offsets are flat, so a strip
//      that wraps into the next y row needs nothing special).  The union
//      of their rings is SIDE rows of UNION_W = STRIP + 8 consecutive plane
//      rows: 144 columns staged once for 8 query columns, where one block
//      per column staged 77 each (616);
//   2. each union column's occupancy bound (one past its last occupied
//      slot; the grid build fills a column's slots from 0, so this is its
//      count) comes from one warp per column, a ballot per 32 slots, and
//      the bounds go through a block scan into staging offsets;
//   3. the occupied slots are staged as float4 (x, y, z, id bits) in
//      dynamic shared memory, `stage` candidates per pass (at most
//      STAGE_MAX, 32 KB, so no block needs more than the default 48 KB);
//      a ring denser than that takes several passes, each query slot
//      keeping its lexicographic (d2, id) minimum in the outputs between
//      passes (the same lane owns it in every pass);
//   4. a query column's candidates are 9 contiguous ranges of the stage
//      (one per ring row, the corner columns left off the first and last).
//      The strip's occupied query slots form one list, spread over all the
//      block's threads: each takes L lanes (a power of two up to 32, as
//      many as keep every thread busy; one when the slots outnumber the
//      threads), its lanes split the candidates, two running minima a lane
//      keep two independent chains in flight, and a shuffle reduction
//      merges the lanes' (d2, id) minima.  A strip of dense columns gets a
//      thread per query slot, a strip with a few query points whole warps.
// The TPU kernel's transposed lane layout, tiled DMA slabs and static
// occupancy tiers were workarounds for that machine and are not carried
// over; none changes a result.
#include <cuda_runtime.h>

#include "scan.cuh"  // CWIPC_RETURN_IF_ERROR

namespace {

constexpr int M = 4;                      // ring radius in columns
constexpr int SIDE = 2 * M + 1;           // 9
constexpr int STRIP = 8;                  // query columns per block
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int UNION_W = STRIP + 2 * M;    // union columns per ring row
constexpr int NU = SIDE * UNION_W;        // union columns per block
constexpr int MAX_CAP_Q = 1024;
constexpr int STAGE_MAX = 2048;           // candidates per pass (float4: 32 KB)
constexpr float F32_MAX = 3.402823466e+38f;
constexpr float HALF_MAX = 0.5f * F32_MAX;
constexpr int INT32_MAX_ = 0x7fffffff;

// One past the last slot of row[0, cap) below HALF_MAX; the same in every
// lane of the calling warp.
__device__ __forceinline__ int column_bound(const float* __restrict__ row, int cap, int lane) {
  int bound = 0;
  for (int s0 = 0; s0 < cap; s0 += 32) {
    const int s = s0 + lane;
    const unsigned occ = __ballot_sync(0xffffffffu, s < cap && row[s] < HALF_MAX);
    if (occ != 0) bound = s0 + 32 - __clz(occ);
  }
  return bound;
}

__device__ __forceinline__ bool lex_less(float d, int id, float bd, int bid) {
  return d < bd || (d == bd && id < bid);
}

// Fold candidate e (x, y, z, bits of its id less id_off) into the running
// lexicographic (d2, id) minimum of query (px, py, pz).  d2 is rounded op
// by op; an empty slot inside a column's prefix has F32_MAX coordinates
// and an infinite d, and the plain version masks it out the same way.
__device__ __forceinline__ void consider(const float4 e, float px, float py, float pz, int id_off,
                                         float& best, int& best_id) {
  const float dx = __fsub_rn(e.x, px);
  const float dy = __fsub_rn(e.y, py);
  const float dz = __fsub_rn(e.z, pz);
  const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
  const int id = __float_as_int(e.w) + id_off;
  if (e.x < HALF_MAX && d < __int_as_float(0x7f800000) && lex_less(d, id, best, best_id)) {
    best = d;
    best_id = id;
  }
}

__global__ void __launch_bounds__(THREADS)
nn_select_strip(const float* __restrict__ rx, const float* __restrict__ ry, const float* __restrict__ rz,
                const float* __restrict__ qx, const float* __restrict__ qy, const float* __restrict__ qz,
                int cap_r, int cap_q, int gz, int gyz, int stage_cap, float* __restrict__ d2_out,
                int* __restrict__ cid_out) {
  extern __shared__ float4 stage[];  // stage_cap candidates: (x, y, z, bits of union_col * capp_r + slot)
  __shared__ int ubound[NU];
  __shared__ int ubase[NU + 1];
  __shared__ int warp_sum[WARPS];
  __shared__ int qcount[STRIP];  // occupied query slots per column of the strip
  __shared__ int qbase[STRIP + 1];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int p0 = blockIdx.x * STRIP;
  const int off = M * gz + M;
  const int capp_r = (cap_r + 7) / 8 * 8;
  const int row_end = gyz + 2 * off;  // no grid column's ring reaches this row
  const int p = p0 + warp;            // warp w < STRIP: query column p0 + w
  const bool col = warp < STRIP && p < gyz;

  // 1. occupancy bounds: the query columns, one a warp, then the union
  const int nq = col ? column_bound(qx + static_cast<size_t>(off + p) * cap_q, cap_q, lane) : 0;
  if (warp < STRIP && lane == 0) qcount[warp] = nq;
  for (int u = warp; u < NU; u += WARPS) {
    const int row = off + p0 + (u / UNION_W - M) * gz + (u % UNION_W - M);
    const int b = row < row_end ? column_bound(rx + static_cast<size_t>(row) * cap_r, cap_r, lane) : 0;
    if (lane == 0) ubound[u] = b;
  }
  // slots past the occupied prefix: nothing to search
  if (col) {
    for (int s = nq + lane; s < cap_q; s += 32) {
      d2_out[static_cast<size_t>(p) * cap_q + s] = F32_MAX;
      cid_out[static_cast<size_t>(p) * cap_q + s] = INT32_MAX_;
    }
  }
  const bool any_query = __syncthreads_or(nq > 0);
  if (!any_query) return;

  // 2. staging offsets: exclusive scan of the NU <= THREADS bounds
  {
    const int v = tid < NU ? ubound[tid] : 0;
    int x = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) warp_sum[warp] = x;
    __syncthreads();
    int before = 0;
    for (int w = 0; w < warp; ++w) before += warp_sum[w];
    if (tid < NU) ubase[tid] = before + x - v;
    if (tid == NU - 1) ubase[NU] = before + x;
    __syncthreads();
  }
  const int ncand = ubase[NU];

  // the strip's occupied query slots as one list: slot q of column i is
  // item qbase[i] + q.  Each item gets L lanes (a power of two, so that a
  // group never straddles a warp): as many as keep every thread busy, one
  // when the items outnumber the threads
  if (tid == 0) {
    int acc = 0;
    for (int i = 0; i < STRIP; ++i) {
      qbase[i] = acc;
      acc += qcount[i];
    }
    qbase[STRIP] = acc;
  }
  __syncthreads();
  const int nitems = qbase[STRIP];
  int L = 32;
  while (L > 1 && L * nitems > THREADS) L >>= 1;
  const int ngroups = THREADS / L;
  const int sub = tid % L;
  const int grp = tid / L;
  const int rounds = (nitems + ngroups - 1) / ngroups;

  for (int c0 = 0; c0 < ncand; c0 += stage_cap) {
    const int c1 = min(c0 + stage_cap, ncand);
    // 3. stage the occupied union slots of this pass; each ring row of the
    // union is UNION_W consecutive plane rows
    for (int dyi = 0; dyi < SIDE; ++dyi) {
      const size_t r0 = static_cast<size_t>(off + p0 + (dyi - M) * gz - M) * cap_r;
      for (int a = tid; a < UNION_W * cap_r; a += THREADS) {
        const int zc = a / cap_r;
        const int s = a - zc * cap_r;
        const int u = dyi * UNION_W + zc;
        if (s >= ubound[u]) continue;
        const int c = ubase[u] + s;
        if (c < c0 || c >= c1) continue;
        stage[c - c0] = make_float4(rx[r0 + a], ry[r0 + a], rz[r0 + a], __int_as_float(zc * capp_r + s));
      }
    }
    __syncthreads();

    // 4. scan: the lanes of group grp take item grp + k * ngroups
    for (int k = 0; k < rounds; ++k) {
      const int item = grp + k * ngroups;
      const bool mine = item < nitems;
      int i = 0;  // the item's column in the strip
      while (i + 1 < STRIP && qbase[i + 1] <= item) ++i;
      const size_t qa = static_cast<size_t>(off + p0 + i) * cap_q + (item - qbase[i]);
      const float px = mine ? qx[qa] : F32_MAX;
      const bool live = px < HALF_MAX;
      const float py = live ? qy[qa] : 0.0f;
      const float pz = live ? qz[qa] : 0.0f;
      // two running minima, even and odd candidates, for two independent chains
      float best = __int_as_float(0x7f800000);  // +inf: no candidate yet
      int best_id = INT32_MAX_;
      float best2 = best;
      int best2_id = INT32_MAX_;
      if (live) {
        for (int dyi = 0; dyi < SIDE; ++dyi) {
          const int corner = (dyi == 0 || dyi == SIDE - 1) ? 1 : 0;
          const int lo = max(ubase[dyi * UNION_W + i + corner], c0);
          const int hi = min(ubase[dyi * UNION_W + i + SIDE - corner], c1);
          // ring index of (dyi, dzi): dyi * 9 + dzi minus the corners before it
          const int skipped = dyi == 0 ? 1 : dyi == SIDE - 1 ? 3 : 2;
          const int id_off = (dyi * SIDE - skipped - i) * capp_r;
          int c = lo + sub;
          for (; c + L < hi; c += 2 * L) {
            consider(stage[c - c0], px, py, pz, id_off, best, best_id);
            consider(stage[c + L - c0], px, py, pz, id_off, best2, best2_id);
          }
          if (c < hi) consider(stage[c - c0], px, py, pz, id_off, best, best_id);
        }
      }
      if (lex_less(best2, best2_id, best, best_id)) {
        best = best2;
        best_id = best2_id;
      }
      for (int o = L / 2; o > 0; o >>= 1) {
        const float od = __shfl_xor_sync(0xffffffffu, best, o);
        const int oid = __shfl_xor_sync(0xffffffffu, best_id, o);
        if (lex_less(od, oid, best, best_id)) {
          best = od;
          best_id = oid;
        }
      }
      if (mine && sub == 0) {
        const size_t o = static_cast<size_t>(p0 + i) * cap_q + (item - qbase[i]);
        if (c0 > 0) {  // this lane stored the earlier passes' minimum here
          const float pd = d2_out[o];
          const int pid = cid_out[o];
          if (lex_less(pd, pid, best, best_id)) {
            best = pd;
            best_id = pid;
          }
        }
        const bool final_pass = c1 == ncand;
        d2_out[o] = (final_pass && best_id == INT32_MAX_) ? F32_MAX : best;
        cid_out[o] = best_id;
      }
    }
    __syncthreads();  // the stage is rewritten by the next pass
  }
  if (ncand == 0 && col) {  // no reference point in any ring of the strip
    for (int s = lane; s < nq; s += 32) {
      d2_out[static_cast<size_t>(p) * cap_q + s] = F32_MAX;
      cid_out[static_cast<size_t>(p) * cap_q + s] = INT32_MAX_;
    }
  }
}

}  // namespace

// stage: candidates staged per pass (ops/nn_select.py:strip_plan), at most
// STAGE_MAX; the launch takes stage * 16 bytes of dynamic shared memory.
extern "C" int cwipc_nn_select(const float* rx, const float* ry, const float* rz, const float* qx,
                               const float* qy, const float* qz, int cap_r, int cap_q, int gz,
                               int gyz, int stage, float* d2, int* cid, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (cap_r < 1 || cap_q < 1 || cap_q > MAX_CAP_Q || gz < 1 || gyz < 0 || stage < 1 || stage > STAGE_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (gyz == 0) return 0;
  const int blocks = (gyz + STRIP - 1) / STRIP;
  nn_select_strip<<<blocks, THREADS, static_cast<size_t>(stage) * sizeof(float4), stream>>>(
      rx, ry, rz, qx, qy, qz, cap_r, cap_q, gz, gyz, stage, d2, cid);
  CWIPC_RETURN_IF_ERROR();
  return 0;
}
