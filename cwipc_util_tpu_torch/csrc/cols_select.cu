// Kernel 4: exact k-NN selection over the (y, z) column grid.
//
// Replaces cwipc_util_tpu/ops/pallas_cols_select.py:_select_kernel (the
// pallas_call at :502; wrapper cols_select_pallas :403).  The semantic spec
// is the plain version, cwipc_util_tpu/ops/cols_knn.py:_cols_select.
//
// Input: three padded coordinate planes [prows, cap] (x, y, z) built by
// ops/cols_knn.py:_cols_build.  Plane row off + r holds the cap slots of
// column r (r < gy*gz), off = 4*gz + 4 rows of F32_MAX pad both ends, and
// an empty slot holds F32_MAX.  For every slot s of the columns
// r in [row0, row0 + nrows), with a point in it:
//   * candidates: every slot of the 9x9 ring of columns around r minus its
//     4 corner columns (77 columns; a corner column lies >= 4.24 cells
//     away, beyond the 4-cell radius a covered query can use), minus the
//     query's own slot;
//   * kth: the exact k-th smallest candidate distance, sqrt of the k-th
//     smallest squared distance d2 = ((dx*dx) + (dy*dy)) + (dz*dz),
//     dx = q - c, rounded as the plain version rounds it (__fmul_rn /
//     __fadd_rn: nvcc would otherwise contract to FMA), so kth is
//     bit-equal to the plain version's wherever kth < 4 * cell;
//   * sums: sum(d < kth) + (k - count(d < kth)) * kth, the sum of the k
//     smallest distances with ties at the k-th counted as the plain
//     version's sorted prefix counts them;
//   * with fewer than k candidates: kth = F32_MAX (the caller's finish
//     marks the query uncovered) and sums = the sum over all of them.
// Slots without a point get sums 0 and kth F32_MAX; nothing reads them.
//
// Bound on the H100: neither bytes nor operations (the planes' occupied
// slots read once and the d2 of every ring pair are a few us at the bench
// shape).  An exact selection scans each query's candidates several times,
// and a ring kernel is bound by how often it restages the same columns and
// by the latency of the staging loads.  The strip design:
//   1. a first launch finds the occupancy bound (one past the last occupied
//      slot; the grid build fills a column from slot 0, so this is its
//      count) of every plane row the query rows' rings reach, a warp per
//      row and a ballot per 32 slots;
//   2. a block of THREADS threads takes STRIP consecutive query columns (in
//      flat column order: the ring offsets are flat, so a strip that wraps
//      into the next y row needs nothing special).  The union of their
//      rings is SIDE rows of UNION_W consecutive plane rows, 144 columns
//      for 8 query columns, where a block per query column staged 77 each;
//      one block scan of their bounds gives the staging offsets;
//   3. the occupied union slots are staged as float4 in dynamic shared
//      memory, `stage` candidates a pass (ops/cols_select.py:select_plan),
//      at most STAGE_MAX (32 KB) whatever the cap.  A union that fits is
//      staged once; a denser one is staged pass by pass for every scan
//      below, the whole block in step;
//   4. the strip's occupied query slots form one list spread over the
//      block's threads, L lanes each (a power of two up to 32, as many as
//      keep every thread busy; one when the slots outnumber the threads).
//      Where the union is staged whole and the strip's largest ring fits
//      HELD registers of each of L lanes (L raised to that where needed),
//      each query's d2 patterns are formed once into its lanes' registers
//      and every later scan reads them; otherwise every scan forms them
//      again from the stage.
//      A query's candidates are 9 contiguous ranges of the stage, its own
//      slot among them at d2 = 0, the least of all: so the k-th smallest
//      over the others is the (k+1)-th over all, and the tie-rule sum over
//      all with k + 1 is the one over the others with k.  No candidate is
//      tested for being the query;
//   5. the selection narrows a bracket of d2 bit patterns (non-negative
//      floats order as int32).  Each scan counts count(d2 <= mid) and also
//      finds the largest pattern <= mid and the least above it, so the
//      bracket snaps to values that occur; mid interpolates where the count
//      reaches k + 1, with a halving step after any step that did not halve
//      the candidates in the bracket.  A first scan finds the finite count
//      and the largest pattern, a last one the tie-rule sum, added in fixed point
//      so that it does not depend on the order of its terms: a row range
//      gives the rows of the whole run bit for bit.
// With a profile buffer (8 words), thread 0 of each block adds clock64
// spans to it: [0] the bounds launch, [1] union bounds and scan, [2] the
// staging of a union that fits, [3] the selection (passes included), and
// counts [4] selection blocks, [5] scans over all queries, [6] queries,
// [7] blocks whose union took passes.
// The TPU kernel's transposed lane layout, static occupancy tiers, MXU
// counts and seeded bisection window were workarounds for that machine and
// are not carried over; none changes a result.
#include <cuda_runtime.h>

#include <climits>

#include "scan.cuh"  // CWIPC_RETURN_IF_ERROR

namespace {

constexpr int M = 4;                      // ring radius in columns
constexpr int SIDE = 2 * M + 1;           // 9
constexpr int STRIP = 8;                  // query columns per block
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNION_W = STRIP + 2 * M;    // union columns per ring row
constexpr int NU = SIDE * UNION_W;        // union columns per block
constexpr int STAGE_MAX = 2048;           // candidates per pass (float4: 32 KB)
constexpr int HELD = 24;                  // d2 patterns a lane holds in registers
constexpr float F32_MAX = 3.402823466e+38f;
constexpr float HALF_MAX = 0.5f * F32_MAX;
constexpr int MAX_BITS = 0x7f7fffff;      // F32_MAX: a scan at this mid counts every finite d2
constexpr unsigned FULL = 0xffffffffu;
enum Phase { FIRST, BISECT, SUM, DONE };

static_assert(NU <= THREADS, "the union scan takes one thread per union column");

__global__ void __launch_bounds__(THREADS)
column_bounds(const float* __restrict__ xs, int cap, int row0, int nb, int* __restrict__ bounds,
              unsigned long long* __restrict__ prof) {
  const long long t0 = clock64();
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (j < nb) {  // the same in every lane of a warp
    const float* row = xs + static_cast<size_t>(row0 + j) * cap;
    int b = 0;
    for (int s0 = 0; s0 < cap; s0 += 32) {
      const int s = s0 + lane;
      const unsigned occ = __ballot_sync(FULL, s < cap && row[s] < HALF_MAX);
      if (occ != 0) b = s0 + 32 - __clz(occ);
    }
    if (lane == 0) bounds[j] = b;
  }
  if (prof != nullptr) {
    __syncthreads();
    if (threadIdx.x == 0) atomicAdd(&prof[0], static_cast<unsigned long long>(clock64() - t0));
  }
}

// One scan's sums over a query's candidates
struct Acc {
  int cnt;        // candidates with d2 <= mid
  int below;      // the largest d2 pattern <= mid (-1: none)
  int above;      // the least d2 pattern > mid (INT_MAX: none)
  long long sum;  // the distances of the candidates <= mid in fixed point, where asked
};

// The fixed-point scale of a query's distance sum: 2^(40 - e) for the
// largest distance it adds, ref < 2^e, so that every term is below 2^40
// and (k + 1) or 77 * cap of them below 2^63.  Integer sums do not depend
// on their order, so a query's sum is the same whatever the strip, the
// lanes or the passes; rounding each term costs under 2^-40 of ref.
__device__ __forceinline__ double sum_scale(int ref_bits) {
  const float ref = __fsqrt_rn(__int_as_float(ref_bits));
  int e = 0;
  frexpf(ref, &e);
  return ref > 0.0f ? ldexp(1.0, 40 - e) : 1.0;
}

__device__ __forceinline__ int d2_bits(const float4 e, float qx, float qy, float qz) {
  const float dx = __fsub_rn(qx, e.x);
  const float dy = __fsub_rn(qy, e.y);
  const float dz = __fsub_rn(qz, e.z);
  return __float_as_int(__fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz)));
}

// One candidate's d2 pattern b into a scan at mid.  INT_MAX (an empty
// register) is above every mid and never the least above one that counts.
// The sum scan is a separate instance, so that the counting scans carry no
// square root or conversion.  (A branch-free form measured slower on the
// card.)
template <bool SUM>
__device__ __forceinline__ void fold(int b, int mid, double scale, Acc& a) {
  if (b <= mid) {
    ++a.cnt;
    a.below = max(a.below, b);
    if (SUM) a.sum += __double2ll_rn(static_cast<double>(__fsqrt_rn(__int_as_float(b))) * scale);
  } else {
    a.above = min(a.above, b);
  }
}

// A scan over query column i's 9 ranges of the staged pass [c0, c1), the
// group's lanes taking every L-th candidate.
template <bool SUM>
__device__ __forceinline__ void scan_stage(const float4* stage, const int* ubase, int i, int c0, int c1, int sub,
                                           int L, float qx, float qy, float qz, int mid, double scale, Acc& a) {
#pragma unroll
  for (int dyi = 0; dyi < SIDE; ++dyi) {
    const int corner = (dyi == 0 || dyi == SIDE - 1) ? 1 : 0;
    const int r_lo = max(ubase[dyi * UNION_W + i + corner], c0);
    const int r_hi = min(ubase[dyi * UNION_W + i + SIDE - corner], c1);
    for (int c = r_lo + sub; c < r_hi; c += L) fold<SUM>(d2_bits(stage[c - c0], qx, qy, qz), mid, scale, a);
  }
}

// A scan over the d2 patterns a lane holds.
template <bool SUM>
__device__ __forceinline__ void scan_held(const int (&d)[HELD], int mid, double scale, Acc& a) {
#pragma unroll
  for (int t = 0; t < HELD; ++t) fold<SUM>(d[t], mid, scale, a);
}

// The largest union column u with ubase[u] <= c: the occupied column that
// holds staged candidate c.
__device__ __forceinline__ int union_col(const int* ubase, int c) {
  int lo = 0, hi = NU - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (ubase[mid] <= c) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(THREADS)
cols_select_strip(const float* __restrict__ xs, const float* __restrict__ ys, const float* __restrict__ zs,
                  int cap, int gz, int k, int row0, int nrows, const int* __restrict__ bounds, int nb,
                  int stage_cap, float* __restrict__ sums, float* __restrict__ kth,
                  unsigned long long* __restrict__ prof) {
  extern __shared__ float4 stage[];  // stage_cap candidates (x, y, z, unused)
  __shared__ int ubase[NU + 1];
  __shared__ int warp_sum[WARPS];
  __shared__ int qbase[STRIP + 1];  // the strip's query slots: column i holds items [qbase[i], qbase[i+1])

  const long long t0 = clock64();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int off = M * gz + M;
  const int q0 = blockIdx.x * STRIP;      // the strip's first output row
  const int nq = min(STRIP, nrows - q0);  // its query columns
  // union column u = (dyi, zc) is plane row row0 + j, j = q0 + off + (dyi - M) * gz + zc - M
  // = q0 + dyi * gz + zc: the bounds' index.  Past the bounds (nb rows) lies no ring column
  // of a query row

  // 1. the union's bounds, their exclusive scan, the strip's query slots
  {
    int v = 0;
    if (tid < NU) {
      const int j = q0 + (tid / UNION_W) * gz + tid % UNION_W;
      v = j < nb ? bounds[j] : 0;
    }
    int x = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(FULL, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) warp_sum[warp] = x;
    __syncthreads();
    int before = 0;
    for (int w = 0; w < warp; ++w) before += warp_sum[w];
    if (tid < NU) ubase[tid] = before + x - v;
    if (tid == NU - 1) ubase[NU] = before + x;
    __syncthreads();
    if (tid == 0) {
      int acc = 0;
      for (int i = 0; i < STRIP; ++i) {
        qbase[i] = acc;
        const int u = M * UNION_W + M + i;
        if (i < nq) acc += ubase[u + 1] - ubase[u];
      }
      qbase[STRIP] = acc;
    }
    __syncthreads();
  }
  const long long t1 = clock64();
  const int ncand = ubase[NU];
  const int nitems = qbase[STRIP];

  // slots past a query column's bound: nothing to select
  for (int p = tid; p < nq * cap; p += THREADS) {
    const int i = p / cap;
    if (p - i * cap >= qbase[i + 1] - qbase[i]) {
      sums[static_cast<size_t>(q0) * cap + p] = 0.0f;
      kth[static_cast<size_t>(q0) * cap + p] = F32_MAX;
    }
  }

  // stage the union's candidates [c0, c1)
  auto stage_pass = [&](int c0, int c1) {
    for (int c = c0 + tid; c < c1; c += THREADS) {
      const int u = union_col(ubase, c);
      const size_t a = static_cast<size_t>(row0 + q0 + (u / UNION_W) * gz + u % UNION_W) * cap + (c - ubase[u]);
      stage[c - c0] = make_float4(xs[a], ys[a], zs[a], 0.0f);
    }
  };
  const bool single = ncand <= stage_cap;
  if (single && nitems > 0) {
    stage_pass(0, ncand);
    __syncthreads();
  }
  const long long t2 = clock64();

  if (nitems > 0) {
    // a query column's candidates: the sum of its 9 ranges' lengths
    auto ring_count = [&](int i) {
      int n = 0;
#pragma unroll
      for (int dyi = 0; dyi < SIDE; ++dyi) {
        const int corner = (dyi == 0 || dyi == SIDE - 1) ? 1 : 0;
        n += ubase[dyi * UNION_W + i + SIDE - corner] - ubase[dyi * UNION_W + i + corner];
      }
      return n;
    };
    int nmax = 0;
    for (int i = 0; i < nq; ++i) {
      if (qbase[i + 1] > qbase[i]) nmax = max(nmax, ring_count(i));
    }
    // L lanes a query slot, a power of two, so that a group never straddles
    // a warp: as many as keep every thread busy, one when the slots
    // outnumber the threads; where the union is staged whole and a query's
    // candidates fit HELD registers of its lanes, at least as many as that
    // takes, so that its d2 patterns are formed once and every later scan
    // reads registers
    int L = 32;
    while (L > 1 && L * nitems > THREADS) L >>= 1;
    const bool held = single && nmax <= 32 * HELD;
    if (held) {
      while (L * HELD < nmax) L <<= 1;
    }
    const int ngroups = THREADS / L;
    const int sub = tid & (L - 1);
    const int grp = tid / L;
    const unsigned gmask = L == 32 ? FULL : ((1u << L) - 1u) << (lane & ~(L - 1));
    const int kk = k + 1;  // the query's own slot is a candidate at d2 = 0

    for (int base = 0; base < nitems; base += ngroups) {
      const int item = base + grp;
      int i = 0;
      while (i + 1 < STRIP && qbase[i + 1] <= item) ++i;
      const int s = item - qbase[i];
      const size_t o = static_cast<size_t>(q0 + i) * cap + s;
      float qx = F32_MAX, qy = 0.0f, qz = 0.0f;
      if (item < nitems) {
        const size_t a = static_cast<size_t>(row0 + q0 + i + off) * cap + s;
        qx = xs[a];
        if (qx < HALF_MAX) {
          qy = ys[a];
          qz = zs[a];
        } else if (sub == 0) {  // an empty slot below the column's bound
          sums[o] = 0.0f;
          kth[o] = F32_MAX;
        }
      }
      Phase phase = qx < HALF_MAX ? FIRST : DONE;
      int mid = MAX_BITS, lo = 0, hi = 0, nfin = 0, kb = 0, scans = 0;
      int c_lo = 0, c_hi = 0;  // count(< lo), count(<= hi)
      bool halve = false;      // the next step halves the bracket
      double scale = 0.0;
      // held: candidate j of the query's 9 ranges in order, j = t * L + sub, in d[t]
      int d[HELD];
      if (held && phase != DONE) {
        int cum[SIDE + 1], start[SIDE];  // range r: held j in [cum[r], cum[r+1]), from stage[start[r]]
        cum[0] = 0;
#pragma unroll
        for (int dyi = 0; dyi < SIDE; ++dyi) {
          const int corner = (dyi == 0 || dyi == SIDE - 1) ? 1 : 0;
          start[dyi] = ubase[dyi * UNION_W + i + corner];
          cum[dyi + 1] = cum[dyi] + ubase[dyi * UNION_W + i + SIDE - corner] - start[dyi];
        }
#pragma unroll
        for (int t = 0; t < HELD; ++t) {
          const int j = t * L + sub;
          int at = start[0];
#pragma unroll
          for (int r = 1; r < SIDE; ++r) {
            if (j >= cum[r]) at = start[r] - cum[r];
          }
          d[t] = j < cum[SIDE] ? d2_bits(stage[at + j], qx, qy, qz) : INT_MAX;
        }
      }
      while (true) {
        Acc a = {0, -1, INT_MAX, 0};
        if (held) {
          if (phase == SUM) {
            scan_held<true>(d, mid, scale, a);
          } else if (phase != DONE) {
            scan_held<false>(d, mid, scale, a);
          }
        } else {
          for (int c0 = 0; c0 < ncand; c0 += stage_cap) {
            const int c1 = min(c0 + stage_cap, ncand);
            if (!single) {
              __syncthreads();  // every group is done with the previous pass
              stage_pass(c0, c1);
              __syncthreads();
            }
            if (phase == SUM) {
              scan_stage<true>(stage, ubase, i, c0, c1, sub, L, qx, qy, qz, mid, scale, a);
            } else if (phase != DONE) {
              scan_stage<false>(stage, ubase, i, c0, c1, sub, L, qx, qy, qz, mid, scale, a);
            }
          }
        }
        if (phase != DONE) {
          for (int w = L / 2; w > 0; w >>= 1) {
            a.cnt += __shfl_xor_sync(gmask, a.cnt, w);
            a.below = max(a.below, __shfl_xor_sync(gmask, a.below, w));
            a.above = min(a.above, __shfl_xor_sync(gmask, a.above, w));
            a.sum += __shfl_xor_sync(gmask, a.sum, w);
          }
          ++scans;
          if (phase == SUM) {
            if (sub == 0) {
              const double s_below = static_cast<double>(a.sum) / scale;
              if (nfin < kk) {
                sums[o] = static_cast<float>(s_below);
                kth[o] = F32_MAX;
              } else {
                const float kd = __fsqrt_rn(__int_as_float(kb));
                sums[o] = static_cast<float>(s_below + static_cast<double>(kk - a.cnt) * static_cast<double>(kd));
                kth[o] = kd;
              }
              if (prof != nullptr) {
                atomicAdd(&prof[5], static_cast<unsigned long long>(scans));
                atomicAdd(&prof[6], 1ull);
              }
            }
            phase = DONE;
          } else {
            // the bracket [lo, hi] holds the (k+1)-th smallest pattern and
            // only values that occur: c_lo = count(< lo) < kk <= count(<= hi) = c_hi
            const int span = c_hi - c_lo;
            if (phase == FIRST) {
              nfin = a.cnt;
              hi = a.below;
              c_hi = a.cnt;
            } else if (a.cnt >= kk) {
              hi = a.below;
              c_hi = a.cnt;
              if (a.cnt == kk) lo = hi;
            } else {
              lo = a.above;
              c_lo = a.cnt;
            }
            // a step that did not halve the candidates in the bracket is
            // followed by one that halves the bracket
            halve = phase == BISECT && !halve && 2 * (c_hi - c_lo) > span;
            if (phase == FIRST && nfin < kk) {
              scale = sum_scale(hi);
              phase = SUM;  // fewer than k: the sum over every finite d2
            } else if (lo == hi) {
              kb = lo;
              scale = sum_scale(kb);
              mid = kb - 1;  // the sum scan: count(< kth) and their distances
              phase = SUM;
            } else {
              // the next mid: on a surface count(d2 <= v) grows about
              // linearly in v, so interpolate the value where the count
              // reaches kk (about 7 scans a query in all on the bench
              // planes, which chip_smoke.py phase 7 counts); any mid in
              // [lo, hi) keeps the bracket
              const float lv = __int_as_float(lo), hv = __int_as_float(hi);
              const float mv =
                  lv + (hv - lv) * (static_cast<float>(kk - c_lo) - 0.5f) / static_cast<float>(c_hi - c_lo);
              mid = halve ? lo + ((hi - lo) >> 1) : min(max(__float_as_int(mv), lo), hi - 1);
              phase = BISECT;
            }
          }
        }
        if (single ? phase == DONE : !__syncthreads_or(phase != DONE)) break;
      }
    }
  }
  if (prof != nullptr) {
    __syncthreads();
    if (tid == 0) {
      const long long t3 = clock64();
      atomicAdd(&prof[1], static_cast<unsigned long long>(t1 - t0));
      atomicAdd(&prof[2], static_cast<unsigned long long>(t2 - t1));
      atomicAdd(&prof[3], static_cast<unsigned long long>(t3 - t2));
      atomicAdd(&prof[4], 1ull);
      if (!single) atomicAdd(&prof[7], 1ull);
    }
  }
}

}  // namespace

// stage: candidates staged per pass (ops/cols_select.py:select_plan), at
// most STAGE_MAX; the launch takes stage * 16 bytes of dynamic shared
// memory.  bounds: nrows + 2 * (4 * gz + 4) ints of scratch.  prof: null,
// or 8 zeroed 64-bit words the launches add their profile to.
extern "C" int cwipc_cols_select(const float* xs, const float* ys, const float* zs, int cap, int gz,
                                 int k, int row0, int nrows, int stage, int* bounds, float* sums,
                                 float* kth, unsigned long long* prof, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (cap < 1 || k < 1 || k == INT_MAX || gz < 1 || row0 < 0 || nrows < 0 || stage < 1 ||
      stage > STAGE_MAX || static_cast<long long>(NU) * cap > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nrows == 0) return 0;
  const int nb = nrows + 2 * (M * gz + M);
  column_bounds<<<(nb + WARPS - 1) / WARPS, THREADS, 0, stream>>>(xs, cap, row0, nb, bounds, prof);
  CWIPC_RETURN_IF_ERROR();
  cols_select_strip<<<(nrows + STRIP - 1) / STRIP, THREADS, static_cast<size_t>(stage) * sizeof(float4),
                      stream>>>(xs, ys, zs, cap, gz, k, row0, nrows, bounds, nb, stage, sums, kth, prof);
  CWIPC_RETURN_IF_ERROR();
  return 0;
}
