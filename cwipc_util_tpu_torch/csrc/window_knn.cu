// Kernel 2: Morton-window kNN mean distance.
//
// Replaces cwipc_util_tpu/ops/pallas_window_knn.py:_window_knn_kernel (the
// pallas_call at :203).  For each point i < count of a Morton-ordered
// cloud: the mean of the kk smallest Euclidean distances to the points
// i+w, 0 < |w| <= window, that lie in [0, count); 0 for i >= count.  A
// missing neighbour counts 0 and the divisor stays kk = min(k, 2*window),
// as in the spec, cwipc_util_tpu/ops/outliers.py:_mean_knn_dist_window.
//
// Bound on the H100: memory by the bytes (12 read and 4 written a point,
// under 4 MB at the chain's 229,376 points), the instruction rate in practice: the 2W
// distances and their selection stay in registers, one thread a point.  A
// block stages its points plus a +/-window halo of x, y, z in shared
// memory, so each coordinate is read from device memory about once.  The
// squared distance is written with __fmul_rn / __fadd_rn so that nvcc does
// not contract it into FMAs: d2 = (dx*dx + dy*dy) + dz*dz, rounded as the
// XLA spec rounds it.  The TPU kernel packed a row index into the 6 low
// mantissa bits of d2 to make its keys unique; here the selection works on
// the exact values, in the reference kernel's two regimes (drop = 2W - kk):
//   * drop <= DROP_MAX (the fast chain: W 16, k 30, drop 2): drop
//     max-passes each remove exactly one largest value (the lowest index
//     among equals), so exactly drop values go whatever the ties and the
//     missing neighbours (F32_MAX) go first; the rest are summed in index
//     order.  A pass is NP - 1 max operations in a tree, NP compares into
//     a bit mask and NP selects: about 4 NP operations, 256 for the chain's
//     two passes at NP 32, where a bitonic sort of the 32 values takes 240
//     compare-exchanges (480 min/max).
//   * otherwise (the window method's default: W 32, k 30, kk 30 of 64):
//     keep the kk smallest with a bitonic merge-and-keep-lower network.
//     Chunks of P (the power of two >= kk) are sorted in alternating
//     directions, each ascending chunk keeps the elementwise minimum of
//     itself and its descending neighbour (the P smallest of the two, as a
//     bitonic sequence) and is merged back into order, until one chunk
//     holds the P smallest in ascending order; the first kk are summed in
//     that order.  At W 32, k 30: two sorts of 32 (2 x 240 compare-
//     exchanges), 32 minima and one merge of 32 (80): 592, against 672
//     for the full sort of 64.  A count-bisection on the d2 bit patterns,
//     as the reference does, takes 31 counts of 64 values (about 4,000
//     operations) and is not used.
// Only the order of the final sum of square roots can differ from the
// spec (index order in the drop regime), so kernel and spec agree within
// float32 allclose.
#include <cuda_runtime.h>

#include <type_traits>

#include "scan.cuh"  // CWIPC_RETURN_IF_ERROR

namespace {

constexpr int BLOCK = 256;
constexpr int MAX_WINDOW = 32;
constexpr int DROP_MAX = 6;  // the reference kernel's bound on max-passes
constexpr float F32_MAX = 3.402823466e+38f;
constexpr float HALF_MAX = 0.5f * F32_MAX;

// Stage the block's points and their +/-window halo, and fill d[0, 2W)
// with the point's squared distances to i+w (w = -W..-1, 1..W; F32_MAX
// where i+w is outside [0, count)) and d[2W, NP) with pad.  Returns false
// for the threads that have no point.
template <int NP>
__device__ __forceinline__ bool window_d2(const float* __restrict__ x, const float* __restrict__ y,
                                          const float* __restrict__ z, int count, int n, int window, float pad,
                                          float (&d)[NP], float* __restrict__ md) {
  __shared__ float sx[BLOCK + 2 * MAX_WINDOW];
  __shared__ float sy[BLOCK + 2 * MAX_WINDOW];
  __shared__ float sz[BLOCK + 2 * MAX_WINDOW];
  const int base = blockIdx.x * BLOCK;
  for (int t = threadIdx.x; t < BLOCK + 2 * window; t += BLOCK) {
    const int g = base - window + t;
    const bool in = g >= 0 && g < n;
    sx[t] = in ? x[g] : 0.0f;
    sy[t] = in ? y[g] : 0.0f;
    sz[t] = in ? z[g] : 0.0f;
  }
  __syncthreads();
  const int i = base + threadIdx.x;
  if (i >= n) return false;
  if (i >= count) {
    md[i] = 0.0f;
    return false;
  }
  const int c = threadIdx.x + window;  // the point's slot in shared memory
  const float px = sx[c], py = sy[c], pz = sz[c];
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    d[j] = pad;
    if (j < 2 * window) {
      const int w = j < window ? j - window : j - window + 1;  // skips w == 0
      const int nb = i + w;
      d[j] = F32_MAX;
      if (nb >= 0 && nb < count) {
        const float dx = __fsub_rn(px, sx[c + w]);
        const float dy = __fsub_rn(py, sy[c + w]);
        const float dz = __fsub_rn(pz, sz[c + w]);
        d[j] = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      }
    }
  }
  return true;
}

template <int NP>
using Mask = typename std::conditional<(NP > 32), unsigned long long, unsigned>::type;

// drop <= DROP_MAX: remove the drop largest, sum the square roots of the rest
template <int NP>
__global__ void __launch_bounds__(BLOCK)
window_knn_drop(const float* __restrict__ x, const float* __restrict__ y, const float* __restrict__ z,
                const int* __restrict__ count_ptr, int n, int window, int kk, float* __restrict__ md) {
  float d[NP];
  // padding reads as already removed: below every distance
  if (!window_d2<NP>(x, y, z, *count_ptr, n, window, -1.0f, d, md)) return;
  const int drop = 2 * window - kk;
#pragma unroll 1
  for (int p = 0; p < drop; ++p) {
    float m[NP / 2];
#pragma unroll
    for (int j = 0; j < NP / 2; ++j) m[j] = fmaxf(d[j], d[j + NP / 2]);
#pragma unroll
    for (int s = NP / 4; s > 0; s >>= 1) {
#pragma unroll
      for (int j = 0; j < s; ++j) m[j] = fmaxf(m[j], m[j + s]);
    }
    Mask<NP> hit = 0;
#pragma unroll
    for (int j = 0; j < NP; ++j) hit |= static_cast<Mask<NP>>(d[j] == m[0]) << j;
    hit &= ~hit + 1;  // the lowest index among equals
#pragma unroll
    for (int j = 0; j < NP; ++j) d[j] = (hit >> j) & 1 ? -1.0f : d[j];
  }
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    if (d[j] >= 0.0f && d[j] < HALF_MAX) s = __fadd_rn(s, __fsqrt_rn(d[j]));
  }
  md[blockIdx.x * BLOCK + threadIdx.x] = __fdiv_rn(s, static_cast<float>(kk));
}

__device__ __forceinline__ void exchange(float& a, float& b, bool up) {
  const float lo = fminf(a, b);
  const float hi = fmaxf(a, b);
  a = up ? lo : hi;
  b = up ? hi : lo;
}

// drop > DROP_MAX: keep the P smallest (P the power of two >= kk) with a
// merge-and-keep-lower network, sum the first kk in ascending order
template <int NP, int P>
__global__ void __launch_bounds__(BLOCK)
window_knn_select(const float* __restrict__ x, const float* __restrict__ y, const float* __restrict__ z,
                  const int* __restrict__ count_ptr, int n, int window, int kk, float* __restrict__ md) {
  float d[NP];
  // padding sorts last, as a missing neighbour does
  if (!window_d2<NP>(x, y, z, *count_ptr, n, window, F32_MAX, d, md)) return;
  // bitonic sort of each chunk of P, ascending for even chunks; every
  // index is a compile-time constant after unrolling, so d stays in
  // registers
#pragma unroll
  for (int size = 2; size <= P; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
#pragma unroll
      for (int a = 0; a < NP; ++a) {
        if ((a ^ stride) > a) exchange(d[a], d[a ^ stride], (a & size) == 0);
      }
    }
  }
  // keep the lower P of each pair of chunks, span apart, and merge them
  // back into order: ascending where the next level keeps them
#pragma unroll
  for (int span = P; span < NP; span <<= 1) {
#pragma unroll
    for (int a = 0; a < NP; ++a) {
      if ((a & (2 * span - 1)) < P) d[a] = fminf(d[a], d[a + span]);
    }
#pragma unroll
    for (int stride = P >> 1; stride > 0; stride >>= 1) {
#pragma unroll
      for (int a = 0; a < NP; ++a) {
        if ((a & (2 * span - 1)) < P && (a ^ stride) > a) exchange(d[a], d[a ^ stride], (a & (2 * span)) == 0);
      }
    }
  }
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    if (j < kk && d[j] < HALF_MAX) s = __fadd_rn(s, __fsqrt_rn(d[j]));
  }
  md[blockIdx.x * BLOCK + threadIdx.x] = __fdiv_rn(s, static_cast<float>(kk));
}

// the select kernel for the chunk P (a power of two, 1 <= p <= NP)
template <int NP, int P>
void launch_select(int p, int blocks, cudaStream_t stream, const float* x, const float* y, const float* z,
                   const int* count, int n, int window, int kk, float* md) {
  if constexpr (P > 1) {
    if (p < P) return launch_select<NP, P / 2>(p, blocks, stream, x, y, z, count, n, window, kk, md);
  }
  window_knn_select<NP, P><<<blocks, BLOCK, 0, stream>>>(x, y, z, count, n, window, kk, md);
}

// NP: the selection's width, a power of two >= 2 * window
template <int NP>
void launch(int blocks, cudaStream_t stream, const float* x, const float* y, const float* z, const int* count,
            int n, int window, int kk, float* md) {
  if (2 * window - kk <= DROP_MAX) {
    window_knn_drop<NP><<<blocks, BLOCK, 0, stream>>>(x, y, z, count, n, window, kk, md);
  } else {
    int p = 1;
    while (p < kk) p <<= 1;
    launch_select<NP, NP>(p, blocks, stream, x, y, z, count, n, window, kk, md);
  }
}

}  // namespace

extern "C" int cwipc_window_knn(const float* x, const float* y, const float* z, const int* count,
                                int n, int window, int kk, float* md, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (window < 1 || window > MAX_WINDOW || kk < 1 || kk > 2 * window) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const int blocks = (n + BLOCK - 1) / BLOCK;
  if (window <= 8) {
    launch<16>(blocks, stream, x, y, z, count, n, window, kk, md);
  } else if (window <= 16) {
    launch<32>(blocks, stream, x, y, z, count, n, window, kk, md);
  } else {
    launch<64>(blocks, stream, x, y, z, count, n, window, kk, md);
  }
  CWIPC_RETURN_IF_ERROR();
  return 0;
}
