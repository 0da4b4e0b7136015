// Kernel 2: Morton-window kNN mean distance.
//
// Replaces cwipc_util_tpu/ops/pallas_window_knn.py:_window_knn_kernel (the
// pallas_call at :203).  For each point i < count of a Morton-ordered
// cloud: the mean of the kk smallest Euclidean distances to the points
// i+w, 0 < |w| <= window, that lie in [0, count); 0 for i >= count.  A
// missing neighbour counts 0 and the divisor stays kk = min(k, 2*window),
// as in the spec, cwipc_util_tpu/ops/outliers.py:_mean_knn_dist_window.
//
// Bound on the H100: latency and memory.  It reads 12 bytes and writes 4
// per point (under 4 MB at the chain's 229,376 points); the 2W distances
// and their sort stay in registers.  One thread per point; a block stages
// its points plus a +/-window halo of x, y, z in shared memory, so each
// coordinate is read from device memory about once.  The squared distance
// is written with __fmul_rn / __fadd_rn so that nvcc does not contract it
// into FMAs: d2 = (dx*dx + dy*dy) + dz*dz, rounded as the XLA spec rounds
// it.  The TPU kernel packed a row index into the 6 low mantissa bits of
// d2 to make its selection keys unique; here a bitonic network sorts the
// exact values in registers (2W <= 64), and the square roots are summed in
// ascending order, as the spec's sort-then-sum does.
#include <cuda_runtime.h>

#include "scan.cuh"  // CWIPC_RETURN_IF_ERROR

namespace {

constexpr int BLOCK = 256;
constexpr int MAX_WINDOW = 32;
constexpr float F32_MAX = 3.402823466e+38f;

// NP: the sorting network's width, a power of two >= 2 * window.
template <int NP>
__global__ void __launch_bounds__(BLOCK)
window_knn(const float* __restrict__ x, const float* __restrict__ y, const float* __restrict__ z,
           const int* __restrict__ count_ptr, int n, int window, int kk, float* __restrict__ md) {
  __shared__ float sx[BLOCK + 2 * MAX_WINDOW];
  __shared__ float sy[BLOCK + 2 * MAX_WINDOW];
  __shared__ float sz[BLOCK + 2 * MAX_WINDOW];
  const int count = *count_ptr;
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
  if (i >= n) return;
  if (i >= count) {
    md[i] = 0.0f;
    return;
  }
  const int c = threadIdx.x + window;  // the point's slot in shared memory
  const float px = sx[c], py = sy[c], pz = sz[c];

  float d[NP];
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    d[j] = F32_MAX;
    if (j < 2 * window) {
      const int w = j < window ? j - window : j - window + 1;  // skips w == 0
      const int nb = i + w;
      if (nb >= 0 && nb < count) {
        const float dx = __fsub_rn(px, sx[c + w]);
        const float dy = __fsub_rn(py, sy[c + w]);
        const float dz = __fsub_rn(pz, sz[c + w]);
        d[j] = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      }
    }
  }

  // bitonic sort, ascending; every index is a compile-time constant after
  // unrolling, so d stays in registers
#pragma unroll
  for (int size = 2; size <= NP; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
#pragma unroll
      for (int a = 0; a < NP; ++a) {
        const int b = a ^ stride;
        if (b > a) {
          const float lo = fminf(d[a], d[b]);
          const float hi = fmaxf(d[a], d[b]);
          const bool up = (a & size) == 0;
          d[a] = up ? lo : hi;
          d[b] = up ? hi : lo;
        }
      }
    }
  }

  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    if (j < kk && d[j] < 0.5f * F32_MAX) s = __fadd_rn(s, __fsqrt_rn(d[j]));
  }
  md[i] = __fdiv_rn(s, static_cast<float>(kk));
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
    window_knn<16><<<blocks, BLOCK, 0, stream>>>(x, y, z, count, n, window, kk, md);
  } else if (window <= 16) {
    window_knn<32><<<blocks, BLOCK, 0, stream>>>(x, y, z, count, n, window, kk, md);
  } else {
    window_knn<64><<<blocks, BLOCK, 0, stream>>>(x, y, z, count, n, window, kk, md);
  }
  CWIPC_RETURN_IF_ERROR();
  return 0;
}
