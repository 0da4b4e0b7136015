// Kernel 7: the selection scan probe.
//
// Replaces benchmarks/sel_roofline.py:_scan_kernel (the pallas_call at :114,
// program _scan_program :112), the TPU's micro-kernel for the "compare and
// count" scan that kernel 4's bisection is built on.  For each column j of
// x [S, C] (C a multiple of 128) and each step t = 0..T-1 in order:
//   i32   count of x <= t*65537+12345           (int32 input)
//   i16   count of x <= int16(t*17+11)           (int16 input)
//   bf16  count of x <= bf16(f32(t)*0.001+0.5)   (bfloat16 input)
//   mxu   the i32 count, computed on the tensor cores
//   add   the column's int32 sum, wrapping
// added to an f32 accumulator in step order; out [8, C] holds it in every
// row.  Counts here are exact integers.  (The TPU kernel sums the bf16
// indicator in bf16, which rounds above 256; at the CPU tests' S = 64 both
// are exact, and at S = 1536 only this kernel and its plain version agree.)
//
// Bound on the H100 (chip_smoke.py's count): operations, one INT32 issue
// per element and step (805,306,368 element-steps at S 1536, T 64, 64
// tiles) over the INT32 issue rate, 64 lanes x 132 SMs x the SM clock; the
// i32 input read once is 50 MB, 15 us at 3.35 TB/s.  Each element-step
// does a compare and an add, so the count is a lower bound on the issues.
//
// Design: every thread loads its elements into registers once and runs all
// T steps on them, so the card reads x once.  The CUDA-core forms give a
// thread 16 rows of one column (four threads a column, 64 rows a block);
// an empty asm marks the registers as changed every step, so the compiler
// cannot hoist a step's work out of the loop (the TPU kernel multiplies by
// t*0+1 for the same reason).  The mxu form gives each warp an 8-column
// strip of 64 rows and issues mma.sync m16n8k16 (f16 in, f32 out) with a
// ones matrix as A and the 0/1 indicator as B, built in the registers that
// hold the B fragment; a column's count is any row of D.  A block's counts
// per step go through shared memory to one integer atomic per column and
// step in a [T, C] buffer (exact in any order); a last launch accumulates
// them in f32 in step order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "scan.cuh"

namespace {

constexpr int FORM_I32 = 0, FORM_I16 = 1, FORM_BF16 = 2, FORM_MXU = 3, FORM_ADD = 4;
constexpr int COLS = 128;        // columns a block covers (a TPU block's lanes)
constexpr int TCHUNK = 64;       // steps whose counts a block holds at once
constexpr int ROW_GROUPS = 4;    // CUDA-core forms: threads a column
constexpr int ROWS_PER_THREAD = 16;
constexpr int CORE_ROWS = ROW_GROUPS * ROWS_PER_THREAD;
constexpr int MXU_WARPS = COLS / 8;  // mxu: one warp an 8-column strip
constexpr int MXU_CHUNKS = 4;        // 16-row k chunks a warp holds
constexpr int MXU_ROWS = 16 * MXU_CHUNKS;

__device__ __forceinline__ int mid_i32(int t) {
  return static_cast<int>(static_cast<unsigned>(t) * 65537u + 12345u);  // wraps as int32 does
}

__device__ __forceinline__ int mid_i16(int t) {
  return static_cast<short>(static_cast<unsigned short>(static_cast<unsigned>(t) * 17u + 11u));
}

__device__ __forceinline__ float mid_bf16(int t) {
  // rounded op by op, as XLA and PyTorch compute f32(t) * 0.001 + 0.5
  const float m = __fadd_rn(__fmul_rn(static_cast<float>(t), 0.001f), 0.5f);
  return __bfloat162float(__float2bfloat16_rn(m));
}

template <int FORM>
using value_t = typename std::conditional<FORM == FORM_BF16, float, int>::type;

template <int FORM>
__device__ __forceinline__ value_t<FORM> load_value(const void* x, size_t i) {
  if constexpr (FORM == FORM_I16) {
    return static_cast<const short*>(x)[i];
  } else if constexpr (FORM == FORM_BF16) {
    return __uint_as_float(static_cast<unsigned>(static_cast<const unsigned short*>(x)[i]) << 16);
  } else {
    return static_cast<const int*>(x)[i];
  }
}

__device__ __forceinline__ void opaque(int& v) { asm volatile("" : "+r"(v)); }
__device__ __forceinline__ void opaque(float& v) { asm volatile("" : "+f"(v)); }

// One step's contribution of a thread's rows: a count, or the wrapping sum.
template <int FORM, bool MASKED>
__device__ __forceinline__ unsigned step_value(value_t<FORM> (&v)[ROWS_PER_THREAD], int live, int t) {
  unsigned acc = 0;
#pragma unroll
  for (int k = 0; k < ROWS_PER_THREAD; ++k) {
    opaque(v[k]);
    const bool in = !MASKED || k < live;
    if constexpr (FORM == FORM_ADD) {
      acc += in ? static_cast<unsigned>(v[k]) : 0u;
    } else if constexpr (FORM == FORM_I32) {
      acc += in && v[k] <= mid_i32(t);
    } else if constexpr (FORM == FORM_I16) {
      acc += in && v[k] <= mid_i16(t);
    } else {
      acc += in && v[k] <= mid_bf16(t);
    }
  }
  return acc;
}

// Adds a block's [tn, COLS] step counts into cnt [T, c].
__device__ __forceinline__ void flush_counts(const int (&s_cnt)[TCHUNK][COLS], int t0, int tn, int c,
                                             int* __restrict__ cnt) {
  for (int j = threadIdx.x; j < tn * COLS; j += blockDim.x) {
    atomicAdd(&cnt[static_cast<size_t>(t0 + j / COLS) * c + blockIdx.x * COLS + j % COLS],
              s_cnt[j / COLS][j % COLS]);
  }
}

template <int FORM>
__global__ void __launch_bounds__(COLS * ROW_GROUPS)
scan_cores(const void* __restrict__ x, int s, int c, int t_steps, int* __restrict__ cnt) {
  __shared__ int s_cnt[TCHUNK][COLS];
  const int col_l = threadIdx.x % COLS;
  const int col = blockIdx.x * COLS + col_l;
  const int row0 = blockIdx.y * CORE_ROWS + (threadIdx.x / COLS) * ROWS_PER_THREAD;
  const int live = min(max(s - row0, 0), ROWS_PER_THREAD);
  const bool full = (static_cast<int>(blockIdx.y) + 1) * CORE_ROWS <= s;  // the same for the whole block
  value_t<FORM> v[ROWS_PER_THREAD];
#pragma unroll
  for (int k = 0; k < ROWS_PER_THREAD; ++k) {
    v[k] = k < live ? load_value<FORM>(x, static_cast<size_t>(row0 + k) * c + col) : value_t<FORM>(0);
  }
  for (int t0 = 0; t0 < t_steps; t0 += TCHUNK) {
    const int tn = min(TCHUNK, t_steps - t0);
    for (int j = threadIdx.x; j < TCHUNK * COLS; j += blockDim.x) s_cnt[j / COLS][j % COLS] = 0;
    __syncthreads();
    for (int tt = 0; tt < tn; ++tt) {
      const unsigned a = full ? step_value<FORM, false>(v, live, t0 + tt)
                              : step_value<FORM, true>(v, live, t0 + tt);
      atomicAdd(&s_cnt[tt][col_l], static_cast<int>(a));
    }
    __syncthreads();
    flush_counts(s_cnt, t0, tn, c, cnt);
    __syncthreads();  // s_cnt is cleared for the next chunk
  }
}

__global__ void __launch_bounds__(MXU_WARPS * 32)
scan_mxu(const int* __restrict__ x, int s, int c, int t_steps, int* __restrict__ cnt) {
  __shared__ int s_cnt[TCHUNK][COLS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gid = lane >> 2;  // the B fragment's column (n)
  const int tig = lane & 3;   // its rows (k): 2*tig, 2*tig+1, 2*tig+8, 2*tig+9
  const int col = blockIdx.x * COLS + warp * 8 + gid;
  const int row_base = blockIdx.y * MXU_ROWS;
  int v[MXU_CHUNKS][4];
  bool in[MXU_CHUNKS][4];
#pragma unroll
  for (int j = 0; j < MXU_CHUNKS; ++j) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int row = row_base + 16 * j + 2 * tig + (q & 1) + (q >> 1) * 8;
      in[j][q] = row < s;
      v[j][q] = in[j][q] ? x[static_cast<size_t>(row) * c + col] : 0;
    }
  }
  const unsigned ones = 0x3C003C00u;  // two f16 1.0s: every A fragment register
  for (int t0 = 0; t0 < t_steps; t0 += TCHUNK) {
    const int tn = min(TCHUNK, t_steps - t0);
    for (int tt = 0; tt < tn; ++tt) {
      const int mid = mid_i32(t0 + tt);
      float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;
#pragma unroll
      for (int j = 0; j < MXU_CHUNKS; ++j) {
        unsigned b[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          opaque(v[j][2 * h]);
          opaque(v[j][2 * h + 1]);
          const unsigned lo = (in[j][2 * h] && v[j][2 * h] <= mid) ? 0x3C00u : 0u;
          const unsigned hi = (in[j][2 * h + 1] && v[j][2 * h + 1] <= mid) ? 0x3C000000u : 0u;
          b[h] = lo | hi;
        }
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
            "{%0, %1, %2, %3}, {%4, %4, %4, %4}, {%5, %6}, {%0, %1, %2, %3};\n"
            : "+f"(d0), "+f"(d1), "+f"(d2), "+f"(d3)
            : "r"(ones), "r"(b[0]), "r"(b[1]));
      }
      if (gid == 0) {  // D row 0: columns 2*tig and 2*tig+1 of the strip; each column written once
        s_cnt[tt][warp * 8 + 2 * tig] = __float2int_rn(d0);
        s_cnt[tt][warp * 8 + 2 * tig + 1] = __float2int_rn(d1);
      }
    }
    __syncthreads();
    flush_counts(s_cnt, t0, tn, c, cnt);
    __syncthreads();  // s_cnt is rewritten by the next chunk
  }
}

__global__ void scan_finish(const int* __restrict__ cnt, int c, int t_steps, float* __restrict__ out) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= c) return;
  float acc = 0.f;
  for (int t = 0; t < t_steps; ++t) acc = __fadd_rn(acc, __int2float_rn(cnt[static_cast<size_t>(t) * c + col]));
#pragma unroll
  for (int r = 0; r < 8; ++r) out[r * c + col] = acc;
}

}  // namespace

// x [s, c] row-major (int32, int16 or bf16 by form), c a multiple of 128;
// cnt [t_steps, c] int scratch; out [8, c] f32.
extern "C" int cwipc_scan_probe(const void* x, int form, int s, int c, int t_steps, int* cnt, float* out,
                                void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (c % COLS != 0 || form < FORM_I32 || form > FORM_ADD) return static_cast<int>(cudaErrorInvalidValue);
  if (c == 0) return 0;
  cudaMemsetAsync(cnt, 0, sizeof(int) * static_cast<size_t>(t_steps) * c, stream);
  CWIPC_RETURN_IF_ERROR();
  if (s > 0 && t_steps > 0) {
    const dim3 cores(c / COLS, (s + CORE_ROWS - 1) / CORE_ROWS);
    const int threads = COLS * ROW_GROUPS;
    switch (form) {
      case FORM_I32: scan_cores<FORM_I32><<<cores, threads, 0, stream>>>(x, s, c, t_steps, cnt); break;
      case FORM_I16: scan_cores<FORM_I16><<<cores, threads, 0, stream>>>(x, s, c, t_steps, cnt); break;
      case FORM_BF16: scan_cores<FORM_BF16><<<cores, threads, 0, stream>>>(x, s, c, t_steps, cnt); break;
      case FORM_ADD: scan_cores<FORM_ADD><<<cores, threads, 0, stream>>>(x, s, c, t_steps, cnt); break;
      default:
        scan_mxu<<<dim3(c / COLS, (s + MXU_ROWS - 1) / MXU_ROWS), MXU_WARPS * 32, 0, stream>>>(
            static_cast<const int*>(x), s, c, t_steps, cnt);
    }
    CWIPC_RETURN_IF_ERROR();
  }
  scan_finish<<<(c + 255) / 256, 256, 0, stream>>>(cnt, c, t_steps, out);
  CWIPC_RETURN_IF_ERROR();
  return 0;
}
