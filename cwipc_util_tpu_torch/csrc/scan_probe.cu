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
// indicator in bf16, which rounds above 256; at the CPU tests' S <= 256
// both are exact, and at S = 1536 only this kernel and its plain version
// agree.)
//
// Bound on the H100 (chip_smoke.py's count): operations, one INT32 issue
// per element and step (805,306,368 element-steps at S 1536, T 64, 64
// tiles) over the INT32 issue rate, 64 lanes x 132 SMs x the SM clock, for
// the count forms; half an issue for add (IADD3 adds two elements).  The
// i32 input read once is 50 MB, 15 us at 3.35 TB/s.  mxu builds its
// indicator on the CUDA cores, so its bound is the same INT32 issue per
// element-step (its tensor-core work is 1/256 of an MMA per element-step).
//
// Design: one launch, no atomics, no scratch.  A warp covers a strip of 8
// columns: lane / 4 is the column, lane % 4 its row lane, and a thread
// holds ROWS rows of its column in registers (a row block of 4 * ROWS rows
// a warp; each row of a load is 32 contiguous bytes).  A block holds whole
// strips over all S rows: the strip's warps (warps_per_strip) take its row
// blocks in turn, and the block combines their sums in shared memory and
// writes its 8 output rows itself.  Rows past S hold a value below every
// threshold (every count takes them at every step; the block subtracts
// them) or 0 (add).  An empty asm marks each register as changed at every
// step, so the front end cannot fold the step loop (the TPU kernel
// multiplies by t*0+1 for the same reason).  ptxas does not see that asm:
// the counts cannot be hoisted, as the threshold changes every step, and
// add starts its sum from t & zero (a 0 the compiler cannot see).
//
// Two paths, chosen on the host (ops/scan_probe.py scan_plan):
// * total (count forms and mxu, S*T <= 2^24): the plain version's f32
//   accumulator then only adds integers to integers below 2^24, so it
//   equals the integer total of the per-step counts converted once.  Each
//   thread carries its total across all T steps in registers: per element-
//   step a compare (setp) and a predicated f32 add of 1.0 on the FMA pipe
//   (four counters, flushed into an integer every FLUSH_STEPS steps, so
//   each stays below 2^24); the next row block is loaded while this one is
//   scanned.  mxu builds four byte indicators a register (four compares, a
//   select and three predicated adds) and issues mma.sync m16n8k32 (s8
//   ones x the indicators, s32 accumulators), which sums its columns
//   exactly across all steps.
// * per step (add, and every form where S*T > 2^24): after each step the
//   4 row lanes of a column are summed by shuffles (mxu: the D fragment
//   already holds the column), the warp keeps its per-step sums for
//   STEP_CHUNK steps in shared memory, the strip's warps' sums are added
//   (integers, wrapping) and one thread a column adds them to its f32
//   accumulator in step order.  Where T > STEP_CHUNK the plan gives each
//   warp one row block if the strip has at most MAX_WARPS of them, so each
//   loads its rows once; else a warp reloads its row blocks for each chunk
//   of STEP_CHUNK steps.
//
// SASS (sm_90a, cuobjdump -sass of the built library, counted by
// cwipc_util_tpu_torch/benchmarks/scan_probe_bench.py --sass): the total
// path's step loop, 4 steps x 32 rows an iteration, is 266 instructions
// for i32, 2.08 an element-step: 129 ISETP (ALU), 128 predicated FADD (FMA
// pipe), 9 of loop and threshold; i16 270 (2.11), bf16 286 (2.23: FSETP,
// FADD and the threshold's conversions), mxu 288 (2.25: 129 ISETP, 32 SEL,
// 102 VIADD, 16 IMMA).  The per-step path: add 112 instructions for 4
// steps (0.88 an element-step: 64 IADD3, 17 IMAD, 8 SHFL, 4 LDS, 4 STS),
// the counts 2.44-2.50.  At 2.08 an element-step the issue slots, and with
// one ISETP an element-step the ALU, bound i32 at about 96 % of the INT32
// rate; it reaches 77 % (PERF.md), the rest being the first row block's
// load, the blocks' spread over the SMs and stalls between the two pipes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <type_traits>

#include "scan.cuh"

namespace {

constexpr int FORM_I32 = 0, FORM_I16 = 1, FORM_BF16 = 2, FORM_MXU = 3, FORM_ADD = 4;
constexpr int STRIP = 8;       // columns a warp covers (lane / 4)
constexpr int LANE_ROWS = 4;   // threads a column in a warp (lane % 4)
constexpr int ROWS = 32;       // rows a thread holds of a row block
constexpr int BLOCK_ROWS = LANE_ROWS * ROWS;
constexpr int MAX_WARPS = 16;  // warps a block
constexpr int STEP_CHUNK = 64;  // per-step path: steps whose sums a warp holds at once
constexpr int FLUSH_STEPS = 1 << 19;  // total path: ROWS / 4 * FLUSH_STEPS * 4 = 2^24
constexpr long long EXACT = 1LL << 24;
constexpr unsigned FULL = 0xffffffffu;

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
__device__ __forceinline__ value_t<FORM> mid_of(int t) {
  if constexpr (FORM == FORM_I16) {
    return mid_i16(t);
  } else if constexpr (FORM == FORM_BF16) {
    return mid_bf16(t);
  } else {
    return mid_i32(t);
  }
}

template <int FORM>
using elem_t = typename std::conditional<FORM == FORM_I16 || FORM == FORM_BF16, unsigned short, int>::type;

template <int FORM>
__device__ __forceinline__ value_t<FORM> widen(elem_t<FORM> e) {
  if constexpr (FORM == FORM_I16) {
    return static_cast<short>(e);
  } else if constexpr (FORM == FORM_BF16) {
    return __uint_as_float(static_cast<unsigned>(e) << 16);
  } else {
    return e;
  }
}

// What a row past S holds: below every threshold of its form, or 0 (add).
template <int FORM>
__device__ __forceinline__ value_t<FORM> pad_value() {
  if constexpr (FORM == FORM_ADD) {
    return 0;
  } else if constexpr (FORM == FORM_I16) {
    return SHRT_MIN;
  } else if constexpr (FORM == FORM_BF16) {
    return __uint_as_float(0xff800000u);  // -inf; every threshold is finite
  } else {
    return INT_MIN;
  }
}

// Row block rb of the thread's column: rows rb * BLOCK_ROWS + 4 k + g.
template <int FORM>
__device__ __forceinline__ void load_rows(value_t<FORM> (&v)[ROWS], const void* __restrict__ x, int rb, int g,
                                          int s, int c, int col) {
  const int row0 = rb * BLOCK_ROWS + g;
  const elem_t<FORM>* p = static_cast<const elem_t<FORM>*>(x) + static_cast<size_t>(row0) * c + col;
  const size_t stride = static_cast<size_t>(LANE_ROWS) * c;
  if ((rb + 1) * BLOCK_ROWS <= s) {
#pragma unroll
    for (int k = 0; k < ROWS; ++k) v[k] = widen<FORM>(p[k * stride]);
  } else {
#pragma unroll
    for (int k = 0; k < ROWS; ++k) v[k] = row0 + k * LANE_ROWS < s ? widen<FORM>(p[k * stride]) : pad_value<FORM>();
  }
}

__device__ __forceinline__ void opaque(int& v) { asm volatile("" : "+r"(v)); }
__device__ __forceinline__ void opaque(float& v) { asm volatile("" : "+f"(v)); }

// a += 1.0f where v <= mid: a compare and a predicated add on the FMA pipe.
__device__ __forceinline__ void count_le(float& a, int v, int mid) {
  asm("{\n\t.reg .pred p;\n\tsetp.le.s32 p, %1, %2;\n\t@p add.f32 %0, %0, 0f3F800000;\n\t}"
      : "+f"(a) : "r"(v), "r"(mid));
}
__device__ __forceinline__ void count_le(float& a, float v, float mid) {
  asm("{\n\t.reg .pred p;\n\tsetp.le.f32 p, %1, %2;\n\t@p add.f32 %0, %0, 0f3F800000;\n\t}"
      : "+f"(a) : "f"(v), "f"(mid));
}

// Four byte indicators v[k0 + e] <= mid, e = 0..3, one a byte: four
// compares, a zero and three predicated adds.
__device__ __forceinline__ unsigned indicators(const int (&v)[ROWS], int k0, int mid) {
  unsigned b;
  asm("{\n\t.reg .pred p0, p1, p2, p3;\n\t"
      "setp.le.s32 p0, %1, %5;\n\tsetp.le.s32 p1, %2, %5;\n\t"
      "setp.le.s32 p2, %3, %5;\n\tsetp.le.s32 p3, %4, %5;\n\t"
      "mov.b32 %0, 0;\n\t@p0 add.u32 %0, %0, 1;\n\t@p1 add.u32 %0, %0, 256;\n\t"
      "@p2 add.u32 %0, %0, 65536;\n\t@p3 add.u32 %0, %0, 16777216;\n\t}"
      : "=r"(b) : "r"(v[k0]), "r"(v[k0 + 1]), "r"(v[k0 + 2]), "r"(v[k0 + 3]), "r"(mid));
  return b;
}

// d += ones(16 x 32) x B (32 x 8), s8 in, s32 out.  B's column is the lane's
// gid = lane / 4; which of the 32 k slots a row takes does not matter, as
// every row of A is ones.  D row gid, columns 2 tig and 2 tig + 1 sit in
// d[0], d[1] (and again in d[2], d[3]).
__device__ __forceinline__ void mma_count(int (&d)[4], unsigned b0, unsigned b1) {
  const unsigned ones = 0x01010101u;
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %4, %4, %4}, {%5, %6}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(ones), "r"(b0), "r"(b1));
}

// One step of mxu over the thread's rows into d.
__device__ __forceinline__ void mxu_step(int (&v)[ROWS], int mid, int (&d)[4]) {
#pragma unroll
  for (int q = 0; q < ROWS / 8; ++q) {
#pragma unroll
    for (int e = 0; e < 8; ++e) opaque(v[8 * q + e]);
    mma_count(d, indicators(v, 8 * q, mid), indicators(v, 8 * q + 4, mid));
  }
}

// Column j's sum from the D fragment, in every lane of the column: lane
// j / 2 (gid 0) holds it in d[j % 2].
__device__ __forceinline__ int mxu_column(const int (&d)[4], int j) {
  const int c0 = __shfl_sync(FULL, d[0], j >> 1);
  const int c1 = __shfl_sync(FULL, d[1], j >> 1);
  return (j & 1) ? c1 : c0;
}

// Total path, CUDA-core forms: the thread's count over all T steps.
template <int FORM>
__device__ __forceinline__ unsigned count_steps(value_t<FORM> (&v)[ROWS], int t_steps) {
  unsigned tot = 0;
  for (int t0 = 0; t0 < t_steps; t0 += FLUSH_STEPS) {
    const int te = t_steps - t0 <= FLUSH_STEPS ? t_steps : t0 + FLUSH_STEPS;
    float a[4] = {0.f, 0.f, 0.f, 0.f};
    for (int t = t0; t < te; ++t) {
      const value_t<FORM> mid = mid_of<FORM>(t);
#pragma unroll
      for (int k = 0; k < ROWS; ++k) {
        opaque(v[k]);
        count_le(a[k & 3], v[k], mid);
      }
    }
    tot += static_cast<unsigned>(__float2int_rn((a[0] + a[1]) + (a[2] + a[3])));
  }
  return tot;
}

// Per-step path: the step's sum over the warp's row block for column j, in
// every lane of the column.  zero is 0 at run time; add starts its sum
// from t & zero, so that ptxas (which does not see the empty asm) cannot
// hoist the sum of the unchanged registers out of the step loop.
template <int FORM>
__device__ __forceinline__ unsigned step_sum(value_t<FORM> (&v)[ROWS], int t, int j, unsigned zero) {
  if constexpr (FORM == FORM_MXU) {
    int d[4] = {0, 0, 0, 0};
    mxu_step(v, mid_i32(t), d);
    return static_cast<unsigned>(mxu_column(d, j));
  } else {
    unsigned acc;
    if constexpr (FORM == FORM_ADD) {
      acc = static_cast<unsigned>(t) & zero;
#pragma unroll
      for (int k = 0; k < ROWS; ++k) {
        opaque(v[k]);
        acc += static_cast<unsigned>(v[k]);
      }
    } else {
      const value_t<FORM> mid = mid_of<FORM>(t);
      float a[2] = {0.f, 0.f};  // at most ROWS / 2 each: exact
#pragma unroll
      for (int k = 0; k < ROWS; ++k) {
        opaque(v[k]);
        count_le(a[k & 1], v[k], mid);
      }
      acc = static_cast<unsigned>(__float2int_rn(a[0] + a[1]));
    }
    acc += __shfl_xor_sync(FULL, acc, 1);
    acc += __shfl_xor_sync(FULL, acc, 2);
    return acc;
  }
}

struct Layout {
  int lane, warp, j, g, strip, wr, col;
};

__device__ __forceinline__ Layout layout(int wps) {
  Layout l;
  l.lane = threadIdx.x & 31;
  l.warp = threadIdx.x >> 5;
  l.j = l.lane >> 2;
  l.g = l.lane & 3;
  l.strip = l.warp / wps;
  l.wr = l.warp % wps;
  const int spb = static_cast<int>(blockDim.x >> 5) / wps;
  l.col = (static_cast<int>(blockIdx.x) * spb + l.strip) * STRIP + l.j;
  return l;
}

// out rows 2 g and 2 g + 1 of the thread's column.
__device__ __forceinline__ void write_out(float* __restrict__ out, int c, const Layout& l, float f) {
  out[static_cast<size_t>(2 * l.g) * c + l.col] = f;
  out[static_cast<size_t>(2 * l.g + 1) * c + l.col] = f;
}

template <int FORM>
__global__ void __launch_bounds__(MAX_WARPS * 32)
scan_total(const void* __restrict__ x, int s, int c, int t_steps, int wps, float* __restrict__ out) {
  __shared__ unsigned s_tot[MAX_WARPS][STRIP];
  const Layout l = layout(wps);
  const int nrb = (s + BLOCK_ROWS - 1) / BLOCK_ROWS;
  value_t<FORM> v[ROWS], nx[ROWS];
  unsigned tot = 0;
  int d[4] = {0, 0, 0, 0};
  if (l.wr < nrb) load_rows<FORM>(v, x, l.wr, l.g, s, c, l.col);
  for (int rb = l.wr; rb < nrb; rb += wps) {
    const bool more = rb + wps < nrb;
    if (more) load_rows<FORM>(nx, x, rb + wps, l.g, s, c, l.col);  // in flight while v is scanned
    if constexpr (FORM == FORM_MXU) {
      for (int t = 0; t < t_steps; ++t) mxu_step(v, mid_i32(t), d);
    } else {
      tot += count_steps<FORM>(v, t_steps);
    }
    if (more) {
#pragma unroll
      for (int k = 0; k < ROWS; ++k) v[k] = nx[k];
    }
  }
  unsigned part;
  if constexpr (FORM == FORM_MXU) {
    part = static_cast<unsigned>(mxu_column(d, l.j));
  } else {
    part = tot;
    part += __shfl_xor_sync(FULL, part, 1);
    part += __shfl_xor_sync(FULL, part, 2);
  }
  if (l.g == 0) s_tot[l.warp][l.j] = part;
  __syncthreads();
  if (l.wr == 0) {
    unsigned sum = 0;
    for (int q = 0; q < wps; ++q) sum += s_tot[l.warp + q][l.j];
    sum -= static_cast<unsigned>(nrb * BLOCK_ROWS - s) * static_cast<unsigned>(t_steps);  // the pad rows
    write_out(out, c, l, __int2float_rn(static_cast<int>(sum)));
  }
}

template <int FORM>
__global__ void __launch_bounds__(MAX_WARPS * 32)
scan_steps(const void* __restrict__ x, int s, int c, int t_steps, int wps, unsigned zero, float* __restrict__ out) {
  extern __shared__ unsigned s_step[];  // [warps][STEP_CHUNK][STRIP]
  const Layout l = layout(wps);
  const int nrb = (s + BLOCK_ROWS - 1) / BLOCK_ROWS;
  const unsigned pads = FORM == FORM_ADD ? 0u : static_cast<unsigned>(nrb * BLOCK_ROWS - s);
  unsigned* mine = s_step + l.warp * STEP_CHUNK * STRIP;
  unsigned* lead = s_step + l.strip * wps * STEP_CHUNK * STRIP;  // the strip's first warp's sums
  const bool once = nrb <= wps;  // one row block a warp at most: loaded once
  value_t<FORM> v[ROWS];
  if (once && l.wr < nrb) load_rows<FORM>(v, x, l.wr, l.g, s, c, l.col);
  float acc = 0.f;
  for (int t0 = 0; t0 < t_steps; t0 += STEP_CHUNK) {
    const int tn = min(STEP_CHUNK, t_steps - t0);
    bool first = true;
    for (int rb = l.wr; rb < nrb; rb += wps) {
      if (!once) load_rows<FORM>(v, x, rb, l.g, s, c, l.col);
      for (int tt = 0; tt < tn; ++tt) {
        const unsigned p = step_sum<FORM>(v, t0 + tt, l.j, zero);
        unsigned* slot = mine + tt * STRIP + l.j;  // the 4 lanes of the column store the same value
        *slot = first ? p : *slot + p;
      }
      first = false;
    }
    if (first) {
      for (int i = l.lane; i < tn * STRIP; i += 32) mine[i] = 0;
    }
    __syncthreads();
    for (int i = l.wr * 32 + l.lane; i < tn * STRIP; i += wps * 32) {
      unsigned sum = lead[i];
      for (int q = 1; q < wps; ++q) sum += lead[q * STEP_CHUNK * STRIP + i];
      lead[i] = sum;
    }
    __syncthreads();
    if (l.wr == 0 && l.g == 0) {
      for (int tt = 0; tt < tn; ++tt) {
        acc = __fadd_rn(acc, __int2float_rn(static_cast<int>(lead[tt * STRIP + l.j] - pads)));
      }
    }
    __syncthreads();  // the sums are rewritten by the next chunk
  }
  acc = __shfl_sync(FULL, acc, l.lane & ~3);
  if (l.wr == 0) write_out(out, c, l, acc);
}

template <int FORM>
void launch(const void* x, int s, int c, int t_steps, bool per_step, int wps, int spb, float* out,
            cudaStream_t stream) {
  const int warps = wps * spb;
  const dim3 grid(c / (STRIP * spb));
  if constexpr (FORM != FORM_ADD) {
    if (!per_step) {
      scan_total<FORM><<<grid, warps * 32, 0, stream>>>(x, s, c, t_steps, wps, out);
      return;
    }
  }
  const size_t smem = sizeof(unsigned) * warps * STEP_CHUNK * STRIP;
  scan_steps<FORM><<<grid, warps * 32, smem, stream>>>(x, s, c, t_steps, wps, 0u, out);
}

}  // namespace

// x [s, c] row-major (int32, int16 or bf16 by form), c a multiple of 128;
// out [8, c] f32.  The plan (ops/scan_probe.py scan_plan): per_step, the
// warps a strip takes (wps) and the strips a block takes (spb); the total
// path is refused for add and where s * t_steps > 2^24.
extern "C" int cwipc_scan_probe(const void* x, int form, int s, int c, int t_steps, int per_step, int wps,
                                int spb, float* out, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bool exact = form != FORM_ADD && static_cast<long long>(s) * t_steps <= EXACT;
  if (c % 128 != 0 || form < FORM_I32 || form > FORM_ADD || s < 0 || t_steps < 0 || wps < 1 || spb < 1 ||
      wps * spb > MAX_WARPS || (c / STRIP) % spb != 0 || (!per_step && !exact)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (c == 0) return 0;
  const bool steps = per_step != 0;
  switch (form) {
    case FORM_I32: launch<FORM_I32>(x, s, c, t_steps, steps, wps, spb, out, stream); break;
    case FORM_I16: launch<FORM_I16>(x, s, c, t_steps, steps, wps, spb, out, stream); break;
    case FORM_BF16: launch<FORM_BF16>(x, s, c, t_steps, steps, wps, spb, out, stream); break;
    case FORM_MXU: launch<FORM_MXU>(x, s, c, t_steps, steps, wps, spb, out, stream); break;
    default: launch<FORM_ADD>(x, s, c, t_steps, steps, wps, spb, out, stream);
  }
  CWIPC_RETURN_IF_ERROR();
  return 0;
}
