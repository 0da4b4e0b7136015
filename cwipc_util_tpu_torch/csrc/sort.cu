// Kernel 6: sort of int32 keys carrying int32 payloads.
//
// Replaces cwipc_util_tpu/ops/pallas_sort.py:_kernel (the pallas_call at
// :169; wrappers sort_by_key :136 and sort3 :183), an all-VMEM bitonic
// network that the JAX package keeps off every path.  Contract: keys in
// signed int32 order (INT32_MAX is the padding sentinel), payload bits
// carried unchanged.  The result here is stable, which is more than the
// contract asks.
//
// Design: an LSD radix sort with 8-bit digits, four passes, the sign bit
// flipped so that unsigned digit order is signed key order.  The sort moves
// (key, index) pairs; each payload then takes one gather by the index
// (cwipc_gather_i32), so any number of payloads costs one read and one
// write each.  A pass is four launches over blocks of 4,096 keys:
//   1. radix_histogram: each block counts its digits in shared memory and
//      writes them digit-major, counts[digit][block];
//   2. scan_digit_columns: one block per digit scans that digit's counts
//      over the blocks (scan.cuh's block scan), giving each block its
//      offset within the digit, and the digit's total;
//   3. scan_tile_counts (scan.cuh): the 256 totals into digit bases;
//   4. radix_scatter: each block ranks its keys stably in four rounds of
//      1,024 (a warp's equal digits by __match_any_sync, the warps in order
//      through a [32][256] table in shared memory) and writes each pair to
//      base[digit] + block offset + rank.
// No pass is skipped: a digit that is the same for all keys costs one
// pass that moves every pair to where it already was.
//
// Bound on the H100: memory.  The function must read the keys and payloads
// once and write them once (24 MB for 1M keys and two payloads: 7.5 us at
// 3.35 TB/s); four passes over (key, index) pairs plus the gathers move
// about 5x that, and each pass also pays its launches.  A onesweep sort
// (one upfront histogram, decoupled look-back) would cut both: later work.
#include <cuda_runtime.h>

#include "scan.cuh"

namespace {

constexpr int RADIX_BITS = 8;
constexpr int RADIX = 1 << RADIX_BITS;
constexpr int ROUNDS = 4;                  // rounds of TILE keys a block ranks
constexpr int BLOCK_KEYS = TILE * ROUNDS;  // keys per block
constexpr int NWARPS = TILE / 32;

__device__ __forceinline__ int digit_of(int key, int shift) {
  return static_cast<int>(((static_cast<unsigned>(key) ^ 0x80000000u) >> shift) & (RADIX - 1));
}

__global__ void __launch_bounds__(TILE)
radix_histogram(const int* __restrict__ keys, int n, int shift, int nblocks, int* __restrict__ counts) {
  __shared__ int hist[RADIX];
  if (threadIdx.x < RADIX) hist[threadIdx.x] = 0;
  __syncthreads();
  const int base = blockIdx.x * BLOCK_KEYS;
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    const int i = base + r * TILE + threadIdx.x;
    if (i < n) atomicAdd(&hist[digit_of(keys[i], shift)], 1);
  }
  __syncthreads();
  if (threadIdx.x < RADIX) counts[threadIdx.x * nblocks + blockIdx.x] = hist[threadIdx.x];
}

// One block per digit: offsets[d][b] = sum of counts[d][< b]; totals[d].
__global__ void __launch_bounds__(TILE)
scan_digit_columns(const int* __restrict__ counts, int nblocks, int* __restrict__ offsets,
                   int* __restrict__ totals) {
  const int d = blockIdx.x;
  const int* col = counts + static_cast<size_t>(d) * nblocks;
  int* out = offsets + static_cast<size_t>(d) * nblocks;
  int carry = 0;
  for (int base = 0; base < nblocks; base += TILE) {
    const int b = base + threadIdx.x;
    int sum;
    const int before = block_exclusive_scan(b < nblocks ? col[b] : 0, &sum);
    if (b < nblocks) out[b] = carry + before;
    carry += sum;
  }
  if (threadIdx.x == 0) totals[d] = carry;
}

// idx_in null: the pairs' index is the key's position (the first pass).
__global__ void __launch_bounds__(TILE)
radix_scatter(const int* __restrict__ keys_in, const int* __restrict__ idx_in, int n, int shift,
              int nblocks, const int* __restrict__ offsets, const int* __restrict__ digit_base,
              int* __restrict__ keys_out, int* __restrict__ idx_out) {
  __shared__ int next[RADIX];              // the block's next output slot per digit
  __shared__ int warp_pos[NWARPS][RADIX];  // a round's counts, then its slots, per warp
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;
  if (threadIdx.x < RADIX) {
    next[threadIdx.x] = digit_base[threadIdx.x] + offsets[threadIdx.x * nblocks + blockIdx.x];
  }
  const int base = blockIdx.x * BLOCK_KEYS;
  for (int r = 0; r < ROUNDS; ++r) {
    for (int j = threadIdx.x; j < NWARPS * RADIX; j += TILE) (&warp_pos[0][0])[j] = 0;
    __syncthreads();
    const int i = base + r * TILE + threadIdx.x;
    const bool live = i < n;
    const int key = live ? keys_in[i] : 0;
    const int d = live ? digit_of(key, shift) : RADIX;  // RADIX groups the dead lanes
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const int rank = __popc(peers & lanes_below);
    if (live && rank == 0) warp_pos[warp][d] = __popc(peers);
    __syncthreads();
    if (threadIdx.x < RADIX) {  // warps in order: slots for each warp's run of this digit
      int pos = next[threadIdx.x];
      for (int w = 0; w < NWARPS; ++w) {
        const int c = warp_pos[w][threadIdx.x];
        warp_pos[w][threadIdx.x] = pos;
        pos += c;
      }
      next[threadIdx.x] = pos;
    }
    __syncthreads();
    if (live) {
      const int pos = warp_pos[warp][d] + rank;
      keys_out[pos] = key;
      idx_out[pos] = idx_in != nullptr ? idx_in[i] : i;
    }
    __syncthreads();  // warp_pos is cleared by the next round
  }
}

__global__ void gather_i32(const int* __restrict__ src, const int* __restrict__ idx, int n,
                           int* __restrict__ dst) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) dst[i] = src[idx[i]];
}

}  // namespace

// Sort the n keys: the sorted keys land in keys_b and the source position of
// each in idx_b (keys_a and idx_a are the ping-pong scratch).  counts and
// offsets hold RADIX * nblocks ints, nblocks = ceil(n / 4096); totals and
// digit_base RADIX ints; total one int.
extern "C" int cwipc_sort_pairs(const int* keys, int n, int* keys_a, int* keys_b, int* idx_a,
                                int* idx_b, int* counts, int* offsets, int* totals, int* digit_base,
                                int* total, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int nblocks = (n + BLOCK_KEYS - 1) / BLOCK_KEYS;
  if (nblocks == 0) return 0;
  const int* k_in = keys;
  const int* i_in = nullptr;
  for (int pass = 0; pass < 32 / RADIX_BITS; ++pass) {
    const int shift = pass * RADIX_BITS;
    int* k_out = (pass & 1) ? keys_b : keys_a;
    int* i_out = (pass & 1) ? idx_b : idx_a;
    radix_histogram<<<nblocks, TILE, 0, stream>>>(k_in, n, shift, nblocks, counts);
    CWIPC_RETURN_IF_ERROR();
    scan_digit_columns<<<RADIX, TILE, 0, stream>>>(counts, nblocks, offsets, totals);
    CWIPC_RETURN_IF_ERROR();
    scan_tile_counts<<<1, TILE, 0, stream>>>(totals, RADIX, digit_base, total);
    CWIPC_RETURN_IF_ERROR();
    radix_scatter<<<nblocks, TILE, 0, stream>>>(k_in, i_in, n, shift, nblocks, offsets, digit_base,
                                                k_out, i_out);
    CWIPC_RETURN_IF_ERROR();
    k_in = k_out;
    i_in = i_out;
  }
  return 0;
}

// dst[i] = src[idx[i]] for i < n.
extern "C" int cwipc_gather_i32(const int* src, const int* idx, int n, int* dst, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n > 0) {
    gather_i32<<<(n + 255) / 256, 256, 0, stream>>>(src, idx, n, dst);
    CWIPC_RETURN_IF_ERROR();
  }
  return 0;
}
