// Kernel 6: sort of int32 keys carrying int32 payloads.
//
// Replaces cwipc_util_tpu/ops/pallas_sort.py:_kernel (the pallas_call at
// :169; wrappers sort_by_key :136 and sort3 :183), an all-VMEM bitonic
// network that the JAX package keeps off every path.  Contract: keys in
// signed int32 order (INT32_MAX is the padding sentinel), payload bits
// carried unchanged, n a multiple of TILE_KEYS (the wrapper takes powers
// of two >= 8192).  The result here is stable, which is more than the
// contract asks.
//
// Design: a onesweep LSD radix sort, 8-bit digits, the sign bit flipped so
// that unsigned digit order is signed key order.  One sort is six launches
// whatever the data:
//   1. one memset zeroes the scratch (digit counts, tile counters, status);
//   2. upfront_histogram counts all four digits in one read of the keys
//      (shared-memory counts per block, then global atomics);
//   3.-6. onesweep_pass, one launch a pass.  A block of 512 threads takes
//      the next tile of 4,096 keys from an atomic counter (so every tile it
//      waits on belongs to a block that is already running) and ranks its
//      keys stably: each warp holds 256 consecutive keys of the tile and
//      counts them per digit in its own row of a [16][256] table, a round
//      of 32 at a time (equal digits by one ballot per digit bit), and one scan of
//      the table over the warps gives every key its slot.  It publishes
//      its per-digit count, resolves its offset by decoupled look-back over
//      the tiles before it (a 64-bit status word per (tile, digit): flag |
//      count; the two threads of a digit read a window of 16 earlier tiles
//      at once and stop at the nearest inclusive prefix in it), publishes
//      its inclusive prefix, stages the tile in shared memory in output
//      order and writes it out.
// Every block reads the four histograms first: a pass whose digit is the
// same for all n keys is skipped (its blocks return at once; a stable pass
// over a uniform digit moves nothing), and the passes that run ping-pong
// between two (key, index) buffers.  The last pass that runs writes the
// sorted keys and reads each payload by the index it carries, into the
// outputs: no separate gather.  If every digit is uniform, the fourth pass
// runs alone, as the identity.
//
// Bound on the H100: memory.  The function must read the keys and payloads
// once and write them once (24 MB for 1M keys and two payloads: 7.5 us at
// 3.35 TB/s).  This design reads the keys once more for the histogram and
// moves (key, index) pairs through the passes before the last, about 3x
// that; each pass also pays the in-block ranking and the look-back chain.
#include <cuda_runtime.h>

#include <climits>

#include "scan.cuh"

namespace {

constexpr int RADIX_BITS = 8;
constexpr int RADIX = 1 << RADIX_BITS;
constexpr int PASSES = 32 / RADIX_BITS;
constexpr int PASS_THREADS = 512;           // threads of a pass block
constexpr int PASS_WARPS = PASS_THREADS / 32;
constexpr int KPT = 8;                      // keys per thread
constexpr int TILE_KEYS = PASS_THREADS * KPT;  // keys per tile (one block each)
constexpr int KEYS_PER_WARP = 32 * KPT;
constexpr int HIST_KEYS = 4 * TILE_KEYS;    // keys per histogram block
constexpr int MAX_PAYLOADS = 4;
constexpr int LOOKBACK = 8;  // earlier tiles each of a digit's two threads reads at once
constexpr unsigned long long FLAG_AGG = 1ull << 62;     // the tile's own count
constexpr unsigned long long FLAG_PREFIX = 1ull << 63;  // the count of this and every earlier tile
constexpr unsigned long long VALUE_MASK = 0xffffffffull;

struct Payloads {
  const int* in[MAX_PAYLOADS];
  int* out[MAX_PAYLOADS];
  int count;
};

__device__ __forceinline__ int digit_of(int key, int pass) {
  return static_cast<int>(((static_cast<unsigned>(key) ^ 0x80000000u) >> (pass * RADIX_BITS)) & (RADIX - 1));
}

// hist[pass][digit] += the count of the keys of this block's HIST_KEYS.
__global__ void __launch_bounds__(TILE)
upfront_histogram(const int* __restrict__ keys, int n, int* __restrict__ hist) {
  __shared__ int h[PASSES * RADIX];
  for (int i = threadIdx.x; i < PASSES * RADIX; i += TILE) h[i] = 0;
  __syncthreads();
  const int end = min((blockIdx.x + 1) * HIST_KEYS, n);
  for (int i = blockIdx.x * HIST_KEYS + threadIdx.x; i < end; i += TILE) {
    const int k = keys[i];
#pragma unroll
    for (int p = 0; p < PASSES; ++p) atomicAdd(&h[p * RADIX + digit_of(k, p)], 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < PASSES * RADIX; i += TILE) {
    if (h[i] != 0) atomicAdd(&hist[i], h[i]);
  }
}

// The lanes of the warp whose digit equals this lane's, from one ballot
// per digit bit (__match_any_sync costs several times as much here).
__device__ __forceinline__ unsigned lanes_with_digit(int d) {
  unsigned peers = 0xffffffffu;
#pragma unroll
  for (int b = 0; b < RADIX_BITS; ++b) {
    const bool bit = (d >> b) & 1;
    const unsigned vote = __ballot_sync(0xffffffffu, bit);
    peers &= bit ? vote : ~vote;
  }
  return peers;
}

// Exclusive prefix sum over the digits: thread d < RADIX passes the count
// of digit d and receives the sum of the counts below it; every thread of
// the block must call it.
__device__ __forceinline__ int digit_exclusive_scan(int v) {
  __shared__ int warp_sums[RADIX / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = threadIdx.x < RADIX ? v : 0;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31 && warp < RADIX / 32) warp_sums[warp] = x;
  __syncthreads();
  int before = 0;
  for (int w = 0; w < warp && w < RADIX / 32; ++w) before += warp_sums[w];
  __syncthreads();  // warp_sums is reused by the next call
  return before + x - v;
}

// One pass of the sort over digit `pass`; see the file comment.  status is
// this pass's [ntiles][RADIX] words, counter its tile counter.
__global__ void __launch_bounds__(PASS_THREADS)
onesweep_pass(int pass, const int* __restrict__ keys, int n, const int* __restrict__ hist,
              int* __restrict__ counter, unsigned long long* __restrict__ status, int* keys_a,
              int* keys_b, int* idx_a, int* idx_b, int* __restrict__ out_keys, Payloads pay) {
  // ranking: each warp's count per digit, then its first slot per digit;
  // then the staged tile (keys, then indices)
  __shared__ int table[2 * TILE_KEYS];
  __shared__ int half_sum[2][RADIX];  // a digit's count over each half of the warps
  __shared__ int run[RADIX];          // the tile's count per digit
  __shared__ int local_start[RADIX];  // where each digit's keys start in the staged tile
  __shared__ int out_offset[RADIX];   // output position of staged slot i of digit d: out_offset[d] + i
  __shared__ int tile_id;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // which passes run: those whose digit is not the same for all n keys
  unsigned runs = 0;
  for (int p = 0; p < PASSES; ++p) {
    const bool uniform = __syncthreads_or(tid < RADIX && hist[p * RADIX + tid] == n);
    if (!uniform) runs |= 1u << p;
  }
  if (runs == 0) runs = 1u << (PASSES - 1);
  if (!((runs >> pass) & 1u)) return;
  const int order = __popc(runs & ((1u << pass) - 1u));  // passes that ran before this one
  const bool first = order == 0;
  const bool last = (runs >> (pass + 1)) == 0;
  const int* k_in = first ? keys : ((order - 1) & 1) ? keys_b : keys_a;
  const int* i_in = first ? nullptr : ((order - 1) & 1) ? idx_b : idx_a;
  int* k_out = (order & 1) ? keys_b : keys_a;
  int* i_out = (order & 1) ? idx_b : idx_a;

  if (tid == 0) tile_id = atomicAdd(counter, 1);
  for (int j = tid; j < PASS_WARPS * RADIX; j += PASS_THREADS) table[j] = 0;
  const int digit_base = digit_exclusive_scan(tid < RADIX ? hist[pass * RADIX + tid] : 0);
  if (tid < RADIX) out_offset[tid] = digit_base;
  const int tile = tile_id;

  // warp w holds the tile's keys w * KEYS_PER_WARP ... in rounds of 32:
  // the tile's order is (warp, round, lane), so ranks need one scan
  const int wbase = tile * TILE_KEYS + warp * KEYS_PER_WARP;
  int key[KPT], idx[KPT], dig[KPT], rank[KPT];
#pragma unroll
  for (int r = 0; r < KPT; ++r) {
    const int i = wbase + r * 32 + lane;
    key[r] = k_in[i];
    idx[r] = first ? i : i_in[i];
  }
  // each warp's stable rank per digit, in its own row of the table
  const unsigned lanes_below = (1u << lane) - 1u;
  int* mine = table + warp * RADIX;
#pragma unroll
  for (int r = 0; r < KPT; ++r) {
    const int d = digit_of(key[r], pass);
    const unsigned peers = lanes_with_digit(d);
    const int below = __popc(peers & lanes_below);
    const int before = mine[d];
    __syncwarp();
    if (below == 0) mine[d] = before + __popc(peers);
    __syncwarp();
    dig[r] = d;
    rank[r] = before + below;
  }
  __syncthreads();
  // the warps' counts to first slots per digit: thread h * RADIX + d takes
  // digit d over half h of the warps
  {
    const int sd = tid & (RADIX - 1);
    const int sh = tid / RADIX;
    int sum = 0;
#pragma unroll
    for (int w = sh * (PASS_WARPS / 2); w < (sh + 1) * (PASS_WARPS / 2); ++w) {
      const int c = table[w * RADIX + sd];
      table[w * RADIX + sd] = sum;
      sum += c;
    }
    half_sum[sh][sd] = sum;
    __syncthreads();
    if (sh == 1) {
#pragma unroll
      for (int w = PASS_WARPS / 2; w < PASS_WARPS; ++w) table[w * RADIX + sd] += half_sum[0][sd];
    } else {
      run[sd] = half_sum[0][sd] + half_sum[1][sd];
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < KPT; ++r) rank[r] += mine[dig[r]];

  // publish the tile's counts, then look back over the earlier tiles: the
  // two threads of a digit read a window of 2 * LOOKBACK earlier tiles at
  // once, stop at the nearest inclusive prefix in it and sum the counts
  // above it
  volatile unsigned long long* st = status;
  const int d = tid >> 1;
  const int j = tid & 1;
  if (j == 0) {  // the thread that later publishes the prefix: its two stores stay in order
    unsigned long long flag = FLAG_AGG;
    if (tile == 0) flag = FLAG_PREFIX;
    st[static_cast<size_t>(tile) * RADIX + d] = flag | static_cast<unsigned long long>(run[d]);
  }
  if (tile > 0) {
    const unsigned pair = 0x3u << (lane & ~1);
    int before = 0;
    for (int hi = tile - 1;; hi -= 2 * LOOKBACK) {
      unsigned long long w[LOOKBACK];
#pragma unroll
      for (int i = 0; i < LOOKBACK; ++i) {
        const int t = hi - j - 2 * i;
        w[i] = FLAG_PREFIX;  // below tile 0: a prefix of 0
        if (t >= 0) w[i] = st[static_cast<size_t>(t) * RADIX + d];
      }
#pragma unroll
      for (int i = 0; i < LOOKBACK; ++i) {
        const int t = hi - j - 2 * i;
        while ((w[i] & (FLAG_AGG | FLAG_PREFIX)) == 0) w[i] = st[static_cast<size_t>(t) * RADIX + d];
      }
      int nearest = INT_MIN;  // the highest tile of the window holding a prefix
#pragma unroll
      for (int i = LOOKBACK - 1; i >= 0; --i) {
        if (w[i] & FLAG_PREFIX) nearest = hi - j - 2 * i;
      }
      nearest = max(nearest, __shfl_xor_sync(pair, nearest, 1));
      int sum = 0;
#pragma unroll
      for (int i = 0; i < LOOKBACK; ++i) {
        if (hi - j - 2 * i >= nearest) sum += static_cast<int>(w[i] & VALUE_MASK);
      }
      before += sum + __shfl_xor_sync(pair, sum, 1);
      if (nearest != INT_MIN) break;
    }
    if (j == 0) {
      st[static_cast<size_t>(tile) * RADIX + d] = FLAG_PREFIX | static_cast<unsigned long long>(before + run[d]);
      out_offset[d] += before;
    }
  }
  const int start = digit_exclusive_scan(tid < RADIX ? run[tid] : 0);
  if (tid < RADIX) {
    local_start[tid] = start;
    out_offset[tid] -= start;
  }
  __syncthreads();

  // stage the tile in output order, then write it out
  int* s_key = table;
  int* s_idx = table + TILE_KEYS;
#pragma unroll
  for (int r = 0; r < KPT; ++r) {
    const int lp = local_start[dig[r]] + rank[r];
    s_key[lp] = key[r];
    s_idx[lp] = idx[r];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < KPT; ++r) {
    const int i = r * PASS_THREADS + tid;
    const int k = s_key[i];
    const int pos = out_offset[digit_of(k, pass)] + i;
    if (last) {
      out_keys[pos] = k;
      for (int p = 0; p < pay.count; ++p) pay.out[p][pos] = pay.in[p][s_idx[i]];
    } else {
      k_out[pos] = k;
      i_out[pos] = s_idx[i];
    }
  }
}

}  // namespace

// Sort the n keys (n a multiple of 4,096) carrying npay <= 4 payloads:
// the sorted keys land in keys_out and payload p in pay_out_p.  keys_a,
// keys_b, idx_a and idx_b are n ints of ping-pong scratch; scratch holds
// scratch_bytes (ops/sort_kernel.py:sort_plan): the digit counts
// [4][256], the tile counters [4], then the status words [4][n / 4096][256]
// of 8 bytes.
extern "C" int cwipc_sort_pairs(const int* keys, int n, int npay, const int* pay_in_0,
                                const int* pay_in_1, const int* pay_in_2, const int* pay_in_3,
                                int* keys_out, int* pay_out_0, int* pay_out_1, int* pay_out_2,
                                int* pay_out_3, int* keys_a, int* keys_b, int* idx_a, int* idx_b,
                                int* scratch, long long scratch_bytes, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int ntiles = n / TILE_KEYS;
  const long long need = 4LL * (PASSES * RADIX + PASSES) + 8LL * PASSES * ntiles * RADIX;
  if (n <= 0 || n % TILE_KEYS != 0 || npay < 0 || npay > MAX_PAYLOADS || scratch_bytes < need) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Payloads pay = {{pay_in_0, pay_in_1, pay_in_2, pay_in_3}, {pay_out_0, pay_out_1, pay_out_2, pay_out_3}, npay};
  int* hist = scratch;
  int* counters = scratch + PASSES * RADIX;
  unsigned long long* status = reinterpret_cast<unsigned long long*>(counters + PASSES);
  cudaError_t e = cudaMemsetAsync(scratch, 0, static_cast<size_t>(need), stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  upfront_histogram<<<(n + HIST_KEYS - 1) / HIST_KEYS, TILE, 0, stream>>>(keys, n, hist);
  CWIPC_RETURN_IF_ERROR();
  for (int pass = 0; pass < PASSES; ++pass) {
    onesweep_pass<<<ntiles, PASS_THREADS, 0, stream>>>(pass, keys, n, hist, counters + pass,
                                               status + static_cast<size_t>(pass) * ntiles * RADIX,
                                               keys_a, keys_b, idx_a, idx_b, keys_out, pay);
    CWIPC_RETURN_IF_ERROR();
  }
  return 0;
}
