// Stable compaction of slot indices into up to two lists, for K10's split
// (spill_split.cu); K8 (filter_scan.cu) compacts in one pass with decoupled
// look-back instead (lookback.cuh).
//
// The JAX program compacts with `jnp.nonzero(size=, fill_value=)`
// (_split_idx): the matching slot indices in ascending slot order, padded.
// Blocks run in no order on the card, so the order comes from three
// launches:
//
// 1. compact_count: each block takes a tile of CT_TILE consecutive slots,
//    evaluates the caller's predicate once per slot (a bit per list), keeps
//    the bits in a byte array and writes its per-list count;
// 2. compact_scan: one block per list turns the block counts into exclusive
//    offsets and the list's total;
// 3. compact_write: each block re-reads its tile's bytes (not the table) and
//    ranks its set bits in slot order with warp ballots and a block prefix,
//    then writes slot indices at offset + rank, below the list's limit.
//
// A tile is walked as CT_ITEMS rounds of CT_THREADS neighbouring slots, so
// every read is coalesced and the rank order within a round is the thread
// order, which is the slot order. Pads are the caller's business
// (compact_pad fills [total, size) with one value).
#pragma once
#include <cuda_runtime.h>

#include <cstdint>

#define CT_THREADS 256
#define CT_ITEMS 16
#define CT_TILE (CT_THREADS * CT_ITEMS)
#define CT_WARPS (CT_THREADS / 32)
#define CT_SCAN_THREADS 1024

static inline int compact_blocks(long long n) {
  long long b = (n + CT_TILE - 1) / CT_TILE;
  return b > 0 ? (int)b : 1;
}

// The outputs of compact_write: list l's slot indices go to idx[l][pos] for
// pos < limit[l].
struct CompactOut {
  int32_t* idx[2];
  long long limit[2];
};

// Sum of one int over the block; every thread gets it. `buf` holds
// CT_WARPS ints of shared memory.
__device__ __forceinline__ int ct_block_sum(int v, int* buf) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, off);
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) buf[warp] = v;
  __syncthreads();
  int s = 0;
#pragma unroll
  for (int w = 0; w < CT_WARPS; w++) s += buf[w];
  return s;
}

// Exclusive rank of this thread's bit among the block's set bits, in
// thread order; *total gets the block's count. `buf` holds CT_WARPS ints.
__device__ __forceinline__ int ct_block_rank(bool bit, int* buf, int* total) {
  unsigned ballot = __ballot_sync(0xFFFFFFFFu, bit);
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) buf[warp] = __popc(ballot);
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < CT_WARPS; w++) {
    before += w < warp ? buf[w] : 0;
    all += buf[w];
  }
  *total = all;
  return before + __popc(ballot & ((1u << lane) - 1u));
}

// Pass 1. `pred(i)` returns the list bits of slot i (bit l: slot i belongs
// to list l); counts is [NL][gridDim.x].
template <int NL, class Pred>
__global__ void __launch_bounds__(CT_THREADS)
    compact_count(Pred pred, long long n, uint8_t* __restrict__ bits, int* __restrict__ counts) {
  __shared__ int buf[CT_WARPS];
  long long base = (long long)blockIdx.x * CT_TILE;
  int c[NL];
#pragma unroll
  for (int l = 0; l < NL; l++) c[l] = 0;
  for (int k = 0; k < CT_ITEMS; k++) {
    long long i = base + (long long)k * CT_THREADS + threadIdx.x;
    if (i >= n) break;
    unsigned b = pred(i);
    bits[i] = (uint8_t)b;
#pragma unroll
    for (int l = 0; l < NL; l++) c[l] += (b >> l) & 1u;
  }
#pragma unroll
  for (int l = 0; l < NL; l++) {
    int s = ct_block_sum(c[l], buf);
    if (threadIdx.x == 0) counts[(long long)l * gridDim.x + blockIdx.x] = s;
  }
}

// Pass 2, one block per list: counts[l] -> exclusive offsets in place,
// totals[l] = the list's count. Static: each unit that includes this header
// gets its own copy.
static __global__ void __launch_bounds__(CT_SCAN_THREADS)
    compact_scan(int* __restrict__ counts, int nblocks, int* __restrict__ totals) {
  __shared__ int buf[CT_SCAN_THREADS / 32];
  __shared__ int carry_s;
  int* c = counts + (long long)blockIdx.x * nblocks;
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry_s = 0;
  __syncthreads();
  for (int start = 0; start < nblocks; start += CT_SCAN_THREADS) {
    int i = start + threadIdx.x;
    int v = i < nblocks ? c[i] : 0;
    int x = v;  // inclusive warp scan
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      int y = __shfl_up_sync(0xFFFFFFFFu, x, off);
      if (lane >= off) x += y;
    }
    if (lane == 31) buf[warp] = x;
    __syncthreads();
    int before = 0, all = 0;
    for (int w = 0; w < CT_SCAN_THREADS / 32; w++) {
      before += w < warp ? buf[w] : 0;
      all += buf[w];
    }
    int carry = carry_s;
    if (i < nblocks) c[i] = carry + before + x - v;
    __syncthreads();
    if (threadIdx.x == 0) carry_s = carry + all;
    __syncthreads();
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry_s;
}

// Pass 3: slot indices in slot order at offsets[l][block] + rank.
template <int NL>
__global__ void __launch_bounds__(CT_THREADS)
    compact_write(const uint8_t* __restrict__ bits, long long n,
                  const int* __restrict__ offsets, CompactOut out) {
  __shared__ int buf[CT_WARPS];
  long long base = (long long)blockIdx.x * CT_TILE;
  long long run[NL];
#pragma unroll
  for (int l = 0; l < NL; l++) run[l] = offsets[(long long)l * gridDim.x + blockIdx.x];
  for (int k = 0; k < CT_ITEMS; k++) {
    long long i = base + (long long)k * CT_THREADS + threadIdx.x;
    if (base + (long long)k * CT_THREADS >= n) break;  // uniform over the block
    unsigned b = i < n ? bits[i] : 0u;
#pragma unroll
    for (int l = 0; l < NL; l++) {
      bool bit = (b >> l) & 1u;
      int total;
      int rank = ct_block_rank(bit, buf, &total);
      long long pos = run[l] + rank;
      if (bit && pos < out.limit[l]) out.idx[l][pos] = (int32_t)i;
      run[l] += total;
    }
  }
}

// idx[l][totals[l] .. size) = fill, for every list.
template <int NL>
__global__ void compact_pad(CompactOut out, const int* __restrict__ totals, long long size,
                            int32_t fill) {
  long long stride = (long long)gridDim.x * blockDim.x;
#pragma unroll
  for (int l = 0; l < NL; l++) {
    long long lim = size < out.limit[l] ? size : out.limit[l];
    for (long long i = totals[l] + (long long)blockIdx.x * blockDim.x + threadIdx.x; i < lim;
         i += stride)
      out.idx[l][i] = fill;
  }
}

// The three passes on `stream`. Scratch: bits [n] bytes, counts [NL *
// compact_blocks(n)] ints, totals [NL] ints.
template <int NL, class Pred>
static void compact_run(Pred pred, long long n, uint8_t* bits, int* counts, int* totals,
                        CompactOut out, cudaStream_t stream) {
  int nb = compact_blocks(n);
  compact_count<NL, Pred><<<nb, CT_THREADS, 0, stream>>>(pred, n, bits, counts);
  compact_scan<<<NL, CT_SCAN_THREADS, 0, stream>>>(counts, nb, totals);
  compact_write<NL><<<nb, CT_THREADS, 0, stream>>>(bits, n, counts, out);
}
