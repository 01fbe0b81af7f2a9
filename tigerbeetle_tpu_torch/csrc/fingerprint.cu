// K6: the state fingerprint (accounts_fp, transfers_fp, live counts,
// commit timestamp).
//
// Replaces tigerbeetle_tpu/models/ledger.py state_fingerprint / _fp_rows /
// _fp_mix (:325-362, jitted by DeviceLedger.fingerprint_lazy :2523-2530).
//
// Bound on an H100: bytes. Every row's key sector must be read to decide
// whether the row is live; only a live row's other 96 bytes are needed. The
// card fetches 64 bytes for a 32-byte sector (the sector probe of
// csrc/chase.cu), so its floor is a 64-byte fetch a slot and the other 64
// bytes of a live row. The hash is a chain of 32 multiply-rotate steps per
// live row, far below the card's integer rate at the tables' live share.
//
// Design: one launch over both tables, a persistent grid of the blocks the
// card holds at once that strides over the account table and then over the
// transfer table, one row a thread: the thread loads the row's 16 key bytes,
// and the whole row as eight 16-byte vectors only when the key is neither
// empty nor a tombstone. Each table's trailing dump row is left out. The
// whole grid sweeps one table front to back, then the other, so the rows in
// flight lie together: grids that gave each table its own blocks, or fixed
// chunks of rows, or more loads a thread (two or four keys first, or a warp's
// live rows queued in shared memory and hashed 32 at a time) read the same
// bytes 3-31% slower on an H100 (PERF.md). Registers stay at 32, so every SM
// holds 2048 threads, each with its key load in flight. Each block reduces a
// table's live hashes and count over the warp and the block, and one thread
// adds them into the kept scratch words with atomicAdd; the block that
// finishes last (a counter in the scratch) takes the totals with atomicExch,
// which leaves the words zeroed for the next call, and writes all five
// output words, commit_ts included: no memset and no copy. The sums wrap
// mod 2^64, exact in any order, so the result is bit-identical to the plain
// version. Row offsets are 64-bit (2^24 rows of 128 bytes pass 2^31).
#include <cuda_runtime.h>

#include "fp.cuh"
#include "hash.cuh"

#define FP_THREADS 256
#define FP_MIN_BLOCKS 8  // 2048 threads an SM: at most 32 registers a thread

// Kept between calls (per device and stream): the four sums, the count of
// blocks done. Zero before a call, left zero by its last block.
struct FpScratch {
  ull acc[4];  // accounts_fp, transfers_fp, accounts, transfers
  unsigned int done;
};

// This thread's live rows of `rows` [0, n), a grid stride apart: the wrapping
// sum of their hashes and their count.
__device__ __forceinline__ void fp_pass(const uint32_t* __restrict__ rows, long long n, ull& sum,
                                        ull& count) {
  const long long stride = (long long)gridDim.x * FP_THREADS;
  for (long long r = (long long)blockIdx.x * FP_THREADS + threadIdx.x; r < n; r += stride) {
    const uint32_t* p = rows + r * ROW_WORDS;
    Key4 k = key_at(p);
    if (key_empty(k) || key_tomb(k)) continue;
    sum += fp_row_hash(load_row(p));
    count += 1;
  }
}

// The block's sums of one table into its kept words (thread 0).
__device__ __forceinline__ void fp_block_add(ull sum, ull count, int table, FpScratch* sc) {
  __shared__ ull s_sum[FP_THREADS / 32], s_count[FP_THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sum += __shfl_down_sync(0xFFFFFFFFu, sum, off);
    count += __shfl_down_sync(0xFFFFFFFFu, count, off);
  }
  if (lane == 0) {
    s_sum[warp] = sum;
    s_count[warp] = count;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    sum = 0;
    count = 0;
#pragma unroll
    for (int w = 0; w < FP_THREADS / 32; w++) {
      sum += s_sum[w];
      count += s_count[w];
    }
    if (count != 0) {
      atomicAdd(&sc->acc[table], sum);
      atomicAdd(&sc->acc[2 + table], count);
    }
  }
  __syncthreads();  // s_sum and s_count are free again
}

__global__ void __launch_bounds__(FP_THREADS, FP_MIN_BLOCKS)
    fp_tables(const uint32_t* __restrict__ acct, long long a_rows,
              const uint32_t* __restrict__ xfer, long long x_rows,
              const ull* __restrict__ commit_ts, ull* out, FpScratch* sc) {
  ull sum = 0, count = 0;
  fp_pass(acct, a_rows, sum, count);
  fp_block_add(sum, count, 0, sc);
  sum = 0;
  count = 0;
  fp_pass(xfer, x_rows, sum, count);
  fp_block_add(sum, count, 1, sc);
  if (threadIdx.x != 0) return;
  __threadfence();  // this block's sums land before its count of done
  if (atomicAdd(&sc->done, 1u) != gridDim.x - 1) return;
  __threadfence();  // the last block: every other block's sums are in
#pragma unroll
  for (int i = 0; i < 4; i++) out[i] = atomicExch(&sc->acc[i], 0ull);
  out[4] = __ldcg(commit_ts);
  atomicExch(&sc->done, 0u);
}

extern "C" size_t tb_fingerprint_scratch_bytes() { return sizeof(FpScratch); }

// out (u64 [5]): accounts_fp, transfers_fp, accounts, transfers,
// commit_timestamp. `*_slots` are the tables' capacities (rows less the dump
// row); scratch: tb_fingerprint_scratch_bytes() bytes, zero before the
// first call on a stream and left zero by each call.
extern "C" int tb_fingerprint(const uint32_t* acct_rows, long long acct_slots,
                              const uint32_t* xfer_rows, long long xfer_slots,
                              const ull* commit_ts, ull* out, void* scratch,
                              cudaStream_t stream) {
  static int grid = 0;  // the blocks the card holds at once: one wave
  if (grid == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fp_tables, FP_THREADS, 0);
    grid = sms * (per_sm > 0 ? per_sm : 1);
  }
  fp_tables<<<grid, FP_THREADS, 0, stream>>>(acct_rows, acct_slots, xfer_rows, xfer_slots,
                                             commit_ts, out, static_cast<FpScratch*>(scratch));
  return (int)cudaGetLastError();
}
