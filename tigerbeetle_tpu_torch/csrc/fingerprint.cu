// K6: the state fingerprint (accounts_fp, transfers_fp, live counts,
// commit timestamp).
//
// Replaces tigerbeetle_tpu/models/ledger.py state_fingerprint / _fp_rows /
// _fp_mix (:325-362, jitted by DeviceLedger.fingerprint_lazy :2523-2530).
//
// Bound on an H100: bytes. Every row's key sector must be read to decide
// whether the row is live; only a live row's other 96 bytes are needed. The
// hash is a chain of 32 multiply-rotate steps per live row, far below the
// card's integer rate at the tables' live share.
//
// Design: one pass per table in a grid-stride loop, one row per thread. A
// thread loads the row's 16 key bytes, and the whole row as eight 16-byte
// vectors only when the key is neither empty nor a tombstone; the live
// rows' hashes and the live count are summed in registers, reduced over the
// warp with shuffles and over the block in shared memory, and one thread
// per block adds them into the output with atomicAdd. The sum is a wrapping
// u64 sum, exact in any order, so the result is bit-identical to the plain
// version. The dump row (the last) is excluded, as in the JAX function.
#include <cuda_runtime.h>

#include "fp.cuh"
#include "hash.cuh"

#define FP_THREADS 256
#define FP_BLOCKS_PER_SM 8
#define SMS 132

__global__ void fp_table(const uint32_t* __restrict__ rows, long long n_rows, ull* out_sum,
                         ull* out_count) {
  ull sum = 0, count = 0;
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n_rows; r += stride) {
    const uint32_t* p = rows + r * ROW_WORDS;
    Key4 k = key_at(p);
    if (key_empty(k) || key_tomb(k)) continue;
    sum += fp_row_hash(load_row(p));
    count += 1;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sum += __shfl_down_sync(0xFFFFFFFFu, sum, off);
    count += __shfl_down_sync(0xFFFFFFFFu, count, off);
  }
  __shared__ ull s_sum[FP_THREADS / 32], s_count[FP_THREADS / 32];
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_sum[warp] = sum;
    s_count[warp] = count;
  }
  __syncthreads();
  if (warp != 0) return;
  sum = lane < FP_THREADS / 32 ? s_sum[lane] : 0ull;
  count = lane < FP_THREADS / 32 ? s_count[lane] : 0ull;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sum += __shfl_down_sync(0xFFFFFFFFu, sum, off);
    count += __shfl_down_sync(0xFFFFFFFFu, count, off);
  }
  if (lane == 0 && count != 0) {
    atomicAdd(out_sum, sum);
    atomicAdd(out_count, count);
  }
}

static void launch_fp_table(const uint32_t* rows, long long n_rows, ull* out_sum,
                            ull* out_count, cudaStream_t stream) {
  long long blocks = (n_rows + FP_THREADS - 1) / FP_THREADS;
  if (blocks > SMS * FP_BLOCKS_PER_SM) blocks = SMS * FP_BLOCKS_PER_SM;
  if (blocks < 1) blocks = 1;
  fp_table<<<(int)blocks, FP_THREADS, 0, stream>>>(rows, n_rows, out_sum, out_count);
}

// out (u64 [5]): accounts_fp, transfers_fp, accounts, transfers,
// commit_timestamp. `*_slots` are the tables' capacities (rows less the dump
// row).
extern "C" int tb_fingerprint(const uint32_t* acct_rows, long long acct_slots,
                              const uint32_t* xfer_rows, long long xfer_slots,
                              const ull* commit_ts, ull* out, cudaStream_t stream) {
  cudaMemsetAsync(out, 0, 4 * sizeof(ull), stream);
  launch_fp_table(acct_rows, acct_slots, out + 0, out + 2, stream);
  launch_fp_table(xfer_rows, xfer_slots, out + 1, out + 3, stream);
  cudaMemcpyAsync(out + 4, commit_ts, sizeof(ull), cudaMemcpyDeviceToDevice, stream);
  return (int)cudaGetLastError();
}
