// K5: the fused group commit of k fast-tier create_transfers batches.
//
// Replaces tigerbeetle_tpu/models/ledger.py DeviceLedger._group_stepper
// (:2384-2421): a lax.scan of the fast commit over k batch slots, then the
// per-slot failure counts and the fault word.
//
// Bound on an H100: bytes, the sum over the slots of K3's bytes (each
// slot's rows in, its probe sectors, its distinct account rows read and
// written, its stored rows and codes out).
//
// Design: one ctypes call per group. The host loop below enqueues K3
// (commit_transfers.cu, xfer_fast_enqueue: one cluster launch) once per
// slot on one stream, so slot i sees the state slot i - 1 left; a fault in
// one slot makes every later slot a no-op through K3's own sticky gate.
// Then one `group_summary` launch counts the non-zero codes over lanes <
// n_i of each slot and writes the fault word after the last slot into the
// summary and into the last word of the flat results. The slots share one
// scratch buffer: they run in stream order. A padding slot (n = 0) commits
// nothing and leaves every state word as it was, as in the JAX scan. This
// costs one launch per slot plus one: 17 for a group of 16.
#include <cuda_runtime.h>

#include "commit_transfers.cuh"
#include "hash.cuh"

#define GROUP_K_MAX 16

struct GroupNs {
  int n[GROUP_K_MAX];
};

__global__ void group_summary(const int32_t* __restrict__ flat, int k, int n_pad, GroupNs ns,
                              const uint32_t* fault, int32_t* flat_fault, int32_t* summary) {
  int slot = blockIdx.x;
  const int32_t* codes = flat + (size_t)slot * n_pad;
  int n = ns.n[slot];
  int count = 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) count += codes[i] != 0;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) count += __shfl_down_sync(0xFFFFFFFFu, count, off);
  __shared__ int s_count[LANES_PER_BLOCK / 32];
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) s_count[warp] = count;
  __syncthreads();
  if (threadIdx.x != 0) return;
  int total = 0;
  for (int w = 0; w < LANES_PER_BLOCK / 32; w++) total += s_count[w];
  summary[slot] = total;
  if (slot == 0) {
    int32_t f = (int32_t)*fault;
    summary[k] = f;
    *flat_fault = f;
  }
}

// rows: [k, n_pad, 32] staged batches on the device; ns, tss: host arrays of
// the k slots' event counts and timestamps; flat: [k * n_pad + 1] codes then
// the fault word; summary: [k + 1] failure counts then the fault word;
// scratch: tb_commit_transfers_fast_scratch(n_pad) bytes.
extern "C" int tb_group_commit(uint32_t* acct_rows, int a_log2, uint32_t* xfer_rows, int t_log2,
                               uint32_t* fulfill, uint32_t* xfer_claim, uint32_t* bal_acc,
                               ull* commit_ts, ull* xfer_count, ull* xfer_used, uint32_t* fault,
                               const uint32_t* rows, int k, int n_pad, const int* ns,
                               const ull* tss, int32_t* flat, int32_t* summary, char* scratch,
                               cudaStream_t stream) {
  if (k < 1 || k > GROUP_K_MAX) return (int)cudaErrorInvalidValue;
  GroupNs gn{};
  for (int i = 0; i < k; i++) {
    if (ns[i] < 0 || ns[i] > n_pad) return (int)cudaErrorInvalidValue;
    gn.n[i] = ns[i];
    xfer_fast_enqueue(acct_rows, a_log2, xfer_rows, t_log2, fulfill, xfer_claim, bal_acc,
                      commit_ts, xfer_count, xfer_used, fault,
                      rows + (size_t)i * n_pad * ROW_WORDS, nullptr, n_pad, ns[i], tss[i], 0,
                      flat + (size_t)i * n_pad, scratch, stream);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  group_summary<<<k, LANES_PER_BLOCK, 0, stream>>>(flat, k, n_pad, gn, fault,
                                                   flat + (size_t)k * n_pad, summary);
  return (int)cudaGetLastError();
}
