// K5: the fused group commit of k fast-tier create_transfers batches, as
// one launch of one thread-block cluster.
//
// Replaces tigerbeetle_tpu/models/ledger.py DeviceLedger._group_stepper
// (:2384-2421): a lax.scan of the fast commit over k batch slots, then the
// per-slot failure counts and the fault word.
//
// Bound on an H100: bytes, the sum over the slots of K3's bytes (each
// slot's rows in, its probe sectors, its distinct account rows read and
// written, its stored rows and codes out): about 0.021 ms for 16 x 8190.
// The floor that one cluster's phases set is k times K3's body (about 40
// us on an H100 for 8190 events, cluster_split.py): about 0.65 ms for 16.
//
// Design: one kernel over one cluster (cluster.cuh) loops over the slots
// and runs K3's phase body (xfer_commit_slot, xfer_commit.cuh) for each, so
// slot i sees the state slot i - 1 left: the body's first cluster barrier
// stands between one slot's apply and the next slot's validate. A fault in
// one slot makes every later slot a no-op through K3's own sticky gate; a
// padding slot (n = 0) validates no lane and changes no state word. The
// slots' counts and timestamps come in the argument struct (no host loop
// enqueues anything); scratch, the claim column and `bal_acc` are reused
// slot after slot, as K3 reuses them launch after launch. Each slot's gate
// thread writes the slot's count of non-zero codes (the codes of lanes >=
// n are 0) into `summary`; after the last slot one thread writes the fault
// word after them and after the codes in `flat`: no summary kernel, no
// memset. Later slots read what earlier ones wrote from other SMs: the
// barrier before each slot invalidates L1, and the claim selects read past
// it (xfer_commit.cuh). Each slot's batch fields sit in shared memory,
// written once at the start.
//
// What this costs (cluster_split.py, on an H100): a slot takes about 50 us
// against K3's 41, most of it in validate. K3's one body fits in 127 of the
// 128 registers a thread of 512 may have; with the body in a loop (or twice
// in a row) ptxas spills about 600 bytes a thread, nearly all of it in
// validate, whether the state comes from the parameters or from shared
// memory. Prefetching the next slot's rows into L2 gained nothing, so it
// is not done.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "xfer_commit.cuh"

namespace cg = cooperative_groups;

#define GROUP_K_MAX 16

struct GroupArgs {
  XferState st;          // the state and the scratch
  const uint32_t* rows;  // [k, B, 32]
  int k;
  int n[GROUP_K_MAX];
  ull ts[GROUP_K_MAX];
  int32_t* flat;     // [k * B + 1]
  int32_t* summary;  // [k + 1]
};

__global__ void __launch_bounds__(CLUSTER_THREADS, 1) group_commit_kernel(GroupArgs g) {
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ XferShared sh;
  __shared__ XferBatch slots[GROUP_K_MAX];
  if (threadIdx.x == 0) {  // constant indices: the arrays stay in the parameters
    const size_t slot_words = (size_t)g.st.B * ROW_WORDS;
#pragma unroll
    for (int s = 0; s < GROUP_K_MAX; s++) {
      XferBatch& b = slots[s];
      b.batch = g.rows + s * slot_words;
      b.mask = nullptr;
      b.n = g.n[s];
      b.timestamp = g.ts[s];
      b.results = g.flat + (size_t)s * g.st.B;
      b.fails = g.summary + s;
    }
  }
  __syncthreads();
  for (int s = 0; s < g.k; s++) {
    xfer_commit_slot<true>(cluster, g.st, slots[s], sh);
  }
  // the last gate's thread wrote the fault word
  if (cluster.thread_rank() == 0) {
    const int32_t f = (int32_t)*g.st.fault;
    g.summary[g.k] = f;
    g.flat[(size_t)g.k * g.st.B] = f;
  }
}

static void group_allow_cluster() {
  static bool done = cudaFuncSetAttribute(group_commit_kernel,
                                          cudaFuncAttributeNonPortableClusterSizeAllowed,
                                          1) == cudaSuccess;
  (void)done;
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
  GroupArgs g{};
  g.st = xfer_args(acct_rows, a_log2, xfer_rows, t_log2, fulfill, xfer_claim, bal_acc, commit_ts,
                   xfer_count, xfer_used, fault, n_pad, 0, scratch);
  g.rows = rows;
  g.k = k;
  for (int i = 0; i < k; i++) {
    if (ns[i] < 0 || ns[i] > n_pad) return (int)cudaErrorInvalidValue;
    g.n[i] = ns[i];
    g.ts[i] = tss[i];
  }
  g.flat = flat;
  g.summary = summary;
  group_allow_cluster();
  launch_cluster(group_commit_kernel, g, stream);
  return (int)cudaGetLastError();
}
