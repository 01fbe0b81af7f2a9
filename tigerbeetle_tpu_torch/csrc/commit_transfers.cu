// K3: create_transfers fast-tier commit (modes fast and fast_pv, with the
// wave mask), as one launch of one thread-block cluster.
//
// Replaces tigerbeetle_tpu/models/ledger.py LedgerKernels._commit_transfers
// (:805-993, jitted :733; with the wave mask for a request of one wave, as
// DeviceLedger._execute_waves runs it; the waves of a request of several
// are K12's, wave_commit.cu), with ops/hashtable.py `claim_slots` (:162) for
// the inserts.
//
// Bound on an H100: bytes. Per event it reads the 128-byte batch row, one
// 32-byte sector per probe of the debit, credit and id chains (fast_pv:
// also the pending and its two accounts), the touched account rows, and
// writes the stored row; the integer work is a few hundred operations.
// What held the launch-per-phase design back was not bytes but its 13
// launches and a memset per call (about 8 us each against 1.3 us of
// bytes): every phase needs all of the one before, and blocks run in no
// order, so each barrier was a kernel boundary.
//
// Design: one kernel over one cluster of CLUSTER_BLOCKS blocks of
// CLUSTER_THREADS threads (cluster.cuh, whose row phases K11tf shares).
// Lane loops stride over the cluster, so any B works. Its phases (validate
// and claim round 0, claim rounds, fold, gate, apply, with a cluster
// barrier where a kernel boundary stood) are `xfer_commit_slot` of
// xfer_commit.cuh, which the group commit (K5, group_commit.cu) runs once
// per slot in one launch.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "xfer_commit.cuh"

namespace cg = cooperative_groups;

extern "C" size_t tb_commit_transfers_fast_scratch(int B) {
  size_t size;
  xfer_carve(nullptr, B, &size);
  return size;
}

struct XferLaunch {
  XferState st;
  XferBatch b;
};

__global__ void __launch_bounds__(CLUSTER_THREADS, 1) xfer_commit(XferLaunch p) {
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ XferShared sh;
  xfer_commit_slot<false>(cluster, p.st, p.b, sh);
}

// The cluster is non-portable (16 blocks), which a kernel must allow once;
// if that failed, the launch fails and says so.
static void xfer_commit_allow_cluster() {
  static bool done = cudaFuncSetAttribute(xfer_commit,
                                          cudaFuncAttributeNonPortableClusterSizeAllowed,
                                          1) == cudaSuccess;
  (void)done;
}

// Commit `batch` ([B, 32] rows, lanes < n, and in `mask` if it is not null)
// on `stream`: codes into `results` [B], the state updated in place;
// `scratch` holds tb_commit_transfers_fast_scratch(B) bytes.
extern "C" int tb_commit_transfers_fast(uint32_t* acct_rows, int a_log2, uint32_t* xfer_rows,
                                        int t_log2, uint32_t* fulfill, uint32_t* xfer_claim,
                                        uint32_t* bal_acc, ull* commit_ts, ull* xfer_count,
                                        ull* xfer_used, uint32_t* fault, const uint32_t* batch,
                                        const uint8_t* mask, int B, int n, ull timestamp,
                                        int pv_mode, int32_t* results, char* scratch,
                                        cudaStream_t stream) {
  XferLaunch p{};
  p.st = xfer_args(acct_rows, a_log2, xfer_rows, t_log2, fulfill, xfer_claim, bal_acc, commit_ts,
                   xfer_count, xfer_used, fault, B, pv_mode, scratch);
  p.b.batch = batch;
  p.b.mask = mask;
  p.b.n = n;
  p.b.timestamp = timestamp;
  p.b.results = results;
  xfer_commit_allow_cluster();
  launch_cluster(xfer_commit, p, stream);
  return (int)cudaGetLastError();
}
