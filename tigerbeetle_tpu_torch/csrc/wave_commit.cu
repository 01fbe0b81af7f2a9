// K12: the conflict waves of one create_transfers batch, as one launch of
// one thread-block cluster.
//
// Replaces tigerbeetle_tpu/models/ledger.py DeviceLedger._wave_stepper
// (:2261-2291): a lax.scan of the masked fast/fast_pv commit over the W
// wave masks of one uploaded batch, with the waves' codes max-folded. Its
// caller, DeviceLedger._execute_waves, pads W to a bucket (_WAVE_BUCKETS)
// so that XLA compiles a few shapes; here W is a loop count and nothing is
// padded.
//
// Bound on an H100: bytes, as K3's for the batch (each lane is live in one
// wave: its row in, its probe sectors, its account rows, its stored row and
// code out), about 0.0013 ms for 8190 events. The floor that one cluster's
// phases set is W bodies: each wave passes K3's five cluster barriers, and
// its fold and apply stride over the batch's 2B (lane, side) words.
//
// Design: one kernel over one cluster (cluster.cuh) loops over the waves
// and runs K3's phase body (xfer_commit_slot, xfer_commit.cuh) for each,
// as the group commit (K5, group_commit.cu) runs it for each slot: wave w
// sees the state wave w - 1 left, through the barrier that opens each body
// (whose wait invalidates L1; the claim selects read past it, kPastL1), so
// a post in wave w + 1 finds the pending that wave w stored, and a limit
// account's balance what the waves before it applied. `wave_of` (one byte a
// lane, 255 for the lanes of the serial residue) is uploaded once with the
// batch. In each wave, a lane of another wave takes no probe and writes
// only the scratch words that the later phases read (idle_lane): a wave's
// work is its own lanes' probes and rows, plus a pass over the batch's
// scratch words. A lane's code is written in its own wave; wave 0 writes
// every lane's, so the codes need no memset. Every wave's timestamps are
// the whole batch's (event_ts(timestamp, n, i)). The gate's sticky fault
// makes every wave after a faulting one a no-op, and its capacity guard
// reads the stored rows that the earlier waves added to `used`.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "xfer_commit.cuh"

namespace cg = cooperative_groups;

#define WAVE_MAX 24  // models/ledger.py WAVE_CAP

struct WaveLaunch {
  XferState st;
  XferBatch b;  // b.mask: each lane's wave
  int waves;
};

__global__ void __launch_bounds__(CLUSTER_THREADS, 1) wave_commit_kernel(WaveLaunch p) {
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ XferShared sh;
  for (int w = 0; w < p.waves; w++) {
    xfer_commit_slot<true, true>(cluster, p.st, p.b, sh, w);
  }
}

static void wave_allow_cluster() {
  static bool done = cudaFuncSetAttribute(wave_commit_kernel,
                                          cudaFuncAttributeNonPortableClusterSizeAllowed,
                                          1) == cudaSuccess;
  (void)done;
}

// Commit `batch` ([B, 32] rows, lanes < n) wave by wave, w = 0 .. waves - 1,
// the lanes of wave w those with wave_of[i] == w (a byte a lane), on
// `stream`: codes into `results` [B] (0 for a lane of no wave), the state
// updated in place; `scratch` holds tb_commit_transfers_fast_scratch(B)
// bytes.
extern "C" int tb_wave_commit(uint32_t* acct_rows, int a_log2, uint32_t* xfer_rows, int t_log2,
                              uint32_t* fulfill, uint32_t* xfer_claim, uint32_t* bal_acc,
                              ull* commit_ts, ull* xfer_count, ull* xfer_used, uint32_t* fault,
                              const uint32_t* batch, const uint8_t* wave_of, int B, int n,
                              ull timestamp, int waves, int pv_mode, int32_t* results,
                              char* scratch, cudaStream_t stream) {
  if (waves < 1 || waves > WAVE_MAX || n < 0 || n > B) return (int)cudaErrorInvalidValue;
  WaveLaunch p{};
  p.st = xfer_args(acct_rows, a_log2, xfer_rows, t_log2, fulfill, xfer_claim, bal_acc, commit_ts,
                   xfer_count, xfer_used, fault, B, pv_mode, scratch);
  p.b.batch = batch;
  p.b.mask = wave_of;
  p.b.n = n;
  p.b.timestamp = timestamp;
  p.b.results = results;
  p.waves = waves;
  wave_allow_cluster();
  launch_cluster(wave_commit_kernel, p, stream);
  return (int)cudaGetLastError();
}
