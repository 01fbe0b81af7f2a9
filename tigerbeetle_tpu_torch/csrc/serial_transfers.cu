// K4: the exact, event-at-a-time create_transfers commit on one table.
//
// Replaces tigerbeetle_tpu/models/ledger.py
// LedgerKernels._serial_transfers_core (:1004-1283): commit_transfers in
// mode serial, and commit_transfers_residue (:743) for the wave executor's
// residue, with explicit per-event timestamps (a residue keeps its events'
// original, scattered batch timestamps).
//
// Bound on an H100: the events form one dependent chain (event i may read
// balances that event i - 1 wrote), so at least one shared-memory round
// trip an event once every lookup is resolved ahead; else bytes: the batch
// rows, a sector per probe and the rows written.
//
// Design: serial_walk.cuh's one-block walk (warp-wide probes, a lookahead
// ring of prefetch warps, a walker warp checking each entry against its
// write log), as K11ts (mesh_serial_transfers.cu) runs it, with the
// single-table policy below: one shard at row 0, each event's timestamp
// from `ts_vec`, and the JAX scan's rules where they differ from the
// sharded one's: a lookup that finds nothing reads the row and fulfill word
// at the slot it returned (the pending's accounts are then probed with that
// row's keys, and an unresolved probe there sets FAULT_SERIAL too); commit_ts
// becomes the unsigned max of itself and each applied event's timestamp
// (earlier waves may have committed later lanes) and is not restored on
// rollback; `xfer_used_slots` counts every applied insert, rolled back or
// not. Entry gates as in JAX: the sticky fault, and the load guard charged
// for all n events against `t_dump / 2` (a tripped gate makes n = 0).
#include <cuda_runtime.h>

#include "serial_walk.cuh"

struct OneTable {
  static constexpr bool zero_missing = false;  // the row at the returned slot
  int n_shards;  // 1
  const ull* ts_vec;
  __device__ int owner(const Key4&) const { return 0; }
  __device__ int64_t base(int, int) const { return 0; }
  __device__ ull ts(int i, int) const { return ts_vec[i]; }
  __device__ ull commit(ull cts, ull ts) const { return ts > cts ? ts : cts; }
};

extern "C" size_t tb_commit_transfers_serial_scratch(int B) {
  size_t size;
  walk_carve_undo(nullptr, B, &size);
  return size;
}

extern "C" int tb_commit_transfers_serial(uint32_t* acct_rows, int a_log2, uint32_t* xfer_rows,
                                          int t_log2, uint32_t* fulfill, ull* commit_ts,
                                          ull* xfer_count, ull* xfer_used, uint32_t* fault,
                                          const uint32_t* batch, const ull* ts_vec, int B, int n,
                                          int32_t* results, char* scratch, cudaStream_t stream) {
  size_t size;
  WalkUndo u = walk_carve_undo(scratch, B, &size);
  WalkTables tb{acct_rows, a_log2, xfer_rows, t_log2, fulfill};
  OneTable pol{1, ts_vec};
  serial_walk<<<1, WALK_THREADS, 0, stream>>>(tb, pol, commit_ts, xfer_count, xfer_used, fault,
                                               batch, B, n, results, u);
  return (int)cudaGetLastError();
}
