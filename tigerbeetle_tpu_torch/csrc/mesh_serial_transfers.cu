// K11 serial transfer commit of the sharded ledger: the exact,
// event-at-a-time scan.
//
// Replaces tigerbeetle_tpu/parallel/mesh.py
// ShardedLedgerKernels._commit_transfers_serial (:431-721): a lax.scan
// over the events in which every lookup is a probe of all shards combined
// by one psum (`_find1`, W = 64) and every write is masked to the owning
// shard, with per-shard undo slots for linked-chain rollback.
//
// Bound on an H100: the events form one dependent chain (event i may read
// balances that event i - 1 wrote), so at least one shared-memory round
// trip an event once every lookup is resolved ahead; else bytes: the batch
// rows, a sector per probe and the rows written.
//
// Design: serial_walk.cuh's one-block walk (warp-wide probes, lookahead
// ring, a walker warp checking each entry against its write log) with the
// owner-shard policy below: every probe on the key's owner shard
// (owner.cuh) and slots kept as global row indices, so the undo log needs
// no per-shard copies. The JAX quirks that decide faults and slots are
// kept: the pending's accounts are probed for every event, with key 0 from
// the zero row when the pending is missing (an unresolved probe there sets
// FAULT_SERIAL too); the insert goes to the first free slot of the id's
// owner; the fulfill word is written on the pending's owner; a rollback
// tombstones each insert on its owner; `commit_ts` is set to each applied
// event's timestamp and not restored on rollback; `xfer_used_slots` counts
// every applied insert on its owner, rolled back or not. Entry gates: the
// sticky fault, and the load guard with all n events charged against every
// shard (a tripped gate makes n = 0).
#include <cuda_runtime.h>

#include "serial_walk.cuh"

struct OwnerShards {
  int n_shards;
  ull timestamp;
  __device__ int owner(const Key4& k) const { return owner_of(k, n_shards); }
  __device__ int64_t base(int shard, int log2) const {
    return (int64_t)shard_base(shard, log2);
  }
  __device__ ull ts(int i, int n) const { return timestamp - (ull)n + (ull)i + 1ull; }
};

extern "C" size_t tb_mesh_commit_transfers_serial_scratch(int B) {
  size_t size;
  walk_carve_undo(nullptr, B, &size);
  return size;
}

extern "C" int tb_mesh_commit_transfers_serial(uint32_t* acct_rows, int a_log2,
                                               uint32_t* xfer_rows, int t_log2, int n_shards,
                                               uint32_t* fulfill, ull* commit_ts, ull* xfer_count,
                                               ull* xfer_used, uint32_t* fault,
                                               const uint32_t* batch, int B, int n,
                                               ull timestamp, int32_t* results,
                                               char* scratch, cudaStream_t stream) {
  if (n_shards < 1 || n_shards > MESH_SHARDS_MAX)
    return (int)cudaErrorInvalidValue;
  size_t size;
  WalkUndo u = walk_carve_undo(scratch, B, &size);
  WalkTables tb{acct_rows, a_log2, xfer_rows, t_log2, fulfill};
  OwnerShards pol{n_shards, timestamp};
  serial_walk<<<1, WALK_THREADS, 0, stream>>>(tb, pol, commit_ts, xfer_count, xfer_used, fault,
                                               batch, B, n, results, u);
  return (int)cudaGetLastError();
}
