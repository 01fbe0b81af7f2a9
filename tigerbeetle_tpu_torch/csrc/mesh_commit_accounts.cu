// K11 account commits of the sharded ledger, fast and serial.
//
// Replaces tigerbeetle_tpu/parallel/mesh.py
// ShardedLedgerKernels._commit_accounts_fast (:340-404) and
// _commit_accounts_serial (:723-838), as commit_accounts.cu (K2) replaces
// the single-table pair. Every probe goes to the key's owner shard
// (owner.cuh); every insert lands there.
//
// Fast: K2 fast's one cluster launch (acct_commit.cuh) with the owner-shard
// policy (AcctShards): each lane probes and claims on its id's owner shard,
// the lowest lane winning each (shard, slot), each block counts the inserts
// each shard owns, and block 0's first warp decides the gate for the whole
// batch (sticky fault, unresolved probe, lost claim, and each shard's load
// guard charged with the inserts it owns) before anything is written.
// Bound: bytes (a batch row in and out, a code, a 32-byte sector a probe).
//
// Serial: account_walk.cuh's plan and one-warp walk, as K2 serial, with the
// owner-shard policy (every probe and insert on the key's owner, slots as
// global rows, so the undo list needs no per-shard copies), the JAX mesh's
// entry gate (all n events charged against every shard: a tripped gate
// makes n = 0) and W = 64 probes; a broken chain tombstones its inserts on
// their owner shards; `acct_used_slots` counts every applied insert on its
// owner, rolled back or not. Bound: account_walk.cuh's.
#include <cuda_runtime.h>

#include "acct_commit.cuh"
#include "account_walk.cuh"

extern "C" size_t tb_mesh_commit_accounts_fast_scratch(int B) {
  size_t size;
  acct_fast_carve(nullptr, B, &size);
  return size;
}

// Commit `batch` ([B, 32] rows, lanes < n) into the n_shards tables of
// `acct_rows` on `stream`: codes into `results` [B], the state updated in
// place (`acct_used` [n_shards]); `scratch` holds
// tb_mesh_commit_accounts_fast_scratch(B) bytes.
extern "C" int tb_mesh_commit_accounts_fast(uint32_t* acct_rows, uint32_t* acct_claim, int a_log2,
                                            int n_shards, ull* commit_ts, ull* acct_count,
                                            ull* acct_used, uint32_t* fault, const uint32_t* batch,
                                            int B, int n, ull timestamp, int32_t* results,
                                            char* scratch, cudaStream_t stream) {
  if (n_shards < 1 || n_shards > MESH_SHARDS_MAX) return (int)cudaErrorInvalidValue;
  size_t size;
  AcctFast a = acct_fast_carve(scratch, B, &size);
  a.rows = acct_rows;
  a.claim = acct_claim;
  a.log2 = a_log2;
  a.n_shards = n_shards;
  a.commit_ts = commit_ts;
  a.count = acct_count;
  a.used = acct_used;
  a.fault = fault;
  a.batch = batch;
  a.B = B;
  a.n = n;
  a.timestamp = timestamp;
  a.results = results;
  return acct_fast_launch<AcctShards>(a, stream);
}

// ---------------------------------------------------------------------------
// serial
// ---------------------------------------------------------------------------

extern "C" size_t tb_mesh_commit_accounts_serial_scratch(int B) {
  size_t size;
  acct_walk_carve(nullptr, B, &size);
  return size;
}

extern "C" int tb_mesh_commit_accounts_serial(uint32_t* acct_rows, int a_log2, int n_shards,
                                              ull* commit_ts, ull* acct_count, ull* acct_used,
                                              uint32_t* fault, const uint32_t* batch, int B,
                                              int n, ull timestamp, int32_t* results,
                                              char* scratch, cudaStream_t stream) {
  if (n_shards < 1 || n_shards > MESH_SHARDS_MAX) return (int)cudaErrorInvalidValue;
  size_t size;
  AcctWalkArgs a{};
  a.sc = acct_walk_carve(scratch, B, &size);
  a.rows = acct_rows;
  a.log2 = a_log2;
  a.commit_ts = commit_ts;
  a.count = acct_count;
  a.used = acct_used;
  a.fault = fault;
  a.batch = batch;
  a.B = B;
  a.n = n;
  a.timestamp = timestamp;
  a.results = results;
  return acct_walk_launch(a, AcctShards{n_shards}, stream);
}
