// K2: create_accounts commit, fast and serial.
//
// Replaces tigerbeetle_tpu/models/ledger.py LedgerKernels._commit_accounts
// (fast, :1284-1336) and _serial_accounts (:1338-1438), jitted at :737.
//
// Fast: acct_commit.cuh's one launch of one thread-block cluster with the
// single-table policy (AcctOneTable): a lane an event probes and validates,
// claim round 0 follows at once, rounds 1-3 with a cluster barrier for each
// barrier of the rule, block 0's first warp decides the fault gate (sticky
// fault, unresolved probe, lost claim, the load guard charged with the ok
// count) and the rows are written only if it passed. No memset, no host
// sync. Bound: bytes (a batch row in and out, a code, a 32-byte sector a
// probe).
//
// Serial: account_walk.cuh's plan and one-warp walk on one table (the
// single-table policy, shard 0 at row 0): a warp an event plans against the
// table as it was, then one warp commits the events in order, re-probing an
// event only where a row the batch wrote lies in its window at or before
// the position its answers depend on, with an undo list for linked-chain
// rollback. Entry gates as in JAX: the sticky fault and the load-factor
// guard charged for all n events. Bound: account_walk.cuh's (the bytes, or a
// shared-memory round trip for each chained or re-probed event).
#include <cuda_runtime.h>

#include "acct_commit.cuh"
#include "account_walk.cuh"

extern "C" size_t tb_commit_accounts_fast_scratch(int B) {
  size_t size;
  acct_fast_carve(nullptr, B, &size);
  return size;
}

// Commit `batch` ([B, 32] rows, lanes < n) on `stream`: codes into
// `results` [B], the state updated in place; `scratch` holds
// tb_commit_accounts_fast_scratch(B) bytes.
extern "C" int tb_commit_accounts_fast(uint32_t* acct_rows, uint32_t* acct_claim, int a_log2,
                                       ull* commit_ts, ull* acct_count, ull* acct_used,
                                       uint32_t* fault, const uint32_t* batch, int B, int n,
                                       ull timestamp, int32_t* results, char* scratch,
                                       cudaStream_t stream) {
  size_t size;
  AcctFast a = acct_fast_carve(scratch, B, &size);
  a.rows = acct_rows;
  a.claim = acct_claim;
  a.log2 = a_log2;
  a.n_shards = 1;
  a.commit_ts = commit_ts;
  a.count = acct_count;
  a.used = acct_used;
  a.fault = fault;
  a.batch = batch;
  a.B = B;
  a.n = n;
  a.timestamp = timestamp;
  a.results = results;
  return acct_fast_launch<AcctOneTable>(a, stream);
}

// ---------------------------------------------------------------------------
// serial
// ---------------------------------------------------------------------------

extern "C" size_t tb_commit_accounts_serial_scratch(int B) {
  size_t size;
  acct_walk_carve(nullptr, B, &size);
  return size;
}

extern "C" int tb_commit_accounts_serial(uint32_t* acct_rows, int a_log2, ull* commit_ts,
                                         ull* acct_count, ull* acct_used, uint32_t* fault,
                                         const uint32_t* batch, int B, int n, ull timestamp,
                                         int32_t* results, char* scratch, cudaStream_t stream) {
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
  return acct_walk_launch(a, AcctOneTable{1}, stream);
}
