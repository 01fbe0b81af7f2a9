// K11 account commits of the sharded ledger, fast and serial.
//
// Replaces tigerbeetle_tpu/parallel/mesh.py
// ShardedLedgerKernels._commit_accounts_fast (:340-404) and
// _commit_accounts_serial (:723-838), as commit_accounts.cu (K2) replaces
// the single-table pair. Every probe goes to the key's owner shard
// (owner.cuh); every insert lands there.
//
// Fast: one thread per event runs the exists probe (W = 32) and
// validate_create_account, counts the inserts each shard owns; the claim
// rounds (claim.cu, per-lane shard) give every valid event a free slot in
// its owner's table, the lowest lane winning each (shard, slot); one thread
// decides the fault gate for the whole batch (sticky fault, unresolved
// probe, lost claim, and each shard's load guard charged with the inserts
// it owns) before the last launch writes anything. Bound: bytes (a batch
// row in and out, a few 32-byte probe sectors per event).
//
// Serial: account_walk.cuh's plan and one-warp walk, as K2 serial, with the
// owner-shard policy (every probe and insert on the key's owner, slots as
// global rows, so the undo list needs no per-shard copies), the JAX mesh's
// entry gate (all n events charged against every shard: a tripped gate
// makes n = 0) and W = 64 probes; a broken chain tombstones its inserts on
// their owner shards; `acct_used_slots` counts every applied insert on its
// owner, rolled back or not. Bound: account_walk.cuh's.
#include <cuda_runtime.h>

#include "account_walk.cuh"
#include "claim.cuh"
#include "owner.cuh"
#include "validate.cuh"

struct MeshAcctHdr {
  uint32_t bad, proceed;
  ull ok_n, max_ts;
  ull ins_n[MESH_SHARDS_MAX];
};

struct MeshAcctFast {
  uint32_t* rows;
  uint32_t* claim;
  int a_log2, n_shards;
  ull* commit_ts;
  ull* count;
  ull* used;  // [n_shards]
  uint32_t* fault;
  const uint32_t* batch;
  int B, n;
  ull timestamp;
  int32_t* results;
  MeshAcctHdr* hdr;
  int32_t* ok;
  int32_t* shard;
  int64_t* slot;
  ClaimScratch claim_sc;
};

static MeshAcctFast carve_fast(char* scratch, int B, size_t* size) {
  MeshAcctFast a{};
  Carver c{scratch, 0};
  a.hdr = c.take<MeshAcctHdr>(1);
  a.ok = c.take<int32_t>(B);
  a.shard = c.take<int32_t>(B);
  a.slot = c.take<int64_t>(B);
  a.claim_sc.cand = c.take<int64_t>(B);
  a.claim_sc.want = c.take<int32_t>(B);
  a.claim_sc.won = c.take<int32_t>(B);
  *size = c.off + 256;
  return a;
}

extern "C" size_t tb_mesh_commit_accounts_fast_scratch(int B) {
  size_t size;
  carve_fast(nullptr, B, &size);
  return size;
}

__device__ __forceinline__ ull event_ts(ull timestamp, int n, int i) {
  return timestamp - (ull)n + (ull)i + 1ull;
}

__global__ void mesh_accounts_validate(MeshAcctFast a) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.B) return;
  Row row = load_row(a.batch + (size_t)i * ROW_WORDS);
  Acct e = unpack_account(row);
  bool valid = i < a.n;
  Key4 key = key_in(row, 0);
  int owner = owner_of(key, a.n_shards);
  Found ex = owner_lookup(a.rows, a.a_log2, a.n_shards, key, WINDOW);
  Acct exr = unpack_account(found_row(a.rows, ex));
  uint32_t r = validate_create_account(e.ts != 0 ? 3u : 0u, e, exr, ex.found);
  if (!valid) r = 0u;
  bool ok = valid && r == 0u;
  a.results[i] = (int32_t)r;
  a.ok[i] = ok;
  a.shard[i] = owner;
  if (valid && !ex.resolved) atomicOr(&a.hdr->bad, FAULT_PROBE);
  if (ok) {
    atomicAdd(&a.hdr->ok_n, 1ull);
    atomicAdd(&a.hdr->ins_n[owner], 1ull);
    atomicMax(&a.hdr->max_ts, event_ts(a.timestamp, a.n, i));
  }
}

__global__ void mesh_accounts_finalize(MeshAcctFast a) {
  uint32_t f = *a.fault | a.hdr->bad;
  ull half = (1ull << a.a_log2) / 2;
  for (int s = 0; s < a.n_shards; s++) {
    if (a.used[s] + a.hdr->ins_n[s] > half) f |= FAULT_CAPACITY;
  }
  *a.fault = f;
  a.hdr->proceed = f == 0u;
  if (f == 0u) {
    if (a.hdr->ok_n) *a.commit_ts = a.hdr->max_ts;
    *a.count += a.hdr->ok_n;
    for (int s = 0; s < a.n_shards; s++) a.used[s] += a.hdr->ins_n[s];
  }
}

__global__ void mesh_accounts_apply(MeshAcctFast a) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.B || !a.ok[i] || !a.hdr->proceed) return;
  Row row = load_row(a.batch + (size_t)i * ROW_WORDS);
  put64(row, 30, event_ts(a.timestamp, a.n, i));
  store_row(a.rows + (size_t)a.slot[i] * ROW_WORDS, row);
}

extern "C" int tb_mesh_commit_accounts_fast(uint32_t* acct_rows, uint32_t* acct_claim, int a_log2,
                                            int n_shards, ull* commit_ts, ull* acct_count,
                                            ull* acct_used, uint32_t* fault, const uint32_t* batch,
                                            int B, int n, ull timestamp, int32_t* results,
                                            char* scratch, cudaStream_t stream) {
  size_t size;
  MeshAcctFast a = carve_fast(scratch, B, &size);
  a.rows = acct_rows;
  a.claim = acct_claim;
  a.a_log2 = a_log2;
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
  cudaMemsetAsync(a.hdr, 0, sizeof(MeshAcctHdr), stream);
  int g = grid_for(B);
  mesh_accounts_validate<<<g, LANES_PER_BLOCK, 0, stream>>>(a);
  claim_slots(batch, ROW_WORDS, a.ok, B, acct_rows, acct_claim, a_log2, a.slot, a.claim_sc,
              &a.hdr->bad, stream, a.shard);
  mesh_accounts_finalize<<<1, 1, 0, stream>>>(a);
  mesh_accounts_apply<<<g, LANES_PER_BLOCK, 0, stream>>>(a);
  return (int)cudaGetLastError();
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
