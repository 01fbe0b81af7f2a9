// K2: create_accounts commit, fast and serial.
//
// Replaces tigerbeetle_tpu/models/ledger.py LedgerKernels._commit_accounts
// (fast, :1284-1336) and _serial_accounts (:1338-1438), jitted at :737.
//
// Fast: one thread per event runs the exists probe (W = 32) and
// validate_create_account; the shared claim rounds (claim.cu) give every
// valid event a distinct free slot; one thread folds the fault gate
// (sticky fault, unresolved probe, lost claim, load-factor guard) into
// `fault` on the device, and the last launch writes the rows only if the
// gate passed. No host sync anywhere. Bound: bytes (a batch row in and out,
// a few 32-byte probe sectors per event).
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

#include "account_walk.cuh"
#include "claim.cuh"
#include "hash.cuh"
#include "validate.cuh"

struct AcctHdr {
  uint32_t bad, proceed;
  ull ok_n, max_ts;
};

struct AcctFast {
  uint32_t* rows;
  uint32_t* claim;
  int a_log2;
  ull* commit_ts;
  ull* count;
  ull* used;
  uint32_t* fault;
  const uint32_t* batch;
  int B, n;
  ull timestamp;
  int32_t* results;
  AcctHdr* hdr;
  int32_t* ok;
  int64_t* slot;
  ClaimScratch claim_sc;
};

static AcctFast carve_fast(char* scratch, int B, size_t* size) {
  AcctFast a{};
  Carver c{scratch, 0};
  a.hdr = c.take<AcctHdr>(1);
  a.ok = c.take<int32_t>(B);
  a.slot = c.take<int64_t>(B);
  a.claim_sc.cand = c.take<int64_t>(B);
  a.claim_sc.want = c.take<int32_t>(B);
  a.claim_sc.won = c.take<int32_t>(B);
  *size = c.off + 256;
  return a;
}

extern "C" size_t tb_commit_accounts_fast_scratch(int B) {
  size_t size;
  carve_fast(nullptr, B, &size);
  return size;
}

__device__ __forceinline__ ull event_ts(ull timestamp, int n, int i) {
  return timestamp - (ull)n + (ull)i + 1ull;
}

__global__ void accounts_validate(AcctFast a) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.B) return;
  Row row = load_row(a.batch + (size_t)i * ROW_WORDS);
  Acct e = unpack_account(row);
  bool valid = i < a.n;
  Found ex = table_lookup(a.rows, a.a_log2, key_in(row, 0), WINDOW);
  Acct exr = unpack_account(load_row(a.rows + (size_t)ex.slot * ROW_WORDS));
  uint32_t r = validate_create_account(e.ts != 0 ? 3u : 0u, e, exr, ex.found);
  if (!valid) r = 0u;
  bool ok = valid && r == 0u;
  a.results[i] = (int32_t)r;
  a.ok[i] = ok;
  if (valid && !ex.resolved) atomicOr(&a.hdr->bad, FAULT_PROBE);
  if (ok) {
    atomicAdd(&a.hdr->ok_n, 1ull);
    atomicMax(&a.hdr->max_ts, event_ts(a.timestamp, a.n, i));
  }
}

__global__ void accounts_finalize(AcctFast a) {
  ull ok_n = a.hdr->ok_n;
  uint32_t f = *a.fault | a.hdr->bad;
  if (*a.used + ok_n > (1ull << a.a_log2) / 2) f |= FAULT_CAPACITY;
  *a.fault = f;
  a.hdr->proceed = f == 0u;
  if (f == 0u) {
    if (ok_n) *a.commit_ts = a.hdr->max_ts;
    *a.count += ok_n;
    *a.used += ok_n;
  }
}

__global__ void accounts_apply(AcctFast a) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.B || !a.ok[i] || !a.hdr->proceed) return;
  Row row = load_row(a.batch + (size_t)i * ROW_WORDS);
  put64(row, 30, event_ts(a.timestamp, a.n, i));
  store_row(a.rows + (size_t)a.slot[i] * ROW_WORDS, row);
}

extern "C" int tb_commit_accounts_fast(uint32_t* acct_rows, uint32_t* acct_claim, int a_log2,
                                       ull* commit_ts, ull* acct_count, ull* acct_used,
                                       uint32_t* fault, const uint32_t* batch, int B, int n,
                                       ull timestamp, int32_t* results, char* scratch,
                                       cudaStream_t stream) {
  size_t size;
  AcctFast a = carve_fast(scratch, B, &size);
  a.rows = acct_rows;
  a.claim = acct_claim;
  a.a_log2 = a_log2;
  a.commit_ts = commit_ts;
  a.count = acct_count;
  a.used = acct_used;
  a.fault = fault;
  a.batch = batch;
  a.B = B;
  a.n = n;
  a.timestamp = timestamp;
  a.results = results;
  cudaMemsetAsync(a.hdr, 0, sizeof(AcctHdr), stream);
  int g = grid_for(B);
  accounts_validate<<<g, LANES_PER_BLOCK, 0, stream>>>(a);
  claim_slots(batch, ROW_WORDS, a.ok, B, acct_rows, acct_claim, a_log2, a.slot, a.claim_sc,
              &a.hdr->bad, stream);
  accounts_finalize<<<1, 1, 0, stream>>>(a);
  accounts_apply<<<g, LANES_PER_BLOCK, 0, stream>>>(a);
  return (int)cudaGetLastError();
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
