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
// Serial: one thread walks the events in order, as K2 serial, with the
// JAX mesh's entry gate (all n events charged against every shard: a
// tripped gate makes n = 0), W = 64 probes, and an undo log of global
// slots; a broken chain tombstones its inserts on their owner shards;
// `acct_used_slots` counts every applied insert on its owner, rolled back
// or not. Bound: latency, a chain of dependent probes per event.
#include <cuda_runtime.h>

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

__global__ void mesh_accounts_serial(uint32_t* rows, int a_log2, int n_shards, ull* commit_ts,
                                     ull* count, ull* used, uint32_t* fault, const uint32_t* batch,
                                     int B, int n, ull timestamp, int32_t* results,
                                     int64_t* undo_slot, int32_t* undo_kind) {
  if (threadIdx.x != 0 || blockIdx.x != 0) return;
  uint32_t fault0 = *fault;
  for (int s = 0; s < n_shards; s++) {
    if (used[s] + (ull)n > (1ull << a_log2) / 2) fault0 |= FAULT_CAPACITY;
  }
  if (fault0) n = 0;
  for (int i = 0; i < B; i++) results[i] = 0;
  Row tomb;
  for (int k = 0; k < ROW_WORDS; k++) tomb.w[k] = TOMB_WORD;
  ull applied[MESH_SHARDS_MAX];
  for (int s = 0; s < n_shards; s++) applied[s] = 0;
  int chain_start = -1;
  bool chain_broken = false, probe_bad = false;
  ull cts = *commit_ts, ok_n = 0;
  for (int i = 0; i < n; i++) {
    Row row = load_row(batch + (size_t)i * ROW_WORDS);
    Acct e = unpack_account(row);
    bool linked = (e.flags & A_LINKED) != 0u;
    if (linked && chain_start < 0) chain_start = i;
    bool in_chain = chain_start >= 0;
    uint32_t r = (in_chain && i == n - 1 && linked) ? 2u
                 : chain_broken                     ? 1u
                 : e.ts != 0                        ? 3u
                                                    : 0u;
    Key4 key = key_in(row, 0);
    int owner = owner_of(key, n_shards);
    size_t base = shard_base(owner, a_log2);
    Found ex = owner_lookup(rows, a_log2, n_shards, key, WINDOW_SCALAR);
    r = validate_create_account(r, e, unpack_account(found_row(rows, ex)), ex.found);
    bool ok = r == 0u;
    Found fr = table_probe_free(rows + base * ROW_WORDS, a_log2, key, WINDOW_SCALAR);
    if (!ex.resolved || (ok && !fr.resolved)) probe_bad = true;
    undo_kind[i] = ok;
    undo_slot[i] = (int64_t)base + fr.slot;
    if (ok) {
      ull ts = event_ts(timestamp, n, i);
      if (fr.resolved) {
        put64(row, 30, ts);
        store_row(rows + (size_t)undo_slot[i] * ROW_WORDS, row);
      }
      cts = ts;
      applied[owner]++;
    }
    if (r != 0u && in_chain && !chain_broken) {  // roll back [chain_start, i)
      for (int k = chain_start; k < i; k++) {
        if (undo_kind[k]) store_row(rows + (size_t)undo_slot[k] * ROW_WORDS, tomb);
        results[k] = 1;
      }
      chain_broken = true;
    }
    results[i] = (int32_t)r;
    if (in_chain && (!linked || r == 2u)) {
      chain_start = -1;
      chain_broken = false;
    }
  }
  for (int i = 0; i < n; i++) ok_n += results[i] == 0;
  *commit_ts = cts;
  *count += ok_n;
  for (int s = 0; s < n_shards; s++) used[s] += applied[s];
  *fault = fault0 | (probe_bad ? FAULT_SERIAL : 0u);
}

extern "C" size_t tb_mesh_commit_accounts_serial_scratch(int B) {
  Carver c{nullptr, 0};
  c.take<int64_t>(B);
  c.take<int32_t>(B);
  return c.off + 256;
}

extern "C" int tb_mesh_commit_accounts_serial(uint32_t* acct_rows, int a_log2, int n_shards,
                                              ull* commit_ts, ull* acct_count, ull* acct_used,
                                              uint32_t* fault, const uint32_t* batch, int B,
                                              int n, ull timestamp, int32_t* results,
                                              char* scratch, cudaStream_t stream) {
  Carver c{scratch, 0};
  int64_t* undo_slot = c.take<int64_t>(B);
  int32_t* undo_kind = c.take<int32_t>(B);
  mesh_accounts_serial<<<1, 1, 0, stream>>>(acct_rows, a_log2, n_shards, commit_ts, acct_count,
                                            acct_used, fault, batch, B, n, timestamp, results,
                                            undo_slot, undo_kind);
  return (int)cudaGetLastError();
}
