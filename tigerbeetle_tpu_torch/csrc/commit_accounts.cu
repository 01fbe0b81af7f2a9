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
// Serial: one thread walks the events in order and updates the table in
// place, with an undo log in the scratch buffer: a broken linked chain
// tombstones the inserts it made. Entry gates as in JAX: the sticky fault
// and the load-factor guard charged for all n events. Bound: latency, a
// chain of dependent probes per event (the events of a chain depend on each
// other, and the reference commits them one by one too).
#include <cuda_runtime.h>

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

__global__ void accounts_serial(uint32_t* rows, int a_log2, ull* commit_ts, ull* count,
                                ull* used, uint32_t* fault, const uint32_t* batch, int B, int n,
                                ull timestamp, int32_t* results, int64_t* undo_slot,
                                int32_t* undo_kind) {
  if (threadIdx.x != 0 || blockIdx.x != 0) return;
  uint32_t fault0 = *fault;
  if (*used + (ull)n > (1ull << a_log2) / 2) fault0 |= FAULT_CAPACITY;
  if (fault0) n = 0;
  for (int i = 0; i < B; i++) results[i] = 0;
  Row tomb;
  for (int k = 0; k < ROW_WORDS; k++) tomb.w[k] = TOMB_WORD;
  int chain_start = -1;
  bool chain_broken = false, probe_bad = false;
  ull cts = *commit_ts, ok_n = 0, applied_n = 0;
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
    Found ex = table_lookup(rows, a_log2, key, WINDOW_SCALAR);
    Acct exr = unpack_account(load_row(rows + (size_t)ex.slot * ROW_WORDS));
    r = validate_create_account(r, e, exr, ex.found);
    bool ok = r == 0u;
    Found fr = table_probe_free(rows, a_log2, key, WINDOW_SCALAR);
    if (!ex.resolved || (ok && !fr.resolved)) probe_bad = true;
    undo_kind[i] = ok;
    undo_slot[i] = fr.slot;
    if (ok) {
      ull ts = event_ts(timestamp, n, i);
      if (fr.resolved) {
        put64(row, 30, ts);
        store_row(rows + (size_t)fr.slot * ROW_WORDS, row);
      }
      cts = ts;
      applied_n++;
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
  *used += applied_n;
  *fault = fault0 | (probe_bad ? FAULT_SERIAL : 0u);
}

extern "C" size_t tb_commit_accounts_serial_scratch(int B) {
  Carver c{nullptr, 0};
  c.take<int64_t>(B);
  c.take<int32_t>(B);
  return c.off + 256;
}

extern "C" int tb_commit_accounts_serial(uint32_t* acct_rows, int a_log2, ull* commit_ts,
                                         ull* acct_count, ull* acct_used, uint32_t* fault,
                                         const uint32_t* batch, int B, int n, ull timestamp,
                                         int32_t* results, char* scratch, cudaStream_t stream) {
  Carver c{scratch, 0};
  int64_t* undo_slot = c.take<int64_t>(B);
  int32_t* undo_kind = c.take<int32_t>(B);
  accounts_serial<<<1, 1, 0, stream>>>(acct_rows, a_log2, commit_ts, acct_count, acct_used,
                                       fault, batch, B, n, timestamp, results, undo_slot,
                                       undo_kind);
  return (int)cudaGetLastError();
}
