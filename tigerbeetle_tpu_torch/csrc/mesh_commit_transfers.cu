// K11 fast transfer commit of the sharded ledger.
//
// Replaces tigerbeetle_tpu/parallel/mesh.py
// ShardedLedgerKernels._commit_transfers_fast (:224-338): every shard
// probes the debit, credit and id chains of every lane, one psum combines
// the owner-masked rows, validation runs replicated, each shard claims
// slots for the ids it owns and folds the balance digits of the accounts
// it owns, and the fault word (PROBE | CLAIM | OVERFLOW | CAPACITY) is
// decided across all shards before any write.
//
// Bound on an H100: bytes, as K3 (commit_transfers.cu): per event the
// 128-byte batch row, one 32-byte sector per probe of its three chains, the
// touched account rows, and the stored row written.
//
// Design: K3's launch sequence with owner probes (owner.cuh) in place of
// the psum. (a) `mesh_xfer_validate`, one thread per event: the three
// probes on their owner shards, the ladder, and atomicAdd of the amount's
// 16-bit digits into the owner shard's `bal_acc` row of each account; the
// inserts each shard owns are counted for its load guard; then the claim
// rounds (claim.cu) with the id's owner as each lane's shard, so the lowest
// lane wins each (shard, slot). (b) `mesh_xfer_fold`, one thread per
// (event, side): the carry fold and the overflow backstop. (c) One thread
// decides the gate for all shards; `commit_ts` becomes the last applied
// event's timestamp, as in JAX. (d) `mesh_xfer_apply` writes only if the
// gate passed, and returns `bal_acc` to zero in any case. No table is
// written before (d). The sharded fast tier has no post/void lanes: the
// host sends those batches to the serial tier.
#include <cuda_runtime.h>

#include "claim.cuh"
#include "owner.cuh"
#include "validate.cuh"

struct MeshXferHdr {
  uint32_t bad, proceed;
  ull ok_n, max_ts;
  ull ins_n[MESH_SHARDS_MAX];
};

struct MeshXferFast {
  uint32_t* acct_rows;
  int a_log2;
  uint32_t* xfer_rows;
  int t_log2;
  int n_shards;
  uint32_t* fulfill;
  uint32_t* xfer_claim;
  uint32_t* bal_acc;
  ull* commit_ts;
  ull* count;
  ull* used;  // [n_shards]
  uint32_t* fault;
  const uint32_t* batch;
  int B, n;
  ull timestamp;
  int32_t* results;
  // scratch
  MeshXferHdr* hdr;
  int32_t* ok;
  int32_t* shard;     // the id's owner
  int64_t* slot2;     // [2B] global account row of each side, -1 if not applied
  int64_t* ins_slot;  // global transfer row claimed for the insert
  uint32_t* new_rows;  // [2B, 32] folded account rows
  ClaimScratch claim_sc;
};

static MeshXferFast carve(char* scratch, int B, size_t* size) {
  MeshXferFast a{};
  Carver c{scratch, 0};
  a.hdr = c.take<MeshXferHdr>(1);
  a.ok = c.take<int32_t>(B);
  a.shard = c.take<int32_t>(B);
  a.slot2 = c.take<int64_t>(2 * (size_t)B);
  a.ins_slot = c.take<int64_t>(B);
  a.new_rows = c.take<uint32_t>(2 * (size_t)B * ROW_WORDS);
  a.claim_sc.cand = c.take<int64_t>(B);
  a.claim_sc.want = c.take<int32_t>(B);
  a.claim_sc.won = c.take<int32_t>(B);
  *size = c.off + 256;
  return a;
}

extern "C" size_t tb_mesh_commit_transfers_fast_scratch(int B) {
  size_t size;
  carve(nullptr, B, &size);
  return size;
}

__device__ __forceinline__ ull event_ts(ull timestamp, int n, int i) {
  return timestamp - (ull)n + (ull)i + 1ull;
}

__device__ __forceinline__ void add_digits(uint32_t* acc, u128 amt) {
#pragma unroll
  for (int d = 0; d < 8; d++) {
    uint32_t digit = (uint32_t)(amt >> (16 * d)) & 0xFFFFu;
    if (digit) atomicAdd(acc + d, digit);
  }
}

__global__ void mesh_xfer_validate(MeshXferFast a) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.B) return;
  Row row = load_row(a.batch + (size_t)i * ROW_WORDS);
  Xfer e = unpack_transfer(row);
  bool valid = i < a.n;
  ull ts = event_ts(a.timestamp, a.n, i);
  uint32_t r0 = transfer_common(e, e.ts != 0 ? 3u : 0u);
  Xfer ea = e;
  ea.ts = ts;

  int S = a.n_shards;
  Found drf = owner_lookup(a.acct_rows, a.a_log2, S, key_in(row, 4), WINDOW);
  Found crf = owner_lookup(a.acct_rows, a.a_log2, S, key_in(row, 8), WINDOW);
  Found exf = owner_lookup(a.xfer_rows, a.t_log2, S, key_in(row, 0), WINDOW);
  Acct dr = unpack_account(found_row(a.acct_rows, drf));
  Acct cr = unpack_account(found_row(a.acct_rows, crf));
  Xfer ex = unpack_transfer(found_row(a.xfer_rows, exf));
  u128 amt;
  uint32_t r = validate_simple_transfer(r0, ea, dr, cr, drf.found, crf.found, ex, exf.found, &amt);
  if (valid && !(drf.resolved && crf.resolved && exf.resolved)) {
    atomicOr(&a.hdr->bad, FAULT_PROBE);
  }
  if (!valid) r = 0u;
  bool ok = valid && r == 0u;
  int owner = owner_of(key_in(row, 0), S);
  a.results[i] = (int32_t)r;
  a.ok[i] = ok;
  a.shard[i] = owner;
  if (!ok) {
    a.slot2[i] = -1;
    a.slot2[a.B + i] = -1;
    return;
  }
  atomicAdd(&a.hdr->ok_n, 1ull);
  atomicAdd(&a.hdr->ins_n[owner], 1ull);
  atomicMax(&a.hdr->max_ts, ts);
  a.slot2[i] = drf.slot;
  a.slot2[a.B + i] = crf.slot;
  // acc words: dp digits 0..7, dpo 8..15, cp 16..23, cpo 24..31
  int off = (e.flags & F_PENDING) ? 0 : 8;
  add_digits(a.bal_acc + (size_t)drf.slot * ROW_WORDS + off, amt);
  add_digits(a.bal_acc + (size_t)crf.slot * ROW_WORDS + 16 + off, amt);
}

// models/ledger.py _fold_digits for one row: 16-bit carry propagation of
// the digit sums into the four balances. *bad on a carry out of any.
__device__ __forceinline__ Row fold_digits(const Row& old, const Row& acc, bool* bad) {
  Row out = old;
  for (int f = 0; f < 4; f++) {
    int w0 = 4 + 4 * f;
    uint32_t carry = 0;
    for (int k = 0; k < 4; k++) {
      uint32_t w = old.w[w0 + k];
      uint32_t s_lo = (w & 0xFFFFu) + acc.w[8 * f + 2 * k] + carry;
      carry = s_lo >> 16;
      uint32_t s_hi = (w >> 16) + acc.w[8 * f + 2 * k + 1] + carry;
      carry = s_hi >> 16;
      out.w[w0 + k] = (s_lo & 0xFFFFu) | (s_hi << 16);
    }
    if (carry != 0) *bad = true;
  }
  return out;
}

__global__ void mesh_xfer_fold(MeshXferFast a) {
  int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= 2 * a.B) return;
  int64_t slot = a.slot2[l];
  if (slot < 0) return;
  bool bad = false;
  Row nr = fold_digits(load_row(a.acct_rows + (size_t)slot * ROW_WORDS),
                       load_row(a.bal_acc + (size_t)slot * ROW_WORDS), &bad);
  // codes 51/52 guard the combined pending+posted sums
  Acct na = unpack_account(nr);
  if (sum_overflows(na.dp, na.dpo) || sum_overflows(na.cp, na.cpo)) bad = true;
  if (bad) atomicOr(&a.hdr->bad, FAULT_OVERFLOW);
  store_row(a.new_rows + (size_t)l * ROW_WORDS, nr);
}

__global__ void mesh_xfer_finalize(MeshXferFast a) {
  uint32_t f = *a.fault | a.hdr->bad;
  ull half = (1ull << a.t_log2) / 2;
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

__global__ void mesh_xfer_apply(MeshXferFast a) {
  int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= 2 * a.B) return;
  int64_t slot = a.slot2[l];
  if (slot < 0) return;
  bool proceed = a.hdr->proceed != 0u;
  if (proceed) {
    store_row(a.acct_rows + (size_t)slot * ROW_WORDS,
              load_row(a.new_rows + (size_t)l * ROW_WORDS));
  }
  uint4* acc = reinterpret_cast<uint4*>(a.bal_acc + (size_t)slot * ROW_WORDS);
#pragma unroll
  for (int k = 0; k < 8; k++) acc[k] = make_uint4(0u, 0u, 0u, 0u);
  if (l >= a.B || !proceed) return;
  int i = l;
  int64_t ins = a.ins_slot[i];
  Row row = load_row(a.batch + (size_t)i * ROW_WORDS);
  put64(row, 30, event_ts(a.timestamp, a.n, i));
  store_row(a.xfer_rows + (size_t)ins * ROW_WORDS, row);
  a.fulfill[ins] = 0u;
}

extern "C" int tb_mesh_commit_transfers_fast(uint32_t* acct_rows, int a_log2, uint32_t* xfer_rows,
                                             int t_log2, int n_shards, uint32_t* fulfill,
                                             uint32_t* xfer_claim, uint32_t* bal_acc,
                                             ull* commit_ts, ull* xfer_count, ull* xfer_used,
                                             uint32_t* fault, const uint32_t* batch, int B, int n,
                                             ull timestamp, int32_t* results, char* scratch,
                                             cudaStream_t stream) {
  size_t size;
  MeshXferFast a = carve(scratch, B, &size);
  a.acct_rows = acct_rows;
  a.a_log2 = a_log2;
  a.xfer_rows = xfer_rows;
  a.t_log2 = t_log2;
  a.n_shards = n_shards;
  a.fulfill = fulfill;
  a.xfer_claim = xfer_claim;
  a.bal_acc = bal_acc;
  a.commit_ts = commit_ts;
  a.count = xfer_count;
  a.used = xfer_used;
  a.fault = fault;
  a.batch = batch;
  a.B = B;
  a.n = n;
  a.timestamp = timestamp;
  a.results = results;
  cudaMemsetAsync(a.hdr, 0, sizeof(MeshXferHdr), stream);
  mesh_xfer_validate<<<grid_for(B), LANES_PER_BLOCK, 0, stream>>>(a);
  claim_slots(batch, ROW_WORDS, a.ok, B, xfer_rows, xfer_claim, t_log2, a.ins_slot, a.claim_sc,
              &a.hdr->bad, stream, a.shard);
  mesh_xfer_fold<<<grid_for(2LL * B), LANES_PER_BLOCK, 0, stream>>>(a);
  mesh_xfer_finalize<<<1, 1, 0, stream>>>(a);
  mesh_xfer_apply<<<grid_for(2LL * B), LANES_PER_BLOCK, 0, stream>>>(a);
  return (int)cudaGetLastError();
}
