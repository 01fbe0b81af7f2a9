// K11 serial transfer commit of the sharded ledger: the exact,
// event-at-a-time scan.
//
// Replaces tigerbeetle_tpu/parallel/mesh.py
// ShardedLedgerKernels._commit_transfers_serial (:431-721): a lax.scan
// over the events in which every lookup is a probe of all shards combined
// by one psum (`_find1`, W = 64) and every write is masked to the owning
// shard, with per-shard undo slots for linked-chain rollback.
//
// Bound on an H100: latency, as K4 (serial_transfers.cu): every event
// validates against the tables as the events before it left them, so the
// events form one dependent chain of probes (six lookups, a free-slot probe
// and up to three row writes each).
//
// Design: K4's one sequential thread, with every probe on the key's owner
// shard (owner.cuh) and slots kept as global row indices, so the undo log
// needs no per-shard copies. The JAX quirks that decide faults and slots
// are kept: the pending's accounts are probed for every event, with key 0
// from the zero row when the pending is missing (an unresolved probe there
// sets FAULT_SERIAL too); the insert goes to the first free slot of the
// id's owner; the fulfill word is written on the pending's owner; a
// rollback tombstones each insert on its owner; `commit_ts` is set to each
// applied event's timestamp and not restored on rollback; `xfer_used_slots`
// counts every applied insert on its owner, rolled back or not. Entry
// gates: the sticky fault, and the load guard with all n events charged
// against every shard (a tripped gate makes n = 0).
#include <cuda_runtime.h>

#include "owner.cuh"
#include "validate.cuh"

struct MeshUndo {
  int32_t* kind;  // 0 not applied, 1 posted, 2 pending, 3 post, 4 void
  int64_t* dr_slot;  // global account rows, -1 where no shard owns a found row
  int64_t* cr_slot;
  int64_t* t_slot;  // the insert's global row on the id's owner
  int64_t* p_slot;  // the pending's global row, -1 if not found
  u128* amt;
  u128* p_amt;
};

static MeshUndo carve_undo(char* scratch, int B, size_t* size) {
  Carver c{scratch, 0};
  MeshUndo u;
  u.kind = c.take<int32_t>(B);
  u.dr_slot = c.take<int64_t>(B);
  u.cr_slot = c.take<int64_t>(B);
  u.t_slot = c.take<int64_t>(B);
  u.p_slot = c.take<int64_t>(B);
  u.amt = c.take<u128>(B);
  u.p_amt = c.take<u128>(B);
  *size = c.off + 256;
  return u;
}

extern "C" size_t tb_mesh_commit_transfers_serial_scratch(int B) {
  size_t size;
  carve_undo(nullptr, B, &size);
  return size;
}

__global__ void mesh_transfers_serial(uint32_t* acct_rows, int a_log2, uint32_t* xfer_rows,
                                      int t_log2, int n_shards, uint32_t* fulfill,
                                      ull* commit_ts, ull* count, ull* used, uint32_t* fault,
                                      const uint32_t* batch, int B, int n, ull timestamp,
                                      int32_t* results, MeshUndo u) {
  if (threadIdx.x != 0 || blockIdx.x != 0) return;
  const int S = n_shards, W = WINDOW_SCALAR;
  uint32_t fault0 = *fault;
  for (int s = 0; s < S; s++) {
    if (used[s] + (ull)n > (1ull << t_log2) / 2) fault0 |= FAULT_CAPACITY;
  }
  if (fault0) n = 0;
  for (int i = 0; i < B; i++) results[i] = 0;
  Row tomb;
  for (int k = 0; k < ROW_WORDS; k++) tomb.w[k] = TOMB_WORD;
  ull applied[MESH_SHARDS_MAX];
  for (int s = 0; s < S; s++) applied[s] = 0;
  int chain_start = -1;
  bool chain_broken = false, probe_bad = false;
  ull cts = *commit_ts, ok_n = 0;

  for (int i = 0; i < n; i++) {
    Row row = load_row(batch + (size_t)i * ROW_WORDS);
    Xfer e = unpack_transfer(row);
    bool linked = (e.flags & F_LINKED) != 0u;
    if (linked && chain_start < 0) chain_start = i;
    bool in_chain = chain_start >= 0;
    uint32_t r = (in_chain && i == n - 1 && linked) ? 2u
                 : chain_broken                     ? 1u
                 : e.ts != 0                        ? 3u
                                                    : 0u;
    r = transfer_common(e, r);
    ull ts = timestamp - (ull)n + (ull)i + 1ull;
    Xfer ea = e;
    ea.ts = ts;

    Found drf = owner_lookup(acct_rows, a_log2, S, key_in(row, 4), W);
    Found crf = owner_lookup(acct_rows, a_log2, S, key_in(row, 8), W);
    Found exf = owner_lookup(xfer_rows, t_log2, S, key_in(row, 0), W);
    Found pf = owner_lookup(xfer_rows, t_log2, S, key_in(row, 16), W);
    Acct dr = unpack_account(found_row(acct_rows, drf));
    Acct cr = unpack_account(found_row(acct_rows, crf));
    Xfer ex = unpack_transfer(found_row(xfer_rows, exf));
    Row p_row = found_row(xfer_rows, pf);
    Xfer p = unpack_transfer(p_row);
    uint32_t p_fulfill = pf.found ? fulfill[pf.slot] : 0u;
    // the pending's accounts (post/void path): key 0 when it is missing
    Found pdrf = owner_lookup(acct_rows, a_log2, S, key_in(p_row, 4), W);
    Found pcrf = owner_lookup(acct_rows, a_log2, S, key_in(p_row, 8), W);
    if (!(drf.resolved && crf.resolved && exf.resolved && pf.resolved && pdrf.resolved &&
          pcrf.resolved))
      probe_bad = true;

    bool is_pv = (e.flags & (F_POST | F_VOID)) != 0u;
    u128 amt;
    if (is_pv) {
      r = validate_post_void(r, ea, p, p_fulfill, pf.found, ex, exf.found, &amt);
    } else {
      r = validate_simple_transfer(r, ea, dr, cr, drf.found, crf.found, ex, exf.found, &amt);
    }
    bool ok = r == 0u;
    bool is_post = is_pv && (e.flags & F_POST) != 0u;
    bool is_pending = !is_pv && (e.flags & F_PENDING) != 0u;

    // the insert target: the first free slot on the id's owner
    int owner = owner_of(key_in(row, 0), S);
    size_t base = shard_base(owner, t_log2);
    Found fr = table_probe_free(xfer_rows + base * ROW_WORDS, t_log2, key_in(row, 0), W);
    int64_t t_slot = (int64_t)base + fr.slot;
    u.kind[i] = 0;
    if (ok) {
      if (!fr.resolved) probe_bad = true;
      if (fr.resolved) {
        store_row(xfer_rows + (size_t)t_slot * ROW_WORDS,
                  pack_transfer(build_stored_transfer(e, p, is_pv, amt, ts)));
        fulfill[t_slot] = 0u;
      }
      if (is_pv && pf.found) fulfill[pf.slot] = is_post ? 1u : 2u;

      // balances on the accounts' owners: post/void move the PENDING's
      const Found& tdr = is_pv ? pdrf : drf;
      const Found& tcr = is_pv ? pcrf : crf;
      if (is_pv) {
        dr = unpack_account(found_row(acct_rows, tdr));
        cr = unpack_account(found_row(acct_rows, tcr));
      }
      if (is_pending) {
        dr.dp += amt;
        cr.cp += amt;
      }
      if (is_pv) {
        dr.dp -= p.amt;
        cr.cp -= p.amt;
      }
      if (is_post || (!is_pv && !is_pending)) {
        dr.dpo += amt;
        cr.cpo += amt;
      }
      if (tdr.found) store_row(acct_rows + (size_t)tdr.slot * ROW_WORDS, pack_account(dr));
      if (tcr.found) store_row(acct_rows + (size_t)tcr.slot * ROW_WORDS, pack_account(cr));
      cts = ts;
      u.kind[i] = is_pv ? (is_post ? 3 : 4) : (is_pending ? 2 : 1);
      u.dr_slot[i] = tdr.found ? tdr.slot : -1;
      u.cr_slot[i] = tcr.found ? tcr.slot : -1;
      u.t_slot[i] = t_slot;
      u.p_slot[i] = pf.found ? pf.slot : -1;
      u.amt[i] = amt;
      u.p_amt[i] = p.amt;
      applied[owner]++;
    }

    if (r != 0u && in_chain && !chain_broken) {  // roll back [chain_start, i)
      for (int k = chain_start; k < i; k++) {
        int kd = u.kind[k];
        if (kd == 0) continue;
        int64_t slots[2] = {u.dr_slot[k], u.cr_slot[k]};
        for (int side = 0; side < 2; side++) {
          if (slots[side] < 0) continue;
          uint32_t* w = acct_rows + (size_t)slots[side] * ROW_WORDS;
          Acct f = unpack_account(load_row(w));
          u128& pend = side == 0 ? f.dp : f.cp;
          u128& post = side == 0 ? f.dpo : f.cpo;
          if (kd == 3 || kd == 4) pend += u.p_amt[k];
          if (kd == 2) pend -= u.amt[k];
          if (kd == 1 || kd == 3) post -= u.amt[k];
          store_row(w, pack_account(f));
        }
        store_row(xfer_rows + (size_t)u.t_slot[k] * ROW_WORDS, tomb);
        if ((kd == 3 || kd == 4) && u.p_slot[k] >= 0) fulfill[u.p_slot[k]] = 0u;
      }
      for (int k = chain_start; k < i; k++) results[k] = 1;
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
  for (int s = 0; s < S; s++) used[s] += applied[s];
  *fault = fault0 | (probe_bad ? FAULT_SERIAL : 0u);
}

extern "C" int tb_mesh_commit_transfers_serial(uint32_t* acct_rows, int a_log2,
                                               uint32_t* xfer_rows, int t_log2, int n_shards,
                                               uint32_t* fulfill, ull* commit_ts, ull* xfer_count,
                                               ull* xfer_used, uint32_t* fault,
                                               const uint32_t* batch, int B, int n,
                                               ull timestamp, int32_t* results, char* scratch,
                                               cudaStream_t stream) {
  size_t size;
  MeshUndo u = carve_undo(scratch, B, &size);
  mesh_transfers_serial<<<1, 1, 0, stream>>>(acct_rows, a_log2, xfer_rows, t_log2, n_shards,
                                             fulfill, commit_ts, xfer_count, xfer_used, fault,
                                             batch, B, n, timestamp, results, u);
  return (int)cudaGetLastError();
}
