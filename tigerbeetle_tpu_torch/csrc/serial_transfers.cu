// K4: the exact, event-at-a-time create_transfers commit.
//
// Replaces tigerbeetle_tpu/models/ledger.py
// LedgerKernels._serial_transfers_core (:1004-1278): commit_transfers in
// mode serial, and commit_transfers_residue (:743) for the wave executor's
// residue, with explicit per-event timestamps.
//
// Bound on an H100: latency. Every event validates against the tables as
// the events before it left them (linked chains, in-batch post/void,
// balancing clamps, duplicate ids), so the events form one dependent chain
// of probes: about six lookups, a free-slot probe and three row writes per
// event, each a dependent trip to device memory. The JAX version is a
// lax.scan whose carry is the whole table; here one thread walks the
// events in order and updates the tables in place, with an undo log in the
// scratch buffer. A broken chain replays the log over [chain_start, i):
// balances restored, inserts tombstoned, fulfill cleared, while commit_ts
// keeps what the rolled-back events set (as the reference's scopes do).
// Entry gates as in JAX: the sticky fault, and the load-factor guard
// charged for all n events. An unresolved probe cannot be undone mid-scan:
// FAULT_SERIAL marks the state corrupt.
#include <cuda_runtime.h>

#include "hash.cuh"
#include "validate.cuh"

struct Undo {
  int32_t* kind;  // 0 not applied, 1 posted, 2 pending, 3 post, 4 void
  int64_t* dr_slot;
  int64_t* cr_slot;
  int64_t* t_slot;
  int64_t* p_slot;
  u128* amt;
  u128* p_amt;
};

static Undo carve_undo(char* scratch, int B, size_t* size) {
  Carver c{scratch, 0};
  Undo u;
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

extern "C" size_t tb_commit_transfers_serial_scratch(int B) {
  size_t size;
  carve_undo(nullptr, B, &size);
  return size;
}

__global__ void transfers_serial(uint32_t* acct_rows, int a_log2, uint32_t* xfer_rows,
                                 int t_log2, uint32_t* fulfill, ull* commit_ts, ull* count,
                                 ull* used, uint32_t* fault, const uint32_t* batch,
                                 const ull* ts_vec, int B, int n, int32_t* results, Undo u) {
  if (threadIdx.x != 0 || blockIdx.x != 0) return;
  uint32_t fault0 = *fault;
  if (*used + (ull)n > (1ull << t_log2) / 2) fault0 |= FAULT_CAPACITY;
  if (fault0) n = 0;
  for (int i = 0; i < B; i++) results[i] = 0;
  Row tomb;
  for (int k = 0; k < ROW_WORDS; k++) tomb.w[k] = TOMB_WORD;
  int chain_start = -1;
  bool chain_broken = false, probe_bad = false;
  ull cts = *commit_ts, ok_n = 0, applied_n = 0;
  const int W = WINDOW_SCALAR;

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
    ull ts = ts_vec[i];
    Xfer ea = e;
    ea.ts = ts;

    Found drf = table_lookup(acct_rows, a_log2, key_in(row, 4), W);
    Found crf = table_lookup(acct_rows, a_log2, key_in(row, 8), W);
    Found exf = table_lookup(xfer_rows, t_log2, key_in(row, 0), W);
    Found pf = table_lookup(xfer_rows, t_log2, key_in(row, 16), W);
    Acct dr = unpack_account(load_row(acct_rows + (size_t)drf.slot * ROW_WORDS));
    Acct cr = unpack_account(load_row(acct_rows + (size_t)crf.slot * ROW_WORDS));
    Xfer ex = unpack_transfer(load_row(xfer_rows + (size_t)exf.slot * ROW_WORDS));
    Row p_row = load_row(xfer_rows + (size_t)pf.slot * ROW_WORDS);
    Xfer p = unpack_transfer(p_row);
    // the pending's accounts (post/void path); garbage when !pf.found
    Found pdrf = table_lookup(acct_rows, a_log2, key_in(p_row, 4), W);
    Found pcrf = table_lookup(acct_rows, a_log2, key_in(p_row, 8), W);
    if (!(drf.resolved && crf.resolved && exf.resolved && pf.resolved && pdrf.resolved &&
          pcrf.resolved))
      probe_bad = true;

    bool is_pv = (e.flags & (F_POST | F_VOID)) != 0u;
    u128 amt;
    if (is_pv) {
      r = validate_post_void(r, ea, p, fulfill[pf.slot], pf.found, ex, exf.found, &amt);
    } else {
      r = validate_simple_transfer(r, ea, dr, cr, drf.found, crf.found, ex, exf.found, &amt);
    }
    bool ok = r == 0u;
    bool is_post = is_pv && (e.flags & F_POST) != 0u;
    bool is_pending = !is_pv && (e.flags & F_PENDING) != 0u;

    Found fr = table_probe_free(xfer_rows, t_log2, key_in(row, 0), W);
    u.kind[i] = 0;
    if (ok) {
      if (!fr.resolved) probe_bad = true;
      if (fr.resolved) {
        store_row(xfer_rows + (size_t)fr.slot * ROW_WORDS,
                  pack_transfer(build_stored_transfer(e, p, is_pv, amt, ts)));
        fulfill[fr.slot] = 0u;
      }
      if (is_pv) fulfill[pf.slot] = is_post ? 1u : 2u;

      // balances: post/void move the PENDING's accounts
      int64_t tdr_slot = drf.slot, tcr_slot = crf.slot;
      if (is_pv) {
        tdr_slot = pdrf.slot;
        tcr_slot = pcrf.slot;
        dr = unpack_account(load_row(acct_rows + (size_t)tdr_slot * ROW_WORDS));
        cr = unpack_account(load_row(acct_rows + (size_t)tcr_slot * ROW_WORDS));
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
      store_row(acct_rows + (size_t)tdr_slot * ROW_WORDS, pack_account(dr));
      store_row(acct_rows + (size_t)tcr_slot * ROW_WORDS, pack_account(cr));
      if (ts > cts) cts = ts;
      u.kind[i] = is_pv ? (is_post ? 3 : 4) : (is_pending ? 2 : 1);
      u.dr_slot[i] = tdr_slot;
      u.cr_slot[i] = tcr_slot;
      u.t_slot[i] = fr.slot;
      u.p_slot[i] = pf.slot;
      u.amt[i] = amt;
      u.p_amt[i] = p.amt;
      applied_n++;
    }

    if (r != 0u && in_chain && !chain_broken) {  // roll back [chain_start, i)
      for (int k = chain_start; k < i; k++) {
        int kd = u.kind[k];
        if (kd == 0) continue;
        uint32_t* drw = acct_rows + (size_t)u.dr_slot[k] * ROW_WORDS;
        uint32_t* crw = acct_rows + (size_t)u.cr_slot[k] * ROW_WORDS;
        Acct fdr = unpack_account(load_row(drw));
        Acct fcr = unpack_account(load_row(crw));
        if (kd == 3 || kd == 4) {
          fdr.dp += u.p_amt[k];
          fcr.cp += u.p_amt[k];
        }
        if (kd == 2) {
          fdr.dp -= u.amt[k];
          fcr.cp -= u.amt[k];
        }
        if (kd == 1 || kd == 3) {
          fdr.dpo -= u.amt[k];
          fcr.cpo -= u.amt[k];
        }
        store_row(drw, pack_account(fdr));
        store_row(crw, pack_account(fcr));
        store_row(xfer_rows + (size_t)u.t_slot[k] * ROW_WORDS, tomb);
        if (kd == 3 || kd == 4) fulfill[u.p_slot[k]] = 0u;
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
  *used += applied_n;
  *fault = fault0 | (probe_bad ? FAULT_SERIAL : 0u);
}

extern "C" int tb_commit_transfers_serial(uint32_t* acct_rows, int a_log2, uint32_t* xfer_rows,
                                          int t_log2, uint32_t* fulfill, ull* commit_ts,
                                          ull* xfer_count, ull* xfer_used, uint32_t* fault,
                                          const uint32_t* batch, const ull* ts_vec, int B, int n,
                                          int32_t* results, char* scratch, cudaStream_t stream) {
  size_t size;
  Undo u = carve_undo(scratch, B, &size);
  transfers_serial<<<1, 1, 0, stream>>>(acct_rows, a_log2, xfer_rows, t_log2, fulfill,
                                        commit_ts, xfer_count, xfer_used, fault, batch, ts_vec,
                                        B, n, results, u);
  return (int)cudaGetLastError();
}
