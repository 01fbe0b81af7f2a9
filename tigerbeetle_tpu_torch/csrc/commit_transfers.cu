// K3: create_transfers fast-tier commit (modes fast and fast_pv, with the
// wave mask).
//
// Replaces tigerbeetle_tpu/models/ledger.py LedgerKernels._commit_transfers
// (:805-993, jitted :733; under a wave mask also through _wave_stepper
// :2261).
//
// Bound on an H100: bytes. Per event it reads the 128-byte batch row, one
// 32-byte sector per probe of the debit, credit and id chains (fast_pv:
// also the pending and its two accounts), the touched account rows, and
// writes the stored row; the integer work is a few hundred operations.
//
// Design: five phases in launch order, because blocks run in no order and
// each phase needs all of the one before:
//   (a) `xfer_validate`, one thread per event: probes, the validation
//       ladders (validate.cuh), result codes, and atomicAdd of the amount's
//       16-bit digits into the `bal_acc` rows of the touched accounts,
//       which is exact in any order; then the claim rounds (claim.cu);
//   (b) `xfer_fold`, one thread per (event, side): the carry fold of the
//       slot's digit sums into the pre-batch account row, and the overflow
//       backstop. Lanes touching one account fold the same row.
//   (c) `xfer_finalize`, one thread: the fault gate, decided on the device
//       (no host sync per batch);
//   (d) `xfer_apply`: if the gate passed, the account rows, the stored
//       transfer rows, `fulfill` and `commit_ts` (max, not set: waves run
//       lanes out of order); in any case `bal_acc` back to zero.
// Rows read in (a) and (b) are the pre-batch snapshot; nothing writes a
// table before (d).
#include <cuda_runtime.h>

#include "claim.cuh"
#include "commit_transfers.cuh"
#include "hash.cuh"
#include "validate.cuh"

struct XferHdr {
  uint32_t bad, proceed;
  ull ok_n;
};

struct XferFast {
  uint32_t* acct_rows;
  int a_log2;
  uint32_t* xfer_rows;
  int t_log2;
  uint32_t* fulfill;
  uint32_t* xfer_claim;
  uint32_t* bal_acc;
  ull* commit_ts;
  ull* count;
  ull* used;
  uint32_t* fault;
  const uint32_t* batch;
  const uint8_t* mask;  // nullable: the wave mask
  int B, n;
  ull timestamp;
  int pv_mode;
  int32_t* results;
  // scratch
  XferHdr* hdr;
  int32_t* ok;
  int32_t* lane_flags;  // bit 0: post/void, bit 1: post
  int64_t* slot2;       // [2B] account slot of each side, -1 if not applied
  int64_t* p_slot;
  int64_t* ins_slot;
  uint32_t* new_rows;  // [2B, 32] folded account rows
  uint32_t* ins_rows;  // [B, 32] rows to store
  ClaimScratch claim_sc;
};

static XferFast carve(char* scratch, int B, size_t* size) {
  XferFast a{};
  Carver c{scratch, 0};
  a.hdr = c.take<XferHdr>(1);
  a.ok = c.take<int32_t>(B);
  a.lane_flags = c.take<int32_t>(B);
  a.slot2 = c.take<int64_t>(2 * (size_t)B);
  a.p_slot = c.take<int64_t>(B);
  a.ins_slot = c.take<int64_t>(B);
  a.new_rows = c.take<uint32_t>(2 * (size_t)B * ROW_WORDS);
  a.ins_rows = c.take<uint32_t>((size_t)B * ROW_WORDS);
  a.claim_sc.cand = c.take<int64_t>(B);
  a.claim_sc.want = c.take<int32_t>(B);
  a.claim_sc.won = c.take<int32_t>(B);
  *size = c.off + 256;
  return a;
}

extern "C" size_t tb_commit_transfers_fast_scratch(int B) {
  size_t size;
  carve(nullptr, B, &size);
  return size;
}

__device__ __forceinline__ ull event_ts(ull timestamp, int n, int i) {
  return timestamp - (ull)n + (ull)i + 1ull;
}

// Add the 8 little-endian 16-bit digits of `amt` (negated mod 2^32 when
// `neg`) into 8 accumulator words.
__device__ __forceinline__ void add_digits(uint32_t* acc, u128 amt, bool neg) {
#pragma unroll
  for (int d = 0; d < 8; d++) {
    uint32_t digit = (uint32_t)(amt >> (16 * d)) & 0xFFFFu;
    if (digit) atomicAdd(acc + d, neg ? 0u - digit : digit);
  }
}

__global__ void xfer_validate(XferFast a) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.B) return;
  Row row = load_row(a.batch + (size_t)i * ROW_WORDS);
  Xfer e = unpack_transfer(row);
  bool valid = i < a.n && (a.mask == nullptr || a.mask[i]);
  ull ts = event_ts(a.timestamp, a.n, i);
  uint32_t r0 = transfer_common(e, e.ts != 0 ? 3u : 0u);
  Xfer ea = e;
  ea.ts = ts;

  Found drf = table_lookup(a.acct_rows, a.a_log2, key_in(row, 4), WINDOW);
  Found crf = table_lookup(a.acct_rows, a.a_log2, key_in(row, 8), WINDOW);
  Found exf = table_lookup(a.xfer_rows, a.t_log2, key_in(row, 0), WINDOW);
  Acct dr = unpack_account(load_row(a.acct_rows + (size_t)drf.slot * ROW_WORDS));
  Acct cr = unpack_account(load_row(a.acct_rows + (size_t)crf.slot * ROW_WORDS));
  Xfer ex = unpack_transfer(load_row(a.xfer_rows + (size_t)exf.slot * ROW_WORDS));
  u128 amt;
  uint32_t r = validate_simple_transfer(r0, ea, dr, cr, drf.found, crf.found, ex, exf.found, &amt);
  bool probe_bad = valid && !(drf.resolved && crf.resolved && exf.resolved);

  bool is_pv = false, is_post = false;
  int64_t dr_eff = drf.slot, cr_eff = crf.slot, p_slot = 0;
  Xfer p{};
  if (a.pv_mode) {
    is_pv = (e.flags & (F_POST | F_VOID)) != 0u;
    Found pf = table_lookup(a.xfer_rows, a.t_log2, key_in(row, 16), WINDOW);
    Row p_row = load_row(a.xfer_rows + (size_t)pf.slot * ROW_WORDS);
    p = unpack_transfer(p_row);
    Found pdrf = table_lookup(a.acct_rows, a.a_log2, key_in(p_row, 4), WINDOW);
    Found pcrf = table_lookup(a.acct_rows, a.a_log2, key_in(p_row, 8), WINDOW);
    u128 amt_pv;
    uint32_t r_pv = validate_post_void(r0, ea, p, a.fulfill[pf.slot], pf.found, ex, exf.found,
                                       &amt_pv);
    if (is_pv) {
      r = r_pv;
      amt = amt_pv;
      dr_eff = pdrf.slot;
      cr_eff = pcrf.slot;
      is_post = (e.flags & F_POST) != 0u;
      if (valid && !(pf.resolved && pdrf.resolved && pcrf.resolved)) probe_bad = true;
    }
    p_slot = pf.slot;
  }
  if (!valid) r = 0u;
  bool ok = valid && r == 0u;
  a.results[i] = (int32_t)r;
  a.ok[i] = ok;
  a.lane_flags[i] = (is_pv ? 1 : 0) | (is_post ? 2 : 0);
  if (probe_bad) atomicOr(&a.hdr->bad, FAULT_PROBE);
  if (!ok) {
    a.slot2[i] = -1;
    a.slot2[a.B + i] = -1;
    return;
  }
  atomicAdd(&a.hdr->ok_n, 1ull);
  a.slot2[i] = dr_eff;
  a.slot2[a.B + i] = cr_eff;
  a.p_slot[i] = p_slot;

  // acc words: dp digits 0..7, dpo 8..15, cp 16..23, cpo 24..31
  uint32_t* acc_dr = a.bal_acc + (size_t)dr_eff * ROW_WORDS;
  uint32_t* acc_cr = a.bal_acc + (size_t)cr_eff * ROW_WORDS;
  if (is_pv) {
    // the pending's amount leaves the pending balances of its accounts;
    // a post adds the resolved amount to their posted balances
    add_digits(acc_dr + 0, p.amt, true);
    add_digits(acc_cr + 16, p.amt, true);
    if (is_post) {
      add_digits(acc_dr + 8, amt, false);
      add_digits(acc_cr + 24, amt, false);
    }
  } else {
    int off = (e.flags & F_PENDING) ? 0 : 8;
    add_digits(acc_dr + off, amt, false);
    add_digits(acc_cr + 16 + off, amt, false);
  }
  Row ins;
  if (a.pv_mode) {
    ins = pack_transfer(build_stored_transfer(e, p, is_pv, amt, ts));
  } else {
    ins = row;
    put64(ins, 30, ts);
  }
  store_row(a.ins_rows + (size_t)i * ROW_WORDS, ins);
}

// models/ledger.py _fold_digits / _fold_digits_signed for one row.
__device__ __forceinline__ Row fold_digits(const Row& old, const Row& acc, bool is_signed,
                                           bool* bad) {
  Row out = old;
  for (int f = 0; f < 4; f++) {
    int w0 = 4 + 4 * f;
    if (is_signed) {
      long long carry = 0;
      for (int k = 0; k < 4; k++) {
        uint32_t w = old.w[w0 + k];
        long long s_lo = (long long)(w & 0xFFFFu) + (long long)(int32_t)acc.w[8 * f + 2 * k] + carry;
        carry = s_lo >> 16;
        long long s_hi = (long long)(w >> 16) + (long long)(int32_t)acc.w[8 * f + 2 * k + 1] + carry;
        carry = s_hi >> 16;
        out.w[w0 + k] = (uint32_t)(s_lo & 0xFFFF) | ((uint32_t)(s_hi & 0xFFFF) << 16);
      }
      if (carry != 0) *bad = true;
    } else {
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
  }
  return out;
}

__global__ void xfer_fold(XferFast a) {
  int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= 2 * a.B) return;
  int64_t slot = a.slot2[l];
  if (slot < 0) return;
  Row old = load_row(a.acct_rows + (size_t)slot * ROW_WORDS);
  Row acc = load_row(a.bal_acc + (size_t)slot * ROW_WORDS);
  bool bad = false;
  Row nr = fold_digits(old, acc, a.pv_mode != 0, &bad);
  // codes 51/52 guard the combined pending+posted sums (:856-861)
  Acct na = unpack_account(nr);
  if (sum_overflows(na.dp, na.dpo) || sum_overflows(na.cp, na.cpo)) bad = true;
  if (bad) atomicOr(&a.hdr->bad, FAULT_OVERFLOW);
  store_row(a.new_rows + (size_t)l * ROW_WORDS, nr);
}

__global__ void xfer_finalize(XferFast a) {
  ull ok_n = a.hdr->ok_n;
  uint32_t f = *a.fault | a.hdr->bad;
  if (*a.used + ok_n > (1ull << a.t_log2) / 2) f |= FAULT_CAPACITY;
  *a.fault = f;
  a.hdr->proceed = f == 0u;
  if (f == 0u) {
    *a.count += ok_n;
    *a.used += ok_n;
  }
}

__global__ void xfer_apply(XferFast a) {
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
  store_row(a.xfer_rows + (size_t)ins * ROW_WORDS, load_row(a.ins_rows + (size_t)i * ROW_WORDS));
  a.fulfill[ins] = 0u;
  int lf = a.lane_flags[i];
  if (lf & 1) a.fulfill[a.p_slot[i]] = (lf & 2) ? 1u : 2u;
  atomicMax(a.commit_ts, event_ts(a.timestamp, a.n, i));
}

void xfer_fast_enqueue(uint32_t* acct_rows, int a_log2, uint32_t* xfer_rows, int t_log2,
                       uint32_t* fulfill, uint32_t* xfer_claim, uint32_t* bal_acc, ull* commit_ts,
                       ull* xfer_count, ull* xfer_used, uint32_t* fault, const uint32_t* batch,
                       const uint8_t* mask, int B, int n, ull timestamp, int pv_mode,
                       int32_t* results, char* scratch, cudaStream_t stream) {
  size_t size;
  XferFast a = carve(scratch, B, &size);
  a.acct_rows = acct_rows;
  a.a_log2 = a_log2;
  a.xfer_rows = xfer_rows;
  a.t_log2 = t_log2;
  a.fulfill = fulfill;
  a.xfer_claim = xfer_claim;
  a.bal_acc = bal_acc;
  a.commit_ts = commit_ts;
  a.count = xfer_count;
  a.used = xfer_used;
  a.fault = fault;
  a.batch = batch;
  a.mask = mask;
  a.B = B;
  a.n = n;
  a.timestamp = timestamp;
  a.pv_mode = pv_mode;
  a.results = results;
  cudaMemsetAsync(a.hdr, 0, sizeof(XferHdr), stream);
  xfer_validate<<<grid_for(B), LANES_PER_BLOCK, 0, stream>>>(a);
  claim_slots(batch, ROW_WORDS, a.ok, B, xfer_rows, xfer_claim, t_log2, a.ins_slot, a.claim_sc,
              &a.hdr->bad, stream);
  xfer_fold<<<grid_for(2LL * B), LANES_PER_BLOCK, 0, stream>>>(a);
  xfer_finalize<<<1, 1, 0, stream>>>(a);
  xfer_apply<<<grid_for(2LL * B), LANES_PER_BLOCK, 0, stream>>>(a);
}

extern "C" int tb_commit_transfers_fast(uint32_t* acct_rows, int a_log2, uint32_t* xfer_rows,
                                        int t_log2, uint32_t* fulfill, uint32_t* xfer_claim,
                                        uint32_t* bal_acc, ull* commit_ts, ull* xfer_count,
                                        ull* xfer_used, uint32_t* fault, const uint32_t* batch,
                                        const uint8_t* mask, int B, int n, ull timestamp,
                                        int pv_mode, int32_t* results, char* scratch,
                                        cudaStream_t stream) {
  xfer_fast_enqueue(acct_rows, a_log2, xfer_rows, t_log2, fulfill, xfer_claim, bal_acc, commit_ts,
                    xfer_count, xfer_used, fault, batch, mask, B, n, timestamp, pv_mode, results,
                    scratch, stream);
  return (int)cudaGetLastError();
}
