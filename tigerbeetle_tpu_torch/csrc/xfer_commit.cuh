// The fast transfer commit of one batch over one thread-block cluster: the
// phase body that K3 (commit_transfers.cu: one batch a launch), K5
// (group_commit.cu: k batch slots in one launch, one after another) and K12
// (wave_commit.cu: the waves of one batch in one launch, kWaves: each wave
// over its own lane list, cluster.cuh LaneList) run.
// Phases, with a cluster barrier (`cluster.sync()`) where a kernel
// boundary stood:
//   (0) each block zeroes its header in shared memory: fault bits, and in
//       block 0 the rounds' want flags, which every warp reaches through
//       distributed shared memory (one 32-bit atomicOr a warp). With one
//       header in block 0 and 64-bit atomics from every warp through
//       map_shared_rank, the ok count's atomicAdd held but commit_ts's
//       atomicMax lost updates on an H100 (it came out short), so the
//       64-bit sums stay in each block. This barrier is also the one
//       between one slot's apply and the next slot's validate in K5;
//   (a) one lane per event: probes, the validation ladders (validate.cuh),
//       result codes, and atomicAdd of the amount's 16-bit digits into the
//       `bal_acc` rows of the touched accounts, which is exact in any order;
//       rows that the ladder does not read are not loaded. Then round 0 of
//       the claims (claim.cuh): the claim column is all free between calls
//       and between slots, so its select is the first free slot of the
//       id's window, and its atomicMin follows at once;
//   (b) claim rounds 1-3, select | barrier | atomicMin | barrier; a round
//       after one that no lane contended in would want nothing either (the
//       column and the tables are as it found them), so that ends them
//       (cluster.cuh `cluster_claims`, which K11tf and K9 share);
//   (c) after the last round's settle and release, one row per (event,
//       side): the carry fold of the slot's digit sums into the pre-batch
//       account row's balances, and the overflow backstop;
//   (d) one thread: the fault gate (and commit_ts, the unsigned max of the
//       applied events' timestamps: waves run lanes out of order; K5 also
//       the slot's count of non-zero codes, n less the ok count), sent to
//       every block's shared memory;
//   (e) if the gate passed, the account rows' balances, the stored transfer
//       rows and `fulfill`; in any case `bal_acc` back to zero.
// Phases (c) and (e) move each 128-byte row with eight lanes, 16 bytes a
// lane (one transaction a row, not eight). Rows read in (a)-(c) are the
// pre-batch snapshot; nothing writes a table before (e). Scratch written by
// one phase and read by another thread is read past L1 (__ldcg).
//
// K5's later slots (and K12's later waves) read what earlier ones wrote from
// other SMs of the cluster. Every such read comes after a cluster barrier, and the barrier's
// wait is an acquire that the compiler follows with an invalidation of the
// SM's L1 (CCTL.IVALL after UCGABAR_WAIT in the SASS of sm_90a;
// chip_smoke.py checks it in K5's kernel), so no weak load after it finds a
// line from before it: the tables, `fulfill` and the scalars are read
// through L1. What the invalidation does not order is the read-only path
// (ld.global.nc), which the compiler may take for a `const __restrict__`
// pointer: the claim selects' table pointer is one, so with kPastL1 (K5)
// they read the table's keys past L1 (ld.global.cg), as K9 does across its
// chunks.
#pragma once
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "claim.cuh"
#include "cluster.cuh"

// A block's header: its fault bits, ok count and the unsigned max of its ok
// events' timestamps (block 0's `want` flags serve the whole cluster).
struct XferHdr {
  uint32_t bad, any_ok;
  uint32_t want[CLAIM_ROUNDS];
  ull ok_n, ts_max;
};

// One warp's share of phase (a), written by its first lane.
struct WarpSums {
  uint32_t bad, ok_n;
  ull ts_max;
};

// The shared memory of a launch, declared by the kernel and reused slot
// after slot.
struct XferShared {
  XferHdr hdr;
  WarpSums warp_sums[CLUSTER_THREADS / 32];
  uint32_t proceed;
};

// The ledger and the scratch of a launch: the same for every slot.
struct XferState {
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
  int B;  // lanes a batch holds (the group's n_pad)
  int pv_mode;
  // scratch
  int32_t* ok;
  int32_t* lane_flags;  // bit 0: post/void, bit 1: post
  int64_t* slot2;       // [2B] account slot of each side, -1 if not applied
  int64_t* p_slot;
  int64_t* ins_slot;
  uint32_t* new_rows;  // [2B, 32] folded account rows
  uint32_t* ins_rows;  // [B, 32] rows to store (fast_pv; fast stores the batch row)
  ClaimScratch claim_sc;
};

// One batch: K3's launch, one slot of K5's (in shared memory), or K12's
// batch, run once a wave.
struct XferBatch {
  const uint32_t* batch;
  // nullable: the wave mask (K3); K12: each lane's wave, 255 for none (read
  // only where the lists are built)
  const uint8_t* mask;
  int n;
  ull timestamp;
  int32_t* results;
  int32_t* fails;  // nullable (K5): the slot's count of non-zero codes (no mask)
};

static XferState xfer_carve(char* scratch, int B, size_t* size) {
  XferState a{};
  Carver c{scratch, 0};
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

// The state of a launch over the scratch (`scratch` of
// tb_commit_transfers_fast_scratch(B) bytes).
static XferState xfer_args(uint32_t* acct_rows, int a_log2, uint32_t* xfer_rows, int t_log2,
                           uint32_t* fulfill, uint32_t* xfer_claim, uint32_t* bal_acc,
                           ull* commit_ts, ull* xfer_count, ull* xfer_used, uint32_t* fault, int B,
                           int pv_mode, char* scratch) {
  size_t size;
  XferState a = xfer_carve(scratch, B, &size);
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
  a.B = B;
  a.pv_mode = pv_mode;
  return a;
}

// Phase (a) for lane i, with claim round 0; returns its fault bits, sets
// *ok, and sets *want0 if the lane contends for a slot. With kWaves (K12)
// lane i is an entry of the wave's list, so live.
template <bool kWaves>
__device__ __forceinline__ uint32_t validate_lane(const XferState& a, const XferBatch& b, int i,
                                                  bool* ok_out, bool* want0) {
  Row row = load_row(b.batch + (size_t)i * ROW_WORDS);
  Xfer e = unpack_transfer(row);
  bool valid = kWaves || (i < b.n && (b.mask == nullptr || b.mask[i]));
  ull ts = event_ts(b.timestamp, b.n, i);
  uint32_t r0 = transfer_common(e, e.ts != 0 ? 3u : 0u);
  Xfer ea = e;
  ea.ts = ts;

  Found drf = table_lookup(a.acct_rows, a.a_log2, key_in(row, 4), WINDOW);
  Found crf = table_lookup(a.acct_rows, a.a_log2, key_in(row, 8), WINDOW);
  Found exf = table_lookup(a.xfer_rows, a.t_log2, key_in(row, 0), WINDOW);
  // a row the ladder reads only where its lookup found it
  Acct dr = drf.found ? load_acct_ladder(a.acct_rows + (size_t)drf.slot * ROW_WORDS)
                      : Acct{};
  Acct cr = crf.found ? load_acct_ladder(a.acct_rows + (size_t)crf.slot * ROW_WORDS)
                      : Acct{};
  Xfer ex = exf.found
                ? unpack_transfer(load_row(a.xfer_rows + (size_t)exf.slot * ROW_WORDS))
                : Xfer{};
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
    uint32_t r_pv = validate_post_void(r0, ea, p, a.fulfill[pf.slot], pf.found,
                                       ex, exf.found, &amt_pv);
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
  *ok_out = ok;
  // claim round 0: the claim column is all free between calls (claim.cuh),
  // so this round's pick is the first free slot of the id's window
  ClaimScratch sc = a.claim_sc;
  sc.won[i] = 0;
  sc.want[i] = 0;
  a.ins_slot[i] = (int64_t)1 << a.t_log2;
  if (ok) {
    Found fr = table_probe_free(a.xfer_rows, a.t_log2, key_in(row, 0), WINDOW);
    if (fr.resolved) {
      sc.cand[i] = fr.slot;
      sc.want[i] = 1;
      atomicMin(a.xfer_claim + fr.slot, (uint32_t)i);
      *want0 = true;
    }
  }
  b.results[i] = (int32_t)r;
  a.ok[i] = ok;
  a.lane_flags[i] = (is_pv ? 1 : 0) | (is_post ? 2 : 0);
  uint32_t bad = probe_bad ? FAULT_PROBE : 0u;
  if (!ok) {
    a.slot2[i] = -1;
    a.slot2[a.B + i] = -1;
    return bad;
  }
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
  if (a.pv_mode) {
    store_row(a.ins_rows + (size_t)i * ROW_WORDS,
              pack_transfer(build_stored_transfer(e, p, is_pv, amt, ts)));
  }
  return bad;
}

// Phase (e), transfers: the stored rows of the events i0, i0 + step, ...
// that applied (with kList of the list's entries i0, i0 + step, ...).
template <bool kList = false>
__device__ __forceinline__ void insert_rows(const XferState& a, const XferBatch& b, int i0, int step,
                                            RowGroup g, const LaneList* list = nullptr) {
  int64_t ok_slot[CLUSTER_IN_FLIGHT], ins[CLUSTER_IN_FLIGHT];
  uint4 v[CLUSTER_IN_FLIGHT];
  int lanes[CLUSTER_IN_FLIGHT];
#pragma unroll
  for (int u = 0; u < CLUSTER_IN_FLIGHT; u++) {
    int i = i0 + u * step;
    if constexpr (kList) {
      i = i < list->cnt ? list->lane(i) : a.B;
      lanes[u] = i;
    }
    ok_slot[u] = i < a.B ? __ldcg(a.slot2 + i) : -1;  // < 0: did not apply
    if (i >= a.B) continue;
    ins[u] = __ldcg(a.ins_slot + i);
    if (a.pv_mode) {
      v[u] = __ldcg(reinterpret_cast<const uint4*>(a.ins_rows + (size_t)i * ROW_WORDS) + g.sub);
    } else {  // the batch row with the event's timestamp
      v[u] = reinterpret_cast<const uint4*>(b.batch + (size_t)i * ROW_WORDS)[g.sub];
      if (g.sub == 7) {
        ull ts = event_ts(b.timestamp, b.n, i);
        v[u].z = (uint32_t)ts;
        v[u].w = (uint32_t)(ts >> 32);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < CLUSTER_IN_FLIGHT; u++) {
    if (ok_slot[u] < 0) continue;
    int i = i0 + u * step;
    if constexpr (kList) i = lanes[u];
    reinterpret_cast<uint4*>(a.xfer_rows + (size_t)ins[u] * ROW_WORDS)[g.sub] = v[u];
    if (g.sub == 0) {
      a.fulfill[ins[u]] = 0u;
      int lf = __ldcg(a.lane_flags + i);
      if (lf & 1) a.fulfill[__ldcg(a.p_slot + i)] = (lf & 2) ? 1u : 2u;
    }
  }
}

// Phases (0)-(e) for batch `b` over state `a`, run by every thread of the
// cluster; with kPastL1 the claim selects read the table past L1; with
// kWaves (K12) only the lanes of one wave, `list`: each phase strides over
// the list's entries (its 2 cnt rows in (c) and (e)), spread over the
// cluster's blocks (spread_rank), and every scratch word, claim, timestamp
// and stored row stays indexed by the lane.
template <bool kPastL1, bool kWaves = false>
__device__ __forceinline__ void xfer_commit_slot(cooperative_groups::cluster_group& cluster,
                                                 const XferState& a, const XferBatch& b,
                                                 XferShared& sh,
                                                 const LaneList* list = nullptr) {
  uint32_t* want = cluster.map_shared_rank(sh.hdr.want, 0);
  const int t = (int)cluster.thread_rank();
  const int stride = (int)cluster.num_threads();
  const int lane = threadIdx.x & 31;
  const bool warp_lead = lane == 0;
  const RowGroup g = row_group(lane);
  const int group = t >> 3, n_groups = stride >> 3;
  // the block's warps: K12 runs WAVE_THREADS a block (cluster.cuh)
  constexpr int kWarps = (kWaves ? WAVE_THREADS : CLUSTER_THREADS) / 32;
  if (threadIdx.x == 0) {
    sh.hdr.bad = 0u;
    for (int r = 0; r < CLAIM_ROUNDS; r++) sh.hdr.want[r] = 0u;
  }
  cluster.sync();

  // (a) validate, and claim round 0
  uint32_t bad = 0u;
  unsigned ok_n = 0;
  ull ts_max = 0ull;
  bool wants = false;
  if constexpr (kWaves) {
    for (int k = list->first; k < list->cnt; k += stride) {
      const int i = list->lane(k);
      bool ok;
      bad |= validate_lane<true>(a, b, i, &ok, &wants);
      ok_n += ok;
      if (ok) ts_max = max(ts_max, event_ts(b.timestamp, b.n, i));
    }
  } else {
    for (int i = t; i < a.B; i += stride) {
      bool ok;
      bad |= validate_lane<false>(a, b, i, &ok, &wants);
      ok_n += ok;
      if (ok) ts_max = max(ts_max, event_ts(b.timestamp, b.n, i));
    }
  }
  bad = __reduce_or_sync(FULL_MASK, bad);
  ok_n = __reduce_add_sync(FULL_MASK, ok_n);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    ts_max = max(ts_max, __shfl_xor_sync(FULL_MASK, ts_max, off));
  }
  if (warp_lead) sh.warp_sums[threadIdx.x >> 5] = WarpSums{bad, ok_n, ts_max};
  if (__any_sync(FULL_MASK, wants) && warp_lead) atomicOr(want, 1u);
  cluster.sync();
  if (threadIdx.x == 0) {  // the block's header, read by the gate
    // `bad` by atomicOr: with no claim round to come, the other warps reach
    // their FAULT_CLAIM atomicOr below with no barrier between
    XferHdr h = sh.hdr;
    h.ok_n = 0ull;
    h.ts_max = 0ull;
    h.any_ok = 0u;
    for (int w = 0; w < kWarps; w++) {
      const WarpSums& ws = sh.warp_sums[w];
      h.bad |= ws.bad;
      h.ok_n += ws.ok_n;
      if (ws.ok_n) h.ts_max = max(h.ts_max, ws.ts_max);
      h.any_ok |= ws.ok_n != 0u;
    }
    atomicOr(&sh.hdr.bad, h.bad);
    sh.hdr.ok_n = h.ok_n;
    sh.hdr.ts_max = h.ts_max;
    sh.hdr.any_ok = h.any_ok;
  }

  // (b) claim rounds 1.., settle and release (cluster.cuh)
  bad = cluster_claims<kPastL1, kWaves>(cluster, want, 1u, false, b.batch, ROW_WORDS, a.ok, a.B,
                                        a.xfer_rows, a.xfer_claim, a.t_log2, a.ins_slot,
                                        a.claim_sc, nullptr, list);
  // (c) fold: it reads nothing that the settle and release write
  if constexpr (kWaves) {
    for (int l = spread_rank(cluster, lane >> 3, 4); l < 2 * list->cnt;
         l += CLUSTER_IN_FLIGHT * n_groups) {
      bad |= fold_rows<XferState, true>(a, l, n_groups, g, a.pv_mode != 0, list);
    }
  } else {
    for (int l = group; l < 2 * a.B; l += CLUSTER_IN_FLIGHT * n_groups) {
      bad |= fold_rows(a, l, n_groups, g, a.pv_mode != 0);
    }
  }
  bad = __reduce_or_sync(FULL_MASK, bad);
  if (warp_lead && bad) atomicOr(&sh.hdr.bad, bad);
  cluster.sync();

  // (d) the fault gate over the blocks' headers, one lane a block, decided
  // by one thread
  if (t < 32) {
    const unsigned nb = cluster.num_blocks();
    XferHdr h{};
    if ((unsigned)t < nb) h = *cluster.map_shared_rank(&sh.hdr, (unsigned)t);
    uint32_t f = __reduce_or_sync(FULL_MASK, h.bad);
    uint32_t any_ok = __reduce_or_sync(FULL_MASK, h.any_ok);
    ull n_ok = h.ok_n, ts = h.any_ok ? h.ts_max : 0ull;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      n_ok += __shfl_xor_sync(FULL_MASK, n_ok, off);
      ts = max(ts, __shfl_xor_sync(FULL_MASK, ts, off));
    }
    if (t == 0) {
      f |= *a.fault;
      if (*a.used + n_ok > (1ull << a.t_log2) / 2) f |= FAULT_CAPACITY;
      *a.fault = f;
      if (f == 0u) {
        *a.count += n_ok;
        *a.used += n_ok;
        if (any_ok) *a.commit_ts = max(*a.commit_ts, ts);
      }
      // with no mask a lane's code is non-zero iff it is one of the n and
      // not ok
      if (b.fails != nullptr) *b.fails = b.n - (int32_t)n_ok;
    }
    f = __shfl_sync(FULL_MASK, f, 0);
    if ((unsigned)t < nb) *cluster.map_shared_rank(&sh.proceed, (unsigned)t) = f == 0u;
  }
  cluster.sync();

  // (e) apply; no block reads another's shared memory from here on
  const bool proceed = sh.proceed != 0u;
  if constexpr (kWaves) {
    const int first = spread_rank(cluster, lane >> 3, 4);
    for (int l = first; l < 2 * list->cnt; l += CLUSTER_IN_FLIGHT * n_groups) {
      apply_rows<XferState, true>(a, l, n_groups, g, proceed, list);
    }
    if (proceed) {
      for (int k = first; k < list->cnt; k += CLUSTER_IN_FLIGHT * n_groups) {
        insert_rows<true>(a, b, k, n_groups, g, list);
      }
    }
  } else {
    for (int l = group; l < 2 * a.B; l += CLUSTER_IN_FLIGHT * n_groups) {
      apply_rows(a, l, n_groups, g, proceed);
    }
    if (proceed) {
      for (int i = group; i < a.B; i += CLUSTER_IN_FLIGHT * n_groups) {
        insert_rows(a, b, i, n_groups, g);
      }
    }
  }
}
