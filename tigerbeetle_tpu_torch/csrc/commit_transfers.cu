// K3: create_transfers fast-tier commit (modes fast and fast_pv, with the
// wave mask), as one launch of one thread-block cluster.
//
// Replaces tigerbeetle_tpu/models/ledger.py LedgerKernels._commit_transfers
// (:805-993, jitted :733; under a wave mask also through _wave_stepper
// :2261), with ops/hashtable.py `claim_slots` (:162) for the inserts.
//
// Bound on an H100: bytes. Per event it reads the 128-byte batch row, one
// 32-byte sector per probe of the debit, credit and id chains (fast_pv:
// also the pending and its two accounts), the touched account rows, and
// writes the stored row; the integer work is a few hundred operations.
// What held the launch-per-phase design back was not bytes but its 13
// launches and a memset per call (about 8 us each against 1.3 us of
// bytes): every phase needs all of the one before, and blocks run in no
// order, so each barrier was a kernel boundary.
//
// Design: one kernel over one cluster of CLUSTER_BLOCKS blocks of
// CLUSTER_THREADS threads (cluster.cuh, whose row phases K11tf shares).
// Lane loops stride over the cluster, so any B works. A cluster barrier
// (`cluster.sync()`) stands where a kernel boundary stood:
//   (0) each block zeroes its header in shared memory: fault bits, the
//       ok count and the commit_ts candidate (each warp's share, folded by
//       the block's first thread), and in block 0 the rounds' want flags,
//       which every warp reaches through distributed shared memory (one
//       32-bit atomicOr a warp). With one header in block 0 and 64-bit
//       atomics from every warp through map_shared_rank, the ok count's
//       atomicAdd held but commit_ts's atomicMax lost updates on an H100
//       (it came out short), so the 64-bit sums stay in each block;
//   (a) one lane per event: probes, the validation ladders (validate.cuh),
//       result codes, and atomicAdd of the amount's 16-bit digits into the
//       `bal_acc` rows of the touched accounts, which is exact in any order;
//       rows that the ladder does not read are not loaded. Then round 0 of
//       the claims (claim.cuh): the claim column is all free between calls,
//       so its select is the first free slot of the id's window, and its
//       atomicMin follows at once;
//   (b) claim rounds 1-3, select | barrier | atomicMin | barrier; a round
//       after one that no lane contended in would want nothing either (the
//       column and the tables are as it found them), so that ends them;
//   (c) after the last round's settle and release, one row per (event,
//       side): the carry fold of the slot's digit sums into the pre-batch
//       account row's balances, and the overflow backstop;
//   (d) one thread: the fault gate (and commit_ts, the unsigned max of the
//       applied events' timestamps: waves run lanes out of order), sent to
//       every block's shared memory;
//   (e) if the gate passed, the account rows' balances, the stored transfer
//       rows and `fulfill`; in any case `bal_acc` back to zero.
// Phases (c) and (e) move each 128-byte row with eight lanes, 16 bytes a
// lane (one transaction a row, not eight). Rows read in (a)-(c) are the
// pre-batch snapshot; nothing writes a table before (e). Scratch written by
// one phase and read by another thread is read past L1 (__ldcg).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "claim.cuh"
#include "cluster.cuh"
#include "commit_transfers.cuh"

namespace cg = cooperative_groups;

// A block's header: its fault bits, ok count and the unsigned max of its
// ok events' timestamps (block 0's `want` flags serve the whole cluster).
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
  int32_t* ok;
  int32_t* lane_flags;  // bit 0: post/void, bit 1: post
  int64_t* slot2;       // [2B] account slot of each side, -1 if not applied
  int64_t* p_slot;
  int64_t* ins_slot;
  uint32_t* new_rows;  // [2B, 32] folded account rows
  uint32_t* ins_rows;  // [B, 32] rows to store (fast_pv; fast stores the batch row)
  ClaimScratch claim_sc;
};

static XferFast carve(char* scratch, int B, size_t* size) {
  XferFast a{};
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

extern "C" size_t tb_commit_transfers_fast_scratch(int B) {
  size_t size;
  carve(nullptr, B, &size);
  return size;
}

// Phase (a) for lane i, with claim round 0; returns its fault bits, sets
// *ok, and sets *want0 if the lane contends for a slot.
__device__ __forceinline__ uint32_t validate_lane(const XferFast& a, int i, bool* ok_out,
                                                  bool* want0) {
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
  // a row the ladder reads only where its lookup found it
  Acct dr = drf.found ? load_acct_ladder(a.acct_rows + (size_t)drf.slot * ROW_WORDS) : Acct{};
  Acct cr = crf.found ? load_acct_ladder(a.acct_rows + (size_t)crf.slot * ROW_WORDS) : Acct{};
  Xfer ex = exf.found ? unpack_transfer(load_row(a.xfer_rows + (size_t)exf.slot * ROW_WORDS))
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
  a.results[i] = (int32_t)r;
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
// that applied.
__device__ __forceinline__ void insert_rows(const XferFast& a, int i0, int step, RowGroup g) {
  int64_t ok_slot[CLUSTER_IN_FLIGHT], ins[CLUSTER_IN_FLIGHT];
  uint4 v[CLUSTER_IN_FLIGHT];
#pragma unroll
  for (int u = 0; u < CLUSTER_IN_FLIGHT; u++) {
    int i = i0 + u * step;
    ok_slot[u] = i < a.B ? __ldcg(a.slot2 + i) : -1;  // < 0: did not apply
    if (i >= a.B) continue;
    ins[u] = __ldcg(a.ins_slot + i);
    if (a.pv_mode) {
      v[u] = __ldcg(reinterpret_cast<const uint4*>(a.ins_rows + (size_t)i * ROW_WORDS) + g.sub);
    } else {  // the batch row with the event's timestamp
      v[u] = reinterpret_cast<const uint4*>(a.batch + (size_t)i * ROW_WORDS)[g.sub];
      if (g.sub == 7) {
        ull ts = event_ts(a.timestamp, a.n, i);
        v[u].z = (uint32_t)ts;
        v[u].w = (uint32_t)(ts >> 32);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < CLUSTER_IN_FLIGHT; u++) {
    if (ok_slot[u] < 0) continue;
    int i = i0 + u * step;
    reinterpret_cast<uint4*>(a.xfer_rows + (size_t)ins[u] * ROW_WORDS)[g.sub] = v[u];
    if (g.sub == 0) {
      a.fulfill[ins[u]] = 0u;
      int lf = __ldcg(a.lane_flags + i);
      if (lf & 1) a.fulfill[__ldcg(a.p_slot + i)] = (lf & 2) ? 1u : 2u;
    }
  }
}

__global__ void __launch_bounds__(CLUSTER_THREADS, 1) xfer_commit(XferFast a) {
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ XferHdr hdr_own;
  __shared__ WarpSums warp_sums[CLUSTER_THREADS / 32];
  __shared__ uint32_t proceed_own;
  uint32_t* want = cluster.map_shared_rank(hdr_own.want, 0);
  const int t = (int)cluster.thread_rank();
  const int stride = (int)cluster.num_threads();
  const int lane = threadIdx.x & 31;
  const bool warp_lead = lane == 0;
  const RowGroup g = row_group(lane);
  const int group = t >> 3, n_groups = stride >> 3;
  if (threadIdx.x == 0) {
    hdr_own.bad = 0u;
    for (int r = 0; r < CLAIM_ROUNDS; r++) hdr_own.want[r] = 0u;
  }
  cluster.sync();

  // (a) validate, and claim round 0
  uint32_t bad = 0u;
  unsigned ok_n = 0;
  ull ts_max = 0ull;
  bool wants = false;
  for (int i = t; i < a.B; i += stride) {
    bool ok;
    bad |= validate_lane(a, i, &ok, &wants);
    ok_n += ok;
    if (ok) ts_max = max(ts_max, event_ts(a.timestamp, a.n, i));
  }
  bad = __reduce_or_sync(FULL_MASK, bad);
  ok_n = __reduce_add_sync(FULL_MASK, ok_n);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    ts_max = max(ts_max, __shfl_xor_sync(FULL_MASK, ts_max, off));
  }
  if (warp_lead) warp_sums[threadIdx.x >> 5] = WarpSums{bad, ok_n, ts_max};
  if (__any_sync(FULL_MASK, wants) && warp_lead) atomicOr(want, 1u);
  cluster.sync();
  if (threadIdx.x == 0) {  // the block's header, read by the gate
    // `bad` by atomicOr: with no claim round to come, the other warps reach
    // their FAULT_CLAIM atomicOr below with no barrier between
    XferHdr h = hdr_own;
    h.ok_n = 0ull;
    h.ts_max = 0ull;
    h.any_ok = 0u;
    for (int w = 0; w < CLUSTER_THREADS / 32; w++) {
      h.bad |= warp_sums[w].bad;
      h.ok_n += warp_sums[w].ok_n;
      if (warp_sums[w].ok_n) h.ts_max = max(h.ts_max, warp_sums[w].ts_max);
      h.any_ok |= warp_sums[w].ok_n != 0u;
    }
    atomicOr(&hdr_own.bad, h.bad);
    hdr_own.ok_n = h.ok_n;
    hdr_own.ts_max = h.ts_max;
    hdr_own.any_ok = h.any_ok;
  }

  // (b) claim rounds 1.. (a round after one no lane contended in would
  // want nothing either); the flag is read once a warp
  bool more = __shfl_sync(FULL_MASK, warp_lead ? want[0] : 0u, 0) != 0u;
  for (int round = 1; round < CLAIM_ROUNDS && more; round++) {
    wants = false;
    for (int i = t; i < a.B; i += stride) {
      wants |= claim_select_lane(i, a.batch, ROW_WORDS, a.ok, a.xfer_rows, a.xfer_claim,
                                 a.t_log2, a.ins_slot, a.claim_sc, round, nullptr);
    }
    if (__any_sync(FULL_MASK, wants) && warp_lead) atomicOr(want + round, 1u);
    cluster.sync();
    more = __shfl_sync(FULL_MASK, warp_lead ? want[round] : 0u, 0) != 0u;
    if (!more) break;
    for (int i = t; i < a.B; i += stride) claim_min_lane(i, a.xfer_claim, a.claim_sc);
    cluster.sync();
  }
  // settle and release, then (c) fold: neither reads what the other writes
  bad = 0u;
  for (int i = t; i < a.B; i += stride) {
    if (claim_finish_lane(i, a.ok, a.xfer_claim, a.ins_slot, a.claim_sc)) bad |= FAULT_CLAIM;
  }
  for (int l = group; l < 2 * a.B; l += CLUSTER_IN_FLIGHT * n_groups) {
    bad |= fold_rows(a, l, n_groups, g, a.pv_mode != 0);
  }
  bad = __reduce_or_sync(FULL_MASK, bad);
  if (warp_lead && bad) atomicOr(&hdr_own.bad, bad);
  cluster.sync();

  // (d) the fault gate over the blocks' headers, one lane a block, decided
  // by one thread
  if (t < 32) {
    const unsigned nb = cluster.num_blocks();
    XferHdr h{};
    if ((unsigned)t < nb) h = *cluster.map_shared_rank(&hdr_own, (unsigned)t);
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
    }
    f = __shfl_sync(FULL_MASK, f, 0);
    if ((unsigned)t < nb) *cluster.map_shared_rank(&proceed_own, (unsigned)t) = f == 0u;
  }
  cluster.sync();

  // (e) apply; no block reads another's shared memory from here on
  const bool proceed = proceed_own != 0u;
  for (int l = group; l < 2 * a.B; l += CLUSTER_IN_FLIGHT * n_groups) {
    apply_rows(a, l, n_groups, g, proceed);
  }
  if (proceed) {
    for (int i = group; i < a.B; i += CLUSTER_IN_FLIGHT * n_groups) insert_rows(a, i, n_groups, g);
  }
}

// The cluster is non-portable (16 blocks), which a kernel must allow once;
// if that failed, the launch fails and says so.
static void xfer_commit_allow_cluster() {
  static bool done = cudaFuncSetAttribute(xfer_commit,
                                          cudaFuncAttributeNonPortableClusterSizeAllowed,
                                          1) == cudaSuccess;
  (void)done;
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
  xfer_commit_allow_cluster();
  launch_cluster(xfer_commit, a, stream);
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
