// K11tf: the sharded ledger's fast transfer commit, as one launch of one
// thread-block cluster.
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
// 128-byte batch row, one 32-byte sector per probe of its three chains on
// their owner shards, the touched account rows, and the stored row written.
// What held the launch-per-phase design back was its 13 launches and a
// memset a call (0.106 ms against 0.0013 ms of bytes, PERF.md).
//
// Design: K3's one launch over one cluster of CLUSTER_BLOCKS blocks
// (cluster.cuh), with a cluster barrier where a kernel boundary stood, and
// the owner probes of owner.cuh in place of the psum (the owner's probe is
// the psum's answer: its row if found, all zero else):
//   (0) each block zeroes its header in shared memory: fault bits, ok
//       count, commit_ts candidate, its per-shard insert counts (32-bit),
//       and in block 0 the rounds' want flags, which every warp reaches
//       through distributed shared memory (one 32-bit atomicOr a warp; the
//       64-bit sums stay in each block: a 64-bit atomicMax through
//       map_shared_rank lost updates on an H100, PERF.md);
//   (a) one lane per event: the three owner probes, the ladder
//       (validate.cuh), result codes, the insert counted for the id's owner
//       shard (a shared-memory atomicAdd), and atomicAdd of the amount's
//       16-bit digits into the owner shard's `bal_acc` row of each account,
//       exact in any order. Then claim round 0 (claim.cuh) on the id's
//       owner shard: the claim column is all free between calls, so its
//       select is the first free slot of the id's window there;
//   (b) claim rounds 1-3 with the id's owner as each lane's shard, so the
//       lowest lane wins each (shard, slot); a round after one that no lane
//       contended in would want nothing either, so that ends them;
//   (c) settle and release, then one row per (event, side): the carry fold
//       (unsigned: the fast tier has no post/void lanes, the host sends
//       those to the serial tier) and the overflow backstop;
//   (d) one warp: the fault gate over the blocks' headers, with the load
//       guard per shard (`used[s] + inserts[s] > half`); if it passed,
//       commit_ts becomes the last applied event's timestamp (lanes commit
//       in order, so the unsigned max of the applied timestamps; unchanged
//       with no applied event), the count and each shard's used slots grow;
//       the gate goes to every block's shared memory;
//   (e) if the gate passed, the account rows' balances, the stored transfer
//       rows (the batch row with its timestamp) and their fulfill words; in
//       any case `bal_acc` back to zero.
// Rows read in (a)-(c) are the pre-batch snapshot; nothing writes a table
// before (e); the fault word is ORed in, never stored.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "claim.cuh"
#include "cluster.cuh"
#include "owner.cuh"

namespace cg = cooperative_groups;

// A block's header: its fault bits, ok count, the unsigned max of its ok
// events' timestamps, its inserts on each shard (block 0's `want` flags
// serve the whole cluster).
struct MeshHdr {
  uint32_t bad, any_ok;
  uint32_t want[CLAIM_ROUNDS];
  ull ok_n, ts_max;
  uint32_t ins_n[MESH_SHARDS_MAX];
};

// One warp's share of phase (a), written by its first lane.
struct MeshWarpSums {
  uint32_t bad, ok_n;
  ull ts_max;
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

// Phase (a) for lane i, with claim round 0; returns its fault bits, sets
// *ok and *owner, and sets *want0 if the lane contends for a slot.
__device__ __forceinline__ uint32_t mesh_validate_lane(const MeshXferFast& a, int i, bool* ok_out,
                                                       int* owner_out, bool* want0) {
  Row row = load_row(a.batch + (size_t)i * ROW_WORDS);
  Xfer e = unpack_transfer(row);
  bool valid = i < a.n;
  ull ts = event_ts(a.timestamp, a.n, i);
  uint32_t r0 = transfer_common(e, e.ts != 0 ? 3u : 0u);
  Xfer ea = e;
  ea.ts = ts;

  const int S = a.n_shards;
  Found drf = owner_lookup(a.acct_rows, a.a_log2, S, key_in(row, 4), WINDOW);
  Found crf = owner_lookup(a.acct_rows, a.a_log2, S, key_in(row, 8), WINDOW);
  Found exf = owner_lookup(a.xfer_rows, a.t_log2, S, key_in(row, 0), WINDOW);
  // a row the ladder reads only where its owner's probe found it
  Acct dr = drf.found ? load_acct_ladder(a.acct_rows + (size_t)drf.slot * ROW_WORDS) : Acct{};
  Acct cr = crf.found ? load_acct_ladder(a.acct_rows + (size_t)crf.slot * ROW_WORDS) : Acct{};
  Xfer ex = exf.found ? unpack_transfer(load_row(a.xfer_rows + (size_t)exf.slot * ROW_WORDS))
                      : Xfer{};
  u128 amt;
  uint32_t r = validate_simple_transfer(r0, ea, dr, cr, drf.found, crf.found, ex, exf.found, &amt);
  uint32_t bad = valid && !(drf.resolved && crf.resolved && exf.resolved) ? FAULT_PROBE : 0u;
  if (!valid) r = 0u;
  bool ok = valid && r == 0u;
  int owner = owner_of(key_in(row, 0), S);
  *ok_out = ok;
  *owner_out = owner;
  // claim round 0 on the id's owner shard: the claim column is all free
  // between calls (claim.cuh), so this round's pick is the first free slot
  // of the id's window there
  ClaimScratch sc = a.claim_sc;
  sc.won[i] = 0;
  sc.want[i] = 0;
  a.ins_slot[i] = (int64_t)1 << a.t_log2;
  if (ok) {
    size_t base = shard_base(owner, a.t_log2);
    Found fr = table_probe_free(a.xfer_rows + base * ROW_WORDS, a.t_log2, key_in(row, 0),
                                WINDOW);
    if (fr.resolved) {
      int64_t slot = (int64_t)base + fr.slot;
      sc.cand[i] = slot;
      sc.want[i] = 1;
      atomicMin(a.xfer_claim + slot, (uint32_t)i);
      *want0 = true;
    }
  }
  a.results[i] = (int32_t)r;
  a.ok[i] = ok;
  a.shard[i] = owner;
  if (!ok) {
    a.slot2[i] = -1;
    a.slot2[a.B + i] = -1;
    return bad;
  }
  a.slot2[i] = drf.slot;
  a.slot2[a.B + i] = crf.slot;
  // acc words: dp digits 0..7, dpo 8..15, cp 16..23, cpo 24..31
  int off = (e.flags & F_PENDING) ? 0 : 8;
  add_digits(a.bal_acc + (size_t)drf.slot * ROW_WORDS + off, amt, false);
  add_digits(a.bal_acc + (size_t)crf.slot * ROW_WORDS + 16 + off, amt, false);
  return bad;
}

// Phase (e), transfers: the batch rows, with their events' timestamps, of
// the events i0, i0 + step, ... that applied, at their claimed slots.
__device__ __forceinline__ void mesh_insert_rows(const MeshXferFast& a, int i0, int step,
                                                 RowGroup g) {
  int64_t ok_slot[CLUSTER_IN_FLIGHT], ins[CLUSTER_IN_FLIGHT];
  uint4 v[CLUSTER_IN_FLIGHT];
#pragma unroll
  for (int u = 0; u < CLUSTER_IN_FLIGHT; u++) {
    int i = i0 + u * step;
    ok_slot[u] = i < a.B ? __ldcg(a.slot2 + i) : -1;  // < 0: did not apply
    if (i >= a.B) continue;
    ins[u] = __ldcg(a.ins_slot + i);
    v[u] = reinterpret_cast<const uint4*>(a.batch + (size_t)i * ROW_WORDS)[g.sub];
    if (g.sub == 7) {
      ull ts = event_ts(a.timestamp, a.n, i);
      v[u].z = (uint32_t)ts;
      v[u].w = (uint32_t)(ts >> 32);
    }
  }
#pragma unroll
  for (int u = 0; u < CLUSTER_IN_FLIGHT; u++) {
    if (ok_slot[u] < 0) continue;
    reinterpret_cast<uint4*>(a.xfer_rows + (size_t)ins[u] * ROW_WORDS)[g.sub] = v[u];
    if (g.sub == 0) a.fulfill[ins[u]] = 0u;
  }
}

__global__ void __launch_bounds__(CLUSTER_THREADS, 1) mesh_xfer_commit(MeshXferFast a) {
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ MeshHdr hdr_own;
  __shared__ MeshWarpSums warp_sums[CLUSTER_THREADS / 32];
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
  for (int s = threadIdx.x; s < MESH_SHARDS_MAX; s += blockDim.x) hdr_own.ins_n[s] = 0u;
  cluster.sync();

  // (a) validate, count each shard's inserts, and claim round 0
  uint32_t bad = 0u;
  unsigned ok_n = 0;
  ull ts_max = 0ull;
  bool wants = false;
  for (int i = t; i < a.B; i += stride) {
    bool ok;
    int owner;
    bad |= mesh_validate_lane(a, i, &ok, &owner, &wants);
    ok_n += ok;
    if (ok) {
      ts_max = max(ts_max, event_ts(a.timestamp, a.n, i));
      atomicAdd(&hdr_own.ins_n[owner], 1u);
    }
  }
  bad = __reduce_or_sync(FULL_MASK, bad);
  ok_n = __reduce_add_sync(FULL_MASK, ok_n);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    ts_max = max(ts_max, __shfl_xor_sync(FULL_MASK, ts_max, off));
  }
  if (warp_lead) warp_sums[threadIdx.x >> 5] = MeshWarpSums{bad, ok_n, ts_max};
  if (__any_sync(FULL_MASK, wants) && warp_lead) atomicOr(want, 1u);
  cluster.sync();
  if (threadIdx.x == 0) {  // the block's header, read by the gate
    // `bad` by atomicOr: with no claim round to come, the other warps reach
    // their FAULT_CLAIM atomicOr below with no barrier between
    uint32_t b = 0u, any_ok = 0u;
    ull n_ok = 0ull, ts = 0ull;
    for (int w = 0; w < CLUSTER_THREADS / 32; w++) {
      b |= warp_sums[w].bad;
      n_ok += warp_sums[w].ok_n;
      if (warp_sums[w].ok_n) ts = max(ts, warp_sums[w].ts_max);
      any_ok |= warp_sums[w].ok_n != 0u;
    }
    atomicOr(&hdr_own.bad, b);
    hdr_own.ok_n = n_ok;
    hdr_own.ts_max = ts;
    hdr_own.any_ok = any_ok;
  }

  // (b) claim rounds 1.. on each lane's owner shard; the flag is read once
  // a warp
  bool more = __shfl_sync(FULL_MASK, warp_lead ? want[0] : 0u, 0) != 0u;
  for (int round = 1; round < CLAIM_ROUNDS && more; round++) {
    wants = false;
    for (int i = t; i < a.B; i += stride) {
      wants |= claim_select_lane(i, a.batch, ROW_WORDS, a.ok, a.xfer_rows, a.xfer_claim,
                                 a.t_log2, a.ins_slot, a.claim_sc, round, a.shard);
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
    bad |= fold_rows(a, l, n_groups, g, false);
  }
  bad = __reduce_or_sync(FULL_MASK, bad);
  if (warp_lead && bad) atomicOr(&hdr_own.bad, bad);
  cluster.sync();

  // (d) the fault gate over the blocks' headers, by block 0's first warp:
  // lane b reads block b's sums, lane s (and s + 32) sums shard s's inserts
  if (t < 32) {
    const unsigned nb = cluster.num_blocks();
    uint32_t f = 0u, any_ok = 0u;
    ull n_ok = 0ull, ts = 0ull;
    if ((unsigned)t < nb) {
      const MeshHdr* h = cluster.map_shared_rank(&hdr_own, (unsigned)t);
      f = h->bad;
      any_ok = h->any_ok;
      n_ok = h->ok_n;
      ts = h->any_ok ? h->ts_max : 0ull;
    }
    ull ins[2] = {0ull, 0ull};
    const ull half = (1ull << a.t_log2) / 2;
#pragma unroll
    for (int k = 0; k < 2; k++) {
      const int s = t + 32 * k;
      if (s >= a.n_shards) continue;
      for (unsigned b = 0; b < nb; b++) ins[k] += cluster.map_shared_rank(&hdr_own, b)->ins_n[s];
      if (a.used[s] + ins[k] > half) f |= FAULT_CAPACITY;
    }
    f = __reduce_or_sync(FULL_MASK, f);
    any_ok = __reduce_or_sync(FULL_MASK, any_ok);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      n_ok += __shfl_xor_sync(FULL_MASK, n_ok, off);
      ts = max(ts, __shfl_xor_sync(FULL_MASK, ts, off));
    }
    if (t == 0) f |= *a.fault;
    f = __shfl_sync(FULL_MASK, f, 0);
    if (t == 0) {
      *a.fault = f;
      if (f == 0u) {
        *a.count += n_ok;
        if (any_ok) *a.commit_ts = ts;
      }
    }
    if (f == 0u) {
#pragma unroll
      for (int k = 0; k < 2; k++) {
        const int s = t + 32 * k;
        if (s < a.n_shards) a.used[s] += ins[k];
      }
    }
    if ((unsigned)t < nb) *cluster.map_shared_rank(&proceed_own, (unsigned)t) = f == 0u;
  }
  cluster.sync();

  // (e) apply; no block reads another's shared memory from here on
  const bool proceed = proceed_own != 0u;
  for (int l = group; l < 2 * a.B; l += CLUSTER_IN_FLIGHT * n_groups) {
    apply_rows(a, l, n_groups, g, proceed);
  }
  if (proceed) {
    for (int i = group; i < a.B; i += CLUSTER_IN_FLIGHT * n_groups) {
      mesh_insert_rows(a, i, n_groups, g);
    }
  }
}

static void mesh_xfer_commit_allow_cluster() {
  static bool done = cudaFuncSetAttribute(mesh_xfer_commit,
                                          cudaFuncAttributeNonPortableClusterSizeAllowed,
                                          1) == cudaSuccess;
  (void)done;
}

extern "C" int tb_mesh_commit_transfers_fast(uint32_t* acct_rows, int a_log2, uint32_t* xfer_rows,
                                             int t_log2, int n_shards, uint32_t* fulfill,
                                             uint32_t* xfer_claim, uint32_t* bal_acc,
                                             ull* commit_ts, ull* xfer_count, ull* xfer_used,
                                             uint32_t* fault, const uint32_t* batch, int B, int n,
                                             ull timestamp, int32_t* results, char* scratch,
                                             cudaStream_t stream) {
  if (n_shards < 1 || n_shards > MESH_SHARDS_MAX) return (int)cudaErrorInvalidValue;
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
  mesh_xfer_commit_allow_cluster();
  launch_cluster(mesh_xfer_commit, a, stream);
  return (int)cudaGetLastError();
}
