// The fast create_accounts commit over one thread-block cluster: K2 fast
// (commit_accounts.cu, one table) and K11af (mesh_commit_accounts.cu, the
// sharded ledger) run this one body, a template over the lookup policy of
// owner.cuh (AcctOneTable, AcctShards): where a key lives and whose load
// guard its insert is charged to.
//
// The JAX programs (models/ledger.py `_commit_accounts` fast, parallel/
// mesh.py `_commit_accounts_fast`): every event probes its id (W = 32) on
// its owner's table and validates against the row found there; the claim
// rounds of claim.cuh give every valid event a distinct free slot of its
// owner's table, the lowest lane winning each (shard, slot); the fault gate
// (sticky fault | FAULT_PROBE, a valid event whose probe did not resolve |
// FAULT_CLAIM | FAULT_CAPACITY, each shard's used slots plus the inserts it
// owns above half its slots) is decided before anything is written; if it
// passed, the rows are stored with their timestamps (words 30-31), commit_ts
// becomes the batch's last ok timestamp (assigned, not maxed), the count
// and each shard's used slots grow. With one table the guard is the used
// slots plus the batch's ok count, as the single-table program charges it.
//
// Bound on an H100: bytes (the batch row in, a code out, a 32-byte sector a
// probe, the row written). The launch-per-round design it replaces made 13
// launches and a memset a call, each barrier of the rule a kernel boundary.
// Here one launch of one cluster of CLUSTER_BLOCKS blocks (cluster.cuh),
// lane loops striding over the cluster's threads (any B), a cluster barrier
// where a kernel boundary stood:
//   (0) each block zeroes its header in shared memory: fault bits, its
//       per-shard insert counts, and in block 0 the rounds' want words,
//       which every warp reaches through distributed shared memory (a
//       32-bit atomicOr a warp; the 64-bit sums stay in each block: a
//       64-bit atomicMax through map_shared_rank lost updates on an H100);
//   (1) one lane per event: the probe on the owner's table, the row found,
//       validate_create_account, the code; the insert counted for its owner
//       shard. Then claim round 0: the claim column is all free between
//       calls (claim.cuh), so the round's pick is the first free slot of the
//       id's window, which an ok id's lookup already gives where it
//       resolved (an ok id is not in its window), and its atomicMin follows
//       at once;
//   (2) claim rounds 1-3, settle and release (cluster.cuh `cluster_claims`,
//       each lane on its owner shard);
//   (3) block 0's first warp: the fault gate over the blocks' headers, the
//       counters, sent to every block;
//   (4) if the gate passed, each warp stores the rows of its 32 lanes, eight
//       lanes to a 128-byte row (the slot by __shfl_sync from the lane that
//       settled it; the lane holding piece 7 writes the timestamp words).
// Rows read in (1)-(2) are the pre-batch table; nothing writes a table
// before (4).
#pragma once
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "claim.cuh"
#include "cluster.cuh"
#include "owner.cuh"

struct AcctFast {
  uint32_t* rows;  // one table, or n_shards of (1 << log2) + 1 rows each
  uint32_t* claim;
  int log2, n_shards;
  ull* commit_ts;
  ull* count;
  ull* used;  // [n_shards]
  uint32_t* fault;
  const uint32_t* batch;
  int B, n;
  ull timestamp;
  int32_t* results;
  // scratch, per lane
  int32_t* ok;
  int32_t* shard;  // the id's owner
  int64_t* slot;   // the row claimed (global)
  ClaimScratch claim_sc;
};

static AcctFast acct_fast_carve(char* scratch, int B, size_t* size) {
  AcctFast a{};
  Carver c{scratch, 0};
  a.ok = c.take<int32_t>(B);
  a.shard = c.take<int32_t>(B);
  a.slot = c.take<int64_t>(B);
  a.claim_sc.cand = c.take<int64_t>(B);
  a.claim_sc.want = c.take<int32_t>(B);
  a.claim_sc.won = c.take<int32_t>(B);
  *size = c.off + 256;
  return a;
}

// A block's header: its fault bits, ok count, the unsigned max of its ok
// events' timestamps, its inserts on each shard (block 0's `want` words
// serve the whole cluster).
struct AcctHdr {
  uint32_t bad, any_ok;
  uint32_t want[CLAIM_ROUNDS];
  ull ok_n, ts_max;
  uint32_t ins_n[MESH_SHARDS_MAX];
};

// One warp's share of phase (1), written by its first lane.
struct AcctWarpSums {
  uint32_t bad, ok_n;
  ull ts_max;
};

// Phase (1) for lane i, with claim round 0; returns its fault bits, sets
// *ok and *owner, and sets *want0 if the lane contends for a slot.
template <class P>
__device__ __forceinline__ uint32_t acct_validate_lane(const AcctFast& a, const P& pol, int i,
                                                       bool* ok_out, int* owner_out,
                                                       bool* want0) {
  const Row row = load_row(a.batch + (size_t)i * ROW_WORDS);
  const Acct e = unpack_account(row);
  const bool valid = i < a.n;
  const Key4 key = key_in(row, 0);
  const int owner = pol.owner(key);
  const int64_t base = pol.base(owner, a.log2);
  const uint32_t* table = a.rows + (size_t)base * ROW_WORDS;
  const Found ex = table_lookup(table, a.log2, key, WINDOW);
  // the ladder reads the row only where the probe found it
  const Acct exr = ex.found ? unpack_account(load_row(table + (size_t)ex.slot * ROW_WORDS))
                            : Acct{};
  uint32_t r = validate_create_account(e.ts != 0 ? 3u : 0u, e, exr, ex.found);
  if (!valid) r = 0u;
  const bool ok = valid && r == 0u;
  ClaimScratch sc = a.claim_sc;
  sc.won[i] = 0;
  sc.want[i] = 0;
  a.slot[i] = (int64_t)1 << a.log2;
  if (ok) {  // claim round 0: the first free slot of the window
    const Found fr = ex.resolved ? ex : table_probe_free(table, a.log2, key, WINDOW);
    if (fr.resolved) {
      const int64_t slot = base + fr.slot;
      sc.cand[i] = slot;
      sc.want[i] = 1;
      atomicMin(a.claim + slot, (uint32_t)i);
      *want0 = true;
    }
  }
  a.results[i] = (int32_t)r;
  a.ok[i] = ok;
  a.shard[i] = owner;
  *ok_out = ok;
  *owner_out = owner;
  return valid && !ex.resolved ? FAULT_PROBE : 0u;
}

template <class P>
__global__ void __launch_bounds__(CLUSTER_THREADS, 1) acct_commit_fast(AcctFast a) {
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const P pol{a.n_shards};
  __shared__ AcctHdr hdr;
  __shared__ AcctWarpSums warp_sums[CLUSTER_THREADS / 32];
  __shared__ uint32_t proceed;
  uint32_t* want = cluster.map_shared_rank(hdr.want, 0);
  const int t = (int)cluster.thread_rank();
  const int stride = (int)cluster.num_threads();
  const int lane = threadIdx.x & 31;
  const bool warp_lead = lane == 0;
  if (threadIdx.x == 0) {
    hdr.bad = 0u;
    for (int r = 0; r < CLAIM_ROUNDS; r++) hdr.want[r] = 0u;
  }
  for (int s = threadIdx.x; s < MESH_SHARDS_MAX; s += blockDim.x) hdr.ins_n[s] = 0u;
  cluster.sync();

  // (1) validate, count each shard's inserts, and claim round 0
  uint32_t bad = 0u;
  unsigned ok_n = 0;
  ull ts_max = 0ull;
  bool wants = false;
  for (int i = t; i < a.B; i += stride) {
    bool ok;
    int owner;
    bad |= acct_validate_lane(a, pol, i, &ok, &owner, &wants);
    if (ok) {
      ok_n++;
      ts_max = max(ts_max, event_ts(a.timestamp, a.n, i));
      // one shared-memory atomic for the ok lanes of this warp on one shard
      const unsigned peers = __match_any_sync(__activemask(), owner);
      if (lane == __ffs(peers) - 1) atomicAdd(&hdr.ins_n[owner], (uint32_t)__popc(peers));
    }
  }
  bad = __reduce_or_sync(FULL_MASK, bad);
  ok_n = __reduce_add_sync(FULL_MASK, ok_n);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    ts_max = max(ts_max, __shfl_xor_sync(FULL_MASK, ts_max, off));
  }
  if (warp_lead) warp_sums[threadIdx.x >> 5] = AcctWarpSums{bad, ok_n, ts_max};
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
    atomicOr(&hdr.bad, b);
    hdr.ok_n = n_ok;
    hdr.ts_max = ts;
    hdr.any_ok = any_ok;
  }

  // (2) claim rounds 1.. on each lane's owner shard, settle and release
  bad = cluster_claims<false>(cluster, want, 1u, false, a.batch, ROW_WORDS, a.ok, a.B, a.rows,
                              a.claim, a.log2, a.slot, a.claim_sc, a.shard);
  bad = __reduce_or_sync(FULL_MASK, bad);
  if (warp_lead && bad) atomicOr(&hdr.bad, bad);
  cluster.sync();

  // (3) the fault gate over the blocks' headers, by block 0's first warp:
  // lane b reads block b's sums, lane s (and s + 32) sums shard s's inserts
  if (t < 32) {
    const unsigned nb = cluster.num_blocks();
    uint32_t f = 0u, any_ok = 0u;
    ull n_ok = 0ull, ts = 0ull;
    if ((unsigned)t < nb) {
      const AcctHdr* h = cluster.map_shared_rank(&hdr, (unsigned)t);
      f = h->bad;
      any_ok = h->any_ok;
      n_ok = h->ok_n;
      ts = h->any_ok ? h->ts_max : 0ull;
    }
    ull ins[2] = {0ull, 0ull};
    const ull half = (1ull << a.log2) / 2;
#pragma unroll
    for (int k = 0; k < 2; k++) {
      const int s = t + 32 * k;
      if (s >= pol.n_shards) continue;
      for (unsigned b = 0; b < nb; b++) ins[k] += cluster.map_shared_rank(&hdr, b)->ins_n[s];
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
        if (any_ok) *a.commit_ts = ts;  // the last ok event's: lanes commit in order
      }
    }
    if (f == 0u) {
#pragma unroll
      for (int k = 0; k < 2; k++) {
        const int s = t + 32 * k;
        if (s < pol.n_shards) a.used[s] += ins[k];
      }
    }
    if ((unsigned)t < nb) *cluster.map_shared_rank(&proceed, (unsigned)t) = f == 0u;
  }
  cluster.sync();

  // (4) apply; no block reads another's shared memory from here on. The
  // warp's lanes i0 .. i0 + 31 (this thread settled lane i0 + lane), row j
  // of them by the eight lanes of group j % 4; a lane holds a slot iff it
  // was ok, as the gate passed
  if (proceed == 0u) return;
  const RowGroup g = row_group(lane);
  for (int i0 = t - lane; i0 < a.B; i0 += stride) {
    const int i = i0 + lane;
    const int64_t s = i < a.B && a.claim_sc.won[i] ? a.slot[i] : -1;
    int64_t dst[CLUSTER_IN_FLIGHT];
    uint4 v[CLUSTER_IN_FLIGHT];
#pragma unroll
    for (int u = 0; u < CLUSTER_IN_FLIGHT; u++) {
      const int j = (lane >> 3) + 4 * u;
      dst[u] = __shfl_sync(FULL_MASK, s, j);
      if (dst[u] < 0) continue;
      v[u] = reinterpret_cast<const uint4*>(a.batch + (size_t)(i0 + j) * ROW_WORDS)[g.sub];
      if (g.sub == 7) {  // words 28-31: the timestamp is words 30-31
        const ull ts = event_ts(a.timestamp, a.n, i0 + j);
        v[u].z = (uint32_t)ts;
        v[u].w = (uint32_t)(ts >> 32);
      }
    }
#pragma unroll
    for (int u = 0; u < CLUSTER_IN_FLIGHT; u++) {
      if (dst[u] >= 0) reinterpret_cast<uint4*>(a.rows + (size_t)dst[u] * ROW_WORDS)[g.sub] = v[u];
    }
  }
}

// The commit of `a.batch` (lanes < a.n) on `stream`: one launch of one
// cluster. The cluster is non-portable (16 blocks), which each instance of
// the kernel allows once; if that failed, the launch fails and says so.
template <class P>
static int acct_fast_launch(const AcctFast& a, cudaStream_t stream) {
  static const bool allowed = cudaFuncSetAttribute(acct_commit_fast<P>,
                                                   cudaFuncAttributeNonPortableClusterSizeAllowed,
                                                   1) == cudaSuccess;
  (void)allowed;
  launch_cluster(acct_commit_fast<P>, a, stream);
  return (int)cudaGetLastError();
}
