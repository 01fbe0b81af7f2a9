// The deterministic parallel slot claim of tigerbeetle_tpu/ops/hashtable.py
// `claim_slots` (:162-218), shared by the fast account and transfer commits,
// the snapshot install and the spill reload.
//
// The rule is the JAX package's, because it decides which slot each row
// lands in: CLAIM_ROUNDS rounds; in each, every lane still wanting a slot
// picks its first probe position (W = 32) that is free in the table and
// unclaimed in the claim column AS IT STOOD AT THE START OF THE ROUND, then
// the lowest lane index wins each contended slot. A round is two steps with
// a barrier between and after them: `claim_select_lane` reads the column
// (and settles the previous round's winners), `claim_min_lane` scatter-mins
// lane indices with atomicMin. No lane reads a claim written in its own
// round. `claim_finish_lane` settles the final round, reports an active lane
// that lost every round and releases its claim.
//
// The round bodies below are the one statement of the rule. Every claimant
// runs them inside one thread-block cluster with a cluster barrier for each
// barrier of the rule (cluster.cuh `cluster_claims`): the fast account
// commits (acct_commit.cuh), K3 and K5 (xfer_commit.cuh), K11tf
// (mesh_commit_transfers.cu), K9 (install.cu) and K10's reload
// (spill_reload.cu). The commits run round 0's select in their validation
// phase: the claim column is all free between calls (every claimant
// releases before it returns), so that select is the first free slot of the
// window. A lane index is always handled by the same thread in every step,
// so the per-lane scratch needs no barrier; the claim column, which other
// lanes' atomics change, is read past L1. K9 and K10's reload run the rounds
// chunk after chunk in one launch: there the table's key words, which an
// earlier chunk wrote, are read past L1 too (kPastL1), as in K5's later
// slots (group_commit.cu).
//
// With a per-lane `shard` (the sharded ledger), `rows` and `claim` hold one
// table of (1 << cap_log2) + 1 rows per shard and lane i claims in table
// shard[i]: its slot is then the row index into the whole allocation, and
// contention is per (shard, slot), as every shard of the JAX mesh runs its
// own claim rounds over the lanes it owns.
//
// `active` is an int32 array (lane i is active where it is nonzero) or a
// callable `bool(int i)`.
#pragma once
#include <cuda_runtime.h>

#include <cstdint>

#include "hash.cuh"

#define CLAIM_ROUNDS 4

// Per-lane scratch of the claim rounds.
struct ClaimScratch {
  int64_t* cand;  // [B] this round's candidate slot
  int32_t* want;  // [B] 1 while the lane contends for `cand`
  int32_t* won;   // [B] 1 once the lane holds a slot
};

__device__ __forceinline__ void claim_settle(int i, const ClaimScratch& sc, int64_t* slot,
                                             const uint32_t* claim) {
  if (sc.want[i] && __ldcg(claim + sc.cand[i]) == (uint32_t)i) {
    sc.won[i] = 1;
    slot[i] = sc.cand[i];
  }
  sc.want[i] = 0;
}

__device__ __forceinline__ bool lane_active(const int32_t* active, int i) {
  return active[i] != 0;
}
__device__ __forceinline__ bool lane_active(int32_t* active, int i) { return active[i] != 0; }
template <class F>
__device__ __forceinline__ bool lane_active(const F& active, int i) {
  return active(i);
}

// Step one of `round` for lane i; true if the lane now contends for a slot.
// With `shard`, lane i claims in table shard[i] of (1 << cap_log2) + 1 rows.
template <bool kPastL1 = false, class Active>
__device__ __forceinline__ bool claim_select_lane(int i, const uint32_t* __restrict__ keys,
                                                  int key_stride, const Active& active,
                                                  const uint32_t* __restrict__ rows,
                                                  const uint32_t* claim, int cap_log2,
                                                  int64_t* slot,
                                                  const ClaimScratch& sc, int round,
                                                  const int32_t* shard) {
  if (round == 0) {
    sc.won[i] = 0;
    sc.want[i] = 0;
    slot[i] = (int64_t)1 << cap_log2;
  } else {
    claim_settle(i, sc, slot, claim);
  }
  if (!lane_active(active, i) || sc.won[i]) return false;
  Probe pr = probe_of(key_at(keys + (size_t)i * key_stride), cap_log2);
  size_t base = shard == nullptr ? 0 : (size_t)shard[i] * (((size_t)1 << cap_log2) + 1);
  for (int j = 0; j < WINDOW; j++) {
    size_t p = base + pr.at(j);
    Key4 k = kPastL1 ? key_at_cg(rows + p * ROW_WORDS) : key_at(rows + p * ROW_WORDS);
    if ((key_empty(k) || key_tomb(k)) && __ldcg(claim + p) == CLAIM_FREE) {
      sc.cand[i] = (int64_t)p;
      sc.want[i] = 1;
      return true;
    }
  }
  return false;
}

// Step two: the lowest contending lane index wins each slot.
__device__ __forceinline__ void claim_min_lane(int i, uint32_t* claim, const ClaimScratch& sc) {
  if (sc.want[i]) atomicMin(claim + sc.cand[i], (uint32_t)i);
}

// After the last round's barrier: settle, release, and return true for an
// active lane with no slot (FAULT_CLAIM). A lane that lost may read its
// candidate after the winner released it: it then sees CLAIM_FREE, which is
// no lane index, and stays lost.
template <class Active>
__device__ __forceinline__ bool claim_finish_lane(int i, const Active& active, uint32_t* claim,
                                                  int64_t* slot, const ClaimScratch& sc) {
  claim_settle(i, sc, slot, claim);
  bool lost = lane_active(active, i) && !sc.won[i];
  if (sc.won[i]) claim[slot[i]] = CLAIM_FREE;
  return lost;
}
