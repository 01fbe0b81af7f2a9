// The deterministic parallel slot claim of tigerbeetle_tpu/ops/hashtable.py
// `claim_slots` (:162-218), shared by the fast account and transfer commits
// (claim.cu).
#pragma once
#include <cuda_runtime.h>

#include <cstdint>

// Per-lane scratch of the claim rounds.
struct ClaimScratch {
  int64_t* cand;  // [B] this round's candidate slot
  int32_t* want;  // [B] 1 while the lane contends for `cand`
  int32_t* won;   // [B] 1 once the lane holds a slot
};

// Claim one distinct free slot of `rows` for every lane with active[i] != 0;
// the key of lane i is keys[i * key_stride .. + 4]. Writes slot[i] (the dump
// slot, 1 << cap_log2, for lanes that are inactive or lost every round),
// ORs FAULT_CLAIM into *bad if an active lane found no slot, and releases
// every claim before the last launch returns. Launches on `stream`.
//
// With `shard` (the sharded ledger, mesh_*.cu), `rows` and `claim` hold one
// table of (1 << cap_log2) + 1 rows per shard and lane i claims in table
// shard[i]: its slot is then the row index into the whole allocation, and
// contention is per (shard, slot), as every shard of the JAX mesh runs its
// own claim rounds over the lanes it owns.
void claim_slots(const uint32_t* keys, int key_stride, const int32_t* active, int B,
                 const uint32_t* rows, uint32_t* claim, int cap_log2, int64_t* slot,
                 ClaimScratch sc, uint32_t* bad, cudaStream_t stream,
                 const int32_t* shard = nullptr);
