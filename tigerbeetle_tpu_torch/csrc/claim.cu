// Slot claim rounds (ops/hashtable.py `claim_slots`), part of K2 and K3.
//
// The rule is the JAX package's, because it decides which slot each row
// lands in: 4 rounds; in each, every lane still wanting a slot picks its
// first probe position (W = 32) that is free in the table and unclaimed in
// the claim column AS IT STOOD AT THE START OF THE ROUND, then the lowest
// lane index wins each contended slot. Blocks run in no order, so a round
// is two launches: `claim_select` reads the column (and settles the
// previous round's winners), `claim_min` scatter-mins lane indices with
// atomicMin. No lane reads a claim written in its own round. A last launch
// settles the final round, flags unresolved lanes and releases every claim.
// Bound: a few 32-byte sectors per lane per round (key words + claim word);
// the launches are short, and the rounds after the first touch only the
// lanes that lost.
#include "claim.cuh"
#include "hash.cuh"

__device__ __forceinline__ void settle(int i, const int64_t* cand, int32_t* want, int32_t* won,
                                       int64_t* slot, const uint32_t* claim) {
  if (want[i] && claim[cand[i]] == (uint32_t)i) {
    won[i] = 1;
    slot[i] = cand[i];
  }
  want[i] = 0;
}

__global__ void claim_select(const uint32_t* __restrict__ keys, int key_stride,
                             const int32_t* __restrict__ active, int B,
                             const uint32_t* __restrict__ rows, const uint32_t* claim,
                             int cap_log2, int64_t* slot, ClaimScratch sc, int round,
                             const int32_t* __restrict__ shard) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  if (round == 0) {
    sc.won[i] = 0;
    sc.want[i] = 0;
    slot[i] = (int64_t)1 << cap_log2;
  } else {
    settle(i, sc.cand, sc.want, sc.won, slot, claim);
  }
  if (!active[i] || sc.won[i]) return;
  Probe pr = probe_of(key_at(keys + (size_t)i * key_stride), cap_log2);
  size_t base = shard == nullptr ? 0 : (size_t)shard[i] * (((size_t)1 << cap_log2) + 1);
  for (int j = 0; j < WINDOW; j++) {
    size_t p = base + pr.at(j);
    Key4 k = key_at(rows + p * ROW_WORDS);
    if ((key_empty(k) || key_tomb(k)) && claim[p] == CLAIM_FREE) {
      sc.cand[i] = (int64_t)p;
      sc.want[i] = 1;
      return;
    }
  }
}

__global__ void claim_min(int B, uint32_t* claim, ClaimScratch sc) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B || !sc.want[i]) return;
  atomicMin(claim + sc.cand[i], (uint32_t)i);
}

__global__ void claim_finish(const int32_t* __restrict__ active, int B, uint32_t* claim,
                             int64_t* slot, ClaimScratch sc, uint32_t* bad) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  settle(i, sc.cand, sc.want, sc.won, slot, claim);
  if (active[i] && !sc.won[i]) atomicOr(bad, FAULT_CLAIM);
  // A lane that lost may read its candidate after the winner released it:
  // it then sees CLAIM_FREE, which is no lane index, and stays lost.
  if (sc.won[i]) claim[slot[i]] = CLAIM_FREE;
}

void claim_slots(const uint32_t* keys, int key_stride, const int32_t* active, int B,
                 const uint32_t* rows, uint32_t* claim, int cap_log2, int64_t* slot,
                 ClaimScratch sc, uint32_t* bad, cudaStream_t stream, const int32_t* shard) {
  const int rounds = 4;
  int g = grid_for(B);
  for (int round = 0; round < rounds; round++) {
    claim_select<<<g, LANES_PER_BLOCK, 0, stream>>>(keys, key_stride, active, B, rows, claim,
                                                     cap_log2, slot, sc, round, shard);
    claim_min<<<g, LANES_PER_BLOCK, 0, stream>>>(B, claim, sc);
  }
  claim_finish<<<g, LANES_PER_BLOCK, 0, stream>>>(active, B, claim, slot, sc, bad);
}
