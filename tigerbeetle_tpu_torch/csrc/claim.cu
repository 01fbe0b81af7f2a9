// Slot claim rounds (ops/hashtable.py `claim_slots`) as launches, for K2
// and K11 (K3, K5, K9, K10's reload and K11tf run the same rounds in one
// cluster launch, cluster.cuh).
//
// The round bodies and the rule are claim.cuh's. Blocks run in no order, so
// each barrier of the rule is a kernel boundary: a round is two launches,
// `claim_select` and `claim_min`, and a last launch settles the final round,
// flags unresolved lanes and releases every claim.
// Bound: a few 32-byte sectors per lane per round (key words + claim word);
// the launches are short, and the rounds after the first touch only the
// lanes that lost.
#include "claim.cuh"

__global__ void claim_select(const uint32_t* __restrict__ keys, int key_stride,
                             const int32_t* __restrict__ active, int B,
                             const uint32_t* __restrict__ rows, const uint32_t* claim,
                             int cap_log2, int64_t* slot, ClaimScratch sc, int round,
                             const int32_t* __restrict__ shard) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  claim_select_lane(i, keys, key_stride, active, rows, claim, cap_log2, slot, sc, round, shard);
}

__global__ void claim_min(int B, uint32_t* claim, ClaimScratch sc) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < B) claim_min_lane(i, claim, sc);
}

__global__ void claim_finish(const int32_t* __restrict__ active, int B, uint32_t* claim,
                             int64_t* slot, ClaimScratch sc, uint32_t* bad) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  if (claim_finish_lane(i, active, claim, slot, sc)) atomicOr(bad, FAULT_CLAIM);
}

void claim_slots(const uint32_t* keys, int key_stride, const int32_t* active, int B,
                 const uint32_t* rows, uint32_t* claim, int cap_log2, int64_t* slot,
                 ClaimScratch sc, uint32_t* bad, cudaStream_t stream, const int32_t* shard) {
  int g = grid_for(B);
  for (int round = 0; round < CLAIM_ROUNDS; round++) {
    claim_select<<<g, LANES_PER_BLOCK, 0, stream>>>(keys, key_stride, active, B, rows, claim,
                                                     cap_log2, slot, sc, round, shard);
    claim_min<<<g, LANES_PER_BLOCK, 0, stream>>>(B, claim, sc);
  }
  claim_finish<<<g, LANES_PER_BLOCK, 0, stream>>>(active, B, claim, slot, sc, bad);
}
