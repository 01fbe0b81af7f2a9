// The one-launch fast transfer commit's shared pieces: K3
// (commit_transfers.cu, one table) and K11tf (mesh_commit_transfers.cu,
// the sharded ledger) each run their phases in one kernel over one
// thread-block cluster of CLUSTER_BLOCKS blocks of CLUSTER_THREADS threads
// (512 threads, so that the validation ladder's ~120 registers fit; 16
// blocks, H100's largest, non-portable cluster: a cluster lives in one GPC,
// and its SMs' L1-to-L2 transactions bound the phases that move rows), with
// a cluster barrier where a kernel boundary stood. Here: the digit sums of
// the amounts, the ladder's account loads, and the phases that move
// 128-byte account rows with eight lanes a row, CLUSTER_IN_FLIGHT rows in
// flight: the carry fold (c) and the apply (e).
//
// The claim rounds (claim.cuh) over one cluster are here too, for every
// claimant: K3 and K5, K11tf, the fast account commits K2 fast and K11af
// (acct_commit.cuh), and K9 (install.cu) and K10's reload (spill_reload.cu),
// the last two chunk after chunk.
//
// fold_rows and apply_rows take the kernel's argument struct `A`, which
// holds acct_rows, bal_acc, new_rows ([2B, 32] folded rows), slot2 ([2B]
// the account row of each (event, side), -1 where the event did not apply)
// and B. Scratch that one phase writes and another thread reads is read
// past L1 (__ldcg).
//
// With the template option kList (K12, wave_commit.cu), fold_rows,
// apply_rows and cluster_claims run over one wave's lane list (LaneList)
// instead of all B lanes, with the list's entries spread over the cluster
// (spread_rank); with it off they compile to the SASS K3, K5, K11tf and K9
// had before the option (serial_ab.py --kind sass). The list comes by
// pointer, null where the option is off: a defaulted LaneList temporary
// changed K11tf's instruction schedule.
#pragma once
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "claim.cuh"
#include "hash.cuh"
#include "validate.cuh"

#define CLUSTER_BLOCKS 16
#define CLUSTER_THREADS 512
// K12's blocks (wave_commit.cu): 8 warps, so that its wave loop has up to
// 255 registers a thread (see there).
#define WAVE_THREADS 256
#define CLUSTER_IN_FLIGHT 8  // rows a row group has in flight in phases (c) and (e)
#define FULL_MASK 0xFFFFFFFFu

__device__ __forceinline__ ull event_ts(ull timestamp, int n, int i) {
  return timestamp - (ull)n + (ull)i + 1ull;
}

// The lanes of one wave (K12): entry k < cnt is lane lanes[k], in ascending
// lane order. Other blocks of the cluster wrote the list before the
// barrier that opens the wave, so it is read past L1. A wave's (event,
// side) rows are 2 cnt: row l < cnt is entry l's debit side (row lanes[l]
// of the batch's 2B), row cnt + k entry k's credit side (row B + lanes[k]).
// `first` is this thread's first entry (its spread_rank over lanes).
struct LaneList {
  const int32_t* lanes;
  int cnt;
  int first;
  __device__ __forceinline__ int lane(int k) const { return __ldcg(lanes + k); }
  __device__ __forceinline__ int row(int l, int B) const {
    return l < cnt ? lane(l) : B + lane(l - cnt);
  }
};

// A rank over the cluster in runs of one warp, the blocks innermost: run c
// (`per_warp` ranks: 32 lanes, or 4 row groups of eight lanes, `sub` this
// thread's) goes to warp c / CLUSTER_BLOCKS of block c % CLUSTER_BLOCKS.
// A short wave's entries so run on every SM of the cluster instead of
// crowding block 0's warps (which timed slower at 24 waves), and a warp's
// entries are neighbours in the list, whose lane-indexed scratch words its
// stores then coalesce (one entry a warp on every SM, its lanes 128 entries
// apart, timed slower at two waves).
__device__ __forceinline__ int spread_rank(cooperative_groups::cluster_group& cluster, int sub,
                                           int per_warp) {
  return ((int)(threadIdx.x >> 5) * CLUSTER_BLOCKS + (int)cluster.block_rank()) * per_warp + sub;
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

// The fields of an account row the transfer ladder reads (id, user data,
// code and timestamp stay zero): 5 of its 8 16-byte pieces.
__device__ __forceinline__ Acct load_acct_ladder(const uint32_t* p) {
  Row r = {};
  const uint4* s = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int k = 1; k < 8; k++) {
    if (k == 5 || k == 6) continue;
    uint4 v = s[k];
    r.w[4 * k] = v.x;
    r.w[4 * k + 1] = v.y;
    r.w[4 * k + 2] = v.z;
    r.w[4 * k + 3] = v.w;
  }
  return unpack_account(r);
}

// models/ledger.py _fold_digits / _fold_digits_signed for one balance
// field: its four words `w` plus the eight 32-bit digit sums d0 (words
// 0-3 of the field's sums) and d1 (4-7); sets *bad on a carry out.
__device__ __forceinline__ uint4 fold_field(uint4 w, uint4 d0, uint4 d1, bool is_signed,
                                            bool* bad) {
  const uint32_t in[4] = {w.x, w.y, w.z, w.w};
  const uint32_t acc[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
  uint32_t out[4];
  if (is_signed) {
    long long carry = 0;
#pragma unroll
    for (int k = 0; k < 4; k++) {
      long long s_lo = (long long)(in[k] & 0xFFFFu) + (long long)(int32_t)acc[2 * k] + carry;
      carry = s_lo >> 16;
      long long s_hi = (long long)(in[k] >> 16) + (long long)(int32_t)acc[2 * k + 1] + carry;
      carry = s_hi >> 16;
      out[k] = (uint32_t)(s_lo & 0xFFFF) | ((uint32_t)(s_hi & 0xFFFF) << 16);
    }
    if (carry != 0) *bad = true;
  } else {
    uint32_t carry = 0;
#pragma unroll
    for (int k = 0; k < 4; k++) {
      uint32_t s_lo = (in[k] & 0xFFFFu) + acc[2 * k] + carry;
      carry = s_lo >> 16;
      uint32_t s_hi = (in[k] >> 16) + acc[2 * k + 1] + carry;
      carry = s_hi >> 16;
      out[k] = (s_lo & 0xFFFFu) | (s_hi << 16);
    }
    if (carry != 0) *bad = true;
  }
  return make_uint4(out[0], out[1], out[2], out[3]);
}

__device__ __forceinline__ uint4 shfl4(unsigned mask, uint4 v, int src) {
  return make_uint4(__shfl_sync(mask, v.x, src), __shfl_sync(mask, v.y, src),
                    __shfl_sync(mask, v.z, src), __shfl_sync(mask, v.w, src));
}

__device__ __forceinline__ u128 u128_of(uint4 v) {
  return mk128((uint64_t)v.x | ((uint64_t)v.y << 32), (uint64_t)v.z | ((uint64_t)v.w << 32));
}

// A row group: eight lanes of a warp move one 128-byte row, lane `sub`
// holding its 16-byte piece `sub` (words 4 sub .. 4 sub + 3); `mask` is the
// group's lanes and `lead` its first lane.
struct RowGroup {
  int sub, lead;
  unsigned mask;
};

__device__ __forceinline__ RowGroup row_group(int lane) {
  return RowGroup{lane & 7, lane & ~7, 0xFFu << (lane & ~7)};
}

// Phase (c) for the rows l0, l0 + step, ... (CLUSTER_IN_FLIGHT of them,
// those < 2B; row l is the account of event l % B's debit or credit side;
// with kList those < 2 list->cnt, the wave's rows): the carry fold of the
// slot's digit sums into the pre-batch row's balances, into new_rows[l].
// Returns FAULT_OVERFLOW or 0 in the group's lanes. Balance field f (dp,
// dpo, cp, cpo) is piece 1 + f; its digit sums are pieces 2f and 2f + 1 of
// the `bal_acc` row (signed where amounts were also subtracted).
template <class A, bool kList = false>
__device__ __forceinline__ uint32_t fold_rows(const A& a, int l0, int step, RowGroup g,
                                              bool is_signed, const LaneList* list = nullptr) {
  const int f = g.sub - 1;  // the field this lane folds, if 0 <= f < 4
  const bool balance = f >= 0 && f < 4;
  int64_t slot[CLUSTER_IN_FLIGHT];
  uint4 w[CLUSTER_IN_FLIGHT], c[CLUSTER_IN_FLIGHT];
#pragma unroll
  for (int u = 0; u < CLUSTER_IN_FLIGHT; u++) {
    int l = l0 + u * step;
    if constexpr (kList) {
      slot[u] = l < 2 * list->cnt ? __ldcg(a.slot2 + list->row(l, a.B)) : -1;
    } else {
      slot[u] = l < 2 * a.B ? __ldcg(a.slot2 + l) : -1;
    }
  }
#pragma unroll
  for (int u = 0; u < CLUSTER_IN_FLIGHT; u++) {
    if (slot[u] < 0) continue;
    w[u] = make_uint4(0u, 0u, 0u, 0u);
    if (balance) {
      w[u] = reinterpret_cast<const uint4*>(a.acct_rows + (size_t)slot[u] * ROW_WORDS)[g.sub];
    }
    c[u] = __ldcg(reinterpret_cast<const uint4*>(a.bal_acc + (size_t)slot[u] * ROW_WORDS) + g.sub);
  }
  bool bad = false;
#pragma unroll
  for (int u = 0; u < CLUSTER_IN_FLIGHT; u++) {
    if (slot[u] < 0) continue;  // the same in the group's lanes
    uint4 d0 = shfl4(g.mask, c[u], g.lead + ((2 * f) & 7));
    uint4 d1 = shfl4(g.mask, c[u], g.lead + ((2 * f + 1) & 7));
    uint4 v = w[u];
    if (balance) v = fold_field(v, d0, d1, is_signed, &bad);
    // codes 51/52 guard the combined pending+posted sums: dp + dpo in the
    // dp lane, cp + cpo in the cp lane
    uint4 next = shfl4(g.mask, v, g.lead + ((g.sub + 1) & 7));
    if ((g.sub == 1 || g.sub == 3) && sum_overflows(u128_of(v), u128_of(next))) bad = true;
    if (balance) {  // only the balances change
      reinterpret_cast<uint4*>(a.new_rows + (size_t)(l0 + u * step) * ROW_WORDS)[g.sub] = v;
    }
  }
  return bad ? FAULT_OVERFLOW : 0u;
}

// Phase (e), accounts: the rows l0, l0 + step, ... of 2B (with kList of
// the wave's 2 list->cnt, as fold_rows numbers them) (their balance pieces
// 1-4: nothing else of an account row changes) if `proceed`, and their
// `bal_acc` rows back to zero in any case.
template <class A, bool kList = false>
__device__ __forceinline__ void apply_rows(const A& a, int l0, int step, RowGroup g,
                                           bool proceed, const LaneList* list = nullptr) {
  const bool balance = g.sub >= 1 && g.sub <= 4;
  int64_t slot[CLUSTER_IN_FLIGHT];
  uint4 v[CLUSTER_IN_FLIGHT];
#pragma unroll
  for (int u = 0; u < CLUSTER_IN_FLIGHT; u++) {
    int l = l0 + u * step;
    if constexpr (kList) {
      const bool in = l < 2 * list->cnt;
      slot[u] = in ? __ldcg(a.slot2 + list->row(l, a.B)) : -1;
      if (in && proceed && balance) {
        v[u] = __ldcg(reinterpret_cast<const uint4*>(a.new_rows + (size_t)l * ROW_WORDS) + g.sub);
      }
    } else {
      slot[u] = l < 2 * a.B ? __ldcg(a.slot2 + l) : -1;
      if (l < 2 * a.B && proceed && balance) {
        v[u] = __ldcg(reinterpret_cast<const uint4*>(a.new_rows + (size_t)l * ROW_WORDS) + g.sub);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < CLUSTER_IN_FLIGHT; u++) {
    if (slot[u] < 0) continue;
    if (proceed && balance) {
      reinterpret_cast<uint4*>(a.acct_rows + (size_t)slot[u] * ROW_WORDS)[g.sub] = v[u];
    }
    reinterpret_cast<uint4*>(a.bal_acc + (size_t)slot[u] * ROW_WORDS)[g.sub] =
        make_uint4(0u, 0u, 0u, 0u);
  }
}

// One round's select over the cluster's lanes (with kList the list's),
// the round's flag and the cluster barrier after them; true if some lane of
// the cluster contends.
template <bool kPastL1, bool kList = false, class Active>
__device__ __forceinline__ bool cluster_select(cooperative_groups::cluster_group& cluster,
                                               uint32_t* want, uint32_t epoch, int round,
                                               const uint32_t* keys, int key_stride,
                                               const Active& active, int B,
                                               const uint32_t* rows, const uint32_t* claim,
                                               int cap_log2, int64_t* slot,
                                               const ClaimScratch& sc, const int32_t* shard,
                                               const LaneList* list = nullptr) {
  const int lane = threadIdx.x & 31;
  bool wants = false;
  if constexpr (kList) {
    for (int k = list->first; k < list->cnt; k += (int)cluster.num_threads()) {
      wants |= claim_select_lane<kPastL1>(list->lane(k), keys, key_stride, active, rows, claim,
                                          cap_log2, slot, sc, round, shard);
    }
  } else {
    for (int i = (int)cluster.thread_rank(); i < B; i += (int)cluster.num_threads()) {
      wants |= claim_select_lane<kPastL1>(i, keys, key_stride, active, rows, claim, cap_log2,
                                          slot, sc, round, shard);
    }
  }
  if (__any_sync(FULL_MASK, wants) && lane == 0) atomicMax(want + round, epoch);
  cluster.sync();
  return __shfl_sync(FULL_MASK, lane == 0 ? want[round] : 0u, 0) == epoch;
}

// The claim rounds of claim.cuh for lanes i < B, strided over the cluster,
// with a cluster barrier for each barrier of the rule. `want` is
// CLAIM_ROUNDS words of one block's shared memory (reached through
// distributed shared memory, zeroed at the launch's start): round r's word
// is raised to `epoch` where some lane contends in it. A round after one
// in which no lane contended would want nothing either (the column and the
// tables are as it found them), so that ends them. `epoch` tells a pass of
// the rounds from the launch's earlier ones (1 for a one-pass kernel; K9
// and K10's reload pass chunk + 1), so no word needs clearing between
// passes. With `select0` the rounds start at round 0; else the caller ran
// round 0 (select and atomicMin: K3, K11tf and the account commits do in
// validation, K10's reload in its probes, where the column is all free),
// raised want[0] to `epoch` and passed the cluster barrier after it.
// Then every lane settles and releases; returns FAULT_CLAIM if one of this
// thread's active lanes won no slot. With kList the rounds run over the
// lanes of `list` (K12's wave; its caller ran round 0 in validation), each
// entry handled by one thread (from list->first) in every step.
template <bool kPastL1, bool kList = false, class Active>
__device__ __forceinline__ uint32_t cluster_claims(cooperative_groups::cluster_group& cluster,
                                                   uint32_t* want, uint32_t epoch, bool select0,
                                                   const uint32_t* keys, int key_stride,
                                                   const Active& active, int B,
                                                   const uint32_t* rows, uint32_t* claim,
                                                   int cap_log2, int64_t* slot,
                                                   const ClaimScratch& sc, const int32_t* shard,
                                                   const LaneList* list = nullptr) {
  if constexpr (kList) {
    const int t = list->first, stride = (int)cluster.num_threads();
    bool more = __shfl_sync(FULL_MASK, (threadIdx.x & 31) == 0 ? want[0] : 0u, 0) == epoch;
    for (int round = 1; round < CLAIM_ROUNDS && more; round++) {
      more = cluster_select<kPastL1, true>(cluster, want, epoch, round, keys, key_stride, active,
                                           B, rows, claim, cap_log2, slot, sc, shard, list);
      if (!more) break;
      for (int k = t; k < list->cnt; k += stride) claim_min_lane(list->lane(k), claim, sc);
      cluster.sync();
    }
    uint32_t bad = 0u;
    for (int k = t; k < list->cnt; k += stride) {
      if (claim_finish_lane(list->lane(k), active, claim, slot, sc)) bad = FAULT_CLAIM;
    }
    return bad;
  } else {
    const int t = (int)cluster.thread_rank(), stride = (int)cluster.num_threads();
    bool more;
    if (select0) {
      more = cluster_select<kPastL1>(cluster, want, epoch, 0, keys, key_stride, active, B, rows,
                                     claim, cap_log2, slot, sc, shard);
      if (more) {
        for (int i = t; i < B; i += stride) claim_min_lane(i, claim, sc);
        cluster.sync();
      }
    } else {  // the flag is read once a warp
      more = __shfl_sync(FULL_MASK, (threadIdx.x & 31) == 0 ? want[0] : 0u, 0) == epoch;
    }
    for (int round = 1; round < CLAIM_ROUNDS && more; round++) {
      more = cluster_select<kPastL1>(cluster, want, epoch, round, keys, key_stride, active, B,
                                     rows, claim, cap_log2, slot, sc, shard);
      if (!more) break;
      for (int i = t; i < B; i += stride) claim_min_lane(i, claim, sc);
      cluster.sync();
    }
    uint32_t bad = 0u;
    for (int i = t; i < B; i += stride) {
      if (claim_finish_lane(i, active, claim, slot, sc)) bad = FAULT_CLAIM;
    }
    return bad;
  }
}

// A launch of `kernel(a)` on one cluster of CLUSTER_BLOCKS blocks of
// `threads` threads. The cluster is non-portable (16 blocks), which the
// caller allows once for its kernel (cudaFuncSetAttribute); if that
// failed, the launch fails and says so.
template <class A>
static void launch_cluster(void (*kernel)(A), const A& a, cudaStream_t stream,
                           int threads = CLUSTER_THREADS) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CLUSTER_BLOCKS, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER_BLOCKS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, kernel, a);
}
