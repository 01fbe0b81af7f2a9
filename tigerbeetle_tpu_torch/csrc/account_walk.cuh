// The serial tier of create_accounts as a parallel plan and a one-warp walk:
// K2 serial (commit_accounts.cu, one table) and K11as
// (mesh_commit_accounts.cu, the sharded ledger).
//
// The JAX scans (models/ledger.py `_serial_accounts`, parallel/mesh.py
// `_commit_accounts_serial`) commit the events one by one: event i
// validates against the table as events 0 .. i - 1 left it, and a broken
// linked chain tombstones the chain's inserts. One thread doing that walks
// a chain of dependent device-memory trips an event: the batch row, a
// lookup over up to 64 probe positions, the found row, a second probe for
// the free slot, the store. But a create_account reads and writes only its
// own id's row, so the part that depends on the order is small: whether a
// row the batch wrote so far lies in the event's probe window at or before
// the position its answers depend on. So:
//
// 1. Plan (one warp an event, the whole batch at once, against the table
//    as it was before the batch; nothing is written): the id's 64-position
//    window in one trip, decided with ballots (warp_window.cuh); `stop`, the
//    last window position the lookup and free-slot answers depend on (the
//    hit, else the first empty slot, else the last probe); the first free
//    position and whether there is one; whether the lookup resolved; the
//    code below the chain's rungs, validate_create_account(0, e, ex, found),
//    and the same with no row found; the flags; the owner shard.
// 2. Walk (one warp, the events in order, 32 at a time: lane k holds event
//    32 g + k). A bitmap in shared memory holds the rows the batch has
//    written, inserts and rollback tombstones (at most 2^20 bits, indexed by
//    the global row modulo their number: a bit another row set only costs a
//    re-probe); a write table holds, by row, the lanes of the group whose
//    plan inserts there. Each lane tests its event's window positions
//    0 .. stop against both (a bit, or an earlier lane's planned insert). If
//    neither is set, nothing the batch wrote before the event lies where its
//    answers were read, so the plan is what a lookup at this point of the
//    walk gives, and outside a linked chain the event's code is the plan's
//    (or 3, timestamp set) whatever came before it: the lanes decide those
//    events at once. Only the events that are stale, linked or in a chain go
//    through the serial path, in order: a stale event's window is loaded
//    again from device memory (the group's pending stores before it made
//    first) and its code decided again; then the chain's rungs (2 open at
//    the end, 1 broken, 3 timestamp set), and on a broken chain the
//    tombstones of its undo slots. A re-probe or a rollback writes where the
//    plan did not say, so the group's stores up to that event are made and
//    the events after it are tested again. At the group's end each lane
//    stores its event's row (or tombstone) and sets its bit, then its code
//    and undo slot. Plan entries and batch rows come into shared memory 32
//    events at a time by cp.async, two groups ahead of the walk.
//
// The JAX scan's quirks are kept: an ok event whose free-slot probe does not
// resolve writes nothing yet counts as applied, and a rollback tombstones
// the slot that probe returned (its last probe); the entry gate charges all
// n events (on the sharded ledger, against every shard) and a tripped gate
// makes n = 0; results past n are 0; `used` counts every applied insert on
// its owner, rolled back or not; commit_ts is the last applied event's
// timestamp.
//
// Bound on an H100: the bytes (the batch rows, a sector a probe, the rows
// written), or, where more, one shared-memory round trip for each event that
// must wait for an earlier one: an event of a linked chain, or one whose
// window holds a row the batch wrote before it. Every other event's answer
// is the table's as it was before the batch, so the events do not form one
// dependent chain and a round trip an event is not a floor here.
//
// Two launches a call in stream order and no host sync: the plan (which also
// zeroes the results) and the walk. Both are templates over the lookup
// policy P (owner.cuh's AcctOneTable or AcctShards): the owner shard of a
// key, the first row of a shard's table, and the shard count for the entry
// gate and the per-shard insert counts:
//   int n_shards; int owner(Key4); int64_t base(int shard, int log2).
#pragma once
#include <cuda_runtime.h>

#include "owner.cuh"
#include "validate.cuh"
#include "warp_window.cuh"

#define AW_WALK_THREADS 256  // all of them clear the bitmap and write table; warp 0 walks
#define AW_BITS_LOG2 20      // the bitmap's bits at most: 128 KB of shared memory
#define AW_GROUP 32          // events a stage holds: one a lane
#define AW_STAGES 3          // the group walked and two in flight
#define AW_WTAB 16384        // the group's write table: a lane mask by row mod AW_WTAB
enum { AW_NONE, AW_ROW, AW_TOMB };  // a lane's pending store

// An entry of the plan: the probe (base, step) on the owner shard's table,
// the owner, and in `bits`:
#define AP_CODE(b) ((b) & 31u)          // the code below the rungs
#define AP_NONE(b) (((b) >> 5) & 31u)   // the code below the rungs with no row found
#define AP_STOP(b) (((b) >> 10) & 63u)  // the last position the answers depend on
#define AP_FREE(b) (((b) >> 16) & 63u)  // the first free position, else the last probe
#define AP_RESOLVED (1u << 22)          // the lookup resolved
#define AP_FREE_OK (1u << 23)           // the window has a free slot
#define AP_LINKED (1u << 24)            // the event is linked
#define AP_TS_SET (1u << 25)            // its timestamp field is not zero

struct __align__(16) AcctPlan {
  uint32_t base, step, owner, bits;
};

struct AcctWalkHdr {
  ull reprobes;  // events the walk resolved again (the last call's)
};

struct AcctWalkScratch {
  AcctWalkHdr* hdr;
  AcctPlan* plan;  // [B]
  int64_t* undo;   // [B] each event's free slot (global row)
};

static AcctWalkScratch acct_walk_carve(char* scratch, int B, size_t* size) {
  Carver c{scratch, 0};
  AcctWalkScratch s;
  s.hdr = c.take<AcctWalkHdr>(1);
  s.plan = c.take<AcctPlan>(B);
  s.undo = c.take<int64_t>(B);
  *size = c.off + 256;
  return s;
}

struct AcctWalkArgs {
  uint32_t* rows;
  int log2, bits_log2;
  ull* commit_ts;
  ull* count;
  ull* used;  // [n_shards]
  uint32_t* fault;
  const uint32_t* batch;
  int B, n;
  ull timestamp;
  int32_t* results;
  AcctWalkScratch sc;
};

// One warp an event: results zeroed for every lane of the batch, a plan
// entry for every event below n.
template <class P>
__global__ void __launch_bounds__(LANES_PER_BLOCK) acct_plan(AcctWalkArgs a, P pol) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < a.B) a.results[t] = 0;
  const int i = t >> 5, lane = threadIdx.x & 31;
  if (i >= a.n) return;  // whole warps
  const uint32_t* brow = a.batch + (size_t)i * ROW_WORDS;
  const Key4 key = key_at(brow);
  const int owner = pol.owner(key);
  const WalkWin w = win_load(a.rows, a.log2, pol.base(owner, a.log2), key, lane);
  const WinIdx x = win_index(w, key);
  if (lane != 0) return;
  const bool found = x.h < x.e;
  const bool resolved = found || x.e < WINDOW_SCALAR;
  const int stop = found ? x.h : min(x.e, WINDOW_SCALAR - 1);
  const int free_pos = min(x.f, WINDOW_SCALAR - 1);
  const Acct e = unpack_account(load_row(brow));
  const Acct none = {};
  const uint32_t code_none = validate_create_account(0u, e, none, false);
  uint32_t code = code_none;
  if (found) {
    const uint32_t* ex = a.rows + (size_t)(w.sb + w.pr.at(x.h)) * ROW_WORDS;
    code = validate_create_account(0u, e, unpack_account(load_row(ex)), true);
  }
  AcctPlan p;
  p.base = w.pr.base;
  p.step = w.pr.step;
  p.owner = (uint32_t)owner;
  p.bits = code | (code_none << 5) | ((uint32_t)stop << 10) | ((uint32_t)free_pos << 16) |
           (resolved ? AP_RESOLVED : 0u) | (x.f < WINDOW_SCALAR ? AP_FREE_OK : 0u) |
           ((e.flags & A_LINKED) ? AP_LINKED : 0u) | (e.ts != 0 ? AP_TS_SET : 0u);
  a.sc.plan[i] = p;
}

struct __align__(16) AcctStage {
  AcctPlan plan[AW_GROUP];
  uint32_t row[AW_GROUP][ROW_WORDS];
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(smem)),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Group g's plan entries and batch rows into stage `st` (nothing past n).
__device__ __forceinline__ void aw_fetch(const AcctWalkArgs& a, AcctStage* st, int g, int n,
                                         int lane) {
  const int i0 = g * AW_GROUP;
  if (i0 >= n) return;
  const int kn = min(AW_GROUP, n - i0);
  if (lane < kn) cp_async16(&st->plan[lane], &a.sc.plan[i0 + lane]);
  for (int c = lane; c < kn * 8; c += 32) {
    cp_async16(&st->row[c >> 3][(c & 7) * 4],
               a.batch + (size_t)(i0 + (c >> 3)) * ROW_WORDS + (c & 7) * 4);
  }
}

__device__ __forceinline__ bool aw_seen(const uint32_t* bitmap, uint32_t bmask, int64_t row) {
  const uint32_t b = (uint32_t)row & bmask;
  return (bitmap[b >> 5] >> (b & 31u)) & 1u;
}

__device__ __forceinline__ void aw_mark(uint32_t* bitmap, uint32_t bmask, int64_t row) {
  const uint32_t b = (uint32_t)row & bmask;
  atomicOr(&bitmap[b >> 5], 1u << (b & 31u));
}

// Whether a write of the batch may lie at window positions 0 .. stop of the
// probe (base, step) on the table at row sb: a bit of `bitmap` (the rows
// written and flushed) or a planned write of an earlier event of the group
// (`wtab`: the group's lanes whose planned insert has that row, keyed by the
// row modulo AW_WTAB).
__device__ __forceinline__ bool aw_stale(const uint32_t* bitmap, uint32_t bmask,
                                         const uint32_t* wtab, int64_t sb, uint32_t base,
                                         uint32_t step, uint32_t mask, int stop, int lane) {
  for (int j = 0; j <= stop; j++) {
    const int64_t row = sb + ((base + (uint32_t)j * step) & mask);
    if (aw_seen(bitmap, bmask, row)) return true;
    if (wtab[(uint32_t)row & (AW_WTAB - 1)] & ((1u << lane) - 1u)) return true;
  }
  return false;
}

// The walker warp: the events in groups of 32, lane k holding event
// 32 g + k. A group is decided in parallel from its plan entries: each
// event's code (the plan's, or 3 for a timestamp set), its insert (a
// pending row store), and whether a write of the batch may lie in its window
// at or before stop (`aw_stale`). Only the events that are stale, linked or
// in a chain go through the walk's serial path, in order: re-probe, chain
// rungs, rollback. A re-probe or a rollback writes where the plan did not
// say, so the group's pending stores up to that event are made and the
// events after it are tested again. At the group's end every pending row or
// tombstone is stored (lane k its own) and its bit set, then the codes, the
// undo slots and the counters.
template <class P>
__device__ void acct_walk_warp(const AcctWalkArgs& a, const P& pol, AcctStage* stage,
                               uint32_t* bitmap, uint32_t* wtab, unsigned* applied, int n,
                               uint32_t fault0, int lane) {
  const uint32_t mask = (1u << a.log2) - 1u;
  const uint32_t bmask = (1u << a.bits_log2) - 1u;
  for (int g = 0; g < AW_STAGES - 1; g++) {
    aw_fetch(a, stage + g, g, n, lane);
    cp_async_commit();
  }
  int chain_start = -1;
  bool broken = false, probe_bad = false;
  ull cts = *a.commit_ts, ok_n = 0, reprobes = 0;
  for (int g = 0; g * AW_GROUP < n; g++) {
    aw_fetch(a, stage + (g + AW_STAGES - 1) % AW_STAGES, g + AW_STAGES - 1, n, lane);
    cp_async_commit();
    cp_async_wait<AW_STAGES - 1>();
    __syncwarp();
    const AcctStage& S = stage[g % AW_STAGES];
    const int g0 = g * AW_GROUP;
    const int kn = min(AW_GROUP, n - g0);
    const bool valid = lane < kn;
    const AcctPlan p = valid ? S.plan[lane] : AcctPlan{0u, 1u, 0u, 0u};
    const uint32_t pb = p.bits;
    const int64_t sb = pol.base((int)p.owner, a.log2);
    bool resolved = (pb & AP_RESOLVED) != 0u, free_ok = (pb & AP_FREE_OK) != 0u;
    int64_t slot = sb + ((p.base + AP_FREE(pb) * p.step) & mask);
    uint32_t r = (pb & AP_TS_SET) ? 3u : AP_CODE(pb);  // outside a chain
    bool was_ok = valid && r == 0u;
    int pending = was_ok && free_ok ? AW_ROW : AW_NONE;
    const int64_t planned = pending == AW_ROW ? slot : -1;
    if (planned >= 0) atomicOr(&wtab[(uint32_t)planned & (AW_WTAB - 1)], 1u << lane);
    __syncwarp();

    // lanes `mine` store their pending row or tombstone and set its bit
    auto flush = [&](bool mine) {
      if (mine && pending != AW_NONE) {
        uint4* d = reinterpret_cast<uint4*>(a.rows + (size_t)slot * ROW_WORDS);
        const uint4* s = reinterpret_cast<const uint4*>(S.row[lane]);
        const ull ts = a.timestamp - (ull)n + (ull)(g0 + lane) + 1ull;
#pragma unroll
        for (int q = 0; q < ROW_WORDS / 4; q++) {
          uint4 v = pending == AW_TOMB ? make_uint4(TOMB_WORD, TOMB_WORD, TOMB_WORD, TOMB_WORD)
                                       : s[q];
          if (pending == AW_ROW && q == ROW_WORDS / 4 - 1) {
            v.z = (uint32_t)ts;
            v.w = (uint32_t)(ts >> 32);
          }
          d[q] = v;
        }
        aw_mark(bitmap, bmask, slot);
        pending = AW_NONE;
      }
      __syncwarp();
    };

    bool stale =
        valid && aw_stale(bitmap, bmask, wtab, sb, p.base, p.step, mask, (int)AP_STOP(pb), lane);
    const unsigned linked = __ballot_sync(WALK_FULL, valid && (pb & AP_LINKED));
    unsigned todo = __ballot_sync(WALK_FULL, stale) | linked | (linked << 1) |
                    (chain_start >= 0 ? 1u : 0u);
    todo &= __ballot_sync(WALK_FULL, valid);
    while (todo) {  // the serial path, in order
      const int k = __ffs(todo) - 1;
      const int i = g0 + k;
      const uint32_t kpb = __shfl_sync(WALK_FULL, pb, k);
      uint32_t code = AP_CODE(kpb);
      bool deviate = false;
      if (__shfl_sync(WALK_FULL, stale, k)) {  // resolve it on the table as it stands
        reprobes++;
        flush(lane < k);
        __threadfence_block();
        __syncwarp();
        const uint32_t* row = S.row[k];
        const Key4 key{{row[0], row[1], row[2], row[3]}};
        const int64_t ksb = pol.base((int)__shfl_sync(WALK_FULL, p.owner, k), a.log2);
        const WalkWin w = win_load<true>(a.rows, a.log2, ksb, key, lane);
        const WinIdx x = win_index(w, key);
        const bool found = x.h < x.e;
        code = AP_NONE(kpb);
        if (found && code == 0u) {  // exists: compare with the row found (lane w has word w)
          const uint32_t ex_w = __ldcg(a.rows + (size_t)(ksb + w.pr.at(x.h)) * ROW_WORDS + lane);
          Row ex;
#pragma unroll
          for (int q = 0; q < ROW_WORDS; q++) ex.w[q] = __shfl_sync(WALK_FULL, ex_w, q);
          code = validate_create_account(0u, unpack_account(load_row(row)),
                                         unpack_account(ex), true);
        }
        if (lane == k) {
          resolved = found || x.e < WINDOW_SCALAR;
          free_ok = x.f < WINDOW_SCALAR;
          slot = ksb + w.pr.at(min(x.f, WINDOW_SCALAR - 1));
        }
        deviate = true;
      }
      const bool klinked = (kpb & AP_LINKED) != 0u;
      if (klinked && chain_start < 0) chain_start = i;
      const bool in_chain = chain_start >= 0;
      const uint32_t r0 = (in_chain && i == n - 1 && klinked) ? 2u
                          : broken                           ? 1u
                          : (kpb & AP_TS_SET)                ? 3u
                                                             : 0u;
      const uint32_t kr = r0 != 0u ? r0 : code;
      if (lane == k) {
        r = kr;
        was_ok = kr == 0u;
        pending = was_ok && free_ok ? AW_ROW : AW_NONE;
      }
      if (kr != 0u && in_chain && !broken) {  // roll back [chain_start, i): all of it applied
        for (int kb = chain_start & ~31; kb < g0; kb += 32) {  // in earlier groups
          const int kk = kb + lane;  // the lane that stored its undo slot and its code
          if (kk < chain_start || kk >= g0) continue;
          const int64_t s = a.sc.undo[kk];
          uint4* d = reinterpret_cast<uint4*>(a.rows + (size_t)s * ROW_WORDS);
#pragma unroll
          for (int q = 0; q < ROW_WORDS / 4; q++)
            d[q] = make_uint4(TOMB_WORD, TOMB_WORD, TOMB_WORD, TOMB_WORD);
          aw_mark(bitmap, bmask, s);
          a.results[kk] = 1;
        }
        if (chain_start < g0) ok_n -= (ull)(g0 - chain_start);
        if (lane < k && g0 + lane >= chain_start) {  // in this group
          pending = AW_TOMB;
          r = 1u;
        }
        broken = true;
        deviate = true;
      }
      if (in_chain && (!klinked || kr == 2u)) {
        chain_start = -1;
        broken = false;
      }
      todo &= ~((2u << k) - 1u);
      if (deviate) {  // its writes are not the plan's: store up to it, test the rest again
        flush(lane <= k);
        stale = valid && lane > k &&
                aw_stale(bitmap, bmask, wtab, sb, p.base, p.step, mask, (int)AP_STOP(pb), lane);
        todo |= __ballot_sync(WALK_FULL, stale);
      }
    }
    flush(true);
    if (valid) {
      a.results[g0 + lane] = (int32_t)r;
      a.sc.undo[g0 + lane] = slot;
    }
    if (planned >= 0) wtab[(uint32_t)planned & (AW_WTAB - 1)] = 0u;
    ok_n += __popc(__ballot_sync(WALK_FULL, valid && r == 0u));
    const unsigned okm = __ballot_sync(WALK_FULL, was_ok);
    if (okm) cts = a.timestamp - (ull)n + (ull)(g0 + 31 - __clz(okm)) + 1ull;
    if (pol.n_shards == 1) {
      if (lane == 0) applied[0] += __popc(okm);
    } else {
      const unsigned peers = __match_any_sync(WALK_FULL, was_ok ? (int)p.owner : -1);
      if (was_ok && lane == __ffs(peers) - 1) atomicAdd(&applied[p.owner], (unsigned)__popc(peers));
    }
    probe_bad = probe_bad || __any_sync(WALK_FULL, valid && (!resolved || (was_ok && !free_ok)));
    __syncwarp();
  }
  cp_async_wait<0>();
  if (lane == 0) {
    *a.commit_ts = cts;
    *a.count += ok_n;
    *a.fault = fault0 | (probe_bad ? FAULT_SERIAL : 0u);
    a.sc.hdr->reprobes = reprobes;
  }
  __syncwarp();
  for (int s = lane; s < pol.n_shards; s += 32) a.used[s] += applied[s];
}

// One block: every thread clears the bitmap and the group's write table,
// thread 0 decides the entry gate, warp 0 walks.
template <class P>
__global__ void __launch_bounds__(AW_WALK_THREADS, 1) acct_walk(AcctWalkArgs a, P pol) {
  extern __shared__ __align__(16) unsigned char aw_smem[];
  AcctStage* stage = reinterpret_cast<AcctStage*>(aw_smem);
  uint32_t* wtab = reinterpret_cast<uint32_t*>(aw_smem + AW_STAGES * sizeof(AcctStage));
  uint32_t* bitmap = wtab + AW_WTAB;
  __shared__ int s_n;
  __shared__ uint32_t s_fault0;
  __shared__ unsigned s_applied[MESH_SHARDS_MAX];
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int k = threadIdx.x; k < AW_WTAB / 4 + (1 << (a.bits_log2 - 7)); k += blockDim.x)
    reinterpret_cast<uint4*>(wtab)[k] = zero;
  for (int s = threadIdx.x; s < MESH_SHARDS_MAX; s += blockDim.x) s_applied[s] = 0u;
  if (threadIdx.x == 0) {
    uint32_t f0 = *a.fault;
    for (int s = 0; s < pol.n_shards; s++) {
      if (a.used[s] + (ull)a.n > (1ull << a.log2) / 2) f0 |= FAULT_CAPACITY;
    }
    s_fault0 = f0;
    s_n = f0 ? 0 : a.n;
  }
  __syncthreads();
  if (threadIdx.x < 32)
    acct_walk_warp(a, pol, stage, bitmap, wtab, s_applied, s_n, s_fault0, threadIdx.x);
}

// The commit of `a.batch` (lanes < a.n): the plan, then the walk.
template <class P>
static int acct_walk_launch(AcctWalkArgs a, P pol, cudaStream_t stream) {
  const uint64_t rows = (uint64_t)pol.n_shards * ((1ull << a.log2) + 1);
  a.bits_log2 = 7;  // 16 bytes at least
  while (a.bits_log2 < AW_BITS_LOG2 && (1ull << a.bits_log2) < rows) a.bits_log2++;
  const size_t fixed = AW_STAGES * sizeof(AcctStage) + AW_WTAB * sizeof(uint32_t);
  const size_t smem = fixed + ((size_t)1 << a.bits_log2) / 8;
  cudaError_t err = cudaFuncSetAttribute(acct_walk<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)(fixed + ((size_t)1 << AW_BITS_LOG2) / 8));
  if (err != cudaSuccess) return (int)err;
  const long long lanes = (long long)a.n * 32 > a.B ? (long long)a.n * 32 : (long long)a.B;
  acct_plan<P><<<grid_for(lanes), LANES_PER_BLOCK, 0, stream>>>(a, pol);
  acct_walk<P><<<1, AW_WALK_THREADS, smem, stream>>>(a, pol);
  return (int)cudaGetLastError();
}
