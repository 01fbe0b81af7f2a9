// K10, the spill cycle's scan: the cycle head and the cold/hot split.
//
// Replaces tigerbeetle_tpu/models/spill.py SpillKernels._ts_occ,
// _cycle_head and _split_idx (:235-269), called by SpillManager._cycle
// (:827-849).
//
// - tb_spill_head: [live count, fault] of the transfer table, the two words
//   the cycle reads back before it decides the split. Live = key neither
//   empty nor tombstone, over the slots before the dump row.
// - tb_spill_split: the n_cold-th smallest (0-based) of the masked per-slot
//   timestamps ts_m (words 30-31 as u64; u64 max for dead slots and the
//   dump row) is the watermark; cold = live and ts_m < watermark, hot = live
//   and not; each list is the slot indices in ascending order, padded with
//   the dump slot to (1 << cap_log2) + CHUNK entries. With n_cold >= live
//   the watermark is u64 max and every live row is cold but those whose
//   timestamp is u64 max. All compares are unsigned 64-bit, as the JAX
//   program's uint64. Every step stays on the card: the host passes n_cold
//   and reads nothing back.
//
// Bound on an H100: bytes. Each slot's key (words 0-3) decides liveness and
// a live slot's timestamp (words 30-31) lies in the row's other 64-byte
// half: a 32-byte sector a slot and one more a live slot, and the two lists
// written once. The card fetches 64 bytes for such a sector (chase.cu's
// sector probe), so the table pass's floor is one 64-byte fetch a slot and
// one more a live slot.
//
// Design: no sort (the JAX program sorts the whole table) and one pass over
// the table; every later pass reads only the live slots, compacted.
//   1. split_init (one block): clears the select's words, its histograms
//      and both look-back states (tile counters and status words).
//   2. split_scan, one pass over the table: persistent blocks take tiles of
//      SPLIT_TILE slots in order (lookback.cuh); each thread issues the key
//      loads of its slots, then the timestamp loads of its live ones; warp
//      ballots and decoupled look-back place the live slots, in slot order,
//      in a compact list (slot, timestamp); the live count and the
//      timestamps' min and max go to the select's words by one global
//      atomic each a block (u64 atomicMin / atomicMax).
//   3. split_select, one cooperative launch (every block resident, so a
//      grid-wide barrier is safe): the bin [base, base + 2^shift) starts as
//      [min, max]; each pass histograms the live timestamps in it into
//      SEL_BINS bins of 2^(shift - SEL_BITS) values (shared-memory bins,
//      then one global atomic a nonzero bin a block), and after the grid's
//      barrier every block picks alike the bin that holds the rank and
//      narrows to it, until the bin is one value wide: the watermark, in
//      ceil(log2(max - min + 1) / SEL_BITS) passes over the live list.
//      Exact for any data: duplicates, all-equal timestamps (no pass),
//      far-apart clusters (a few more passes) and u64 max among the live
//      ones. With n_cold >= live the watermark is u64 max at once.
//   4. split_part, one pass over the live list: persistent blocks take
//      tiles of PART_TILE entries in order; an entry is cold if its
//      timestamp is below the watermark; its cold rank c (cold entries
//      before it) comes from warp ballots and decoupled look-back of the
//      cold count, and then it goes to cold[c] or to hot[j - c] (j its
//      index in the list): a stable partition, both lists in slot order.
//      Once the last tile has published its count, every block writes its
//      share of both lists' padding with the dump slot.
// At the cycle's load limit the live list holds half the slots, at 2^24
// with the main path's state about a fifth. Each look-back state has one
// status word a tile for one count (the live slots in the scan, the cold
// entries in the partition: a hot entry's place follows from it), in
// lookback.cuh's format; split_init zeroes the words every call, so every
// call uses epoch 1 and no word left by an earlier call can read as ready.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "hash.cuh"
#include "lookback.cuh"

namespace cg = cooperative_groups;

#define SPILL_CHUNK 8192
#define SEL_BLOCKS (132 * 8)  // the head's grid
#define HEAD_THREADS 256
#define SPLIT_THREADS 256
#define SPLIT_WARPS (SPLIT_THREADS / 32)
#define SPLIT_ITEMS 8                               // table slots a thread a tile
#define SPLIT_TILE (SPLIT_THREADS * SPLIT_ITEMS)    // table slots a tile of the scan
#define PART_ITEMS 16                               // list entries a thread a tile
#define PART_TILE (SPLIT_THREADS * PART_ITEMS)      // list entries a tile of the partition
#define SEL_THREADS 1024
#define SEL_WARPS (SEL_THREADS / 32)
#define SEL_BITS 12
#define SEL_BINS (1 << SEL_BITS)
#define INIT_THREADS 1024

// ---------------------------------------------------------------- head

__global__ void __launch_bounds__(HEAD_THREADS)
    spill_head_kernel(const uint32_t* __restrict__ rows, long long slots,
                      const uint32_t* __restrict__ fault, uint32_t* __restrict__ out) {
  __shared__ int buf[HEAD_THREADS / 32];
  int live = 0;
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < slots; i += stride) {
    Key4 k = key_at(rows + i * ROW_WORDS);
    live += !(key_empty(k) || key_tomb(k));
  }
  live = __reduce_add_sync(0xFFFFFFFFu, live);
  if ((threadIdx.x & 31) == 0) buf[threadIdx.x >> 5] = live;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int w = 0; w < HEAD_THREADS / 32; w++) s += buf[w];
    if (s) atomicAdd(out, (uint32_t)s);
    if (blockIdx.x == 0) out[1] = *fault;
  }
}

// rows: the transfer table ((1 << cap_log2) + 1 rows); fault: the sticky
// fault word; out: u32 [2], zeroed by the caller.
extern "C" int tb_spill_head(const uint32_t* rows, int cap_log2, const uint32_t* fault,
                             uint32_t* out, cudaStream_t stream) {
  spill_head_kernel<<<SEL_BLOCKS, HEAD_THREADS, 0, stream>>>(rows, 1ll << cap_log2, fault, out);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- split

// The select's words.
struct SelState {
  ull lo, hi;      // min and max of the live timestamps
  unsigned live;   // live slots
  unsigned done;   // 1 once `watermark` is exact
  ull watermark;
};

struct SplitArgs {
  const uint32_t* rows;
  long long n;     // slots, the dump row included
  long long dump;  // the dump row's index
  ull n_cold;
  int32_t* cold;
  int32_t* hot;
  long long size;  // entries of each list
  // scratch
  SelState* sel;
  unsigned* hist;      // [3][SEL_BINS] the select's passes, in turn
  LookbackState scan;  // tiles of the table
  LookbackState part;  // tiles of the live list
  long long scan_tiles, part_tiles_max;
  int32_t* live_slot;  // [n] the live slots in slot order ...
  ull* live_ts;        // [n] ... and their timestamps
};

static long long split_scan_tiles(long long n) { return (n + SPLIT_TILE - 1) / SPLIT_TILE; }
static long long split_part_tiles(long long n) { return (n + PART_TILE - 1) / PART_TILE; }

static SplitArgs carve(char* scratch, long long n, size_t* size) {
  SplitArgs a{};
  Carver c{scratch, 0};
  a.scan_tiles = split_scan_tiles(n);
  a.part_tiles_max = split_part_tiles(n);
  a.sel = c.take<SelState>(1);
  a.hist = c.take<unsigned>(3 * SEL_BINS);
  a.scan = lookback_carve(c.take<char>(lookback_bytes(a.scan_tiles)));
  a.part = lookback_carve(c.take<char>(lookback_bytes(a.part_tiles_max)));
  a.live_slot = c.take<int32_t>(n);
  a.live_ts = c.take<ull>(n);
  *size = c.off + 256;
  return a;
}

extern "C" size_t tb_spill_split_scratch(int cap_log2) {
  size_t size;
  carve(nullptr, (1ll << cap_log2) + 1, &size);
  return size;
}

__device__ __forceinline__ void lb_clear(LookbackState st, long long tiles, int t, int nt) {
  if (t < 2) st.ctr[t] = 0u;
  for (long long i = t; i < tiles; i += nt) st.status[i] = 0ull;
}

// 1. The select's words, the histogram and both look-back states.
__global__ void __launch_bounds__(INIT_THREADS) split_init(SplitArgs a) {
  const int t = threadIdx.x;
  if (t == 0) {
    SelState s{};
    s.lo = U64_ONES;
    *a.sel = s;
  }
  for (int b = t; b < 3 * SEL_BINS; b += INIT_THREADS) a.hist[b] = 0u;
  lb_clear(a.scan, a.scan_tiles, t, INIT_THREADS);
  lb_clear(a.part, a.part_tiles_max, t, INIT_THREADS);
}

// 2. The table pass: the live list (slot order) and the live timestamps'
// count, min and max.
__global__ void __launch_bounds__(SPLIT_THREADS) split_scan(SplitArgs a) {
  __shared__ unsigned s_tile;
  __shared__ unsigned s_cnt[SPLIT_ITEMS][SPLIT_WARPS];  // live slots of round k in warp w
  __shared__ unsigned s_excl;
  __shared__ ull s_lo[SPLIT_WARPS], s_hi[SPLIT_WARPS];
  __shared__ unsigned s_live[SPLIT_WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  ull lo = U64_ONES, hi = 0ull;
  unsigned n_live = 0u;
  for (;;) {
    const long long tile = lb_take_tile(a.scan, &s_tile);
    if (tile >= a.scan_tiles) break;
    // slot of round k: first + k * SPLIT_THREADS
    const long long first = tile * SPLIT_TILE + threadIdx.x;
    uint4 key[SPLIT_ITEMS];
#pragma unroll
    for (int k = 0; k < SPLIT_ITEMS; k++) {
      const long long i = min(first + k * SPLIT_THREADS, a.n - 1);
      key[k] = *reinterpret_cast<const uint4*>(a.rows + i * ROW_WORDS);
    }
    unsigned live = 0u;
#pragma unroll
    for (int k = 0; k < SPLIT_ITEMS; k++) {
      const Key4 kk{{key[k].x, key[k].y, key[k].z, key[k].w}};
      const bool ok = first + k * SPLIT_THREADS < a.dump && !key_empty(kk) && !key_tomb(kk);
      live |= (ok ? 1u : 0u) << k;
    }
    ull ts[SPLIT_ITEMS];
#pragma unroll
    for (int k = 0; k < SPLIT_ITEMS; k++) {
      ts[k] = 0ull;
      if ((live >> k) & 1u) {
        const uint2 w =
            *reinterpret_cast<const uint2*>(a.rows + (first + k * SPLIT_THREADS) * ROW_WORDS + 30);
        ts[k] = (ull)w.x | ((ull)w.y << 32);
      }
    }
    unsigned ballot[SPLIT_ITEMS];
#pragma unroll
    for (int k = 0; k < SPLIT_ITEMS; k++) {
      const bool on = (live >> k) & 1u;
      if (on) {
        lo = min(lo, ts[k]);
        hi = max(hi, ts[k]);
        n_live++;
      }
      ballot[k] = __ballot_sync(LB_FULL, on);
      if (lane == 0) s_cnt[k][warp] = __popc(ballot[k]);
    }
    __syncthreads();
    // list order is round, then warp, then lane: this warp's offset in
    // each round, and the tile's aggregate
    unsigned off[SPLIT_ITEMS], agg = 0u;
#pragma unroll
    for (int k = 0; k < SPLIT_ITEMS; k++) {
#pragma unroll
      for (int w = 0; w < SPLIT_WARPS; w++) {
        if (w == warp) off[k] = agg;
        agg += s_cnt[k][w];
      }
    }
    if (warp == 0) {  // the tile's offset
      unsigned excl = 0u;
      if (tile == 0) {
        if (lane == 0) lb_publish(a.scan.status, tile, LB_INC, 1u, agg);
      } else {
        if (lane == 0) lb_publish(a.scan.status, tile, LB_AGG, 1u, agg);
        excl = lb_exclusive(a.scan.status, tile, 1u);
        if (lane == 0) lb_publish(a.scan.status, tile, LB_INC, 1u, excl + agg);
      }
      if (lane == 0) s_excl = excl;
    }
    __syncthreads();
    if (live != 0u) {
      const unsigned excl = s_excl;
#pragma unroll
      for (int k = 0; k < SPLIT_ITEMS; k++) {
        if (!((live >> k) & 1u)) continue;
        const unsigned pos = excl + off[k] + __popc(ballot[k] & below);
        a.live_slot[pos] = (int32_t)(first + k * SPLIT_THREADS);
        a.live_ts[pos] = ts[k];
      }
    }
  }
  // the block's count, min and max: one atomic each
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(LB_FULL, lo, o));
    hi = max(hi, __shfl_xor_sync(LB_FULL, hi, o));
  }
  n_live = __reduce_add_sync(LB_FULL, n_live);
  if (lane == 0) {
    s_lo[warp] = lo;
    s_hi[warp] = hi;
    s_live[warp] = n_live;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < SPLIT_WARPS; w++) {
      lo = min(lo, s_lo[w]);
      hi = max(hi, s_hi[w]);
      n_live += s_live[w];
    }
    if (n_live) {
      atomicAdd(&a.sel->live, n_live);
      atomicMin(&a.sel->lo, lo);
      atomicMax(&a.sel->hi, hi);
    }
  }
  lb_leave(a.scan);
}

// A shared-memory histogram add, aggregated over the lanes of a warp that
// add to one bin (a cluster of timestamps puts many in one bin): one
// atomic per distinct bin per warp. Every lane of the warp must call it.
__device__ __forceinline__ void hist_add(unsigned* h, unsigned bin, bool on) {
  const unsigned active = __ballot_sync(0xFFFFFFFFu, on);
  if (!on) return;
  const unsigned peers = __match_any_sync(active, bin);
  if ((int)(threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(&h[bin], (unsigned)__popc(peers));
}

// Block-wide over SEL_THREADS threads: the bin of `h` (SEL_BINS bins, in
// shared or global memory) that holds rank k (k below the bins' total), and
// the count of the bins before it. `s` holds SEL_WARPS + 2 words of shared
// memory.
template <class H>
__device__ __forceinline__ void block_pick(const H& h, ull k, ull* s, unsigned* bin, ull* below) {
  constexpr int PER = SEL_BINS / SEL_THREADS;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  ull mine = 0ull;
#pragma unroll
  for (int j = 0; j < PER; j++) mine += h(t * PER + j);
  ull incl = mine;  // inclusive scan over the block
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const ull y = __shfl_up_sync(0xFFFFFFFFu, incl, o);
    if (lane >= o) incl += y;
  }
  __syncthreads();
  if (lane == 31) s[warp] = incl;
  __syncthreads();
  for (int w = 0; w < warp; w++) incl += s[w];
  const ull excl = incl - mine;
  if (excl <= k && k < incl) {
    ull c = excl;
    for (int j = 0; j < PER; j++) {
      const ull v = h(t * PER + j);
      if (k < c + v) {
        s[SEL_WARPS] = (ull)(t * PER + j);
        s[SEL_WARPS + 1] = c;
        break;
      }
      c += v;
    }
  }
  __syncthreads();
  *bin = (unsigned)s[SEL_WARPS];
  *below = s[SEL_WARPS + 1];
  __syncthreads();
}

__device__ __forceinline__ int bit_length(ull x) { return x ? 64 - __clzll((long long)x) : 0; }

// 3. The select, one cooperative launch (every block resident, grid-wide
// barriers): pass after pass over the live timestamps in the current bin,
// a histogram of SEL_BINS bins, then every block picks the bin of the rank
// alike, until the bin is one value wide. The trivial cases (n_cold >=
// live, every live timestamp equal) settle the watermark at once.
__global__ void __launch_bounds__(SEL_THREADS) split_select(SplitArgs a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ unsigned h[SEL_BINS];
  __shared__ ull s[SEL_WARPS + 2];
  SelState* sel = a.sel;
  const ull lo = sel->lo, hi = sel->hi;
  const long long live = sel->live;
  if (a.n_cold >= (ull)live || lo == hi) {  // alike in every block
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      sel->watermark = a.n_cold >= (ull)live ? U64_ONES : lo;
      sel->done = 1u;
    }
    return;
  }
  ull base = lo, k = a.n_cold;
  int shift = bit_length(hi - lo);  // every live v: v - base < 2^shift
  const long long stride = (long long)gridDim.x * SEL_THREADS;
  for (int pass = 0; shift > 0; pass++) {
    const int s2 = shift > SEL_BITS ? shift - SEL_BITS : 0;
    unsigned* gh = a.hist + (size_t)(pass % 3) * SEL_BINS;
    if (blockIdx.x == 0) {  // the next pass's bins: last read two passes ago
      unsigned* next = a.hist + (size_t)((pass + 1) % 3) * SEL_BINS;
      for (int b = threadIdx.x; b < SEL_BINS; b += SEL_THREADS) next[b] = 0u;
    }
    for (int b = threadIdx.x; b < SEL_BINS; b += SEL_THREADS) h[b] = 0u;
    __syncthreads();
    for (long long j0 = (long long)blockIdx.x * SEL_THREADS; j0 < live; j0 += stride) {
      const long long j = j0 + threadIdx.x;
      const ull v = j < live ? a.live_ts[j] : base;
      const bool in = j < live && v >= base && (shift >= 64 || ((v - base) >> shift) == 0ull);
      hist_add(h, (unsigned)((v - base) >> s2), in);
    }
    __syncthreads();
    for (int b = threadIdx.x; b < SEL_BINS; b += SEL_THREADS)
      if (h[b]) atomicAdd(&gh[b], h[b]);
    grid.sync();
    unsigned bin;
    ull before;
    block_pick([&](int b) { return (ull)__ldcg(gh + b); }, k, s, &bin, &before);
    base += (ull)bin << s2;
    k -= before;
    shift = s2;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    sel->watermark = base;
    sel->done = 1u;
  }
}

// 5. The stable partition of the live list into the cold and hot lists, and
// their padding.
__global__ void __launch_bounds__(SPLIT_THREADS) split_part(SplitArgs a) {
  __shared__ unsigned s_tile;
  __shared__ unsigned s_cnt[PART_ITEMS][SPLIT_WARPS];  // cold entries of round k in warp w
  __shared__ unsigned s_excl;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const long long live = a.sel->live;
  const ull wm = a.sel->watermark;
  const long long tiles = (live + PART_TILE - 1) / PART_TILE;
  for (;;) {
    const long long tile = lb_take_tile(a.part, &s_tile);
    if (tile >= tiles) break;
    // entry of round k: first + k * SPLIT_THREADS
    const long long first = tile * PART_TILE + threadIdx.x;
    ull ts[PART_ITEMS];
#pragma unroll
    for (int k = 0; k < PART_ITEMS; k++) {
      const long long j = first + k * SPLIT_THREADS;
      ts[k] = j < live ? a.live_ts[j] : 0ull;
    }
    unsigned ballot[PART_ITEMS];
#pragma unroll
    for (int k = 0; k < PART_ITEMS; k++) {
      const bool cold = first + k * SPLIT_THREADS < live && ts[k] < wm;
      ballot[k] = __ballot_sync(LB_FULL, cold);
      if (lane == 0) s_cnt[k][warp] = __popc(ballot[k]);
    }
    __syncthreads();
    unsigned off[PART_ITEMS], agg = 0u;
#pragma unroll
    for (int k = 0; k < PART_ITEMS; k++) {
#pragma unroll
      for (int w = 0; w < SPLIT_WARPS; w++) {
        if (w == warp) off[k] = agg;
        agg += s_cnt[k][w];
      }
    }
    if (warp == 0) {  // the tile's cold offset
      unsigned excl = 0u;
      if (tile == 0) {
        if (lane == 0) lb_publish(a.part.status, tile, LB_INC, 1u, agg);
      } else {
        if (lane == 0) lb_publish(a.part.status, tile, LB_AGG, 1u, agg);
        excl = lb_exclusive(a.part.status, tile, 1u);
        if (lane == 0) lb_publish(a.part.status, tile, LB_INC, 1u, excl + agg);
      }
      if (lane == 0) s_excl = excl;
    }
    __syncthreads();
    const unsigned excl = s_excl;
#pragma unroll
    for (int k = 0; k < PART_ITEMS; k++) {
      const long long j = first + k * SPLIT_THREADS;
      if (j >= live) continue;
      const unsigned c = excl + off[k] + __popc(ballot[k] & below);  // cold entries before j
      const int32_t slot = a.live_slot[j];
      if ((ballot[k] >> lane) & 1u) {
        a.cold[c] = slot;
      } else {
        a.hot[j - c] = slot;
      }
    }
  }

  // the padding, once the last tile has published the cold total
  if (threadIdx.x == 0) {
    unsigned total = 0u;
    if (tiles > 0) {
      unsigned long long s;
      do {
        s = lb_load(a.part.status, tiles - 1);
      } while (lb_flag(s, 1u) != LB_INC);
      total = (unsigned)s;
    }
    s_excl = total;
  }
  __syncthreads();
  const long long n_cold = s_excl, n_hot = live - n_cold;
  const long long stride = (long long)gridDim.x * SPLIT_THREADS;
  const long long t0 = (long long)blockIdx.x * SPLIT_THREADS + threadIdx.x;
  const int32_t fill = (int32_t)a.dump;
  for (long long i = n_cold + t0; i < a.size; i += stride) a.cold[i] = fill;
  for (long long i = n_hot + t0; i < a.size; i += stride) a.hot[i] = fill;
  lb_leave(a.part);
}

// Persistent blocks: as many as fit on the card at once, at most `per_sm`
// an SM.
template <class K>
static int fit_grid(K kernel, int threads, int per_sm_max = 1 << 20) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  per_sm = per_sm < per_sm_max ? per_sm : per_sm_max;
  return sms * (per_sm > 0 ? per_sm : 1);
}

// rows: the transfer table ((1 << cap_log2) + 1 rows); n_cold: the rank of
// the watermark (0 <= n_cold < rows); cold/hot: int32 [(1 << cap_log2) +
// SPILL_CHUNK] each; scratch: tb_spill_split_scratch(cap_log2) bytes.
extern "C" int tb_spill_split(const uint32_t* rows, int cap_log2, long long n_cold,
                              int32_t* cold, int32_t* hot, char* scratch, cudaStream_t stream) {
  long long dump = 1ll << cap_log2, n = dump + 1;
  if (n_cold < 0 || n_cold >= n) return (int)cudaErrorInvalidValue;
  static int scan_fit = 0, part_fit = 0, select_fit = 0;
  if (scan_fit == 0) {
    scan_fit = fit_grid(split_scan, SPLIT_THREADS);
    part_fit = fit_grid(split_part, SPLIT_THREADS);
    select_fit = fit_grid(split_select, SEL_THREADS, 1);  // one block an SM: fewer atomics
  }
  size_t size;
  SplitArgs a = carve(scratch, n, &size);
  a.rows = rows;
  a.n = n;
  a.dump = dump;
  a.n_cold = (ull)n_cold;
  a.cold = cold;
  a.hot = hot;
  a.size = dump + SPILL_CHUNK;
  split_init<<<1, INIT_THREADS, 0, stream>>>(a);
  const int scan_grid = a.scan_tiles < scan_fit ? (int)a.scan_tiles : scan_fit;
  split_scan<<<scan_grid, SPLIT_THREADS, 0, stream>>>(a);
  void* args[] = {&a};
  cudaError_t err = cudaLaunchCooperativeKernel((void*)split_select, dim3(select_fit),
                                                dim3(SEL_THREADS), args, 0, stream);
  if (err != cudaSuccess) return (int)err;
  split_part<<<part_fit, SPLIT_THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}
