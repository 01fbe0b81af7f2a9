// K8: the equality filter scan behind the secondary-index queries.
//
// Replaces tigerbeetle_tpu/models/ledger.py LedgerKernels.filter_scan
// (:767-798), called by DeviceLedger._query_scan (:2786-2803).
//
// What it computes, for a table of 1 << cap_log2 slots plus the dump row:
// the live slots (key neither empty nor tombstone; the dump row excluded)
// whose field equals the query value, on `nwords` u32 words from `word0`
// or, for a half-word field, on the low 16 bits of word0; the total match
// count; and the first QUERY_LIMIT matching rows in slot order, padded with
// the dump row's content.
//
// Bound on an H100: bytes, over 3.35 TB/s. Each slot's key sector (32
// bytes) decides liveness and the field's sector the match: one sector a
// slot when the field shares the key's sector (debit_account_id), two
// otherwise (credit_account_id, code). The output is at most 1 MiB of rows.
// There is no arithmetic to speak of. The card fetches 64 bytes for such a
// sector (chase.cu's sector probe: two sectors of one 64-byte half cost
// 1.15 times one, one of each half 2.06 times), so the floor is 64 bytes a
// slot, and 64 more a live slot whose field lies in the row's other half.
//
// Design: one launch, one pass over the table.
// - Persistent blocks take tiles of FS_TILE consecutive slots in order from
//   a tile counter (lookback.cuh), so a tile's predecessors are running or
//   done and it may wait on them.
// - A tile is FS_ITEMS rounds of FS_THREADS neighbouring slots (a warp's
//   load covers 32 neighbouring rows). Each thread issues the key loads of
//   all its slots before it uses one, then the field loads of its live
//   slots, all together: no break and no store between loads, and the
//   ragged end clamps its addresses and masks its bits. A field in the
//   other 64-byte half is read for live slots only (an unconditional load
//   would fetch that half for every slot); one in the key's half comes from
//   the same fetch.
// - The match bits stay in registers. Warp ballots and one block barrier
//   rank them in slot order; decoupled look-back gives the tile's offset.
//   No per-slot array is written and the table is read once.
// - A tile writes its matches below QUERY_LIMIT straight into the output
//   (one thread a row, eight 16-byte vectors). The last tile writes the
//   total; then every block, having run out of tiles, waits for that total
//   and writes its share of the dump-row padding, eight lanes a row.
// The count is exact: the whole table is scanned, with no exit at
// QUERY_LIMIT. The state buffer (counters and tile status words) is kept by
// the caller between calls and never cleared: each call passes a new epoch.
#include <cuda_runtime.h>

#include "hash.cuh"
#include "lookback.cuh"

#define QUERY_LIMIT 8192
#define FS_THREADS 256
#define FS_ITEMS 8
#define FS_TILE (FS_THREADS * FS_ITEMS)  // kernels.FILTER_TILE
#define FS_WARPS (FS_THREADS / 32)

struct ScanArgs {
  const uint32_t* rows;
  long long n;     // slots, the dump row included
  long long dump;  // the dump row's index
  long long tiles;
  int word0, halfword;
  uint32_t v0, v1, v2, v3;
  uint32_t* out_rows;
  int32_t* out_total;
  LookbackState st;
  unsigned epoch;
};

// The field's words of one row, NW of them from word0 (NW-aligned).
template <int NW>
struct Field;
template <>
struct Field<1> {
  uint32_t x;
  __device__ __forceinline__ void load(const uint32_t* p) { x = *p; }
  __device__ __forceinline__ bool eq(const ScanArgs& a) const {
    return (a.halfword ? (x & 0xFFFFu) : x) == a.v0;
  }
};
template <>
struct Field<2> {
  uint2 x;
  __device__ __forceinline__ void load(const uint32_t* p) {
    x = *reinterpret_cast<const uint2*>(p);
  }
  __device__ __forceinline__ bool eq(const ScanArgs& a) const { return x.x == a.v0 && x.y == a.v1; }
};
template <>
struct Field<4> {
  uint4 x;
  __device__ __forceinline__ void load(const uint32_t* p) {
    x = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ bool eq(const ScanArgs& a) const {
    return x.x == a.v0 && x.y == a.v1 && x.z == a.v2 && x.w == a.v3;
  }
};

template <int NW>
__global__ void __launch_bounds__(FS_THREADS) filter_scan_kernel(ScanArgs a) {
  __shared__ unsigned s_tile;
  __shared__ unsigned s_cnt[FS_ITEMS][FS_WARPS];  // matches of round k in warp w
  __shared__ unsigned s_excl;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  for (;;) {
    const long long tile = lb_take_tile(a.st, &s_tile);
    if (tile >= a.tiles) break;
    // slot of round k: first + k * FS_THREADS
    const long long first = tile * FS_TILE + threadIdx.x;
    uint4 key[FS_ITEMS];
#pragma unroll
    for (int k = 0; k < FS_ITEMS; k++) {
      const long long i = min(first + k * FS_THREADS, a.n - 1);
      key[k] = *reinterpret_cast<const uint4*>(a.rows + i * ROW_WORDS);
    }
    unsigned live = 0u;
#pragma unroll
    for (int k = 0; k < FS_ITEMS; k++) {
      const Key4 kk{{key[k].x, key[k].y, key[k].z, key[k].w}};
      const bool ok = first + k * FS_THREADS < a.dump && !key_empty(kk) && !key_tomb(kk);
      live |= (ok ? 1u : 0u) << k;
    }
    Field<NW> fld[FS_ITEMS];
#pragma unroll
    for (int k = 0; k < FS_ITEMS; k++) {
      if ((live >> k) & 1u) fld[k].load(a.rows + (first + k * FS_THREADS) * ROW_WORDS + a.word0);
    }
    unsigned bits = 0u, ballot[FS_ITEMS];
#pragma unroll
    for (int k = 0; k < FS_ITEMS; k++) {
      const bool hit = ((live >> k) & 1u) && fld[k].eq(a);
      bits |= (hit ? 1u : 0u) << k;
      ballot[k] = __ballot_sync(LB_FULL, hit);
      if (lane == 0) s_cnt[k][warp] = __popc(ballot[k]);
    }
    __syncthreads();
    // slot order is round, then warp, then lane: this warp's offset in each
    // round, and the tile's aggregate
    unsigned off[FS_ITEMS], agg = 0u;
#pragma unroll
    for (int k = 0; k < FS_ITEMS; k++) {
#pragma unroll
      for (int w = 0; w < FS_WARPS; w++) {
        if (w == warp) off[k] = agg;
        agg += s_cnt[k][w];
      }
    }
    if (warp == 0) {  // the tile's offset
      unsigned excl = 0u;
      if (tile == 0) {
        if (lane == 0) lb_publish(a.st.status, tile, LB_INC, a.epoch, agg);
      } else {
        if (lane == 0) lb_publish(a.st.status, tile, LB_AGG, a.epoch, agg);
        excl = lb_exclusive(a.st.status, tile, a.epoch);
        if (lane == 0) lb_publish(a.st.status, tile, LB_INC, a.epoch, excl + agg);
      }
      if (lane == 0) {
        s_excl = excl;
        if (tile == a.tiles - 1) *a.out_total = (int32_t)(excl + agg);
      }
    }
    __syncthreads();
    if (bits != 0u) {
      const unsigned excl = s_excl;
#pragma unroll
      for (int k = 0; k < FS_ITEMS; k++) {
        const unsigned pos = excl + off[k] + __popc(ballot[k] & below);
        if (!((bits >> k) & 1u) || pos >= QUERY_LIMIT) continue;
        store_row(a.out_rows + (size_t)pos * ROW_WORDS,
                  load_row(a.rows + (first + k * FS_THREADS) * ROW_WORDS));
      }
    }
  }

  // the padding [total, QUERY_LIMIT) with the dump row, once the last tile
  // has published the total
  if (threadIdx.x == 0) {
    unsigned long long s;
    do {
      s = lb_load(a.st.status, a.tiles - 1);
    } while (lb_flag(s, a.epoch) != LB_INC);
    s_excl = (unsigned)s;
  }
  __syncthreads();
  const unsigned total = s_excl;
  const int sub = threadIdx.x & 7;
  const long long groups = (long long)gridDim.x * (FS_THREADS / 8);
  const uint4 d = reinterpret_cast<const uint4*>(a.rows + a.dump * ROW_WORDS)[sub];
  for (long long r = total + (long long)blockIdx.x * (FS_THREADS / 8) + (threadIdx.x >> 3);
       r < QUERY_LIMIT; r += groups) {
    reinterpret_cast<uint4*>(a.out_rows + r * ROW_WORDS)[sub] = d;
  }
  lb_leave(a.st);
}

static long long scan_tiles(int cap_log2) {
  return ((1ll << cap_log2) + 1 + FS_TILE - 1) / FS_TILE;
}

// The bytes of the state buffer a table of 1 << cap_log2 slots needs: the
// caller keeps it between calls, zeroed once.
extern "C" size_t tb_filter_scan_state_bytes(int cap_log2) {
  return lookback_bytes(scan_tiles(cap_log2));
}

// Persistent blocks: as many as fit on the card at once, at most one a tile.
template <int NW>
static int scan_grid(long long tiles) {
  static int fit = 0;
  if (fit == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, filter_scan_kernel<NW>, FS_THREADS,
                                                  0);
    fit = sms * (per_sm > 0 ? per_sm : 1);
  }
  return (int)(tiles < fit ? tiles : fit);
}

// rows: the table ((1 << cap_log2) + 1 rows, the last the dump row);
// (word0, nwords, halfword): the field, word0 a multiple of nwords; v: the
// value's u32 words, low first; out_rows: [QUERY_LIMIT, 32]; out_total: one
// int32; state: tb_filter_scan_state_bytes(cap_log2) bytes, zeroed before
// the first call and kept; epoch: a value in [1, 2^30) that differs from
// the previous call's on this state.
extern "C" int tb_filter_scan(const uint32_t* rows, int cap_log2, int word0, int nwords,
                              int halfword, uint32_t v0, uint32_t v1, uint32_t v2, uint32_t v3,
                              uint32_t* out_rows, int32_t* out_total, char* state,
                              unsigned epoch, cudaStream_t stream) {
  if (word0 < 0 || nwords < 1 || nwords > 4 || nwords == 3 || word0 % nwords != 0 ||
      word0 + nwords > ROW_WORDS || (halfword && nwords != 1) || epoch == 0u ||
      epoch > LB_EPOCH_MASK)
    return (int)cudaErrorInvalidValue;
  ScanArgs a{};
  a.rows = rows;
  a.dump = 1ll << cap_log2;
  a.n = a.dump + 1;
  a.tiles = scan_tiles(cap_log2);
  a.word0 = word0;
  a.halfword = halfword;
  a.v0 = v0;
  a.v1 = v1;
  a.v2 = v2;
  a.v3 = v3;
  a.out_rows = out_rows;
  a.out_total = out_total;
  a.st = lookback_carve(state);
  a.epoch = epoch;
  if (nwords == 1) {
    filter_scan_kernel<1><<<scan_grid<1>(a.tiles), FS_THREADS, 0, stream>>>(a);
  } else if (nwords == 2) {
    filter_scan_kernel<2><<<scan_grid<2>(a.tiles), FS_THREADS, 0, stream>>>(a);
  } else {
    filter_scan_kernel<4><<<scan_grid<4>(a.tiles), FS_THREADS, 0, stream>>>(a);
  }
  return (int)cudaGetLastError();
}
