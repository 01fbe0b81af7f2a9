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
//   the dump slot to (1 << cap_log2) + CHUNK entries. With n_cold == live
//   the watermark is u64 max and every live row is cold. All compares are
//   unsigned 64-bit, as the JAX program's uint64.
//
// Bound on an H100: bytes. Each slot's key sector decides liveness and its
// timestamp sector (words 24-31) holds ts: 64 bytes a slot; the head reads
// the key sector alone. The index lists are written once.
//
// Design: no sort (the JAX program sorts the whole table). The first pass
// reads both sectors once, stores ts_m (8 bytes a slot) and builds the
// histogram of ts_m's top byte; an unsigned 64-bit radix select then takes
// one digit a pass, most significant first: a one-thread kernel picks the
// digit bucket that holds rank k and narrows (prefix, k), and the next pass
// histograms the next byte of the slots whose higher bytes equal the
// prefix, over ts_m alone. After 8 digits the prefix is the watermark.
// compact.cuh's passes then write both lists in slot order from one byte of
// list bits a slot, and a pad pass fills the tails with the dump slot.
// Every step stays on the card: the host passes n_cold and reads nothing.
#include <cuda_runtime.h>

#include "compact.cuh"
#include "hash.cuh"

#define SPILL_CHUNK 8192
#define SEL_THREADS 256
#define SEL_BLOCKS (132 * 8)

// ---------------------------------------------------------------- head

__global__ void spill_head_kernel(const uint32_t* __restrict__ rows, long long slots,
                                  const uint32_t* __restrict__ fault, uint32_t* __restrict__ out) {
  __shared__ int buf[CT_WARPS];
  int live = 0;
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < slots; i += stride) {
    Key4 k = key_at(rows + i * ROW_WORDS);
    live += !(key_empty(k) || key_tomb(k));
  }
  int s = ct_block_sum(live, buf);
  if (threadIdx.x == 0) {
    if (s) atomicAdd(out, (uint32_t)s);
    if (blockIdx.x == 0) out[1] = *fault;
  }
}

// rows: the transfer table ((1 << cap_log2) + 1 rows); fault: the sticky
// fault word; out: u32 [2], zeroed by the caller.
extern "C" int tb_spill_head(const uint32_t* rows, int cap_log2, const uint32_t* fault,
                             uint32_t* out, cudaStream_t stream) {
  spill_head_kernel<<<SEL_BLOCKS, CT_THREADS, 0, stream>>>(rows, 1ll << cap_log2, fault, out);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- split

struct SelState {
  ull prefix;  // the watermark's digits found so far, in place
  ull k;       // the rank still to find among the slots with that prefix
};

struct SplitScratch {
  ull* ts_m;      // [n] masked timestamps
  uint8_t* live;  // [n] 1 for a live slot (dump row 0)
  uint8_t* bits;  // [n] list bits: 1 cold, 2 hot
  int* counts;    // [2][blocks]
  int* totals;    // [2]
  unsigned* hist;  // [8][256] one histogram per digit
  SelState* sel;
};

static SplitScratch carve(char* scratch, long long n, size_t* size) {
  SplitScratch a{};
  Carver c{scratch, 0};
  a.ts_m = c.take<ull>(n);
  a.live = c.take<uint8_t>(n);
  a.bits = c.take<uint8_t>(n);
  a.counts = c.take<int>(2 * (size_t)compact_blocks(n));
  a.totals = c.take<int>(2);
  a.hist = c.take<unsigned>(8 * 256);
  a.sel = c.take<SelState>(1);
  *size = c.off + 256;
  return a;
}

extern "C" size_t tb_spill_split_scratch(int cap_log2) {
  size_t size;
  carve(nullptr, (1ll << cap_log2) + 1, &size);
  return size;
}

// A shared-memory histogram add, aggregated over the lanes of a warp that
// add to one bin (live timestamps share their high bytes, dead slots all
// sit in bin 255): one atomic per distinct bin per warp. Every lane of the
// warp must call it.
__device__ __forceinline__ void hist_add(unsigned* h, unsigned bin, bool on) {
  unsigned active = __ballot_sync(0xFFFFFFFFu, on);
  if (!on) return;
  unsigned peers = __match_any_sync(active, bin);
  if ((int)(threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(&h[bin], (unsigned)__popc(peers));
}

// Pass 0: ts_m and liveness from the table, and the top byte's histogram.
// The loop steps a whole block at a time, so a warp's lanes stay together.
__global__ void __launch_bounds__(SEL_THREADS)
    split_scan(const uint32_t* __restrict__ rows, long long n, long long dump,
               ull* __restrict__ ts_m, uint8_t* __restrict__ live, unsigned* __restrict__ hist) {
  __shared__ unsigned h[256];
  for (int b = threadIdx.x; b < 256; b += blockDim.x) h[b] = 0;
  __syncthreads();
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long b0 = (long long)blockIdx.x * blockDim.x; b0 < n; b0 += stride) {
    long long i = b0 + threadIdx.x;
    ull t = U64_ONES;
    if (i < n) {
      const uint32_t* p = rows + i * ROW_WORDS;
      Key4 k = key_at(p);
      bool occ = i != dump && !(key_empty(k) || key_tomb(k));
      if (occ) t = (ull)p[30] | ((ull)p[31] << 32);
      ts_m[i] = t;
      live[i] = occ;
    }
    hist_add(h, (unsigned)(t >> 56), i < n);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < 256; b += blockDim.x)
    if (h[b]) atomicAdd(&hist[b], h[b]);
}

// Pass d (1..7): the histogram of byte (7 - d) over the slots whose bytes
// above it equal the prefix found so far.
__global__ void __launch_bounds__(SEL_THREADS)
    split_hist(const ull* __restrict__ ts_m, long long n, int d, const SelState* __restrict__ sel,
               unsigned* __restrict__ hist) {
  __shared__ unsigned h[256];
  for (int b = threadIdx.x; b < 256; b += blockDim.x) h[b] = 0;
  __syncthreads();
  int shift = 8 * (7 - d);
  ull prefix = sel->prefix >> (shift + 8);
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long b0 = (long long)blockIdx.x * blockDim.x; b0 < n; b0 += stride) {
    long long i = b0 + threadIdx.x;
    ull t = i < n ? ts_m[i] : 0ull;
    hist_add(h, (unsigned)((t >> shift) & 0xFF), i < n && (t >> (shift + 8)) == prefix);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < 256; b += blockDim.x)
    if (h[b]) atomicAdd(&hist[b], h[b]);
}

__global__ void split_init(SelState* sel, ull n_cold) {
  if (threadIdx.x == 0) *sel = SelState{0ull, n_cold};
}

// After pass d: the digit whose bucket holds rank k, and k within it.
__global__ void split_select(const unsigned* __restrict__ hist, int d, SelState* sel) {
  if (threadIdx.x != 0) return;
  ull k = sel->k, below = 0;
  int digit = 255;
  for (int b = 0; b < 256; b++) {
    if (k < below + hist[b]) {
      digit = b;
      break;
    }
    below += hist[b];
  }
  sel->k = k - below;
  sel->prefix |= (ull)digit << (8 * (7 - d));
}

struct ColdHot {
  const ull* ts_m;
  const uint8_t* live;
  const SelState* sel;

  __device__ __forceinline__ unsigned operator()(long long i) const {
    if (!live[i]) return 0u;
    return ts_m[i] < sel->prefix ? 1u : 2u;
  }
};

// rows: the transfer table ((1 << cap_log2) + 1 rows); n_cold: the rank of
// the watermark (0 <= n_cold < rows); cold/hot: int32 [(1 << cap_log2) +
// SPILL_CHUNK] each; scratch: tb_spill_split_scratch(cap_log2) bytes.
extern "C" int tb_spill_split(const uint32_t* rows, int cap_log2, long long n_cold,
                              int32_t* cold, int32_t* hot, char* scratch, cudaStream_t stream) {
  long long dump = 1ll << cap_log2, n = dump + 1;
  if (n_cold < 0 || n_cold >= n) return (int)cudaErrorInvalidValue;
  size_t size;
  SplitScratch a = carve(scratch, n, &size);
  cudaMemsetAsync(a.hist, 0, 8 * 256 * sizeof(unsigned), stream);
  split_init<<<1, 32, 0, stream>>>(a.sel, (ull)n_cold);
  split_scan<<<SEL_BLOCKS, SEL_THREADS, 0, stream>>>(rows, n, dump, a.ts_m, a.live, a.hist);
  split_select<<<1, 32, 0, stream>>>(a.hist, 0, a.sel);
  for (int d = 1; d < 8; d++) {
    split_hist<<<SEL_BLOCKS, SEL_THREADS, 0, stream>>>(a.ts_m, n, d, a.sel, a.hist + 256 * d);
    split_select<<<1, 32, 0, stream>>>(a.hist + 256 * d, d, a.sel);
  }
  CompactOut out{};
  long long size_out = dump + SPILL_CHUNK;
  out.idx[0] = cold;
  out.idx[1] = hot;
  out.limit[0] = out.limit[1] = size_out;
  ColdHot pred{a.ts_m, a.live, a.sel};
  compact_run<2>(pred, n, a.bits, a.counts, a.totals, out, stream);
  compact_pad<2><<<SEL_BLOCKS, CT_THREADS, 0, stream>>>(out, a.totals, size_out, (int32_t)dump);
  return (int)cudaGetLastError();
}
