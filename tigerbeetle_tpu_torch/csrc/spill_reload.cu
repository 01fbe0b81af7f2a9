// K10, the spill cycle's row movers: gather and reload.
//
// Replaces tigerbeetle_tpu/models/spill.py SpillKernels._gather and _reload
// (:271-305), called by SpillManager._cycle (:859-925: the cold rows'
// gather to the host, the hot tail's rebuild into a fresh table) and
// _reload_rows (:721-753: spilled rows a batch references, back into the
// live table).
//
// - tb_spill_gather: rows and fulfill words at an index list of any length
//   (the dump slot is a valid index; its content comes out as it is). The
//   cycle calls it once for each side: the cold rows into a staging buffer
//   for the host, the hot rows, padded with the dump slot to whole chunks,
//   for the rebuild's reloads.
// - tb_spill_reload: a chunk of stored rows back into a table, verbatim,
//   fulfill word included. Lanes whose key is already resident are skipped
//   (reload is idempotent); the absent active keys claim slots with the
//   JAX rule (4 rounds, lowest lane wins, claim.cu). The chunk is
//   all-or-nothing: PROBE (an active lane's lookup window ran out), CLAIM
//   (a lane found no slot) and CAPACITY (used_slots + new rows > half the
//   slots) OR into the sticky fault word, and any fault, earlier ones
//   included, leaves the table, fulfill and used_slots as they were. Then
//   `probe` = (u32)used_slots ^ fault, the word the host's staging fence
//   waits on. The dump row is never written.
//
// Bound on an H100: bytes. A reload chunk of 8192 moves 8192 x 132 bytes
// in and the same out, plus one key sector per probe. Gather moves its rows
// and fulfill words once each way and reads its indices: (4 + 2 x 132)
// bytes a row, 0.031 ms over 3.35 TB/s for the 393 K cold rows of a cycle
// at 2^20 transfer slots. At 8192 rows a launch (the JAX cycle's CHUNK
// windows, which XLA needs for one compiled shape) the bound is 0.00066 ms
// and the launch and its wrapper cost 0.03 ms, as much as
// torch.index_select: launches, not bytes, held the cycle back.
//
// Design: gather is one grid-stride launch of about two blocks an SM over
// the whole list. Eight lanes move a row as 16-byte vectors, so a warp
// moves four rows a step, and each warp keeps GATHER_UNROLL steps (16 rows,
// 2 KiB) in flight: it loads its 16 indices coalesced, one lane each,
// shuffles them to the row groups, issues all 16 row loads, then stores the
// rows and, from the index lanes, the fulfill words. Reload is
// K1's probe per lane (hash.cuh), which marks the lanes that need a slot
// and counts them and the unresolved lanes per block into scratch words;
// claim.cu's rounds over the needing lanes; a one-thread gate that decides
// `proceed` for the whole chunk, updates the fault word and used_slots and
// writes `probe`; and a scatter of the needing lanes' rows gated on
// `proceed`.
#include <cuda_runtime.h>

#include "claim.cuh"
#include "hash.cuh"

// ---------------------------------------------------------------- gather

#define GATHER_THREADS 256
#define GATHER_UNROLL 4                  // steps of four rows a warp has in flight
#define GATHER_ROWS (4 * GATHER_UNROLL)  // rows a warp moves per turn
#define GATHER_BLOCKS_PER_SM 2

__global__ void __launch_bounds__(GATHER_THREADS) spill_gather_kernel(
    const uint32_t* __restrict__ rows, const uint32_t* __restrict__ fulfill,
    const int32_t* __restrict__ idx, long long B, uint32_t* __restrict__ out_rows,
    uint32_t* __restrict__ out_ful) {
  const int lane = threadIdx.x & 31;
  const int sub = lane & 7, quad = lane >> 3;  // piece of the row, row of the step
  const long long warp = ((long long)blockIdx.x * GATHER_THREADS + threadIdx.x) >> 5;
  const long long n_warps = ((long long)gridDim.x * GATHER_THREADS) >> 5;
  for (long long base = warp * GATHER_ROWS; base < B; base += n_warps * GATHER_ROWS) {
    const bool mine = lane < GATHER_ROWS && base + lane < B;
    const int my_slot = mine ? __ldg(idx + base + lane) : 0;
    uint4 v[GATHER_UNROLL];
#pragma unroll
    for (int u = 0; u < GATHER_UNROLL; u++) {
      const int r = 4 * u + quad;
      const long long s = __shfl_sync(0xFFFFFFFFu, my_slot, r);
      if (base + r < B) {
        v[u] = __ldg(reinterpret_cast<const uint4*>(rows + s * ROW_WORDS) + sub);
      }
    }
    const uint32_t ful = mine ? __ldg(fulfill + my_slot) : 0u;
#pragma unroll
    for (int u = 0; u < GATHER_UNROLL; u++) {
      const long long r = base + 4 * u + quad;
      if (r < B) reinterpret_cast<uint4*>(out_rows + r * ROW_WORDS)[sub] = v[u];
    }
    if (mine) out_ful[base + lane] = ful;
  }
}

// rows/fulfill: the table and its fulfill column; idx: int32 [B] slots (each
// at most the dump slot, checked by the caller); out_rows [B, 32], out_ful [B].
extern "C" int tb_spill_gather(const uint32_t* rows, const uint32_t* fulfill, const int32_t* idx,
                               long long B, uint32_t* out_rows, uint32_t* out_ful,
                               cudaStream_t stream) {
  if (B > 0) {
    static int sms = 0;
    if (sms == 0) {
      int dev = 0;
      cudaGetDevice(&dev);
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (sms <= 0) sms = 1;
    }
    const long long rows_a_block = (long long)GATHER_ROWS * (GATHER_THREADS / 32);
    const long long needed = (B + rows_a_block - 1) / rows_a_block;
    const long long most = (long long)GATHER_BLOCKS_PER_SM * sms;
    const int grid = (int)(needed < most ? needed : most);
    spill_gather_kernel<<<grid, GATHER_THREADS, 0, stream>>>(rows, fulfill, idx, B, out_rows,
                                                            out_ful);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- reload

struct ReloadScratch {
  int32_t* need;  // [B] active and not resident: claims a slot
  int64_t* slot;  // [B]
  uint32_t* bad;  // [1] PROBE and CLAIM bits of this chunk
  ull* n_new;     // [1] needing lanes
  int32_t* proceed;  // [1]
  ClaimScratch claim_sc;
};

static ReloadScratch carve(char* scratch, int B, size_t* size) {
  ReloadScratch a{};
  Carver c{scratch, 0};
  a.need = c.take<int32_t>(B);
  a.slot = c.take<int64_t>(B);
  a.bad = c.take<uint32_t>(1);
  a.n_new = c.take<ull>(1);
  a.proceed = c.take<int32_t>(1);
  a.claim_sc.cand = c.take<int64_t>(B);
  a.claim_sc.want = c.take<int32_t>(B);
  a.claim_sc.won = c.take<int32_t>(B);
  *size = c.off + 256;
  return a;
}

extern "C" size_t tb_spill_reload_scratch(int B) {
  size_t size;
  carve(nullptr, B, &size);
  return size;
}

__global__ void reload_probe(const uint32_t* __restrict__ rows, int cap_log2,
                             const uint32_t* __restrict__ rows_b,
                             const uint8_t* __restrict__ active, int B, int32_t* __restrict__ need,
                             ull* n_new, uint32_t* bad) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool act = false, unresolved = false, nd = false;
  if (i < B) {
    Found f = table_lookup(rows, cap_log2, key_at(rows_b + (size_t)i * ROW_WORDS), WINDOW);
    act = active[i] != 0;
    nd = act && !f.found;
    unresolved = act && !f.resolved;
    need[i] = nd;
  }
  int count = __syncthreads_count(nd);
  int any_bad = __syncthreads_or(unresolved);
  if (threadIdx.x != 0) return;
  if (count) atomicAdd(n_new, (ull)count);
  if (any_bad) atomicOr(bad, FAULT_PROBE);
}

__global__ void reload_gate(uint32_t* fault, ull* used, const ull* n_new, const uint32_t* bad,
                            ull half, int32_t* proceed, uint32_t* probe) {
  if (threadIdx.x != 0) return;
  ull n = *n_new, u = *used;
  uint32_t f = *fault | *bad | (u + n > half ? FAULT_CAPACITY : 0u);
  *fault = f;
  *proceed = f == 0u;
  if (f == 0u) u += n;
  *used = u;
  *probe = (uint32_t)u ^ f;
}

__global__ void reload_scatter(uint32_t* __restrict__ rows, uint32_t* __restrict__ fulfill,
                               const uint32_t* __restrict__ rows_b,
                               const uint32_t* __restrict__ ful_b, int B,
                               const int32_t* __restrict__ need, const int64_t* __restrict__ slot,
                               const int32_t* __restrict__ proceed) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B || !*proceed || !need[i]) return;
  int64_t s = slot[i];
  store_row(rows + (size_t)s * ROW_WORDS, load_row(rows_b + (size_t)i * ROW_WORDS));
  fulfill[s] = ful_b[i];
}

// rows/fulfill/claim: the transfer table ((1 << cap_log2) + 1 rows), its
// fulfill and claim columns; used: its used-slot word; fault: the sticky
// fault word; rows_b [B, 32], ful_b [B]: the stored rows; active [B]: the
// lanes to reload; probe: one u32 out; scratch: tb_spill_reload_scratch(B).
extern "C" int tb_spill_reload(uint32_t* rows, uint32_t* fulfill, uint32_t* claim, int cap_log2,
                               ull* used, uint32_t* fault, const uint32_t* rows_b,
                               const uint32_t* ful_b, const uint8_t* active, int B,
                               uint32_t* probe, char* scratch, cudaStream_t stream) {
  if (B <= 0) return (int)cudaErrorInvalidValue;
  size_t size;
  ReloadScratch a = carve(scratch, B, &size);
  cudaMemsetAsync(a.bad, 0, sizeof(uint32_t), stream);
  cudaMemsetAsync(a.n_new, 0, sizeof(ull), stream);
  int g = grid_for(B);
  reload_probe<<<g, LANES_PER_BLOCK, 0, stream>>>(rows, cap_log2, rows_b, active, B, a.need,
                                                  a.n_new, a.bad);
  claim_slots(rows_b, ROW_WORDS, a.need, B, rows, claim, cap_log2, a.slot, a.claim_sc, a.bad,
              stream);
  reload_gate<<<1, 32, 0, stream>>>(fault, used, a.n_new, a.bad, (1ull << cap_log2) / 2,
                                    a.proceed, probe);
  reload_scatter<<<g, LANES_PER_BLOCK, 0, stream>>>(rows, fulfill, rows_b, ful_b, B, a.need,
                                                    a.slot, a.proceed);
  return (int)cudaGetLastError();
}
