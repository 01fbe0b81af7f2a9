// K10, the spill cycle's row movers: gather and reload.
//
// Replaces tigerbeetle_tpu/models/spill.py SpillKernels._gather and _reload
// (:271-305), called by SpillManager._cycle (:859-925: the cold rows'
// gather to the host, the hot tail's rebuild into a fresh table) and
// _reload_rows (:721-753: spilled rows a batch references, back into the
// live table).
//
// - tb_spill_gather: rows and fulfill words at an index list (the dump slot
//   is a valid index; its content comes out as it is).
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
// Bound on an H100: bytes. A chunk of 8192 moves 8192 x 132 bytes in and
// the same out, plus one key sector per probe; gather moves its rows once
// each way.
//
// Design: gather is one thread per row (eight 16-byte vectors). Reload is
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

__global__ void spill_gather_kernel(const uint32_t* __restrict__ rows,
                                    const uint32_t* __restrict__ fulfill,
                                    const int32_t* __restrict__ idx, int B,
                                    uint32_t* __restrict__ out_rows,
                                    uint32_t* __restrict__ out_ful) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  long long s = idx[i];
  store_row(out_rows + (size_t)i * ROW_WORDS, load_row(rows + s * ROW_WORDS));
  out_ful[i] = fulfill[s];
}

// rows/fulfill: the table and its fulfill column; idx: int32 [B] slots (each
// at most the dump slot, checked by the caller); out_rows [B, 32], out_ful [B].
extern "C" int tb_spill_gather(const uint32_t* rows, const uint32_t* fulfill, const int32_t* idx,
                               int B, uint32_t* out_rows, uint32_t* out_ful,
                               cudaStream_t stream) {
  if (B > 0) {
    spill_gather_kernel<<<grid_for(B), LANES_PER_BLOCK, 0, stream>>>(rows, fulfill, idx, B,
                                                                     out_rows, out_ful);
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
