// K9: snapshot row install, one chunk of 128-byte row images into a table.
//
// Replaces tigerbeetle_tpu/models/ledger.py DeviceLedger._install_fn
// (:2561-2610), driven chunk by chunk by install_snapshot_rows (:2612-2675).
//
// Bound on an H100: bytes. Each row is read once and written once (with
// its fulfill word for transfers), and each claim probe reads one 32-byte
// sector of key words and one claim word; there is no arithmetic.
//
// Design: the claim rounds of claim.cu decide the slots with the JAX rule
// (4 rounds, lowest lane wins within the chunk), over active lanes
// `lane < n`; slot placement is part of the state, so a chunk here is the
// JAX chunk. Then `install_scatter`, one thread per lane, writes each
// resolved lane's row and fulfill word, counts the resolved lanes per
// block (__syncthreads_count) and adds them into the table's count and
// used-slot words with one atomicAdd per block, and ORs FAULT_INSTALL into
// the fault word if any active lane found no slot. The install is not
// gated on an earlier fault (as in the JAX function), and the dump row is
// never written: unresolved lanes write nothing.
#include <cuda_runtime.h>

#include "claim.cuh"
#include "hash.cuh"

struct InstallScratch {
  int32_t* active;
  int64_t* slot;
  uint32_t* bad;  // claim_slots' fault bits, unused: `won` decides per lane
  ClaimScratch claim_sc;
};

static InstallScratch carve(char* scratch, int B, size_t* size) {
  InstallScratch a{};
  Carver c{scratch, 0};
  a.active = c.take<int32_t>(B);
  a.slot = c.take<int64_t>(B);
  a.bad = c.take<uint32_t>(1);
  a.claim_sc.cand = c.take<int64_t>(B);
  a.claim_sc.want = c.take<int32_t>(B);
  a.claim_sc.won = c.take<int32_t>(B);
  *size = c.off + 256;
  return a;
}

extern "C" size_t tb_install_rows_scratch(int B) {
  size_t size;
  carve(nullptr, B, &size);
  return size;
}

__global__ void install_active(int32_t* active, int B, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < B) active[i] = i < n;
}

__global__ void install_scatter(uint32_t* __restrict__ rows, uint32_t* fulfill,
                                const uint32_t* __restrict__ rows_b,
                                const uint32_t* __restrict__ ful_b, int B, int n,
                                const int64_t* __restrict__ slot,
                                const int32_t* __restrict__ won, ull* count, ull* used,
                                uint32_t* fault) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool active = i < B && i < n;
  bool ok = active && won[i] != 0;
  if (ok) {
    int64_t s = slot[i];
    store_row(rows + (size_t)s * ROW_WORDS, load_row(rows_b + (size_t)i * ROW_WORDS));
    if (fulfill != nullptr) fulfill[s] = ful_b[i];
  }
  int resolved = __syncthreads_count(ok);
  int lost = __syncthreads_or(active && !ok);
  if (threadIdx.x != 0) return;
  if (resolved) {
    atomicAdd(count, (ull)resolved);
    atomicAdd(used, (ull)resolved);
  }
  if (lost) atomicOr(fault, FAULT_INSTALL);
}

// rows/claim: the table and its claim column (capacity 1 << cap_log2, plus
// the dump row); fulfill/ful_b: null for accounts; rows_b: [B, 32] row
// images, lanes < n installed; count/used: the table's live count and
// used-slot words; scratch: tb_install_rows_scratch(B) bytes.
extern "C" int tb_install_rows(uint32_t* rows, uint32_t* claim, int cap_log2, uint32_t* fulfill,
                               ull* count, ull* used, uint32_t* fault, const uint32_t* rows_b,
                               const uint32_t* ful_b, int B, int n, char* scratch,
                               cudaStream_t stream) {
  if (B <= 0) return (int)cudaGetLastError();
  size_t size;
  InstallScratch a = carve(scratch, B, &size);
  int g = grid_for(B);
  install_active<<<g, LANES_PER_BLOCK, 0, stream>>>(a.active, B, n);
  claim_slots(rows_b, ROW_WORDS, a.active, B, rows, claim, cap_log2, a.slot, a.claim_sc, a.bad,
              stream);
  install_scatter<<<g, LANES_PER_BLOCK, 0, stream>>>(rows, fulfill, rows_b, ful_b, B, n, a.slot,
                                                     a.claim_sc.won, count, used, fault);
  return (int)cudaGetLastError();
}
