// K1: batched table lookup with the 128-byte row gather.
//
// Replaces tigerbeetle_tpu/models/ledger.py LedgerKernels._lookup_accounts /
// _lookup_transfers (:1444-1459, jitted :754-755) over ops/hashtable.py
// `lookup` (:127).
//
// Bound on an H100: bytes. A lane reads its 16-byte key, one 32-byte sector
// per probe (the key words of a row), then the 128-byte row, and writes the
// row, its slot and two flags; there is no arithmetic to speak of. Design:
// one thread per lane, probing in sequence and stopping at the first hit or
// empty slot (at load <= 1/2 the mean chain is under two probes), so a lane
// touches only the sectors its own chain needs; rows move as 16-byte vector
// loads and stores.
#include <cuda_runtime.h>

#include "hash.cuh"

__global__ void lookup_kernel(const uint32_t* __restrict__ key4, int B,
                              const uint32_t* __restrict__ rows, int cap_log2,
                              int64_t* __restrict__ slot, uint8_t* __restrict__ found,
                              uint8_t* __restrict__ resolved, uint32_t* __restrict__ out_rows) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  Found f = table_lookup(rows, cap_log2, key_at(key4 + 4 * (size_t)i), WINDOW);
  slot[i] = f.slot;
  found[i] = f.found;
  resolved[i] = f.resolved;
  store_row(out_rows + (size_t)i * ROW_WORDS, load_row(rows + (size_t)f.slot * ROW_WORDS));
}

extern "C" int tb_lookup(const uint32_t* key4, int B, const uint32_t* rows, int cap_log2,
                         int64_t* slot, uint8_t* found, uint8_t* resolved,
                         uint32_t* out_rows, cudaStream_t stream) {
  if (B > 0) {
    lookup_kernel<<<grid_for(B), LANES_PER_BLOCK, 0, stream>>>(
        key4, B, rows, cap_log2, slot, found, resolved, out_rows);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* tb_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
