// K1: batched table lookup with the 128-byte row gather.
//
// Replaces tigerbeetle_tpu/models/ledger.py LedgerKernels._lookup_accounts /
// _lookup_transfers (:1444-1459, jitted :754-755) over ops/hashtable.py
// `lookup` (:127).
//
// Bound on an H100: latency before bytes. A key's probes are a chain of
// dependent loads (its key, then each probe, each at about 350 ns from
// device memory), and 8190 keys move about 2 MB, under a microsecond at
// 3.35 TB/s. Design (group_probe.cuh): eight threads a key, so the batch
// fills the card's SMs (8190 keys are 256 blocks of 256 threads); at every
// probe the group reads the slot's whole row in one coalesced request and
// keeps the row the lookup returns in registers, so the chain ends with
// the row in hand and no second trip. One output buffer holds the rows and
// both flags, so the host reads a lookup back with one copy.
#include <cuda_runtime.h>

#include "group_probe.cuh"

__global__ void lookup_kernel(const uint32_t* __restrict__ key4, int B,
                              const uint32_t* __restrict__ rows, int cap_log2,
                              uint8_t* __restrict__ out) {
  Group g = group_of_thread();
  if (g.key >= B) return;  // the whole group: its threads share the key
  Key4 key = key_at(key4 + 4 * (size_t)g.key);
  GroupFound f = group_lookup(rows, cap_log2, key, WINDOW, g);
  group_store(out, B, g.key, g, f.part, f.found, f.resolved);
}

extern "C" int tb_lookup(const uint32_t* key4, int B, const uint32_t* rows, int cap_log2,
                         uint8_t* out, cudaStream_t stream) {
  if (B > 0) {
    lookup_kernel<<<group_grid_for(B), LANES_PER_BLOCK, 0, stream>>>(key4, B, rows, cap_log2,
                                                                      out);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* tb_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
