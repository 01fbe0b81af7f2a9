// K11 lookup: the sharded ledger's batched lookup of accounts or transfers.
//
// Replaces tigerbeetle_tpu/parallel/mesh.py
// ShardedLedgerKernels._lookup_accounts_shard / _lookup_transfers_shard
// (:844-857) over `_find` (:205-218): every shard probes its table with
// W = 32, masks by owner, and one psum combines found, row and the
// unresolved flag.
//
// Bound on an H100: bytes, as K1 (lookup.cu): a lane reads its 16-byte key,
// one 32-byte sector per probe of its owner's chain and the found row, and
// writes the row and two flags. Design: one thread per lane probes the
// owner shard alone (owner.cuh), which gives the psum's answer without the
// other S - 1 probes; rows move as 16-byte vector loads and stores.
#include <cuda_runtime.h>

#include "owner.cuh"

__global__ void mesh_lookup_kernel(const uint32_t* __restrict__ key4, int B,
                                   const uint32_t* __restrict__ rows, int cap_log2, int n_shards,
                                   uint8_t* __restrict__ found, uint8_t* __restrict__ resolved,
                                   uint32_t* __restrict__ out_rows) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  Found f = owner_lookup(rows, cap_log2, n_shards, key_at(key4 + 4 * (size_t)i), WINDOW);
  found[i] = f.found;
  resolved[i] = f.resolved;
  store_row(out_rows + (size_t)i * ROW_WORDS, found_row(rows, f));
}

extern "C" int tb_mesh_lookup(const uint32_t* key4, int B, const uint32_t* rows, int cap_log2,
                              int n_shards, uint8_t* found, uint8_t* resolved, uint32_t* out_rows,
                              cudaStream_t stream) {
  if (B > 0) {
    mesh_lookup_kernel<<<grid_for(B), LANES_PER_BLOCK, 0, stream>>>(
        key4, B, rows, cap_log2, n_shards, found, resolved, out_rows);
  }
  return (int)cudaGetLastError();
}
