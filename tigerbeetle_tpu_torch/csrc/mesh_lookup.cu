// K11 lookup: the sharded ledger's batched lookup of accounts or transfers.
//
// Replaces tigerbeetle_tpu/parallel/mesh.py
// ShardedLedgerKernels._lookup_accounts_shard / _lookup_transfers_shard
// (:844-857) over `_find` (:205-218): every shard probes its table with
// W = 32, masks by owner, and one psum combines found, row and the
// unresolved flag.
//
// Bound on an H100: latency before bytes, as K1 (lookup.cu). Design: K1's
// group of eight threads a key (group_probe.cuh) on the key's owner shard
// alone (owner.cuh), which gives the psum's answer without the other S - 1
// probes; the row is written from the group's registers where the key is
// found, and all zero where not, into the same one output buffer as K1's.
#include <cuda_runtime.h>

#include "group_probe.cuh"
#include "owner.cuh"

__global__ void mesh_lookup_kernel(const uint32_t* __restrict__ key4, int B,
                                   const uint32_t* __restrict__ rows, int cap_log2, int n_shards,
                                   uint8_t* __restrict__ out) {
  Group g = group_of_thread();
  if (g.key >= B) return;  // the whole group: its threads share the key
  Key4 key = key_at(key4 + 4 * (size_t)g.key);
  const uint32_t* shard = rows + shard_base(owner_of(key, n_shards), cap_log2) * ROW_WORDS;
  GroupFound f = group_lookup(shard, cap_log2, key, WINDOW, g);
  group_store(out, B, g.key, g, f.found ? f.part : make_uint4(0u, 0u, 0u, 0u), f.found,
              f.resolved);
}

extern "C" int tb_mesh_lookup(const uint32_t* key4, int B, const uint32_t* rows, int cap_log2,
                              int n_shards, uint8_t* out, cudaStream_t stream) {
  if (B > 0) {
    mesh_lookup_kernel<<<group_grid_for(B), LANES_PER_BLOCK, 0, stream>>>(
        key4, B, rows, cap_log2, n_shards, out);
  }
  return (int)cudaGetLastError();
}
