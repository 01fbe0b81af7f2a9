// The sharded ledger's owner hash and owner-shard probes (K11, mesh_*.cu).
//
// owner_of is tigerbeetle_tpu/parallel/mesh.py `owner_of_key4` (:105-114):
// the same constants (:98-102) as the port's parallel/mesh.py, a plain
// unsigned 64-bit modulo at the end. The S shards of a table lie one after
// another in one allocation, (1 << cap_log2) + 1 rows each (the last the
// shard's dump row, never written here).
//
// The JAX kernels probe every shard for every lane and combine the
// owner-masked answers with one psum; exactly one shard, the key's owner,
// can contribute a found row, and only the owner's unresolved probe counts.
// So a lane here probes its key's owner shard alone and gets the same
// answer: found and resolved as the owner has them, the row if found and
// all-zero else (the psum of nothing), and the fulfill word likewise.
#pragma once
#include <cstdint>

#include "hash.cuh"

// Shards a kernel's fixed per-shard arrays can hold (the wrappers check).
#define MESH_SHARDS_MAX 64

__device__ __forceinline__ int owner_of(const Key4& key, int n_shards) {
  uint64_t lo = (uint64_t)key.k[0] | ((uint64_t)key.k[1] << 32);
  uint64_t hi = (uint64_t)key.k[2] | ((uint64_t)key.k[3] << 32);
  uint64_t x = (lo ^ 0xA5A5A5A5A5A5A5A5ull) * 0xD6E8FEB86659FD93ull;
  x = x ^ (hi * 0xD6E8FEB86659FD93ull) ^ (x >> 29);
  x = x * 0x94D049BB133111EBull;
  x = x ^ (x >> 32);
  return (int)(x % (uint64_t)n_shards);
}

// The first row of `shard`'s table.
__device__ __forceinline__ size_t shard_base(int shard, int cap_log2) {
  return (size_t)shard * (((size_t)1 << cap_log2) + 1);
}

// `table_lookup` of `key` in its owner's table; the slot is a row index
// into the whole allocation.
__device__ __forceinline__ Found owner_lookup(const uint32_t* rows, int cap_log2, int n_shards,
                                              const Key4& key, int window) {
  size_t base = shard_base(owner_of(key, n_shards), cap_log2);
  Found f = table_lookup(rows + base * ROW_WORDS, cap_log2, key, window);
  f.slot += (int64_t)base;
  return f;
}

// The row a lookup gives: the found row, else all zero.
__device__ __forceinline__ Row found_row(const uint32_t* rows, const Found& f) {
  Row r = {};
  if (f.found) r = load_row(rows + (size_t)f.slot * ROW_WORDS);
  return r;
}

// The lookup policies of the account commits (acct_commit.cuh,
// account_walk.cuh): the owner shard of a key and the first row of a
// shard's table. One table at row 0 (K2):
struct AcctOneTable {
  int n_shards;  // 1
  __device__ int owner(const Key4&) const { return 0; }
  __device__ int64_t base(int, int) const { return 0; }
};

// The key's owner among n_shards tables laid one after another (K11):
struct AcctShards {
  int n_shards;
  __device__ int owner(const Key4& k) const { return owner_of(k, n_shards); }
  __device__ int64_t base(int shard, int log2) const { return (int64_t)shard_base(shard, log2); }
};
