// Double-hashed probes over the row tables: the exact hash_key4 /
// probe_step of tigerbeetle_tpu/ops/hashtable.py:74-108 and the probe
// results of its `lookup` and `probe_free`, for one lane.
//
// A probe sequence visits (base + j * step) & mask for j < window, step odd.
// The JAX version gathers the whole window and resolves it branch-free; a
// GPU lane can stop early and get the same answer: `found` needs a hit
// before the first empty slot, the first free slot is never after the first
// empty one, so only a window with no empty slot must be scanned in full.
#pragma once
#include <cstdint>

#include "rows.cuh"

#define WINDOW 32
#define WINDOW_SCALAR 64
#define CLAIM_FREE 0xFFFFFFFFu
#define TOMB_WORD 0xFFFFFFFFu

struct Key4 {
  uint32_t k[4];
};

__device__ __forceinline__ Key4 key_at(const uint32_t* row_words) {
  uint4 v = *reinterpret_cast<const uint4*>(row_words);
  return Key4{{v.x, v.y, v.z, v.w}};
}

// The same past L1 (a table that another block of the launch writes).
__device__ __forceinline__ Key4 key_at_cg(const uint32_t* row_words) {
  uint4 v = __ldcg(reinterpret_cast<const uint4*>(row_words));
  return Key4{{v.x, v.y, v.z, v.w}};
}

__device__ __forceinline__ Key4 key_in(const Row& r, int w) {
  return Key4{{r.w[w], r.w[w + 1], r.w[w + 2], r.w[w + 3]}};
}

__device__ __forceinline__ Key4 key_of(u128 id) {
  uint64_t lo = lo64(id), hi = hi64(id);
  return Key4{{(uint32_t)lo, (uint32_t)(lo >> 32), (uint32_t)hi, (uint32_t)(hi >> 32)}};
}

__device__ __forceinline__ bool key_empty(const Key4& a) {
  return (a.k[0] | a.k[1] | a.k[2] | a.k[3]) == 0u;
}
__device__ __forceinline__ bool key_tomb(const Key4& a) {
  return (a.k[0] & a.k[1] & a.k[2] & a.k[3]) == TOMB_WORD;
}
__device__ __forceinline__ bool key_eq(const Key4& a, const Key4& b) {
  return a.k[0] == b.k[0] && a.k[1] == b.k[1] && a.k[2] == b.k[2] && a.k[3] == b.k[3];
}

struct Probe {
  uint32_t base, step, mask;
  __device__ __forceinline__ uint32_t at(int j) const { return (base + (uint32_t)j * step) & mask; }
};

// splitmix64 finalizer over both id limbs (base) and a second hash (step).
__device__ __forceinline__ Probe probe_of(const Key4& key, int cap_log2) {
  uint64_t lo = (uint64_t)key.k[0] | ((uint64_t)key.k[1] << 32);
  uint64_t hi = (uint64_t)key.k[2] | ((uint64_t)key.k[3] << 32);
  uint64_t mask = (1ull << cap_log2) - 1;
  uint64_t x = lo ^ (hi * 0x9E3779B97F4A7C15ull);
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  x = x ^ (x >> 31);
  uint64_t y = (lo ^ 0x6A09E667F3BCC909ull) * 0xD1B54A32D192ED03ull;
  y = y ^ (hi * 0xD1B54A32D192ED03ull) ^ (y >> 31);
  y = (y ^ (y >> 29)) * 0xBF58476D1CE4E5B9ull;
  y = y ^ (y >> 32);
  return Probe{(uint32_t)(x & mask), (uint32_t)((y & mask) | 1ull), (uint32_t)mask};
}

struct Found {
  int64_t slot;
  bool found, resolved;
};

// ops/hashtable.py `lookup` for one key: the first hit before the first
// empty slot; else the first free slot (the insert target), resolved iff an
// empty slot ended the chain; unresolved lanes return the first free slot,
// else the last probe.
__device__ __forceinline__ Found table_lookup(const uint32_t* rows, int cap_log2,
                                              const Key4& key, int window) {
  Probe pr = probe_of(key, cap_log2);
  bool probeable = !key_empty(key) && !key_tomb(key);
  int64_t free_pos = -1, last = 0;
  for (int j = 0; j < window; j++) {
    uint32_t p = pr.at(j);
    Key4 k = key_at(rows + (size_t)p * ROW_WORDS);
    if (probeable && key_eq(k, key)) return Found{(int64_t)p, true, true};
    bool empty = key_empty(k);
    if (free_pos < 0 && (empty || key_tomb(k))) free_pos = p;
    if (empty) return Found{free_pos, false, true};
    last = p;
  }
  return Found{free_pos >= 0 ? free_pos : last, false, false};
}

// ops/hashtable.py `probe_free`: the first free probe position of a key
// known to be absent (the serial tier's insert target).
__device__ __forceinline__ Found table_probe_free(const uint32_t* rows, int cap_log2,
                                                  const Key4& key, int window) {
  Probe pr = probe_of(key, cap_log2);
  uint32_t p = 0;
  for (int j = 0; j < window; j++) {
    p = pr.at(j);
    Key4 k = key_at(rows + (size_t)p * ROW_WORDS);
    if (key_empty(k) || key_tomb(k)) return Found{(int64_t)p, false, true};
  }
  return Found{(int64_t)p, false, false};
}

// Scratch carving: the wrapper allocates one byte buffer per launch and the
// C entry point cuts it into 256-byte aligned arrays.
struct Carver {
  char* base;
  size_t off;
  template <typename T>
  T* take(size_t count) {
    off = (off + 255) & ~(size_t)255;
    T* p = reinterpret_cast<T*>(reinterpret_cast<uintptr_t>(base) + off);
    off += count * sizeof(T);
    return p;
  }
};

// Launch helpers shared by the kernels' C entry points.
#define LANES_PER_BLOCK 256
static inline int grid_for(long long lanes) {
  long long g = (lanes + LANES_PER_BLOCK - 1) / LANES_PER_BLOCK;
  return g > 0 ? (int)g : 1;
}
