// Group probes: the batched lookups K1 (lookup.cu) and K11l
// (mesh_lookup.cu), eight threads (a quarter warp) a key.
//
// A lookup is a chain of dependent loads: the key, each probe's key words,
// and then the row of the slot the chain ends on. A thread a key reads a
// probe's key sector and, after the chain, the slot's 128-byte row: one
// more trip to device memory. Here the eight threads of a group read the
// probed slot's whole row at every probe, 16 bytes each, so the row comes
// in one 128-byte request together with its key words. The first thread
// decides the probe from words 0-3 and shares the verdict by __shfl_sync;
// the group keeps in registers (four words a thread) the row the lookup
// returns and writes it from there, with no trip after the chain. The
// answer is table_lookup's (hash.cuh) for every key: found and resolved as
// it has them, and the row of the slot it returns (the hit; else the first
// free probe, empty or tombstone, whose stale words are part of the answer;
// else, in an unresolved window with no free slot, the last probe).
#pragma once
#include <cstdint>

#include "hash.cuh"

#define GROUP_LANES 8

// A probe's verdict, as the group's first thread shares it.
#define PROBE_OTHER 0
#define PROBE_HIT 1
#define PROBE_EMPTY 2
#define PROBE_TOMB 3

struct GroupFound {
  uint4 part;  // this thread's 16 bytes of the row the lookup returns
  bool found, resolved;
};

// The group of thread `threadIdx.x`: its key (one per GROUP_LANES threads
// of the grid), its lane in the group and the group's lanes in the warp.
// Blocks hold whole warps, so a group never straddles two.
struct Group {
  long long key;
  int lane;
  unsigned mask;
};

__device__ __forceinline__ Group group_of_thread() {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  return Group{t / GROUP_LANES, (int)(threadIdx.x % GROUP_LANES),
               0xFFu << (threadIdx.x & 31u & ~(unsigned)(GROUP_LANES - 1))};
}

// ops/hashtable.py `lookup` of `key` (held by every thread of the group)
// in `rows` with its row gather. The tables are not written during the
// launch, so the rows go through the read-only path.
__device__ __forceinline__ GroupFound group_lookup(const uint32_t* __restrict__ rows,
                                                   int cap_log2, const Key4& key, int window,
                                                   const Group& g) {
  Probe pr = probe_of(key, cap_log2);
  bool probeable = !key_empty(key) && !key_tomb(key);
  uint4 keep = make_uint4(0u, 0u, 0u, 0u);
  bool have_free = false;
  for (int j = 0; j < window; j++) {
    const uint4* row = reinterpret_cast<const uint4*>(rows + (size_t)pr.at(j) * ROW_WORDS);
    uint4 v = __ldg(row + g.lane);
    int verdict = PROBE_OTHER;
    if (g.lane == 0) {
      Key4 k = {{v.x, v.y, v.z, v.w}};
      verdict = probeable && key_eq(k, key) ? PROBE_HIT
                : key_empty(k)              ? PROBE_EMPTY
                : key_tomb(k)               ? PROBE_TOMB
                                            : PROBE_OTHER;
    }
    verdict = __shfl_sync(g.mask, verdict, 0, GROUP_LANES);
    if (verdict == PROBE_HIT) return GroupFound{v, true, true};
    if (!have_free) keep = v;
    if (verdict == PROBE_EMPTY) return GroupFound{keep, false, true};
    have_free |= verdict == PROBE_TOMB;
  }
  return GroupFound{keep, false, false};
}

// A lookup's one output buffer (kernels.lookup_views reads it so): B rows
// of 128 bytes, then B found bytes, then B resolved bytes. Each thread
// writes its 16 bytes of key i's row; the first writes the two flags.
__device__ __forceinline__ void group_store(uint8_t* __restrict__ out, int B, long long i,
                                            const Group& g, const uint4& part, bool found,
                                            bool resolved) {
  reinterpret_cast<uint4*>(out)[(size_t)i * GROUP_LANES + g.lane] = part;
  if (g.lane == 0) {
    out[(size_t)B * ROW_WORDS * 4 + i] = found;
    out[(size_t)B * (ROW_WORDS * 4 + 1) + i] = resolved;
  }
}

static inline int group_grid_for(int B) { return grid_for((long long)B * GROUP_LANES); }
