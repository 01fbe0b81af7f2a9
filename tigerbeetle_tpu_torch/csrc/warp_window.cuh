// One probe window of 64 positions loaded by a whole warp (positions j and
// j + 32 in lane j) and decided with ballots: what `table_lookup` and
// `table_probe_free` (hash.cuh) decide from it, in one device-memory trip
// instead of a chain of up to 64. Shared by the serial transfer walk
// (serial_walk.cuh: K4, K11ts) and the serial account walk
// (account_walk.cuh: K2 serial, K11as).
#pragma once
#include <cstdint>

#include "hash.cuh"

#define WALK_FULL 0xFFFFFFFFu

static_assert(WINDOW_SCALAR == 64, "a warp probes a window as two positions a lane");

struct WalkWin {
  Probe pr;
  int64_t sb;
  uint4 a, b;  // the key words at probe positions lane and lane + 32
};

// With CG, the loads bypass L1 (ld.global.cg): a table this launch writes.
template <bool CG = false>
__device__ __forceinline__ WalkWin win_load(const uint32_t* rows, int log2, int64_t sb,
                                            const Key4& key, int lane) {
  WalkWin w;
  w.pr = probe_of(key, log2);
  w.sb = sb;
  const uint4* a =
      reinterpret_cast<const uint4*>(rows + (size_t)(sb + w.pr.at(lane)) * ROW_WORDS);
  const uint4* b =
      reinterpret_cast<const uint4*>(rows + (size_t)(sb + w.pr.at(lane + 32)) * ROW_WORDS);
  w.a = CG ? __ldcg(a) : *a;
  w.b = CG ? __ldcg(b) : *b;
  return w;
}

__device__ __forceinline__ uint64_t ballot64(bool lo, bool hi) {
  return (uint64_t)__ballot_sync(WALK_FULL, lo) | ((uint64_t)__ballot_sync(WALK_FULL, hi) << 32);
}

__device__ __forceinline__ int first_bit(uint64_t m) { return m ? __ffsll((long long)m) - 1 : 64; }

// The window positions that decide both probes, WINDOW_SCALAR where there is
// none: the first hit of a probeable key (neither all zero nor all ones),
// the first empty slot, the first free (empty or tombstone) slot.
// table_lookup finds the key iff h < e, resolves iff it finds it or e < 64;
// table_probe_free returns position f, or the last probe where f == 64.
struct WinIdx {
  int h, e, f;
};

__device__ __forceinline__ WinIdx win_index(const WalkWin& w, const Key4& key) {
  bool probeable = !key_empty(key) && !key_tomb(key);
  Key4 ka{{w.a.x, w.a.y, w.a.z, w.a.w}};
  Key4 kb{{w.b.x, w.b.y, w.b.z, w.b.w}};
  uint64_t hit = ballot64(probeable && key_eq(ka, key), probeable && key_eq(kb, key));
  uint64_t emp = ballot64(key_empty(ka), key_empty(kb));
  uint64_t fre = emp | ballot64(key_tomb(ka), key_tomb(kb));
  return WinIdx{first_bit(hit), first_bit(emp), first_bit(fre)};
}
