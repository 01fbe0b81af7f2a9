// The state fingerprint's per-row hash: the exact _fp_mix / _fp_rows of
// tigerbeetle_tpu/models/ledger.py:318-347, for one 128-byte row.
//
// The digest of a table is the wrapping u64 sum of this hash over its live
// rows (neither empty nor tombstone). The constants are shared with the
// native engine's tb_ledger_fingerprint: change none of them alone.
#pragma once
#include <cstdint>

#include "rows.cuh"

#define FP_SEED 0x9E3779B97F4A7C15ull
#define FP_MUL 0xC2B2AE3D27D4EB4Full
#define FP_ADD 0x165667B19E3779F9ull
#define FP_MIX1 0xFF51AFD7ED558CCDull
#define FP_MIX2 0xC4CEB9FE1A85EC53ull

__device__ __forceinline__ uint64_t fp_mix(uint64_t x) {
  x = (x ^ (x >> 33)) * FP_MIX1;
  x = (x ^ (x >> 33)) * FP_MIX2;
  return x ^ (x >> 33);
}

// A chain over the 32 words in order: each word enters through a multiply
// and the state turns by 27 bits between words.
__device__ __forceinline__ uint64_t fp_row_hash(const Row& r) {
  uint64_t h = FP_SEED;
#pragma unroll
  for (int i = 0; i < ROW_WORDS; i++) {
    h ^= (uint64_t)r.w[i] * FP_MUL;
    h = ((h << 27) | (h >> 37)) * FP_SEED + FP_ADD;
  }
  return fp_mix(h);
}
