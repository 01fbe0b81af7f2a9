// Exact u128 arithmetic for the ledger kernels (the counterpart of
// tigerbeetle_tpu/ops/u128.py and of the port's ops/u128.py, which carry a
// u128 as two u64 limbs). The card has native 64-bit integer lanes, and
// nvcc lowers unsigned __int128 to pairs of them, so the helpers here are
// the plain operators plus the overflow tests the ladders need.
#pragma once
#include <cstdint>

typedef unsigned __int128 u128;

#define U64_ONES 0xFFFFFFFFFFFFFFFFull

__device__ __forceinline__ u128 mk128(uint64_t lo, uint64_t hi) {
  return ((u128)hi << 64) | (u128)lo;
}
__device__ __forceinline__ uint64_t lo64(u128 x) { return (uint64_t)x; }
__device__ __forceinline__ uint64_t hi64(u128 x) { return (uint64_t)(x >> 64); }

__device__ __forceinline__ bool is_max128(u128 x) {
  return lo64(x) == U64_ONES && hi64(x) == U64_ONES;
}

// reference: src/state_machine.zig:1152-1157 (u128 instantiation)
__device__ __forceinline__ bool sum_overflows(u128 a, u128 b) { return a + b < a; }

// reference: src/state_machine.zig:1152-1157 (u64 instantiation)
__device__ __forceinline__ bool sum_overflows_u64(uint64_t a, uint64_t b) {
  return a + b < a;
}

// max(0, a - b)
__device__ __forceinline__ u128 sat_sub(u128 a, u128 b) { return a < b ? (u128)0 : a - b; }

__device__ __forceinline__ u128 min128(u128 a, u128 b) { return a < b ? a : b; }
