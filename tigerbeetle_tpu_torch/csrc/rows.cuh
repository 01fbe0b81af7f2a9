// 128-byte wire rows as 32 u32 words (reference: src/tigerbeetle.zig:7-40
// Account, :64-89 Transfer; the counterpart of the row codecs in
// models/ledger.py). Rows are 128-byte aligned in every table and batch, so
// a row moves as eight 16-byte vector loads or stores.
#pragma once
#include <cstdint>

#include "u128.cuh"

#define ROW_WORDS 32

// Transfer flag bits (reference: src/tigerbeetle.zig:91-104).
#define F_LINKED 1u
#define F_PENDING 2u
#define F_POST 4u
#define F_VOID 8u
#define F_BAL_DR 16u
#define F_BAL_CR 32u
#define TRANSFER_FLAGS_PADDING (0xFFFFu & ~0x3Fu)
// Account flag bits (reference: src/tigerbeetle.zig:42-62).
#define A_LINKED 1u
#define A_DR_LIMIT 2u
#define A_CR_LIMIT 4u
#define ACCOUNT_FLAGS_PADDING (0xFFFFu & ~0x7u)

// Sticky fault bits (models/ledger.py "Fault protocol").
#define FAULT_PROBE 1u
#define FAULT_CLAIM 2u
#define FAULT_OVERFLOW 4u
#define FAULT_SERIAL 8u
#define FAULT_CAPACITY 16u
#define FAULT_INSTALL (1u << 30)

#define NS_PER_S 1000000000ull

struct Row {
  uint32_t w[ROW_WORDS];
};

struct Xfer {
  u128 id, dr, cr, amt, pid, ud128;
  uint64_t ud64, ts;
  uint32_t ud32, timeout, ledger, code, flags;
};

struct Acct {
  u128 id, dp, dpo, cp, cpo, ud128;
  uint64_t ud64, ts;
  uint32_t ud32, reserved, ledger, code, flags;
};

__device__ __forceinline__ Row load_row(const uint32_t* p) {
  Row r;
  const uint4* s = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int k = 0; k < 8; k++) {
    uint4 v = s[k];
    r.w[4 * k] = v.x;
    r.w[4 * k + 1] = v.y;
    r.w[4 * k + 2] = v.z;
    r.w[4 * k + 3] = v.w;
  }
  return r;
}

__device__ __forceinline__ void store_row(uint32_t* p, const Row& r) {
  uint4* d = reinterpret_cast<uint4*>(p);
#pragma unroll
  for (int k = 0; k < 8; k++) {
    d[k] = make_uint4(r.w[4 * k], r.w[4 * k + 1], r.w[4 * k + 2], r.w[4 * k + 3]);
  }
}

__device__ __forceinline__ uint64_t w64(const Row& r, int i) {
  return (uint64_t)r.w[i] | ((uint64_t)r.w[i + 1] << 32);
}
__device__ __forceinline__ u128 w128(const Row& r, int i) {
  return mk128(w64(r, i), w64(r, i + 2));
}
__device__ __forceinline__ void put64(Row& r, int i, uint64_t x) {
  r.w[i] = (uint32_t)x;
  r.w[i + 1] = (uint32_t)(x >> 32);
}
__device__ __forceinline__ void put128(Row& r, int i, u128 x) {
  put64(r, i, lo64(x));
  put64(r, i + 2, hi64(x));
}

__device__ __forceinline__ Xfer unpack_transfer(const Row& r) {
  Xfer t;
  t.id = w128(r, 0);
  t.dr = w128(r, 4);
  t.cr = w128(r, 8);
  t.amt = w128(r, 12);
  t.pid = w128(r, 16);
  t.ud128 = w128(r, 20);
  t.ud64 = w64(r, 24);
  t.ud32 = r.w[26];
  t.timeout = r.w[27];
  t.ledger = r.w[28];
  t.code = r.w[29] & 0xFFFFu;
  t.flags = r.w[29] >> 16;
  t.ts = w64(r, 30);
  return t;
}

__device__ __forceinline__ Row pack_transfer(const Xfer& t) {
  Row r;
  put128(r, 0, t.id);
  put128(r, 4, t.dr);
  put128(r, 8, t.cr);
  put128(r, 12, t.amt);
  put128(r, 16, t.pid);
  put128(r, 20, t.ud128);
  put64(r, 24, t.ud64);
  r.w[26] = t.ud32;
  r.w[27] = t.timeout;
  r.w[28] = t.ledger;
  r.w[29] = (t.code & 0xFFFFu) | (t.flags << 16);
  put64(r, 30, t.ts);
  return r;
}

__device__ __forceinline__ Acct unpack_account(const Row& r) {
  Acct a;
  a.id = w128(r, 0);
  a.dp = w128(r, 4);
  a.dpo = w128(r, 8);
  a.cp = w128(r, 12);
  a.cpo = w128(r, 16);
  a.ud128 = w128(r, 20);
  a.ud64 = w64(r, 24);
  a.ud32 = r.w[26];
  a.reserved = r.w[27];
  a.ledger = r.w[28];
  a.code = r.w[29] & 0xFFFFu;
  a.flags = r.w[29] >> 16;
  a.ts = w64(r, 30);
  return a;
}

__device__ __forceinline__ Row pack_account(const Acct& a) {
  Row r;
  put128(r, 0, a.id);
  put128(r, 4, a.dp);
  put128(r, 8, a.dpo);
  put128(r, 12, a.cp);
  put128(r, 16, a.cpo);
  put128(r, 20, a.ud128);
  put64(r, 24, a.ud64);
  r.w[26] = a.ud32;
  r.w[27] = a.reserved;
  r.w[28] = a.ledger;
  r.w[29] = (a.code & 0xFFFFu) | (a.flags << 16);
  put64(r, 30, a.ts);
  return r;
}

// The row an event stores: post/void events inherit the pending's routing
// fields, default their user data from it and persist the resolved amount
// (reference: src/state_machine.zig:907-1014; build_stored_transfer).
__device__ __forceinline__ Xfer build_stored_transfer(const Xfer& e, const Xfer& p, bool is_pv,
                                                      u128 amt, uint64_t ts) {
  Xfer s = e;
  if (is_pv) {
    s.dr = p.dr;
    s.cr = p.cr;
    if (e.ud128 == 0) s.ud128 = p.ud128;
    if (e.ud64 == 0) s.ud64 = p.ud64;
    if (e.ud32 == 0) s.ud32 = p.ud32;
    s.timeout = 0;
    s.ledger = p.ledger;
    s.code = p.code;
  }
  s.amt = amt;
  s.ts = ts;
  return s;
}

// u64 scalars of the state live in int64 tensors; the kernels use them as
// unsigned 64-bit words with the same bits.
typedef unsigned long long ull;
