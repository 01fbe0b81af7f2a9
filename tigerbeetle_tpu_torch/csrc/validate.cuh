// The validation ladders of tigerbeetle_tpu/models/validate.py (and of the
// port's models/validate.py) for one lane: the exact result-code precedence
// of the reference (src/state_machine.zig:738-1077). The fast transfer
// kernel, both serial kernels and the account kernels call these same
// functions, so the tiers cannot drift, as in the JAX package.
//
// First match wins: SET(cond, code) assigns only while the result is 0.
#pragma once
#include <cstdint>

#include "rows.cuh"

#define SET(cond, code) \
  do {                  \
    if (r == 0u && (cond)) r = (code); \
  } while (0)

// reference: src/state_machine.zig:779-787
__device__ __forceinline__ uint32_t transfer_common(const Xfer& e, uint32_t r) {
  SET((e.flags & TRANSFER_FLAGS_PADDING) != 0u, 4u);
  SET(e.id == 0, 5u);
  SET(is_max128(e.id), 6u);
  return r;
}

// reference: src/state_machine.zig:886-905
__device__ __forceinline__ uint32_t transfer_exists_code(const Xfer& e, const Xfer& ex) {
  uint32_t r = 0u;
  SET(e.flags != ex.flags, 36u);
  SET(e.dr != ex.dr, 37u);
  SET(e.cr != ex.cr, 38u);
  SET(e.amt != ex.amt, 39u);
  SET(e.ud128 != ex.ud128, 41u);
  SET(e.ud64 != ex.ud64, 42u);
  SET(e.ud32 != ex.ud32, 43u);
  SET(e.timeout != ex.timeout, 44u);
  SET(e.code != ex.code, 45u);
  SET(true, 46u);
  return r;
}

// reference: src/state_machine.zig:789-884. `e.ts` is the event's commit
// timestamp. Returns the code; *amt_out is the (clamped) amount to apply.
__device__ __forceinline__ uint32_t validate_simple_transfer(uint32_t r, const Xfer& e,
                                                             const Acct& dr, const Acct& cr,
                                                             bool dr_found, bool cr_found,
                                                             const Xfer& ex, bool ex_found,
                                                             u128* amt_out) {
  bool pending = (e.flags & F_PENDING) != 0u;
  bool bal_dr = (e.flags & F_BAL_DR) != 0u;
  bool bal_cr = (e.flags & F_BAL_CR) != 0u;
  SET(e.dr == 0, 8u);
  SET(is_max128(e.dr), 9u);
  SET(e.cr == 0, 10u);
  SET(is_max128(e.cr), 11u);
  SET(e.cr == e.dr, 12u);
  SET(e.pid != 0, 13u);
  SET(!pending && e.timeout != 0u, 17u);
  SET(!bal_dr && !bal_cr && e.amt == 0, 18u);
  SET(e.ledger == 0u, 19u);
  SET(e.code == 0u, 20u);
  SET(!dr_found, 21u);
  SET(!cr_found, 22u);
  SET(dr_found && cr_found && dr.ledger != cr.ledger, 23u);
  SET(dr_found && e.ledger != dr.ledger, 24u);
  if (r == 0u && ex_found) r = transfer_exists_code(e, ex);

  // Balancing clamp (reference: :826-846); amount 0 with a balancing flag
  // means "as much as possible", sentinel u64 max (:829).
  u128 amt = e.amt;
  if ((bal_dr || bal_cr) && amt == 0) amt = (u128)U64_ONES;
  u128 dr_bal = dr.dp + dr.dpo;
  if (bal_dr) amt = min128(amt, sat_sub(dr.cpo, dr_bal));
  SET(bal_dr && amt == 0, 54u);
  u128 cr_bal = cr.cp + cr.cpo;
  if (bal_cr) amt = min128(amt, sat_sub(cr.dpo, cr_bal));
  SET(bal_cr && amt == 0, 55u);

  // Overflow checks (reference: :848-862).
  SET(pending && sum_overflows(amt, dr.dp), 47u);
  SET(pending && sum_overflows(amt, cr.cp), 48u);
  SET(sum_overflows(amt, dr.dpo), 49u);
  SET(sum_overflows(amt, cr.cpo), 50u);
  SET(sum_overflows(amt, dr_bal), 51u);
  SET(sum_overflows(amt, cr_bal), 52u);
  SET(sum_overflows_u64(e.ts, (uint64_t)e.timeout * NS_PER_S), 53u);

  // Balance-limit invariants (reference: src/tigerbeetle.zig:31-39).
  SET((dr.flags & A_DR_LIMIT) != 0u && dr_bal + amt > dr.cpo, 54u);
  SET((cr.flags & A_CR_LIMIT) != 0u && cr_bal + amt > cr.dpo, 55u);
  *amt_out = amt;
  return r;
}

// reference: src/state_machine.zig:1016-1077
__device__ __forceinline__ uint32_t post_void_exists_code(const Xfer& e, const Xfer& ex,
                                                          const Xfer& p) {
  uint32_t r = 0u;
  SET(e.flags != ex.flags, 36u);
  SET((e.amt == 0 ? p.amt : e.amt) != ex.amt, 39u);
  SET(e.pid != ex.pid, 40u);
  SET((e.ud128 == 0 ? p.ud128 : e.ud128) != ex.ud128, 41u);
  SET((e.ud64 == 0 ? p.ud64 : e.ud64) != ex.ud64, 42u);
  SET((e.ud32 == 0u ? p.ud32 : e.ud32) != ex.ud32, 43u);
  SET(true, 46u);
  return r;
}

// reference: src/state_machine.zig:907-1014. `p_fulfill` is the pending's
// fulfill word (1 posted, 2 voided). Returns the code; *amt_out is the
// posted amount.
__device__ __forceinline__ uint32_t validate_post_void(uint32_t r, const Xfer& e, const Xfer& p,
                                                       uint32_t p_fulfill, bool p_found,
                                                       const Xfer& ex, bool ex_found,
                                                       u128* amt_out) {
  bool is_post = (e.flags & F_POST) != 0u;
  bool is_void = (e.flags & F_VOID) != 0u;
  SET(is_post && is_void, 7u);
  SET((e.flags & F_PENDING) != 0u, 7u);
  SET((e.flags & F_BAL_DR) != 0u, 7u);
  SET((e.flags & F_BAL_CR) != 0u, 7u);
  SET(e.pid == 0, 14u);
  SET(is_max128(e.pid), 15u);
  SET(e.pid == e.id, 16u);
  SET(e.timeout != 0u, 17u);
  SET(!p_found, 25u);
  SET((p.flags & F_PENDING) == 0u, 26u);
  SET(e.dr != 0 && e.dr != p.dr, 27u);
  SET(e.cr != 0 && e.cr != p.cr, 28u);
  SET(e.ledger != 0u && e.ledger != p.ledger, 29u);
  SET(e.code != 0u && e.code != p.code, 30u);
  u128 amt = e.amt == 0 ? p.amt : e.amt;
  SET(amt > p.amt, 31u);
  SET(is_void && amt < p.amt, 32u);
  if (r == 0u && ex_found) r = post_void_exists_code(e, ex, p);
  SET(p_fulfill == 1u, 33u);
  SET(p_fulfill == 2u, 34u);
  uint64_t timeout_ns = (uint64_t)p.timeout * NS_PER_S;
  SET(p.timeout != 0u && e.ts >= p.ts + timeout_ns, 35u);
  *amt_out = amt;
  return r;
}

// reference: src/state_machine.zig:767-777
__device__ __forceinline__ uint32_t account_exists_code(const Acct& e, const Acct& ex) {
  uint32_t r = 0u;
  SET(e.flags != ex.flags, 15u);
  SET(e.ud128 != ex.ud128, 16u);
  SET(e.ud64 != ex.ud64, 17u);
  SET(e.ud32 != ex.ud32, 18u);
  SET(e.ledger != ex.ledger, 19u);
  SET(e.code != ex.code, 20u);
  SET(true, 21u);
  return r;
}

// reference: src/state_machine.zig:738-765
__device__ __forceinline__ uint32_t validate_create_account(uint32_t r, const Acct& e,
                                                            const Acct& ex, bool ex_found) {
  SET(e.reserved != 0u, 4u);
  SET((e.flags & ACCOUNT_FLAGS_PADDING) != 0u, 5u);
  SET(e.id == 0, 6u);
  SET(is_max128(e.id), 7u);
  SET((e.flags & A_DR_LIMIT) != 0u && (e.flags & A_CR_LIMIT) != 0u, 8u);
  SET(e.dp != 0, 9u);
  SET(e.dpo != 0, 10u);
  SET(e.cp != 0, 11u);
  SET(e.cpo != 0, 12u);
  SET(e.ledger == 0u, 13u);
  SET(e.code == 0u, 14u);
  if (r == 0u && ex_found) r = account_exists_code(e, ex);
  return r;
}

#undef SET
