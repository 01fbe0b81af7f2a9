"""Validation ladders of the ledger state machine on int64 torch lanes.

The counterpart of `tigerbeetle_tpu/models/validate.py`: the exact
result-code precedence of the reference (src/state_machine.zig:738-1077
create_account / create_transfer / post_or_void_pending_transfer and the
exists-check helpers), shared by the plain fast and serial commits in
models/ledger.py. The CUDA kernels carry the same ladders in
`csrc/validate.cuh`, shared by all of them in turn.

Inputs are dicts of per-lane int64 tensors (`unpack_transfer` /
`unpack_account`): u64 fields hold their 64 bits, u32 and u16 fields their
value. `dr`/`cr`/`ex`/`p` are gathered store rows (garbage where the
matching *_found flag is False; every use is gated). Result codes are int64.
"""

from __future__ import annotations

import torch

from tigerbeetle_tpu_torch.constants import NS_PER_S
from tigerbeetle_tpu_torch.ops import u128

# Transfer flag bits (reference: src/tigerbeetle.zig:91-104).
F_LINKED = 1
F_PENDING = 2
F_POST = 4
F_VOID = 8
F_BAL_DR = 16
F_BAL_CR = 32
TRANSFER_FLAGS_PADDING = 0xFFFF & ~0b111111

# Account flag bits (reference: src/tigerbeetle.zig:42-62).
A_LINKED = 1
A_DR_LIMIT = 2  # debits_must_not_exceed_credits
A_CR_LIMIT = 4  # credits_must_not_exceed_debits
ACCOUNT_FLAGS_PADDING = 0xFFFF & ~0b111


class Ladder:
    """First-match-wins result-code accumulator."""

    def __init__(self, r0):
        self.r = r0

    def set(self, cond, code: int):
        self.r = torch.where((self.r == 0) & cond, code, self.r)

    def merge(self, other_r):
        self.r = torch.where(self.r == 0, other_r, self.r)


def transfer_common(ev, r0):
    """Checks shared by the simple and post/void branches
    (reference: src/state_machine.zig:779-787)."""
    lad = Ladder(r0)
    lad.set((ev["flags"] & TRANSFER_FLAGS_PADDING) != 0, 4)  # reserved_flag
    lad.set(u128.is_zero(ev["id_lo"], ev["id_hi"]), 5)  # id_must_not_be_zero
    lad.set(u128.is_max(ev["id_lo"], ev["id_hi"]), 6)  # id_must_not_be_int_max
    return lad.r


def transfer_exists_code(ev, ex):
    """reference: src/state_machine.zig:886-905 (simple-transfer exists)."""
    lad = Ladder(torch.zeros_like(ev["flags"]))
    lad.set(ev["flags"] != ex["flags"], 36)
    lad.set(~u128.eq(ev["dr_lo"], ev["dr_hi"], ex["dr_lo"], ex["dr_hi"]), 37)
    lad.set(~u128.eq(ev["cr_lo"], ev["cr_hi"], ex["cr_lo"], ex["cr_hi"]), 38)
    lad.set(~u128.eq(ev["amt_lo"], ev["amt_hi"], ex["amt_lo"], ex["amt_hi"]), 39)
    lad.set(~u128.eq(ev["ud128_lo"], ev["ud128_hi"], ex["ud128_lo"], ex["ud128_hi"]), 41)
    lad.set(ev["ud64"] != ex["ud64"], 42)
    lad.set(ev["ud32"] != ex["ud32"], 43)
    lad.set(ev["timeout"] != ex["timeout"], 44)
    lad.set(ev["code"] != ex["code"], 45)
    lad.set(torch.ones_like(ev["flags"], dtype=torch.bool), 46)  # exists
    return lad.r


def validate_simple_transfer(r0, ev, dr, cr, dr_found, cr_found, ex, ex_found):
    """The non-post/void create_transfer path
    (reference: src/state_machine.zig:789-884). Returns (result, amt_lo, amt_hi)
    where amt is the clamped amount to apply when result == 0."""
    flags = ev["flags"]
    pending = (flags & F_PENDING) != 0
    bal_dr = (flags & F_BAL_DR) != 0
    bal_cr = (flags & F_BAL_CR) != 0

    lad = Ladder(r0)
    lad.set(u128.is_zero(ev["dr_lo"], ev["dr_hi"]), 8)
    lad.set(u128.is_max(ev["dr_lo"], ev["dr_hi"]), 9)
    lad.set(u128.is_zero(ev["cr_lo"], ev["cr_hi"]), 10)
    lad.set(u128.is_max(ev["cr_lo"], ev["cr_hi"]), 11)
    lad.set(u128.eq(ev["cr_lo"], ev["cr_hi"], ev["dr_lo"], ev["dr_hi"]), 12)
    lad.set(~u128.is_zero(ev["pid_lo"], ev["pid_hi"]), 13)  # pending_id_must_be_zero
    lad.set(~pending & (ev["timeout"] != 0), 17)
    lad.set(
        ~bal_dr & ~bal_cr & u128.is_zero(ev["amt_lo"], ev["amt_hi"]), 18
    )  # amount_must_not_be_zero
    lad.set(ev["ledger"] == 0, 19)
    lad.set(ev["code"] == 0, 20)
    lad.set(~dr_found, 21)
    lad.set(~cr_found, 22)
    lad.set(dr_found & cr_found & (dr["ledger"] != cr["ledger"]), 23)
    lad.set(dr_found & (ev["ledger"] != dr["ledger"]), 24)
    lad.merge(torch.where(ex_found, transfer_exists_code(ev, ex), 0))

    # Balancing clamp (reference: src/state_machine.zig:826-846). amount==0 with
    # a balancing flag means "as much as possible", sentinel u64 max (:829).
    amt_lo, amt_hi = ev["amt_lo"], ev["amt_hi"]
    use_sentinel = (bal_dr | bal_cr) & u128.is_zero(amt_lo, amt_hi)
    amt_lo = torch.where(use_sentinel, u128.U64_ONES, amt_lo)
    amt_hi = torch.where(use_sentinel, 0, amt_hi)

    # dr_balance = dr.debits_pending + dr.debits_posted (never overflows by the
    # overflows_debits invariant enforced at every prior commit).
    dr_bal_lo, dr_bal_hi, _ = u128.add(dr["dp_lo"], dr["dp_hi"], dr["dpo_lo"], dr["dpo_hi"])
    dr_avail_lo, dr_avail_hi = u128.sat_sub(dr["cpo_lo"], dr["cpo_hi"], dr_bal_lo, dr_bal_hi)
    c_lo, c_hi = u128.min_(amt_lo, amt_hi, dr_avail_lo, dr_avail_hi)
    amt_lo, amt_hi = u128.select(bal_dr, c_lo, c_hi, amt_lo, amt_hi)
    lad.set(bal_dr & u128.is_zero(amt_lo, amt_hi), 54)  # exceeds_credits

    cr_bal_lo, cr_bal_hi, _ = u128.add(cr["cp_lo"], cr["cp_hi"], cr["cpo_lo"], cr["cpo_hi"])
    cr_avail_lo, cr_avail_hi = u128.sat_sub(cr["dpo_lo"], cr["dpo_hi"], cr_bal_lo, cr_bal_hi)
    c_lo, c_hi = u128.min_(amt_lo, amt_hi, cr_avail_lo, cr_avail_hi)
    amt_lo, amt_hi = u128.select(bal_cr, c_lo, c_hi, amt_lo, amt_hi)
    lad.set(bal_cr & u128.is_zero(amt_lo, amt_hi), 55)  # exceeds_debits

    # Overflow checks (reference: src/state_machine.zig:848-862).
    lad.set(pending & u128.sum_overflows(amt_lo, amt_hi, dr["dp_lo"], dr["dp_hi"]), 47)
    lad.set(pending & u128.sum_overflows(amt_lo, amt_hi, cr["cp_lo"], cr["cp_hi"]), 48)
    lad.set(u128.sum_overflows(amt_lo, amt_hi, dr["dpo_lo"], dr["dpo_hi"]), 49)
    lad.set(u128.sum_overflows(amt_lo, amt_hi, cr["cpo_lo"], cr["cpo_hi"]), 50)
    lad.set(u128.sum_overflows(amt_lo, amt_hi, dr_bal_lo, dr_bal_hi), 51)
    lad.set(u128.sum_overflows(amt_lo, amt_hi, cr_bal_lo, cr_bal_hi), 52)
    lad.set(
        u128.sum_overflows_u64(ev["ts"], ev["timeout"] * NS_PER_S),
        53,
    )

    # Balance-limit invariants (reference: src/tigerbeetle.zig:31-39; checked
    # after the overflow codes, so the sums below cannot wrap when reached).
    dr_tot_lo, dr_tot_hi, _ = u128.add(dr_bal_lo, dr_bal_hi, amt_lo, amt_hi)
    dr_limited = (dr["flags"] & A_DR_LIMIT) != 0
    lad.set(
        dr_limited & u128.gt(dr_tot_lo, dr_tot_hi, dr["cpo_lo"], dr["cpo_hi"]), 54
    )  # exceeds_credits
    cr_tot_lo, cr_tot_hi, _ = u128.add(cr_bal_lo, cr_bal_hi, amt_lo, amt_hi)
    cr_limited = (cr["flags"] & A_CR_LIMIT) != 0
    lad.set(
        cr_limited & u128.gt(cr_tot_lo, cr_tot_hi, cr["dpo_lo"], cr["dpo_hi"]), 55
    )  # exceeds_debits

    return lad.r, amt_lo, amt_hi


def post_void_exists_code(ev, ex, p):
    """reference: src/state_machine.zig:1016-1077."""
    lad = Ladder(torch.zeros_like(ev["flags"]))
    lad.set(ev["flags"] != ex["flags"], 36)
    t_amt_zero = u128.is_zero(ev["amt_lo"], ev["amt_hi"])
    amt_ref_lo = torch.where(t_amt_zero, p["amt_lo"], ev["amt_lo"])
    amt_ref_hi = torch.where(t_amt_zero, p["amt_hi"], ev["amt_hi"])
    lad.set(~u128.eq(amt_ref_lo, amt_ref_hi, ex["amt_lo"], ex["amt_hi"]), 39)
    lad.set(~u128.eq(ev["pid_lo"], ev["pid_hi"], ex["pid_lo"], ex["pid_hi"]), 40)
    ud128_zero = u128.is_zero(ev["ud128_lo"], ev["ud128_hi"])
    ud128_ref_lo = torch.where(ud128_zero, p["ud128_lo"], ev["ud128_lo"])
    ud128_ref_hi = torch.where(ud128_zero, p["ud128_hi"], ev["ud128_hi"])
    lad.set(~u128.eq(ud128_ref_lo, ud128_ref_hi, ex["ud128_lo"], ex["ud128_hi"]), 41)
    ud64_ref = torch.where(ev["ud64"] == 0, p["ud64"], ev["ud64"])
    lad.set(ud64_ref != ex["ud64"], 42)
    ud32_ref = torch.where(ev["ud32"] == 0, p["ud32"], ev["ud32"])
    lad.set(ud32_ref != ex["ud32"], 43)
    lad.set(torch.ones_like(ev["flags"], dtype=torch.bool), 46)
    return lad.r


def validate_post_void(r0, ev, p, p_found, ex, ex_found):
    """The post/void_pending_transfer path
    (reference: src/state_machine.zig:907-1014). `p` is the pending transfer's
    row (including its device-side `fulfill` column, which replaces the
    reference's posted groove). The pending transfer's accounts are not
    validated — only mutated on apply, exactly as the reference.
    Returns (result, amt_lo, amt_hi) — the posted amount."""
    flags = ev["flags"]
    is_post = (flags & F_POST) != 0
    is_void = (flags & F_VOID) != 0

    lad = Ladder(r0)
    lad.set(is_post & is_void, 7)  # flags_are_mutually_exclusive
    lad.set((flags & F_PENDING) != 0, 7)
    lad.set((flags & F_BAL_DR) != 0, 7)
    lad.set((flags & F_BAL_CR) != 0, 7)
    lad.set(u128.is_zero(ev["pid_lo"], ev["pid_hi"]), 14)
    lad.set(u128.is_max(ev["pid_lo"], ev["pid_hi"]), 15)
    lad.set(u128.eq(ev["pid_lo"], ev["pid_hi"], ev["id_lo"], ev["id_hi"]), 16)
    lad.set(ev["timeout"] != 0, 17)
    lad.set(~p_found, 25)  # pending_transfer_not_found
    lad.set((p["flags"] & F_PENDING) == 0, 26)
    lad.set(
        ~u128.is_zero(ev["dr_lo"], ev["dr_hi"])
        & ~u128.eq(ev["dr_lo"], ev["dr_hi"], p["dr_lo"], p["dr_hi"]),
        27,
    )
    lad.set(
        ~u128.is_zero(ev["cr_lo"], ev["cr_hi"])
        & ~u128.eq(ev["cr_lo"], ev["cr_hi"], p["cr_lo"], p["cr_hi"]),
        28,
    )
    lad.set((ev["ledger"] != 0) & (ev["ledger"] != p["ledger"]), 29)
    lad.set((ev["code"] != 0) & (ev["code"] != p["code"]), 30)

    t_amt_zero = u128.is_zero(ev["amt_lo"], ev["amt_hi"])
    amt_lo = torch.where(t_amt_zero, p["amt_lo"], ev["amt_lo"])
    amt_hi = torch.where(t_amt_zero, p["amt_hi"], ev["amt_hi"])
    lad.set(u128.gt(amt_lo, amt_hi, p["amt_lo"], p["amt_hi"]), 31)  # exceeds_pending
    lad.set(is_void & u128.lt(amt_lo, amt_hi, p["amt_lo"], p["amt_hi"]), 32)

    lad.merge(torch.where(ex_found, post_void_exists_code(ev, ex, p), 0))

    lad.set(p["fulfill"] == 1, 33)  # pending_transfer_already_posted
    lad.set(p["fulfill"] == 2, 34)  # pending_transfer_already_voided

    timeout_ns = p["timeout"] * NS_PER_S
    lad.set((p["timeout"] != 0) & ~u128.ult(ev["ts"], p["ts"] + timeout_ns), 35)  # expired

    return lad.r, amt_lo, amt_hi


def account_exists_code(ev, ex):
    """reference: src/state_machine.zig:767-777."""
    lad = Ladder(torch.zeros_like(ev["flags"]))
    lad.set(ev["flags"] != ex["flags"], 15)
    lad.set(~u128.eq(ev["ud128_lo"], ev["ud128_hi"], ex["ud128_lo"], ex["ud128_hi"]), 16)
    lad.set(ev["ud64"] != ex["ud64"], 17)
    lad.set(ev["ud32"] != ex["ud32"], 18)
    lad.set(ev["ledger"] != ex["ledger"], 19)
    lad.set(ev["code"] != ex["code"], 20)
    lad.set(torch.ones_like(ev["flags"], dtype=torch.bool), 21)  # exists
    return lad.r


def validate_create_account(r0, ev, ex, ex_found):
    """reference: src/state_machine.zig:738-765."""
    lad = Ladder(r0)
    lad.set(ev["reserved"] != 0, 4)  # reserved_field
    lad.set((ev["flags"] & ACCOUNT_FLAGS_PADDING) != 0, 5)  # reserved_flag
    lad.set(u128.is_zero(ev["id_lo"], ev["id_hi"]), 6)
    lad.set(u128.is_max(ev["id_lo"], ev["id_hi"]), 7)
    both_limits = ((ev["flags"] & A_DR_LIMIT) != 0) & (
        (ev["flags"] & A_CR_LIMIT) != 0
    )
    lad.set(both_limits, 8)
    lad.set(~u128.is_zero(ev["dp_lo"], ev["dp_hi"]), 9)
    lad.set(~u128.is_zero(ev["dpo_lo"], ev["dpo_hi"]), 10)
    lad.set(~u128.is_zero(ev["cp_lo"], ev["cp_hi"]), 11)
    lad.set(~u128.is_zero(ev["cpo_lo"], ev["cpo_hi"]), 12)
    lad.set(ev["ledger"] == 0, 13)
    lad.set(ev["code"] == 0, 14)
    lad.merge(torch.where(ex_found, account_exists_code(ev, ex), 0))
    return lad.r
