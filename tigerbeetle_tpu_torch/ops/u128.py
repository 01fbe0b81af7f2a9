"""Exact u128 arithmetic as two u64 limbs (lo, hi) on int64 tensors.

The counterpart of `tigerbeetle_tpu/ops/u128.py`. torch has no unsigned
64-bit arithmetic, so every u64 limb is an int64 tensor holding the same 64
bits. Addition, subtraction and multiplication wrap mod 2^64 exactly as the
unsigned operations do; only comparisons differ, and `ult` flips the sign
bit to compare as unsigned. All helpers are shape-polymorphic.
"""

from __future__ import annotations

import torch

SIGN = -(1 << 63)  # the sign bit as an int64 value
U64_ONES = -1  # 0xFFFFFFFFFFFFFFFF as an int64 value


def to_i64(x: int) -> int:
    """An unsigned 64-bit integer as the int64 value with the same bits."""
    x &= (1 << 64) - 1
    return x - (1 << 64) if x >> 63 else x


def ult(a, b):
    """Unsigned a < b on int64 lanes."""
    return (a ^ SIGN) < (b ^ SIGN)


def srl(x, k: int):
    """Logical right shift of int64 lanes (`>>` on int64 is arithmetic)."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def add(a_lo, a_hi, b_lo, b_hi):
    """(a + b) mod 2^128 with carry-out. Returns (lo, hi, carry_out bool)."""
    lo = a_lo + b_lo
    c0 = ult(lo, a_lo)
    hi0 = a_hi + b_hi
    c1 = ult(hi0, a_hi)
    hi = hi0 + c0.to(torch.int64)
    c2 = ult(hi, hi0)
    return lo, hi, c1 | c2


def add_u64(a_lo, a_hi, b):
    """(a + b) for u64 b, with carry-out."""
    return add(a_lo, a_hi, b, torch.zeros_like(b))


def sub(a_lo, a_hi, b_lo, b_hi):
    """(a - b) mod 2^128 with borrow-out (True iff a < b)."""
    lo = a_lo - b_lo
    brw0 = ult(a_lo, b_lo)
    hi0 = a_hi - b_hi
    brw1 = ult(a_hi, b_hi)
    hi = hi0 - brw0.to(torch.int64)
    brw2 = ult(hi0, hi)  # wrapped below zero
    return lo, hi, brw1 | brw2


def sat_sub(a_lo, a_hi, b_lo, b_hi):
    """max(0, a - b) (saturating subtract)."""
    lo, hi, brw = sub(a_lo, a_hi, b_lo, b_hi)
    zero = torch.zeros_like(lo)
    return torch.where(brw, zero, lo), torch.where(brw, zero, hi)


def eq(a_lo, a_hi, b_lo, b_hi):
    return (a_lo == b_lo) & (a_hi == b_hi)


def lt(a_lo, a_hi, b_lo, b_hi):
    return ult(a_hi, b_hi) | ((a_hi == b_hi) & ult(a_lo, b_lo))


def gt(a_lo, a_hi, b_lo, b_hi):
    return lt(b_lo, b_hi, a_lo, a_hi)


def le(a_lo, a_hi, b_lo, b_hi):
    return ~gt(a_lo, a_hi, b_lo, b_hi)


def is_zero(a_lo, a_hi):
    return (a_lo == 0) & (a_hi == 0)


def is_max(a_lo, a_hi):
    return (a_lo == U64_ONES) & (a_hi == U64_ONES)


def min_(a_lo, a_hi, b_lo, b_hi):
    a_less = lt(a_lo, a_hi, b_lo, b_hi)
    return torch.where(a_less, a_lo, b_lo), torch.where(a_less, a_hi, b_hi)


def select(pred, a_lo, a_hi, b_lo, b_hi):
    return torch.where(pred, a_lo, b_lo), torch.where(pred, a_hi, b_hi)


def sum_overflows(a_lo, a_hi, b_lo, b_hi):
    """reference: src/state_machine.zig:1152-1157 (u128 instantiation)."""
    _, _, carry = add(a_lo, a_hi, b_lo, b_hi)
    return carry


def sum_overflows_u64(a, b):
    """reference: src/state_machine.zig:1152-1157 (u64 instantiation)."""
    return ult(a + b, a)
