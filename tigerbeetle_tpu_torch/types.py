"""Core data model: Account, Transfer, flags, result codes (a numpy-only
copy of `tigerbeetle_tpu/types.py`).

Byte-layout-compatible with the reference's extern structs
(reference: src/tigerbeetle.zig:7-104 — 128-byte little-endian, no padding).
u128 fields are stored as two little-endian u64 limbs (lo, hi).

The numpy structured dtypes here are the wire format; the device tables hold
the same 128 bytes per row as 32 words.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np

from tigerbeetle_tpu_torch.constants import U64_MAX, U128_MAX

# --- flags (reference: src/tigerbeetle.zig:42-62, 91-104) ---


class AccountFlags(enum.IntFlag):
    linked = 1 << 0
    debits_must_not_exceed_credits = 1 << 1
    credits_must_not_exceed_debits = 1 << 2

    @staticmethod
    def padding_mask() -> int:
        return 0xFFFF & ~0b111


class TransferFlags(enum.IntFlag):
    linked = 1 << 0
    pending = 1 << 1
    post_pending_transfer = 1 << 2
    void_pending_transfer = 1 << 3
    balancing_debit = 1 << 4
    balancing_credit = 1 << 5

    @staticmethod
    def padding_mask() -> int:
        return 0xFFFF & ~0b111111


# --- result codes (reference: src/tigerbeetle.zig:109-229) ---
# Error codes are ordered by descending precedence; the numeric values are part
# of the wire protocol and must match the reference exactly.


class CreateAccountResult(enum.IntEnum):
    ok = 0
    linked_event_failed = 1
    linked_event_chain_open = 2
    timestamp_must_be_zero = 3
    reserved_field = 4
    reserved_flag = 5
    id_must_not_be_zero = 6
    id_must_not_be_int_max = 7
    flags_are_mutually_exclusive = 8
    debits_pending_must_be_zero = 9
    debits_posted_must_be_zero = 10
    credits_pending_must_be_zero = 11
    credits_posted_must_be_zero = 12
    ledger_must_not_be_zero = 13
    code_must_not_be_zero = 14
    exists_with_different_flags = 15
    exists_with_different_user_data_128 = 16
    exists_with_different_user_data_64 = 17
    exists_with_different_user_data_32 = 18
    exists_with_different_ledger = 19
    exists_with_different_code = 20
    exists = 21


class CreateTransferResult(enum.IntEnum):
    ok = 0
    linked_event_failed = 1
    linked_event_chain_open = 2
    timestamp_must_be_zero = 3
    reserved_flag = 4
    id_must_not_be_zero = 5
    id_must_not_be_int_max = 6
    flags_are_mutually_exclusive = 7
    debit_account_id_must_not_be_zero = 8
    debit_account_id_must_not_be_int_max = 9
    credit_account_id_must_not_be_zero = 10
    credit_account_id_must_not_be_int_max = 11
    accounts_must_be_different = 12
    pending_id_must_be_zero = 13
    pending_id_must_not_be_zero = 14
    pending_id_must_not_be_int_max = 15
    pending_id_must_be_different = 16
    timeout_reserved_for_pending_transfer = 17
    amount_must_not_be_zero = 18
    ledger_must_not_be_zero = 19
    code_must_not_be_zero = 20
    debit_account_not_found = 21
    credit_account_not_found = 22
    accounts_must_have_the_same_ledger = 23
    transfer_must_have_the_same_ledger_as_accounts = 24
    pending_transfer_not_found = 25
    pending_transfer_not_pending = 26
    pending_transfer_has_different_debit_account_id = 27
    pending_transfer_has_different_credit_account_id = 28
    pending_transfer_has_different_ledger = 29
    pending_transfer_has_different_code = 30
    exceeds_pending_transfer_amount = 31
    pending_transfer_has_different_amount = 32
    pending_transfer_already_posted = 33
    pending_transfer_already_voided = 34
    pending_transfer_expired = 35
    exists_with_different_flags = 36
    exists_with_different_debit_account_id = 37
    exists_with_different_credit_account_id = 38
    exists_with_different_amount = 39
    exists_with_different_pending_id = 40
    exists_with_different_user_data_128 = 41
    exists_with_different_user_data_64 = 42
    exists_with_different_user_data_32 = 43
    exists_with_different_timeout = 44
    exists_with_different_code = 45
    exists = 46
    overflows_debits_pending = 47
    overflows_credits_pending = 48
    overflows_debits_posted = 49
    overflows_credits_posted = 50
    overflows_debits = 51
    overflows_credits = 52
    overflows_timeout = 53
    exceeds_credits = 54
    exceeds_debits = 55


class Operation(enum.IntEnum):
    """State machine operations (reference: src/state_machine.zig:208-214).

    Values < 128 are reserved for VSR (reference: src/constants.zig:38
    vsr_operations_reserved); state-machine ops start at 128.
    """

    # VSR-reserved (reference: src/vsr.zig:158-230):
    reserved = 0
    root = 1
    register = 2
    reconfigure = 3
    # State machine:
    create_accounts = 128
    create_transfers = 129
    lookup_accounts = 130
    lookup_transfers = 131


# --- wire-format structured dtypes (128 bytes each, little-endian) ---

ACCOUNT_DTYPE = np.dtype(
    [
        ("id_lo", "<u8"),
        ("id_hi", "<u8"),
        ("debits_pending_lo", "<u8"),
        ("debits_pending_hi", "<u8"),
        ("debits_posted_lo", "<u8"),
        ("debits_posted_hi", "<u8"),
        ("credits_pending_lo", "<u8"),
        ("credits_pending_hi", "<u8"),
        ("credits_posted_lo", "<u8"),
        ("credits_posted_hi", "<u8"),
        ("user_data_128_lo", "<u8"),
        ("user_data_128_hi", "<u8"),
        ("user_data_64", "<u8"),
        ("user_data_32", "<u4"),
        ("reserved", "<u4"),
        ("ledger", "<u4"),
        ("code", "<u2"),
        ("flags", "<u2"),
        ("timestamp", "<u8"),
    ]
)
assert ACCOUNT_DTYPE.itemsize == 128

TRANSFER_DTYPE = np.dtype(
    [
        ("id_lo", "<u8"),
        ("id_hi", "<u8"),
        ("debit_account_id_lo", "<u8"),
        ("debit_account_id_hi", "<u8"),
        ("credit_account_id_lo", "<u8"),
        ("credit_account_id_hi", "<u8"),
        ("amount_lo", "<u8"),
        ("amount_hi", "<u8"),
        ("pending_id_lo", "<u8"),
        ("pending_id_hi", "<u8"),
        ("user_data_128_lo", "<u8"),
        ("user_data_128_hi", "<u8"),
        ("user_data_64", "<u8"),
        ("user_data_32", "<u4"),
        ("timeout", "<u4"),
        ("ledger", "<u4"),
        ("code", "<u2"),
        ("flags", "<u2"),
        ("timestamp", "<u8"),
    ]
)
assert TRANSFER_DTYPE.itemsize == 128

CREATE_ACCOUNTS_RESULT_DTYPE = np.dtype([("index", "<u4"), ("result", "<u4")])
CREATE_TRANSFERS_RESULT_DTYPE = np.dtype([("index", "<u4"), ("result", "<u4")])
assert CREATE_ACCOUNTS_RESULT_DTYPE.itemsize == 8


def split_u128(x: int) -> tuple[int, int]:
    assert 0 <= x <= U128_MAX
    return x & U64_MAX, x >> 64


def join_u128(lo: int, hi: int) -> int:
    return (int(hi) << 64) | int(lo)


# --- host-side record classes (exact-integer semantics for the oracle) ---


@dataclasses.dataclass
class Account:
    """reference: src/tigerbeetle.zig:7-40."""

    id: int = 0
    debits_pending: int = 0
    debits_posted: int = 0
    credits_pending: int = 0
    credits_posted: int = 0
    user_data_128: int = 0
    user_data_64: int = 0
    user_data_32: int = 0
    reserved: int = 0
    ledger: int = 0
    code: int = 0
    flags: int = 0
    timestamp: int = 0

    def debits_exceed_credits(self, amount: int) -> bool:
        # reference: src/tigerbeetle.zig:31-34
        return bool(self.flags & AccountFlags.debits_must_not_exceed_credits) and (
            self.debits_pending + self.debits_posted + amount > self.credits_posted
        )

    def credits_exceed_debits(self, amount: int) -> bool:
        # reference: src/tigerbeetle.zig:36-39
        return bool(self.flags & AccountFlags.credits_must_not_exceed_debits) and (
            self.credits_pending + self.credits_posted + amount > self.debits_posted
        )

    def to_np(self) -> np.ndarray:
        return accounts_to_np([self])

    @staticmethod
    def from_np(row: np.ndarray) -> "Account":
        return Account(
            id=join_u128(row["id_lo"], row["id_hi"]),
            debits_pending=join_u128(row["debits_pending_lo"], row["debits_pending_hi"]),
            debits_posted=join_u128(row["debits_posted_lo"], row["debits_posted_hi"]),
            credits_pending=join_u128(row["credits_pending_lo"], row["credits_pending_hi"]),
            credits_posted=join_u128(row["credits_posted_lo"], row["credits_posted_hi"]),
            user_data_128=join_u128(row["user_data_128_lo"], row["user_data_128_hi"]),
            user_data_64=int(row["user_data_64"]),
            user_data_32=int(row["user_data_32"]),
            reserved=int(row["reserved"]),
            ledger=int(row["ledger"]),
            code=int(row["code"]),
            flags=int(row["flags"]),
            timestamp=int(row["timestamp"]),
        )


@dataclasses.dataclass
class Transfer:
    """reference: src/tigerbeetle.zig:64-89."""

    id: int = 0
    debit_account_id: int = 0
    credit_account_id: int = 0
    amount: int = 0
    pending_id: int = 0
    user_data_128: int = 0
    user_data_64: int = 0
    user_data_32: int = 0
    timeout: int = 0
    ledger: int = 0
    code: int = 0
    flags: int = 0
    timestamp: int = 0

    def to_np(self) -> np.ndarray:
        return transfers_to_np([self])

    @staticmethod
    def from_np(row: np.ndarray) -> "Transfer":
        return Transfer(
            id=join_u128(row["id_lo"], row["id_hi"]),
            debit_account_id=join_u128(row["debit_account_id_lo"], row["debit_account_id_hi"]),
            credit_account_id=join_u128(
                row["credit_account_id_lo"], row["credit_account_id_hi"]
            ),
            amount=join_u128(row["amount_lo"], row["amount_hi"]),
            pending_id=join_u128(row["pending_id_lo"], row["pending_id_hi"]),
            user_data_128=join_u128(row["user_data_128_lo"], row["user_data_128_hi"]),
            user_data_64=int(row["user_data_64"]),
            user_data_32=int(row["user_data_32"]),
            timeout=int(row["timeout"]),
            ledger=int(row["ledger"]),
            code=int(row["code"]),
            flags=int(row["flags"]),
            timestamp=int(row["timestamp"]),
        )


def accounts_to_np(accounts: list[Account]) -> np.ndarray:
    out = np.zeros(len(accounts), dtype=ACCOUNT_DTYPE)
    for i, a in enumerate(accounts):
        out[i]["id_lo"], out[i]["id_hi"] = split_u128(a.id)
        out[i]["debits_pending_lo"], out[i]["debits_pending_hi"] = split_u128(a.debits_pending)
        out[i]["debits_posted_lo"], out[i]["debits_posted_hi"] = split_u128(a.debits_posted)
        out[i]["credits_pending_lo"], out[i]["credits_pending_hi"] = split_u128(
            a.credits_pending
        )
        out[i]["credits_posted_lo"], out[i]["credits_posted_hi"] = split_u128(a.credits_posted)
        out[i]["user_data_128_lo"], out[i]["user_data_128_hi"] = split_u128(a.user_data_128)
        out[i]["user_data_64"] = a.user_data_64
        out[i]["user_data_32"] = a.user_data_32
        out[i]["reserved"] = a.reserved
        out[i]["ledger"] = a.ledger
        out[i]["code"] = a.code
        out[i]["flags"] = a.flags
        out[i]["timestamp"] = a.timestamp
    return out


def transfers_to_np(transfers: list[Transfer]) -> np.ndarray:
    out = np.zeros(len(transfers), dtype=TRANSFER_DTYPE)
    for i, t in enumerate(transfers):
        out[i]["id_lo"], out[i]["id_hi"] = split_u128(t.id)
        out[i]["debit_account_id_lo"], out[i]["debit_account_id_hi"] = split_u128(
            t.debit_account_id
        )
        out[i]["credit_account_id_lo"], out[i]["credit_account_id_hi"] = split_u128(
            t.credit_account_id
        )
        out[i]["amount_lo"], out[i]["amount_hi"] = split_u128(t.amount)
        out[i]["pending_id_lo"], out[i]["pending_id_hi"] = split_u128(t.pending_id)
        out[i]["user_data_128_lo"], out[i]["user_data_128_hi"] = split_u128(t.user_data_128)
        out[i]["user_data_64"] = t.user_data_64
        out[i]["user_data_32"] = t.user_data_32
        out[i]["timeout"] = t.timeout
        out[i]["ledger"] = t.ledger
        out[i]["code"] = t.code
        out[i]["flags"] = t.flags
        out[i]["timestamp"] = t.timestamp
    return out
