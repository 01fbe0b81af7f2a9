"""Scalar reference state machine — the parity oracle.

An exact, line-faithful reimplementation of the reference ledger semantics
(reference: src/state_machine.zig:612-1077) over in-memory dict stores, using
Python arbitrary-precision ints with explicit u64/u128 overflow semantics.

This is NOT the production path — it is the oracle every device kernel is
tested against for bit-exact result-code and state parity (SURVEY.md §7
build-plan stage 2), and the model behind the simulator's auditor.

The port's copy of `tigerbeetle_tpu/models/oracle.py`: the same semantics,
the same `fingerprint` and the same `snapshot_bytes`, which reach a
checkpoint blob.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np

from tigerbeetle_tpu_torch.constants import NS_PER_S, U64_MAX, U128_MAX
from tigerbeetle_tpu_torch.types import (
    Account,
    AccountFlags,
    CreateAccountResult,
    CreateTransferResult,
    Operation,
    Transfer,
    TransferFlags,
)

POSTED = 1
VOIDED = 2


def sum_overflows_u128(a: int, b: int) -> bool:
    return a + b > U128_MAX


def sum_overflows_u64(a: int, b: int) -> bool:
    return a + b > U64_MAX


@dataclasses.dataclass
class _Scope:
    """Rollback scope for linked chains (reference: src/lsm/groove.zig:990-1010).

    Records prior values of mutated keys; discard restores them in reverse.
    """

    accounts: list[tuple[int, Account | None]] = dataclasses.field(default_factory=list)
    transfers: list[tuple[int, Transfer | None]] = dataclasses.field(default_factory=list)
    posted: list[tuple[int, int | None]] = dataclasses.field(default_factory=list)


class OracleStateMachine:
    """Exact semantics of reference src/state_machine.zig over dict stores."""

    process = None  # no device table geometry (Replica backend duck-typing)

    def __init__(self) -> None:
        self.accounts: dict[int, Account] = {}
        self.transfers: dict[int, Transfer] = {}
        # posted groove: pending transfer timestamp -> POSTED | VOIDED
        # (reference: src/state_machine.zig:185-198 PostedGrooveValue).
        self.posted: dict[int, int] = {}
        self.commit_timestamp: int = 0
        self.prepare_timestamp: int = 0
        self._scope: _Scope | None = None

    # --- store accessors with scope recording ---

    def _put_account(self, a: Account) -> None:
        if self._scope is not None:
            prev = self.accounts.get(a.id)
            self._scope.accounts.append(
                (a.id, dataclasses.replace(prev) if prev is not None else None)
            )
        self.accounts[a.id] = a

    def _put_transfer(self, t: Transfer) -> None:
        if self._scope is not None:
            prev = self.transfers.get(t.id)
            self._scope.transfers.append(
                (t.id, dataclasses.replace(prev) if prev is not None else None)
            )
        self.transfers[t.id] = t

    def _put_posted(self, pending_timestamp: int, fulfillment: int) -> None:
        if self._scope is not None:
            self._scope.posted.append(
                (pending_timestamp, self.posted.get(pending_timestamp))
            )
        self.posted[pending_timestamp] = fulfillment

    def _scope_open(self) -> None:
        assert self._scope is None
        self._scope = _Scope()

    def _scope_close(self, persist: bool) -> None:
        scope = self._scope
        assert scope is not None
        self._scope = None
        if persist:
            return
        for key, prev in reversed(scope.posted):
            if prev is None:
                del self.posted[key]
            else:
                self.posted[key] = prev
        for key, prev in reversed(scope.transfers):
            if prev is None:
                del self.transfers[key]
            else:
                self.transfers[key] = prev
        for key, prev in reversed(scope.accounts):
            if prev is None:
                del self.accounts[key]
            else:
                self.accounts[key] = prev

    # --- lifecycle (reference: src/state_machine.zig:336-343) ---

    def prepare(self, operation: Operation, event_count: int) -> None:
        if operation in (Operation.create_accounts, Operation.create_transfers):
            self.prepare_timestamp += event_count

    # --- batch executor (reference: src/state_machine.zig:612-698) ---

    def execute(
        self, operation: Operation, timestamp: int, events: list
    ) -> list[tuple[int, int]]:
        """Returns the sparse (index, result) list, exactly as the reference
        emits it (only non-ok results; chain rollbacks appended in FIFO order).
        """
        if isinstance(events, np.ndarray):  # wire rows -> record classes
            cls = Account if operation == Operation.create_accounts else Transfer
            events = [cls.from_np(events[i]) for i in range(len(events))]

        results: list[tuple[int, int]] = []
        chain: int | None = None
        chain_broken = False

        for index, event_in in enumerate(events):
            event = dataclasses.replace(event_in)
            result = None

            if event.flags & 0x1:  # linked
                if chain is None:
                    chain = index
                    assert not chain_broken
                    self._scope_open()
                if index == len(events) - 1:
                    result = 2  # linked_event_chain_open

            if result is None and chain_broken:
                result = 1  # linked_event_failed
            if result is None and event.timestamp != 0:
                result = 3  # timestamp_must_be_zero

            if result is None:
                event.timestamp = timestamp - len(events) + index + 1
                if operation == Operation.create_accounts:
                    result = int(self.create_account(event))
                elif operation == Operation.create_transfers:
                    result = int(self.create_transfer(event))
                else:
                    raise AssertionError(operation)

            if result != 0:
                if chain is not None:
                    if not chain_broken:
                        chain_broken = True
                        self._scope_close(persist=False)
                        for chain_index in range(chain, index):
                            results.append((chain_index, 1))  # linked_event_failed
                    else:
                        assert result in (1, 2)
                results.append((index, result))

            if chain is not None and (not (event.flags & 0x1) or result == 2):
                if not chain_broken:
                    self._scope_close(persist=True)
                chain = None
                chain_broken = False

        assert chain is None
        assert not chain_broken
        from tigerbeetle_tpu_torch import constants

        if constants.VERIFY:
            self._audit_count = getattr(self, "_audit_count", 0) + 1
            if self._audit_count % 8 == 0:
                self.verify_conservation()
        return results

    def verify_conservation(self) -> None:
        """Intensive-tier audit (constants.VERIFY; reference
        src/constants.zig:592): per ledger, total debits_posted ==
        total credits_posted and total debits_pending ==
        total credits_pending — money never appears or vanishes.
        O(accounts) per audit, run on a commit cadence."""
        per_ledger: dict[int, list[int]] = {}
        for a in self.accounts.values():
            t = per_ledger.setdefault(a.ledger, [0, 0, 0, 0])
            t[0] += a.debits_posted
            t[1] += a.credits_posted
            t[2] += a.debits_pending
            t[3] += a.credits_pending
        for ledger, (dp, cp, dpe, cpe) in per_ledger.items():
            assert dp == cp, (
                f"VERIFY: ledger {ledger} posted conservation broken: "
                f"debits {dp} != credits {cp}"
            )
            assert dpe == cpe, (
                f"VERIFY: ledger {ledger} pending conservation broken: "
                f"debits {dpe} != credits {cpe}"
            )

    def execute_dense(
        self, operation: Operation, timestamp: int, events: list
    ) -> list[int]:
        """Dense per-event result codes (ok = 0), the device kernels' output
        format. Sparse wire results = [(i, c) for i, c in enumerate(dense) if c]."""
        sparse = self.execute(operation, timestamp, events)
        dense = [0] * len(events)
        for index, result in sparse:
            dense[index] = result
        return dense

    # -- parity extraction + snapshot (so the oracle can stand in for the
    # device ledger behind the Replica in logic-level simulations) --

    def extract(self):
        return (
            {k: dataclasses.replace(v) for k, v in self.accounts.items()},
            {k: dataclasses.replace(v) for k, v in self.transfers.items()},
            dict(self.posted),
        )

    def assert_parity(self, backend) -> None:
        """Diff another backend's extract() surface against this oracle
        and FAIL NAMING the first divergent object (id + both values) —
        the wave-scheduler parity tests run adversarial thousand-event
        batches, where a whole-dict assert's diff is unreadable."""
        accounts, transfers, posted = backend.extract()
        for name, got, want in (
            ("account", accounts, self.accounts),
            ("transfer", transfers, self.transfers),
            ("posted", posted, self.posted),
        ):
            assert set(got) == set(want), (
                f"{name} id sets differ: only-device="
                f"{sorted(set(got) - set(want))[:4]} only-oracle="
                f"{sorted(set(want) - set(got))[:4]}"
            )
            for k in sorted(want):
                assert got[k] == want[k], (
                    f"{name} {k}: device={got[k]} oracle={want[k]}"
                )
        assert backend.commit_timestamp == self.commit_timestamp, (
            backend.commit_timestamp, self.commit_timestamp,
        )

    def fingerprint(self) -> dict:
        """Order-independent state digest matching DeviceLedger /
        NativeLedger fingerprint() bit-exactly (models/ledger.py
        fp_rows_np): the commutative per-row sum makes the dict-ordered
        wire images hash identically to the device's slot layout. This
        is what lets StreamVerifier recompute a region's checkpoint
        commitments from its CDC stream alone."""
        from tigerbeetle_tpu_torch.models.ledger import fp_rows_np
        from tigerbeetle_tpu_torch.types import accounts_to_np, transfers_to_np

        afp, alive = fp_rows_np(accounts_to_np(list(self.accounts.values())))
        tfp, tlive = fp_rows_np(transfers_to_np(list(self.transfers.values())))
        assert alive == len(self.accounts) and tlive == len(self.transfers)
        return {
            "accounts_fp": afp,
            "transfers_fp": tfp,
            "accounts": alive,
            "transfers": tlive,
            "commit_timestamp": self.commit_timestamp,
        }

    def snapshot_bytes(self) -> bytes:
        import json

        from tigerbeetle_tpu_torch.types import accounts_to_np, transfers_to_np

        acc = accounts_to_np([self.accounts[k] for k in sorted(self.accounts)])
        xfr = transfers_to_np([self.transfers[k] for k in sorted(self.transfers)])
        posted = json.dumps(
            [[str(k), v] for k, v in sorted(self.posted.items())]
        ).encode()
        head = (
            len(acc).to_bytes(8, "little")
            + len(xfr).to_bytes(8, "little")
            + len(posted).to_bytes(8, "little")
            + self.commit_timestamp.to_bytes(8, "little")
        )
        return head + acc.tobytes() + xfr.tobytes() + posted

    def restore_bytes(self, raw: bytes) -> None:
        import json

        import numpy as np

        from tigerbeetle_tpu_torch.types import ACCOUNT_DTYPE, TRANSFER_DTYPE

        n_acc = int.from_bytes(raw[0:8], "little")
        n_xfr = int.from_bytes(raw[8:16], "little")
        n_posted = int.from_bytes(raw[16:24], "little")
        self.commit_timestamp = int.from_bytes(raw[24:32], "little")
        off = 32
        acc = np.frombuffer(raw[off : off + 128 * n_acc], dtype=ACCOUNT_DTYPE)
        off += 128 * n_acc
        xfr = np.frombuffer(raw[off : off + 128 * n_xfr], dtype=TRANSFER_DTYPE)
        off += 128 * n_xfr
        posted = json.loads(raw[off : off + n_posted].decode())
        self.accounts = {}
        for i in range(n_acc):
            a = Account.from_np(acc[i])
            self.accounts[a.id] = a
        self.transfers = {}
        for i in range(n_xfr):
            t = Transfer.from_np(xfr[i])
            self.transfers[t.id] = t
        self.posted = {int(k): v for k, v in posted}

    def lookup_accounts(self, ids: Iterable[int]) -> list[Account]:
        # reference: src/state_machine.zig:701-717
        return [
            dataclasses.replace(self.accounts[i]) for i in ids if i in self.accounts
        ]

    def lookup_transfers(self, ids: Iterable[int]) -> list[Transfer]:
        # reference: src/state_machine.zig:720-736
        return [
            dataclasses.replace(self.transfers[i]) for i in ids if i in self.transfers
        ]

    # --- create_account (reference: src/state_machine.zig:738-777) ---

    def create_account(self, a: Account) -> CreateAccountResult:
        R = CreateAccountResult
        if a.reserved != 0:
            return R.reserved_field
        if a.flags & AccountFlags.padding_mask():
            return R.reserved_flag
        if a.id == 0:
            return R.id_must_not_be_zero
        if a.id == U128_MAX:
            return R.id_must_not_be_int_max
        if (a.flags & AccountFlags.debits_must_not_exceed_credits) and (
            a.flags & AccountFlags.credits_must_not_exceed_debits
        ):
            return R.flags_are_mutually_exclusive
        if a.debits_pending != 0:
            return R.debits_pending_must_be_zero
        if a.debits_posted != 0:
            return R.debits_posted_must_be_zero
        if a.credits_pending != 0:
            return R.credits_pending_must_be_zero
        if a.credits_posted != 0:
            return R.credits_posted_must_be_zero
        if a.ledger == 0:
            return R.ledger_must_not_be_zero
        if a.code == 0:
            return R.code_must_not_be_zero

        e = self.accounts.get(a.id)
        if e is not None:
            return self._create_account_exists(a, e)

        self._put_account(dataclasses.replace(a))
        self.commit_timestamp = a.timestamp
        return R.ok

    @staticmethod
    def _create_account_exists(a: Account, e: Account) -> CreateAccountResult:
        # reference: src/state_machine.zig:767-777
        R = CreateAccountResult
        assert a.id == e.id
        if a.flags != e.flags:
            return R.exists_with_different_flags
        if a.user_data_128 != e.user_data_128:
            return R.exists_with_different_user_data_128
        if a.user_data_64 != e.user_data_64:
            return R.exists_with_different_user_data_64
        if a.user_data_32 != e.user_data_32:
            return R.exists_with_different_user_data_32
        assert a.reserved == 0 and e.reserved == 0
        if a.ledger != e.ledger:
            return R.exists_with_different_ledger
        if a.code != e.code:
            return R.exists_with_different_code
        return R.exists

    # --- create_transfer (reference: src/state_machine.zig:779-884) ---

    def create_transfer(self, t: Transfer) -> CreateTransferResult:
        R = CreateTransferResult
        F = TransferFlags

        if t.flags & TransferFlags.padding_mask():
            return R.reserved_flag
        if t.id == 0:
            return R.id_must_not_be_zero
        if t.id == U128_MAX:
            return R.id_must_not_be_int_max

        if t.flags & (F.post_pending_transfer | F.void_pending_transfer):
            return self._post_or_void_pending_transfer(t)

        if t.debit_account_id == 0:
            return R.debit_account_id_must_not_be_zero
        if t.debit_account_id == U128_MAX:
            return R.debit_account_id_must_not_be_int_max
        if t.credit_account_id == 0:
            return R.credit_account_id_must_not_be_zero
        if t.credit_account_id == U128_MAX:
            return R.credit_account_id_must_not_be_int_max
        if t.credit_account_id == t.debit_account_id:
            return R.accounts_must_be_different

        if t.pending_id != 0:
            return R.pending_id_must_be_zero
        if not (t.flags & F.pending):
            if t.timeout != 0:
                return R.timeout_reserved_for_pending_transfer
        if not (t.flags & (F.balancing_debit | F.balancing_credit)):
            if t.amount == 0:
                return R.amount_must_not_be_zero

        if t.ledger == 0:
            return R.ledger_must_not_be_zero
        if t.code == 0:
            return R.code_must_not_be_zero

        dr_account = self.accounts.get(t.debit_account_id)
        if dr_account is None:
            return R.debit_account_not_found
        cr_account = self.accounts.get(t.credit_account_id)
        if cr_account is None:
            return R.credit_account_not_found
        assert t.timestamp > dr_account.timestamp
        assert t.timestamp > cr_account.timestamp

        if dr_account.ledger != cr_account.ledger:
            return R.accounts_must_have_the_same_ledger
        if t.ledger != dr_account.ledger:
            return R.transfer_must_have_the_same_ledger_as_accounts

        # If the transfer already exists, it must not influence the overflow
        # or limit checks (reference: src/state_machine.zig:823-824).
        e = self.transfers.get(t.id)
        if e is not None:
            return self._create_transfer_exists(t, e)

        amount = t.amount
        if t.flags & (F.balancing_debit | F.balancing_credit):
            if amount == 0:
                amount = U64_MAX  # note: u64 max (reference: :829)
        else:
            assert amount != 0
        if t.flags & F.balancing_debit:
            dr_balance = dr_account.debits_posted + dr_account.debits_pending
            amount = min(amount, max(0, dr_account.credits_posted - dr_balance))
            if amount == 0:
                return R.exceeds_credits
        if t.flags & F.balancing_credit:
            cr_balance = cr_account.credits_posted + cr_account.credits_pending
            amount = min(amount, max(0, cr_account.debits_posted - cr_balance))
            if amount == 0:
                return R.exceeds_debits

        if t.flags & F.pending:
            if sum_overflows_u128(amount, dr_account.debits_pending):
                return R.overflows_debits_pending
            if sum_overflows_u128(amount, cr_account.credits_pending):
                return R.overflows_credits_pending
        if sum_overflows_u128(amount, dr_account.debits_posted):
            return R.overflows_debits_posted
        if sum_overflows_u128(amount, cr_account.credits_posted):
            return R.overflows_credits_posted
        if sum_overflows_u128(amount, dr_account.debits_pending + dr_account.debits_posted):
            return R.overflows_debits
        if sum_overflows_u128(amount, cr_account.credits_pending + cr_account.credits_posted):
            return R.overflows_credits

        if sum_overflows_u64(t.timestamp, t.timeout * NS_PER_S):
            return R.overflows_timeout
        if dr_account.debits_exceed_credits(amount):
            return R.exceeds_credits
        if cr_account.credits_exceed_debits(amount):
            return R.exceeds_debits

        t2 = dataclasses.replace(t, amount=amount)
        self._put_transfer(t2)

        dr_new = dataclasses.replace(dr_account)
        cr_new = dataclasses.replace(cr_account)
        if t.flags & F.pending:
            dr_new.debits_pending += amount
            cr_new.credits_pending += amount
        else:
            dr_new.debits_posted += amount
            cr_new.credits_posted += amount
        self._put_account(dr_new)
        self._put_account(cr_new)

        self.commit_timestamp = t.timestamp
        return R.ok

    @staticmethod
    def _create_transfer_exists(t: Transfer, e: Transfer) -> CreateTransferResult:
        # reference: src/state_machine.zig:886-905
        R = CreateTransferResult
        assert t.id == e.id
        if t.flags != e.flags:
            return R.exists_with_different_flags
        if t.debit_account_id != e.debit_account_id:
            return R.exists_with_different_debit_account_id
        if t.credit_account_id != e.credit_account_id:
            return R.exists_with_different_credit_account_id
        if t.amount != e.amount:
            return R.exists_with_different_amount
        assert t.pending_id == 0 and e.pending_id == 0
        if t.user_data_128 != e.user_data_128:
            return R.exists_with_different_user_data_128
        if t.user_data_64 != e.user_data_64:
            return R.exists_with_different_user_data_64
        if t.user_data_32 != e.user_data_32:
            return R.exists_with_different_user_data_32
        if t.timeout != e.timeout:
            return R.exists_with_different_timeout
        assert t.ledger == e.ledger
        if t.code != e.code:
            return R.exists_with_different_code
        return R.exists

    # --- post/void (reference: src/state_machine.zig:907-1014) ---

    def _post_or_void_pending_transfer(self, t: Transfer) -> CreateTransferResult:
        R = CreateTransferResult
        F = TransferFlags
        assert t.id != 0
        assert t.flags & (F.post_pending_transfer | F.void_pending_transfer)

        if (t.flags & F.post_pending_transfer) and (t.flags & F.void_pending_transfer):
            return R.flags_are_mutually_exclusive
        if t.flags & F.pending:
            return R.flags_are_mutually_exclusive
        if t.flags & F.balancing_debit:
            return R.flags_are_mutually_exclusive
        if t.flags & F.balancing_credit:
            return R.flags_are_mutually_exclusive

        if t.pending_id == 0:
            return R.pending_id_must_not_be_zero
        if t.pending_id == U128_MAX:
            return R.pending_id_must_not_be_int_max
        if t.pending_id == t.id:
            return R.pending_id_must_be_different
        if t.timeout != 0:
            return R.timeout_reserved_for_pending_transfer

        p = self.transfers.get(t.pending_id)
        if p is None:
            return R.pending_transfer_not_found
        assert p.id == t.pending_id
        if not (p.flags & F.pending):
            return R.pending_transfer_not_pending

        dr_account = self.accounts[p.debit_account_id]
        cr_account = self.accounts[p.credit_account_id]
        assert p.timestamp > dr_account.timestamp
        assert p.timestamp > cr_account.timestamp
        assert p.amount > 0

        if t.debit_account_id > 0 and t.debit_account_id != p.debit_account_id:
            return R.pending_transfer_has_different_debit_account_id
        if t.credit_account_id > 0 and t.credit_account_id != p.credit_account_id:
            return R.pending_transfer_has_different_credit_account_id
        # user_data is allowed to differ across pending and post/void transfers.
        if t.ledger > 0 and t.ledger != p.ledger:
            return R.pending_transfer_has_different_ledger
        if t.code > 0 and t.code != p.code:
            return R.pending_transfer_has_different_code

        amount = t.amount if t.amount > 0 else p.amount
        if amount > p.amount:
            return R.exceeds_pending_transfer_amount
        if (t.flags & F.void_pending_transfer) and amount < p.amount:
            return R.pending_transfer_has_different_amount

        e = self.transfers.get(t.id)
        if e is not None:
            return self._post_or_void_pending_transfer_exists(t, e, p)

        fulfillment = self.posted.get(p.timestamp)
        if fulfillment is not None:
            if fulfillment == POSTED:
                return R.pending_transfer_already_posted
            return R.pending_transfer_already_voided

        assert p.timestamp < t.timestamp
        if p.timeout > 0:
            timeout_ns = p.timeout * NS_PER_S
            if t.timestamp >= p.timestamp + timeout_ns:
                return R.pending_transfer_expired

        t2 = Transfer(
            id=t.id,
            debit_account_id=p.debit_account_id,
            credit_account_id=p.credit_account_id,
            user_data_128=t.user_data_128 if t.user_data_128 > 0 else p.user_data_128,
            user_data_64=t.user_data_64 if t.user_data_64 > 0 else p.user_data_64,
            user_data_32=t.user_data_32 if t.user_data_32 > 0 else p.user_data_32,
            ledger=p.ledger,
            code=p.code,
            pending_id=t.pending_id,
            timeout=0,
            timestamp=t.timestamp,
            flags=t.flags,
            amount=amount,
        )
        self._put_transfer(t2)

        self._put_posted(
            p.timestamp, POSTED if t.flags & F.post_pending_transfer else VOIDED
        )

        dr_new = dataclasses.replace(dr_account)
        cr_new = dataclasses.replace(cr_account)
        dr_new.debits_pending -= p.amount
        cr_new.credits_pending -= p.amount
        if t.flags & F.post_pending_transfer:
            assert amount > 0
            assert amount <= p.amount
            dr_new.debits_posted += amount
            cr_new.credits_posted += amount
        self._put_account(dr_new)
        self._put_account(cr_new)

        self.commit_timestamp = t.timestamp
        return R.ok

    @staticmethod
    def _post_or_void_pending_transfer_exists(
        t: Transfer, e: Transfer, p: Transfer
    ) -> CreateTransferResult:
        # reference: src/state_machine.zig:1016-1077
        R = CreateTransferResult
        assert t.id == e.id
        assert t.id != p.id
        assert t.pending_id == p.id

        if t.flags != e.flags:
            return R.exists_with_different_flags

        if t.amount == 0:
            if e.amount != p.amount:
                return R.exists_with_different_amount
        else:
            if t.amount != e.amount:
                return R.exists_with_different_amount

        if t.pending_id != e.pending_id:
            return R.exists_with_different_pending_id

        if t.user_data_128 == 0:
            if e.user_data_128 != p.user_data_128:
                return R.exists_with_different_user_data_128
        else:
            if t.user_data_128 != e.user_data_128:
                return R.exists_with_different_user_data_128

        if t.user_data_64 == 0:
            if e.user_data_64 != p.user_data_64:
                return R.exists_with_different_user_data_64
        else:
            if t.user_data_64 != e.user_data_64:
                return R.exists_with_different_user_data_64

        if t.user_data_32 == 0:
            if e.user_data_32 != p.user_data_32:
                return R.exists_with_different_user_data_32
        else:
            if t.user_data_32 != e.user_data_32:
                return R.exists_with_different_user_data_32

        return R.exists
