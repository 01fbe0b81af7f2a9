"""Randomized ledger workload generator.

The analog of the reference's workload generator (reference:
src/state_machine/workload.zig:1-19): produces seeded, reproducible batches of
create_accounts / create_transfers / lookup_* events covering the valid,
invalid, and intra-batch-conflicting regions of the input space — duplicate
ids, linked chains, two-phase pending/post/void (including in-batch
references), balancing transfers, balance-limit accounts, expired timeouts.

Used by the parity tests (device kernels vs. oracle) and the simulator's
auditor.

The port's copy of `tigerbeetle_tpu/testing/workload.py`: the same seed
gives the same events, draw for draw.
"""

from __future__ import annotations

import random

from tigerbeetle_tpu_torch.constants import U128_MAX
from tigerbeetle_tpu_torch.types import Account, AccountFlags, Operation, Transfer, TransferFlags


class WorkloadGenerator:
    def __init__(
        self,
        seed: int,
        *,
        ledgers: tuple[int, ...] = (1, 2),
        invalid_rate: float = 0.15,
        conflict_rate: float = 0.25,
        chain_rate: float = 0.1,
        two_phase_rate: float = 0.2,
        balancing_rate: float = 0.1,
        limit_account_rate: float = 0.15,
    ) -> None:
        self.rng = random.Random(seed)
        self.ledgers = ledgers
        self.invalid_rate = invalid_rate
        self.conflict_rate = conflict_rate
        self.chain_rate = chain_rate
        self.two_phase_rate = two_phase_rate
        self.balancing_rate = balancing_rate
        self.limit_account_rate = limit_account_rate
        self.next_id = 1
        self.account_ids: list[int] = []
        self.transfer_ids: list[int] = []
        self.pending_ids: list[int] = []

    def _fresh_id(self) -> int:
        i = self.next_id
        self.next_id += 1
        # Spread ids over the u128 space so hash paths are exercised.
        return (i * 0x9E3779B97F4A7C15) & (U128_MAX - 1) | 1

    def _account_id(self) -> int:
        rng = self.rng
        if self.account_ids and rng.random() > 0.1:
            return rng.choice(self.account_ids)
        return self._fresh_id()

    def gen_accounts_batch(self, size: int) -> tuple[Operation, list[Account]]:
        rng = self.rng
        events: list[Account] = []
        while len(events) < size:
            a = Account(
                id=self._fresh_id(),
                ledger=rng.choice(self.ledgers),
                code=rng.randint(1, 100),
                user_data_128=rng.randint(0, U128_MAX),
                user_data_64=rng.getrandbits(64),
                user_data_32=rng.getrandbits(32),
            )
            if rng.random() < self.limit_account_rate:
                a.flags |= rng.choice(
                    (
                        AccountFlags.debits_must_not_exceed_credits,
                        AccountFlags.credits_must_not_exceed_debits,
                    )
                )
            roll = rng.random()
            if roll < self.invalid_rate:
                mutation = rng.randrange(8)
                if mutation == 0:
                    a.id = 0
                elif mutation == 1:
                    a.id = U128_MAX
                elif mutation == 2:
                    a.ledger = 0
                elif mutation == 3:
                    a.code = 0
                elif mutation == 4:
                    a.debits_posted = rng.randint(1, 100)
                elif mutation == 5:
                    a.flags = int(a.flags) | (1 << rng.randint(3, 15))
                elif mutation == 6:
                    a.reserved = 1
                elif mutation == 7:
                    a.flags = int(
                        AccountFlags.debits_must_not_exceed_credits
                        | AccountFlags.credits_must_not_exceed_debits
                    )
            elif roll < self.invalid_rate + self.conflict_rate and self.account_ids:
                # Duplicate of an existing account (exists / exists_with_*).
                a.id = rng.choice(self.account_ids)
                if rng.random() < 0.5:
                    a.user_data_32 ^= 1
            else:
                self.account_ids.append(a.id)
            if rng.random() < self.chain_rate and len(events) < size - 1:
                a.flags = int(a.flags) | int(AccountFlags.linked)
            events.append(a)
        return Operation.create_accounts, events

    def gen_transfers_batch(self, size: int) -> tuple[Operation, list[Transfer]]:
        rng = self.rng
        events: list[Transfer] = []
        batch_created_ids: list[int] = []
        batch_pending: list[int] = []
        while len(events) < size:
            t = Transfer(
                id=self._fresh_id(),
                debit_account_id=self._account_id(),
                credit_account_id=self._account_id(),
                amount=rng.randint(1, 1 << rng.choice((8, 16, 48, 64))),
                ledger=rng.choice(self.ledgers),
                code=rng.randint(1, 100),
                user_data_64=rng.getrandbits(16),
            )
            roll = rng.random()
            if roll < self.two_phase_rate:
                kind = rng.randrange(3)
                if kind == 0:
                    t.flags |= TransferFlags.pending
                    if rng.random() < 0.3:
                        t.timeout = rng.choice((0, 1, 10, 1 << 20))
                    batch_pending.append(t.id)
                    self.pending_ids.append(t.id)
                else:
                    pool = self.pending_ids + batch_pending
                    if pool:
                        t.pending_id = rng.choice(pool)
                        t.flags |= (
                            TransferFlags.post_pending_transfer
                            if kind == 1
                            else TransferFlags.void_pending_transfer
                        )
                        t.debit_account_id = 0
                        t.credit_account_id = 0
                        t.ledger = 0
                        t.code = 0
                        if rng.random() < 0.5:
                            t.amount = 0
            elif roll < self.two_phase_rate + self.balancing_rate:
                t.flags |= rng.choice(
                    (TransferFlags.balancing_debit, TransferFlags.balancing_credit)
                )
                if rng.random() < 0.3:
                    t.amount = 0
            elif roll < self.two_phase_rate + self.balancing_rate + self.invalid_rate:
                mutation = rng.randrange(10)
                if mutation == 0:
                    t.id = 0
                elif mutation == 1:
                    t.id = U128_MAX
                elif mutation == 2:
                    t.debit_account_id = self._fresh_id()  # not found
                elif mutation == 3:
                    t.credit_account_id = 0
                elif mutation == 4:
                    t.credit_account_id = t.debit_account_id
                elif mutation == 5:
                    t.amount = 0
                elif mutation == 6:
                    t.ledger = 0
                elif mutation == 7:
                    t.code = 0
                elif mutation == 8:
                    t.flags = int(t.flags) | (1 << rng.randint(6, 15))
                elif mutation == 9:
                    t.timeout = 5  # timeout without pending
            elif (
                roll < self.two_phase_rate + self.balancing_rate
                + self.invalid_rate + self.conflict_rate
            ):
                pool = self.transfer_ids + batch_created_ids
                if pool:
                    t.id = rng.choice(pool)  # duplicate id (exists checks)
                    if rng.random() < 0.3:
                        t.amount += 1

            if rng.random() < self.chain_rate and len(events) < size - 1:
                t.flags = int(t.flags) | int(TransferFlags.linked)
            if t.id not in batch_created_ids:
                batch_created_ids.append(t.id)
                self.transfer_ids.append(t.id)
            events.append(t)
        return Operation.create_transfers, events

    def gen_lookup_batch(self, size: int, kind: str) -> tuple[Operation, list[int]]:
        rng = self.rng
        pool = self.account_ids if kind == "accounts" else self.transfer_ids
        ids = [
            rng.choice(pool) if pool and rng.random() > 0.2 else self._fresh_id()
            for _ in range(size)
        ]
        op = (
            Operation.lookup_accounts
            if kind == "accounts"
            else Operation.lookup_transfers
        )
        return op, ids
