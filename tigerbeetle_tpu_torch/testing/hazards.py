"""Hazard requests for the serial transfer commit's lookahead (K11ts).

The serial kernel resolves the lookups of later events ahead of the event
it commits, against the tables as they stand, and must then see every
write made in between: a rewritten account row, an insert into a probe
window, a fulfill word, a rollback's tombstones. Each request here aims at
one of those, among plain transfers that keep the lookahead busy:

- `chain_break_reuse`: a linked chain of twelve broken at its last link
  (its eleven inserts tombstoned), then the same ids again, whose inserts
  reuse the tombstones;
- `duplicate_id`: one id four times (equal, different amount, equal again)
  and a chain broken by a duplicate of its own first id;
- `pending_post`: pendings created, then posted or voided, a few events
  and a few dozen events later in the same request;
- `post_and_void`: a post then a void of one pending, a void then a post
  of another;
- `hot_account`: one debits-must-not-exceed-credits account in
  consecutive events (credits, debits past its limit, balancing debits
  clamped to what is left) and a credits-must-not-exceed-debits account
  under balancing credits;
- `shared_window`: transfer ids crafted with the port's `hash_key4` to
  share a first probe position on one owner shard, inserted one after
  another, and a pending in that window posted after another insert there.

`hazard_accounts()` are the accounts every request assumes (ledger 1).
The requests are made in plain Python and numpy from the caller's generator;
the tests hold the plain versions against the JAX package on them, and
`chip_smoke.py` holds the kernel against its plain version on them.
"""

from __future__ import annotations

import numpy as np
import torch

from tigerbeetle_tpu_torch.ops import hashtable as ht
from tigerbeetle_tpu_torch.types import Account, AccountFlags, Transfer, TransferFlags

CASES = ("chain_break_reuse", "duplicate_id", "pending_post", "post_and_void",
         "hot_account", "shared_window")
N_ACCOUNTS = 32
HOT_DR = 1  # debits_must_not_exceed_credits
HOT_CR = 2  # credits_must_not_exceed_debits
_LINKED = int(TransferFlags.linked)
_PENDING = int(TransferFlags.pending)
_POST = int(TransferFlags.post_pending_transfer)
_VOID = int(TransferFlags.void_pending_transfer)
_BAL_DR = int(TransferFlags.balancing_debit)
_BAL_CR = int(TransferFlags.balancing_credit)


def hazard_accounts() -> list[Account]:
    flags = {HOT_DR: int(AccountFlags.debits_must_not_exceed_credits),
             HOT_CR: int(AccountFlags.credits_must_not_exceed_debits)}
    return [Account(id=i, ledger=1, code=1, flags=flags.get(i, 0))
            for i in range(1, N_ACCOUNTS + 1)]


class _Request:
    def __init__(self, rng, first_id: int):
        self.rng = rng
        self.next_id = first_id
        self.events: list[Transfer] = []

    def fresh(self) -> int:
        self.next_id += 1
        return self.next_id

    def add(self, **kw) -> Transfer:
        kw.setdefault("ledger", 1)
        kw.setdefault("code", 1)
        t = Transfer(**kw)
        self.events.append(t)
        return t

    def plain(self, k: int = 1, id_=None, dr=None, cr=None, amount=None, flags=0):
        """k plain transfers between the accounts 3.. (the hot ones left
        alone unless named)."""
        for _ in range(k):
            a, b = self.rng.choice(np.arange(3, N_ACCOUNTS + 1), 2, replace=False)
            self.add(id=self.fresh() if id_ is None else id_,
                     debit_account_id=int(a) if dr is None else dr,
                     credit_account_id=int(b) if cr is None else cr,
                     amount=int(self.rng.integers(1, 100)) if amount is None else amount,
                     flags=flags)

    def pending(self, amount: int) -> int:
        pid = self.fresh()
        self.plain(id_=pid, amount=amount, flags=_PENDING)
        return pid

    def resolve(self, pid: int, post: bool, amount: int = 0) -> None:
        self.add(id=self.fresh(), pending_id=pid, amount=amount, ledger=0, code=0,
                 flags=_POST if post else _VOID)


def shared_window_ids(t_log2: int, n_shards: int, k: int, start: int) -> list[int]:
    """k transfer ids from `start` up whose first probe position (and owner
    shard, with n_shards > 1) are equal: each later one's probe passes the
    earlier ones' slots."""
    from tigerbeetle_tpu_torch.parallel.mesh import owner_of_ids_np

    span = 1 << 18
    ids = np.arange(start, start + span, dtype=np.uint64)
    key4 = np.zeros((span, 4), dtype=np.uint32)
    key4[:, 0] = (ids & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    key4[:, 1] = (ids >> np.uint64(32)).astype(np.uint32)
    base = ht.hash_key4(torch.from_numpy(key4.view(np.int32)), t_log2).numpy()
    owner = (owner_of_ids_np(ids, np.zeros(span, dtype=np.uint64), n_shards)
             if n_shards > 1 else np.zeros(span, dtype=np.int64))
    group = owner * (1 << t_log2) + base
    _, first, counts = np.unique(group, return_index=True, return_counts=True)
    g = group[first[np.argmax(counts >= k)]]
    hits = np.nonzero(group == g)[0][:k]
    if len(hits) < k:
        raise ValueError(f"no {k} ids share a window in [{start}, {start + span})")
    return [int(ids[i]) for i in hits]


def hazard_request(case: str, rng, t_log2: int, n_shards: int,
                   first_id: int = 1_000_000) -> list[Transfer]:
    """The request of `case` (one of CASES): 29-45 transfers over
    hazard_accounts(), ids from `first_id` up."""
    q = _Request(rng, first_id)
    if case == "chain_break_reuse":
        q.plain(4)
        chain = [q.fresh() for _ in range(12)]
        for c in chain[:-1]:
            q.plain(id_=c, flags=_LINKED)
        q.plain(id_=chain[-1], amount=0)  # amount_must_not_be_zero: the chain breaks
        q.plain(3)
        for c in chain[:6]:  # the same ids again: inserts reuse the tombstones
            q.plain(id_=c)
        for _ in range(4):  # a chain that holds
            q.plain(flags=_LINKED)
        q.plain(2)
    elif case == "duplicate_id":
        x = q.fresh()
        q.plain(2)
        q.plain(id_=x, dr=3, cr=4, amount=7)
        q.plain(1)
        q.plain(id_=x, dr=3, cr=4, amount=7)  # exists
        q.plain(2)
        q.plain(id_=x, dr=3, cr=4, amount=8)  # exists_with_different_amount
        q.plain(10)
        q.plain(id_=x, dr=3, cr=4, amount=7)
        y = q.fresh()
        q.plain(id_=y, flags=_LINKED)
        q.plain(flags=_LINKED)
        q.plain(id_=y)  # a duplicate of the chain's first id breaks it
        q.plain(3)
        q.plain(id_=y, dr=5, cr=6, amount=9)  # the rolled-back id commits now
        q.plain(4)
    elif case == "pending_post":
        p1 = q.pending(50)
        q.plain(1)
        p2 = q.pending(70)
        q.plain(2)
        q.resolve(p1, post=True, amount=20)
        p3 = q.pending(90)
        q.plain(3)
        q.resolve(p2, post=False)
        q.plain(30)
        q.resolve(p3, post=True)
        q.resolve(p1, post=True)  # already posted
        q.plain(2)
    elif case == "post_and_void":
        p = q.pending(40)
        q.plain(2)
        q.resolve(p, post=True)
        q.resolve(p, post=False)  # pending_transfer_already_posted
        r = q.pending(60)
        q.plain(1)
        q.resolve(r, post=False)
        q.resolve(r, post=True)  # pending_transfer_already_voided
        q.plain(30)
    elif case == "hot_account":
        for _ in range(4):
            q.plain(dr=5, cr=HOT_DR, amount=100)
        for k in range(16):
            if k % 4 == 3:
                q.plain(dr=HOT_DR, cr=6, amount=0, flags=_BAL_DR)
            else:
                q.plain(dr=HOT_DR, cr=6, amount=45)  # past the limit: exceeds_credits
        q.plain(dr=HOT_CR, cr=7, amount=30)
        for k in range(8):
            q.plain(dr=8, cr=HOT_CR, amount=0 if k % 2 else 12,
                    flags=_BAL_CR if k % 2 else 0)
        q.plain(dr=5, cr=HOT_DR, amount=10)
        q.plain(dr=HOT_DR, cr=6, amount=0, flags=_BAL_DR)
        q.plain(8)
    elif case == "shared_window":
        a, b, c, d, e = shared_window_ids(t_log2, n_shards, 5, first_id + 10_000)
        q.plain(2)
        q.plain(id_=a)
        q.plain(id_=b)  # probes past a's slot
        q.plain(1)
        q.plain(id_=c, amount=50, flags=_PENDING)
        q.plain(id_=d)  # an insert into the pending's window before its post
        q.add(id=e, pending_id=c, amount=30, ledger=0, code=0, flags=_POST)
        q.plain(id_=b)  # exists
        q.plain(20)
    else:
        raise ValueError(f"unknown hazard case {case!r}")
    return q.events
