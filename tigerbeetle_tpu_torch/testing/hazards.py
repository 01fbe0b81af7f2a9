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
  another, and a pending in that window posted after another insert there;
- `missing_tomb`: a post and a void of a missing pending whose lookup ends
  on a tombstone that a rollback left just before them in the request (an
  id of the broken chain shares the pending's first probe position);
- `missing_full`: a post and a void of a missing pending whose 64-slot
  window has no empty slot left: 64 inserts fill it first, so the lookup
  does not resolve and its last probe is another transfer's row.

The last two aim at what a lookup that finds nothing gives. The single-table
scan reads the row at the slot it returned (a tombstone, another key's row)
and probes the pending's accounts with that row's keys; the sharded scan
reads zeros. With `fill_tomb_window` applied to the single table's accounts,
the tombstone's keys do not resolve there, so `missing_tomb` sets
FAULT_SERIAL on the single table and not on the sharded ledger;
`missing_full` sets it on both (the pending's own probe).

`hazard_accounts()` are the accounts every request assumes (ledger 1).
The requests are made in plain Python and numpy from the caller's generator;
the tests hold the plain versions against the JAX package on them, and
`chip_smoke.py` holds the kernels against their plain versions on them.

`account_hazard_request` does the same for the serial account commit (K2
serial, K11as: csrc/account_walk.cuh), which plans every event against the
table as it was before the batch and re-probes an event only where a row
the batch wrote lies in its probe window at or before the position its
answers depend on (`stop`). Its cases, in ACCOUNT_CASES:

- `shared_window`: ids whose windows hold another id's first probe
  position at their `stop` (the rows before it filled first): that id's
  insert lands there, and they insert past it; a duplicate of each;
- `dup_live`: one id inserted, then again (exists, then with other flags
  and another code), and as the last link of a chain it breaks;
- `dup_after_rollback`: a chain broken by an invalid last link, then its
  ids again: they insert again, into their own tombstones;
- `rollback_frees_window`: a broken chain's tombstone frees the position
  another id's window stopped at: that id inserts into it;
- `window_full`: an id whose window is full but for one position (filled
  first) that an earlier insert takes: its lookup and free-slot probe do
  not resolve (FAULT_SERIAL), it writes nothing yet counts as applied, and
  its chain's rollback tombstones its last probe, another row; it then
  inserts into that tombstone;
- `tomb_window`: tombstones in a window before the batch (made first):
  inserts reuse them, lookups pass them; ids 0 and 2^128 - 1 (the empty and
  the tombstone key) probe their windows too;
- `chain_open_at_end`: a chain still open at the last event;
- `chains_across_groups`: chains that cross the walk's groups of 32 events:
  one broken by its last link (its rollback reaches back into the group
  before), whose first ids then insert again into their tombstones, one
  that holds, and one still open at the last event;
- `gate_tripped`: the load guard charged all n events trips (one shard one
  slot short): every code 0, nothing written;
- `pad_past_n`: events past n in the batch (duplicates, links) that must
  neither commit nor code.

`prepare_account_hazard` makes the table what a case assumes.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from tigerbeetle_tpu_torch.ops import hashtable as ht
from tigerbeetle_tpu_torch.types import Account, AccountFlags, Transfer, TransferFlags

ACCOUNT_CASES = ("shared_window", "dup_live", "dup_after_rollback", "rollback_frees_window",
                 "window_full", "tomb_window", "chain_open_at_end", "chains_across_groups",
                 "gate_tripped", "pad_past_n")
GATE_SHARD = 2  # the shard left one slot short by gate_tripped (0 on one table)

CASES = ("chain_break_reuse", "duplicate_id", "pending_post", "post_and_void",
         "hot_account", "shared_window", "missing_tomb", "missing_full")
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
    base = ht.hash_key4(_key4(ids), t_log2).numpy()
    owner = (owner_of_ids_np(ids, np.zeros(span, dtype=np.uint64), n_shards)
             if n_shards > 1 else np.zeros(span, dtype=np.int64))
    group = owner * (1 << t_log2) + base
    _, first, counts = np.unique(group, return_index=True, return_counts=True)
    g = group[first[np.argmax(counts >= k)]]
    hits = np.nonzero(group == g)[0][:k]
    if len(hits) < k:
        raise ValueError(f"no {k} ids share a window in [{start}, {start + span})")
    return [int(ids[i]) for i in hits]


def _key4(ids) -> torch.Tensor:
    ids = np.asarray(ids, dtype=np.uint64)
    key4 = np.zeros((len(ids), 4), dtype=np.uint32)
    key4[:, 0] = (ids & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    key4[:, 1] = (ids >> np.uint64(32)).astype(np.uint32)
    return torch.from_numpy(key4.view(np.int32))


def window_fill_ids(t_log2: int, n_shards: int, key_id: int, start: int) -> list[int]:
    """For each of the 64 probe positions of transfer id `key_id` on its
    owner shard, in probe order, the first id from `start` up on that shard
    whose first probe is that position: inserted in this order into a table
    where those positions are free, each lands on its own."""
    from tigerbeetle_tpu_torch.parallel.mesh import owner_of_ids_np

    def owner(ids):
        ids = np.asarray(ids, dtype=np.uint64)
        return (owner_of_ids_np(ids, np.zeros(len(ids), dtype=np.uint64), n_shards)
                if n_shards > 1 else np.zeros(len(ids), dtype=np.int64))

    pos = ht.probe_positions(_key4([key_id]), t_log2, ht.WINDOW_SCALAR)[0].numpy()
    span = 1 << 22
    ids = np.arange(start, start + span, dtype=np.uint64)
    base = ht.hash_key4(_key4(ids), t_log2).numpy()
    mine = owner(ids) == owner([key_id])[0]
    first = {}
    for i in np.nonzero(mine & np.isin(base, pos))[0]:
        first.setdefault(int(base[i]), int(ids[i]))
    if len(first) < len(pos):
        raise ValueError(f"ids from {start} miss {len(pos) - len(first)} of {key_id}'s window")
    return [first[int(p)] for p in pos]


def fill_tomb_window(acct_rows: np.ndarray, a_log2: int, rng) -> None:
    """In place: the empty rows of a single account table (int32 [2^a_log2
    + 1, 32]) at the 64 probe positions of the all-ones (tombstone) key get
    random words, so a probe of that key does not resolve."""
    tomb = torch.full((1, 4), -1, dtype=torch.int32)
    pos = ht.probe_positions(tomb, a_log2, ht.WINDOW_SCALAR)[0].numpy()
    empty = pos[(acct_rows[pos, :4] == 0).all(1)]
    acct_rows[empty] = rng.integers(1, 1 << 31, (len(empty), 32)).astype(np.int32)


def hazard_request(case: str, rng, t_log2: int, n_shards: int,
                   first_id: int = 1_000_000) -> list[Transfer]:
    """The request of `case` (one of CASES): 29-45 transfers over
    hazard_accounts() (`missing_full`: 76), ids from `first_id` up."""
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
    elif case == "missing_tomb":
        x, p = shared_window_ids(t_log2, n_shards, 2, first_id + 20_000)
        q.plain(3)
        q.plain(id_=x, flags=_LINKED)  # lands on p's first probe position
        q.plain(flags=_LINKED)
        q.plain(amount=0)  # the chain breaks: x's slot becomes a tombstone
        q.resolve(p, post=True)  # pending_transfer_not_found, its lookup on the tombstone
        q.plain(2)
        q.resolve(p, post=False)
        q.plain(25)
    elif case == "missing_full":
        p = q.fresh()
        q.plain(3)
        for f in window_fill_ids(t_log2, n_shards, p, first_id + 30_000):
            q.plain(id_=f)
        q.resolve(p, post=True)  # its window is full: the lookup does not resolve
        q.plain(2)
        q.resolve(p, post=False)
        q.plain(5)
    else:
        raise ValueError(f"unknown hazard case {case!r}")
    return q.events


# ----------------------------------------------------------------------
# the serial account commit (K2 serial, K11as)
# ----------------------------------------------------------------------


@dataclass
class AccountHazard:
    """A request of account_hazard_request and what it assumes of the
    table: `junk` rows (shard, slot) hold a live row of random words (made
    so where they are empty or tombstones), `tombs` rows are tombstones
    (where they are empty), and with `used` set, shard GATE_SHARD's
    `acct_used_slots` is that. The batch holds all `events`; n of them are
    committed."""

    events: list
    n: int
    used: int | None = None
    junk: list = field(default_factory=list)
    tombs: list = field(default_factory=list)


def _owner_np(ids, n_shards: int) -> np.ndarray:
    from tigerbeetle_tpu_torch.parallel.mesh import owner_of_ids_np

    ids = np.asarray(ids, dtype=np.uint64)
    if n_shards == 1:
        return np.zeros(len(ids), dtype=np.int64)
    return owner_of_ids_np(ids, np.zeros(len(ids), dtype=np.uint64), n_shards)


def _window(key_id: int, log2: int, n_shards: int):
    """(owner shard, the 64 probe positions) of id `key_id`."""
    pos = ht.probe_positions(_key4([key_id]), log2, ht.WINDOW_SCALAR)[0].numpy()
    return int(_owner_np([key_id], n_shards)[0]), pos


def window_ids(log2: int, n_shards: int, shard: int, pos: int, k: int, start: int,
               max_index: int = 3) -> list:
    """The first k ids from `start` up owned by `shard` whose probe window
    holds position `pos` at an index <= max_index: [(id, index), ...]."""
    out = []
    chunk = 1 << 16
    for lo in range(start, start + (1 << 26), chunk):
        ids = np.arange(lo, lo + chunk, dtype=np.uint64)
        pp = ht.probe_positions(_key4(ids), log2, max_index + 1).numpy()
        hit = (pp == pos) & (_owner_np(ids, n_shards) == shard)[:, None]
        for r in np.nonzero(hit.any(1))[0]:
            out.append((int(ids[r]), int(np.argmax(hit[r]))))
            if len(out) == k:
                return out
    raise ValueError(f"fewer than {k} ids from {start} hold position {pos} of shard {shard}")


def _acct(id_, linked=False, **kw) -> Account:
    kw.setdefault("ledger", 1)
    kw.setdefault("code", 1)
    return Account(id=id_, flags=int(AccountFlags.linked) if linked else 0, **kw)


def account_hazard_request(case: str, rng, a_log2: int, n_shards: int,
                           first_id: int = 5_000_000) -> AccountHazard:
    """The request of `case` (one of ACCOUNT_CASES), 11-100 accounts on ledger
    1 with ids from `first_id` up, and what it assumes of a table of 2^a_log2
    slots a shard over n_shards (1: one table) holding hazard_accounts()."""
    ev: list = []
    nxt = [first_id]

    def fresh() -> int:
        nxt[0] += 1
        return nxt[0]

    def plain(k: int) -> None:
        for _ in range(k):
            ev.append(_acct(fresh(), user_data_64=int(rng.integers(1, 1 << 40))))

    def bad(linked=False) -> None:  # ledger_must_not_be_zero
        ev.append(_acct(fresh(), linked, ledger=0))

    hz = AccountHazard(ev, 0)

    def before(key_id: int, j: int, what: list) -> None:
        """Rows of key_id's window before index j into `what` (junk: its
        lookup's stop is then position j, where an empty slot waits)."""
        shard, pos = _window(key_id, a_log2, n_shards)
        what.extend((shard, int(q)) for q in pos[:j])

    if case == "shared_window":
        a = fresh()
        sa, pa = _window(a, a_log2, n_shards)
        (b, jb), (c, jc) = window_ids(a_log2, n_shards, sa, int(pa[0]), 2, first_id + 10_000)
        before(b, jb, hz.junk)
        before(c, jc, hz.junk)
        plain(2)
        ev.append(_acct(a))  # lands on b's and c's stop
        ev.append(_acct(b))  # re-probed: inserts past a
        plain(1)
        ev.append(_acct(c))
        ev.append(_acct(b, user_data_64=7))  # exists_with_different_user_data_64
        ev.append(_acct(a))  # exists
        plain(10)
    elif case == "dup_live":
        x = fresh()
        plain(2)
        ev.append(_acct(x))
        plain(1)
        ev.append(_acct(x))  # exists
        ev.append(Account(id=x, ledger=1, code=1,  # exists_with_different_flags
                          flags=int(AccountFlags.debits_must_not_exceed_credits)))
        ev.append(_acct(x, code=2))  # exists_with_different_code
        y = fresh()
        ev.append(_acct(y, True))
        ev.append(_acct(x))  # exists: the chain breaks, y is tombstoned
        ev.append(_acct(y))  # inserts again
        plain(5)
    elif case == "dup_after_rollback":
        x, z = fresh(), fresh()
        plain(2)
        ev.append(_acct(x, True))
        ev.append(_acct(z, True))
        bad()  # the chain breaks: x and z tombstoned
        plain(1)
        ev.append(_acct(x))  # inserts again, into its tombstone
        ev.append(_acct(x))  # exists
        ev.append(_acct(z))
        plain(4)
    elif case == "rollback_frees_window":
        a, b = fresh(), fresh()
        sa, pa = _window(a, a_log2, n_shards)
        ((c, jc),) = window_ids(a_log2, n_shards, sa, int(pa[0]), 1, first_id + 20_000)
        before(c, jc, hz.junk)
        plain(2)
        ev.append(_acct(a, True))  # lands on c's stop
        ev.append(_acct(b, True))
        bad()  # a's slot becomes a tombstone
        ev.append(_acct(c))  # re-probed: inserts into the tombstone
        ev.append(_acct(a))  # inserts past c
        ev.append(_acct(b))
        ev.append(_acct(c))  # exists
        plain(3)
    elif case == "window_full":
        z = fresh()
        sz, pz = _window(z, a_log2, n_shards)
        ((k, jk),) = window_ids(a_log2, n_shards, sz, int(pz[0]), 1, first_id + 30_000,
                                max_index=ht.WINDOW_SCALAR - 1)
        _, pk = _window(k, a_log2, n_shards)
        hz.junk.extend((sz, int(q)) for j, q in enumerate(pk) if j != jk)
        plain(2)
        ev.append(_acct(z))  # takes the last free position of k's window
        plain(1)
        ev.append(_acct(k, True))  # unresolved: writes nothing, applied, FAULT_SERIAL
        ev.append(_acct(fresh(), True))
        bad()  # the rollback tombstones k's last probe
        ev.append(_acct(k))  # inserts into that tombstone (still unresolved)
        ev.append(_acct(k))  # exists, found at its last probe
        plain(3)
    elif case == "tomb_window":
        t0 = fresh()
        s0, p0 = _window(t0, a_log2, n_shards)
        hz.tombs.extend((s0, int(q)) for q in p0[:3])
        ((t1, j1),) = window_ids(a_log2, n_shards, s0, int(p0[0]), 1, first_id + 40_000)
        before(t1, j1, hz.junk)
        plain(2)
        ev.append(_acct(0))  # id_must_not_be_zero: probes the empty key's window
        ev.append(_acct((1 << 128) - 1))  # id_must_not_be_int_max: the tombstone key's
        ev.append(_acct(t0))  # passes three tombstones, inserts into the first
        ev.append(_acct(t1))  # its free slot was t0's tombstone: re-probed
        ev.append(_acct(t0, user_data_128=5))  # exists_with_different_user_data_128
        ev.append(_acct(fresh(), True))
        ev.append(_acct(t1))  # exists: the chain breaks
        plain(3)
    elif case == "chain_open_at_end":
        plain(3)
        for _ in range(2):
            ev.append(_acct(fresh(), True))
        plain(3)
        for _ in range(3):  # linked_event_chain_open at the last, the others 1
            ev.append(_acct(fresh(), True))
    elif case == "chains_across_groups":
        plain(20)
        chain = [fresh() for _ in range(25)]  # events 20-44
        ev.extend(_acct(c, True) for c in chain)
        bad()  # event 45 breaks it: all 25 rolled back, across events 31 | 32
        plain(5)
        ev.extend(_acct(c) for c in chain[:3])  # insert again, into their tombstones
        ev.extend(_acct(fresh(), True) for _ in range(20))  # events 54-73, across 63 | 64
        plain(4)  # the first ends that chain
        ev.extend(_acct(fresh(), True) for _ in range(22))  # events 78-99, open at the end
    elif case == "gate_tripped":
        plain(4)
        ev.append(_acct(fresh(), True))
        plain(15)
        hz.used = (1 << a_log2) // 2 - len(ev) + 1
    elif case == "pad_past_n":
        plain(6)
        ev.append(_acct(fresh(), True))
        plain(13)
        hz.n = len(ev)
        ev.extend(_acct(e.id, True) for e in ev[:8])  # past n: duplicates, links
        return hz
    else:
        raise ValueError(f"unknown account hazard case {case!r}")
    hz.n = len(ev)
    return hz


def prepare_account_hazard(acct_rows, used, hz: AccountHazard, rng) -> None:
    """In place: the account table ([2^a + 1, 32], or [S, 2^a + 1, 32]
    sharded; a numpy array of 32-bit words or an int32 torch tensor on any
    device) and `acct_used_slots` (0-d, or [S]) as `hz` assumes them."""
    is_torch = isinstance(acct_rows, torch.Tensor)
    rows = acct_rows if is_torch else acct_rows.view(np.int32)
    rows = rows if rows.ndim == 3 else rows[None]
    for shard, slot in hz.junk:
        key = rows[shard, slot, :4]
        if bool((key == 0).all()) or bool((key == -1).all()):
            words = rng.integers(1, 1 << 31, 32).astype(np.int32)
            rows[shard, slot] = torch.from_numpy(words).to(rows.device) if is_torch else words
    for shard, slot in hz.tombs:
        if bool((rows[shard, slot, :4] == 0).all()):
            rows[shard, slot] = -1
    if hz.used is not None:
        used[GATE_SHARD if used.ndim else ...] = hz.used
