"""Requests for the fast create_accounts commit (K2 fast, K11af).

Both kernels are one launch of one thread-block cluster
(csrc/acct_commit.cuh): a lane an event probes its id's window and
validates, the claim rounds give every ok event a free slot of its owner's
table (four rounds, the lowest lane winning each slot), one warp decides the
fault gate, and the rows are written only if it passed. Each case aims at
one part of that:

- `shared_window`: groups of six new ids sharing a probe window, at random
  lanes. Where the table is small enough to search (ids sharing first
  position and step on one owner among at most 2^24 buckets) they share the
  whole window, which is free: each round one of them wins, so two lose all
  four rounds; else they share the first position and every other position
  of each one's window is taken, so one wins and five find no slot. Either
  way FAULT_CLAIM and nothing is written;
- `shared_first`: groups of six new ids sharing only a first position, which
  is free: one wins in round 0, the others take their own next free slots in
  later rounds, and every row is written;
- `window_full`: three new ids whose windows hold only live rows: their
  lookups do not resolve and they find no slot (FAULT_PROBE | FAULT_CLAIM);
- `window_tombs`: three new ids whose windows hold live rows and two
  tombstones but no empty slot: their lookups do not resolve, their claims
  take the first tombstone (FAULT_PROBE alone);
- `capacity_at`, `capacity_past`: the load guard exactly at its limit, and
  one past it (FAULT_CAPACITY): on one table the used slots plus the batch's
  ok count against half the slots; sharded, shard 2's used slots plus the
  inserts it owns against half a shard, the other shards below;
- `sticky`: a fault word set before the batch: nothing is written;
- `all_fail`: every event fails its ladder, so no lane wants a slot; the
  count, used slots and commit_ts stay as they were;
- `padding`: lanes from n up hold valid-looking new accounts, which get code
  0 and are not written;
- `tomb_reuse`: tombstones at the first probe position of every other new
  id, which the commit reuses;
- `ts_below_commit`: a batch timestamp below the stored commit_ts, which the
  commit sets (it is assigned, not maxed);
- `ts_wrap`: a batch timestamp below n, so the events' timestamps wrap and
  the last ok timestamp is an unsigned maximum;
- `dup_id`: pairs of events with the same new id: both pass validation
  against the table before the batch and take distinct slots.

Every case but `all_fail` also holds failing events (ids that exist, a zero
id, a zero ledger or code, a reserved field, padding flags).

`account_case(name, cap_log2, n_shards, B, rng)` returns a dict: `acct_rows`
(uint32 [2^cap_log2 + 1, 32], or [n_shards, 2^cap_log2 + 1, 32]: the table
before the batch, about a fifth live and a twentieth tombstones), `used`
(uint64, a scalar or [n_shards]), `count`, `commit_ts` and `fault` (the
state's scalars), `rows` ([B, 32] uint32: the batch), `n`, `timestamp` and
`want_fault` (the fault word the commit must leave). `n_shards` None is the
single table. Made with numpy from the caller's generator; the tests hold
both plain versions against the JAX package on them, and `chip_smoke.py`
holds both kernels against their plain versions on them.
"""

from __future__ import annotations

import functools

import numpy as np

from tigerbeetle_tpu_torch import types
from tigerbeetle_tpu_torch.ops import hashtable as ht
from tigerbeetle_tpu_torch.parallel.mesh import owner_of_ids_np
from tigerbeetle_tpu_torch.testing.install_cases import _key4, _window

CASES = ("shared_window", "shared_first", "window_full", "window_tombs", "capacity_at",
         "capacity_past", "sticky", "all_fail", "padding", "tomb_reuse", "ts_below_commit",
         "ts_wrap", "dup_id")
GROUP = 6  # new ids a shared window or first position holds
FAULT_PROBE, FAULT_CLAIM, FAULT_OVERFLOW, FAULT_CAPACITY = 1, 2, 4, 16
TOMB = 0xFFFFFFFF
COMMIT_TS = 10**12
FAILING = 8  # failing events in a batch (ids that exist, then the ladder's)


def _owners(ids, n_shards) -> np.ndarray:
    ids = np.asarray(ids, dtype=np.uint64)
    if n_shards is None:
        return np.zeros(len(ids), dtype=np.int64)
    return owner_of_ids_np(ids, np.zeros_like(ids), n_shards).astype(np.int64)


def exact_windows(cap_log2: int, n_shards) -> bool:
    """Whether groups sharing a whole window can be searched for: 2^22 ids
    over at most 2^24 (owner, first position, step) buckets."""
    return 2 * cap_log2 + int(np.log2(n_shards or 1)) <= 24


@functools.lru_cache(maxsize=None)
def _groups(cap_log2: int, n_shards, exact: bool, count: int, start: int = 1 << 32) -> tuple:
    """`count` groups of GROUP ids from `start` up on one owner sharing the
    first probe position (and, with `exact`, the step: the whole window); a
    group's (owner, first position) is no other group's."""
    span = 1 << 22
    ids = np.arange(start, start + span, dtype=np.uint64)
    k4 = _key4(ids)
    key = ht.hash_key4(k4, cap_log2).numpy().astype(np.int64)
    width = 1 << cap_log2
    if exact:
        key = key * width + ht.probe_step(k4, cap_log2).numpy()
        width <<= cap_log2
    key = key + _owners(ids, n_shards) * width
    order = np.argsort(key, kind="stable")
    sk = key[order]
    starts = np.concatenate([[0], np.flatnonzero(np.diff(sk)) + 1])
    sizes = np.diff(np.concatenate([starts, [len(sk)]]))
    out, firsts = [], set()
    for s0 in starts[sizes >= GROUP]:
        g = ids[np.sort(order[s0:s0 + GROUP])]
        first = (int(_owners(g[:1], n_shards)[0]), int(_window(g[:1], cap_log2)[0, 0]))
        if first not in firsts:
            firsts.add(first)
            out.append(tuple(int(x) for x in g))
            if len(out) == count:
                return tuple(out)
    raise ValueError(f"fewer than {count} groups of {GROUP} at 2^{cap_log2}")


def _base_table(cap_log2: int, rng) -> np.ndarray:
    """One shard's table: about a fifth live rows (ids in [2^63, 2^64),
    above every new id), a twentieth tombstones, a random dump row."""
    n = 1 << cap_log2
    rows = np.zeros((n + 1, 32), dtype=np.uint32)
    kind = rng.integers(0, 60, n)
    live = kind < 12
    rows[:n][live] = _live(int(live.sum()), rng)
    rows[:n][(kind >= 12) & (kind < 15), :4] = TOMB
    rows[n] = rng.integers(0, 1 << 32, 32, dtype=np.uint32)
    return rows


def _live(k: int, rng) -> np.ndarray:
    rows = rng.integers(0, 1 << 32, (k, 32), dtype=np.uint32)
    rows[:, 2:4] = 0
    rows[:, 1] |= np.uint32(1 << 31)
    return rows


def _accounts(ids, rng) -> np.ndarray:
    """Valid new accounts with ids `ids` as [len(ids), 32] uint32 rows."""
    a = np.zeros(len(ids), dtype=types.ACCOUNT_DTYPE)
    a["id_lo"] = np.asarray(ids, dtype=np.uint64)
    a["user_data_128_lo"] = rng.integers(0, 1 << 62, len(ids))
    a["user_data_64"] = rng.integers(0, 1 << 62, len(ids))
    a["user_data_32"] = rng.integers(0, 1 << 31, len(ids))
    a["ledger"] = rng.integers(1, 4, len(ids))
    a["code"] = rng.integers(1, 100, len(ids))
    a["flags"] = rng.choice([0, 1 << 1, 1 << 2], len(ids))  # no linked flag
    return np.ascontiguousarray(a).view(np.uint32).reshape(len(ids), 32).copy()


def _fail(rows, lanes, tables, cap_log2: int, n_shards, rng) -> None:
    """Make the events at `lanes` fail: the first two find their ids in
    their owner's table (a live row at the first probe position, or the
    next where the other took it: exists, with differences), the rest one
    rung of the ladder each."""
    a = rows.reshape(-1).view(types.ACCOUNT_DTYPE)
    placed = set()
    for k, lane in enumerate(lanes):
        if k < 2:  # past a row placed here before, which the lookup passes
            owner = _owners(a["id_lo"][lane:lane + 1], n_shards)[0]
            win = _window(a["id_lo"][lane:lane + 1], cap_log2)[0]
            pos = next(int(p) for p in win if (owner, int(p)) not in placed)
            placed.add((owner, pos))
            tables[owner, pos] = _live(1, rng)
            tables[owner, pos, :4] = rows[lane, :4]
        elif k == 2:
            a["id_lo"][lane] = 0  # id_must_not_be_zero
        elif k == 3:
            a["ledger"][lane] = 0  # ledger_must_not_be_zero
        elif k == 4:
            a["code"][lane] = 0  # code_must_not_be_zero
        elif k == 5:
            a["reserved"][lane] = 1  # reserved_field
        elif k == 6:
            a["flags"][lane] |= 1 << 15  # reserved_flag
        else:
            a["debits_pending_lo"][lane] = 7  # debits_pending_must_be_zero


def _unstarve(rows, ids, lanes, tables, cap_log2: int, n_shards, rng) -> None:
    """Give each event at `lanes` whose window the case filled (no empty
    slot on its owner) a new id whose window has one."""
    taken = set(int(x) for x in ids)
    for lane in lanes:
        while True:
            k = ids[lane:lane + 1]
            if (tables[_owners(k, n_shards)[0], _window(k, cap_log2)[0], :4] == 0).all(-1).any():
                break
            new = int(rng.integers(1, 1 << 31))
            if new not in taken:
                taken.add(new)
                ids[lane] = new
                rows[lane, 0], rows[lane, 1] = new & TOMB, new >> 32


def account_case(name: str, cap_log2: int, n_shards, B: int, rng) -> dict:
    """The table, scalars, batch and expected fault of case `name` at
    2^cap_log2 slots a table (n_shards tables, or one for None), B lanes."""
    if name not in CASES:
        raise ValueError(f"unknown account case {name!r}")
    S = n_shards or 1
    half = (1 << cap_log2) // 2
    tables = np.stack([_base_table(cap_log2, rng) for _ in range(S)])
    occupied = ~(tables[:, :-1, :4] == 0).all(-1)
    used = occupied.sum(1).astype(np.uint64)
    count = int((occupied & ~(tables[:, :-1, :4] == TOMB).all(-1)).sum())
    n = B if name != "padding" else B - B // 4 - 5
    if 4 * B > S * half:
        raise ValueError(f"{B} lanes would crowd {S} x 2^{cap_log2} slots")
    ids = rng.permutation(np.unique(rng.integers(1, 1 << 31, 2 * B, dtype=np.uint64)))[:B]
    rows = _accounts(ids, rng)
    lanes = rng.permutation(n)
    failing = lanes[:FAILING] if name != "all_fail" else np.arange(n)
    free_lanes = lanes[FAILING:]
    fault, want, timestamp, commit_ts = 0, 0, COMMIT_TS + 10 * B, COMMIT_TS
    _fail(rows, failing, tables, cap_log2, n_shards, rng)

    def put_ids(at, new_ids):
        rows[at, 0] = (np.asarray(new_ids, dtype=np.uint64) & np.uint64(TOMB)).astype(np.uint32)
        rows[at, 1] = (np.asarray(new_ids, dtype=np.uint64) >> np.uint64(32)).astype(np.uint32)

    def fill(owner, pos):  # make these positions live (ids above every new id)
        tables[owner, pos] = _live(len(pos), rng)

    if name in ("shared_window", "shared_first"):
        exact = name == "shared_window" and exact_windows(cap_log2, n_shards)
        n_groups = max(1, B // 64)
        groups = np.array(_groups(cap_log2, n_shards, exact, n_groups), dtype=np.uint64)
        at = free_lanes[:n_groups * GROUP]
        put_ids(at, groups.ravel())
        ids[at] = groups.ravel()
        win = _window(groups.ravel(), cap_log2)
        own = _owners(groups.ravel(), n_shards)
        if exact:  # the windows free, so the rounds decide
            tables[own[:, None], win] = 0
        elif name == "shared_window":  # only the first positions free
            for o, w in zip(own, win):
                fill(o, w[1:])
        tables[own, win[:, 0]] = 0
        want = FAULT_CLAIM if name == "shared_window" else 0
    elif name in ("window_full", "window_tombs"):
        at = free_lanes[:3]
        win = _window(ids[at], cap_log2)
        own = _owners(ids[at], n_shards)
        for o, w in zip(own, win):
            fill(o, w)
        if name == "window_tombs":
            tables[own[:, None], win[:, [5, 17]], :4] = TOMB
        want = FAULT_PROBE | (FAULT_CLAIM if name == "window_full" else 0)
    elif name == "sticky":
        fault = want = FAULT_OVERFLOW
    elif name == "tomb_reuse":
        at = free_lanes[::2]
        win = _window(ids[at], cap_log2)
        own = _owners(ids[at], n_shards)
        tables[own, win[:, 0]] = 0
        tables[own, win[:, 0], :4] = TOMB
    elif name == "ts_below_commit":
        commit_ts, timestamp = COMMIT_TS * 1000, COMMIT_TS
    elif name == "ts_wrap":
        timestamp = n // 3
    elif name == "dup_id":
        at = free_lanes[:8]
        rows[at[1::2], :4] = rows[at[0::2], :4]
        ids[at[1::2]] = ids[at[0::2]]
    # (padding: lanes n.. hold valid new accounts; the others as made)
    if name in ("shared_window", "window_full", "window_tombs"):
        _unstarve(rows, ids, np.setdiff1d(free_lanes, at), tables, cap_log2, n_shards, rng)

    # the inserts each shard owns if every event but the failing ones is ok
    ins = np.bincount(_owners(ids[free_lanes], n_shards), minlength=S).astype(np.uint64)
    if name in ("capacity_at", "capacity_past"):
        s = 0 if n_shards is None else min(2, S - 1)
        used[s] = np.uint64(half) - ins[s] + np.uint64(name == "capacity_past")
        want = FAULT_CAPACITY if name == "capacity_past" else 0
    else:
        assert (used + ins <= np.uint64(half)).all(), "the load guard would trip"
    return {
        "acct_rows": tables if n_shards else tables[0],
        "used": used if n_shards else used[0],
        "count": count, "commit_ts": commit_ts, "fault": fault,
        "rows": rows, "n": n, "timestamp": timestamp, "want_fault": want,
    }
