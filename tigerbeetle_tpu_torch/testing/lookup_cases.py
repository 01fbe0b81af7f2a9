"""Cases for the batched lookups: K1 (`table_lookup_plain` of
models/ledger.py, csrc/lookup.cu) and K11l (`lookup_plain` of
parallel/mesh.py, csrc/mesh_lookup.cu).

On the card a group of eight threads walks a key's probe chain, reads the
probed slot's whole row at every probe and keeps in registers the row the
lookup returns: the hit's, else the first free probe's (empty or tombstone,
stale words and all), else the last probe's. So every lane's answer must
be right, found or not, whatever ends its chain. Each case crafts the
chains of some keys (the crafted lanes, at random lanes of the batch, with
no two crafted chains sharing a slot); the other lanes look up ids the
table holds or does not hold:

- `first_hit`: the key at its first probe;
- `hit_after_tombs`: one to five tombstones, their other words nonzero,
  then the key;
- `miss_after_tombs`: one to five such tombstones, then an empty slot: not
  found, resolved, the first tombstone's row;
- `miss_empty_first`: an empty first probe whose other words are nonzero:
  not found, resolved, that row;
- `unresolved_tomb`: all WINDOW probes other keys but one tombstone: not
  resolved, the tombstone's row;
- `unresolved_full`: all WINDOW probes other keys: not resolved, the last
  probe's row;
- `special_keys`: the all-zero key (its first probe an empty slot with
  nonzero words) and the all-ones key (two tombstones, then an empty slot),
  which are never found;
- `repeated`: one present key (after two tombstones) in about half the
  lanes and one absent key (an empty first probe) in about a quarter;
- `exhausted`: every slot of a table live or a tombstone (of the sharded
  table, one shard's): its absent keys do not resolve (the first tombstone
  of their window, else the last probe).

`lookup_case(name, cap_log2, n, rng, n_shards=0)` returns a dict of numpy
arrays: `rows` (uint32 [2^cap_log2 + 1, 32], or [n_shards, 2^cap_log2 + 1,
32] for the sharded table: each shard's table about 30% live, 5%
tombstones, a random dump row), `key4` (uint32 [n, 4]) and, for the crafted
lanes (`crafted`, bool [n]), what their chains are built to give: `found`,
`resolved` (bool [n]) and `slot` (int64 [n], the row of the answer as an
index into the tables flattened to [-1, 32]; -1 elsewhere). Made with numpy
(the probe positions and owners with the port's own hash functions) from
the caller's generator; the tests hold the plain versions against the JAX
package on them, and `chip_smoke.py` holds the kernels against the plain
versions on them.
"""

from __future__ import annotations

import numpy as np
import torch

from tigerbeetle_tpu_torch.ops import hashtable as ht

CASES = ("first_hit", "hit_after_tombs", "miss_after_tombs", "miss_empty_first",
         "unresolved_tomb", "unresolved_full", "special_keys", "repeated", "exhausted")
SIZES = (1, 33, 8190)  # a lane; a warp's four groups and one more; a request
LOG2_CPU = 12
LOG2_CHIP = 16
SHARDS = (1, 8)
W = ht.WINDOW
TOMB = 0xFFFF_FFFF
LIVE_SHARE, TOMB_SHARE = 0.30, 0.05
ZERO_KEY = np.zeros(4, dtype=np.uint32)
ONES_KEY = np.full(4, TOMB, dtype=np.uint32)


def _words(rng, n: int) -> np.ndarray:
    return rng.integers(0, 1 << 32, (n, 32), dtype=np.uint64).astype(np.uint32)


def _keys(rng, n: int) -> np.ndarray:
    """n random keys, never all zero nor all ones."""
    k = rng.integers(0, 1 << 32, (n, 4), dtype=np.uint64).astype(np.uint32)
    k[:, 0] |= np.uint32(1)
    k[:, 3] &= np.uint32(0x7FFF_FFFF)
    return k


def _windows(key4: np.ndarray, cap_log2: int) -> np.ndarray:
    """[n, W] probe positions of each key."""
    return ht.probe_positions(torch.from_numpy(key4.view(np.int32)), cap_log2, W).numpy()


def _owners(key4: np.ndarray, n_shards: int) -> np.ndarray:
    from tigerbeetle_tpu_torch.parallel.mesh import owner_of_ids_np

    k = key4.astype(np.uint64)
    lo = k[:, 0] | (k[:, 1] << np.uint64(32))
    hi = k[:, 2] | (k[:, 3] << np.uint64(32))
    return owner_of_ids_np(lo, hi, n_shards)


def _base(S: int, cap_log2: int, rng):
    """S tables about LIVE_SHARE live (each key at the first empty slot of
    its window, as an insert places it; keys placed in rounds, the first of
    a round's claimants of a slot winning it) and TOMB_SHARE tombstones,
    with random dump rows; and the live keys."""
    cap = 1 << cap_log2
    rows = np.zeros((S, cap + 1, 32), dtype=np.uint32)
    rows[:, cap] = _words(rng, S)
    live = []
    for s in range(S):
        keys = _keys(rng, int(cap * LIVE_SHARE))
        pos = _windows(keys, cap_log2)
        taken = np.zeros(cap, dtype=bool)
        while len(keys):
            free = ~taken[pos]
            want = np.flatnonzero(free.any(1))
            target = pos[want, free[want].argmax(1)]
            _, first = np.unique(target, return_index=True)
            won = want[first]
            at = target[first]
            rows[s, at] = _words(rng, len(at))
            rows[s, at, :4] = keys[won]
            taken[at] = True
            live.append(keys[won])
            lost = np.setdiff1d(want, won)
            keys, pos = keys[lost], pos[lost]
        tombs = rng.choice(cap, int(cap * TOMB_SHARE), replace=False)
        rows[s, tombs, 4:] = _words(rng, len(tombs))[:, 4:]
        rows[s, tombs, :4] = TOMB
    return rows, np.concatenate(live)


class _Crafter:
    """Writes crafted chains into the tables, no two sharing a slot. A
    chain's key, owner shard and window come precomputed."""

    def __init__(self, rows, rng):
        self.rows = rows
        self.claimed = [set() for _ in range(rows.shape[0])]
        self.pool = _words(rng, 1024)  # the other words of crafted rows
        self.used = 0

    def fits(self, s: int, pos, span: int) -> bool:
        p = set(pos[:span].tolist())
        return len(p) == span and not self.claimed[s] & p

    def flat(self, s: int, p) -> int:
        return s * self.rows.shape[1] + int(p)

    def put(self, s: int, p, key) -> None:
        """Slot p of shard s: a row of nonzero words under `key`."""
        self.rows[s, p] = self.pool[self.used % len(self.pool)] | np.uint32(1)
        self.rows[s, p, :4] = key
        self.used += 1
        self.claimed[s].add(int(p))

    def chain(self, key, s: int, pos, kinds) -> tuple:
        """Lay `kinds` ("tomb", "empty", "hit", "other") on the first
        probes `pos` of key (owned by shard s); returns (found, resolved,
        flat answer slot) as table_lookup gives them."""
        free = None
        for j, kind in enumerate(kinds):
            other = ONES_KEY if kind == "tomb" else ZERO_KEY if kind == "empty" else key \
                if kind == "hit" else self.pool[self.used % len(self.pool), :4] | np.uint32(1)
            self.put(s, pos[j], other)
            if kind == "hit":
                return True, True, self.flat(s, pos[j])
            if free is None and kind in ("tomb", "empty"):
                free = pos[j]
            if kind == "empty":
                return False, True, self.flat(s, free)
        return False, False, self.flat(s, pos[len(kinds) - 1] if free is None else free)


def _placed(keys, cap_log2: int, S: int):
    """Each key with its owner shard and window."""
    owners = _owners(keys, S) if S > 1 else np.zeros(len(keys), dtype=np.int64)
    return zip(keys, owners.tolist(), _windows(keys, cap_log2))


def _some(rng, n: int, share: float, first: int) -> np.ndarray:
    """About `share` of n lanes, the first `first` of them always."""
    lanes = rng.random(n) < share
    lanes[:first] = True
    return lanes


def _kinds(name: str, rng) -> list:
    t = int(rng.integers(1, 6))
    if name == "first_hit":
        return ["hit"]
    if name == "hit_after_tombs":
        return ["tomb"] * t + ["hit"]
    if name == "miss_after_tombs":
        return ["tomb"] * t + ["empty"]
    if name == "miss_empty_first":
        return ["empty"]
    kinds = ["other"] * W
    if name == "unresolved_tomb":
        kinds[int(rng.integers(0, W))] = "tomb"
    return kinds


def lookup_case(name: str, cap_log2: int, n: int, rng, n_shards: int = 0) -> dict:
    """The tables, keys and crafted answers of case `name` at 2^cap_log2
    slots (a table, or n_shards of them) and n lanes."""
    if name not in CASES:
        raise ValueError(f"unknown lookup case {name!r}")
    S = max(n_shards, 1)
    cap = 1 << cap_log2
    rows, live = _base(S, cap_log2, rng)
    key4 = np.where((rng.random(n) < 0.5)[:, None],
                    live[rng.integers(0, len(live), n)], _keys(rng, n))
    crafted = np.zeros(n, dtype=bool)
    found = np.zeros(n, dtype=bool)
    resolved = np.zeros(n, dtype=bool)
    slot = np.full(n, -1, dtype=np.int64)
    c = _Crafter(rows, rng)

    def mark(lanes, key, answer):
        key4[lanes] = key
        crafted[lanes] = True
        found[lanes], resolved[lanes], slot[lanes] = answer

    if name == "special_keys":
        lanes = _some(rng, n, 0.5, 2)
        for (key, s, pos), kinds, parity in (
                (next(_placed(ZERO_KEY[None], cap_log2, S)), ["empty"], 0),
                (next(_placed(ONES_KEY[None], cap_log2, S)), ["tomb", "tomb", "empty"], 1)):
            mark(lanes & (np.arange(n) % 2 == parity), key, c.chain(key, s, pos, kinds))
    elif name == "repeated":
        pick = rng.random(n)
        pick[0] = 0.0  # the present key in the first lane
        for lanes, kinds in ((pick < 0.5, ["tomb", "tomb", "hit"]), (pick >= 0.75, ["empty"])):
            key, s, pos = next(p for p in _placed(_keys(rng, 64), cap_log2, S)
                               if c.fits(p[1], p[2], len(kinds)))
            mark(lanes, key, c.chain(key, s, pos, kinds))
    elif name == "exhausted":
        full = int(rng.integers(0, S))
        body = rows[full, :cap]
        empty = np.flatnonzero((body[:, :4] == 0).all(1))
        body[empty] = _words(rng, len(empty))
        body[empty, :4] = _keys(rng, len(empty))
        lanes = np.flatnonzero(_some(rng, n, 0.5, 1))
        cand = _keys(rng, 4 * S * len(lanes) + 64)
        mine = [p for p in _placed(cand, cap_log2, S) if p[1] == full]
        for lane, (key, s, pos) in zip(lanes, mine):
            tomb = np.flatnonzero((body[pos, :4] == TOMB).all(1))
            mark(lane, key, (False, False, c.flat(s, pos[tomb[0]] if len(tomb) else pos[-1])))
    else:
        budget = cap // 2
        cand = list(_placed(_keys(rng, 4 * n), cap_log2, S))
        for i, lane in enumerate(rng.permutation(n)):
            kinds = _kinds(name, rng)
            pick = next((p for p in cand[4 * i:4 * i + 4] if c.fits(p[1], p[2], len(kinds))),
                        None)
            if pick is None or len(c.claimed[pick[1]]) + len(kinds) > budget:
                continue
            mark(lane, pick[0], c.chain(*pick, kinds))
    return {"rows": rows if n_shards else rows[0], "key4": key4, "crafted": crafted,
            "found": found, "resolved": resolved, "slot": slot}
