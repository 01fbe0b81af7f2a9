"""Tables for the spill cycle's split (K10s): the watermark select and the
cold and hot lists.

The split's watermark is the n_cold-th smallest masked timestamp (u64 max
for dead slots and the dump row), compared unsigned; on the card it is a
select that narrows a histogram of the live timestamps, so its exactness
must not depend on how the timestamps fall. Each case aims at one way they
can:

- `distinct`: distinct timestamps spread over 2^40;
- `duplicates`: timestamps drawn from 40 values;
- `all_equal`: every live slot has the same timestamp;
- `two_clusters`: half the live timestamps near 2^10, half near 2^63 (the
  first histogram puts each cluster in one bin);
- `near_max`: timestamps within 2^20 of u64 max, a tenth of them at u64
  max itself (they tie with the dead slots' mask);
- `consecutive`: rising timestamps, one a slot, as a ledger gives them;
- `tombstones_dump`: a fifth of the slots tombstones and a nonzero dump
  row, all with small timestamps in words 30-31, which the mask must hide.

Every table also has empty slots whose words 30-31 hold small junk.
`split_case(name, cap_log2, rng)` returns [2^cap_log2 + 1, 32] uint32 rows
(about 3/8 live; a row holds its key and its timestamp, the split reads
nothing else); `n_cold_of(rank, live)` the rank a case is split at for
each of RANKS: 0, 1, the middle, live - 1 and live. Made with numpy from
the caller's generator; the tests hold the plain version against the JAX
package on them, and `chip_smoke.py` holds the kernel against its plain
version on them.
"""

from __future__ import annotations

import numpy as np

CASES = ("distinct", "duplicates", "all_equal", "two_clusters", "near_max", "consecutive",
         "tombstones_dump")
U64_MAX = (1 << 64) - 1


RANKS = ("zero", "one", "middle", "last", "all")


def n_cold_of(rank: str, live: int) -> int:
    """The rank a case is split at (0 <= n_cold <= live): 0, 1, the middle,
    live - 1 or live."""
    return {"zero": 0, "one": min(1, live), "middle": live // 2, "last": max(live - 1, 0),
            "all": live}[rank]


def _timestamps(name: str, k: int, rng) -> np.ndarray:
    if name in ("distinct", "tombstones_dump"):
        return rng.choice(1 << 40, k, replace=False).astype(np.uint64) + np.uint64(1)
    if name == "duplicates":
        return rng.choice(rng.integers(1, 1 << 40, 40, dtype=np.uint64), k)
    if name == "all_equal":
        return np.full(k, 123_456_789_012, dtype=np.uint64)
    if name == "two_clusters":
        low = rng.integers(1 << 10, (1 << 10) + 4 * k, k, dtype=np.uint64)
        high = rng.integers(1 << 63, (1 << 63) + 4 * k, k, dtype=np.uint64)
        return np.where(rng.random(k) < 0.5, low, high)
    if name == "near_max":
        ts = np.uint64(U64_MAX) - rng.integers(0, 1 << 20, k, dtype=np.uint64)
        ts[rng.random(k) < 0.1] = np.uint64(U64_MAX)
        return ts
    if name == "consecutive":
        return np.uint64(1_700_000_000_000_000_000) + rng.permutation(k).astype(np.uint64)
    raise ValueError(name)


def split_case(name: str, cap_log2: int, rng) -> np.ndarray:
    """The table of case `name` at 2^cap_log2 slots."""
    if name not in CASES:
        raise ValueError(f"unknown split case {name!r}")
    n = 1 << cap_log2
    rows = np.zeros((n + 1, 32), dtype=np.uint32)
    kind = rng.random(n)
    live = np.flatnonzero(kind < 0.375)
    rows[live, :4] = rng.integers(0, 1 << 32, (len(live), 4), dtype=np.uint32)
    rows[live, 0] |= np.uint32(1)  # never an empty or a tombstone key
    rows[live, 3] &= np.uint32(0x7FFFFFFF)
    ts = _timestamps(name, len(live), rng)
    rows[live, 30] = (ts & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    rows[live, 31] = (ts >> np.uint64(32)).astype(np.uint32)
    empty = np.flatnonzero(kind >= 0.375)
    rows[empty, 30] = rng.integers(0, 1000, len(empty), dtype=np.uint32)
    if name == "tombstones_dump":
        tomb = np.flatnonzero((kind >= 0.375) & (kind < 0.575))
        rows[tomb, :4] = 0xFFFFFFFF
        rows[tomb, 30] = rng.integers(0, 1000, len(tomb), dtype=np.uint32)
        rows[tomb, 31] = 0
        rows[n, :4] = rng.integers(1, 1 << 31, 4, dtype=np.uint32)  # a live-looking key
        rows[n, 30:32] = [5, 0]
    return rows
