"""Cases for the state fingerprint (K6): the wrapping u64 sums of the row
hash over the live rows of both tables, the live counts and the commit
timestamp.

On the card the fingerprint is one launch over both tables: the grid
strides over the account table and then the transfer table a row a
thread, and the block that finishes last adds up the others' sums. So its
answer must not depend on where the live rows lie, how many there are, how
the tables' slot counts fall on the grid's rows or on an empty table. Each
case aims at one of those:

- `empty`: no live row in either table (the dump rows zero too);
- `tombstones`: a fifth of the slots live, a tenth tombstones;
- `key_words`: keys with one word set (live), with three words all ones
  (live), all zero and all ones (empty and tombstone, the other words of
  those rows nonzero);
- `last_slot`: live rows only in the first and in the last slot before the
  dump row;
- `dump_nonzero`: the dump rows hold a live-looking key and random words;
- `dense`: every slot live (every lane of every warp hashes);
- `sparse`: one slot in 997 live (most blocks add nothing).

`fp_case(name, a_slots, x_slots, rng)` returns a state dict of numpy arrays:
`acct_rows` (uint32 [a_slots + 1, 32]), `xfer_rows` (uint32 [x_slots + 1,
32]) and `commit_ts` (uint64 0-d). GEOMETRIES_CPU and GEOMETRIES_CHIP give
the slot counts the tests and `chip_smoke.py` take: the ledger's powers of
two, and counts that are no multiple of the kernel's rows a block takes at
a time (BLOCK_ROWS) nor of a warp's 32, an empty account table among them.
Made with numpy from the caller's generator; the tests hold the plain
version against the JAX package's `state_fingerprint` on them, and
`chip_smoke.py` holds the kernel against its plain version on them.
"""

from __future__ import annotations

import numpy as np

CASES = ("empty", "tombstones", "key_words", "last_slot", "dump_nonzero", "dense", "sparse")
BLOCK_ROWS = 256  # csrc/fingerprint.cu FP_THREADS: the rows a block takes at a time
GEOMETRIES_CPU = ((64, 256), (77, 1000), (0, 129))
GEOMETRIES_CHIP = ((1 << 14, 1 << 16), ((1 << 14) + 77, (1 << 16) + 1031), (0, 4 * BLOCK_ROWS + 33))
TOMB = 0xFFFF_FFFF


def _words(rng, n: int) -> np.ndarray:
    return rng.integers(0, 1 << 32, (n, 32), dtype=np.uint64).astype(np.uint32)


def _live_keys(rows: np.ndarray, idx: np.ndarray) -> None:
    """Random live rows at `idx`: key word 0 odd (never empty), word 3 below
    2^31 (never a tombstone)."""
    rows[idx, 0] |= np.uint32(1)
    rows[idx, 3] &= np.uint32(0x7FFF_FFFF)


def _table(name: str, slots: int, rng) -> np.ndarray:
    rows = np.zeros((slots + 1, 32), dtype=np.uint32)
    if name == "empty" or slots == 0:
        return rows
    kind = rng.random(slots)
    if name == "tombstones":
        live = np.flatnonzero(kind < 0.2)
        rows[live] = _words(rng, len(live))
        _live_keys(rows, live)
        tomb = np.flatnonzero((kind >= 0.2) & (kind < 0.3))
        rows[tomb] = _words(rng, len(tomb))
        rows[tomb, :4] = TOMB
    elif name == "key_words":
        # a quarter each: one key word set, three all ones, all zero, all ones
        which = rng.integers(0, 4, slots)
        rows[:slots] = _words(rng, slots)
        one = np.flatnonzero(which == 0)
        keep = rng.integers(0, 4, len(one))
        val = rows[one, keep] | np.uint32(1)
        rows[one, :4] = 0
        rows[one, keep] = val
        three = np.flatnonzero(which == 1)
        odd = rng.integers(0, 4, len(three))
        rows[three, :4] = TOMB
        rows[three, odd] = rng.integers(0, TOMB, len(three), dtype=np.uint64).astype(np.uint32)
        rows[np.flatnonzero(which == 2), :4] = 0
        rows[np.flatnonzero(which == 3), :4] = TOMB
    elif name == "last_slot":
        live = np.array(sorted({0, slots - 1}))
        rows[live] = _words(rng, len(live))
        _live_keys(rows, live)
    elif name == "dump_nonzero":
        live = np.flatnonzero(kind < 0.3)
        rows[live] = _words(rng, len(live))
        _live_keys(rows, live)
        rows[slots] = _words(rng, 1)
        _live_keys(rows, np.array([slots]))
    elif name == "dense":
        rows[:slots] = _words(rng, slots)
        _live_keys(rows, np.arange(slots))
    elif name == "sparse":
        live = np.arange(rng.integers(0, 997), slots, 997)
        rows[live] = _words(rng, len(live))
        _live_keys(rows, live)
    return rows


def fp_case(name: str, a_slots: int, x_slots: int, rng) -> dict:
    """The state of case `name` with `a_slots` account and `x_slots`
    transfer slots (each table one dump row more)."""
    if name not in CASES:
        raise ValueError(f"unknown fingerprint case {name!r}")
    return {"acct_rows": _table(name, a_slots, rng), "xfer_rows": _table(name, x_slots, rng),
            "commit_ts": np.uint64(rng.integers(0, 1 << 64, dtype=np.uint64))}
