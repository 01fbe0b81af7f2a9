"""Restores for the snapshot install (K9) across its chunks.

K9 installs a table's rows chunk after chunk; each chunk's claim rounds see
every earlier chunk's rows, and within a chunk the lowest lane wins a
contended slot in each of the four rounds. Each case aims at one of those:

- `shared_windows`: groups of six rows whose ids share a probe window,
  chosen with the port's own probe functions, at random lanes of every
  chunk. Where the table is small enough to search (2^12 slots or fewer)
  the six share the whole window (first position and step): each round one
  of them wins, so two lose all four rounds; else they share the first
  position and every other position of each one's window is taken, so one
  wins and five find no slot. Either way FAULT_INSTALL is set;
- `partial_last`: two chunks and a half, and three rows more;
- `refill`: groups of eight rows sharing a first probe position, three in
  one chunk and five in the next, so the later chunk finds the slots the
  earlier one filled; and one pair whose later row's only free slot the
  earlier row takes (FAULT_INSTALL);
- `tomb_reuse`: tombstones at the first probe position of every other
  row, which the install reuses.

`install_case(name, cap_log2, chunk, table, rng)` returns a dict: `base`
([2^cap_log2 + 1, 32] uint32: the table before the install, about a third
live, a twentieth tombstones), `rows` ([n, 32] uint32 row images with
distinct ids), `ful` ([n] uint32, posted/voided words; None for accounts)
and `fault` (whether FAULT_INSTALL must follow). Made with numpy from the
caller's generator; the tests hold the plain version against the JAX
package on them, and `chip_smoke.py` holds the kernel against its plain
version on them.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tigerbeetle_tpu_torch.ops import hashtable as ht

CASES = ("shared_windows", "partial_last", "refill", "tomb_reuse")
GROUP = 6  # rows a shared window holds in `shared_windows`
EXACT_LOG2_MAX = 12  # the largest table whose windows are searched for exact sharing


def _key4(ids) -> torch.Tensor:
    ids = np.asarray(ids, dtype=np.uint64)
    key4 = np.zeros((len(ids), 4), dtype=np.uint32)
    key4[:, 0] = (ids & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    key4[:, 1] = (ids >> np.uint64(32)).astype(np.uint32)
    return torch.from_numpy(key4.view(np.int32))


def _window(ids, cap_log2: int) -> np.ndarray:
    """[len(ids), WINDOW] probe positions of each id."""
    return ht.probe_positions(_key4(ids), cap_log2, ht.WINDOW).numpy()


@functools.lru_cache(maxsize=None)
def _groups(cap_log2: int, k: int, exact: bool, count: int, start: int = 1 << 32) -> tuple:
    """`count` groups of k ids from `start` up sharing the first probe
    position (and, with `exact`, the step: the whole window); a group's
    first position is no other group's."""
    span = 1 << 22
    ids = np.arange(start, start + span, dtype=np.uint64)
    key = ht.hash_key4(_key4(ids), cap_log2).numpy()
    if exact:
        key = key * (1 << cap_log2) + ht.probe_step(_key4(ids), cap_log2).numpy()
    order = np.argsort(key, kind="stable")
    sk = key[order]
    bounds = np.flatnonzero(np.diff(sk)) + 1
    starts = np.concatenate([[0], bounds])
    sizes = np.diff(np.concatenate([starts, [len(sk)]]))
    out, firsts = [], set()
    for s0 in starts[sizes >= k]:
        g = ids[np.sort(order[s0:s0 + k])]
        first = int(_window(g[:1], cap_log2)[0, 0])
        if first not in firsts:
            firsts.add(first)
            out.append(tuple(int(x) for x in g))
            if len(out) == count:
                return tuple(out)
    raise ValueError(f"fewer than {count} groups of {k} at 2^{cap_log2}")


def _base_table(cap_log2: int, rng) -> np.ndarray:
    n = 1 << cap_log2
    rows = np.zeros((n + 1, 32), dtype=np.uint32)
    kind = rng.integers(0, 60, n)  # 0-19 live, 20-22 tombstone, else empty
    body = rows[:n]
    live = kind < 20
    body[live] = rng.integers(0, 1 << 32, (int(live.sum()), 32), dtype=np.uint32)
    body[live, 2:4] = 0  # ids below 2^64 ...
    body[live, 1] |= np.uint32(1 << 31)  # ... and above the install's, never 0
    body[(kind >= 20) & (kind < 23), :4] = 0xFFFFFFFF
    rows[n] = rng.integers(0, 1 << 32, 32, dtype=np.uint32)  # the dump row
    return rows


def _rows_of(ids, rng) -> np.ndarray:
    rows = rng.integers(0, 1 << 32, (len(ids), 32), dtype=np.uint32)
    rows[:, :4] = _key4(ids).numpy().view(np.uint32)
    return rows


def _fill(base, slots, rng) -> None:
    """Make `slots` live (ids above every install id)."""
    slots = np.unique(slots)
    base[slots] = rng.integers(0, 1 << 32, (len(slots), 32), dtype=np.uint32)
    base[slots, 2:4] = 0
    base[slots, 1] |= np.uint32(1 << 31)


def install_case(name: str, cap_log2: int, chunk: int, table: str, rng) -> dict:
    """The base table, rows, fulfill words and expected fault of case `name`
    at 2^cap_log2 slots and chunks of `chunk` rows."""
    if name not in CASES:
        raise ValueError(f"unknown install case {name!r}")
    n_slots = 1 << cap_log2
    base = _base_table(cap_log2, rng)
    n = 3 * chunk if name != "partial_last" else 2 * chunk + chunk // 2 + 3
    if 3 * n > n_slots:
        raise ValueError(f"{n} rows would crowd 2^{cap_log2} slots")
    # distinct random ids below 2^31, clear of the group ids (from 2^32 up)
    ids = rng.permutation(np.unique(rng.integers(1, 1 << 31, 2 * n, dtype=np.uint64)))[:n]
    fault = False
    if name == "shared_windows":
        exact = cap_log2 <= EXACT_LOG2_MAX
        per_chunk = max(1, min(8, chunk // (4 * GROUP)))
        groups = np.array(_groups(cap_log2, GROUP, exact, 3 * per_chunk), dtype=np.uint64)
        for c in range(3):
            lanes = rng.choice(chunk, per_chunk * GROUP, replace=False)
            ids[c * chunk + lanes] = groups[c * per_chunk:(c + 1) * per_chunk].ravel()
        win = _window(groups.ravel(), cap_log2)
        if exact:  # the windows free, so the rounds decide
            base[win] = 0
        else:  # only the first positions free
            _fill(base, win[:, 1:].ravel(), rng)
            base[win[:, 0]] = 0
        fault = True
    elif name == "refill":
        n_groups = max(1, chunk // 16)
        groups = np.array(_groups(cap_log2, 8, False, n_groups + 1), dtype=np.uint64)
        lanes0 = rng.choice(chunk, 3 * n_groups + 1, replace=False)
        lanes1 = chunk + rng.choice(chunk, 5 * n_groups + 1, replace=False)
        ids[lanes0[:-1]] = groups[:n_groups, :3].ravel()
        ids[lanes1[:-1]] = groups[:n_groups, 3:].ravel()
        # the pair: the later row's window is full but for the first
        # position, which the earlier row (same first position) takes
        pair = groups[n_groups, :2]
        win = _window(pair, cap_log2)
        _fill(base, win[1, 1:], rng)
        base[win[:, 0]] = 0
        ids[lanes0[-1]], ids[lanes1[-1]] = pair
        fault = True
    elif name == "tomb_reuse":
        first = _window(ids[::2], cap_log2)[:, 0]
        base[first] = 0
        base[first, :4] = 0xFFFFFFFF
    assert len(np.unique(ids)) == n
    rows = _rows_of(ids, rng)
    ful = None if table == "acct" else rng.integers(0, 3, n).astype(np.uint32)
    return {"base": base, "rows": rows, "ful": ful, "fault": fault}
