"""Reloads for the spill cycle's reload (K10r), one chunk and chunk after
chunk.

K10r runs a rebuild's chunks in order in one launch; each chunk is all or
nothing, its probes and claims see every earlier chunk's rows, used_slots
carries over, and a chunk after a fault still probes, claims and ORs its
PROBE and CLAIM bits into the fault word while writing nothing. Each case
aims at one of those:

- `one_chunk`: fewer rows than a chunk, into a table about a quarter full;
- `two_chunks`, `many_chunks`: a chunk and a part, and six chunks and a
  part, of new ids;
- `rebuild`: the cycle's own shape, four chunks and a part into a fresh
  table;
- `resident`: every other row's id already in the table (skipped);
- `dup_within`: ids repeated within a chunk (each copy claims a slot);
- `dup_across`: ids of chunk 0 again in chunks 1 and 3 (resident by then);
- `capacity_middle`: used_slots such that chunk 1 crosses half the slots
  (FAULT_CAPACITY), and chunk 3 holds ids whose probe windows have no
  empty and no free slot (FAULT_PROBE and FAULT_CLAIM on top);
- `full_window`: groups of three ids sharing a first probe position, whose
  windows hold no empty slot and no free one but that first position, a
  tombstone (no window ends: FAULT_PROBE; the lowest lane of a group
  claims the tombstone, the other two find no slot: FAULT_CLAIM);
- `earlier_fault`: a fault word set before the reload (nothing is written,
  the later bits still OR in);
- `sparse_active`: one chunk with a random active mask (`active` is set
  in the case), for the one-chunk entry point.

`reload_case(name, cap_log2, chunk, rng)` returns a dict: `table` (numpy
uint32/uint64 leaves xfer_rows [2^cap_log2 + 1, 32], fulfill, xfer_claim,
all free, xfer_used_slots (a 0-d uint64) and fault (a 0-d uint32)), `rows`
([n_pad, 32] uint32: the stored rows, padded to whole chunks with the
table's dump row as the cycle's gather pads them), `ful` ([n_pad] uint32),
`n` (the rows to reload), `active` (None, or a bool [chunk] mask for
`sparse_active`) and `fault` (the fault bits the reload must end with).
Made with numpy from the caller's generator; the tests hold the plain
version against the JAX package on them, and `chip_smoke.py` holds the
kernel against its plain version on them.
"""

from __future__ import annotations

import numpy as np
import torch

from tigerbeetle_tpu_torch.ops import hashtable as ht

CASES = ("one_chunk", "two_chunks", "many_chunks", "rebuild", "resident", "dup_within",
         "dup_across", "capacity_middle", "full_window", "earlier_fault", "sparse_active")
FAULT_PROBE = 1
FAULT_CLAIM = 2
FAULT_CAPACITY = 16
FAULT_INSTALL = 1 << 30
CLAIM_FREE = 0xFFFFFFFF


def _key4(ids) -> torch.Tensor:
    ids = np.asarray(ids, dtype=np.uint64)
    key4 = np.zeros((len(ids), 4), dtype=np.uint32)
    key4[:, 0] = (ids & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    key4[:, 1] = (ids >> np.uint64(32)).astype(np.uint32)
    return torch.from_numpy(key4.view(np.int32))


def _window(ids, cap_log2: int) -> np.ndarray:
    """[len(ids), WINDOW] probe positions of each id."""
    return ht.probe_positions(_key4(ids), cap_log2, ht.WINDOW).numpy()


def _rows_of(ids, rng) -> np.ndarray:
    rows = rng.integers(0, 1 << 32, (len(ids), 32), dtype=np.uint32)
    rows[:, :4] = _key4(ids).numpy().view(np.uint32)
    return rows


def _live(rows, slots, rng) -> None:
    """Make `slots` live with ids from 2^40 up, clear of every reload id."""
    slots = np.unique(slots)
    rows[slots] = rng.integers(0, 1 << 32, (len(slots), 32), dtype=np.uint32)
    rows[slots, 1] = (rows[slots, 1] & np.uint32(0xFFFF)) | np.uint32(1 << 16)
    rows[slots, 2:4] = 0


def _base(cap_log2: int, share: float, rng) -> np.ndarray:
    """A table about `share` live, a twentieth of that in tombstones, and a
    nonzero dump row."""
    n = 1 << cap_log2
    rows = np.zeros((n + 1, 32), dtype=np.uint32)
    kind = rng.random(n)
    _live(rows, np.flatnonzero(kind < share), rng)
    rows[np.flatnonzero((kind >= share) & (kind < share * 1.05)), :4] = 0xFFFFFFFF
    rows[n] = rng.integers(0, 1 << 32, 32, dtype=np.uint32)
    return rows


def _free_ids(count: int, taken: set, rng) -> np.ndarray:
    out = []
    while len(out) < count:
        for x in rng.integers(1, 1 << 31, 2 * count, dtype=np.uint64):
            if int(x) not in taken:
                taken.add(int(x))
                out.append(int(x))
                if len(out) == count:
                    break
    return np.array(out, dtype=np.uint64)


def reload_case(name: str, cap_log2: int, chunk: int, rng) -> dict:
    """The table, stored rows, row count, active mask and expected fault
    bits of case `name` at 2^cap_log2 slots and chunks of `chunk` rows."""
    if name not in CASES:
        raise ValueError(f"unknown reload case {name!r}")
    slots = 1 << cap_log2
    half = slots // 2
    share = 0.0 if name == "rebuild" else 0.25
    rows = _base(cap_log2, share, rng)
    live = np.flatnonzero(~((rows[:-1, :4] == 0).all(1) | (rows[:-1, :4] == 0xFFFFFFFF).all(1)))
    used = len(live) + int((rows[:-1, :4] == 0xFFFFFFFF).all(1).sum())
    fault = 0
    active = None
    n = {"one_chunk": chunk // 2 + 3, "two_chunks": chunk + chunk // 3,
         "many_chunks": 6 * chunk + 5, "rebuild": 4 * chunk + chunk // 2,
         "sparse_active": chunk}.get(name, 4 * chunk + 7)
    if used + n > half and name not in ("capacity_middle",):
        raise ValueError(f"{n} rows and {used} used slots would cross half of 2^{cap_log2}")
    taken: set = set()
    ids = _free_ids(n, taken, rng)
    if name == "resident":
        pick = rng.choice(live, n // 2, replace=False)
        ids[0:2 * (n // 2):2] = (rows[pick, 0].astype(np.uint64)
                                 | (rows[pick, 1].astype(np.uint64) << np.uint64(32)))
    elif name == "dup_within":
        lanes = rng.choice(chunk, 2 * (chunk // 8), replace=False)
        ids[lanes[1::2]] = ids[lanes[0::2]]
    elif name == "dup_across":
        src = rng.choice(chunk, chunk // 4, replace=False)
        ids[chunk + src[: chunk // 8]] = ids[src[: chunk // 8]]
        ids[3 * chunk + src[chunk // 8:]] = ids[src[chunk // 8:]]
    elif name == "capacity_middle":
        used = half - chunk - chunk // 2  # chunk 0 fits, chunk 1 crosses half
        fault = FAULT_CAPACITY | FAULT_PROBE | FAULT_CLAIM
        full = ids[3 * chunk: 3 * chunk + 4]
        win = _window(full, cap_log2)
        _live(rows, win.ravel(), rng)
    elif name == "full_window":
        trios = _shared_first(cap_log2, 3, 2)
        lanes = 2 * chunk + rng.choice(chunk, trios.size, replace=False)
        ids[lanes] = trios.ravel()
        win = _window(trios.ravel(), cap_log2)
        _live(rows, win[:, 1:].ravel(), rng)
        rows[win[:, 0]] = 0
        rows[win[:, 0], :4] = 0xFFFFFFFF
        fault = FAULT_PROBE | FAULT_CLAIM
    elif name == "earlier_fault":
        fault = FAULT_INSTALL
    elif name == "sparse_active":
        active = rng.random(chunk) < 0.6
    stored = _rows_of(ids, rng)
    n_pad = -(-n // chunk) * chunk
    out_rows = np.tile(rows[-1], (n_pad, 1))  # the gather pads with the dump row
    out_rows[:n] = stored
    ful = np.full(n_pad, 7, dtype=np.uint32)
    ful[:n] = rng.integers(0, 3, n).astype(np.uint32)
    table = {
        "xfer_rows": rows,
        "fulfill": rng.integers(0, 3, slots + 1).astype(np.uint32),
        "xfer_claim": np.full(slots + 1, CLAIM_FREE, dtype=np.uint32),
        "xfer_used_slots": np.array(used, dtype=np.uint64),
        "fault": np.array(FAULT_INSTALL if name == "earlier_fault" else 0, dtype=np.uint32),
    }
    if name == "rebuild":
        table["fulfill"][:] = 0
    return {"table": table, "rows": out_rows, "ful": ful, "n": n, "active": active,
            "fault": fault}


def _shared_first(cap_log2: int, k: int, count: int, start: int = 1 << 33) -> np.ndarray:
    """`count` groups of k ids from `start` up sharing their first probe
    position, each group's its own: [count, k] uint64."""
    span = 1 << 20
    ids = np.arange(start, start + span, dtype=np.uint64)
    first = _window(ids, cap_log2)[:, 0]
    order = np.argsort(first, kind="stable")
    sf = first[order]
    starts = np.concatenate([[0], np.flatnonzero(np.diff(sf)) + 1])
    sizes = np.diff(np.concatenate([starts, [len(sf)]]))
    groups = [np.sort(ids[order[s0:s0 + k]]) for s0 in starts[sizes >= k][:count]]
    if len(groups) < count:
        raise ValueError(f"fewer than {count} groups of {k} at 2^{cap_log2}")
    return np.array(groups, dtype=np.uint64)


def to_torch(table: dict, device) -> dict:
    """A case's table as the port's tensors (int32 bits, int64 used_slots)."""
    return {
        "xfer_rows": torch.from_numpy(table["xfer_rows"].view(np.int32).copy()).to(device),
        "fulfill": torch.from_numpy(table["fulfill"].view(np.int32).copy()).to(device),
        "xfer_claim": torch.from_numpy(table["xfer_claim"].view(np.int32).copy()).to(device),
        "xfer_used_slots": torch.tensor(int(table["xfer_used_slots"]), dtype=torch.int64,
                                        device=device),
        "fault": torch.tensor(np.array(table["fault"]).astype(np.uint32).view(np.int32),
                              device=device).reshape(()),
    }
