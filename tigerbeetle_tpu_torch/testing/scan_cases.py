"""Tables for the equality filter scan (K8) at the edges of its tiles.

K8 scans a table in tiles of `kernels.FILTER_TILE` slots, each tile's
matches placed by the tile's offset (a decoupled look-back over the tiles
before it), and the last tile writes the total. Each case aims at one edge:

- `tile_edges`: a match in the first and in the last slot of every tile;
- `last_before_dump`: one match, in the last slot before the dump row (the
  dump row carries the value too);
- `last_tile_only`: matches only in the last tile that holds slots (the
  tile after it holds only the dump row);
- `exactly_limit` / `limit_plus_one`: QUERY_LIMIT and QUERY_LIMIT + 1
  matches spread over the table (the output is full; the count goes on);
- `dead_rows_carry_value`: empty slots, tombstones and the dump row carry
  the value in the field and must not count; a few live rows match;
- `no_match`: nothing matches (the output is all dump row; the dump row
  carries the value).

`scan_case(name, cap_log2, spec, value_words, rng)` returns the table as a
[2^cap_log2 + 1, 32] uint32 array: about a third of the slots live with
random keys, a twentieth tombstones, the rest empty; no row matches by
chance. Made with numpy from the caller's generator; the tests hold the
plain version against the JAX package on them at 2^14 slots, and
`chip_smoke.py` holds the kernel against its plain version on them at 2^24.
"""

from __future__ import annotations

import numpy as np

from tigerbeetle_tpu_torch.kernels import FILTER_TILE, QUERY_LIMIT

CASES = ("tile_edges", "last_before_dump", "last_tile_only", "exactly_limit",
         "limit_plus_one", "dead_rows_carry_value", "no_match")
# (table, field) of each field shape: four words sharing the key's sector,
# two words, one word, a half-word
FIELDS = (("xfer", "debit_account_id"), ("xfer", "user_data_64"), ("acct", "ledger"),
          ("xfer", "code"))


def _set_field(rows, slots, spec, value_words) -> None:
    word0, nwords, halfword = spec
    if halfword:
        rows[slots, word0] = (rows[slots, word0] & 0xFFFF0000) | value_words[0]
    else:
        rows[slots, word0:word0 + nwords] = value_words[:nwords]


def _matches(rows, spec, value_words) -> np.ndarray:
    word0, nwords, halfword = spec
    if halfword:
        return (rows[:, word0] & 0xFFFF) == value_words[0]
    return (rows[:, word0:word0 + nwords] == np.asarray(value_words[:nwords],
                                                         dtype=np.uint32)).all(axis=1)


def _match_slots(name: str, cap_log2: int, live: np.ndarray, rng) -> np.ndarray:
    """The slots that match in case `name` (made live where they are not)."""
    n = 1 << cap_log2
    tiles = n // FILTER_TILE
    if name == "tile_edges":
        return np.concatenate([np.arange(tiles) * FILTER_TILE,
                               np.arange(tiles) * FILTER_TILE + FILTER_TILE - 1])
    if name == "last_before_dump":
        return np.array([n - 1])
    if name == "last_tile_only":
        start = (tiles - 1) * FILTER_TILE
        return rng.choice(np.arange(start, n), min(300, FILTER_TILE), replace=False)
    if name in ("exactly_limit", "limit_plus_one"):
        k = QUERY_LIMIT + (name == "limit_plus_one")  # over all slots: a dead one turns live
        return np.sort(rng.choice(n, k, replace=False))
    if name == "dead_rows_carry_value":
        return np.sort(rng.choice(np.nonzero(live)[0], 37, replace=False))
    if name == "no_match":
        return np.zeros(0, dtype=np.int64)
    raise ValueError(f"unknown scan case {name!r}")


def scan_case(name: str, cap_log2: int, spec, value_words, rng) -> np.ndarray:
    """The table of case `name` for the field `spec` = (word0, nwords,
    halfword) and the value's four u32 words."""
    if cap_log2 < 14 or (1 << cap_log2) % FILTER_TILE:
        raise ValueError(f"scan cases need 2^14 slots or more, whole tiles: 2^{cap_log2}")
    n = 1 << cap_log2
    rows = np.zeros((n + 1, 32), dtype=np.uint32)
    kind = rng.integers(0, 60, n)  # 0-19 live, 20-22 tombstone, else empty
    live = kind < 20
    tomb = (kind >= 20) & (kind < 23)
    n_live = int(live.sum())
    keys = rng.integers(1, 1 << 32, (n_live, 4), dtype=np.uint32)
    keys[:, 3] &= 0x7FFFFFFF  # never a tombstone
    body = rows[:n]  # a view: the slots without the dump row
    body[live, :4] = keys
    body[live, 4:] = rng.integers(0, 1 << 32, (n_live, 28), dtype=np.uint32)
    body[tomb, :4] = 0xFFFFFFFF
    rows[n] = rng.integers(0, 1 << 32, 32, dtype=np.uint64).astype(np.uint32)  # the dump row
    # no chance matches: a live row that matches gets another first word
    word0 = spec[0]
    chance = np.nonzero(_matches(rows[:n], spec, value_words) & live)[0]
    if spec[2]:
        rows[chance, word0] = (rows[chance, word0] & 0xFFFF0000) | ((value_words[0] + 1) & 0xFFFF)
    else:
        rows[chance, word0] ^= np.uint32(1)
    hits = _match_slots(name, cap_log2, live, rng)
    rows[hits[~live[hits]], :4] = rng.integers(1, 1 << 31, (int((~live[hits]).sum()), 4),
                                               dtype=np.uint64).astype(np.uint32)
    _set_field(rows, hits, spec, value_words)
    # dead rows and the dump row carry the value
    if name in ("dead_rows_carry_value", "last_before_dump", "no_match"):
        dead = np.nonzero(~live)[0]
        dead = dead[~np.isin(dead, hits)]
        _set_field(rows, rng.choice(dead, min(500, len(dead)), replace=False), spec, value_words)
        _set_field(rows, np.array([n]), spec, value_words)
    return rows


def expected_total(rows: np.ndarray, spec, value_words) -> int:
    """The live matches of a case table, by numpy (the cases' own check)."""
    k4 = rows[:-1, :4]
    live = ~((k4 == 0).all(axis=1) | (k4 == 0xFFFFFFFF).all(axis=1))
    return int((live & _matches(rows[:-1], spec, value_words)).sum())
