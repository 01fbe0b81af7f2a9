"""One LSM tree over the Grid (reference: src/lsm/tree.zig, table.zig,
table_memory.zig, compaction.zig, manifest.zig — collapsed to their
load-bearing contracts):

- fixed-width keys (big-endian-comparable bytes) and values;
- a mutable in-memory table absorbs puts/removes; on flush it becomes an
  immutable ON-DISK table: sorted (key, value) pairs packed into grid data
  blocks plus one index block of first-keys (binary-searched on lookup);
- level 0 holds overlapping tables newest-first (flush targets); levels
  >= 1 hold DISJOINT tables sorted by key range (reference invariant,
  src/lsm/manifest_level.zig), found by binary search on lookup;
- compaction is PACED: one table per compact step — the over-budget
  level's victim table merges with the intersecting tables of the next
  level (k-way, newest-wins dedup), output split into bounded tables,
  tombstone GC at the bottom (reference: src/lsm/compaction.zig:1-32 one
  table per half-bar). A flush triggers at most one paced step per level
  (the half-bar analog), with a 2x-budget backpressure loop as the
  hard bound;
- the manifest (table metadata: level, key range, block addresses) is a
  plain structure serialized with the tree's checkpoint (reference keeps a
  ManifestLog of blocks; lsm/manifest_log.py provides the incremental
  block-chain form used by the forest checkpoint).

Tombstone = value of all 0xFF (valid object values never are: wire rows
carry nonzero ids in the id field's position).

The port's copy of `tigerbeetle_tpu/lsm/tree.py`, the same code with its imports
pointed at this package (the port imports nothing of the JAX package), so
that the port writes the same grid bytes.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

from tigerbeetle_tpu_torch.lsm.grid import BLOCK_PAYLOAD_MAX, Grid
from tigerbeetle_tpu_torch.metrics import NULL_METRICS
from tigerbeetle_tpu_torch.tracer import NULL_TRACER

GROWTH_FACTOR = 8  # reference: src/config.zig:142
LEVEL0_TABLES_MAX = 4

# Split-block-style bloom filter (reference: src/lsm/bloom_filter.zig):
# ~10 bits/key, 4 probes -> ~1-2% false positives. The filter is its own
# grid block per table, consulted before any index/data block read.
FILTER_BITS_PER_KEY = 10
FILTER_PROBES = 4


# Filter format v1: "BF02"-prefixed bits built with the VECTORIZED
# polynomial hash below (building 10M+ keys through per-key blake2b
# dominated whole spill cycles). The authoritative version marker is
# TableInfo.filter_version (persisted in the manifest) — payload sniffing
# alone could misread a legacy blake2b filter whose first bytes collide
# with the magic (~2^-32/filter, but a false NEGATIVE would silently skip
# a table). Legacy version-0 filters keep the blake2b probes.
FILTER_MAGIC = b"BF02"
_POLY = 0x100000001B3  # FNV-ish odd multiplier (mod 2^64)
_MIX1 = 0xFF51AFD7ED558CCD
_MIX2 = 0xC4CEB9FE1A85EC53
_M64 = (1 << 64) - 1


def _poly_hash_scalar(key: bytes) -> tuple[int, int]:
    h = 0xCBF29CE484222325
    for b in key:
        h = ((h ^ b) * _POLY) & _M64
    h ^= h >> 33
    h1 = (h * _MIX1) & _M64
    h1 ^= h1 >> 29
    h2 = ((h * _MIX2) & _M64) | 1
    return h1, h2


def _filter_probes(key: bytes, nbits: int):
    """Legacy (unversioned) probe positions — blake2b."""
    d = hashlib.blake2b(key, digest_size=16).digest()
    h1 = int.from_bytes(d[:8], "little")
    h2 = int.from_bytes(d[8:], "little") | 1
    return ((h1 + i * h2) % nbits for i in range(FILTER_PROBES))


def build_filter(keys, count: int) -> bytes:
    """Split-block-style filter over fixed-size keys, built VECTORIZED:
    one polynomial pass over the key byte columns + one scattered
    bitwise-or per probe (numpy), instead of a Python blake2b per key.
    `keys` is an iterable of key bytes OR a packed np.uint8 [n, key_size]
    array (the array-native table-write path)."""
    # multiple of 8 so the query side's len*8 equals the build-side modulus
    nbits = (max(64, count * FILTER_BITS_PER_KEY) + 7) // 8 * 8
    bits = np.zeros(nbits // 8, dtype=np.uint8)
    if isinstance(keys, np.ndarray):
        arr = keys
    else:
        keys = list(keys)
        arr = (
            np.frombuffer(b"".join(keys), dtype=np.uint8)
            .reshape(len(keys), len(keys[0]))
            if keys else None
        )
    if arr is not None and len(arr):
        n, ksz = arr.shape
        h = np.full(n, 0xCBF29CE484222325, dtype=np.uint64)
        poly = np.uint64(_POLY)
        for j in range(ksz):
            h = (h ^ arr[:, j].astype(np.uint64)) * poly
        h ^= h >> np.uint64(33)
        h1 = h * np.uint64(_MIX1)
        h1 ^= h1 >> np.uint64(29)
        h2 = (h * np.uint64(_MIX2)) | np.uint64(1)
        for i in range(FILTER_PROBES):
            p = (h1 + np.uint64(i) * h2) % np.uint64(nbits)
            np.bitwise_or.at(
                bits, (p >> np.uint64(3)).astype(np.int64),
                (np.uint8(1) << (p & np.uint64(7)).astype(np.uint8)),
            )
    return FILTER_MAGIC + bits.tobytes()


def filter_may_contain_many(filt: bytes, keys_u8: np.ndarray,
                            version: int = 1) -> np.ndarray:
    """Vectorized membership probe: one polynomial pass over the packed
    key matrix (np.uint8 [n, key_size]) + FILTER_PROBES scattered bit
    tests — the batch analog of filter_may_contain, amortizing the hash
    over the whole id set (the multi-lookup path). Legacy (version-0)
    filters fall back to the scalar blake2b probes per key."""
    n = len(keys_u8)
    if n == 0:
        return np.zeros(0, dtype=bool)
    if not (version >= 1 and filt.startswith(FILTER_MAGIC)):
        return np.array([
            filter_may_contain(filt, k.tobytes(), version=version)
            for k in keys_u8
        ])
    bits = np.frombuffer(filt, dtype=np.uint8, offset=len(FILTER_MAGIC))
    nbits = len(bits) * 8
    if nbits == 0:
        return np.ones(n, dtype=bool)
    h = np.full(n, 0xCBF29CE484222325, dtype=np.uint64)
    poly = np.uint64(_POLY)
    for j in range(keys_u8.shape[1]):
        h = (h ^ keys_u8[:, j].astype(np.uint64)) * poly
    h ^= h >> np.uint64(33)
    h1 = h * np.uint64(_MIX1)
    h1 ^= h1 >> np.uint64(29)
    h2 = (h * np.uint64(_MIX2)) | np.uint64(1)
    may = np.ones(n, dtype=bool)
    for i in range(FILTER_PROBES):
        p = (h1 + np.uint64(i) * h2) % np.uint64(nbits)
        may &= (
            bits[(p >> np.uint64(3)).astype(np.int64)]
            & (np.uint8(1) << (p & np.uint64(7)).astype(np.uint8))
        ) != 0
    return may


def filter_may_contain(filt: bytes, key: bytes, version: int = 1) -> bool:
    if version >= 1 and filt.startswith(FILTER_MAGIC):
        bits = filt[len(FILTER_MAGIC):]
        nbits = len(bits) * 8
        if nbits == 0:
            return True
        h1, h2 = _poly_hash_scalar(key)
        # (h1 + i*h2) wraps mod 2^64 BEFORE the modulus (the vectorized
        # filter construction computes in u64; nbits does not divide 2^64)
        return all(
            bits[p >> 3] & (1 << (p & 7))
            for p in (
                ((h1 + i * h2) & _M64) % nbits for i in range(FILTER_PROBES)
            )
        )
    nbits = len(filt) * 8  # legacy blake2b filter
    if nbits == 0:
        return True
    return all(
        filt[p >> 3] & (1 << (p & 7)) for p in _filter_probes(key, nbits)
    )


@dataclasses.dataclass
class TableInfo:
    """Manifest entry (reference: src/lsm/manifest.zig TableInfo)."""

    index_address: int
    key_min: bytes
    key_max: bytes
    entry_count: int
    filter_address: int = 0  # 0 = no filter (pre-filter manifests)
    filter_version: int = 0  # 0 = legacy blake2b probes, 1 = BF02 poly

    def to_json(self):
        return {
            "index_address": self.index_address,
            "key_min": self.key_min.hex(),
            "key_max": self.key_max.hex(),
            "entry_count": self.entry_count,
            "filter_address": self.filter_address,
            "filter_version": self.filter_version,
        }

    @staticmethod
    def from_json(d):
        return TableInfo(
            index_address=d["index_address"],
            key_min=bytes.fromhex(d["key_min"]),
            key_max=bytes.fromhex(d["key_max"]),
            entry_count=d["entry_count"],
            filter_address=d.get("filter_address", 0),
            filter_version=d.get("filter_version", 0),
        )


def _bisect_table(level: list[TableInfo], key: bytes) -> int | None:
    """Index of the (disjoint, sorted) table whose range covers key."""
    lo, hi = 0, len(level) - 1
    while lo <= hi:
        mid = (lo + hi) // 2
        t = level[mid]
        if key < t.key_min:
            hi = mid - 1
        elif key > t.key_max:
            lo = mid + 1
        else:
            return mid
    return None


class Tree:
    # observability seams (SpillManager.instrument / the bench re-point
    # these at the shared registry; defaults cost nothing)
    metrics = NULL_METRICS
    tracer = NULL_TRACER

    def __init__(self, grid: Grid, key_size: int, value_size: int,
                 memtable_max: int = 4096, manifest_log=None,
                 tree_id: int = 0, filters: bool = True):
        self.grid = grid
        self.manifest_log = manifest_log  # emits TableInfo churn events
        self.tree_id = tree_id
        # bloom filters serve _table_get point lookups only; trees that are
        # exclusively range-scanned (secondary indexes) skip the build
        self.filters = filters
        self.key_size = key_size
        self.value_size = value_size
        self.entry_size = key_size + value_size
        self.entries_per_block = BLOCK_PAYLOAD_MAX // self.entry_size
        self.memtable_max = memtable_max
        self.table_entries_max = memtable_max * 4  # merge output table size
        self.memtable: dict[bytes, bytes] = {}
        self.tombstone = b"\xff" * value_size
        # levels[0]: overlapping, newest-first. levels[i>=1]: disjoint,
        # sorted by key range (reference: src/lsm/manifest_level.zig).
        self.levels: list[list[TableInfo]] = [[]]
        self._compact_cursor: dict[int, int] = {}  # level -> round-robin pos
        # pending put_array buffers, settled into sorted L0 tables in bulk
        # (one big sort + fewer, larger tables = less write amplification
        # than per-chunk insertion). INVARIANT: at most one of (memtable,
        # _pending) is non-empty — every entry point settles/flushes the
        # other first, so newest-wins ordering across the two paths holds.
        self._pending: list[tuple[np.ndarray, np.ndarray | bytes]] = []
        self._pending_rows = 0
        self.settle_max = 16 * memtable_max
        # An interrupted compaction (GridBlockCorrupt mid-merge-read) must
        # RESUME at the next settle point, before any further block
        # allocation — otherwise a healed-and-retried replica compacts in
        # a different order than its peers and the grids' block layouts
        # diverge (repair-by-address depends on layout determinism).
        self._compact_debt = False

    # -- writes --

    def put(self, key: bytes, value: bytes) -> None:
        assert len(key) == self.key_size and len(value) == self.value_size
        assert value != self.tombstone
        if self._pending or self._compact_debt:
            self._settle()
        self.memtable[key] = value
        if len(self.memtable) >= self.memtable_max:
            self.flush()

    def put_many(self, keys, values) -> None:
        """Bulk put: one C-speed dict update per chunk instead of a Python
        call per key (the spill cycle feeds 12 trees x 100k+ rows; per-key
        put() was the dominant cost of a cycle). `values` is a parallel
        list or ONE shared value (secondary-index presence bytes)."""
        if not keys:
            return
        if self._pending or self._compact_debt:
            self._settle()
        if isinstance(values, (bytes, bytearray)):
            assert len(values) == self.value_size
            pairs = ((k, values) for k in keys)
        else:
            pairs = zip(keys, values)
        # chunked so the memtable flushes near its budget (a single giant
        # update would build one oversized on-disk table)
        it = iter(pairs)
        while True:
            room = max(self.memtable_max - len(self.memtable), 1024)
            chunk = []
            for _ in range(room):
                try:
                    chunk.append(next(it))
                except StopIteration:
                    break
            if not chunk:
                break
            self.memtable.update(chunk)
            if len(self.memtable) >= self.memtable_max:
                self.flush()

    def remove(self, key: bytes) -> None:
        assert len(key) == self.key_size
        if self._pending or self._compact_debt:
            self._settle()
        self.memtable[key] = self.tombstone

    # -- reads (the lookup cascade, reference: src/lsm/tree.zig:303-433) --

    def get(self, key: bytes) -> bytes | None:
        if self._pending or self._compact_debt:
            self._settle()
        hit = self.memtable.get(key)
        if hit is not None:
            return None if hit == self.tombstone else hit
        for info in self.levels[0]:  # newest-first, overlapping
            if info.key_min <= key <= info.key_max:
                hit = self._table_get(info, key)
                if hit is not None:
                    return None if hit == self.tombstone else hit
        for level in self.levels[1:]:  # disjoint: binary search by range
            i = _bisect_table(level, key)
            if i is not None:
                hit = self._table_get(level[i], key)
                if hit is not None:
                    return None if hit == self.tombstone else hit
        return None

    def get_many(self, keys: list[bytes]) -> list[bytes | None]:
        """Batched point reads: one memtable pass, then each LEVEL is
        walked once for the whole unresolved set — per-table bloom probes
        run vectorized over the candidate batch and each index block is
        parsed once per table per call, not once per key (the reference
        saturates IO depth across a prefetch batch the same way,
        src/lsm/groove.zig:710-760). Results are positional: out[i] is the
        live value for keys[i] or None (missing or tombstone). Equivalent
        to [self.get(k) for k in keys] by construction — the cascade
        resolves each key at the NEWEST occurrence, same as get()."""
        if self._pending or self._compact_debt:
            self._settle()
        with self.tracer.span("lsm.get_many", ids=len(keys)), \
                self.metrics.histogram("lsm.get_many_us").time():
            out = self._get_many(keys)
        self.metrics.counter("lsm.lookup_batches").add()
        self.metrics.counter("lsm.lookup_ids").add(len(keys))
        return out

    def _get_many(self, keys: list[bytes]) -> list[bytes | None]:
        n = len(keys)
        out: list[bytes | None] = [None] * n
        mt = self.memtable
        tomb = self.tombstone
        unresolved: set[int] = set()
        for i, k in enumerate(keys):
            hit = mt.get(k)
            if hit is None:
                unresolved.add(i)
            elif hit != tomb:
                out[i] = hit
        # level 0: overlapping tables newest-first — each table claims the
        # candidates in its key range that an older table must not shadow
        for info in self.levels[0]:
            if not unresolved:
                return out
            cand = [
                i for i in sorted(unresolved)
                if info.key_min <= keys[i] <= info.key_max
            ]
            if cand:
                self._table_get_many(info, keys, cand, out, unresolved)
        # levels >= 1: disjoint sorted tables — group the (sorted)
        # unresolved keys by covering table with one merge walk per level
        for level in self.levels[1:]:
            if not unresolved:
                return out
            if not level:
                continue
            order = sorted(unresolved, key=lambda i: keys[i])
            t = 0
            by_table: dict[int, list[int]] = {}
            for i in order:
                k = keys[i]
                while t < len(level) and level[t].key_max < k:
                    t += 1
                if t == len(level):
                    break
                if level[t].key_min <= k:
                    by_table.setdefault(t, []).append(i)
            for t, cand in by_table.items():
                self._table_get_many(level[t], keys, cand, out, unresolved)
        return out

    def _table_get_many(self, info: TableInfo, keys: list[bytes],
                        cand: list[int], out: list,
                        unresolved: set[int]) -> None:
        """Resolve `cand` (indices into keys) against ONE table: vectorized
        bloom probe over the batch, one index-block parse, then per-data-
        block grouped binary searches. Hits (including tombstones) are
        recorded in `out` and removed from `unresolved` — a hit at this
        depth shadows every older occurrence."""
        ksz = self.key_size
        if info.filter_address:
            keys_u8 = np.frombuffer(
                b"".join(keys[i] for i in cand), dtype=np.uint8
            ).reshape(len(cand), ksz)
            may = filter_may_contain_many(
                self.grid.read_block(info.filter_address), keys_u8,
                version=info.filter_version,
            )
            n_probed = len(cand)
            cand = [i for i, m in zip(cand, may) if m]
            self.metrics.counter("lsm.bloom_probes").add(n_probed)
            self.metrics.counter("lsm.bloom_negatives").add(
                n_probed - len(cand)
            )
            if not cand:
                return
        index = self.grid.read_block(info.index_address)
        rec = 8 + ksz
        nb = len(index) // rec
        firsts = [index[j * rec + 8 : j * rec + 8 + ksz] for j in range(nb)]
        from bisect import bisect_right

        by_block: dict[int, list[int]] = {}
        for i in cand:
            pos = max(0, bisect_right(firsts, keys[i]) - 1)
            by_block.setdefault(pos, []).append(i)
        e = self.entry_size
        tomb = self.tombstone
        for pos, members in by_block.items():
            addr = int.from_bytes(index[pos * rec : pos * rec + 8], "little")
            data = self.grid.read_block(addr)
            ne = len(data) // e
            for i in members:
                key = keys[i]
                lo, hi = 0, ne - 1
                while lo <= hi:
                    mid = (lo + hi) // 2
                    k = data[mid * e : mid * e + ksz]
                    if k == key:
                        v = data[mid * e + ksz : (mid + 1) * e]
                        if v != tomb:
                            out[i] = v
                        unresolved.discard(i)
                        break
                    if k < key:
                        lo = mid + 1
                    else:
                        hi = mid - 1

    def range(self, lo: bytes, hi: bytes) -> list[tuple[bytes, bytes]]:
        """All live (key, value) pairs with lo <= key <= hi, ascending.
        Newest-wins across memtable/levels; tombstones excluded (reference:
        src/lsm/tree.zig:1126-1140 RangeQuery over levels)."""
        assert len(lo) == self.key_size and len(hi) == self.key_size
        if self._pending or self._compact_debt:
            self._settle()
        out: dict[bytes, bytes] = {}
        # oldest-first so newer entries overwrite: deepest level first, each
        # level oldest-to-newest (lists are newest-first)
        for level in reversed(self.levels):
            for info in reversed(level):
                if info.key_max < lo or info.key_min > hi:
                    continue
                out.update(self._table_range(info, lo, hi))
        for k, v in self.memtable.items():
            if lo <= k <= hi:
                out[k] = v
        return sorted(
            (k, v) for k, v in out.items() if v != self.tombstone
        )

    def _table_range(self, info: TableInfo, lo: bytes,
                     hi: bytes) -> dict[bytes, bytes]:
        """One table's entries in [lo, hi]: binary-search the index block for
        the first candidate data block, then walk blocks until past hi."""
        index = self.grid.read_block(info.index_address)
        rec = 8 + self.key_size
        n = len(index) // rec
        # last block whose first key <= lo (earlier blocks cannot contain lo)
        pos = 0
        a, b = 0, n - 1
        while a <= b:
            mid = (a + b) // 2
            first = index[mid * rec + 8 : mid * rec + 8 + self.key_size]
            if first <= lo:
                pos = mid
                a = mid + 1
            else:
                b = mid - 1
        out: dict[bytes, bytes] = {}
        e = self.entry_size
        for i in range(pos, n):
            first = index[i * rec + 8 : i * rec + 8 + self.key_size]
            if first > hi:
                break
            addr = int.from_bytes(index[i * rec : i * rec + 8], "little")
            data = self.grid.read_block(addr)
            for j in range(len(data) // e):
                k = data[j * e : j * e + self.key_size]
                if k < lo:
                    continue
                if k > hi:
                    break
                out[k] = data[j * e + self.key_size : (j + 1) * e]
        return out

    def _table_get(self, info: TableInfo, key: bytes) -> bytes | None:
        if info.filter_address:
            # bloom check first: a negative skips the index+data reads
            # entirely (reference: src/lsm/bloom_filter.zig consulted in
            # lookup_from_levels_storage)
            if not filter_may_contain(
                self.grid.read_block(info.filter_address), key,
                version=info.filter_version,
            ):
                return None
        index = self.grid.read_block(info.index_address)
        # index payload: [addr u64][first_key key_size] per data block
        rec = 8 + self.key_size
        n = len(index) // rec
        lo, hi = 0, n - 1
        pos = 0
        while lo <= hi:  # last block whose first key <= key
            mid = (lo + hi) // 2
            first = index[mid * rec + 8 : mid * rec + 8 + self.key_size]
            if first <= key:
                pos = mid
                lo = mid + 1
            else:
                hi = mid - 1
        addr = int.from_bytes(index[pos * rec : pos * rec + 8], "little")
        data = self.grid.read_block(addr)
        e = self.entry_size
        lo, hi = 0, len(data) // e - 1
        while lo <= hi:
            mid = (lo + hi) // 2
            k = data[mid * e : mid * e + self.key_size]
            if k == key:
                return data[mid * e + self.key_size : (mid + 1) * e]
            if k < key:
                lo = mid + 1
            else:
                hi = mid - 1
        return None

    # -- flush / compaction (array-native: tables move through flush and
    # merge as packed np.uint8 [n, entry_size] matrices — the per-entry
    # Python streaming this replaces was 85% of a whole spill cycle) --

    def flush(self) -> None:
        """Make every pending write durable-visible in the levels."""
        self._settle()
        self._flush_memtable()

    def _flush_memtable(self) -> None:
        if not self.memtable:
            if self._compact_debt:
                self._compact_with_debt()
            return
        items = sorted(self.memtable.items())
        self.memtable = {}
        flat = b"".join(k + v for k, v in items)
        entries = np.frombuffer(flat, dtype=np.uint8).reshape(
            len(items), self.entry_size
        )
        info = self._write_table_arr(entries)
        self.levels[0].insert(0, info)
        self._log("i", 0, info)
        self._compact_with_debt()

    def _compact_with_debt(self) -> None:
        """Run compaction under the resume contract: if a merge read
        raises (faulted block awaiting peer repair), the debt flag stays
        set and the NEXT settle point re-runs compaction BEFORE any new
        allocation — so a heal-and-retry replica allocates grid blocks in
        the same order as a replica that never faulted."""
        self._compact_debt = True
        self._maybe_compact()
        self._compact_debt = False

    def put_array(self, keys: np.ndarray, values,
                  settle: bool = True) -> None:
        """Array-native bulk put: keys np.uint8 [n, key_size]; values
        np.uint8 [n, value_size] or ONE shared value (bytes) broadcast to
        every key (secondary-index presence bytes). The spill cycle's
        write path — no per-key Python objects anywhere.

        Arrays BUFFER in _pending and settle in bulk (one sort over many
        cycles' worth of entries, split into large tables); any read or
        flush settles first, so visibility is unchanged. settle=False
        defers even the size-threshold settle: the call then touches no
        grid state at all and CANNOT raise — the exactly-once building
        block for the spill cycle's fault-retry contract."""
        n = len(keys)
        if n == 0:
            return
        assert keys.shape == (n, self.key_size) and keys.dtype == np.uint8
        if self.memtable:
            # settle=False promises "touches no grid state, CANNOT raise";
            # flushing a memtable writes tables and runs compaction (both
            # can raise GridBlockCorrupt). A caller mixing put() with
            # put_array(settle=False) must fail loudly here rather than
            # silently breaking the spill job's exactly-once fault-retry
            # contract.
            assert settle, (
                "put_array(settle=False) requires an empty memtable: the "
                "no-raise guarantee cannot hold across a memtable flush"
            )
            self._flush_memtable()
        self._pending.append((keys, values))
        self._pending_rows += n
        if settle and self._pending_rows >= self.settle_max:
            self._settle()

    def _settle(self) -> None:
        with self.tracer.span("lsm.compact", rows=self._pending_rows), \
                self.metrics.histogram("lsm.compact_us").time():
            self._settle_inner()

    def _settle_inner(self) -> None:
        """Sort the accumulated put_array buffers into level-0 tables.
        Resume-safe: all level-0 tables land before compaction starts, so
        a compaction raise leaves every settled entry durable in the
        levels and sets _compact_debt for the retry."""
        if not self._pending:
            if self._compact_debt:
                self._compact_with_debt()
            return
        bufs, self._pending = self._pending, []
        n = self._pending_rows
        self._pending_rows = 0
        entries = np.empty((n, self.entry_size), dtype=np.uint8)
        at = 0
        for keys, values in bufs:
            k = len(keys)
            entries[at : at + k, : self.key_size] = keys
            if isinstance(values, (bytes, bytearray)):
                assert len(values) == self.value_size
                entries[at : at + k, self.key_size :] = np.frombuffer(
                    bytes(values), dtype=np.uint8
                )
            else:
                assert values.shape == (k, self.value_size)
                entries[at : at + k, self.key_size :] = values
            at += k
        order = np.lexsort(self._key_cols(entries))
        entries = entries[order]
        if n > 1:
            # duplicate keys across buffers: LAST wins (later input is
            # newer; stable lexsort preserved input order within runs)
            kw = entries[:, : self.key_size]
            last = np.empty(n, dtype=bool)
            last[-1] = True
            last[:-1] = np.any(kw[1:] != kw[:-1], axis=1)
            entries = entries[last]
        # ALL chunks land in level 0 before any compaction: a compaction
        # read can raise GridBlockCorrupt (faulted block awaiting repair),
        # and the caller's retry must find every settled entry durable in
        # the levels — compacting between chunks would lose the rest
        for start in range(0, len(entries), self.table_entries_max):
            chunk = entries[start : start + self.table_entries_max]
            info = self._write_table_arr(chunk)
            self.levels[0].insert(0, info)
            self._log("i", 0, info)
        self._compact_with_debt()

    def _log(self, op: str, level: int, info: TableInfo) -> None:
        if self.manifest_log is not None:
            self.manifest_log.append(self.tree_id, level, op, info)

    def _key_cols(self, entries: np.ndarray) -> tuple:
        """Sort columns for np.lexsort: the key bytes (big-endian
        comparable) packed into native u64 words, LEAST significant word
        first (lexsort's primary key is the last element). Right-padding
        with zeros preserves lexicographic order for equal-length keys."""
        k = self.key_size
        nw = (k + 7) // 8
        n = len(entries)
        if k == nw * 8:
            padded = np.ascontiguousarray(entries[:, :k])
        else:
            padded = np.zeros((n, nw * 8), dtype=np.uint8)
            padded[:, :k] = entries[:, :k]
        words = padded.view(">u8").astype(np.uint64)
        return tuple(words[:, w] for w in range(nw - 1, -1, -1))

    def _write_table_arr(self, entries: np.ndarray) -> TableInfo:
        """One immutable on-disk table from sorted packed entries."""
        n = len(entries)
        assert n > 0
        epb = self.entries_per_block
        index = bytearray()
        flat = entries.tobytes()
        row = self.entry_size
        for i in range(0, n, epb):
            payload = flat[i * row : min(i + epb, n) * row]
            addr = self.grid.create_block(payload)
            index += addr.to_bytes(8, "little") + flat[
                i * row : i * row + self.key_size
            ]
        index_address = self.grid.create_block(bytes(index))
        filter_address = (
            self.grid.create_block(
                build_filter(entries[:, : self.key_size], n)
            )
            if self.filters else 0
        )
        return TableInfo(
            index_address=index_address,
            key_min=flat[: self.key_size],
            key_max=flat[(n - 1) * row : (n - 1) * row + self.key_size],
            entry_count=n,
            filter_address=filter_address,
            filter_version=1,
        )

    def _level_budget(self, level: int) -> int:
        return LEVEL0_TABLES_MAX * (GROWTH_FACTOR ** level)

    def _maybe_compact(self) -> None:
        """At most ONE paced table merge per over-budget level per call
        (the half-bar analog); a 2x-budget backpressure loop bounds the
        worst case (reference paces compaction so a level can never run
        away, src/lsm/compaction.zig:1-32)."""
        for level in range(len(self.levels)):
            budget = self._level_budget(level)
            if len(self.levels[level]) > budget:
                self._compact_one(level)
            while len(self.levels[level]) > 2 * budget:
                self._compact_one(level)
        from tigerbeetle_tpu_torch import constants

        if constants.VERIFY:
            self.verify_levels()

    def verify_levels(self) -> None:
        """Intensive-tier audit (constants.VERIFY; reference
        src/constants.zig:592): every level >= 1 holds DISJOINT tables
        sorted by key range, and every table's bounds are ordered."""
        for level, tables in enumerate(self.levels):
            for info in tables:
                assert info.key_min <= info.key_max, (
                    f"L{level}: inverted table bounds"
                )
                assert info.entry_count > 0, f"L{level}: empty table"
            if level == 0:
                continue
            for a, b in zip(tables, tables[1:]):
                assert a.key_max < b.key_min, (
                    f"L{level}: overlapping/unsorted tables "
                    f"({a.key_max.hex()} !< {b.key_min.hex()})"
                )

    def _compact_one(self, level: int) -> None:
        """Merge ONE victim table from `level` with the intersecting tables
        of `level+1`: a VECTORIZED k-way merge — victim + intersecting run
        load as packed matrices, one stable lexsort orders them (victim
        rows first, so newest wins on equal keys), a shifted-compare mask
        dedups, tombstones drop at the bottom, and the result splits into
        bounded output tables. Host memory is O(victim + intersecting run)
        <= (1 + growth) tables — traded up from the old streaming merge's
        O(block) bound, which cost a Python iteration per entry and
        dominated entire spill cycles (reference streams because servers
        are memory-constrained, src/lsm/compaction.zig:1-32; this host is
        not, and the bench bills the difference)."""
        if level + 1 >= len(self.levels):
            self.levels.append([])
        src, dst = self.levels[level], self.levels[level + 1]
        if level == 0:
            cur = len(src) - 1  # oldest level-0 table
        else:
            cur = self._compact_cursor.get(level, 0) % len(src)
        victim = src[cur]  # peeked, NOT popped: reads below may raise
        # intersecting run in the (sorted, disjoint) destination level
        lo_i = 0
        while lo_i < len(dst) and dst[lo_i].key_max < victim.key_min:
            lo_i += 1
        hi_i = lo_i
        while hi_i < len(dst) and dst[hi_i].key_min <= victim.key_max:
            hi_i += 1
        olds = dst[lo_i:hi_i]
        bottom = (
            level + 1 == len(self.levels) - 1
            or all(not lvl for lvl in self.levels[level + 2 :])
        )

        if not olds:
            # disjoint victim: MOVE the table down — no read, no rewrite,
            # no grid churn (reference: src/lsm/compaction.zig move_table).
            # Ascending-key trees (object/posted trees: timestamp keys)
            # take this path almost every time, so their spill write cost
            # is one table write total.
            src.pop(cur)
            if level != 0:
                self._compact_cursor[level] = cur
            self._log("r", level, victim)
            self._log("i", level + 1, victim)
            self.levels[level + 1] = dst[:lo_i] + [victim] + dst[lo_i:]
            return

        # read EVERY merge input before touching the level lists: a read
        # of a faulted block raises GridBlockCorrupt, the replica repairs
        # it from a peer and retries — the tree must still hold all data.
        # Addresses are captured at read time so the releases below never
        # re-read (a re-read could raise AFTER the lists were mutated).
        inputs = [self._read_table_arr(t) for t in [victim, *olds]]
        src.pop(cur)
        if level != 0:
            self._compact_cursor[level] = cur  # next table shifts into place
        merged = np.concatenate([arr for arr, _ in inputs])
        order = np.lexsort(self._key_cols(merged))
        merged = merged[order]
        n = len(merged)
        keep = np.ones(n, dtype=bool)
        if n > 1:
            kw = merged[:, : self.key_size]
            # stable sort put the victim's (newer) row first in each equal-
            # key run: keep the FIRST of each run
            keep[1:] = np.any(kw[1:] != kw[:-1], axis=1)
        if bottom:
            keep &= ~np.all(
                merged[:, self.key_size :] == np.uint8(0xFF), axis=1
            )
        merged = merged[keep]

        out: list[TableInfo] = []
        for start in range(0, len(merged), self.table_entries_max):
            out.append(
                self._write_table_arr(
                    merged[start : start + self.table_entries_max]
                )
            )
        for (_, addrs), info in zip(inputs[1:], olds):
            self._release_table(info, addrs)
            self._log("r", level + 1, info)
        self._release_table(victim, inputs[0][1])
        self._log("r", level, victim)
        for info in out:
            self._log("i", level + 1, info)
        self.levels[level + 1] = dst[:lo_i] + out + dst[hi_i:]

    def _read_table_arr(
        self, info: TableInfo
    ) -> tuple[np.ndarray, list[int]]:
        """One table's entries as a packed np.uint8 [n, entry_size] matrix
        (the merge input form), plus its data-block addresses (so the
        caller can release the table without re-reading the index)."""
        index = self.grid.read_block(info.index_address)
        rec = 8 + self.key_size
        addrs = [
            int.from_bytes(index[i * rec : i * rec + 8], "little")
            for i in range(len(index) // rec)
        ]
        flat = b"".join(self.grid.read_block(a) for a in addrs)
        # read-only view is fine: merge inputs only flow into concatenate/
        # fancy-indexing, which allocate fresh output arrays
        return np.frombuffer(flat, dtype=np.uint8).reshape(
            -1, self.entry_size
        ), addrs

    def _release_table(self, info: TableInfo, addrs: list[int]) -> None:
        """Release a table's blocks from captured addresses — no reads."""
        for a in addrs:
            self.grid.release(a)
        self.grid.release(info.index_address)
        if info.filter_address:
            self.grid.release(info.filter_address)

    # -- checkpoint (persisted via the ManifestLog, lsm/manifest_log.py) --

    def live_tables(self) -> list:
        """(tree_id, level, info) of every live table — the manifest log's
        compaction snapshot input. Level 0 is emitted OLDEST-FIRST: the
        log's restore replays events chronologically and rebuilds level 0
        newest-first by reversing, so snapshot events must read like the
        original insert order."""
        out = [(self.tree_id, 0, info) for info in reversed(self.levels[0])]
        for level, tables in enumerate(self.levels[1:], start=1):
            out += [(self.tree_id, level, info) for info in tables]
        return out

    def restore_levels(self, per_level: dict[int, list[TableInfo]]) -> None:
        """Adopt levels replayed from the manifest log."""
        n = max(per_level, default=0) + 1
        self.levels = [per_level.get(i, []) for i in range(max(n, 1))]
        self.memtable = {}
        self._pending = []
        self._pending_rows = 0
        self._compact_debt = False
        self._compact_cursor = {}
