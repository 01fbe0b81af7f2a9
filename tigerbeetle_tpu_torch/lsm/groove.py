"""Grooves and the Forest: the object stores over LSM trees.

The reference's Groove (reference: src/lsm/groove.zig:23-77, 602-1010):
ObjectTree keyed by timestamp + IdTree mapping id -> timestamp + one
secondary index tree per struct field (comptime-generated from the fields
not in `ignored`, reference: src/lsm/groove.zig:137-157), with
get/insert/upsert and the prefetch contract (async load, then synchronous
get during commit). The Forest fans open/flush/checkpoint out to every
groove (reference: src/lsm/forest.zig:253-407).

Index trees use composite keys (reference: src/lsm/composite_key.zig):
big-endian field value ++ big-endian timestamp, so one range scan yields a
field value's matching timestamps in commit order. Upsert diffs old vs new
rows and touches only the CHANGED index trees (reference:
src/lsm/groove.zig:925-966 — balance mutations remove + reinsert).

The per-groove field lists mirror the reference's tree ids 1-24
(reference: src/state_machine.zig:67-100): accounts index
debits/credits_pending/posted, user_data_128/64/32, ledger, code (flags
and reserved ignored); transfers index debit/credit_account_id, amount,
pending_id, user_data_128/64/32, timeout, ledger, code (flags ignored).

Role in the device design: the device hash tables ARE the working set;
this LSM forest is the bounded-memory BACKING store once state exceeds them — cold
rows spill here (models/spill.py) and reload before a commit needs them.
Queries merge a device filter-scan over the device tables with index range
scans over the spilled tail (models/ledger.py query_*).

The port's copy of `tigerbeetle_tpu/lsm/groove.py`, the same code with its imports
pointed at this package (the port imports nothing of the JAX package), so
that the port writes the same grid bytes.
"""

from __future__ import annotations

from tigerbeetle_tpu_torch.lsm.grid import Grid
from tigerbeetle_tpu_torch.lsm.tree import Tree

ID_SIZE = 16
TS_SIZE = 8
OBJECT_SIZE = 128
TS_MAX = (1 << 64) - 1

# (name, byte offset in the 128-byte wire row, width) — little-endian fields
# (reference struct layouts: src/tigerbeetle.zig:7-40 Account, :64-89
# Transfer; index field sets: src/state_machine.zig:103-206).
ACCOUNT_INDEX_FIELDS = (
    ("debits_pending", 16, 16),
    ("debits_posted", 32, 16),
    ("credits_pending", 48, 16),
    ("credits_posted", 64, 16),
    ("user_data_128", 80, 16),
    ("user_data_64", 96, 8),
    ("user_data_32", 104, 4),
    ("ledger", 112, 4),
    ("code", 116, 2),
)
TRANSFER_INDEX_FIELDS = (
    ("debit_account_id", 16, 16),
    ("credit_account_id", 32, 16),
    ("amount", 48, 16),
    ("pending_id", 64, 16),
    ("user_data_128", 80, 16),
    ("user_data_64", 96, 8),
    ("user_data_32", 104, 4),
    ("timeout", 108, 4),
    ("ledger", 112, 4),
    ("code", 116, 2),
)


class Groove:
    def __init__(self, grid: Grid, memtable_max: int = 2048,
                 index_fields: tuple = (), manifest_log=None,
                 tree_ids: dict | None = None):
        tid = tree_ids or {}
        # ObjectTree: timestamp (big-endian, order-preserving) -> 128B row
        self.objects = Tree(grid, TS_SIZE, OBJECT_SIZE, memtable_max,
                            manifest_log=manifest_log,
                            tree_id=tid.get("timestamp", 0))
        # IdTree: id (big-endian u128) -> timestamp (reference IdTreeValue)
        self.ids = Tree(grid, ID_SIZE, TS_SIZE, memtable_max,
                        manifest_log=manifest_log, tree_id=tid.get("id", 0))
        # Secondary index trees: (field_be ++ ts_be) -> presence byte.
        # filters=False: index trees are range-scanned only (query()), and
        # bloom filters serve point lookups — building them was ~30% of a
        # spill cycle's LSM bill for nothing.
        self.index_spec = {name: (off, w) for name, off, w in index_fields}
        self.indexes = {
            name: Tree(grid, w + TS_SIZE, 1, memtable_max,
                       manifest_log=manifest_log, tree_id=tid.get(name, 0),
                       filters=False)
            for name, off, w in index_fields
        }
        # prefetch cache: id -> row (the CacheMap residency contract:
        # prefetched values stay resident through the commit, reference:
        # src/lsm/cache_map.zig:10-25)
        self.prefetched: dict[int, bytes | None] = {}

    @staticmethod
    def _id_key(id_: int) -> bytes:
        return id_.to_bytes(ID_SIZE, "big")

    @staticmethod
    def _ts_key(timestamp: int) -> bytes:
        return timestamp.to_bytes(TS_SIZE, "big")

    def _index_key(self, off: int, w: int, row: bytes, ts_key: bytes) -> bytes:
        return row[off : off + w][::-1] + ts_key  # LE field -> BE prefix

    # -- writes (reference: groove.insert/upsert/remove :902-966) --

    def insert(self, id_: int, timestamp: int, row: bytes) -> None:
        assert len(row) == OBJECT_SIZE
        ts_key = self._ts_key(timestamp)
        self.objects.put(ts_key, row)
        self.ids.put(self._id_key(id_), ts_key)
        for name, (off, w) in self.index_spec.items():
            self.indexes[name].put(
                self._index_key(off, w, row, ts_key), b"\x00"
            )

    def insert_bulk(self, rows_u8, timestamps, settle: bool = True) -> None:
        """Array-native bulk insert of n wire rows (np.uint8 [n, 128]) with
        their timestamps (np.uint64 [n]) — the spill cycle's write path.
        Key construction is numpy byte-slicing (big-endian composite keys
        built column-wise); each tree takes ONE put_array — no per-entry
        Python objects from here through the on-disk table write.
        settle=False defers all on-disk settling (the call cannot raise);
        the caller later settles each tree at a fault-retry-safe point."""
        import numpy as np

        n = len(rows_u8)
        if n == 0:
            return
        rows_u8 = np.ascontiguousarray(rows_u8)
        ts_be = np.ascontiguousarray(
            timestamps.astype(">u8")
        ).view(np.uint8).reshape(n, TS_SIZE)
        self.objects.put_array(ts_be, rows_u8, settle=settle)
        # id key: the 16 LE bytes at offset 0, reversed -> BE u128
        id_be = np.ascontiguousarray(rows_u8[:, ID_SIZE - 1 :: -1])
        self.ids.put_array(id_be, ts_be, settle=settle)
        for name, (off, w) in self.index_spec.items():
            field_be = rows_u8[:, off + w - 1 : (off - 1 if off else None) : -1]
            comp = np.concatenate(
                [np.ascontiguousarray(field_be), ts_be], axis=1
            )
            self.indexes[name].put_array(comp, b"\x00", settle=settle)

    def upsert(self, id_: int, timestamp: int, row: bytes,
               old_row: bytes | None = None) -> None:
        """Replace the object at `timestamp`. With `old_row`, only CHANGED
        index entries are removed/reinserted (reference diffs via the object
        cache, src/lsm/groove.zig:925-966); without it, the caller asserts
        the indexed fields are unchanged (e.g. re-spilling an identical
        immutable row)."""
        ts_key = self._ts_key(timestamp)
        self.objects.put(ts_key, row)
        self.ids.put(self._id_key(id_), ts_key)
        for name, (off, w) in self.index_spec.items():
            new_field = row[off : off + w]
            if old_row is None:
                self.indexes[name].put(
                    self._index_key(off, w, row, ts_key), b"\x00"
                )
            elif old_row[off : off + w] != new_field:
                self.indexes[name].remove(
                    self._index_key(off, w, old_row, ts_key)
                )
                self.indexes[name].put(
                    self._index_key(off, w, row, ts_key), b"\x00"
                )

    def remove(self, id_: int, timestamp: int,
               row: bytes | None = None) -> None:
        ts_key = self._ts_key(timestamp)
        self.objects.remove(ts_key)
        self.ids.remove(self._id_key(id_))
        if row is not None:
            for name, (off, w) in self.index_spec.items():
                self.indexes[name].remove(
                    self._index_key(off, w, row, ts_key)
                )

    # -- reads: prefetch then synchronous get (reference :608-760, 602) --

    def prefetch(self, ids: list[int]) -> None:
        """Load the working set (IdTree -> ObjectTree cascade). After this,
        get() is synchronous and pure — the property that lets the commit
        step run as one device kernel."""
        for id_ in ids:
            if id_ in self.prefetched:
                continue
            ts_key = self.ids.get(self._id_key(id_))
            self.prefetched[id_] = (
                None if ts_key is None else self.objects.get(ts_key)
            )

    def get(self, id_: int) -> bytes | None:
        assert id_ in self.prefetched, "get() before prefetch()"
        return self.prefetched[id_]

    def get_many_rows(
        self, ids: list[int]
    ) -> tuple[list[bytes | None], list[bytes | None]]:
        """Batched id -> (row, ts_key) via ONE multi-point-read per tree
        (IdTree then ObjectTree) instead of a full cascade per id — the
        spill reload's vectorized multi-lookup (reference prefetch contract,
        src/lsm/groove.zig:710-760). Positional: rows[i]/ts_keys[i] are
        None when ids[i] is absent."""
        ts_keys = self.ids.get_many([self._id_key(i) for i in ids])
        hit_idx = [i for i, t in enumerate(ts_keys) if t is not None]
        rows: list[bytes | None] = [None] * len(ids)
        if hit_idx:
            got = self.objects.get_many([ts_keys[i] for i in hit_idx])
            for i, row in zip(hit_idx, got):
                rows[i] = row
        return rows, ts_keys

    def prefetch_clear(self) -> None:
        self.prefetched.clear()

    # -- queries (reference: tree.zig:1126-1140 RangeQuery over an index) --

    def query(self, field: str, value: int, ts_min: int = 0,
              ts_max: int = TS_MAX) -> list[int]:
        """Timestamps of objects whose `field` equals `value`, ascending —
        one composite-key range scan."""
        off, w = self.index_spec[field]
        prefix = value.to_bytes(w, "big")
        lo = prefix + ts_min.to_bytes(TS_SIZE, "big")
        hi = prefix + ts_max.to_bytes(TS_SIZE, "big")
        return [
            int.from_bytes(k[-TS_SIZE:], "big")
            for k, _ in self.indexes[field].range(lo, hi)
        ]

    def get_by_timestamp(self, timestamp: int) -> bytes | None:
        return self.objects.get(self._ts_key(timestamp))

    # -- lifecycle --

    def flush(self) -> None:
        self.objects.flush()
        self.ids.flush()
        for tree in self.indexes.values():
            tree.flush()


# Tree id assignment mirrors the reference exactly (reference:
# src/state_machine.zig:67-100 tree_ids).
ACCOUNT_TREE_IDS = {
    "id": 1, "debits_pending": 2, "debits_posted": 3, "credits_pending": 4,
    "credits_posted": 5, "user_data_128": 6, "user_data_64": 7,
    "user_data_32": 8, "ledger": 9, "code": 10, "timestamp": 11,
}
TRANSFER_TREE_IDS = {
    "id": 12, "debit_account_id": 13, "credit_account_id": 14, "amount": 15,
    "pending_id": 16, "user_data_128": 17, "user_data_64": 18,
    "user_data_32": 19, "timeout": 20, "ledger": 21, "code": 22,
    "timestamp": 23,
}
POSTED_TREE_ID = 24


class Forest:
    """The grooves of the accounting state machine (reference:
    src/state_machine.zig:67-100: accounts, transfers, posted — tree ids
    1-24 incl. the per-field secondary indexes). Checkpoints persist the
    manifest INCREMENTALLY via the ManifestLog block chain
    (lsm/manifest_log.py; reference: src/lsm/manifest_log.zig)."""

    def __init__(self, grid: Grid, memtable_max: int = 2048):
        from tigerbeetle_tpu_torch.lsm.manifest_log import ManifestLog

        self.grid = grid
        self.manifest_log = ManifestLog(grid)
        self.accounts = Groove(grid, memtable_max=memtable_max,
                               index_fields=ACCOUNT_INDEX_FIELDS,
                               manifest_log=self.manifest_log,
                               tree_ids=ACCOUNT_TREE_IDS)
        self.transfers = Groove(grid, memtable_max=memtable_max,
                                index_fields=TRANSFER_INDEX_FIELDS,
                                manifest_log=self.manifest_log,
                                tree_ids=TRANSFER_TREE_IDS)
        # posted: pending timestamp -> fulfillment byte (padded value)
        self.posted = Tree(grid, TS_SIZE, 1, memtable_max,
                           manifest_log=self.manifest_log,
                           tree_id=POSTED_TREE_ID)

    def _trees(self) -> list[Tree]:
        out = []
        for g in (self.accounts, self.transfers):
            out += [g.objects, g.ids, *g.indexes.values()]
        out.append(self.posted)
        return out

    def flush(self) -> None:
        self.accounts.flush()
        self.transfers.flush()
        self.posted.flush()

    def checkpoint(self) -> dict:
        """Flush everything, persist manifest churn to the log chain, and
        return the durable meta (manifest log blocks + identity registry
        head + free set — the superblock trailer contract, reference:
        src/vsr/superblock_manifest.zig). Block creation (manifest chain,
        then the registry chain capturing every live block's expected
        checksum) happens BEFORE the free set encode, which applies staged
        releases last."""
        self.flush()
        live = [t for tree in self._trees() for t in tree.live_tables()]
        mlog = self.manifest_log.checkpoint(live)
        block_chk = self.grid.encode_chk_registry()
        return {
            "manifest_log": mlog,
            "block_chk": block_chk,
            "free_set": self.grid.encode_free_set().hex(),
        }

    def restore(self, m: dict) -> None:
        # the registry FIRST: every later chain/table read then carries
        # identity verification, not just self-checksums
        self.grid.restore_chk_registry(m.get("block_chk"))
        levels = self.manifest_log.restore(m["manifest_log"])
        for tree in self._trees():
            assert tree.tree_id > 0
            tree.restore_levels(levels.get(tree.tree_id, {}))
        self.grid.restore_free_set(bytes.fromhex(m["free_set"]))
