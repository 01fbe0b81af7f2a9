"""Per-structure fuzzers (tier 4).

The reference runs a dedicated fuzzer per load-bearing data structure
(reference: build.zig:508-558 — fuzz_ewah, fuzz_lsm_tree, fuzz_lsm_forest,
fuzz_lsm_manifest_log, fuzz_lsm_cache_map, fuzz_vsr_journal_format,
fuzz_vsr_superblock, fuzz_vsr_superblock_free_set; shared helpers
src/testing/fuzz.zig). Each fuzzer here is a seeded function
``fuzz_*(seed, steps)`` that drives the structure against an oracle model
(or an invariant set) and raises AssertionError on any divergence:

- the pytest tier runs every fuzzer with bounded steps
  (tests/test_torch_fuzz.py).

Corruption-facing fuzzers (journal format, superblock) assert the
recovery paths never crash and never accept corrupt data silently.

The port's copy of `tigerbeetle_tpu/testing/fuzz.py`, over the port's
`lsm/`, `vsr/` and `stdx.py`.
"""

from __future__ import annotations

import random

from tigerbeetle_tpu_torch import stdx
from tigerbeetle_tpu_torch.constants import TEST_CLUSTER
from tigerbeetle_tpu_torch.io.storage import MemoryStorage, Zone, ZoneLayout
from tigerbeetle_tpu_torch.lsm.cache import SetAssociativeCache
from tigerbeetle_tpu_torch.lsm.grid import Grid
from tigerbeetle_tpu_torch.lsm.groove import Forest
from tigerbeetle_tpu_torch.lsm.tree import Tree
from tigerbeetle_tpu_torch.vsr.free_set import FreeSet
from tigerbeetle_tpu_torch.vsr.header import Command, Header
from tigerbeetle_tpu_torch.vsr.journal import Journal
from tigerbeetle_tpu_torch.vsr.superblock import SuperBlock, VSRState

_LAYOUT = ZoneLayout(TEST_CLUSTER, grid_size=96 * 1024 * 1024)


def _grid(storage=None, blocks=640):
    storage = storage or MemoryStorage(_LAYOUT)
    return storage, Grid(storage, offset=0, block_count=blocks,
                         cache_blocks=64)


# ----------------------------------------------------------------------
# fuzz_ewah (reference: src/ewah.zig codec)
# ----------------------------------------------------------------------


def fuzz_ewah(seed: int, steps: int = 200) -> None:
    rng = random.Random(seed)
    for _ in range(steps):
        n = rng.randint(1, 256)
        style = rng.random()
        if style < 0.3:  # long runs (the codec's compression case)
            words, w = [], 0
            while len(words) < n:
                run = rng.randint(1, n - len(words))
                w = rng.choice((0, (1 << 64) - 1, rng.getrandbits(64)))
                words += [w] * run
        else:
            words = [rng.getrandbits(64) for _ in range(n)]
        enc = stdx.ewah_encode(words)
        dec = stdx.ewah_decode(enc, len(words))
        assert dec == words, f"ewah roundtrip diverged (seed {seed})"


# ----------------------------------------------------------------------
# fuzz_lsm_tree (reference: fuzz_lsm_tree.zig — ops vs a model)
# ----------------------------------------------------------------------


def fuzz_lsm_tree(seed: int, steps: int = 1500) -> None:
    rng = random.Random(seed)
    _, grid = _grid()
    tree = Tree(grid, key_size=8, value_size=8,
                memtable_max=rng.choice((16, 32, 64)))
    model: dict[bytes, bytes] = {}
    keyspace = rng.choice((64, 512, 4096))
    for step in range(steps):
        roll = rng.random()
        k = rng.randrange(keyspace).to_bytes(8, "big")
        if roll < 0.55:
            v = rng.getrandbits(63).to_bytes(8, "big")
            tree.put(k, v)
            model[k] = v
        elif roll < 0.75:
            tree.remove(k)
            model.pop(k, None)
        elif roll < 0.95:
            assert tree.get(k) == model.get(k), (seed, step)
        else:
            tree.flush()
            if rng.random() < 0.3:
                # checkpoint analog: staged frees become reusable (without
                # this, compaction churn exhausts the grid by design —
                # frees only apply at checkpoints)
                grid.encode_free_set()
    tree.flush()
    for k, v in model.items():
        assert tree.get(k) == v, (seed, k)
    lo = rng.randrange(keyspace).to_bytes(8, "big")
    hi = rng.randrange(keyspace).to_bytes(8, "big")
    if lo > hi:
        lo, hi = hi, lo
    expect = sorted((k, v) for k, v in model.items() if lo <= k <= hi)
    assert tree.range(lo, hi) == expect, seed
    # levels >= 1 must stay disjoint and sorted
    for level in tree.levels[1:]:
        for a, b in zip(level, level[1:]):
            assert a.key_max < b.key_min, (seed, "level overlap")


# ----------------------------------------------------------------------
# fuzz_lsm_forest (reference: fuzz_lsm_forest.zig — checkpoint/restore)
# ----------------------------------------------------------------------


def fuzz_lsm_forest(seed: int, steps: int = 400) -> None:
    rng = random.Random(seed)
    storage, grid = _grid()
    forest = Forest(grid)
    model: dict[int, tuple[int, bytes]] = {}
    ts = 0
    meta = None
    for step in range(steps):
        roll = rng.random()
        if roll < 0.7 or not model:
            id_ = rng.randrange(1, 4096)
            ts += 1
            # 0..254: an all-0xFF row is the tombstone encoding, which real
            # wire rows can never be (all-ones ids are invalid,
            # reference: src/tigerbeetle.zig:160-163)
            row = bytes([rng.randrange(255)]) * 128
            forest.transfers.insert(id_, ts, row)
            model[id_] = (ts, row)
        elif roll < 0.9:
            id_ = rng.choice(list(model))
            g = forest.transfers
            ts_key = g.ids.get(g._id_key(id_))
            assert ts_key is not None, (seed, step, id_)
            assert g.objects.get(ts_key) == model[id_][1], (seed, step)
        else:
            meta = forest.checkpoint()
    meta = forest.checkpoint()
    # restart: fresh forest over the same storage
    _, grid2 = _grid(storage)
    forest2 = Forest(grid2)
    forest2.restore(meta)
    for id_, (_, row) in model.items():
        g = forest2.transfers
        ts_key = g.ids.get(g._id_key(id_))
        assert ts_key is not None, (seed, id_)
        assert g.objects.get(ts_key) == row, (seed, id_)


# ----------------------------------------------------------------------
# fuzz_lsm_manifest_log (reference: fuzz_lsm_manifest_log.zig)
# ----------------------------------------------------------------------


def fuzz_lsm_manifest_log(seed: int, steps: int = 60) -> None:
    """Random churn + multiple checkpoints; every checkpoint's meta must
    restore to exactly the live table metadata at that instant."""
    rng = random.Random(seed)
    storage, grid = _grid()
    forest = Forest(grid)
    ts = 0
    for _ in range(steps):
        for _ in range(rng.randint(10, 120)):
            ts += 1
            forest.transfers.insert(rng.randrange(1, 2000), ts,
                                    bytes([ts % 251]) * 128)
        meta = forest.checkpoint()
        snapshot = [
            [i.to_json() for i in lv]
            for tree in forest._trees()
            for lv in tree.levels
            if lv
        ]
        _, grid2 = _grid(storage)
        forest2 = Forest(grid2)
        forest2.restore(meta)
        snapshot2 = [
            [i.to_json() for i in lv]
            for tree in forest2._trees()
            for lv in tree.levels
            if lv
        ]
        assert snapshot == snapshot2, seed


# ----------------------------------------------------------------------
# fuzz_cache_map analog: the set-associative cache
# ----------------------------------------------------------------------


def fuzz_sac(seed: int, steps: int = 5000) -> None:
    """A cache may evict, but must NEVER return a wrong value, and a
    just-put key must be immediately readable."""
    rng = random.Random(seed)
    cap = rng.choice((16, 64, 256))
    cache = SetAssociativeCache(cap)
    model: dict[int, int] = {}
    for step in range(steps):
        k = rng.randrange(cap * 4)
        roll = rng.random()
        if roll < 0.5:
            v = rng.getrandbits(32)
            cache.put(k, v)
            model[k] = v
            assert cache.get(k) == v, (seed, step)
        elif roll < 0.9:
            got = cache.get(k)
            assert got is None or got == model.get(k), (seed, step)
        else:
            cache.remove(k)
            assert cache.get(k) is None, (seed, step)


# ----------------------------------------------------------------------
# fuzz_vsr_superblock_free_set (reference: fuzz_vsr_superblock_free_set.zig)
# ----------------------------------------------------------------------


def fuzz_free_set(seed: int, steps: int = 2000) -> None:
    rng = random.Random(seed)
    count = rng.choice((64, 256, 1024))
    fs = FreeSet(count)
    acquired: set[int] = set()
    for step in range(steps):
        roll = rng.random()
        if roll < 0.55:
            want = rng.randint(1, 8)
            r = fs.reserve(want)
            if r is not None:
                for _ in range(rng.randint(0, want)):
                    a = fs.acquire(r)
                    if a is None:
                        break
                    assert a not in acquired, (seed, step, "double acquire")
                    acquired.add(a)
                fs.forfeit(r)
            else:
                assert fs.count_free() < want, (seed, step)
        elif roll < 0.85 and acquired:
            a = rng.choice(sorted(acquired))
            fs.release(a)
            acquired.discard(a)
        else:
            # encode/decode roundtrip preserves exact state
            fs2 = FreeSet.decode(fs.encode(), count)
            assert fs2.count_free() == fs.count_free(), (seed, step)
            assert all(not fs2.is_free(a) for a in acquired), (seed, step)
    assert fs.count_free() == count - len(acquired), seed


# ----------------------------------------------------------------------
# fuzz_vsr_journal_format (reference: fuzz_vsr_journal_format.zig —
# recovery over arbitrary bytes must classify, never crash or accept junk)
# ----------------------------------------------------------------------


def fuzz_journal_format(seed: int, steps: int = 20) -> None:
    rng = random.Random(seed)
    for _ in range(steps):
        storage = MemoryStorage(_LAYOUT)
        journal = Journal(storage, TEST_CLUSTER)
        written: dict[int, bytes] = {}
        for op in range(1, rng.randint(2, 40)):
            body = rng.randbytes(rng.randrange(0, 512))
            h = Header(command=int(Command.prepare), op=op,
                       operation=130, timestamp=op * 10)
            h.set_checksum_body(body)
            h.set_checksum()
            journal.write_prepare(h, body)
            written[op] = body
        # corrupt random WAL ranges (headers and prepares zones)
        for _ in range(rng.randrange(0, 6)):
            zone = rng.choice((Zone.wal_headers, Zone.wal_prepares))
            size = _LAYOUT.sizes[zone]
            off = rng.randrange(0, size - 64)
            storage.fault(zone, off, rng.randint(1, 4096))
        j2 = Journal(storage, TEST_CLUSTER)
        recovered = j2.recover()  # must never raise
        for op, header in recovered.items():
            got = j2.read_prepare(op)
            if got is not None:
                h2, body = got
                # anything recovery vouches for must be bit-exact
                assert body == written.get(op), (seed, op)
                assert h2.checksum == header.checksum, (seed, op)


# ----------------------------------------------------------------------
# fuzz_vsr_superblock (reference: fuzz_vsr_superblock.zig — quorum
# recovery under copy corruption)
# ----------------------------------------------------------------------


def fuzz_superblock(seed: int, steps: int = 40) -> None:
    rng = random.Random(seed)
    for _ in range(steps):
        storage = MemoryStorage(_LAYOUT)
        sb = SuperBlock(storage)
        last = None
        for seq in range(1, rng.randint(2, 6)):
            last = VSRState(cluster=7, replica=0, sequence=seq,
                            commit_min=seq * 10, commit_max=seq * 10,
                            meta={"m": str(seq)})
            sb.checkpoint(last)
        # corrupt up to 2 of the 4 copies: quorum must still recover the
        # LATEST state (reference: superblock_quorums.zig)
        n_corrupt = rng.randint(0, 2)
        size = ZoneLayout.SUPERBLOCK_COPY_SIZE
        for c in rng.sample(range(4), n_corrupt):
            storage.fault(Zone.superblock, c * size + rng.randrange(0, 4096),
                          rng.randint(1, 1024))
        sb2 = SuperBlock(storage)
        got = sb2.open()  # must never crash
        assert got.sequence == last.sequence, (seed, got.sequence)
        assert got.commit_min == last.commit_min, seed
        assert got.meta == last.meta, seed


ALL_FUZZERS = {
    "ewah": fuzz_ewah,
    "lsm_tree": fuzz_lsm_tree,
    "lsm_forest": fuzz_lsm_forest,
    "lsm_manifest_log": fuzz_lsm_manifest_log,
    "sac": fuzz_sac,
    "free_set": fuzz_free_set,
    "journal_format": fuzz_journal_format,
    "superblock": fuzz_superblock,
}
