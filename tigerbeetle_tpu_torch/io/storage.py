"""The Storage seam: zoned, durable sector IO.

This is the dependency-injection boundary the whole test strategy hangs on
(reference: src/storage.zig production vs src/testing/storage.zig fake,
injected comptime at src/tigerbeetle/main.zig:26-33; SURVEY.md §4 takeaway
"replicate the seam, not the files"). Everything above — journal,
superblock, grid, checkpoint — talks to this interface only, so the
deterministic simulator swaps in MemoryStorage (with per-zone fault
injection) with zero changes to the layers above.

Zones mirror the reference's disk layout (reference: src/vsr.zig:59-108):
superblock | wal_headers | wal_prepares | client_replies | grid.

The port's copy of `tigerbeetle_tpu/io/storage.py`, the same code with its imports
pointed at this package (the port imports nothing of the JAX package), so
that the port writes the same grid bytes.
"""

from __future__ import annotations

import enum
import os

from tigerbeetle_tpu_torch.constants import ConfigCluster, DEFAULT_CLUSTER

SECTOR_SIZE = 4096


class Zone(enum.Enum):
    superblock = 0
    wal_headers = 1
    wal_prepares = 2
    client_replies = 3
    grid = 4


class ZoneLayout:
    """Byte offsets/sizes of each zone for a cluster config."""

    SUPERBLOCK_COPIES = 4
    SUPERBLOCK_COPY_SIZE = 64 * 1024  # header sector + trailers, padded

    def __init__(self, cluster: ConfigCluster = DEFAULT_CLUSTER,
                 grid_size: int = 64 * 1024 * 1024,
                 forest_blocks: int = 0):
        slot_count = cluster.journal_slot_count
        msg_max = cluster.message_size_max
        # The grid zone partitions as: two ping-pong snapshot areas | the
        # LSM forest's block area (`forest_blocks` 128 KiB blocks, for the
        # spill backing store — 0 when the ledger is HBM-only).
        self.forest_blocks = forest_blocks
        forest_size = forest_blocks * cluster.block_size
        assert forest_size < grid_size, "forest larger than the grid zone"
        self.snapshot_area_size = (grid_size - forest_size) // 2 // 4096 * 4096
        self.forest_offset = 2 * self.snapshot_area_size
        self.sizes = {
            Zone.superblock: self.SUPERBLOCK_COPIES * self.SUPERBLOCK_COPY_SIZE,
            Zone.wal_headers: _sector_ceil(slot_count * 128),
            Zone.wal_prepares: slot_count * msg_max,
            Zone.client_replies: cluster.reply_slot_count * msg_max,
            Zone.grid: grid_size,
        }
        self.starts = {}
        off = 0
        for z in Zone:
            self.starts[z] = off
            off += self.sizes[z]
        self.total_size = off

    def offset(self, zone: Zone, offset_logical: int) -> int:
        assert 0 <= offset_logical < self.sizes[zone], (zone, offset_logical)
        return self.starts[zone] + offset_logical


def _sector_ceil(n: int) -> int:
    return (n + SECTOR_SIZE - 1) // SECTOR_SIZE * SECTOR_SIZE


class Storage:
    """Interface: durable zoned IO. Writes are durable when the call returns
    (the file backend opens O_DSYNC / fdatasyncs)."""

    layout: ZoneLayout

    def read(self, zone: Zone, offset: int, size: int) -> bytes:
        raise NotImplementedError

    def write(self, zone: Zone, offset: int, data: bytes) -> None:
        raise NotImplementedError

    def write_lazy(self, zone: Zone, offset: int, data: bytes) -> None:
        """Buffered write: durable only after the next sync(). For data
        whose loss is tolerated by a checksum-validated read path (client
        reply slots) — an O_DSYNC flush per reply would contend with the
        WAL's flushes for the device (measured ~2 ms each, and far worse
        under concurrent 1 MiB prepare writes)."""
        self.write(zone, offset, data)

    def sync(self) -> None:
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError


class FileStorage(Storage):
    """Production path: the native C++ sector IO (native/storage.cc —
    O_DIRECT+O_DSYNC with buffered fallback; reference: src/storage.zig)."""

    def __init__(self, path: str, layout: ZoneLayout, create: bool = False):
        from tigerbeetle_tpu_torch import native

        self.layout = layout
        self.path = path
        self._lib = native.lib()
        fd = self._lib.tb_storage_open(
            path.encode(), layout.total_size, 1 if create else 0
        )
        if fd < 0:
            raise OSError(-fd, os.strerror(-fd), path)
        self.fd = fd
        # Buffered second descriptor for write_lazy (no O_DSYNC): reply-slot
        # writes ride the page cache; sync() fdatasyncs it.
        self._lazy_fd = os.open(path, os.O_RDWR)

    def read(self, zone: Zone, offset: int, size: int) -> bytes:
        import ctypes

        buf = ctypes.create_string_buffer(size)
        rc = self._lib.tb_storage_read(
            self.fd, self.layout.offset(zone, offset), buf, size
        )
        if rc < 0:
            raise OSError(-rc, os.strerror(-rc))
        return buf.raw

    def write(self, zone: Zone, offset: int, data: bytes) -> None:
        rc = self._lib.tb_storage_write(
            self.fd, self.layout.offset(zone, offset), bytes(data), len(data)
        )
        if rc < 0:
            raise OSError(-rc, os.strerror(-rc))

    def write_lazy(self, zone: Zone, offset: int, data: bytes) -> None:
        os.pwrite(self._lazy_fd, data, self.layout.offset(zone, offset))

    def sync(self) -> None:
        os.fdatasync(self._lazy_fd)  # lazy writes become durable here
        rc = self._lib.tb_storage_sync(self.fd)
        if rc < 0:
            raise OSError(-rc, os.strerror(-rc))

    def close(self) -> None:
        if self.fd >= 0:
            self._lib.tb_storage_close(self.fd)
            self.fd = -1
            os.close(self._lazy_fd)


class MemoryStorage(Storage):
    """Deterministic in-memory fake (reference: src/testing/storage.zig).

    Durability contract matches the production backend: a write is durable
    when the call returns (FileStorage opens O_DSYNC). Fault injection:
    `fault(zone, offset, size)` flips bytes so checksums fail — the
    simulator drives this per its fault atlas. `crash()` models power loss
    DURING the single in-flight write: the LAST write (only) is torn,
    keeping or reverting each of its sectors independently (seeded). It
    must not drop earlier acknowledged writes — the production device
    cannot."""

    def __init__(self, layout: ZoneLayout, seed: int = 0):
        import random

        self.layout = layout
        self.data = bytearray(layout.total_size)
        self.rng = random.Random(seed)
        self._last_write: tuple[int, bytes] | None = None  # (abs, old bytes)
        self.reads = 0
        self.writes = 0
        # Optional per-read observer (zone, offset, size) — the simulator's
        # latency/IO-accounting injection point. Lives on the Storage seam
        # so the layers above stay untouched: a hook that sleeps models a
        # slow medium, a hook that records the calling context proves which
        # loop paid for the read (reference: src/testing/storage.zig models
        # read/write latency inside the fake, not the callers).
        self.read_hook = None

    def read(self, zone: Zone, offset: int, size: int) -> bytes:
        self.reads += 1
        if self.read_hook is not None:
            self.read_hook(zone, offset, size)
        start = self.layout.offset(zone, offset)
        return bytes(self.data[start : start + size])

    def write(self, zone: Zone, offset: int, data: bytes) -> None:
        self.writes += 1
        start = self.layout.offset(zone, offset)
        self._last_write = (start, bytes(self.data[start : start + len(data)]))
        self.data[start : start + len(data)] = data

    def sync(self) -> None:
        self._last_write = None  # a sync barrier: nothing in flight

    def close(self) -> None:
        pass

    # -- fault injection --

    def fault(self, zone: Zone, offset: int, size: int = SECTOR_SIZE) -> None:
        start = self.layout.offset(zone, offset)
        for i in range(start, min(start + size, len(self.data))):
            self.data[i] ^= 0xFF

    def crash(self) -> None:
        """Tear the single in-flight write: each of its sectors is
        independently kept or reverted (seeded)."""
        if self._last_write is None:
            return
        start, old = self._last_write
        for s in range(0, len(old), SECTOR_SIZE):
            if self.rng.random() < 0.5:  # this sector's write is lost
                end = min(s + SECTOR_SIZE, len(old))
                self.data[start + s : start + end] = old[s:end]
        self._last_write = None
