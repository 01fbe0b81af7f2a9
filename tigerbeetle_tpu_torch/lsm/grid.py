"""The Grid: the on-disk block store under the LSM forest.

The reference's design (reference: src/vsr/grid.zig:30-33, 731, 539):
fixed-size blocks addressed by u64 (address 0 = null), allocated from the
FreeSet, every block checksummed, reads served from a block cache first.
Blocks live in the Storage seam's grid zone ABOVE the checkpoint snapshot
areas (the zone is partitioned: snapshots | blocks).

Block wire format: [checksum u128][size u32][reserved u32][payload...]
padded to block_size (the reference prefixes blocks with a full vsr.Header;
the checksum-over-payload core is the same contract).

The port's copy of `tigerbeetle_tpu/lsm/grid.py`, the same code with its imports
pointed at this package (the port imports nothing of the JAX package), so
that the port writes the same grid bytes.
"""

from __future__ import annotations

from tigerbeetle_tpu_torch import native
from tigerbeetle_tpu_torch.io.storage import Storage, Zone
from tigerbeetle_tpu_torch.lsm.cache import SetAssociativeCache
from tigerbeetle_tpu_torch.metrics import NULL_METRICS
from tigerbeetle_tpu_torch.vsr.free_set import FreeSet

BLOCK_SIZE = 128 * 1024  # reference: src/config.zig:140
_HEADER = 24  # checksum u128 + size u32 + reserved u32
BLOCK_PAYLOAD_MAX = BLOCK_SIZE - _HEADER


class GridBlockCorrupt(RuntimeError):
    """A block failed its embedded checksum/size validation. Carries the
    address so the VSR layer can repair it from peers instead of crashing
    (reference: src/vsr/grid.zig:731 read_block remote fallback +
    src/vsr/grid_blocks_missing.zig)."""

    def __init__(self, address: int, why: str):
        super().__init__(f"grid block {address}: {why}")
        self.address = address


class Grid:
    # observability seam (re-pointed by SpillManager.instrument / bench)
    metrics = NULL_METRICS

    def __init__(self, storage: Storage, offset: int, block_count: int,
                 cache_blocks: int = 256):
        """`offset`: byte offset within the grid zone where the block area
        starts (above the checkpoint snapshot areas)."""
        assert block_count % 64 == 0
        self.storage = storage
        self.offset = offset
        self.block_count = block_count
        self.free_set = FreeSet(block_count)
        # 16-way CLOCK block cache (reference: src/vsr/grid.zig set-
        # associative cache over 128 KiB blocks, src/config.zig:112)
        cap = max(16, (cache_blocks + 15) // 16 * 16)
        self.cache = SetAssociativeCache(cap)
        self.cache_blocks = cache_blocks
        # Released blocks stage here until the next checkpoint: the LAST
        # durable checkpoint's manifest may still reference them, so they
        # must not be reusable until a free set excluding them is encoded
        # (reference: src/vsr/superblock_free_set.zig — releases apply at
        # checkpoint, never mid-interval).
        self._staged_free: list[int] = []
        # Block IDENTITY registry: address -> expected payload checksum of
        # the block THIS replica wrote there. A block can carry a valid
        # self-checksum and still be the WRONG block for its address (a
        # peer whose layout diverged serving repair, a misdirected write) —
        # the registry is the parent-hash the reference gets from its
        # block-tree references (src/vsr/grid.zig block_id includes the
        # checksum). Consulted by read/verify/install; persisted at
        # checkpoint as a grid block chain (encode_chk_registry).
        self.block_chk: dict[int, int] = {}
        self._chk_chain: list[int] = []  # current registry chain blocks

    def _pos(self, address: int) -> int:
        assert 1 <= address <= self.block_count, address
        return self.offset + (address - 1) * BLOCK_SIZE

    # -- allocation --

    def acquire(self) -> int:
        r = self.free_set.reserve(1)
        if r is None:
            raise RuntimeError("grid full: no free blocks")
        address = self.free_set.acquire(r)
        self.free_set.forfeit(r)
        assert address is not None
        return address

    def release(self, address: int) -> None:
        """Stage the block for release at the NEXT checkpoint (see
        _staged_free) — crash-restore to the previous checkpoint must still
        find its contents intact."""
        assert 1 <= address <= self.block_count, address
        self._staged_free.append(address)
        self.cache.remove(address)

    # -- IO --

    def write_block(self, address: int, payload: bytes) -> None:
        assert len(payload) <= BLOCK_PAYLOAD_MAX, len(payload)
        chk = native.checksum(payload)
        head = (
            chk.to_bytes(16, "little")
            + len(payload).to_bytes(4, "little")
            + b"\x00" * 4
        )
        self.storage.write(Zone.grid, self._pos(address), head + payload)
        self.block_chk[address] = chk
        self._cache_put(address, payload)

    def create_block(self, payload: bytes) -> int:
        address = self.acquire()
        self.write_block(address, payload)
        return address

    @staticmethod
    def validate_raw(raw: bytes) -> bytes | None:
        """Parse + checksum-verify block wire bytes; the payload, or None
        if corrupt. The ONE implementation of the block header contract
        (all read/verify/install paths and state-sync installs use it)."""
        if len(raw) < _HEADER:
            return None
        size = int.from_bytes(raw[16:20], "little")
        if size > BLOCK_PAYLOAD_MAX or len(raw) < _HEADER + size:
            return None
        payload = raw[_HEADER : _HEADER + size]
        if native.checksum(payload) != int.from_bytes(raw[0:16], "little"):
            return None
        return payload

    def read_block(self, address: int) -> bytes:
        cached = self.cache.get(address)
        if cached is not None:
            return cached
        raw = self.storage.read(Zone.grid, self._pos(address), BLOCK_SIZE)
        self.metrics.counter("grid.block_reads").add()
        payload = self.validate_raw(raw)
        if payload is None:
            self.metrics.counter("grid.corrupt_blocks").add()
            raise GridBlockCorrupt(address, "bad checksum or size")
        exp = self.block_chk.get(address)
        if exp is not None and exp != int.from_bytes(raw[0:16], "little"):
            # self-consistent bytes but the WRONG block for this address
            self.metrics.counter("grid.corrupt_blocks").add()
            raise GridBlockCorrupt(address, "identity mismatch")
        self._cache_put(address, payload)
        return payload

    def verify_block(self, address: int) -> bool:
        """Verify a block in place (scrubbing; no cache effects): header
        self-checksum AND identity vs the registry. True = intact."""
        raw = self.storage.read(Zone.grid, self._pos(address), BLOCK_SIZE)
        if self.validate_raw(raw) is None:
            return False
        exp = self.block_chk.get(address)
        return exp is None or exp == int.from_bytes(raw[0:16], "little")

    def read_block_raw(self, address: int) -> bytes | None:
        """The block's verified on-disk bytes (header + payload), or None
        if corrupt — the repair-serving read (peers must not spread
        corruption)."""
        raw = self.storage.read(Zone.grid, self._pos(address), BLOCK_SIZE)
        size = int.from_bytes(raw[16:20], "little")
        if self.validate_raw(raw) is None:
            return None
        return raw[: _HEADER + size]

    def install_block_raw(self, address: int, raw: bytes) -> bool:
        """Install repaired block bytes at `address` — verified for BOTH
        self-consistency and identity (a diverged peer can serve bytes
        with a valid checksum that are the wrong block for this address;
        installing them would be silent corruption no later read could
        catch without the registry). Clears the cache entry so the next
        read sees the healed bytes."""
        if self.validate_raw(raw) is None:
            return False
        chk = int.from_bytes(raw[0:16], "little")
        exp = self.block_chk.get(address)
        if exp is not None and exp != chk:
            return False  # wrong-content repair: keep asking
        size = int.from_bytes(raw[16:20], "little")
        self.storage.write(Zone.grid, self._pos(address), raw[: _HEADER + size])
        if exp is None:
            # A block healed at an unregistered address gains identity
            # coverage NOW (and persists into the next checkpoint's
            # registry) — otherwise it would stay self-checksum-only and
            # be excluded from every future encode_chk_registry. Tradeoff:
            # with no registry entry there is nothing to verify content
            # AGAINST, so this pins the first-arriving valid bytes; a
            # diverged peer answering first wins the slot either way
            # (the old behavior also installed them, just unregistered) —
            # cross-replica state checks remain the backstop there.
            self.block_chk[address] = chk
        self.cache.remove(address)
        return True

    def _cache_put(self, address: int, payload: bytes) -> None:
        self.cache.put(address, payload)

    # -- checkpoint trailer --

    def encode_free_set(self) -> bytes:
        """Checkpoint trailer: apply staged releases, THEN encode — the new
        checkpoint's free set marks replaced blocks free (nothing in its
        manifests references them), and only once it is durable can they be
        reused. The caller must not create blocks between this call and the
        superblock write that records it."""
        for address in self._staged_free:
            self.free_set.release(address)
            self.block_chk.pop(address, None)
        self._staged_free.clear()
        return self.free_set.encode()

    def restore_free_set(self, data: bytes) -> None:
        self.free_set = FreeSet.decode(data, self.block_count)
        self._staged_free.clear()

    # -- the identity-registry chain (persisted alongside the free set;
    # the registry can exceed the superblock copy, so only the chain HEAD
    # (address + checksum) rides the checkpoint meta — the same trailer
    # pattern as the spill id-chain) --

    _CHK_ENTRY = 24  # addr u64 + checksum u128

    def encode_chk_registry(self) -> dict:
        """Write the registry into a fresh block chain (the old chain is
        released — staged, applied by the encode_free_set that MUST follow
        this call) and return the verified head pointer for the meta."""
        for address in self._chk_chain:
            self.release(address)
        # exclude staged frees: they leave block_chk at the encode that
        # follows, and persisting them would make a restarted replica's
        # registry (and therefore its chain layout and every later block
        # allocation) diverge from a peer that never restarted
        staged = set(self._staged_free)
        entries = sorted(
            (a, c) for a, c in self.block_chk.items() if a not in staged
        )
        per_block = (BLOCK_PAYLOAD_MAX - self._CHK_ENTRY) // self._CHK_ENTRY
        next_addr, next_chk = 0, 0
        chain: list[int] = []
        if entries:
            # written LAST chunk first so each block points at its successor
            last = ((len(entries) - 1) // per_block) * per_block
            for start in range(last, -1, -per_block):
                chunk = entries[start : start + per_block]
                payload = (
                    next_addr.to_bytes(8, "little")
                    + next_chk.to_bytes(16, "little")
                    + b"".join(
                        a.to_bytes(8, "little") + c.to_bytes(16, "little")
                        for a, c in chunk
                    )
                )
                next_addr = self.create_block(payload)
                next_chk = self.block_chk[next_addr]
                chain.append(next_addr)
        self._chk_chain = chain
        return {"addr": next_addr, "chk": f"{next_chk:x}"}

    def restore_chk_registry(self, head: dict | None) -> None:
        """Rebuild the registry by walking the chain from the verified
        head. A missing head (legacy checkpoint) leaves the registry empty
        — identity checks then degrade to self-checksum only. A CORRUPT
        chain block degrades the same way (empty registry + warning)
        instead of raising: this runs during local startup restore, where
        no peer-repair path exists yet — one latent sector error in the
        chain must not make restart unrecoverable. The registry is an
        extra verification layer over the self-checksums, never the data
        itself, so losing it costs coverage, not correctness."""
        self.block_chk = {}
        self._chk_chain = []
        if not head or not head.get("addr"):
            return
        addr = int(head["addr"])
        exp = int(head["chk"], 16)
        while addr:
            raw = self.storage.read(Zone.grid, self._pos(addr), BLOCK_SIZE)
            payload = self.validate_raw(raw)
            if payload is None or int.from_bytes(raw[0:16], "little") != exp:
                import sys

                sys.stderr.write(
                    f"warning: grid identity-registry chain corrupt at "
                    f"block {addr}; restoring with an EMPTY registry — "
                    "identity checks degrade to self-checksum only; "
                    "blocks regain registry coverage as they are "
                    "rewritten\n"
                )
                self.block_chk = {}
                self._chk_chain = []
                return
            self._chk_chain.append(addr)
            self.block_chk[addr] = exp
            next_addr = int.from_bytes(payload[0:8], "little")
            next_chk = int.from_bytes(payload[8:24], "little")
            for i in range(24, len(payload), self._CHK_ENTRY):
                a = int.from_bytes(payload[i : i + 8], "little")
                c = int.from_bytes(payload[i + 8 : i + 24], "little")
                self.block_chk[a] = c
            addr, exp = next_addr, next_chk
