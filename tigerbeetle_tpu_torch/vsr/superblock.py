"""The SuperBlock: the durable VSR root, 4 redundant copies with quorum.

The reference's design (reference: src/vsr/superblock.zig:1-34): the
superblock records the durable `vsr_state` — checkpoint op (commit_min),
its checksum, view numbers — plus references to the checkpoint's trailers.
Here the trailers are the device-ledger snapshot blobs living in the grid
zone (ping-ponged by sequence parity so the previous checkpoint stays
intact while the next one writes — the reference's copy-on-write manifest
serves the same purpose).

4 copies are written per checkpoint (reference: superblock_copies=4,
src/config.zig:138); opening requires a quorum of >= 2 valid copies of the
winning sequence (reference: src/vsr/superblock_quorums.zig), so a crash
torn mid-update (some copies new, some old) resolves to whichever sequence
has quorum — and because copies are written new-sequence-last-synced-first,
at least one complete set survives.

The port's copy of `tigerbeetle_tpu/vsr/superblock.py`, the same code with its imports
pointed at this package, so that its bytes on disk and on the wire are the
JAX package's.
"""

from __future__ import annotations

import dataclasses
import json

from tigerbeetle_tpu_torch import native
from tigerbeetle_tpu_torch.io.storage import Storage, Zone, ZoneLayout

MAGIC = 0x7475_5F74_6267_6C62  # "tbgl_tpu" as a tag
QUORUM = 2


@dataclasses.dataclass
class BlobRef:
    """A checkpoint trailer blob in the grid zone."""

    name: str
    offset: int  # grid-zone logical offset
    size: int
    checksum: int


@dataclasses.dataclass
class VSRState:
    """Durable consensus + checkpoint state (reference:
    src/vsr/superblock.zig vsr_state)."""

    cluster: int = 0
    replica: int = 0
    sequence: int = 0  # superblock version counter
    commit_min: int = 0  # checkpoint op: state <= this op is in the snapshot
    commit_min_checksum: int = 0  # hash-chain anchor for replay
    commit_max: int = 0
    view: int = 0
    log_view: int = 0
    prepare_timestamp: int = 0
    area: int = 0  # grid area holding `blobs` (explicit ping-pong side)
    blobs: list[BlobRef] = dataclasses.field(default_factory=list)
    meta: dict = dataclasses.field(default_factory=dict)  # small host state

    def to_bytes(self) -> bytes:
        d = dataclasses.asdict(self)
        return json.dumps(d, sort_keys=True).encode()

    @staticmethod
    def from_bytes(b: bytes) -> "VSRState":
        d = json.loads(b.decode())
        d["blobs"] = [BlobRef(**x) for x in d["blobs"]]
        return VSRState(**d)


class SuperBlock:
    """Serialized copy layout (one per 64 KiB copy slot):
    [0:8)   magic
    [8:16)  payload length
    [16:32) payload checksum (AEGIS-128L)
    [32:..) payload (VSRState bytes)
    """

    def __init__(self, storage: Storage):
        self.storage = storage
        self.layout = storage.layout
        self.state: VSRState | None = None

    def _copy_bytes(self, state: VSRState) -> bytes:
        payload = state.to_bytes()
        assert len(payload) + 32 <= ZoneLayout.SUPERBLOCK_COPY_SIZE, (
            "superblock payload overflow"
        )
        head = (
            MAGIC.to_bytes(8, "little")
            + len(payload).to_bytes(8, "little")
            + native.checksum(payload).to_bytes(16, "little")
        )
        return head + payload

    def checkpoint(self, state: VSRState) -> None:
        """Durably advance to `state` (sequence must increase)."""
        if self.state is not None:
            assert state.sequence > self.state.sequence
        blob = self._copy_bytes(state)
        for copy in range(ZoneLayout.SUPERBLOCK_COPIES):
            self.storage.write(
                Zone.superblock, copy * ZoneLayout.SUPERBLOCK_COPY_SIZE, blob
            )
            # Sync after the FIRST copy so at least one complete new copy is
            # durable before the rest overwrite old ones, and after the last.
            if copy in (0, ZoneLayout.SUPERBLOCK_COPIES - 1):
                self.storage.sync()
        self.state = state

    @staticmethod
    def decode_copy(raw: bytes) -> tuple[VSRState | None, str]:
        """Decode ONE copy's raw bytes -> (state, verdict). The single
        implementation of the copy wire format, shared by the quorum
        open and `tigerbeetle inspect superblock` (which reports every
        copy's verdict instead of silently skipping the bad ones)."""
        if int.from_bytes(raw[0:8], "little") != MAGIC:
            return None, "bad magic"
        length = int.from_bytes(raw[8:16], "little")
        if length + 32 > len(raw):
            return None, "length overflows the copy"
        want = int.from_bytes(raw[16:32], "little")
        payload = raw[32 : 32 + length]
        if native.checksum(payload) != want:
            return None, "payload checksum mismatch"
        return VSRState.from_bytes(payload), "valid"

    @staticmethod
    def quorum_winner(
        states: list[VSRState | None],
    ) -> tuple[VSRState | None, int]:
        """The quorum rule in ONE place (shared with `tigerbeetle
        inspect`, which must report the same winner the replica would
        open): (winning state, number of copies carrying it), or
        (None, 0) when no sequence reaches QUORUM valid copies."""
        by_seq: dict[int, int] = {}
        by_state: dict[int, VSRState] = {}
        for st in states:
            if st is None:
                continue
            by_seq[st.sequence] = by_seq.get(st.sequence, 0) + 1
            by_state[st.sequence] = st
        quorate = [s for s, n in by_seq.items() if n >= QUORUM]
        if not quorate:
            return None, 0
        winner = max(quorate)
        return by_state[winner], by_seq[winner]

    def open(self) -> VSRState:
        """Quorum read: the highest sequence with >= QUORUM valid copies."""
        decoded = [
            self.decode_copy(self.storage.read(
                Zone.superblock,
                copy * ZoneLayout.SUPERBLOCK_COPY_SIZE,
                ZoneLayout.SUPERBLOCK_COPY_SIZE,
            ))[0]
            for copy in range(ZoneLayout.SUPERBLOCK_COPIES)
        ]
        state, _copies = self.quorum_winner(decoded)
        if state is None:
            raise RuntimeError(
                "superblock: no sequence with a quorum of valid copies "
                "— data file corrupt or not formatted"
            )
        self.state = state
        return self.state
