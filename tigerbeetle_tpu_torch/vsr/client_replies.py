"""ClientReplies: the latest reply per client, persisted in the dedicated
client_replies zone.

The reference stores one message-sized slot per client session
(reference: src/vsr/client_replies.zig; zone sizing clients_max x
message_size_max, src/vsr.zig:59-108), so a primary can answer a
duplicate request with the ORIGINAL reply bytes even after a restart —
without it, a retransmit arriving after recovery would have to be dropped
(re-executing is forbidden: exactly-once semantics).

A slot is validated on read against the reply checksum recorded in the
checkpointed client table: a torn write, a stale slot from an evicted
session, or bytes predating a state sync all fail the match and read as
absent (the caller falls back to its reply-lost path; the reference
additionally repairs reply slots from peers).

The port's copy of `tigerbeetle_tpu/vsr/client_replies.py`, the same code with its imports
pointed at this package, so that its bytes on disk and on the wire are the
JAX package's.
"""

from __future__ import annotations

from tigerbeetle_tpu_torch.constants import ConfigCluster
from tigerbeetle_tpu_torch.io.storage import Storage, Zone
from tigerbeetle_tpu_torch.vsr.header import HEADER_SIZE, Command, Header


class ClientReplies:
    def __init__(self, storage: Storage, cluster: ConfigCluster):
        self.storage = storage
        self.slot_size = cluster.message_size_max
        # reply_slot_count, not clients_max: the ingress gateway's
        # many-session mode raises clients_max far past what a
        # slot-per-session zone could hold (constants.ConfigCluster)
        self.slot_count = cluster.reply_slot_count

    def write(self, slot: int, wire: bytes) -> None:
        """Best-effort persistence (write_lazy): a reply lost to a crash
        before the next sync reads as absent (checksum mismatch) and the
        reply-lost fallbacks apply; the checkpoint chain syncs before
        persisting the client table, so a checkpointed reply_checksum
        always has durable bytes behind it."""
        assert 0 <= slot < self.slot_count
        assert len(wire) <= self.slot_size
        self.storage.write_lazy(Zone.client_replies, slot * self.slot_size, wire)

    def read(self, slot: int, checksum: int) -> bytes | None:
        """The slot's reply wire bytes iff intact and matching `checksum`
        (the client table's record of which reply should be there)."""
        assert 0 <= slot < self.slot_count
        raw = self.storage.read(
            Zone.client_replies, slot * self.slot_size, self.slot_size
        )
        header = Header.from_bytes(raw[:HEADER_SIZE])
        if (
            not header.valid_checksum()
            or header.checksum != checksum
            or header.command != Command.reply
            or header.size > self.slot_size
        ):
            return None
        body = raw[HEADER_SIZE : header.size]
        if not header.valid_checksum_body(body):
            return None
        return raw[: header.size]
