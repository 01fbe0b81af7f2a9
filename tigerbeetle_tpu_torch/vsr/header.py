"""The 128-byte VSR Header — shared by network messages and journal entries.

Field-for-field the reference's wire layout (reference: src/vsr.zig:235-394:
checksum u128, checksum_body u128, parent u128, client u128, context u128,
request u32, cluster u32, epoch u32, view u32, op u64, commit u64,
timestamp u64, size u32, replica u8, command u8, operation u8, version u8 —
little-endian extern struct, no padding). The dual checksums let a header be
trusted without reading its body, and `parent` hash-chains prepares
(reference: src/vsr.zig:246-268).

Checksums are the native AEGIS-128L MAC (tigerbeetle_tpu_torch.native), identical
construction to the reference's vsr.checksum.

The port's copy of `tigerbeetle_tpu/vsr/header.py`, the same code with its imports
pointed at this package, so that its bytes on disk and on the wire are the
JAX package's.
"""

from __future__ import annotations

import dataclasses
import enum
import struct

import numpy as np

from tigerbeetle_tpu_torch import native
from tigerbeetle_tpu_torch.types import Operation

HEADER_SIZE = 128
VERSION = 0

# One struct pack/unpack per (de)serialization: the numpy-record path cost
# ~30 us per call and every message pays several (receive parse, checksum
# verify, send serialize) — at wire rate that is real event-loop time.
# u128 fields travel as (lo, hi) u64 pairs, same little-endian layout.
_WIRE = struct.Struct("<10Q4I3QI4B")
assert _WIRE.size == HEADER_SIZE
_U64 = 0xFFFFFFFFFFFFFFFF


def trace_id(client: int, request_checksum: int) -> int:
    """Cluster-causal trace id: a u64 derived DETERMINISTICALLY from
    (client id, request checksum) — the pair that uniquely names one
    client request cluster-wide — so every process that sees any leg of
    the op derives the SAME id with no coordination, and the simulator's
    traces stay byte-reproducible (no RNG, no wall clock).

    The carrier is the header's `context` field: the primary already
    stamps every prepare with context = the request's checksum (the
    reserved use of context on the prepare/reply path), so prepares,
    journal slots, replies and CDC records all carry enough to re-derive
    the id — the trace identity propagates with the consensus stream
    itself, costing zero extra wire bytes. splitmix64 finalizers over
    the folded u128s — the client mixes BEFORE the checksum folds in, so
    the derivation is not symmetric in its arguments: cheap, well-mixed,
    pure int math."""
    c = (client ^ (client >> 64)) & _U64
    s = (request_checksum ^ (request_checksum >> 64)) & _U64
    x = (c + 0x9E3779B97F4A7C15) & _U64
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9 & _U64
    x = (x ^ (x >> 27)) * 0x94D049BB133111EB & _U64
    x = (x ^ (x >> 31)) ^ s
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9 & _U64
    x = (x ^ (x >> 27)) * 0x94D049BB133111EB & _U64
    x ^= x >> 31
    # never 0: 0 is the "untraced" sentinel in span args
    return x or 1


class Command(enum.IntEnum):
    """VSR protocol commands (reference: src/vsr.zig:111-154)."""

    reserved = 0
    ping = 1
    pong = 2
    ping_client = 3
    pong_client = 4
    request = 5
    prepare = 6
    prepare_ok = 7
    reply = 8
    commit = 9
    start_view_change = 10
    do_view_change = 11
    start_view = 12
    request_start_view = 13
    request_headers = 14
    request_prepare = 15
    request_reply = 16
    headers = 17
    eviction = 18
    request_blocks = 19
    block = 20
    request_sync_manifest = 21
    request_sync_free_set = 22
    request_sync_client_sessions = 23
    sync_manifest = 24
    sync_free_set = 25
    sync_client_sessions = 26
    # Ingress extension (tigerbeetle_tpu/ingress): a typed load-shed
    # reply. The gateway answers a request it cannot admit (saturated
    # commit pipeline / exhausted message pool / session table full) with
    # `busy` echoing the client + request number — the client backs off
    # and retries, instead of timing out against a silent drop.
    busy = 27
    # Live introspection (`tigerbeetle inspect live`, inspect.py): a
    # request_stats frame asks a running replica for its [stats]-registry
    # snapshot + basic consensus state; the `stats` reply carries the
    # JSON body. Served in ANY status — the whole point is to look at a
    # replica that is wedged mid-view-change or mid-recovery.
    request_stats = 28
    stats = 29
    # Phase marker (scripts/prodday.py, inspect.send_mark): a `mark`
    # frame carries a phase name in its body; the replica stamps it into
    # its flight recorder so per-interval history slices by scenario
    # phase. Served in ANY status (a driver marks phases through faults)
    # and answered with a small `stats` ack so the driver knows the
    # boundary landed before offered load changes.
    mark = 30


# Vectorized view of the same layout (batch scans over header rings);
# cross-checked against _WIRE below so the two definitions cannot drift.
HEADER_DTYPE = np.dtype(
    [
        ("checksum_lo", "<u8"), ("checksum_hi", "<u8"),
        ("checksum_body_lo", "<u8"), ("checksum_body_hi", "<u8"),
        ("parent_lo", "<u8"), ("parent_hi", "<u8"),
        ("client_lo", "<u8"), ("client_hi", "<u8"),
        ("context_lo", "<u8"), ("context_hi", "<u8"),
        ("request", "<u4"),
        ("cluster", "<u4"),
        ("epoch", "<u4"),
        ("view", "<u4"),
        ("op", "<u8"),
        ("commit", "<u8"),
        ("timestamp", "<u8"),
        ("size", "<u4"),
        ("replica", "u1"),
        ("command", "u1"),
        ("operation", "u1"),
        ("version", "u1"),
    ]
)
assert HEADER_DTYPE.itemsize == HEADER_SIZE


@dataclasses.dataclass
class Header:
    checksum: int = 0
    checksum_body: int = 0
    parent: int = 0
    client: int = 0
    context: int = 0
    request: int = 0
    cluster: int = 0
    epoch: int = 0
    view: int = 0
    op: int = 0
    commit: int = 0
    timestamp: int = 0
    size: int = HEADER_SIZE
    replica: int = 0
    command: int = int(Command.reserved)
    operation: int = int(Operation.reserved)
    version: int = VERSION

    # -- wire --

    def to_bytes(self) -> bytes:
        return _WIRE.pack(
            self.checksum & _U64, self.checksum >> 64,
            self.checksum_body & _U64, self.checksum_body >> 64,
            self.parent & _U64, self.parent >> 64,
            self.client & _U64, self.client >> 64,
            self.context & _U64, self.context >> 64,
            self.request, self.cluster, self.epoch, self.view,
            self.op, self.commit, self.timestamp,
            self.size, self.replica, self.command, self.operation,
            self.version,
        )

    @staticmethod
    def from_bytes(b) -> "Header":
        assert len(b) == HEADER_SIZE, len(b)
        v = _WIRE.unpack(b)
        return Header(
            checksum=v[0] | (v[1] << 64),
            checksum_body=v[2] | (v[3] << 64),
            parent=v[4] | (v[5] << 64),
            client=v[6] | (v[7] << 64),
            context=v[8] | (v[9] << 64),
            request=v[10], cluster=v[11], epoch=v[12], view=v[13],
            op=v[14], commit=v[15], timestamp=v[16],
            size=v[17], replica=v[18], command=v[19], operation=v[20],
            version=v[21],
        )

    # -- tracing --

    def trace(self) -> int:
        """The op's cluster-causal trace id, derived from the fields THIS
        header carries: a request hashes its own checksum (ingress — the
        id is assigned here); prepares and replies carry the request
        checksum in `context` (see trace_id). Only meaningful for
        request/prepare/reply-shaped headers."""
        if self.command == int(Command.request):
            return trace_id(self.client, self.checksum)
        return trace_id(self.client, self.context)

    # -- checksums (reference: src/vsr.zig:428-442 set/valid pattern) --

    def calculate_checksum(self) -> int:
        """Checksum over the header bytes EXCLUDING the leading checksum
        field itself."""
        return native.checksum(self.to_bytes()[16:])

    def set_checksum_body(self, body: bytes) -> None:
        self.size = HEADER_SIZE + len(body)
        self.checksum_body = native.checksum(body)

    def set_checksum(self) -> None:
        self.checksum = self.calculate_checksum()

    def valid_checksum(self) -> bool:
        return self.checksum == self.calculate_checksum()

    def valid_checksum_body(self, body: bytes) -> bool:
        return self.checksum_body == native.checksum(body)


# _WIRE and HEADER_DTYPE define the same 128-byte layout twice (struct for
# scalar speed, dtype for vectorized ring scans): pin them together so an
# edit to one cannot silently drift from the other.
_probe = np.frombuffer(
    Header(
        checksum=(1 << 64) | 2, checksum_body=3, parent=4, client=5,
        context=6, request=7, cluster=8, epoch=9, view=10, op=11, commit=12,
        timestamp=13, size=14, replica=15, command=16, operation=17,
        version=18,
    ).to_bytes(),
    dtype=HEADER_DTYPE,
)[0]
assert (
    (int(_probe["checksum_lo"]), int(_probe["checksum_hi"])) == (2, 1)
    and int(_probe["checksum_body_lo"]) == 3
    and int(_probe["context_lo"]) == 6
    and int(_probe["request"]) == 7
    and int(_probe["view"]) == 10
    and int(_probe["op"]) == 11
    and int(_probe["timestamp"]) == 13
    and int(_probe["size"]) == 14
    and int(_probe["replica"]) == 15
    and int(_probe["command"]) == 16
    and int(_probe["version"]) == 18
), "Header _WIRE struct and HEADER_DTYPE layouts diverged"
del _probe
