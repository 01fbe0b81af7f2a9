"""Durable per-consumer cursor: the at-least-once bookmark.

A consumer's cursor records the highest op whose records the sink has
accepted, plus that prepare's checksum. On resume the pump restarts at
`op + 1`; anything delivered after the last ack is REDELIVERED, and the
`(op, checksum)` pair is what makes redelivery dedupable (apply only ops
above the cursor; the checksum detects a timeline that forked under the
consumer, which committed history never does — so a mismatch is loud).

Durability is superblock-style (reference: src/vsr/superblock.zig's
checksummed, atomically-replaced state): the payload is canonical JSON
with an embedded AEGIS checksum, written to a temp file, fsynced, then
`os.replace`d over the cursor path, then the directory fsynced. A crash
at any point leaves either the old cursor or the new one — a torn or
corrupt file fails its checksum and reads as absent (op 0: replay from
the start, which at-least-once permits).
"""

from __future__ import annotations

import json
import os
import sys

from tigerbeetle_tpu_torch import native


def _encode(op: int, checksum: int) -> bytes:
    payload = {"op": op, "checksum": f"{checksum:032x}"}
    body = json.dumps(payload, sort_keys=True, separators=(",", ":"))
    crc = native.checksum(body.encode())
    return json.dumps(
        {"body": payload, "crc": f"{crc:032x}"},
        sort_keys=True, separators=(",", ":"),
    ).encode() + b"\n"


def _decode(raw: bytes) -> tuple[int, int] | None:
    try:
        outer = json.loads(raw)
        body = outer["body"]
        canon = json.dumps(body, sort_keys=True, separators=(",", ":"))
        if f"{native.checksum(canon.encode()):032x}" != outer["crc"]:
            return None
        return int(body["op"]), int(body["checksum"], 16)
    except (ValueError, KeyError, TypeError):
        return None


class FileCursor:
    """Atomic write-rename cursor file."""

    def __init__(self, path: str):
        self.path = path

    def load(self) -> tuple[int, int]:
        """(op, checksum); (0, 0) when absent or corrupt (corruption
        warns: replaying from scratch is safe but worth an operator's
        attention)."""
        try:
            with open(self.path, "rb") as f:
                raw = f.read()
        except FileNotFoundError:
            return (0, 0)
        got = _decode(raw)
        if got is None:
            sys.stderr.write(
                f"cdc: cursor {self.path} corrupt; restarting stream "
                "from op 0 (at-least-once: consumers dedup by op)\n"
            )
            return (0, 0)
        return got

    def ack(self, op: int, checksum: int) -> None:
        tmp = self.path + ".tmp"
        data = _encode(op, checksum)
        fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
        try:
            os.write(fd, data)
            os.fsync(fd)
        finally:
            os.close(fd)
        os.replace(tmp, self.path)
        dfd = os.open(os.path.dirname(self.path) or ".", os.O_RDONLY)
        try:
            os.fsync(dfd)  # the rename itself must be durable
        finally:
            os.close(dfd)


class MemoryCursor:
    """Same interface, process-local: the simulator's "durable" consumer
    state (survives consumer crash/restart inside one simulated run) and
    unit tests."""

    def __init__(self):
        self.op = 0
        self.checksum = 0

    def load(self) -> tuple[int, int]:
        return (self.op, self.checksum)

    def ack(self, op: int, checksum: int) -> None:
        self.op = op
        self.checksum = checksum
