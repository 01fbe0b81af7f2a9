"""Append-only file: out-of-band disaster-recovery log.

The reference's AOF (reference: src/aof.zig:23-70): every committed prepare
is appended — sector-aligned records with a magic + header + body — BEFORE
the reply is sent (hooked at src/vsr/replica.zig:3643-3648), so even a
total loss of the data file can be replayed into a fresh cluster.

Record layout: [magic u64][size u64][header 128B][body][zero pad to 4KiB].
The header's own dual checksums authenticate the record; a torn tail record
simply fails validation and ends the replay.

The port's copy of `tigerbeetle_tpu/aof.py`, the same code over the port's
`vsr/header.py`: a log written by either package replays in the other.
"""

from __future__ import annotations

import os
import sys

from tigerbeetle_tpu_torch.vsr.header import HEADER_SIZE, Command, Header

MAGIC = 0x6165_675F_746F_6265  # record marker
SECTOR = 4096


class AOF:
    def __init__(self, path: str):
        self.path = path
        self.fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND | os.O_DSYNC,
                          0o644)

    def append(self, header: Header, body: bytes) -> None:
        assert header.command == Command.prepare
        assert header.size == HEADER_SIZE + len(body)
        record = (
            MAGIC.to_bytes(8, "little")
            + header.size.to_bytes(8, "little")
            + header.to_bytes()
            + body
        )
        pad = (-len(record)) % SECTOR
        data = record + b"\x00" * pad
        done = 0
        while done < len(data):  # short writes would tear the record AND
            done += os.write(self.fd, data[done:])  # misalign every later one

    def close(self) -> None:
        if self.fd >= 0:
            os.close(self.fd)
            self.fd = -1


def replay(path: str):
    """Yield (header, body) for every valid record, stopping at the last
    intact one (reference: AOF replay tool, src/aof.zig).

    A crash mid-append leaves a torn tail: a partial magic/size prefix, a
    header cut short, a body cut short, or intact bytes whose checksums
    no longer authenticate. Every such shape STOPS the replay at the last
    valid record — never raises — and leaves one warning on stderr (the
    operator should know the log ends in a tear rather than cleanly; the
    replayed prefix is still the complete durable history, because the
    torn record's reply can never have left the replica: the AOF append
    completes before the reply is sent)."""
    with open(path, "rb") as f:
        data = f.read()
    off = 0
    while off + 16 + HEADER_SIZE <= len(data):
        if int.from_bytes(data[off : off + 8], "little") != MAGIC:
            break
        size = int.from_bytes(data[off + 8 : off + 16], "little")
        if size < HEADER_SIZE or off + 16 + size > len(data):
            break
        header = Header.from_bytes(data[off + 16 : off + 16 + HEADER_SIZE])
        body = data[off + 16 + HEADER_SIZE : off + 16 + size]
        if not header.valid_checksum() or not header.valid_checksum_body(body):
            break
        yield header, body
        off += 16 + size
        off += (-off) % SECTOR
    if off < len(data):
        sys.stderr.write(
            f"aof: {path}: torn/corrupt tail record at offset {off} "
            f"({len(data) - off} trailing bytes ignored); replay stops "
            "at the last valid record\n"
        )
