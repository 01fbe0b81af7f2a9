"""Grid block allocator: a bitset free set with reservations and an EWAH
trailer encoding (reference: src/vsr/superblock_free_set.zig:14-23
Reservations, :10 EWAH trailer encoding). The grid block store that will
persist this trailer through the superblock is not built yet — encode()/
decode() are its wire format.

Blocks are addressed 1..block_count (address 0 is reserved/null, like the
reference). A Reservation pins a range of potentially-free blocks so that
concurrent compactions can acquire from disjoint windows deterministically;
outstanding reservations exclude their windows from later reserve() scans.

The port's copy of `tigerbeetle_tpu/vsr/free_set.py`, the same code with its imports
pointed at this package (the port imports nothing of the JAX package), so
that the port writes the same grid bytes.
"""

from __future__ import annotations

import dataclasses

from tigerbeetle_tpu_torch.stdx import ewah_decode, ewah_encode

_WORD = 64


@dataclasses.dataclass
class Reservation:
    block_base: int  # first block index (0-based) of the window
    block_count: int
    session: int


class FreeSet:
    def __init__(self, block_count: int):
        assert block_count % _WORD == 0
        self.block_count = block_count
        # bit SET = block free (index 0 = address 1)
        self.words = [(1 << _WORD) - 1] * (block_count // _WORD)
        self.reservation_count = 0
        self.reservation_session = 1
        self._reserved_hi = 0  # blocks below this are in a live reservation

    # -- bit helpers --

    def is_free(self, address: int) -> bool:
        i = address - 1
        return bool(self.words[i // _WORD] >> (i % _WORD) & 1)

    def _set(self, i: int, free: bool) -> None:
        if free:
            self.words[i // _WORD] |= 1 << (i % _WORD)
        else:
            self.words[i // _WORD] &= ~(1 << (i % _WORD))

    def count_free(self) -> int:
        return sum(bin(w).count("1") for w in self.words)

    # -- reservations (reference: reserve/forfeit discipline) --

    def reserve(self, count: int) -> Reservation | None:
        """Reserve a window containing >= count free blocks. The scan starts
        past every outstanding reservation's window, so concurrent holders
        get DISJOINT windows (the contract concurrent compactions rely on;
        reference: superblock_free_set.zig reservation discipline)."""
        free_seen = 0
        base = None
        for i in range(self._reserved_hi, self.block_count):
            if self.words[i // _WORD] >> (i % _WORD) & 1:
                if base is None:
                    base = i
                free_seen += 1
                if free_seen == count:
                    self.reservation_count += 1
                    self._reserved_hi = i + 1
                    return Reservation(
                        block_base=base, block_count=i - base + 1,
                        session=self.reservation_session,
                    )
        return None

    def forfeit(self, reservation: Reservation) -> None:
        assert reservation.session == self.reservation_session
        self.reservation_count -= 1
        if self.reservation_count == 0:
            self.reservation_session += 1  # stale reservations now assert
            self._reserved_hi = 0

    def acquire(self, reservation: Reservation) -> int | None:
        """First free block within the reservation window -> address."""
        assert reservation.session == self.reservation_session
        for i in range(
            reservation.block_base,
            reservation.block_base + reservation.block_count,
        ):
            if self.words[i // _WORD] >> (i % _WORD) & 1:
                self._set(i, False)
                return i + 1
        return None

    def release(self, address: int) -> None:
        i = address - 1
        assert not self.is_free(address), f"double free of block {address}"
        self._set(i, True)

    # -- superblock trailer encoding --

    def encode(self) -> bytes:
        return ewah_encode(self.words)

    @classmethod
    def decode(cls, data: bytes, block_count: int) -> "FreeSet":
        fs = cls(block_count)
        fs.words = ewah_decode(data, block_count // _WORD)
        return fs
