"""The Time seam.

The reference injects Time as a comptime parameter so the simulator can run
the whole cluster on virtual ticks (reference: src/testing/time.zig;
composition src/tigerbeetle/main.zig:26-33). Same seam here: production
uses the OS clocks; tests/simulator use DeterministicTime advanced by the
event loop.

The port's copy of `tigerbeetle_tpu/io/time.py`, the same code with its imports
pointed at this package.
"""

from __future__ import annotations

import time as _time


class Time:
    def monotonic(self) -> int:
        """Monotonic nanoseconds (never goes backwards)."""
        raise NotImplementedError

    def realtime(self) -> int:
        """Wall-clock nanoseconds since epoch (may step)."""
        raise NotImplementedError

    def tick(self) -> None:
        """Advance one tick (no-op on real time)."""


class RealTime(Time):
    def monotonic(self) -> int:
        return _time.monotonic_ns()

    def realtime(self) -> int:
        return _time.time_ns()


class DeterministicTime(Time):
    """Virtual clock: one tick = tick_ns monotonic; realtime = epoch +
    monotonic + a fixed offset (per-replica offsets model clock skew,
    reference: src/testing/time.zig OffsetType)."""

    def __init__(self, tick_ns: int = 10_000_000, epoch: int = 1_600_000_000_000_000_000,
                 offset_ns: int = 0):
        self.tick_ns = tick_ns
        self.epoch = epoch
        self.offset_ns = offset_ns
        self.ticks = 0

    def monotonic(self) -> int:
        return self.ticks * self.tick_ns

    def realtime(self) -> int:
        return self.epoch + self.monotonic() + self.offset_ns

    def tick(self) -> None:
        self.ticks += 1
