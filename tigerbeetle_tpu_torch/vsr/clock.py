"""Fault-tolerant cluster clock: Marzullo's algorithm over ping offsets.

The reference's design (reference: src/vsr/clock.zig:15-70,
src/vsr/marzullo.zig): each replica samples its clock offset against every
peer from ping/pong round trips — the peer's realtime was read somewhere
within the round trip, so the true offset lies in an interval
[t1 - m2, t1 - m0] (m0/m2 = own monotonic at send/receive, t1 = peer's
realtime). Marzullo's algorithm finds the smallest interval overlapping a
majority of sources (self included as [0,0]); its midpoint bounds the
cluster-synchronized wall time. `realtime_synchronized()` gates timestamp
assignment on having such a quorum window (reference:
src/vsr/replica.zig:1220-1223).

The port's copy of `tigerbeetle_tpu/vsr/clock.py`, the same code with its imports
pointed at this package.
"""

from __future__ import annotations

import dataclasses

from tigerbeetle_tpu_torch.io.time import Time


@dataclasses.dataclass
class Interval:
    lo: int
    hi: int
    sources: int = 0


def marzullo(intervals: list[tuple[int, int]], quorum: int) -> Interval | None:
    """Smallest interval contained in at least `quorum` of the input
    intervals (reference: src/vsr/marzullo.zig smallest_interval). Returns
    None if no point is covered by a quorum."""
    if not intervals:
        return None
    edges: list[tuple[int, int]] = []  # (offset, +1 open / -1 close)
    for lo, hi in intervals:
        assert lo <= hi
        edges.append((lo, -1))
        edges.append((hi, +1))
    # Sort by offset; opens (-1) before closes (+1) at the same offset.
    edges.sort()
    best: Interval | None = None
    count = 0
    lo = None
    for offset, kind in edges:
        if kind == -1:
            count += 1
            if count >= quorum and (best is None or count > best.sources):
                lo = offset
                best = Interval(lo=offset, hi=offset, sources=count)
        else:
            if best is not None and best.sources == count and lo is not None:
                best.hi = offset
                lo = None
            count -= 1
    if best is None or best.sources < quorum:
        return None
    return best


class Clock:
    """Per-replica clock state; fed by the replica's ping/pong traffic.
    Samples expire (the reference re-samples in windowed epochs, reference:
    src/vsr/clock.zig epoch handling) so a long-dead peer's stale offset
    cannot keep steering the synchronized time."""

    def __init__(self, replica: int, replica_count: int, time: Time,
                 sample_age_max_ns: int = 10_000_000_000):
        self.replica = replica
        self.replica_count = replica_count
        self.time = time
        self.sample_age_max_ns = sample_age_max_ns
        # Freshest offset interval per peer + the monotonic time it was
        # taken (self is implicit [0, 0], never stale).
        self.samples: dict[int, tuple[int, int, int]] = {}

    @property
    def quorum(self) -> int:
        return self.replica_count // 2 + 1

    # -- sampling (driven by the replica's pong handler) --

    def learn(self, peer: int, m0: int, t1: int, m2: int) -> None:
        """A pong round trip: own monotonic m0 at ping send, peer realtime
        t1, own monotonic m2 at pong receive."""
        if peer == self.replica or m2 < m0:
            return  # m2 == m0 is a zero-width (exact) interval — valid
        # The peer read t1 somewhere in [m0, m2]: offset in [t1-m2, t1-m0],
        # expressed relative to our realtime at the midpoint.
        own_realtime = self.time.realtime()
        own_monotonic = self.time.monotonic()
        # Project both bounds to "peer_realtime - own_realtime" offsets.
        base = own_realtime - own_monotonic
        self.samples[peer] = (t1 - (base + m2), t1 - (base + m0), own_monotonic)

    def _window(self) -> Interval | None:
        now = self.time.monotonic()
        fresh = [
            (lo, hi)
            for lo, hi, taken in self.samples.values()
            if now - taken <= self.sample_age_max_ns
        ]
        return marzullo([(0, 0)] + fresh, self.quorum)

    # -- reading --

    def realtime(self) -> int:
        return self.time.realtime()

    def realtime_synchronized(self) -> int | None:
        """Cluster-synchronized wall time, or None when no quorum of FRESH
        samples exists (timestamp assignment must wait)."""
        window = self._window()
        if window is None:
            return None
        midpoint = (window.lo + window.hi) // 2
        return self.time.realtime() + midpoint
