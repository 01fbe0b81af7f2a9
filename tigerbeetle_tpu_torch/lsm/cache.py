"""Set-associative cache with CLOCK Nth-chance eviction.

The analog of the reference's SetAssociativeCache (reference:
src/lsm/set_associative_cache.zig:15-22 Layout — 16 ways per set,
cache-line-packed metadata, CLOCK Nth-chance): fixed capacity, O(ways)
lookup, no per-entry allocation. Used as the grid block cache (the
reference uses it for the grid cache and the object cache; here the object
cache is the device tables' residency itself).

A key hashes to ONE set of `ways` slots. On hit, the slot's clock count
resets to 0. On insert into a full set, the clock hand sweeps the set
incrementing each slot's count until one exceeds `clock_bits` chances —
that slot is evicted (recently-hit slots survive longer).

The port's copy of `tigerbeetle_tpu/lsm/cache.py`, the same code with its imports
pointed at this package (the port imports nothing of the JAX package), so
that the port writes the same grid bytes.
"""

from __future__ import annotations

WAYS = 16  # reference: src/lsm/set_associative_cache.zig Layout.ways
CLOCK_CHANCES = 2  # Nth-chance: evict after N sweeps without a hit


class SetAssociativeCache:
    def __init__(self, capacity: int, ways: int = WAYS):
        assert capacity >= ways and capacity % ways == 0
        self.ways = ways
        self.sets = capacity // ways
        n = capacity
        self.keys: list[int | None] = [None] * n
        self.values: list[object] = [None] * n
        self.counts = bytearray(n)  # clock counts
        self.hands = bytearray(self.sets)  # per-set clock hand (way index)
        self.hits = 0
        self.misses = 0

    def _set_base(self, key: int) -> int:
        # splitmix-style finalizer — keys are block addresses (sequential),
        # so they must be scrambled across sets
        x = (key * 0x9E3779B97F4A7C15) & ((1 << 64) - 1)
        x ^= x >> 31
        return (x % self.sets) * self.ways

    def get(self, key: int):
        base = self._set_base(key)
        for i in range(base, base + self.ways):
            if self.keys[i] == key:
                self.counts[i] = 0  # touched: reset chances
                self.hits += 1
                return self.values[i]
        self.misses += 1
        return None

    def put(self, key: int, value) -> None:
        base = self._set_base(key)
        free = None
        for i in range(base, base + self.ways):
            if self.keys[i] == key:
                self.values[i] = value
                self.counts[i] = 0
                return
            if free is None and self.keys[i] is None:
                free = i
        if free is not None:
            self.keys[free] = key
            self.values[free] = value
            self.counts[free] = 0
            return
        # CLOCK Nth-chance sweep from the set's hand
        set_idx = base // self.ways
        hand = self.hands[set_idx]
        while True:
            i = base + hand
            hand = (hand + 1) % self.ways
            if self.counts[i] >= CLOCK_CHANCES:
                self.keys[i] = key
                self.values[i] = value
                self.counts[i] = 0
                self.hands[set_idx] = hand
                return
            self.counts[i] += 1

    def remove(self, key: int) -> None:
        base = self._set_base(key)
        for i in range(base, base + self.ways):
            if self.keys[i] == key:
                self.keys[i] = None
                self.values[i] = None
                self.counts[i] = 0
                return

    def clear(self) -> None:
        n = len(self.keys)
        self.keys = [None] * n
        self.values = [None] * n
        self.counts = bytearray(n)
        self.hands = bytearray(self.sets)

    def __contains__(self, key: int) -> bool:
        base = self._set_base(key)
        return any(self.keys[i] == key for i in range(base, base + self.ways))
