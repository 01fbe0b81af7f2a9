"""The Network seam: message transport between replicas and clients.

The reference's MessageBus is a TCP mesh in production and a virtual
PacketSimulator under test, swapped at the same interface (reference:
src/message_bus.zig:21-22 vs src/testing/cluster/network.zig). Same seam
here: `Network.send(src, dst, data)` with delivery via registered handlers.

Addresses: replicas are ints 0..n-1; clients are their u128 client ids.
Messages are REAL wire bytes (128-byte Header + body) — everything crossing
this seam would survive a socket.

InProcessNetwork is the deterministic scripted transport (cluster tests):
messages queue in send order and `step()`/`run()` pump them one at a time;
`filters` may drop or hold messages (partitions, drops — the LinkFilter
analog, reference: src/vsr/replica_test.zig scripted networks).

The port's copy of `tigerbeetle_tpu/io/network.py`, the same code with its imports
pointed at this package.
"""

from __future__ import annotations

from collections import deque
from typing import Callable

Address = int  # replica index (< 2^32) or client id (u128)
Handler = Callable[[Address, bytes], None]
Filter = Callable[[Address, Address, bytes], bool]  # True = deliver


class Network:
    def attach(self, addr: Address, handler: Handler) -> None:
        raise NotImplementedError

    def send(self, src: Address, dst: Address, data: bytes) -> None:
        raise NotImplementedError


class InProcessNetwork(Network):
    def __init__(self):
        self.handlers: dict[Address, Handler] = {}
        self.queue: deque[tuple[Address, Address, bytes]] = deque()
        self.filters: list[Filter] = []
        self.delivered = 0
        self.dropped = 0

    def attach(self, addr: Address, handler: Handler) -> None:
        self.handlers[addr] = handler

    def send(self, src: Address, dst: Address, data: bytes) -> None:
        self.queue.append((src, dst, bytes(data)))

    # -- pumping --

    def step(self) -> bool:
        """Deliver one queued message (or drop it per filters). Returns
        False when the queue is empty."""
        if not self.queue:
            return False
        src, dst, data = self.queue.popleft()
        for f in self.filters:
            if not f(src, dst, data):
                self.dropped += 1
                return True
        handler = self.handlers.get(dst)
        if handler is None:
            self.dropped += 1
            return True
        self.delivered += 1
        handler(src, data)
        return True

    def run(self, limit: int = 100_000) -> int:
        """Pump until quiescent. Returns messages processed."""
        n = 0
        while self.step():
            n += 1
            if n >= limit:
                raise RuntimeError("network did not quiesce (livelock?)")
        return n


class LinkControl:
    """Scripted, fully deterministic link faults over InProcessNetwork
    (the client-runtime tests' fault dial): drop or HOLD messages
    matching a (src, dst) pattern — held messages are captured in order
    and re-injected by release(), modeling a delayed/duplicated delivery
    with an exact interleaving (no randomness; the seeded chaos lives in
    PacketSimulator)."""

    def __init__(self, network: InProcessNetwork):
        self.network = network
        self.rules: list[dict] = []
        self.held: list[tuple[Address, Address, bytes]] = []
        network.filters.append(self._filter)

    def _match(self, rule: dict, src: Address, dst: Address) -> bool:
        return (
            (rule["src"] is None or rule["src"] == src)
            and (rule["dst"] is None or rule["dst"] == dst)
        )

    def _filter(self, src: Address, dst: Address, data: bytes) -> bool:
        for rule in self.rules:
            if rule["remaining"] == 0 or not self._match(rule, src, dst):
                continue
            if rule["remaining"] > 0:
                rule["remaining"] -= 1
            if rule["mode"] == "hold":
                self.held.append((src, dst, data))
            return False
        return True

    def drop(self, src: Address | None = None, dst: Address | None = None,
             count: int = -1) -> dict:
        """Drop messages matching (src, dst); count<0 = until clear()."""
        rule = {"src": src, "dst": dst, "mode": "drop", "remaining": count}
        self.rules.append(rule)
        return rule

    def hold(self, src: Address | None = None, dst: Address | None = None,
             count: int = -1) -> dict:
        """Capture matching messages instead of delivering them; they
        re-enter the queue (in capture order) at release()."""
        rule = {"src": src, "dst": dst, "mode": "hold", "remaining": count}
        self.rules.append(rule)
        return rule

    def clear(self) -> None:
        self.rules.clear()

    def release(self, duplicate: int = 1) -> int:
        """Re-inject every held message `duplicate` times (1 = plain
        delayed delivery; 2 = delayed + duplicated — the stale-frame
        storms a healed link replays). Active rules still apply to the
        released copies (clear() first for a clean heal). Returns
        messages re-injected."""
        held, self.held = self.held, []
        n = 0
        for src, dst, data in held:
            for _ in range(duplicate):
                self.network.queue.append((src, dst, data))
                n += 1
        return n
