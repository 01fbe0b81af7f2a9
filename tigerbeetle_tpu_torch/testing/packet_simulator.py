"""Virtual network with seeded faults: delay, loss, duplication, reorder,
partitions (reference: src/testing/packet_simulator.zig:79 — delay, loss,
replay, clogging, 5 partition modes).

Deterministic: a seed fixes every decision; messages deliver on virtual
ticks through a priority queue ordered by (deliver_tick, sequence), so the
same seed always produces the same interleaving.

The port's copy of `tigerbeetle_tpu/testing/packet_simulator.py`, over the
port's `io/network.py`: the same seed gives the same delays, losses and
partitions.
"""

from __future__ import annotations

import heapq
import random

from tigerbeetle_tpu_torch.io.network import Address, Handler, Network


PARTITION_MODES = (
    "uniform_size",      # a random minority side is cut off
    "uniform_partition",  # every replica independently coin-flipped to a side
    "isolate_single",    # one replica cut from everyone
    "single_link",       # one replica pair's link cut
    "clog_link",         # one link CLOGGED: packets massively delayed, not
                         # dropped — bursts of stale traffic on heal
)


class PacketSimulatorOptions:
    def __init__(
        self,
        one_way_delay_min: int = 1,
        one_way_delay_max: int = 4,
        packet_loss_probability: float = 0.0,
        packet_replay_probability: float = 0.0,
        partition_probability: float = 0.0,  # per tick: start a partition
        unpartition_probability: float = 0.2,  # per tick: heal it
        partition_modes: tuple = PARTITION_MODES,
        partition_symmetry_probability: float = 0.7,  # else one-way cut
        client_loss_probability: float = 0.0,
        client_replay_probability: float = 0.0,
    ):
        self.one_way_delay_min = one_way_delay_min
        self.one_way_delay_max = one_way_delay_max
        self.packet_loss_probability = packet_loss_probability
        self.packet_replay_probability = packet_replay_probability
        self.partition_probability = partition_probability
        self.unpartition_probability = unpartition_probability
        self.partition_modes = partition_modes
        self.partition_symmetry_probability = partition_symmetry_probability
        # Client-link fault dial (ADDITIVE to the general loss/replay):
        # frames with a client endpoint — requests, replies, busy sheds,
        # evictions, pings — drop or duplicate at their own rate, so the
        # client runtime's timeout/retarget/dedup transitions get
        # exercised without destabilizing the consensus links. Zero (the
        # default) draws nothing from the rng: pre-existing seeds replay
        # byte-identically.
        self.client_loss_probability = client_loss_probability
        self.client_replay_probability = client_replay_probability


class PacketSimulator(Network):
    def __init__(self, seed: int, replica_count: int,
                 options: PacketSimulatorOptions | None = None):
        self.rng = random.Random(seed)
        self.replica_count = replica_count
        self.options = options or PacketSimulatorOptions()
        self.handlers: dict[Address, Handler] = {}
        self.queue: list[tuple[int, int, Address, Address, bytes]] = []
        self._seq = 0
        self.tick_now = 0
        # partition: a set of replicas isolated from the rest (clients count
        # as being on the majority side)
        self.partition: set[int] = set()
        # one-way cut replica links (src, dst) — the generalized form the
        # reference's partition modes/symmetries reduce to (reference:
        # src/testing/packet_simulator.zig:79)
        self.partition_links: set[tuple[int, int]] = set()
        # clogged links: packets still deliver, tens of ticks late (the
        # reference's clogging — stale bursts arrive after the heal)
        self.clogged_links: set[tuple[int, int]] = set()
        self.crashed: set[int] = set()
        self.stats = {"sent": 0, "delivered": 0, "lost": 0, "replayed": 0,
                      "partitioned_drops": 0}

    def attach(self, addr: Address, handler: Handler) -> None:
        self.handlers[addr] = handler

    # -- faults --

    def _is_replica(self, addr: Address) -> bool:
        return 0 <= addr < self.replica_count

    def _cut(self, src: Address, dst: Address) -> bool:
        if src in self.crashed or dst in self.crashed:
            return True
        if self.partition:
            a = src in self.partition if self._is_replica(src) else False
            b = dst in self.partition if self._is_replica(dst) else False
            if a != b:  # across the partition boundary
                return True
        if self.partition_links and self._is_replica(src) and self._is_replica(dst):
            return (src, dst) in self.partition_links
        return False

    def clear_partitions(self) -> None:
        self.partition = set()
        self.partition_links = set()
        self.clogged_links = set()

    def step_partitions(self) -> None:
        o = self.options
        if self.partition or self.partition_links or self.clogged_links:
            if self.rng.random() < o.unpartition_probability:
                self.clear_partitions()
            return
        if not (o.partition_probability > 0
                and self.rng.random() < o.partition_probability):
            return
        if self.replica_count < 2:
            return  # single-replica cluster: no links to cut (VOPR r1 draw)
        mode = self.rng.choice(list(o.partition_modes))
        symmetric = self.rng.random() < o.partition_symmetry_probability
        n = self.replica_count
        if mode == "isolate_single":
            side = {self.rng.randrange(n)}
        elif mode == "single_link":
            a, b = self.rng.sample(range(n), 2)
            self.partition_links.add((a, b))
            if symmetric:
                self.partition_links.add((b, a))
            return
        elif mode == "clog_link":
            a, b = self.rng.sample(range(n), 2)
            self.clogged_links.add((a, b))
            if symmetric:
                self.clogged_links.add((b, a))
            return
        elif mode == "uniform_partition":
            # independent coin flip per replica; both sides may be any size
            # (including empty — then nothing is cut, a valid draw)
            side = {r for r in range(n) if self.rng.random() < 0.5}
            if len(side) == n:
                side = set()
        else:  # uniform_size: a random minority
            k = self.rng.randint(1, max(1, (n - 1) // 2))
            side = set(self.rng.sample(range(n), k))
        if symmetric:
            self.partition = side
            return
        # asymmetric: the side can send OUT but hears nothing back
        for s in range(n):
            for d in range(n):
                if s == d:
                    continue
                if (s not in side) and (d in side):
                    self.partition_links.add((s, d))

    # -- transport --

    def send(self, src: Address, dst: Address, data: bytes) -> None:
        self.stats["sent"] += 1
        o = self.options
        if self._cut(src, dst):
            self.stats["partitioned_drops"] += 1
            return
        if o.packet_loss_probability and self.rng.random() < o.packet_loss_probability:
            self.stats["lost"] += 1
            return
        client_link = not (self._is_replica(src) and self._is_replica(dst))
        if (
            client_link
            and o.client_loss_probability
            and self.rng.random() < o.client_loss_probability
        ):
            self.stats["client_lost"] = self.stats.get("client_lost", 0) + 1
            return
        copies = 1
        if o.packet_replay_probability and self.rng.random() < o.packet_replay_probability:
            copies = 2
            self.stats["replayed"] += 1
        if (
            client_link
            and copies == 1
            and o.client_replay_probability
            and self.rng.random() < o.client_replay_probability
        ):
            copies = 2
            self.stats["client_replayed"] = (
                self.stats.get("client_replayed", 0) + 1
            )
        clogged = (
            self._is_replica(src) and self._is_replica(dst)
            and (src, dst) in self.clogged_links
        )
        for _ in range(copies):
            delay = self.rng.randint(o.one_way_delay_min, o.one_way_delay_max)
            if clogged:  # stale burst: arrives long after the clog heals
                delay += self.rng.randint(30, 80)
                self.stats["clogged"] = self.stats.get("clogged", 0) + 1
            self._seq += 1
            heapq.heappush(
                self.queue,
                (self.tick_now + delay, self._seq, src, dst, bytes(data)),
            )

    def tick(self) -> int:
        """Advance one tick; deliver everything due. Handlers may send more
        (those land on later ticks). Returns messages delivered."""
        self.tick_now += 1
        self.step_partitions()
        n = 0
        while self.queue and self.queue[0][0] <= self.tick_now:
            _, _, src, dst, data = heapq.heappop(self.queue)
            if self._cut(src, dst):
                self.stats["partitioned_drops"] += 1
                continue
            handler = self.handlers.get(dst)
            if handler is None:
                continue
            self.stats["delivered"] += 1
            handler(src, data)
            n += 1
        return n
