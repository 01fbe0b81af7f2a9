"""Deterministic in-process cluster: real replicas + clients over fakes.

The reference's ClusterType (reference: src/testing/cluster.zig:50-73)
wires production replicas to in-memory Storage, a virtual Network, and
virtual Time with ZERO changes to the replica code — the comptime seams.
This is the same harness over our seams, used by the cluster tests and the
simulator.

The port's copy of `tigerbeetle_tpu/testing/cluster.py`. `device` goes to
every replica and to `restart_replica`: None builds each replica's device
ledger on "cuda" (raising where CUDA is missing), "cpu" runs the kernels'
plain versions.
"""

from __future__ import annotations

from tigerbeetle_tpu_torch.constants import ConfigCluster, ConfigProcess
from tigerbeetle_tpu_torch.io.network import InProcessNetwork
from tigerbeetle_tpu_torch.io.storage import MemoryStorage, ZoneLayout
from tigerbeetle_tpu_torch.io.time import DeterministicTime
from tigerbeetle_tpu_torch.types import Operation
from tigerbeetle_tpu_torch.vsr.client import Client
from tigerbeetle_tpu_torch.vsr.durable import format_data_file
from tigerbeetle_tpu_torch.vsr.header import Header
from tigerbeetle_tpu_torch.vsr.replica import Replica

CLIENT_ID_BASE = 1 << 64  # client addresses: above any replica index


class Cluster:
    def __init__(
        self,
        replica_count: int = 3,
        cluster: ConfigCluster | None = None,
        process: ConfigProcess | None = None,
        grid_size: int = 8 * 1024 * 1024,
        mode: str = "auto",
        backend_factory=None,
        network: InProcessNetwork | None = None,
        seed: int = 0,
        forest_blocks: int = 0,
        standby_count: int = 0,
        metrics=None,
        tracer=None,
        tracer_factory=None,
        device=None,
    ):
        from tigerbeetle_tpu_torch.constants import TEST_CLUSTER, TEST_PROCESS

        self.cluster_config = cluster or TEST_CLUSTER
        self.process_config = process or TEST_PROCESS
        self.network = network if network is not None else InProcessNetwork()
        self.time = DeterministicTime()
        self.mode = mode
        self.backend_factory = backend_factory
        self.device = device
        self.layout = ZoneLayout(self.cluster_config, grid_size=grid_size,
                                 forest_blocks=forest_blocks)
        self.storages = []
        self.replicas: list[Replica] = []
        self.clients: list[Client] = []
        self.detached: set[int] = set()
        self.network.filters.append(
            lambda src, dst, data: src not in self.detached
            and dst not in self.detached
        )

        self.standby_count = standby_count
        self.replica_count = replica_count  # ACTIVE replicas only
        for i in range(replica_count + standby_count):
            storage = MemoryStorage(self.layout, seed=seed * 97 + i)
            format_data_file(storage, self.cluster_config)
            self.storages.append(storage)
            r = Replica(
                i, replica_count, storage, self.network, self.time,
                self.cluster_config, self.process_config, mode=mode,
                backend_factory=backend_factory,
                standby_count=standby_count,
                # observability pass-through: a harness can hand every
                # replica one shared registry/tracer (tests do), or a
                # tracer PER replica via tracer_factory(i) — the shape
                # the cluster-causal stitch tests use (pid = index)
                metrics=metrics,
                tracer=tracer_factory(i) if tracer_factory else tracer,
                device=device,
            )
            # thread timing must not leak into deterministic runs
            r.sync_payload_async = False
            r.open()
            self.replicas.append(r)

    def add_client(self) -> Client:
        c = Client(
            CLIENT_ID_BASE + len(self.clients), self.network,
            self.replica_count,
        )
        self.clients.append(c)
        c.register()
        self.network.run()
        c.take_reply()
        assert c.session != 0
        return c

    def execute(self, client: Client, operation: Operation,
                body: bytes) -> tuple[Header, bytes]:
        """Send one request and pump the network until its reply arrives.
        One broadcast retry models the client's request timeout (it may not
        know the current primary after a view change)."""
        client.request(operation, body)
        self.network.run()
        if client.reply is None:
            client.resend()
            self.network.run()
        return client.take_reply()

    def run_ticks(self, n: int) -> None:
        """Advance virtual time: each tick every replica ticks, then the
        network quiesces (the simulator interleaves these differently)."""
        for _ in range(n):
            self.time.tick()
            for r in self.replicas:
                if r.replica not in self.detached:
                    r.tick()
            self.network.run()

    def detach_replica(self, index: int) -> None:
        """Crash a replica: no messages in or out, no ticks."""
        self.detached.add(index)

    def reattach_replica(self, index: int) -> None:
        self.detached.discard(index)

    def restart_replica(self, index: int, backend_factory=None) -> Replica:
        """Crash-restart a replica over its surviving storage bytes."""
        old = self.replicas[index]
        r = Replica(
            index, self.replica_count, self.storages[index], self.network,
            self.time, self.cluster_config, self.process_config,
            mode=self.mode,
            backend_factory=backend_factory or self.backend_factory,
            standby_count=self.standby_count,
            device=self.device,
        )
        r.sync_payload_async = False  # deterministic harness
        r.open()
        self.replicas[index] = r
        self.detached.discard(index)
        del old
        # Recovering replicas rejoin via request_start_view -> start_view;
        # pump until the handshake settles (ticks drive retries if needed).
        self.network.run()
        for _ in range(3 * 40):
            if r.status == "normal":
                break
            self.run_ticks(1)
        return r
