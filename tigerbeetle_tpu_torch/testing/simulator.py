"""The VOPR-equivalent deterministic simulator (reference:
src/simulator.zig:66-173, SURVEY.md §4 tier 3).

One seed drives EVERYTHING — packet delays/loss/replay, partitions, the
crash/restart schedule, WAL fault injection, client workload and retry
timing — so a failing seed replays identically. The whole cluster (real
Replica code over MemoryStorage + PacketSimulator + per-replica skewed
DeterministicTime) runs in one process on virtual ticks.

Checkers (reference: src/testing/cluster/state_checker.zig,
storage_checker.zig):
- commit histories: every replica's committed (op -> checksum) stream must
  agree with every other's on common ops — one linear history, no forks;
- convergence after healing: all replicas reach the same commit_min;
- oracle parity: replaying the committed history through the scalar oracle
  must equal every replica's final extracted state bit-for-bit;
- liveness: the run must make progress within its tick budget.

The ledger backend is the scalar oracle by default (logic-level simulation
at high op counts); backend_factory=None runs each replica's own
DeviceLedger on `device`: "cuda" when None (the ledger raises where CUDA is
missing), "cpu" for the kernels' plain versions.

The port's copy of `tigerbeetle_tpu/testing/simulator.py`: the same seed
draws the same faults, workload and schedule, in the same order. The CDC,
fan-out, ingress, connect-storm, AOF-tail, commitment and scripted
tick-hook options ride modules the port does not have yet (queues A6 and
A7 of ROADMAP.md): they keep their parameters and raise
NotImplementedError when set.
"""

from __future__ import annotations

import random

from tigerbeetle_tpu_torch import types
from tigerbeetle_tpu_torch.constants import TEST_CLUSTER, ConfigCluster
from tigerbeetle_tpu_torch.io.storage import MemoryStorage, Zone, ZoneLayout
from tigerbeetle_tpu_torch.io.time import DeterministicTime
from tigerbeetle_tpu_torch.models.oracle import OracleStateMachine
from tigerbeetle_tpu_torch.state_machine import StateMachine
from tigerbeetle_tpu_torch.testing.packet_simulator import (
    PacketSimulator,
    PacketSimulatorOptions,
)
from tigerbeetle_tpu_torch.testing.workload import WorkloadGenerator
from tigerbeetle_tpu_torch.types import Operation
from tigerbeetle_tpu_torch.vsr.client import Client, RequestTimeout, SessionEvicted
from tigerbeetle_tpu_torch.vsr.durable import format_data_file
from tigerbeetle_tpu_torch.vsr.header import Header
from tigerbeetle_tpu_torch.vsr.replica import Replica

CLIENT_ID_BASE = 1 << 64
CLIENT_RETRY_TICKS = 30


class SimClient:
    """Workload client riding the client RUNTIME: retries, exponential
    backoff, round-robin re-targeting, busy backoff and (opt-in)
    re-registration all happen inside Client.tick() — the driver only
    issues work and takes replies, the same contract the live chaos
    fleet runs under. Typed errors surface through poll(): an eviction
    is fatal unless the client auto-re-registers (then it is counted and
    the session resumes), a deadline expiry counts and the slot retries
    with fresh work."""

    def __init__(self, client: Client, seed: int, batch_size: int = 8,
                 workload_knobs: dict | None = None,
                 tick_stride: int = 1, tick_burst: int = 1):
        self.client = client
        self.gen = WorkloadGenerator(seed, **(workload_knobs or {}))
        self.batch = batch_size
        self.rng = random.Random(seed * 13 + 7)
        self.replies = 0
        self.batch_index = 0
        self.evictions = 0
        self.deadline_timeouts = 0
        # Clock-skew dial: this client's runtime clock ticks at a skewed
        # rate against sim time (stride > 1 = slow clock, burst > 1 =
        # fast clock), so timeout/backoff firing interleaves differently
        # per client — the "clock-skewed timeout firing" fault axis.
        self.tick_stride = tick_stride
        self.tick_burst = tick_burst

    drain_mode = False  # heal phase: finish in-flight work, issue nothing new
    # Issue probability per free-slot tick — the offered-load dial the
    # prodday twin's phases turn (tigerbeetle_tpu/prodday.py). Changing
    # duty changes WHICH draws issue work but every draw still happens,
    # so a timeline's load curve stays seed-deterministic.
    duty = 0.5

    def tick(self, now: int) -> None:
        c = self.client
        if now % self.tick_stride == 0:
            for _ in range(self.tick_burst):
                c.tick()
        try:
            c.poll()
        except SessionEvicted:
            self.evictions += 1
            if not c.auto_reregister:
                raise AssertionError("client evicted during simulation")
        except RequestTimeout:
            self.deadline_timeouts += 1
        if c.reply is not None:
            c.take_reply()
            self.replies += 1
        if self.drain_mode and c.in_flight is None:
            return
        if c.session == 0:
            if c.in_flight is None and not c._want_reregister:
                c.register()
            return
        if c.in_flight is None:
            # idle when the draw lands below (1 - duty): at the 0.5
            # default this is bit-for-bit the pre-duty behavior, so
            # every tuned seed in the test suite replays unchanged
            if self.rng.random() < 1.0 - self.duty:
                return  # idle this tick
            self.batch_index += 1
            if self.batch_index % 3 == 1:
                op, events = self.gen.gen_accounts_batch(self.batch)
                body = types.accounts_to_np(events).tobytes()
            else:
                op, events = self.gen.gen_transfers_batch(self.batch)
                body = types.transfers_to_np(events).tobytes()
            c.request(op, body)


# the options that ride modules the port does not have yet, and the queue
# of ROADMAP.md that ports them
_UNPORTED = {
    "cdc_consumer": "A6 (CDC)",
    "cdc_fanout": "A6 (CDC and ingress)",
    "ingress_gateway": "A6 (ingress)",
    "storm_clients": "A6 (ingress)",
    "tail_aof": "A6 (CDC) and A4 (the AOF)",
    "commitment_interval": "A7 (federation)",
    "tick_hook": "A7 (the production day)",
}


def _refuse_unported(**options) -> None:
    for name, value in options.items():
        if value:
            raise NotImplementedError(
                f"Simulator({name}=...) needs queue {_UNPORTED[name]} of "
                "ROADMAP.md, which the port does not have yet"
            )


class Simulator:
    def __init__(
        self,
        seed: int,
        replica_count: int = 3,
        standby_count: int = 0,
        n_clients: int = 2,
        ticks: int = 1500,
        cluster: ConfigCluster = TEST_CLUSTER,
        crash_probability: float = 0.002,
        restart_ticks_max: int = 80,
        wal_fault_probability: float = 0.2,
        torn_write_probability: float = 0.2,
        replies_fault_probability: float = 0.1,
        superblock_fault_probability: float = 0.1,
        grid_fault_probability: float = 0.0,
        grid_read_latency_s: float = 0.0,
        forest_blocks: int = 0,
        grid_size: int = 8 * 1024 * 1024,
        options: PacketSimulatorOptions | None = None,
        backend_factory=OracleStateMachine,
        process=None,
        client_batch: int = 8,
        workload_knobs: dict | None = None,
        trace_path: str | None = None,
        cdc_consumer: bool = False,
        cdc_crash_probability: float = 0.01,
        cdc_fanout: int = 0,
        cdc_fanout_throttle: int = 4,
        ingress_gateway: bool = False,
        storm_clients: int = 0,
        hash_log: tuple[str, str] | None = None,
        client_auto_reregister: bool = False,
        client_deadline_ticks: int = 0,
        client_tick_skew: bool = False,
        primary_crash_probability: float = 0.0,
        latency_sample_every: int = 0,
        tick_hook=None,
        commitment_interval: int = 0,
        tail_aof: bool = False,
        device=None,
    ):
        from tigerbeetle_tpu_torch.constants import TEST_PROCESS

        _refuse_unported(
            cdc_consumer=cdc_consumer, cdc_fanout=cdc_fanout,
            ingress_gateway=ingress_gateway, storm_clients=storm_clients,
            tail_aof=tail_aof, commitment_interval=commitment_interval,
            tick_hook=tick_hook,
        )
        self.process_config = process or TEST_PROCESS
        # each replica's DeviceLedger (backend_factory=None) is built on
        # this device, at the start and at every restart
        self.device = device
        # hash_log debugging surface (testing/hash_log.py; the reference's
        # -Dhash-log-mode): ("record"|"check", path). ONE log instance
        # lives across replica 0's crash/restarts — recovery re-commits
        # re-record/re-check identical entries (idempotent by op), and
        # check mode dies AT the first divergent op of a replayed seed.
        self.hash_log = None
        if hash_log is not None:
            from tigerbeetle_tpu_torch.testing.hash_log import HashLog

            self.hash_log = HashLog(hash_log[0], path=hash_log[1])
        # Latency-anatomy sampling override (tigerbeetle_tpu/latency.py):
        # 0 keeps the replica default. Stamps ride the DeterministicTime
        # seam (virtual ticks), so forcing sample_every=1 must leave the
        # committed history byte-identical AND fold identical latency
        # histograms across runs of one seed (tests/test_latency.py).
        self.latency_sample_every = latency_sample_every
        self.seed = seed
        self.rng = random.Random(seed)
        self.ticks_budget = ticks
        self.cluster_config = cluster
        self.crash_probability = crash_probability
        self.restart_ticks_max = restart_ticks_max
        self.wal_fault_probability = wal_fault_probability
        self.torn_write_probability = torn_write_probability
        self.replies_fault_probability = replies_fault_probability
        self.superblock_fault_probability = superblock_fault_probability
        self.grid_fault_probability = grid_fault_probability
        self.backend_factory = backend_factory
        self.replica_count = replica_count  # ACTIVE replicas (quorums)
        self.standby_count = standby_count
        self.total_replicas = replica_count + standby_count

        # Deterministic tracer mode: spans from every replica's commit
        # path are timestamped with SIM TICKS (the virtual clock), and the
        # canonical dump is byte-identical across runs of the same seed —
        # two dumps of a diverging VOPR seed can be diffed directly. The
        # tracer is pure observation: enabling it must leave the committed
        # history unchanged (tested in tests/test_metrics.py).
        #
        # ONE tracer PER REPLICA (pid = replica index), surviving that
        # replica's crash/restarts, and the dump is the STITCHED cluster
        # trace (tracer.stitch): every span tagged with an op's trace id
        # (vsr/header.py trace_id) becomes a Perfetto flow linking the
        # op's legs across replica pids — and because ticks, ring
        # contents and the stitch are all deterministic, the same seed
        # still dumps byte-identical files.
        self.trace_path = trace_path
        self.tracers = None
        if trace_path is not None:
            from tigerbeetle_tpu_torch.tracer import SimTracer

            self.tracers = [
                SimTracer(clock=lambda: self.net.tick_now, pid=i)
                for i in range(replica_count + standby_count)
            ]

        self.net = PacketSimulator(
            seed * 31 + 1, self.total_replicas,
            options or PacketSimulatorOptions(
                packet_loss_probability=0.02,
                packet_replay_probability=0.02,
                partition_probability=0.005,
            ),
        )
        self.layout = ZoneLayout(cluster, grid_size=grid_size,
                                 forest_blocks=forest_blocks)
        self.times = [
            DeterministicTime(offset_ns=self.rng.randint(-50, 50) * 1_000_000)
            for _ in range(self.total_replicas)
        ]
        self.storages = []
        self.replicas: list[Replica] = []
        # god's-eye committed history per replica:
        # op -> (checksum, operation, timestamp, body)
        self.histories: list[dict[int, tuple]] = [
            {} for _ in range(self.total_replicas)
        ]
        # Injected grid-read latency (through the Storage seam, reference:
        # src/testing/storage.zig read_latency): every forest-block read
        # costs real wall time. Replica behavior keys off VIRTUAL time
        # (ticks / the Time seam) and the spill IO rides the deterministic
        # executor, so a seeded run's committed history must be BYTE-
        # IDENTICAL with and without the latency — the proof that replica
        # spill/grid IO is off the hot loop rather than hidden in it.
        self.grid_read_latency_s = grid_read_latency_s
        self.grid_reads = 0

        def _grid_latency_hook(zone, offset, size):
            if zone is Zone.grid and offset >= self.layout.forest_offset:
                self.grid_reads += 1
                if self.grid_read_latency_s > 0.0:
                    import time as _time

                    _time.sleep(self.grid_read_latency_s)

        for i in range(self.total_replicas):
            storage = MemoryStorage(self.layout, seed=seed * 97 + i)
            format_data_file(storage, cluster)
            if forest_blocks:
                storage.read_hook = _grid_latency_hook
            self.storages.append(storage)
            self.replicas.append(self._make_replica(i))
        self.down: dict[int, int] = {}  # replica -> restart tick
        self.crashes = 0
        self.wal_faults = 0
        self.torn_writes = 0
        self.replies_faults = 0
        self.superblock_faults = 0
        self.grid_faults = 0

        # Client-runtime fault axes (all seed-deterministic): opt-in
        # automatic re-registration after eviction, per-request deadlines
        # (RequestTimeout), skewed client clocks, and targeted crashes of
        # the PRIMARY while client requests are in flight.
        self.client_auto_reregister = client_auto_reregister
        self.client_deadline_ticks = client_deadline_ticks
        self.client_tick_skew = client_tick_skew
        self.primary_crash_probability = primary_crash_probability
        self.primary_crashes = 0
        self._client_batch = client_batch
        self._workload_knobs = workload_knobs
        self.clients = [
            self._new_sim_client(i) for i in range(n_clients)
        ]

    def _new_sim_client(self, i: int) -> SimClient:
        """One seeded workload client on the tick-driven runtime. The
        skew draws come from the client's OWN derived rng (not self.rng),
        so enabling skew never shifts the crash/fault schedule of a
        seed's other draws."""
        stride = burst = 1
        if self.client_tick_skew:
            skew_rng = random.Random(self.seed * 41 + i * 3 + 2)
            stride = skew_rng.choice((1, 1, 2, 3))
            burst = skew_rng.choice((1, 1, 2)) if stride == 1 else 1
        return SimClient(
            Client(
                CLIENT_ID_BASE + i, self.net, self.replica_count,
                request_timeout_ticks=CLIENT_RETRY_TICKS,
                # short runs need a snappy ladder: cap at 4x base (the
                # live default caps at 16x — seconds-scale wall time)
                max_backoff_exponent=2,
                ping_ticks=40,
                deadline_ticks=self.client_deadline_ticks,
                auto_reregister=self.client_auto_reregister,
            ),
            self.seed * 7 + i, batch_size=self._client_batch,
            workload_knobs=self._workload_knobs,
            tick_stride=stride, tick_burst=burst,
        )

    def _make_replica(self, i: int) -> Replica:
        r = Replica(
            i, self.replica_count, self.storages[i], self.net, self.times[i],
            self.cluster_config, self.process_config,
            backend_factory=self.backend_factory,
            standby_count=self.standby_count,
            tracer=self.tracers[i] if self.tracers is not None else None,
            device=self.device,
        )
        if self.latency_sample_every:
            r.latency.sample_every = self.latency_sample_every
        hist = self.histories[i]

        def hook(header: Header, body: bytes, _h=hist) -> None:
            prev = _h.get(header.op)
            if prev is not None and prev[0] != header.checksum:
                raise AssertionError(
                    f"replica {i}: op {header.op} committed twice with "
                    f"different checksums"
                )
            _h[header.op] = (
                header.checksum, header.operation, header.timestamp, body,
            )

        r.commit_hook = hook
        if i == 0 and self.hash_log is not None:
            # chains AFTER the history hook (attach composes); replica 0
            # only — every replica commits the same stream, and one
            # recording per seed is the reference's shape too
            self.hash_log.attach(r)
        # thread timing must not leak into seeded deterministic runs
        r.sync_payload_async = False
        r.open()
        return r

    # -- fault scheduling --

    def kill_primary(self, now: int) -> bool:
        """Scripted targeted crash (the prodday twin's `kill_primary` /
        `gray_primary` events): SIGKILL the current primary if one is
        identifiable, up, and quorum can spare it. Unlike the
        probability-drawn `_maybe_crash` primary fault, this fires at an
        exact scripted tick; the crash itself still rides `_crash` (torn
        head, restart delay) so its draws stay in the seed's stream."""
        active_down = sum(1 for i in self.down if i < self.replica_count)
        if active_down >= (self.replica_count - 1) // 2:
            return False
        views = [
            self.replicas[i].view
            for i in range(self.replica_count)
            if i not in self.down and self.replicas[i].status == "normal"
        ]
        if not views:
            return False
        primary = max(views) % self.replica_count
        if primary in self.down:
            return False
        self.primary_crashes += 1
        self._crash(primary, now)
        return True

    def _crash(self, victim: int, now: int) -> None:
        self.crashes += 1
        if self.rng.random() < self.torn_write_probability:
            self._inject_torn_head(victim)
        self.net.crashed.add(victim)
        self.down[victim] = now + self.rng.randint(
            10, self.restart_ticks_max
        )

    def _maybe_crash(self, now: int) -> None:
        alive = [i for i in range(self.total_replicas) if i not in self.down]
        # quorum safety counts ACTIVE replicas only; standbys (index >=
        # replica_count) may crash freely — they hold no votes
        active_down = sum(1 for i in self.down if i < self.replica_count)
        max_down = (self.replica_count - 1) // 2
        # Targeted fault: SIGKILL-the-primary with client requests IN
        # FLIGHT — the failover transition the client runtime's
        # timeout -> re-target -> duplicate-reply-dedup ladder exists
        # for. Probability 0 (the default) draws nothing.
        if (
            self.primary_crash_probability
            and self.rng.random() < self.primary_crash_probability
            and active_down < max_down
            and any(c.client.in_flight is not None for c in self.clients)
        ):
            views = [
                self.replicas[i].view
                for i in range(self.replica_count)
                if i not in self.down and self.replicas[i].status == "normal"
            ]
            if views:
                primary = max(views) % self.replica_count
                if primary not in self.down:
                    self.primary_crashes += 1
                    self._crash(primary, now)
                    return
        if self.rng.random() < self.crash_probability:
            if active_down >= max_down:
                alive = [i for i in alive if i >= self.replica_count]
                if not alive:
                    return
            victim = self.rng.choice(alive)
            self._crash(victim, now)

    def _inject_torn_head(self, i: int) -> None:
        """Crash-point torn write: the victim's most recent journal write
        is cut mid-sector, modeling a crash DURING write_prepare
        (reference: src/simulator.zig:160-173 crash-point faults). Tears
        either the prepare body only (redundant header survives -> TORN
        slot, body repairable from any acker) or both rings (-> BLANK
        slot, an explicit nack in protocol-aware recovery).

        Fault atlas rule (reference: src/testing/storage.zig:1-25): only
        tear when at least one OTHER replica journaled the op, so a copy
        survives cluster-wide and a possibly-acked op cannot vanish."""
        victim = self.replicas[i]
        op = victim.op
        if op < 1 or victim.journal.read_prepare(op) is None:
            return
        # survivors must be VOTERS: every repair path fetches from active
        # replicas only, so a copy surviving solely on a standby is
        # unreachable — tearing the last voter copy would wedge the cluster
        survivors = any(
            self.replicas[j].journal.read_prepare(op) is not None
            for j in range(self.replica_count)
            if j != i
        )
        if not survivors:
            return
        cfg = self.cluster_config
        slot = victim.journal.slot_for_op(op)
        self.storages[i].fault(
            Zone.wal_prepares, slot * cfg.message_size_max + 160, 96
        )
        if self.rng.random() < 0.5:  # tear the redundant header too: BLANK
            self.storages[i].fault(Zone.wal_headers, slot * 128, 128)
        self.torn_writes += 1

    def _maybe_grid_fault(self) -> None:
        """Corrupt one acquired forest block on an ALIVE replica mid-
        workload — the scrub pass (or a commit tripping GridBlockCorrupt)
        must heal it from a peer before the run's state checks read the
        spilled tail (reference: src/testing/storage.zig:1-25 faults every
        zone; src/vsr/grid_blocks_missing.zig peer repair).

        Fault atlas rule: only fault an address for which at least one
        OTHER alive replica holds a verifiable copy (replicas' forests are
        bit-identical by determinism, but a peer may itself carry an
        unhealed fault at the same address)."""
        if self.grid_fault_probability <= 0.0:
            return
        if self.rng.random() >= self.grid_fault_probability:
            return
        alive = [i for i in range(self.total_replicas) if i not in self.down]
        self.rng.shuffle(alive)
        from tigerbeetle_tpu_torch.lsm.grid import BLOCK_SIZE

        for i in alive:
            r = self.replicas[i]
            if r.forest is None:
                continue
            grid = r.forest.grid
            acquired = [
                a for a in range(1, grid.block_count + 1)
                if not grid.free_set.is_free(a)
            ]
            self.rng.shuffle(acquired)
            for a in acquired[:8]:
                if not grid.verify_block(a):
                    continue  # already faulted and not yet healed
                survivors = any(
                    self.replicas[j].forest is not None
                    and self.replicas[j].forest.grid.verify_block(a)
                    for j in alive
                    if j != i
                )
                if not survivors:
                    continue
                fo = self.layout.forest_offset
                self.storages[i].fault(
                    Zone.grid,
                    fo + (a - 1) * BLOCK_SIZE + self.rng.randrange(0, 1024),
                    64,
                )
                grid.cache.remove(a)  # the fault must be visible to reads
                self.grid_faults += 1
                return
            # no eligible block on this replica this tick: try the next

    def _maybe_restart(self, now: int) -> None:
        for i, when in list(self.down.items()):
            if now >= when:
                if self.rng.random() < self.wal_fault_probability:
                    self._inject_wal_fault(i)
                if self.rng.random() < self.replies_fault_probability:
                    self._inject_replies_fault(i)
                if self.rng.random() < self.superblock_fault_probability:
                    self._inject_superblock_fault(i)
                del self.down[i]
                self.net.crashed.discard(i)
                self.replicas[i] = self._make_replica(i)

    def _inject_replies_fault(self, i: int) -> None:
        """Corrupt one client_replies slot: the checksum-validated restore
        must read it as absent and fall back to the reply-lost paths
        (reference: src/testing/storage.zig faults every zone)."""
        slot = self.rng.randrange(self.cluster_config.reply_slot_count)
        self.storages[i].fault(
            Zone.client_replies,
            slot * self.cluster_config.message_size_max
            + self.rng.randrange(0, 256),
            64,
        )
        self.replies_faults += 1

    def _inject_superblock_fault(self, i: int) -> None:
        """Corrupt ONE of the superblock's redundant copies: the quorum
        (4 copies) must still open. Atlas rule: never more than one copy
        per restart (a lost quorum is a beyond-f fault)."""
        copy = self.rng.randrange(ZoneLayout.SUPERBLOCK_COPIES)
        self.storages[i].fault(
            Zone.superblock,
            copy * ZoneLayout.SUPERBLOCK_COPY_SIZE
            + self.rng.randrange(0, 1024),
            64,
        )
        self.superblock_faults += 1

    def _inject_wal_fault(self, i: int) -> None:
        """Corrupt one WAL prepare body on the restarting replica — the
        journal must detect it (faulty slot) and the repair path must
        refetch it from a peer.

        Fault atlas rule (reference: src/testing/storage.zig
        ClusterFaultAtlas — at least one valid copy must survive): only
        fault an op that EVERY other replica has committed (and therefore
        journaled), so the repair source set is a majority and no committed
        op can vanish from all logs."""
        others_min = min(
            (
                self.replicas[j].commit_min
                for j in range(self.replica_count)  # repair sources: voters
                if j != i
            ),
            default=0,  # single-voter cluster: no repair source, no fault
        )
        if others_min < 1:
            return
        victim_journal = self.replicas[i].journal
        lo = max(1, self.replicas[i].op - self.cluster_config.journal_slot_count + 1)
        if lo > others_min:
            return
        for _ in range(8):  # a few random probes for a fault-eligible slot
            op = self.rng.randint(lo, others_min)
            got = victim_journal.read_prepare(op)
            if got is None:
                continue
            slot = victim_journal.slot_for_op(op)
            msg_max = self.cluster_config.message_size_max
            if self.rng.random() < 0.3 and op > lo:
                # MISDIRECTED write (reference: src/vsr/journal.zig
                # decision-matrix rows): a checksum-VALID prepare lands in
                # the wrong slot — recovery must classify it (not trust
                # it) and repair this slot from the redundant evidence
                src_op = op - 1
                src = self.replicas[i].journal.read_prepare(src_op)
                if src is not None:
                    src_slot = victim_journal.slot_for_op(src_op)
                    raw = self.storages[i].read(
                        Zone.wal_prepares, src_slot * msg_max, msg_max
                    )
                    self.storages[i].write(
                        Zone.wal_prepares, slot * msg_max, raw
                    )
                    self.wal_faults += 1
                    return
            self.storages[i].fault(
                Zone.wal_prepares, slot * msg_max + 200, 64,
            )
            self.wal_faults += 1
            return

    # -- main loop --

    def step(self) -> None:
        """ONE simulation tick: fault draws, replica/client/CDC ticks,
        network delivery — the exact body `run()` repeats. Extracted so
        a composite harness (federation/sim.py SimFederation) can
        interleave several Simulators tick-by-tick and drive agents
        between them without forking the loop."""
        now = self.net.tick_now
        self._maybe_crash(now)
        self._maybe_grid_fault()
        self._maybe_restart(now)
        for i, r in enumerate(self.replicas):
            if i not in self.down:
                self.times[i].tick()
                r.tick()
        for c in self.clients:
            c.tick(now)
        self.net.tick()

    def run(self) -> dict:
        for _ in range(self.ticks_budget):
            self.step()

        try:
            self._heal_and_converge()
            self._check()
        finally:
            # dump even when a checker raises: a diverging seed's trace is
            # exactly the artifact worth diffing against a healthy replay
            if self.tracers is not None and self.trace_path is not None:
                from tigerbeetle_tpu_torch.tracer import dump_stitched

                dump_stitched(
                    self.trace_path,
                    [tr.events_ordered() for tr in self.tracers],
                    labels=[
                        f"replica {i}" if i < self.replica_count
                        else f"standby {i}"
                        for i in range(len(self.tracers))
                    ],
                )
            # ...and a failing seed's hash-log recording is the artifact a
            # replay checks against (save in the finally for the same
            # reason the trace dumps there)
            if self.hash_log is not None and self.hash_log.mode == "record":
                self.hash_log.save()
        committed = max(
            (max(h) if h else 0) for h in self.histories
        )
        out_cdc = {}
        if self.primary_crash_probability:
            out_cdc["primary_crashes"] = self.primary_crashes
        if self.client_auto_reregister:
            # every surfaced eviction pairs with one automatic re-register
            out_cdc["client_evictions"] = sum(
                c.evictions for c in self.clients
            )
        if self.client_deadline_ticks:
            out_cdc["client_deadline_timeouts"] = sum(
                c.deadline_timeouts for c in self.clients
            )
        if self.hash_log is not None:
            out_cdc["hash_log_mode"] = self.hash_log.mode
            # ops THIS RUN streamed/verified — in check mode len(entries)
            # is the preloaded recording and says nothing about coverage
            out_cdc["hash_log_ops"] = self.hash_log.ops_seen
        return {
            "seed": self.seed,
            "committed_ops": committed,
            "replies": sum(c.replies for c in self.clients),
            **out_cdc,
            "crashes": self.crashes,
            "wal_faults": self.wal_faults,
            "torn_writes": self.torn_writes,
            "replies_faults": self.replies_faults,
            "superblock_faults": self.superblock_faults,
            "grid_faults": self.grid_faults,
            "grid_reads": self.grid_reads,
            "net": dict(self.net.stats),
            "view": self.replicas[0].view,
        }

    def _heal_and_converge(self) -> None:
        self.net.clear_partitions()
        self.net.options.partition_probability = 0.0
        self.net.options.packet_loss_probability = 0.0
        self.crash_probability = 0.0
        for c in self.clients:
            c.drain_mode = True
        for i in list(self.down):
            del self.down[i]
            self.net.crashed.discard(i)
            self.replicas[i] = self._make_replica(i)
        # The budget must cover a full capped-backoff retry CYCLE of the
        # client runtime (a request that spent the fault phase retrying
        # sits at the top of its ladder — base 30 * 2^4 plus jitter —
        # and may need several re-targeted fires to find the primary);
        # the loop exits at quiescence, so healthy seeds don't pay this.
        budget = 2400
        for _ in range(budget):
            for i, r in enumerate(self.replicas):
                self.times[i].tick()
                r.tick()
            for c in self.clients:
                c.tick(self.net.tick_now)
            self.net.tick()
            mins = {r.commit_min for r in self.replicas}
            stats = {r.status for r in self.replicas}
            if len(mins) == 1 and stats == {"normal"}:
                quiet = all(c.client.in_flight is None for c in self.clients)
                if quiet and self._grids_clean():
                    return
        raise AssertionError(
            f"no convergence within heal budget: commit_mins="
            f"{[r.commit_min for r in self.replicas]} "
            f"status={[r.status for r in self.replicas]} "
            f"views={[r.view for r in self.replicas]}"
        )

    def _grids_clean(self) -> bool:
        """Every replica's acquired forest blocks verify — injected grid
        faults must be detected (scrub pass) AND healed (peer repair)
        before the final state checks read the spilled tail. Only probed
        once commits/statuses have already converged, and skipped entirely
        when no grid fault was ever injected (checksumming every block of
        every replica per probe would be pure waste there)."""
        if self.grid_faults == 0:
            return True
        for r in self.replicas:
            if r.forest is None:
                continue
            grid = r.forest.grid
            for a in range(1, grid.block_count + 1):
                if not grid.free_set.is_free(a) and not grid.verify_block(a):
                    return False
        return True

    def _check(self) -> None:
        # 1. one linear history: common ops agree across replicas
        merged: dict[int, tuple] = {}
        for i, h in enumerate(self.histories):
            for op, rec in h.items():
                if op in merged:
                    assert merged[op][0] == rec[0], (
                        f"history fork at op {op} (replica {i})"
                    )
                else:
                    merged[op] = rec
        assert merged, "nothing committed"
        top = max(merged)
        assert set(merged) == set(range(1, top + 1)), "history has holes"

        # 2. convergence to the same commit point
        mins = {r.commit_min for r in self.replicas}
        assert mins == {top}, (mins, top)

        # 3. oracle replay parity, bit for bit, on every replica
        sm = StateMachine(OracleStateMachine(),
                          self.cluster_config.message_size_max)
        for op in range(1, top + 1):
            _, operation, timestamp, body = merged[op]
            if operation != int(Operation.register):
                sm.commit(Operation(operation), timestamp, body)
        oracle = sm.backend
        for r in self.replicas:
            accounts, transfers, posted = r.ledger.extract()
            assert accounts == oracle.accounts, f"replica {r.replica} accounts"
            assert transfers == oracle.transfers, f"replica {r.replica} transfers"
            assert posted == oracle.posted, f"replica {r.replica} posted"


def run_simulation(seed: int, **kwargs) -> dict:
    return Simulator(seed, **kwargs).run()


def random_options(seed: int, device_fraction: float = 0.0) -> dict:
    """Seed-derived cluster topology + fault mix for the VOPR fleet
    (reference: src/simulator.zig:66-152 — cluster size, client count, and
    every fault probability drawn from the seed; :160-173 crash-point
    faults). The draw is deterministic in `seed`, so a failing fleet seed
    replays with the identical topology.

    Most seeds run the scalar-oracle backend (logic-level, fast) with the
    full chaos mix: 1-6 replicas, 0-2 standbys, 1-8 clients, partitions +
    torn writes + WAL/replies/superblock faults all active together. A
    `device_fraction` slice instead runs the DeviceLedger backend with a
    tiny spill-heavy table + grid faults (grid faults need a forest, which
    only the device backend owns), still combined with partitions, crashes
    and torn writes — the combination the round-4 verdict called out as
    never explored."""
    rng = random.Random(seed ^ 0x56303552)  # "V05R"
    opts: dict = {
        "replica_count": rng.randint(1, 6),
        "standby_count": rng.randint(0, 2),
        "n_clients": rng.randint(1, 8),
        "client_batch": rng.choice((1, 2, 4, 8, 16)),
        "crash_probability": rng.uniform(0.0, 0.004),
        "restart_ticks_max": rng.randint(40, 120),
        "wal_fault_probability": rng.uniform(0.0, 0.35),
        "torn_write_probability": rng.uniform(0.0, 0.35),
        "replies_fault_probability": rng.uniform(0.0, 0.25),
        "superblock_fault_probability": rng.uniform(0.0, 0.25),
        "options": PacketSimulatorOptions(
            one_way_delay_min=rng.randint(1, 2),
            one_way_delay_max=rng.randint(3, 10),
            packet_loss_probability=rng.uniform(0.0, 0.06),
            packet_replay_probability=rng.uniform(0.0, 0.06),
            partition_probability=rng.uniform(0.0, 0.012),
            unpartition_probability=rng.uniform(0.05, 0.4),
            partition_symmetry_probability=rng.uniform(0.3, 1.0),
        ),
        "workload_knobs": {
            "ledgers": rng.choice(((1,), (1, 2), (1, 2, 3))),
            "invalid_rate": rng.uniform(0.0, 0.3),
            "conflict_rate": rng.uniform(0.0, 0.4),
            "chain_rate": rng.uniform(0.0, 0.25),
            "two_phase_rate": rng.uniform(0.0, 0.4),
            "balancing_rate": rng.uniform(0.0, 0.2),
            "limit_account_rate": rng.uniform(0.0, 0.3),
        },
    }
    if rng.random() < device_fraction:
        from tigerbeetle_tpu_torch.constants import ConfigProcess

        # device-backend spill seed: the grid-fault atlas needs >= 2
        # replicas holding verifiable peer copies, and the compile-bound
        # device runs cap the tick budget and client count
        opts.update(
            backend_factory=None,
            replica_count=max(2, min(3, opts["replica_count"])),
            standby_count=0,
            n_clients=1,
            client_batch=24,
            ticks=300,
            grid_fault_probability=rng.uniform(0.05, 0.2),
            forest_blocks=192,
            grid_size=64 * 1024 * 1024,
            process=ConfigProcess(
                account_slots_log2=10, transfer_slots_log2=7,
                lsm_memtable_max=48,
            ),
            workload_knobs=dict(
                ledgers=(1,), invalid_rate=0.0,
                conflict_rate=rng.uniform(0.0, 0.05), chain_rate=0.0,
                two_phase_rate=rng.uniform(0.05, 0.15),
                balancing_rate=0.0, limit_account_rate=0.0,
            ),
        )
    return opts


def describe_options(opts: dict) -> str:
    """One-line topology/fault summary for fleet logs (replayability:
    the seed alone reproduces the draw, this line makes it legible)."""
    o = opts.get("options")
    backend = "device" if opts.get("backend_factory", "x") is None else "oracle"
    parts = [
        f"r{opts['replica_count']}+s{opts['standby_count']}",
        f"c{opts['n_clients']}x{opts['client_batch']}",
        backend,
        f"crash={opts['crash_probability']:.4f}",
        f"wal={opts['wal_fault_probability']:.2f}",
        f"torn={opts['torn_write_probability']:.2f}",
    ]
    if opts.get("grid_fault_probability"):
        parts.append(f"grid={opts['grid_fault_probability']:.2f}")
    if o is not None:
        parts.append(
            f"loss={o.packet_loss_probability:.3f}"
            f"/part={o.partition_probability:.4f}"
        )
    return " ".join(parts)
