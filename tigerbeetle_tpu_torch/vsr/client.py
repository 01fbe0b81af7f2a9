"""The native session client (reference: src/vsr/client.zig:17-80).

Protocol: register a session (an op committed through the cluster), then
one in-flight request at a time, each with a monotonically increasing
request number; the session number rides in `context` so the cluster can
evict stale sessions; replies are matched by request number. Retries resend
the SAME message bytes (idempotent via the replicated client table).

Fault-tolerant runtime (the reference's request/ping timeout state
machine, src/vsr/client.zig request_timeout/ping_timeout): the client is
TICK-driven through the same deterministic time seam the replica uses —
the simulator advances it with sim ticks, live drivers map wall clock
onto ticks with `WallTicker` — so every retry/backoff/failover decision
is reproducible under a seed and none of them needs driver code:

- request timeout: exponential backoff with deterministic jitter (the
  rng is seeded from the client id), resends RE-TARGETED round-robin
  across the replicas — after a primary crash the retry ladder walks the
  cluster until a replica in the new view answers, instead of hammering
  the dead primary forever;
- typed `busy` sheds back off on a DECORRELATED-jitter ladder distinct
  from the loss ladder (a shed is proof the replica is alive — the retry
  goes back to the same primary, and the loss timer re-arms rather than
  compounding);
- ping/pong view discovery while idle (`ping_client`/`pong_client`):
  an idle client learns a view change before its next request, so the
  first send targets the new primary;
- per-request deadlines surface a typed `RequestTimeout` from the wait
  path (poll/take_reply) instead of retrying forever;
- eviction surfaces a typed `SessionEvicted` from the wait path (the
  old behavior was a silent `evicted` flag and a request dropped on the
  floor), with opt-in automatic re-registration (`auto_reregister`) for
  fleets that should ride through client-table pressure.

Legacy drivers that never tick keep working: `resend()` and the
`reply`/`busy` fields behave exactly as before.

The port's copy of `tigerbeetle_tpu/vsr/client.py`, the same code with its imports
pointed at this package.
"""

from __future__ import annotations

import random

from tigerbeetle_tpu_torch.io.network import Network
from tigerbeetle_tpu_torch.metrics import NULL_METRICS
from tigerbeetle_tpu_torch.types import Operation
from tigerbeetle_tpu_torch.vsr.header import HEADER_SIZE, Command, Header


class ClientError(Exception):
    """Base of the typed client-runtime errors."""


class SessionEvicted(ClientError):
    """The cluster evicted this session from its client table (register
    pressure at clients_max, or a request carried a stale session). Any
    in-flight request's fate is UNKNOWN — it may or may not have
    committed before the eviction — so the runtime never silently
    retries it under a new session (that could execute it twice)."""

    def __init__(self, client_id: int, request: int | None):
        self.client_id = client_id
        self.request = request  # None: evicted while idle
        super().__init__(
            f"session evicted (client {client_id:#x}"
            + (f", request {request} in flight)" if request is not None
               else ", idle)")
        )


class RequestTimeout(ClientError):
    """The in-flight request exceeded its per-request deadline. The
    request is dropped (retries stop); like eviction, its fate is
    unknown — a caller that re-issues the same EVENTS under a new
    request number risks double execution, re-issuing the same request
    bytes is safe but the deadline already said it took too long."""

    def __init__(self, client_id: int, request: int, ticks: int):
        self.client_id = client_id
        self.request = request
        self.ticks = ticks
        super().__init__(
            f"request {request} deadline after {ticks} ticks "
            f"(client {client_id:#x})"
        )


class Timeout:
    """Tick-driven retry timer: exponential backoff with deterministic
    jitter (reference: src/vsr.zig Timeout.backoff/exponential_backoff_
    with_jitter). The duration is drawn ONCE per arm — base * 2^attempts
    plus up to 50% jitter from the client's seeded rng — so firing is a
    cheap integer compare and the same seed replays the same ladder."""

    __slots__ = ("after", "rng", "ticks", "attempts", "ticking",
                 "duration", "max_exponent")

    def __init__(self, after: int, rng: random.Random, max_exponent: int = 4):
        self.after = after
        self.rng = rng
        self.max_exponent = max_exponent
        self.ticks = 0
        self.attempts = 0
        self.ticking = False
        self.duration = after

    def _arm(self) -> None:
        base = self.after << min(self.attempts, self.max_exponent)
        self.duration = base + self.rng.randrange(base // 2 + 1)
        self.ticks = 0

    def start(self) -> None:
        self.ticking = True
        self.attempts = 0
        self._arm()

    def stop(self) -> None:
        self.ticking = False
        self.ticks = 0
        self.attempts = 0

    def rearm(self) -> None:
        """Restart the current attempt without climbing the ladder (a
        busy shed proved the path alive — the loss backoff must not
        compound on top of the busy backoff)."""
        if self.ticking:
            self._arm()

    def backoff(self) -> None:
        """After a fire: climb the ladder and re-arm."""
        self.attempts += 1
        self._arm()

    def tick(self) -> None:
        if self.ticking:
            self.ticks += 1

    def fired(self) -> bool:
        return self.ticking and self.ticks >= self.duration


class BusyBackoff:
    """Decorrelated-jitter backoff for typed busy sheds (next = min(cap,
    uniform(base, prev * 3)) — the AWS "decorrelated jitter" shape):
    sustained shed storms spread retries out instead of synchronizing
    them, and the ladder is DISTINCT from the loss timeout's exponential
    one (a shed is backpressure, not loss)."""

    __slots__ = ("rng", "base", "cap", "prev")

    def __init__(self, rng: random.Random, base: int = 2, cap: int = 64):
        self.rng = rng
        self.base = base
        self.cap = cap
        self.prev = 0

    def next_delay(self) -> int:
        hi = max(self.base + 1, self.prev * 3)
        self.prev = min(self.cap,
                        self.base + self.rng.randrange(hi - self.base + 1))
        return self.prev

    def reset(self) -> None:
        self.prev = 0


class Client:
    def __init__(self, client_id: int, network: Network, replica_count: int,
                 cluster_id: int = 0,
                 request_timeout_ticks: int = 30,
                 ping_ticks: int = 50,
                 deadline_ticks: int = 0,
                 auto_reregister: bool = False,
                 max_backoff_exponent: int = 4,
                 metrics=None):
        self.client_id = client_id
        self.network = network
        self.replica_count = replica_count
        self.cluster_id = cluster_id
        self.session = 0
        self.request_number = 0
        self.view = 0  # best-known view (updates from replies/pongs/busy)
        self.reply: tuple[Header, bytes] | None = None
        self.evicted = False
        self.in_flight: bytes | None = None
        # Load-shed signal (Command.busy from the ingress gateway): the
        # in-flight request was REFUSED, not lost — back off and resend.
        # The tick runtime consumes it itself; non-ticking drivers read
        # the flag and resend() after their own backoff, as before.
        self.busy = False
        self.busy_replies = 0
        # typed error surfaced by poll()/take_reply() (the wait path):
        # SessionEvicted or RequestTimeout
        self.error: ClientError | None = None
        # -- tick runtime state (all deterministic: the jitter rng is
        # seeded from the client id, time is injected ticks) --
        self.ticks = 0
        self.rng = random.Random(client_id ^ 0xC11E47)
        self.request_timeout = Timeout(
            request_timeout_ticks, self.rng,
            max_exponent=max_backoff_exponent,
        )
        self.busy_backoff = BusyBackoff(self.rng)
        self.ping_ticks = ping_ticks
        self.deadline_ticks = deadline_ticks
        self.auto_reregister = auto_reregister
        self._deadline_at = 0  # tick the in-flight request dies at (0: none)
        self._busy_at = 0  # tick the consumed busy shed resends at (0: none)
        self._retargets = 0  # timeout fires for THIS request (round-robin)
        self._inflight_op = 0  # operation byte of the in-flight request
        self._next_ping = 0  # idle-ping schedule (0: not scheduled)
        self._want_reregister = False
        m = metrics or NULL_METRICS
        self.metrics = m
        self._c_timeouts = m.counter("client.timeouts")
        self._c_resends = m.counter("client.resends")
        self._c_retargets = m.counter("client.retargets")
        self._c_busy = m.counter("client.busy_sheds")
        self._c_pings = m.counter("client.pings")
        self._c_pongs = m.counter("client.pongs")
        self._c_evictions = m.counter("client.evictions")
        self._c_reregisters = m.counter("client.reregisters")
        self._c_deadlines = m.counter("client.deadline_timeouts")
        self._c_stale = m.counter("client.stale_replies")
        network.attach(client_id, self._on_message)

    @property
    def primary_index(self) -> int:
        return self.view % self.replica_count

    def _on_message(self, src, data: bytes) -> None:
        header = Header.from_bytes(data[:HEADER_SIZE])
        if not header.valid_checksum():
            return
        body = data[HEADER_SIZE : header.size]
        if not header.valid_checksum_body(body):
            return
        if header.command == Command.eviction:
            self._on_eviction(header)
            return
        if header.command == Command.pong_client:
            # idle view discovery: the pong carries the replica's view, so
            # the next request targets the current primary
            self.view = max(self.view, header.view)
            self._c_pongs.add()
            return
        if header.command == Command.busy:
            # Strictly current-or-ignored: a busy is only meaningful for
            # the request that is IN FLIGHT right now, matched by request
            # number AND operation. Anything else (late busy for a taken
            # reply, a previous incarnation's register, a re-ordered
            # shed) is dropped with NO counter and NO flag — a stale shed
            # must not re-arm backoff against a request it never named.
            if (
                self.in_flight is None
                or header.request != self.request_number
                or header.operation != self._inflight_op
            ):
                return
            self.view = max(self.view, header.view)
            self.busy = True
            self.busy_replies += 1
            self._c_busy.add()
            # the shed proves the path is alive: the loss ladder restarts
            # (the busy ladder owns the retry; see tick())
            self.request_timeout.rearm()
            return
        if header.command != Command.reply:
            return
        if self.in_flight is None:
            # nothing awaiting: a duplicate of an already-taken reply.
            # Register replies in particular always carry request=0 and
            # request_number stays 0 after registration, so a late
            # duplicate (a shed-then-retried register racing the cached
            # resend) would otherwise be accepted and sit in `reply` to
            # be misread as the answer to the NEXT request.
            self._c_stale.add()
            return
        if header.request != self.request_number:
            self._c_stale.add()
            return  # stale reply
        self.view = max(self.view, header.view)
        self.in_flight = None
        self.busy = False
        self._busy_at = 0
        self._deadline_at = 0
        self._retargets = 0
        self.request_timeout.stop()
        self.busy_backoff.reset()
        self.reply = (header, body)

    def _on_eviction(self, header: Header) -> None:
        self.view = max(self.view, header.view)
        self.evicted = True
        self._c_evictions.add()
        inflight_request = (
            self.request_number if self.in_flight is not None else None
        )
        # the in-flight request's fate is unknown: never auto-retry it
        # under a new session (double-execution hazard) — surface it
        self.in_flight = None
        self.busy = False
        self._busy_at = 0
        self._deadline_at = 0
        self.request_timeout.stop()
        if inflight_request is not None or not self.auto_reregister:
            self.error = SessionEvicted(self.client_id, inflight_request)
        if self.auto_reregister:
            # the next tick re-registers (a fresh session; callers see
            # the error for the dropped request, then the session works).
            # session drops to 0 NOW: a driver gating on `session != 0`
            # must fall into its register-pending path instead of issuing
            # one more request under the dead session in the window
            # before the tick runs (the replica would evict it again).
            # Non-auto clients keep the stale value — legacy drivers
            # probe the dead session deliberately and read `evicted`.
            self.session = 0
            self._want_reregister = True

    # -- requests (the pump is external: network.run() / bus.pump()) --

    def register(self) -> None:
        assert self.session == 0 and self.in_flight is None
        self.request_number = 0
        h = Header(
            command=int(Command.request),
            operation=int(Operation.register),
            client=self.client_id,
            request=0,
            cluster=self.cluster_id,
        )
        self._send(h, b"")

    def request(self, operation: Operation, body: bytes) -> None:
        if self.error is not None:
            self.poll()  # unconsumed typed error: surface it, not assert
        assert self.session != 0, "register first"
        assert self.in_flight is None, "one in-flight request per client"
        self.request_number += 1
        h = Header(
            command=int(Command.request),
            operation=int(operation),
            client=self.client_id,
            context=self.session,
            request=self.request_number,
            cluster=self.cluster_id,
        )
        self._send(h, body)

    def _send(self, header: Header, body: bytes) -> None:
        header.set_checksum_body(body)
        header.set_checksum()
        self.in_flight = header.to_bytes() + body
        self._inflight_op = header.operation
        self.busy = False
        self._busy_at = 0
        self._retargets = 0
        self.request_timeout.start()
        self.busy_backoff.reset()
        self._deadline_at = (
            self.ticks + self.deadline_ticks if self.deadline_ticks else 0
        )
        self.network.send(self.client_id, self.primary_index, self.in_flight)

    def _reregister(self) -> None:
        """Post-eviction automatic re-registration: a fresh session under
        the same client id (the replicated table committed the eviction,
        so the register commits a brand-new entry)."""
        self._want_reregister = False
        self.session = 0
        self.evicted = False
        self._c_reregisters.add()
        self.register()

    def resend(self) -> None:
        """Retry the in-flight request. Broadcast to every replica: after a
        view change the client may not know the new primary yet; replicas
        that are not the primary ignore requests. Legacy seam for drivers
        that run their own retry clocks — the tick runtime uses the
        round-robin single-target resend instead (cheaper, and it walks
        the cluster deterministically)."""
        assert self.in_flight is not None
        self.busy = False
        self._busy_at = 0
        self.request_timeout.rearm()
        self._c_resends.add(self.replica_count)
        for r in range(self.replica_count):
            self.network.send(self.client_id, r, self.in_flight)

    # -- the tick-driven runtime --

    def tick(self) -> None:
        """One virtual-time step: fire timeouts, consume busy sheds,
        enforce deadlines, ping while idle. The simulator calls this once
        per sim tick; live drivers map wall time onto it (WallTicker)."""
        self.ticks += 1
        if self._want_reregister and self.in_flight is None:
            self._reregister()
            return
        if self.in_flight is None:
            if (
                self.ping_ticks
                and self.session
                and not self.evicted
                and self.error is None
            ):
                if self._next_ping == 0:
                    # first idle tick: schedule with a jittered phase so a
                    # fleet's pings spread instead of synchronizing
                    self._next_ping = (
                        self.ticks + self.rng.randrange(self.ping_ticks) + 1
                    )
                elif self.ticks >= self._next_ping:
                    self._next_ping = self.ticks + self.ping_ticks
                    self._send_ping()
            return
        self._next_ping = 0
        if self._deadline_at and self.ticks >= self._deadline_at:
            self._c_deadlines.add()
            self.error = RequestTimeout(
                self.client_id, self.request_number,
                self.ticks - (self._deadline_at - self.deadline_ticks),
            )
            self.in_flight = None
            self.busy = False
            self._busy_at = 0
            self._deadline_at = 0
            self.request_timeout.stop()
            return
        if self.busy and self._busy_at == 0:
            # consume the shed: schedule the resend on the busy ladder
            self._busy_at = self.ticks + self.busy_backoff.next_delay()
        if self._busy_at:
            if self.ticks >= self._busy_at:
                self._busy_at = 0
                self.busy = False
                self._c_resends.add()
                # a shed came FROM the primary (or named its view): retry
                # there, no retarget — the replica is alive, just loaded
                self.network.send(
                    self.client_id, self.primary_index, self.in_flight
                )
                self.request_timeout.rearm()
            return
        self.request_timeout.tick()
        if self.request_timeout.fired():
            self.request_timeout.backoff()
            self._c_timeouts.add()
            self._c_resends.add()
            # Round-robin re-target (reference: on_request_timeout sends
            # to view + attempts): fire k tries primary + k, so a dead
            # primary costs one fire before the retry walks the cluster
            # and finds a replica that answers (or forwards the view).
            self._retargets += 1
            dst = (self.primary_index + self._retargets) % self.replica_count
            if dst != self.primary_index:
                self._c_retargets.add()
            self.network.send(self.client_id, dst, self.in_flight)

    def _send_ping(self) -> None:
        """Idle view discovery: ping every replica; each normal replica
        answers pong_client stamped with its view (reference:
        src/vsr/client.zig on_ping_timeout pings the whole cluster)."""
        self._c_pings.add()
        h = Header(
            command=int(Command.ping_client),
            client=self.client_id,
            cluster=self.cluster_id,
        )
        h.set_checksum_body(b"")
        h.set_checksum()
        wire = h.to_bytes()
        for r in range(self.replica_count):
            self.network.send(self.client_id, r, wire)

    # -- the wait path --

    def poll(self) -> None:
        """Raise the pending typed error (SessionEvicted/RequestTimeout),
        if any — THE wait-path check: drivers spinning on `reply is None`
        call this each turn so a dead request surfaces instead of
        spinning forever. The error is consumed by raising."""
        if self.error is not None:
            err, self.error = self.error, None
            raise err

    @property
    def done(self) -> bool:
        """True when a reply is ready OR a typed error is pending (the
        wait loop's exit condition; take_reply/poll then resolves it)."""
        return self.reply is not None or self.error is not None

    def take_reply(self) -> tuple[Header, bytes]:
        if self.reply is None:
            self.poll()  # surface the typed error from the wait path
        assert self.reply is not None, "no reply pending"
        header, body = self.reply
        self.reply = None
        if header.operation == int(Operation.register):
            self.session = int.from_bytes(body[:8], "little")
        return header, body


class WallTicker:
    """Map wall time onto client ticks for LIVE drivers: advance(now)
    runs the tick runtime at tick_s cadence. The burst after a driver
    stall is BOUNDED so a paused process resumes with one retry, not a
    retry storm; the client itself never reads a clock (the seam stays
    deterministic — sim code drives tick() directly)."""

    __slots__ = ("client", "tick_s", "_last", "max_burst")

    def __init__(self, client: Client, tick_s: float = 0.01,
                 max_burst: int = 8):
        self.client = client
        self.tick_s = tick_s
        self._last = None
        self.max_burst = max_burst

    def advance(self, now: float) -> None:
        if self._last is None:
            self._last = now
            return
        n = int((now - self._last) / self.tick_s)
        if n <= 0:
            return
        self._last += n * self.tick_s
        for _ in range(min(n, self.max_burst)):
            self.client.tick()


# the counters every Client binds (pinned against the CATALOG by
# tests/test_metrics.py so the name set cannot drift)
CLIENT_METRIC_NAMES = (
    "client.timeouts", "client.resends", "client.retargets",
    "client.busy_sheds", "client.pings", "client.pongs",
    "client.evictions", "client.reregisters", "client.deadline_timeouts",
    "client.stale_replies",
)
