"""IngressGateway: session tracking + load shedding in front of the replica.

The gateway wraps the replica's network handler (the same seam for the
TCP bus and the in-process/simulated transports): non-request traffic
(consensus, repair, sync) passes through at the cost of one byte
compare; request frames go through per-session sequence tracking and
the credit regulator. A request the pipeline cannot absorb is answered
with a typed `Command.busy` reply echoing the client + request number —
the client keeps the same bytes in flight and resends after backoff
(vsr/client.py `busy`), instead of timing out against a silent drop.

Session table: one tiny record per LOGICAL session (client id), not per
connection — many sessions share one TCP connection (the bus aliases
reply routing by client id; io/message_bus.py "Session multiplexing").
The record is (conn, last_request): small enough that 10k+ sessions
are a few MB and admission stays O(1).

Retransmits are never shed: a request at-or-below the session's
last-admitted number is either still in the pipeline (the replica
dedups it) or already executed (the replica resends the cached reply)
— both are cheap, and shedding one would stall a client's reply
recovery behind its backoff.
"""

from __future__ import annotations

from tigerbeetle_tpu_torch.io.message_bus import TCPMessageBus
from tigerbeetle_tpu_torch.ingress.regulator import CreditRegulator
from tigerbeetle_tpu_torch.latency import NULL_ANATOMY
from tigerbeetle_tpu_torch.vsr.header import HEADER_SIZE, Command, Header

# peeked header fields, layout-pinned at import by io/message_bus.py
_CMD_OFF = TCPMessageBus._CMD_OFF
_CLIENT_OFF = TCPMessageBus._CLIENT_OFF
_REQUEST_OFF = TCPMessageBus._REQUEST_OFF
_OP_OFF = TCPMessageBus._OP_OFF
_CMD_REQUEST = int(Command.request)


class _Session:
    __slots__ = ("conn", "last_request")

    def __init__(self, conn=None, last_request: int = 0):
        self.conn = conn  # bus connection currently routing this session
        self.last_request = last_request  # highest ADMITTED request number


class IngressGateway:
    def __init__(self, network, replica, sessions_max: int = 0,
                 regulator: CreditRegulator | None = None):
        self.network = network
        self.replica = replica
        # 0 = unbounded here (the replica's clients_max eviction still
        # caps the replicated table; the gateway cap sheds BEFORE an
        # eviction storm instead of after)
        self.sessions_max = sessions_max
        self.regulator = regulator or CreditRegulator(
            replica, pool=getattr(network, "pool", None)
        )
        self.sessions: dict[int, _Session] = {}
        self._inner = None
        # latency anatomy bound once (one attr hop per frame instead of
        # two); harness replicas without one get the shared inert
        # instance
        self._latency = getattr(replica, "latency", None) or NULL_ANATOMY
        m = replica.metrics
        self._c_admitted = m.counter("ingress.admitted")
        self._c_shed = m.counter("ingress.shed")
        self._c_shed_sessions = m.counter("ingress.shed_sessions")
        self._c_retransmits = m.counter("ingress.retransmits")
        self._c_passthrough = m.counter("ingress.passthrough_backup")
        self._g_sessions = m.gauge("ingress.sessions")

    # -- install / uninstall (the handler-wrap seam) --

    def install(self) -> None:
        """Wrap the replica's attached handler. Call after replica.open()
        (the replica attaches at construction; open only recovers state).
        Also registers as the bus's ingress seam for session-alias and
        connection-close callbacks."""
        assert self._inner is None, "gateway already installed"
        handlers = self.network.handlers
        addr = self.replica.replica
        self._inner = handlers[addr]
        handlers[addr] = self.on_frame
        if hasattr(self.network, "ingress"):
            self.network.ingress = self
        self.replica.ingress_evict_hook = self.on_evict

    def uninstall(self) -> None:
        if self._inner is not None:
            self.network.handlers[self.replica.replica] = self._inner
            self._inner = None
            if getattr(self.network, "ingress", None) is self:
                self.network.ingress = None
            if self.replica.ingress_evict_hook is self.on_evict:
                self.replica.ingress_evict_hook = None

    # -- bus callbacks (TCP only; in-process transports never call) --

    def on_session(self, cid: int, conn) -> None:
        """The bus aliased `cid`'s reply routing to `conn` (first frame,
        or a reconnect taking over) — latest wins, like the alias."""
        sess = self.sessions.get(cid)
        if sess is not None:
            sess.conn = conn

    def on_evict(self, cid: int) -> None:
        """The replica evicted `cid` from its client table (register at
        clients_max). Track it: an evicted session on a still-open
        multiplexed connection would otherwise hold a table entry — and
        a sessions_max credit — until every session on that connection
        disconnects."""
        if self.sessions.pop(cid, None) is not None:
            self._g_sessions.set(len(self.sessions))

    def on_conn_close(self, conn) -> None:
        """Sessions routed over a closing connection leave the gateway
        table (re-admitted on reconnect); their replica client-table
        entries survive, so the session itself resumes where it was."""
        dropped = False
        for cid in getattr(conn, "sessions", ()):
            sess = self.sessions.get(cid)
            if sess is not None and sess.conn is conn:
                del self.sessions[cid]
                dropped = True
        if dropped:
            self._g_sessions.set(len(self.sessions))

    # -- the frame path --

    def on_frame(self, src, frame: bytes) -> None:
        if len(frame) < HEADER_SIZE or frame[_CMD_OFF] != _CMD_REQUEST:
            self._inner(src, frame)  # consensus/repair/sync: pass through
            return
        if not self.replica.is_primary:
            # Shed/busy interplay with client failover: the runtime's
            # timeout RE-TARGETS requests round-robin, so backups see a
            # spray of requests they will drop (not primary). Admitting
            # them would burn credits and grow this gateway's session
            # table from traffic it never serves; SHEDDING them would be
            # worse — a busy reply stamped with a stale view would tell
            # the client "alive, back off" about a replica that cannot
            # serve it, stalling failover behind the busy ladder. Pass
            # through untouched: the replica drops it, the client's
            # timeout walks on to the primary.
            self._c_passthrough.add()
            self._inner(src, frame)
            return
        cid = int.from_bytes(
            frame[_CLIENT_OFF : _CLIENT_OFF + 16], "little"
        )
        req = int.from_bytes(
            frame[_REQUEST_OFF : _REQUEST_OFF + 4], "little"
        )
        # Latency-anatomy arrival stamp (latency.py): the gateway is the
        # earliest point the process sees the request, so the sampled
        # request's ingress_admission leg starts HERE — covering gateway
        # admission plus the replica's dedup/backpressure checks. One
        # flag test per request frame while unsampled; a stamp consumed
        # by no record (this frame shed or deduped) goes stale and the
        # anatomy's freshness guard discards it.
        self._latency.arrive()
        sess = self.sessions.get(cid)
        if sess is None:
            # new logical session (its register — or the first frame the
            # gateway sees from a session established before install)
            if (
                self.sessions_max
                and len(self.sessions) >= self.sessions_max
                and not self._reclaim_dead()
            ):
                self._c_shed_sessions.add()
                self._shed(cid, req, frame[_OP_OFF])
                return
            if not self.regulator.try_admit():
                self._shed(cid, req, frame[_OP_OFF])
                return
            conns = getattr(self.network, "conns", None)
            self.sessions[cid] = _Session(
                conn=conns.get(cid) if conns is not None else None,
                last_request=req,
            )
            self._g_sessions.set(len(self.sessions))
            self._c_admitted.add()
            self._inner(src, frame)
            return
        if req <= sess.last_request:
            self._c_retransmits.add()
            self._inner(src, frame)  # never shed a retransmit
            return
        if not self.regulator.try_admit():
            self._shed(cid, req, frame[_OP_OFF])
            return
        sess.last_request = req
        self._c_admitted.add()
        self._inner(src, frame)

    def _reclaim_dead(self) -> bool:
        """O(1) insurance at the cap: if the OLDEST tracked session is no
        longer in the replica's client table (evicted before the gateway
        installed, or admitted over a transport that never reports conn
        closes), drop it and admit the newcomer in its place. One probe
        per full-table admission attempt — never a table scan."""
        oldest = next(iter(self.sessions), None)
        if oldest is None or oldest in self.replica.client_table:
            return False
        if (
            self.sessions[oldest].last_request == 0
            and self.replica.ingress_occupancy()[0]
        ):
            # absent from the client table, but its register (request 0)
            # may still be in the commit pipeline — not provably dead
            return False
        del self.sessions[oldest]
        return True

    def _shed(self, cid: int, req: int, operation: int) -> None:
        """Typed refusal: busy echoes the client + request (+ operation,
        for the client's own bookkeeping). A reply the pool cannot carry
        is dropped — the client's retry timeout still covers it."""
        self._c_shed.add()
        h = Header(
            command=int(Command.busy),
            client=cid,
            request=req,
            operation=operation,
        )
        # replica._send stamps replica/view/cluster + checksums — the
        # same wire discipline every other reply leaves with
        self.replica._send(cid, h)
