"""Production transport: the TCP message bus.

The reference's MessageBus (reference: src/message_bus.zig:24-70): replicas
listen on configured addresses and connect to each other; clients connect
in; messages are 128-byte-Header-framed (size from the header, checksums
validated by the receiver), with per-connection buffers and reconnect.

This implements the same Network seam as the in-process fakes, so the
Replica and Client run unchanged over real sockets. Non-blocking sockets
pumped by the process event loop (`pump()` ~ the reference's io.run_for_ns
tick, reference: src/tigerbeetle/main.zig start loop).

Replica-to-replica links: the replica with the LOWER index connects, the
higher accepts (a deterministic direction avoids duplicate links). Client
links: clients connect in; the bus learns the client id from the first
frame and routes replies back over the same connection.

Ingress extensions (tigerbeetle_tpu/ingress — the 10k-session front door):

- **Session multiplexing**: every request frame's client id is aliased to
  the connection it arrived on, so many logical sessions share one TCP
  connection and replies route per-session (`conns[client_id] -> conn`).
  The one-connection-per-client path is the degenerate single-session
  case (the alias equals the connection's hello peer). Aliases are
  latest-wins: a session reconnecting on a new connection takes its
  routing with it.
- **Fair pumping**: frames dispatched per connection per pump turn are
  bounded by `dispatch_budget`; leftovers stay buffered and the
  connection joins the hot list, drained FIRST next turn — one firehose
  peer cannot starve the rest of the loop. A trickling (slow-loris) peer
  never forms a frame and costs one bounded recv per readiness event.
- **Accept drain**: one readiness event accepts up to `accept_budget`
  pending connections behind a configurable `listen_backlog` — a connect
  storm of hundreds no longer lands one accept per select round.
- **Typed shed outcomes**: `send()` returns "sent" | "shed_conn" |
  "shed_pool" | "unreachable" and counts refusals into the ingress.*
  metrics instead of dropping silently; pool budget held by a closing
  connection is always credited back (churned clients cannot leak it).
- **Slow-peer defense**: a CLIENT connection whose send queue stays at
  its cap (open socket, never reads) accumulates strikes and is
  disconnected after `wedged_strikes_max` consecutive refusals —
  replica links are exempt (VSR owns their retry discipline).
- **Reconnect with backoff**: a lost or refused dial arms a per-replica
  backoff (50ms doubling to 2s, reset on success); sends inside the
  window return "unreachable" without burning a dial, the first send
  after it re-dials. Reconnection is LAZY — the retry that triggers the
  send is the client runtime's timeout (vsr/client.py) or VSR's own
  retransmits, so a restarted replica's clients re-attach without any
  harness code. Multiplexed (demux) sessions re-alias on the new
  connection automatically: the server re-learns each session's routing
  from the first request (or client ping) frame it sends there.

The port's copy of `tigerbeetle_tpu/io/message_bus.py`, the same code over
the port's `io/network.py`, `metrics.py`, `tracer.py` and `vsr/header.py`:
its frames on the socket are the JAX package's, so a port server and a JAX
client (or the other way round) talk to each other.
"""

from __future__ import annotations

import errno
import selectors
import socket
import time as _time

from tigerbeetle_tpu_torch.io.network import Address, Handler, Network
from tigerbeetle_tpu_torch.metrics import NULL_METRICS
from tigerbeetle_tpu_torch.tracer import NULL_TRACER
from tigerbeetle_tpu_torch.vsr.header import HEADER_SIZE, Command, Header, trace_id

MESSAGE_SIZE_MAX_DEFAULT = 1 << 20


class MessagePool:
    """Fixed send-buffer accounting (reference: src/message_pool.zig:18-41
    — the pool is sized exactly from worst-case concurrent use, and
    exhaustion is BACKPRESSURE, not allocation): sends that would exceed
    the budget are refused, which is safe for every VSR message class
    (the protocol retransmits on its timeouts). Exhaustion is a TYPED
    outcome (the bus counts it in ingress.shed_pool and its send()
    returns "shed_pool"), never a silent drop."""

    def __init__(self, messages_max: int = 64,
                 message_size_max: int = MESSAGE_SIZE_MAX_DEFAULT):
        self.capacity = messages_max * message_size_max
        self.used = 0
        self.dropped = 0  # observability: sends refused at the budget

    def try_charge(self, n: int) -> bool:
        if self.used + n > self.capacity:
            self.dropped += 1
            return False
        self.used += n
        return True

    def credit(self, n: int) -> None:
        self.used -= n
        assert self.used >= 0


class _Conn:
    __slots__ = (
        "sock", "peer", "connected", "rbuf", "roff", "wbuf",
        "sessions", "strikes", "pending_traces", "pending_lat",
    )

    def __init__(self, sock: socket.socket, peer: Address | None = None,
                 connected: bool = True):
        self.sock = sock
        self.peer = peer  # replica index / client id once known
        self.connected = connected  # False while a non-blocking dial pends
        self.rbuf = bytearray()
        self.roff = 0  # consumed-frame offset into rbuf (compacted per turn)
        self.wbuf = bytearray()
        # client ids whose reply routing aliases to this connection
        # (session multiplexing; empty for replica links)
        self.sessions: set[Address] = set()
        # consecutive sends refused at the per-connection cap: the
        # wedged-consumer disconnect counter (reset on flush progress)
        self.strikes = 0
        # tracing only: trace ids of reply frames queued in wbuf and not
        # yet flushed — PER CONNECTION, so a flush span is tagged with
        # exactly the replies that connection's write carried
        self.pending_traces: list[int] = []
        # latency-anatomy tokens of sampled replies queued in wbuf: the
        # flush that writes this conn finishes their records (the
        # reply_egress leg ends at the first socket write)
        self.pending_lat: list[int] = []


class TCPMessageBus(Network):
    # observability seams (re-pointed by the composition root; defaults
    # are the zero-cost no-op backends). `metrics` is a property so a
    # re-point rebinds the hot-path counters ONCE — per-event registry
    # lookups would tax exactly the overload paths (shed, accept storm)
    # the counters exist to observe.
    tracer = NULL_TRACER
    _metrics = NULL_METRICS
    # per-request latency anatomy (latency.py LatencyAnatomy), installed
    # by the composition root next to `defer_egress = True`: the replica
    # parks each sampled reply's record in `latency.pending_egress`
    # keyed by (client, context), send() claims it for the connection
    # that queues the reply frame, and the flush that writes the conn
    # closes the record (reply_egress = finalize -> first socket write)
    latency = None

    @property
    def metrics(self):
        return self._metrics

    @metrics.setter
    def metrics(self, m):
        self._metrics = m
        self._c_shed_conn = m.counter("ingress.shed_conn")
        self._c_disconnect_wedged = m.counter("ingress.disconnect_wedged")
        self._c_shed_pool = m.counter("ingress.shed_pool")
        self._c_accepts = m.counter("ingress.accepts")
        self._c_flushes = m.counter("bus.flushes")
        self._c_tx_bytes = m.counter("bus.tx_bytes")
        self._c_frames = m.counter("bus.frames")
        self._c_reconnects = m.counter("bus.reconnects")
        self._c_dial_failures = m.counter("bus.dial_failures")

    def __init__(
        self,
        addresses: list[tuple[str, int]],
        own_address: Address,
        listen: bool = False,
        message_size_max: int = MESSAGE_SIZE_MAX_DEFAULT,
        messages_max: int = 64,
        listen_backlog: int = 1024,
        accept_budget: int = 256,
        dispatch_budget: int = 256,
        wedged_strikes_max: int = 512,
        demux: bool = False,
    ):
        """addresses: replica index -> (host, port). own_address: our
        replica index, or our client id (clients don't listen).

        demux=True (client-side session multiplexing): inbound frames
        dispatch to the handler attached at the frame's CLIENT id, so N
        logical sessions' Clients share this one bus/connection — each
        attaches at its own id and sees only its own replies. The
        default routes everything to handlers[own] (one session per
        bus, the pre-ingress behavior)."""
        self.metrics = self._metrics  # bind the no-op counters until re-pointed
        self.addresses = addresses
        self.own = own_address
        self.demux = demux
        self.message_size_max = message_size_max
        self.pool = MessagePool(messages_max, message_size_max)
        # Per-connection send cap: one wedged peer (open socket, never
        # reads -> EAGAIN forever) must not consume the SHARED pool and
        # starve sends to the healthy quorum (the reference bounds per-
        # connection send queues the same way, src/message_bus.zig:24-70).
        self.conn_send_max = max(
            2, messages_max // max(2, len(addresses))
        ) * message_size_max
        self.accept_budget = accept_budget
        self.dispatch_budget = dispatch_budget
        self.wedged_strikes_max = wedged_strikes_max
        self.sel = selectors.DefaultSelector()
        self.handlers: dict[Address, Handler] = {}
        self.conns: dict[Address, _Conn] = {}  # peer/session -> connection
        # identity set of live connections: `conns` holds one entry PER
        # SESSION under multiplexing, so per-turn sweeps (flush) iterate
        # this instead of O(sessions) dict values
        self._links: dict[_Conn, None] = {}
        # connections with complete frames still buffered after their
        # dispatch budget ran out — drained first next pump turn
        self._hot: dict[_Conn, None] = {}
        # ingress gateway seam: notified of session aliasing and closes
        # (None when no gateway is installed — the pre-ingress behavior)
        self.ingress = None
        # Reconnect-with-backoff state, per dialed replica: a failed or
        # refused dial must not hot-loop SYNs at a dead peer (every send
        # would otherwise pay a socket+connect), and the window doubles
        # while the peer stays dead. replica -> [retry_at_monotonic,
        # current_delay_s]; absent = dial freely. `_was_connected` marks
        # replicas we reached at least once, so a successful re-dial
        # counts into bus.reconnects (first dials don't).
        self._dial_backoff: dict[int, list] = {}
        self._was_connected: set[int] = set()
        self.listener: socket.socket | None = None
        if listen:
            host, port = addresses[own_address]
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind((host, port))
            s.listen(listen_backlog)
            s.setblocking(False)
            self.listener = s
            self.sel.register(s, selectors.EVENT_READ, ("accept", None))

    # -- Network seam --

    def attach(self, addr: Address, handler: Handler) -> None:
        self.handlers[addr] = handler

    # Sends below this wbuf level defer their socket write to the pump
    # turn's flush: a window of replies coalesces into ONE send syscall
    # (and one TCP segment burst) instead of one per 128-byte reply — and
    # the clients' next requests then arrive together, which is what feeds
    # the replica's group-commit fusion.
    FLUSH_EAGER = 1 << 17

    def send(self, src: Address, dst: Address, data: bytes) -> str:
        """Queue `data` for `dst`. Returns the typed outcome: "sent",
        "shed_conn" (this peer's queue is capped), "shed_pool" (shared
        budget exhausted — backpressure, the protocol retransmits), or
        "unreachable". Existing callers may ignore the return value; the
        shed outcomes are also counted in the ingress.* metrics."""
        conn = self.conns.get(dst)
        if conn is None:
            if dst < len(self.addresses):
                conn = self._connect(dst)
            if conn is None:
                return "unreachable"  # VSR retransmits cover the loss
        if len(conn.wbuf) + len(data) > self.conn_send_max:
            self.pool.dropped += 1
            self._c_shed_conn.add()
            # Wedged-consumer defense: a CLIENT connection pinned at its
            # cap is not reading. Strikes accumulate per refused send and
            # reset whenever a flush makes progress; past the limit the
            # connection is cut (its sessions re-register on reconnect).
            # Replica links are exempt: consensus owns their retries.
            if conn.peer is None or conn.peer >= len(self.addresses):
                conn.strikes += 1
                if conn.strikes > self.wedged_strikes_max:
                    self._c_disconnect_wedged.add()
                    self._close(conn)
            return "shed_conn"  # drop for THIS peer, not for everyone
        if not self.pool.try_charge(len(data)):
            self._c_shed_pool.add()
            return "shed_pool"  # pool exhausted: backpressure
        conn.wbuf += data
        lat = self.latency
        if (
            lat is not None
            and lat.pending_egress
            and data[self._CMD_OFF] == _CMD_REPLY
        ):
            # sampled reply: claim its parked latency record for THIS
            # conn (the key re-derives from the frame bytes — client +
            # context — so no side channel rides the send path)
            tok = lat.pending_egress.pop(
                (
                    int.from_bytes(
                        data[self._CLIENT_OFF : self._CLIENT_OFF + 16],
                        "little",
                    ),
                    int.from_bytes(
                        data[self._CONTEXT_OFF : self._CONTEXT_OFF + 16],
                        "little",
                    ),
                ),
                None,
            )
            if tok is not None:
                conn.pending_lat.append(tok)
        if self.tracer.enabled and data[self._CMD_OFF] == _CMD_REPLY:
            # the op's egress hop: tag the flush that carries this reply
            # (tracked on the CONNECTION, so the tag lands on the flush
            # that actually writes this conn — never a neighbor's)
            conn.pending_traces.append(trace_id(
                int.from_bytes(
                    data[self._CLIENT_OFF : self._CLIENT_OFF + 16], "little"
                ),
                int.from_bytes(
                    data[self._CONTEXT_OFF : self._CONTEXT_OFF + 16],
                    "little",
                ),
            ))
        if len(conn.wbuf) >= self.FLUSH_EAGER:
            # large payloads start on the wire now; the eager flush
            # carries THIS conn's reply trace ids itself — left pending
            # they would mislabel the next flush_pending span
            if conn.pending_traces:
                traces, conn.pending_traces = conn.pending_traces, []
                with self.tracer.span("bus.flush", conns=1,
                                      traces=traces):
                    self._flush(conn)
            else:
                self._flush(conn)
        return "sent"

    def flush_pending(self) -> None:
        """Flush every connection's buffered sends (one syscall per conn
        per turn). pump() calls this on entry (so bytes queued between
        pumps never wait out a blocking select) and on exit (so sends
        queued by this turn's handlers leave with it)."""
        pending = [c for c in self._links if c.wbuf]
        if not pending:
            return
        self._c_flushes.add()
        traces: list[int] = []
        for conn in pending:
            if conn.pending_traces:
                traces.extend(conn.pending_traces)
                conn.pending_traces = []
        with self.tracer.span("bus.flush", conns=len(pending),
                              traces=traces):
            for conn in pending:
                self._flush(conn)

    # -- connections --

    DIAL_BACKOFF_MIN = 0.05  # first retry window after a failed dial
    DIAL_BACKOFF_MAX = 2.0  # ceiling while the peer stays dead

    def _dial_fail(self, replica: int) -> None:
        """A dial was refused/errored: arm (or double) the backoff window
        so sends stop paying a socket+SYN per attempt at a dead peer."""
        self._c_dial_failures.add()
        b = self._dial_backoff.get(replica)
        delay = self.DIAL_BACKOFF_MIN if b is None else min(
            self.DIAL_BACKOFF_MAX, b[1] * 2
        )
        self._dial_backoff[replica] = [_time.monotonic() + delay, delay]

    def _dial_ok(self, replica: int) -> None:
        self._dial_backoff.pop(replica, None)
        if replica in self._was_connected:
            self._c_reconnects.add()
        else:
            self._was_connected.add(replica)

    def _connect(self, replica: int) -> _Conn | None:
        # NON-BLOCKING dial: a blocked peer must never stall the event loop
        # (consensus for the live quorum would freeze for the TCP timeout).
        b = self._dial_backoff.get(replica)
        if b is not None and _time.monotonic() < b[0]:
            return None  # inside the backoff window: don't burn a dial
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setblocking(False)
        try:
            rc = s.connect_ex(self.addresses[replica])
        except OSError:
            s.close()
            self._dial_fail(replica)
            return None
        if rc not in (0, errno.EINPROGRESS, errno.EWOULDBLOCK):
            s.close()
            self._dial_fail(replica)
            return None
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        conn = _Conn(s, peer=replica, connected=(rc == 0))
        if rc == 0:
            self._dial_ok(replica)
        self.conns[replica] = conn
        self._links[conn] = None
        self.sel.register(
            s, selectors.EVENT_READ | selectors.EVENT_WRITE, ("conn", conn)
        )
        # identify ourselves so the acceptor can route replies (clients in
        # the u128 `client` field; replicas in the u8 `replica` field)
        hello = Header()
        if self.own < len(self.addresses):
            hello.replica = self.own
        else:
            hello.client = self.own
        hello.set_checksum_body(b"")
        hello.set_checksum()
        frame = hello.to_bytes()
        self.pool.used += len(frame)  # mandatory frame: charge unconditionally
        conn.wbuf += frame
        self._flush(conn)
        return conn

    def _accept(self) -> None:
        """Drain the accept queue: up to accept_budget pending connections
        per readiness event (a connect storm of hundreds used to land ONE
        accept per select round and stall for seconds)."""
        assert self.listener is not None
        for _ in range(self.accept_budget):
            try:
                s, _addr = self.listener.accept()
            except OSError:
                return
            s.setblocking(False)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn = _Conn(s)
            self._links[conn] = None
            self.sel.register(s, selectors.EVENT_READ, ("conn", conn))
            self._c_accepts.add()

    def _close(self, conn: _Conn) -> None:
        try:
            self.sel.unregister(conn.sock)
        except (KeyError, ValueError):
            pass
        conn.sock.close()
        self.pool.credit(len(conn.wbuf))  # unsent bytes return to the pool
        conn.wbuf.clear()
        if conn.pending_lat:
            # replies that never reached the wire: drop their records
            # (an egress stamp here would fabricate a latency)
            if self.latency is not None:
                for tok in conn.pending_lat:
                    self.latency.discard(tok)
            conn.pending_lat.clear()
        self._hot.pop(conn, None)
        self._links.pop(conn, None)
        # the gateway sees the close FIRST, while conn.sessions still
        # names the sessions routed here (it drops their table entries)
        if self.ingress is not None:
            self.ingress.on_conn_close(conn)
        # drop every routing entry aliased here (sessions + hello peer):
        # a reconnect re-learns them from its first frames
        for cid in conn.sessions:
            if self.conns.get(cid) is conn:
                del self.conns[cid]
        conn.sessions.clear()
        if conn.peer is not None and self.conns.get(conn.peer) is conn:
            del self.conns[conn.peer]

    def _flush(self, conn: _Conn) -> None:
        if not conn.connected:
            return  # dial still in progress; flushed on writability
        self._flush_io(conn)
        if conn.pending_lat:
            # reply_egress closes at the flush that first attempts the
            # socket write (a partial write still counts: the reply's
            # bytes started onto the wire with this syscall)
            lat = self.latency
            if lat is not None:
                for tok in conn.pending_lat:
                    lat.finish(tok)
            conn.pending_lat.clear()

    def _flush_io(self, conn: _Conn) -> None:
        while conn.wbuf:
            try:
                n = conn.sock.send(conn.wbuf)
            except OSError as e:
                if e.errno in (errno.EAGAIN, errno.EWOULDBLOCK):
                    return
                self._close(conn)
                return
            if n <= 0:
                return
            del conn.wbuf[:n]
            conn.strikes = 0  # the peer is reading again
            self.pool.credit(n)
            self._c_tx_bytes.add(n)

    # -- pumping --

    def pump(self, timeout: float = 0.01) -> int:
        """One event-loop turn: accept/read/dispatch. Returns frames
        dispatched. Hot connections (frames buffered past their budget
        last turn) are drained FIRST, before the select — fairness is
        round-robin across turns, not starvation of the patient."""
        dispatched = 0
        t0 = _time.perf_counter_ns() if self.metrics.enabled else 0
        self.flush_pending()  # deferred sends must not wait out the select
        if self._hot:
            timeout = 0.0  # buffered work exists: never block the select
            hot, self._hot = self._hot, {}
            for conn in hot:
                dispatched += self._drain(conn)
        for key, mask in self.sel.select(timeout):
            kind, conn = key.data
            if kind == "accept":
                self._accept()
                continue
            if mask & selectors.EVENT_WRITE and not conn.connected:
                # pending dial resolved: success or failure
                err = conn.sock.getsockopt(socket.SOL_SOCKET, socket.SO_ERROR)
                if err != 0:
                    if conn.peer is not None:
                        self._dial_fail(conn.peer)
                    self._close(conn)
                    continue
                if conn.peer is not None:
                    self._dial_ok(conn.peer)
                conn.connected = True
                self.sel.modify(
                    conn.sock, selectors.EVENT_READ, ("conn", conn)
                )
                self._flush(conn)
            if not (mask & selectors.EVENT_READ):
                continue
            # Drain the socket buffer in one turn (a 1 MiB batch frame
            # spans many TCP segments; one recv per select round would cap
            # ingest at 64 KiB per event-loop turn). Bounded so one
            # firehose peer can't starve the rest of the loop. On FIN or
            # error, buffered frames STILL dispatch before the close —
            # a one-shot client may send its request and close.
            closing = False
            for _ in range(64):
                try:
                    chunk = conn.sock.recv(1 << 18)
                except OSError as e:
                    if e.errno not in (errno.EAGAIN, errno.EWOULDBLOCK):
                        closing = True
                    break
                if not chunk:
                    closing = True
                    break
                conn.rbuf += chunk
                if len(chunk) < (1 << 18):
                    break
            dispatched += self._drain(conn)
            if closing:
                self._close(conn)
        self.flush_pending()  # this turn's handler sends leave with it
        if dispatched and t0:
            # only turns that dispatched frames: idle selects would bury
            # the signal (and cost a histogram write per quiet turn)
            self._c_frames.add(dispatched)
            self.metrics.histogram("bus.pump_us").observe(
                (_time.perf_counter_ns() - t0) / 1000.0
            )
        return dispatched

    # Peeked header fields (framing + session aliasing read a handful of
    # bytes instead of parsing the full header — that parse, and the
    # checksum, belong to the handler): five u128s (80) + four u32s (16) +
    # three u64s (24) = size u32 at 120; client u128 at 48 (after
    # checksum, checksum_body, parent); request u32 at 80; command u8 at
    # 125. All cross-checked against Header at import.
    _SIZE_OFF = 120
    _CLIENT_OFF = 48
    _CONTEXT_OFF = 64  # context u128 (request checksum on reply frames)
    _REQUEST_OFF = 80
    _CMD_OFF = 125
    _OP_OFF = 126  # `operation` u8

    def _drain(self, conn: _Conn, budget: int | None = None) -> int:
        n = 0
        budget = self.dispatch_budget if budget is None else budget
        buf = conn.rbuf
        # frame-parse span: only when there is at least one parseable
        # frame AND tracing is on (pump calls _drain for every readable
        # conn; empty passes must stay free)
        tok = (
            self.tracer.start("bus.frame_parse")
            if self.tracer.enabled and len(buf) - conn.roff >= HEADER_SIZE
            else 0
        )
        # cluster-causal ingress anchor: the trace ids of the request
        # frames this parse pass dispatches (annotated onto the span at
        # the end — the ids are learned frame by frame)
        parse_traces: list[int] = [] if tok else None
        mv = memoryview(buf)
        try:
            while len(buf) - conn.roff >= HEADER_SIZE:
                if n >= budget:
                    # fairness: this peer used its turn; remaining frames
                    # stay buffered and the conn drains first next turn
                    self._hot[conn] = None
                    break
                o = conn.roff + self._SIZE_OFF
                size = int.from_bytes(mv[o : o + 4], "little")
                if size < HEADER_SIZE or size > self.message_size_max:
                    mv.release()
                    self._close(conn)  # corrupt framing: drop the conn
                    return n
                if len(buf) - conn.roff < size:
                    break
                frame = bytes(mv[conn.roff : conn.roff + size])
                conn.roff += size
                if conn.peer is None:
                    # first frame identifies the peer (hello or any
                    # message: the client field for clients, replica for
                    # replicas)
                    header = Header.from_bytes(frame[:HEADER_SIZE])
                    if not header.valid_checksum():
                        mv.release()
                        self._close(conn)
                        return n
                    peer = header.client if header.client else header.replica
                    conn.peer = peer
                    # Simultaneous dials create two links; keep the FIRST
                    # as canonical for sends (an overwrite would orphan
                    # its buffered partial frames) — this one stays
                    # readable.
                    if peer not in self.conns:
                        self.conns[peer] = conn
                    if header.client:
                        # the hello peer IS a session (the degenerate
                        # single-session case): track it like any alias
                        # so close/gateway bookkeeping is uniform
                        conn.sessions.add(peer)
                        if self.ingress is not None:
                            self.ingress.on_session(peer, conn)
                    if size == HEADER_SIZE and header.command == 0:
                        continue  # pure hello: consume
                # Session multiplexing: alias every request frame's client
                # id to this connection so the reply routes back here.
                # Latest-wins (a reconnecting session's new connection
                # takes over); the degenerate case — one session whose id
                # IS the hello peer — is a no-op dict hit.
                if frame[self._CMD_OFF] in (_CMD_REQUEST, _CMD_PING_CLIENT):
                    cid = int.from_bytes(
                        frame[self._CLIENT_OFF : self._CLIENT_OFF + 16],
                        "little",
                    )
                    # ping_client aliases too: an idle multiplexed session
                    # whose connection died re-attaches with its first
                    # ping — the pong must route over the NEW conn even
                    # before the session's next request re-aliases it
                    if cid and self.conns.get(cid) is not conn:
                        self._alias(cid, conn)
                    if frame[self._CMD_OFF] != _CMD_REQUEST:
                        cid = 0  # pings don't anchor trace ids
                    if parse_traces is not None and cid:
                        # ingress: the trace id is ASSIGNED here, from
                        # the request's own (client, checksum) pair
                        parse_traces.append(trace_id(
                            cid,
                            int.from_bytes(frame[0:16], "little"),
                        ))
                if self.demux:
                    # session-multiplexed client bus: route by the
                    # frame's client id (replies/busy/eviction all carry
                    # it), falling back to the bus's own handler
                    cid = int.from_bytes(
                        frame[self._CLIENT_OFF : self._CLIENT_OFF + 16],
                        "little",
                    )
                    handler = (
                        self.handlers.get(cid) or self.handlers.get(self.own)
                    )
                else:
                    handler = self.handlers.get(self.own)
                if handler is not None:
                    handler(conn.peer, frame)
                    n += 1
        finally:
            mv.release()
            if tok:
                if parse_traces:
                    self.tracer.annotate(tok, traces=parse_traces)
                self.tracer.stop(tok)
        # compact ONCE per turn (a del per frame moved the whole tail —
        # O(bytes) per 1 MiB batch frame — on every message)
        if conn.roff:
            if conn.roff == len(buf):
                buf.clear()
            else:
                del buf[: conn.roff]
            conn.roff = 0
        return n

    def drop_connections(self) -> None:
        """Fault-injection helper (chaos harness / tests): abruptly close
        every live connection with SO_LINGER=0, so the peer observes a
        RESET, not a graceful FIN. Recovery is the production path under
        test: the next send re-dials (with backoff), sessions re-alias,
        and the client runtime's timeouts retransmit what was in flight."""
        import struct as _struct

        for conn in list(self._links):
            try:
                conn.sock.setsockopt(
                    socket.SOL_SOCKET, socket.SO_LINGER,
                    _struct.pack("ii", 1, 0),
                )
            except OSError:
                pass
            self._close(conn)

    def _alias(self, cid: Address, conn: _Conn) -> None:
        old = self.conns.get(cid)
        if old is not None and old is not conn:
            old.sessions.discard(cid)
        self.conns[cid] = conn
        conn.sessions.add(cid)
        if self.ingress is not None:
            self.ingress.on_session(cid, conn)


# the framing/aliasing fast path peeks fields without parsing the header —
# pin the offsets against the Header layout so they can never drift
_CMD_REQUEST = int(Command.request)
_CMD_REPLY = int(Command.reply)
_CMD_PING_CLIENT = int(Command.ping_client)
_pin = Header(
    size=0x0BADF00D, client=0x0CAFE, context=0x0C0FFEE, request=0x0D15EA5E,
    command=int(Command.request), operation=0x42,
).to_bytes()
assert int.from_bytes(
    _pin[TCPMessageBus._SIZE_OFF : TCPMessageBus._SIZE_OFF + 4], "little"
) == 0x0BADF00D
assert int.from_bytes(
    _pin[TCPMessageBus._CLIENT_OFF : TCPMessageBus._CLIENT_OFF + 16],
    "little",
) == 0x0CAFE
assert int.from_bytes(
    _pin[TCPMessageBus._CONTEXT_OFF : TCPMessageBus._CONTEXT_OFF + 16],
    "little",
) == 0x0C0FFEE
assert int.from_bytes(
    _pin[TCPMessageBus._REQUEST_OFF : TCPMessageBus._REQUEST_OFF + 4],
    "little",
) == 0x0D15EA5E
assert _pin[TCPMessageBus._CMD_OFF] == _CMD_REQUEST
assert _pin[TCPMessageBus._OP_OFF] == 0x42
del _pin
