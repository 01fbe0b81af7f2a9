"""The port's ingress gateway (tigerbeetle_tpu_torch/ingress + the bus front
door), the mirror of `tests/test_ingress.py` on the port's modules:
session multiplexing over shared connections, credit-based admission with
typed busy sheds, fair pumping against firehose/slow-loris peers, pool
credit on close, accept drain, the CDC fan-out hub's backpressure
isolation, the many-session client-table checkpoint blob, and the
multiplexed front door end-to-end (500-session tier-1 smoke, 10k soak
nightly)."""

from __future__ import annotations

import errno
import socket
import time

import numpy as np
import pytest

from tigerbeetle_tpu_torch import types
from tigerbeetle_tpu_torch.types import Operation
from tigerbeetle_tpu_torch.vsr.header import HEADER_SIZE, Command, Header


def _request_frame(cid: int, request: int = 0,
                   operation: int = int(Operation.register),
                   body: bytes = b"") -> bytes:
    h = Header(
        command=int(Command.request), client=cid, request=request,
        operation=operation,
    )
    h.set_checksum_body(body)
    h.set_checksum()
    return h.to_bytes() + body


def _listening_bus(**kw):
    from tigerbeetle_tpu_torch.testing.process import free_port
    from tigerbeetle_tpu_torch.io.message_bus import TCPMessageBus
    from tigerbeetle_tpu_torch.metrics import Metrics

    port = free_port()
    bus = TCPMessageBus([("127.0.0.1", port)], 0, listen=True, **kw)
    bus.metrics = Metrics()
    return bus, port


# ---------------------------------------------------------------------
# transport front door (io/message_bus.py)
# ---------------------------------------------------------------------


def test_accept_drain_takes_a_connect_storm_in_one_pump():
    """One readiness event used to land ONE accept per select round; the
    drain loop takes the whole storm inside one pump turn."""
    bus, port = _listening_bus()
    socks = [socket.create_connection(("127.0.0.1", port)) for _ in range(40)]
    try:
        deadline = time.monotonic() + 5
        pumps = 0
        while len(bus._links) < 40 and time.monotonic() < deadline:
            bus.pump(timeout=0.05)
            pumps += 1
        assert len(bus._links) == 40
        # the storm needed O(1) pump turns, not one per connection
        assert pumps <= 4, pumps
        snap = bus.metrics.snapshot()["counters"]
        assert snap["ingress.accepts"] == 40
    finally:
        for s in socks:
            s.close()
        bus.sel.close()


def test_slow_loris_and_torn_header_do_not_stall_other_sessions():
    """A peer trickling a frame byte-by-byte (or closing mid-frame)
    costs bounded work; complete frames from other connections dispatch
    within the same pump turn."""
    got: list[tuple[int, int]] = []  # (client id, request)

    bus, port = _listening_bus()
    bus.attach(0, lambda src, frame: got.append((
        int.from_bytes(frame[48:64], "little"),
        int.from_bytes(frame[80:84], "little"),
    )))
    loris = socket.create_connection(("127.0.0.1", port))
    torn = socket.create_connection(("127.0.0.1", port))
    fast = socket.create_connection(("127.0.0.1", port))
    try:
        frame_l = _request_frame(0x10A15, 1)
        loris.sendall(frame_l[:3])  # 3 bytes of header, then silence
        torn.sendall(_request_frame(0x70A2, 1)[: HEADER_SIZE // 2])
        fast.sendall(_request_frame(0xFA57, 1))
        deadline = time.monotonic() + 5
        while not got and time.monotonic() < deadline:
            bus.pump(timeout=0.05)
        # the fast session dispatched despite two wedged partial frames
        assert (0xFA57, 1) in got
        # the torn peer closes mid-frame: no dispatch, no crash
        torn.close()
        for _ in range(3):
            bus.pump(timeout=0.02)
        assert all(cid != 0x70A2 for cid, _r in got)
        # the loris eventually completes its frame: it dispatches then
        for i in range(3, len(frame_l), 7):
            loris.sendall(frame_l[i : i + 7])
            bus.pump(timeout=0.0)
        deadline = time.monotonic() + 5
        while (0x10A15, 1) not in got and time.monotonic() < deadline:
            bus.pump(timeout=0.05)
        assert (0x10A15, 1) in got
    finally:
        loris.close()
        fast.close()
        bus.sel.close()


def test_dispatch_budget_firehose_fairness():
    """A firehose peer's frames past the per-connection budget stay
    buffered (drained first next turn) while another peer's single frame
    dispatches in the same turn."""
    got: list[int] = []
    bus, port = _listening_bus(dispatch_budget=4)
    bus.attach(0, lambda src, frame: got.append(
        int.from_bytes(frame[48:64], "little")
    ))
    hose = socket.create_connection(("127.0.0.1", port))
    meek = socket.create_connection(("127.0.0.1", port))
    try:
        hose.sendall(b"".join(
            _request_frame(0xF00D, r) for r in range(1, 11)
        ))
        meek.sendall(_request_frame(0x3EE, 1))
        deadline = time.monotonic() + 5
        while 0x3EE not in got and time.monotonic() < deadline:
            bus.pump(timeout=0.05)
        # the meek peer was served while the firehose still had frames
        # buffered past its budget
        assert got.count(0xF00D) <= 2 * 4
        # leftovers drain over the following turns, budget per turn
        deadline = time.monotonic() + 5
        while got.count(0xF00D) < 10 and time.monotonic() < deadline:
            bus.pump(timeout=0.05)
        assert got.count(0xF00D) == 10
    finally:
        hose.close()
        meek.close()
        bus.sel.close()


def test_message_pool_typed_outcomes_and_credit_on_close():
    """Pool exhaustion is a typed outcome, not a silent drop — and a
    closing connection credits its unsent bytes back (a churned client
    cannot leak budget)."""
    import threading

    from tigerbeetle_tpu_torch.io.message_bus import TCPMessageBus
    from tigerbeetle_tpu_torch.metrics import Metrics

    # plain TCP sink: accepts, never reads
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(4)
    port = srv.getsockname()[1]
    accepted = []
    threading.Thread(
        target=lambda: accepted.append(srv.accept()[0]), daemon=True
    ).start()

    bus = TCPMessageBus(
        [("127.0.0.1", port)], 0xC11E27,
        messages_max=2, message_size_max=1024,
    )
    bus.metrics = Metrics()
    try:
        # resolve the non-blocking dial (flushes the hello frame) so the
        # per-connection cap below is measured on OUR payloads alone
        bus.send(0xC11E27, 0, b"")
        conn = bus.conns[0]
        deadline = time.monotonic() + 5
        while (
            (not conn.connected or conn.wbuf)
            and time.monotonic() < deadline
        ):
            bus.pump(timeout=0.05)
        assert conn.connected and not conn.wbuf
        # small sends stay buffered (below FLUSH_EAGER): the pool charge
        # is held until flush or close
        assert bus.send(0xC11E27, 0, b"x" * 1024) == "sent"
        assert bus.pool.used == 1024
        # shrink the shared budget below the NEXT send (the per-conn cap
        # still has room): exhaustion must come back typed as shed_pool
        bus.pool.capacity = 1500
        out = bus.send(0xC11E27, 0, b"y" * 1024)
        assert out == "shed_pool"
        snap = bus.metrics.snapshot()["counters"]
        assert snap["ingress.shed_pool"] == 1
        assert bus.pool.used == 1024  # the refused send charged nothing
        bus._close(conn)
        assert bus.pool.used == 0  # credited on close, not leaked
    finally:
        bus.sel.close()
        srv.close()


def test_wedged_client_consumer_disconnected_after_strikes():
    """A CLIENT connection pinned at its send cap (open socket, never
    reads) accumulates strikes and is cut; its pool bytes return."""
    got = []
    bus, port = _listening_bus(wedged_strikes_max=3)
    bus.attach(0, lambda src, frame: got.append(frame))
    peer = socket.create_connection(("127.0.0.1", port))
    try:
        cid = 0x3EDCED
        peer.sendall(_request_frame(cid, 1))
        deadline = time.monotonic() + 5
        while not got and time.monotonic() < deadline:
            bus.pump(timeout=0.05)
        conn = bus.conns[cid]

        class _EAgainSock:
            def send(self, data):
                raise OSError(errno.EAGAIN, "wedged")

            def close(self):
                pass

        real_sock = conn.sock
        conn.sock = _EAgainSock()
        # fill the per-connection cap, then strike it out
        chunk = b"r" * (1 << 18)
        while bus.send(0, cid, chunk) == "sent":
            bus._flush(conn)  # EAGAIN: nothing leaves, wbuf grows
        outcomes = [bus.send(0, cid, chunk) for _ in range(5)]
        # refusals strike the wedged peer out; past the limit the conn is
        # gone and later sends see "unreachable"
        assert outcomes[0] == "shed_conn"
        assert outcomes[-1] == "unreachable"
        assert cid not in bus.conns  # disconnected at the strike limit
        assert bus.pool.used == 0
        snap = bus.metrics.snapshot()["counters"]
        assert snap["ingress.disconnect_wedged"] == 1
        real_sock.close()
    finally:
        peer.close()
        bus.sel.close()


def test_session_multiplexing_two_sessions_share_one_connection():
    """Two logical sessions' Clients on ONE demux bus/connection: the
    server aliases reply routing per client id; each Client sees only
    its own replies."""
    from tigerbeetle_tpu_torch.io.message_bus import TCPMessageBus
    from tigerbeetle_tpu_torch.vsr.client import Client

    server, port = _listening_bus()
    sessions_granted = {}

    def serve(src, frame):
        h = Header.from_bytes(frame[:HEADER_SIZE])
        if h.command != Command.request:
            return
        session = sessions_granted.setdefault(
            h.client, 100 + len(sessions_granted)
        )
        body = session.to_bytes(8, "little")
        r = Header(
            command=int(Command.reply), client=h.client,
            request=h.request, operation=h.operation, op=session,
        )
        r.set_checksum_body(body)
        r.set_checksum()
        server.send(0, h.client, r.to_bytes() + body)

    server.attach(0, serve)
    mux = TCPMessageBus([("127.0.0.1", port)], 0xD3FACE, demux=True)
    try:
        a = Client(0xA11CE, mux, replica_count=1)
        b = Client(0xB0B, mux, replica_count=1)
        a.register()
        b.register()
        deadline = time.monotonic() + 5
        while (
            (a.reply is None or b.reply is None)
            and time.monotonic() < deadline
        ):
            server.pump(timeout=0.0)
            mux.pump(timeout=0.01)
        a.take_reply()
        b.take_reply()
        assert {a.session, b.session} == {100, 101}
        # ONE server-side connection carries both sessions' aliases
        # (plus the mux bus's own hello-peer id)
        conns = [c for c in server._links if c.sessions]
        assert len(conns) == 1
        assert conns[0].sessions >= {0xA11CE, 0xB0B}
    finally:
        mux.sel.close()
        server.sel.close()


# ---------------------------------------------------------------------
# admission control (ingress/gateway.py + regulator.py)
# ---------------------------------------------------------------------


def _oracle_cluster(metrics=None):
    from tigerbeetle_tpu_torch.metrics import Metrics
    from tigerbeetle_tpu_torch.models.oracle import OracleStateMachine
    from tigerbeetle_tpu_torch.testing.cluster import Cluster

    m = metrics or Metrics()
    return Cluster(
        replica_count=1, backend_factory=OracleStateMachine, metrics=m
    ), m


def _accounts(ids):
    arr = np.zeros(len(ids), dtype=types.ACCOUNT_DTYPE)
    arr["id_lo"] = ids
    arr["ledger"] = 1
    arr["code"] = 1
    return arr.tobytes()


def _transfer(tid: int) -> bytes:
    arr = np.zeros(1, dtype=types.TRANSFER_DTYPE)
    arr["id_lo"] = tid
    arr["debit_account_id_lo"] = 1
    arr["credit_account_id_lo"] = 2
    arr["amount_lo"] = 1
    arr["ledger"] = 1
    arr["code"] = 1
    return arr.tobytes()


def test_gateway_sheds_typed_busy_and_recovers():
    from tigerbeetle_tpu_torch.ingress import IngressGateway

    cluster, m = _oracle_cluster()
    r = cluster.replicas[0]
    gw = IngressGateway(cluster.network, r)
    gw.install()
    c = cluster.add_client()
    _h, body = cluster.execute(c, Operation.create_accounts, _accounts([1, 2]))
    assert body == b""

    # saturate: occupancy at the cap -> the next NEW request sheds with
    # a typed busy reply echoing client + request
    orig = r.ingress_occupancy
    r.ingress_occupancy = lambda: (99, 8)
    gw.regulator.drain()
    c.request(Operation.create_transfers, _transfer(50))
    cluster.network.run()
    assert c.reply is None
    assert c.busy and c.busy_replies == 1
    assert c.in_flight is not None  # the same bytes retry after backoff
    snap = m.snapshot()["counters"]
    assert snap["ingress.shed"] == 1

    # capacity returns: the RESEND of the same request is admitted and
    # commits exactly once
    r.ingress_occupancy = orig
    gw.regulator.drain()
    c.resend()
    cluster.network.run()
    _h, body = c.take_reply()
    assert body == b""
    assert m.snapshot()["counters"]["ingress.shed"] == 1


def test_gateway_never_sheds_retransmits():
    """A retransmit of an ADMITTED request bypasses admission even under
    saturation: the replica dedups it for free (cached-reply resend),
    and shedding it would stall the client's reply recovery."""
    from tigerbeetle_tpu_torch.ingress import IngressGateway

    cluster, m = _oracle_cluster()
    r = cluster.replicas[0]
    gw = IngressGateway(cluster.network, r)
    gw.install()
    c = cluster.add_client()
    _h, body = cluster.execute(c, Operation.create_accounts, _accounts([1, 2]))
    assert body == b""
    c.request(Operation.create_transfers, _transfer(51))
    cluster.network.run()
    _h, body = c.take_reply()
    assert body == b""
    before = m.snapshot()["counters"]["ingress.shed"]

    r.ingress_occupancy = lambda: (99, 8)  # fully saturated
    gw.regulator.drain()
    # a duplicate of the last request (reply lost scenario): must reach
    # the replica and come back with the CACHED reply, not a busy —
    # rebuild the exact duplicate wire (same request number, same body)
    h = Header(
        command=int(Command.request),
        operation=int(Operation.create_transfers),
        client=c.client_id, context=c.session, request=c.request_number,
    )
    body_t = _transfer(51)
    h.set_checksum_body(body_t)
    h.set_checksum()
    wire = h.to_bytes() + body_t
    cluster.network.send(c.client_id, 0, wire)
    c.in_flight = wire  # make the client accept the (cached) reply
    cluster.network.run()
    snap = m.snapshot()["counters"]
    assert snap["ingress.shed"] == before  # no shed
    assert snap["ingress.retransmits"] >= 1
    _h, body = c.take_reply()
    assert body == b""


def test_gateway_session_cap_sheds_new_sessions_only():
    from tigerbeetle_tpu_torch.ingress import IngressGateway
    from tigerbeetle_tpu_torch.metrics import Metrics
    from tigerbeetle_tpu_torch.models.oracle import OracleStateMachine
    from tigerbeetle_tpu_torch.testing.cluster import Cluster
    from tigerbeetle_tpu_torch.vsr.client import Client

    m = Metrics()
    cluster = Cluster(
        replica_count=1, backend_factory=OracleStateMachine, metrics=m
    )
    r = cluster.replicas[0]
    gw = IngressGateway(cluster.network, r, sessions_max=2)
    gw.install()
    a = cluster.add_client()
    b = cluster.add_client()
    over = Client(1 << 70, cluster.network, 1)
    over.register()
    cluster.network.run()
    assert over.session == 0 and over.busy  # shed at the session cap
    snap = m.snapshot()["counters"]
    assert snap["ingress.shed_sessions"] == 1
    # existing sessions keep working
    _h, body = cluster.execute(a, Operation.create_accounts, _accounts([1, 2]))
    assert body == b""
    _h, body = cluster.execute(b, Operation.create_transfers, _transfer(52))
    assert body == b""


def test_replica_eviction_frees_gateway_session_slot():
    """A register at clients_max evicts the oldest session from the
    replica AND (via ingress_evict_hook) from the gateway table:
    evicted sessions on a still-open multiplexed connection must not
    pin the sessions_max cap forever."""
    from tigerbeetle_tpu_torch.constants import ConfigCluster
    from tigerbeetle_tpu_torch.ingress import IngressGateway
    from tigerbeetle_tpu_torch.metrics import Metrics
    from tigerbeetle_tpu_torch.models.oracle import OracleStateMachine
    from tigerbeetle_tpu_torch.testing.cluster import Cluster

    m = Metrics()
    cfg = ConfigCluster(clients_max=2)
    cluster = Cluster(
        replica_count=1, cluster=cfg,
        backend_factory=OracleStateMachine, metrics=m,
    )
    r = cluster.replicas[0]
    gw = IngressGateway(cluster.network, r, sessions_max=3)
    gw.install()
    # each register past clients_max evicts the oldest; the gateway
    # table must track, so none of these is shed at the gateway cap
    # (add_client asserts the register got a real session)
    for _ in range(4):
        cluster.add_client()
    snap = m.snapshot()["counters"]
    assert snap.get("ingress.shed_sessions", 0) == 0
    assert set(gw.sessions) == set(r.client_table)
    assert len(gw.sessions) == 2


def test_duplicate_register_commit_releases_replaced_reply_slot():
    """A register op for a client ALREADY in the table (a view change
    can carry the same client's register twice in the surviving log)
    overwrites the entry; the replaced entry's reply slot must return
    to the free list — the old O(sessions) rebuild self-healed this,
    the incremental list has to be told."""
    from tigerbeetle_tpu_torch.constants import ConfigCluster
    from tigerbeetle_tpu_torch.models.oracle import OracleStateMachine
    from tigerbeetle_tpu_torch.testing.cluster import Cluster

    cfg = ConfigCluster(clients_max=8, client_reply_slots=2)
    cluster = Cluster(
        replica_count=1, cluster=cfg, backend_factory=OracleStateMachine
    )
    r = cluster.replicas[0]
    a = cluster.add_client()
    b = cluster.add_client()
    assert r.client_table[a.client_id]["slot"] is not None
    assert r.client_table[b.client_id]["slot"] is not None

    def dup_register(client_id):
        h = Header(
            command=int(Command.prepare), client=client_id,
            operation=int(Operation.register), op=r.op + 1,
            timestamp=r.sm.prepare_timestamp + 1,
        )
        r._commit_finalize(r._commit_dispatch(h, b""))

    def assert_slot_conservation():
        # every slot is either owned by a table entry or on the free
        # list — never both, never neither
        used = {e.get("slot") for e in r.client_table.values()} - {None}
        free = set(r._reply_slots_free or [])
        assert used.isdisjoint(free)
        assert used | free == set(range(cfg.client_reply_slots)), (
            used, free,
        )

    dup_register(a.client_id)
    assert_slot_conservation()
    assert r.client_table[a.client_id]["slot"] is not None

    # restart edge: the free list is rebuilt LAZILY (None until the
    # first alloc) — a duplicate register replayed from the WAL tail
    # before any rebuild must not let the lazy rebuild count the
    # replaced entry's slot as owned
    r._reply_slots_free = None
    dup_register(b.client_id)
    assert_slot_conservation()
    assert r.client_table[b.client_id]["slot"] is not None


def test_conn_close_drops_gateway_sessions_only_for_that_conn():
    """The bus notifies the gateway BEFORE clearing a closing
    connection's session aliases; the gateway drops exactly those
    sessions' records."""
    from tigerbeetle_tpu_torch.io.message_bus import TCPMessageBus
    from tigerbeetle_tpu_torch.ingress import IngressGateway

    class _FakeReplica:
        replica = 0
        is_primary = True  # the gateway only admits on the primary

        def __init__(self, bus):
            from tigerbeetle_tpu_torch.metrics import Metrics

            self.metrics = Metrics()
            self.network = bus

        def ingress_occupancy(self):
            return (0, 8)

        def _send(self, dst, header):
            pass

    server, port = _listening_bus()
    server.attach(0, lambda src, frame: None)
    fake = _FakeReplica(server)
    gw = IngressGateway(server, fake)
    gw.install()
    s1 = socket.create_connection(("127.0.0.1", port))
    s2 = socket.create_connection(("127.0.0.1", port))
    try:
        s1.sendall(_request_frame(0xAA1, 1) + _request_frame(0xAA2, 1))
        s2.sendall(_request_frame(0xBB1, 1))
        deadline = time.monotonic() + 5
        while len(gw.sessions) < 3 and time.monotonic() < deadline:
            server.pump(timeout=0.05)
        assert set(gw.sessions) == {0xAA1, 0xAA2, 0xBB1}
        s1.close()
        deadline = time.monotonic() + 5
        while len(gw.sessions) > 1 and time.monotonic() < deadline:
            server.pump(timeout=0.05)
        assert set(gw.sessions) == {0xBB1}
    finally:
        s2.close()
        server.sel.close()


# ---------------------------------------------------------------------
# CDC fan-out hub (ingress/fanout.py)
# ---------------------------------------------------------------------


def test_fanout_eight_consumers_throttled_pauses_only_itself():
    from tigerbeetle_tpu_torch.cdc import MemoryCursor, MemorySink
    from tigerbeetle_tpu_torch.ingress import CdcFanoutHub

    cluster, m = _oracle_cluster()
    r = cluster.replicas[0]
    hub = CdcFanoutHub(r, window=8)  # small window: laggards hit the WAL
    sinks = {f"c{i}": MemorySink() for i in range(8)}
    slow = MemorySink(capacity=4)
    sinks["slow"] = slow
    for name, sink in sinks.items():
        hub.add_consumer(name, sink, MemoryCursor(), ack_interval=4)
    hub.attach()

    c = cluster.add_client()
    _h, body = cluster.execute(c, Operation.create_accounts, _accounts([1, 2]))
    assert body == b""
    for i in range(24):
        _h, body = cluster.execute(
            c, Operation.create_transfers, _transfer(100 + i)
        )
        assert body == b""
        hub.pump(budget_ops=4)
    for _ in range(40):
        hub.pump(budget_ops=8)
    lags = hub.lag_ops()
    assert lags["slow"] > 0, lags  # the throttled consumer lags...
    assert all(v == 0 for k, v in lags.items() if k != "slow"), lags
    # ...past the live window: its reads fell back to the WAL ring
    assert m.snapshot()["counters"]["cdc.journal_reads"] > 0
    # fast consumers carry identical streams
    first = sinks["c0"].lines
    assert first and all(
        sinks[f"c{i}"].lines == first for i in range(1, 8)
    )
    # drain the slow one: it converges with the same stream
    while hub.lag_ops()["slow"]:
        slow.drain()
        hub.pump(budget_ops=16)
    slow.drain()
    gauges = m.snapshot()["gauges"]
    assert gauges["ingress.fanout_consumers"] == 9
    assert gauges["ingress.fanout_lag_ops"] == 0


def test_fanout_consumer_resumes_from_cursor():
    """Removing and re-adding a consumer (a crash model: hub state
    volatile, cursor durable) redelivers only from its last ack."""
    from tigerbeetle_tpu_torch.cdc import MemoryCursor, MemorySink
    from tigerbeetle_tpu_torch.ingress import CdcFanoutHub

    cluster, _m = _oracle_cluster()
    r = cluster.replicas[0]
    hub = CdcFanoutHub(r, window=64)
    cur = MemoryCursor()
    sink = MemorySink()
    hub.add_consumer("a", sink, cur, ack_interval=2)
    hub.attach()
    c = cluster.add_client()
    cluster.execute(c, Operation.create_accounts, _accounts([1, 2]))
    for i in range(6):
        cluster.execute(c, Operation.create_transfers, _transfer(300 + i))
    hub.pump(budget_ops=64)
    n_before = len(sink.lines)
    assert n_before > 0
    hub.remove_consumer("a")
    sink2 = MemorySink()
    hub.add_consumer("a", sink2, cur, ack_interval=2)
    for i in range(3):
        cluster.execute(c, Operation.create_transfers, _transfer(400 + i))
    for _ in range(10):
        hub.pump(budget_ops=64)
    # resumed from the durable cursor: at most the unacked tail redelivers
    assert 3 <= len(sink2.lines) <= 3 + 2


def test_cdc_tail_detach_leaves_later_tails_attached():
    """Two independent tails on one replica (e.g. a sim consumer next
    to a fan-out hub) chain through cdc_hook. Detaching EITHER one must
    splice only itself out — restoring a stale saved hook would
    silently unhook the tail that attached after it."""
    from tigerbeetle_tpu_torch.cdc.pump import CdcTail

    cluster, _m = _oracle_cluster()
    r = cluster.replicas[0]
    c = cluster.add_client()
    cluster.execute(c, Operation.create_accounts, _accounts([1, 2]))

    # first-attached detaches first: the later tail must stay hooked
    t1 = CdcTail(r, window=16)
    t2 = CdcTail(r, window=16)
    t1.attach()
    t2.attach()
    t1.detach()
    cluster.execute(c, Operation.create_transfers, _transfer(500))
    assert t2._live, "later tail was unhooked by the earlier detach"
    assert not t1._live
    t2.detach()
    assert r.cdc_hook is None

    # last-attached detaches first: plain head restore
    t3 = CdcTail(r, window=16)
    t4 = CdcTail(r, window=16)
    t3.attach()
    t4.attach()
    t4.detach()
    cluster.execute(c, Operation.create_transfers, _transfer(501))
    assert t3._live
    assert not t4._live
    t3.detach()
    assert r.cdc_hook is None


# ---------------------------------------------------------------------
# many-session checkpoint (client-table grid blob)
# ---------------------------------------------------------------------


def test_client_table_blob_checkpoint_survives_restart():
    """600 sessions overflow the inline superblock budget: the table
    spills to a grid blob, restores across restart, and durable reply
    slots stay capped at client_reply_slots."""
    from tigerbeetle_tpu_torch.constants import ConfigCluster
    from tigerbeetle_tpu_torch.models.oracle import OracleStateMachine
    from tigerbeetle_tpu_torch.testing.cluster import Cluster

    cfg = ConfigCluster(
        journal_slot_count=2048, clients_max=2000, client_reply_slots=8
    )
    cluster = Cluster(
        replica_count=1, cluster=cfg, backend_factory=OracleStateMachine
    )
    r = cluster.replicas[0]
    clients = [cluster.add_client() for _ in range(600)]
    _h, body = cluster.execute(
        clients[0], Operation.create_accounts, _accounts([1, 2])
    )
    assert body == b""
    r.checkpoint()
    st = r.superblock.state
    assert st.meta.get("client_table_blob") is True
    assert any(ref.name == "client_table" for ref in st.blobs)
    assert "client_table" not in st.meta
    r2 = cluster.restart_replica(0)
    assert len(r2.client_table) == 600
    slots = [
        e.get("slot") for e in r2.client_table.values()
        if e.get("slot") is not None
    ]
    assert len(slots) <= 8
    # a pre-restart session still works after the blob restore
    _h, body = cluster.execute(
        clients[5], Operation.create_transfers, _transfer(77)
    )
    assert body == b""


def test_small_client_table_stays_inline():
    from tigerbeetle_tpu_torch.models.oracle import OracleStateMachine
    from tigerbeetle_tpu_torch.testing.cluster import Cluster

    cluster = Cluster(replica_count=1, backend_factory=OracleStateMachine)
    r = cluster.replicas[0]
    cluster.add_client()
    r.checkpoint()
    st = r.superblock.state
    assert not st.meta.get("client_table_blob")
    assert "client_table" in st.meta
    assert not any(ref.name == "client_table" for ref in st.blobs)


# ---------------------------------------------------------------------
# deterministic simulator: fan-out + storm + gateway
# ---------------------------------------------------------------------


def test_simulator_ingress_fanout_storm_deterministic():
    """A seeded run with the gateway on every replica, a connect storm,
    and 3 fan-out consumers (one throttled): every consumer passes the
    full stream contract (the sim's checker), the throttled consumer's
    lag dominates, and two same-seed runs are byte-identical."""
    from tigerbeetle_tpu_torch.testing.simulator import Simulator

    kw = dict(
        ticks=500, cdc_fanout=3, ingress_gateway=True, storm_clients=5
    )
    a = Simulator(211, **kw)
    sa = a.run()
    assert sa["cdc_fanout_consumers"] == 3
    assert sa["cdc_fanout_refusals"] > 0
    lag = sa["cdc_fanout_lag_max"]
    assert lag["slow"] >= max(v for k, v in lag.items() if k != "slow")
    b = Simulator(211, **kw)
    sb = b.run()
    assert sa == sb
    for name in a.cdc_fanout.stores:
        assert (
            a.cdc_fanout.stores[name].stream
            == b.cdc_fanout.stores[name].stream
        ), name


@pytest.mark.slow
def test_simulator_ingress_more_seeds():
    from tigerbeetle_tpu_torch.testing.simulator import run_simulation

    for seed in (7, 23, 31, 59):
        stats = run_simulation(
            seed, ticks=800, cdc_fanout=3, ingress_gateway=True,
            storm_clients=4 + seed % 8,
        )
        assert stats["committed_ops"] > 0


# ---------------------------------------------------------------------
# the front door end-to-end (multiplexed driver against a real server)
# ---------------------------------------------------------------------


def test_ingress_sessions_smoke_500():
    """Tier-1 smoke: 500 live multiplexed sessions over 8 connections
    through the gateway — registration storm, live p99 vs baseline,
    saturation sheds, conservation verified over the wire (inside the
    driver)."""
    from tigerbeetle_tpu_torch.testing.ingress_sessions import run_ingress_sessions

    out = run_ingress_sessions(
        n_sessions=500, conns=8, n_accounts=64, baseline_sessions=4,
        driver_batches=3, batch=64, bg_window=8, sat_window=64,
        sat_batches=16, reg_window=128,
    )
    assert out["sessions"] == 500
    assert out["ingress_sessions_gauge"] == 500
    assert out["p99_ratio"] is not None
    # the registration storm + saturation phase exercised the shed path
    assert out["ingress_shed"] + out["busy_replies"] > 0
    assert out["ingress_admitted"] > 500  # registers + workload


@pytest.mark.slow
def test_ingress_sessions_soak_10k():
    """Nightly soak: >= 10k live sessions. The bench artifact evaluates
    the p99 <= 2x acceptance number; here we assert the structural
    contract with sandbox-tolerant bounds (sessions sustained, sheds
    typed and counted, saturated throughput does not collapse)."""
    from tigerbeetle_tpu_torch.testing.ingress_sessions import run_ingress_sessions

    out = run_ingress_sessions(
        n_sessions=10_000, conns=16, n_accounts=256, baseline_sessions=10,
        driver_batches=10, batch=256, bg_window=32, sat_window=256,
        sat_batches=60, reg_window=512,
    )
    assert out["sessions"] == 10_000
    assert out["ingress_sessions_gauge"] == 10_000
    assert out["ingress_shed"] + out["busy_replies"] > 0
    assert out["tps_saturated_ratio"] and out["tps_saturated_ratio"] >= 0.7
    assert out["p99_ratio"] and out["p99_ratio"] <= 4.0
