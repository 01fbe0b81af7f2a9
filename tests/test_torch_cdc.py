"""The port's change stream (`tigerbeetle_tpu_torch/cdc/`), the mirror of
`tests/test_cdc.py` on the port's modules: record encoding, the durable
cursor, AOF replay, the commit hooks, the pump's live tail and
backpressure, the UDP sink, the `cdc` command and the simulator's
consumer."""

import io
import json
import sys

import numpy as np
import pytest

from tigerbeetle_tpu_torch import types
from tigerbeetle_tpu_torch.cdc import (
    CdcPump,
    FileCursor,
    MemoryCursor,
    MemorySink,
    encode_batch,
    record_line,
)
from tigerbeetle_tpu_torch.models.oracle import OracleStateMachine
from tigerbeetle_tpu_torch.testing.cluster import Cluster
from tigerbeetle_tpu_torch.types import (
    CreateTransferResult,
    Operation,
    TransferFlags,
)
from tigerbeetle_tpu_torch.vsr.header import Command, Header


def _prepare_header(op, operation, timestamp) -> Header:
    return Header(
        command=int(Command.prepare), op=op,
        operation=int(operation), timestamp=timestamp,
    )


# ---------------------------------------------------------------- encoder


def test_record_encoder_exact_deltas_and_canonical_lines():
    transfers = [
        types.Transfer(id=10, debit_account_id=1, credit_account_id=2,
                       amount=7, ledger=1, code=1),
        types.Transfer(id=11, debit_account_id=2, credit_account_id=3,
                       amount=5, ledger=1, code=1,
                       flags=int(TransferFlags.pending)),
    ]
    body = types.transfers_to_np(transfers).tobytes()
    h = _prepare_header(9, Operation.create_transfers, 1000)
    recs = encode_batch(h, body, b"")  # empty reply: all ok
    assert [r["ts"] for r in recs] == [999, 1000]  # ts - n + i + 1
    assert recs[0]["deltas"] == [
        [1, "debits_posted", 7], [2, "credits_posted", 7],
    ]
    assert recs[1]["deltas"] == [
        [2, "debits_pending", 5], [3, "credits_pending", 5],
    ]
    assert all(r["resolved"] and r["result"] == 0 for r in recs)
    # canonical: stable bytes, loadable, op/ix present
    lines = [record_line(r) for r in recs]
    assert lines == [record_line(r) for r in recs]
    assert json.loads(lines[0])["op"] == 9


def test_record_encoder_failed_and_indirect_events():
    transfers = [
        types.Transfer(id=20, debit_account_id=1, credit_account_id=2,
                       amount=3, ledger=1, code=1),
        types.Transfer(id=21, pending_id=11,
                       flags=int(TransferFlags.post_pending_transfer)),
    ]
    body = types.transfers_to_np(transfers).tobytes()
    reply = np.zeros(1, dtype=types.CREATE_TRANSFERS_RESULT_DTYPE)
    reply[0]["index"] = 0
    reply[0]["result"] = int(CreateTransferResult.exists)
    recs = encode_batch(
        _prepare_header(3, Operation.create_transfers, 50),
        body, reply.tobytes(),
    )
    # failed: exactly zero effect, known exactly
    assert recs[0]["result"] == int(CreateTransferResult.exists)
    assert recs[0]["resolved"] and "deltas" not in recs[0]
    # post_pending: amount resolves against the pending transfer's state
    assert recs[1]["result"] == 0
    assert not recs[1]["resolved"] and "deltas" not in recs[1]
    # unknown reply buffer: result null, unresolved
    recs = encode_batch(
        _prepare_header(3, Operation.create_transfers, 50), body, None
    )
    assert all(r["result"] is None and not r["resolved"] for r in recs)
    # non-change ops encode to nothing
    assert encode_batch(
        _prepare_header(1, Operation.register, 1), b"", b""
    ) == []


# ----------------------------------------------------------------- cursor


def test_file_cursor_roundtrip_and_corrupt_fallback(tmp_path):
    path = str(tmp_path / "consumer.cursor")
    c = FileCursor(path)
    assert c.load() == (0, 0)  # absent
    c.ack(42, 0xDEADBEEF << 64)
    assert FileCursor(path).load() == (42, 0xDEADBEEF << 64)
    c.ack(43, 7)  # atomic replace, no tmp residue
    assert not (tmp_path / "consumer.cursor.tmp").exists()
    assert c.load() == (43, 7)
    # corruption reads as absent (with a warning), never raises
    with open(path, "r+b") as f:
        f.seek(10)
        f.write(b"XX")
    err = io.StringIO()
    orig, sys.stderr = sys.stderr, err
    try:
        assert FileCursor(path).load() == (0, 0)
    finally:
        sys.stderr = orig
    assert "corrupt" in err.getvalue()


# ------------------------------------------------------- AOF torn tails


def test_aof_replay_tolerates_truncation_at_every_tail_offset(tmp_path):
    from tigerbeetle_tpu_torch.aof import AOF, SECTOR, replay

    path = str(tmp_path / "log.aof")
    aof = AOF(path)
    headers = []
    for op in (1, 2, 3):
        t = types.Transfer(id=op, debit_account_id=1, credit_account_id=2,
                           amount=1, ledger=1, code=1)
        body = types.transfers_to_np([t]).tobytes()
        h = _prepare_header(op, Operation.create_transfers, 100 + op)
        h.set_checksum_body(body)
        h.set_checksum()
        aof.append(h, body)
        headers.append(h)
    aof.close()
    data = open(path, "rb").read()
    assert len(data) == 3 * SECTOR
    whole = list(replay(path))
    assert [h.op for h, _ in whole] == [1, 2, 3]

    record_len = 16 + 128 + 128  # magic+size, header, 1-transfer body
    err = io.StringIO()
    orig, sys.stderr = sys.stderr, err
    try:
        # crash mid-append of record 3: every byte offset of the final
        # record must stop the replay cleanly — never raise. A cut inside
        # the record loses it (replay ends at record 2); a cut inside the
        # trailing zero PAD leaves the record complete and replayable.
        for cut in range(2 * SECTOR, 3 * SECTOR):
            with open(path, "r+b") as f:
                f.truncate(cut)
                f.seek(0, 2)
            got = list(replay(path))
            want = [1, 2] if cut < 2 * SECTOR + record_len else [1, 2, 3]
            assert [h.op for h, _ in got] == want, cut
            # restore for the next cut
            with open(path, "r+b") as f:
                f.write(data)
    finally:
        sys.stderr = orig
    # a cut strictly inside the record leaves trailing bytes: warned
    assert "torn/corrupt tail" in err.getvalue()


# ----------------------------------- hook exactly-once across all paths


def _oracle_cluster(replica_count=3, **kw):
    return Cluster(replica_count=replica_count,
                   backend_factory=OracleStateMachine, **kw)


def _drive_batches(cluster, client, start_id, n_batches, batch=2):
    for k in range(n_batches):
        ts = [
            types.Transfer(
                id=start_id + k * batch + j, debit_account_id=1,
                credit_account_id=2, amount=1, ledger=1, code=1,
            )
            for j in range(batch)
        ]
        _h, body = cluster.execute(
            client, Operation.create_transfers,
            types.transfers_to_np(ts).tobytes(),
        )
        assert body == b""


def test_commit_hooks_fire_exactly_once_across_repair_catchup_and_sync(
    tmp_path,
):
    """The contract documented at replica._commit_dispatch_inner: the
    commit hook, the AOF append, and the CDC finalize hook each fire
    EXACTLY once per op within a process lifetime — through the normal
    path, through catchup after a partition (journal-gap repair fills via
    request_prepare), and through a state-sync install, which commits
    NONE of the jumped ops (they fire zero times, by design: the CDC pump
    declares them as a gap)."""
    from tigerbeetle_tpu_torch.aof import AOF, replay

    cl = _oracle_cluster()
    counts = [{} for _ in cl.replicas]  # replica -> op -> commit_hook fires
    cdc_counts = [{} for _ in cl.replicas]
    for i, r in enumerate(cl.replicas):
        def commit_hook(h, b, _c=counts[i]):
            _c[h.op] = _c.get(h.op, 0) + 1

        def cdc_hook(h, b, reply, _c=cdc_counts[i]):
            _c[h.op] = _c.get(h.op, 0) + 1

        r.commit_hook = commit_hook
        r.cdc_hook = cdc_hook
    aof_path = str(tmp_path / "r0.aof")
    cl.replicas[0].aof = AOF(aof_path)

    c = cl.add_client()
    accounts = [types.Account(id=i, ledger=1, code=1) for i in (1, 2)]
    cl.execute(c, Operation.create_accounts,
               types.accounts_to_np(accounts).tobytes())

    # normal path
    _drive_batches(cl, c, 1000, 3)
    # catchup: replica 2 misses a few ops, then repairs + commits them
    cl.detach_replica(2)
    _drive_batches(cl, c, 2000, 4)
    cl.reattach_replica(2)
    cl.run_ticks(30)
    base_commit = cl.replicas[2].commit_min
    assert base_commit == cl.replicas[0].commit_min
    # state sync: replica 2 misses > checkpoint_interval (60) ops — on
    # reattach it installs the checkpoint image and commits the tail only
    cl.detach_replica(2)
    interval = cl.cluster_config.checkpoint_interval
    _drive_batches(cl, c, 10_000, interval + 10)
    cl.reattach_replica(2)
    for _ in range(20):
        cl.run_ticks(10)
        if cl.replicas[2].commit_min == cl.replicas[0].commit_min:
            break
    assert cl.replicas[2].commit_min == cl.replicas[0].commit_min

    top = cl.replicas[0].commit_min
    for i in (0, 1):
        ops = set(counts[i])
        assert ops == set(range(1, top + 1))
        assert set(counts[i].values()) == {1}, f"replica {i} duplicated"
        assert counts[i] == cdc_counts[i]
    # replica 2: every fired op fired ONCE; the state-sync jump fired none
    assert set(counts[2].values()) == {1}, "replica 2 duplicated a commit"
    assert counts[2] == cdc_counts[2]
    jumped = set(range(base_commit + 1, cl.replicas[2].checkpoint_op + 1))
    assert jumped and not (jumped & set(counts[2])), (
        "state-sync install must not re-fire hooks for jumped ops"
    )
    # the AOF holds replica 0's ops exactly once each
    aof_ops = [h.op for h, _ in replay(aof_path)]
    assert aof_ops == sorted(set(aof_ops))
    assert set(aof_ops) == set(range(1, top + 1))


# -------------------------------------------- pump: live tail + resume


def _expected_lines(replica, lo, hi):
    out = []
    for op in range(lo, hi + 1):
        h, body = replica.journal.read_prepare(op)
        reply = replica.cdc_replies.get(op)
        out += [record_line(r) for r in encode_batch(h, body, reply)]
    return out


def test_pump_live_tail_window_eviction_and_resume():
    cl = _oracle_cluster(replica_count=1)
    r = cl.replicas[0]
    sink, cursor = MemorySink(), MemoryCursor()
    pump = CdcPump(r, sink, cursor, window=2, ack_interval=2)
    pump.attach()
    c = cl.add_client()
    accounts = [types.Account(id=i, ledger=1, code=1) for i in (1, 2)]
    cl.execute(c, Operation.create_accounts,
               types.accounts_to_np(accounts).tobytes())
    _drive_batches(cl, c, 100, 4)
    # a duplicate id: a non-empty reply body must survive the live-window
    # eviction through the replica's cdc_replies ring
    dup = types.Transfer(id=100, debit_account_id=1, credit_account_id=2,
                         amount=1, ledger=1, code=1)
    _h, reply = cl.execute(c, Operation.create_transfers,
                           types.transfers_to_np([dup]).tobytes())
    assert reply != b""
    # window=2 but 6 ops committed: the pump serves evictions from the WAL
    while pump.pump(budget_ops=4):
        pass
    m = r.metrics.snapshot()["counters"]
    assert m["cdc.journal_reads"] > 0 and m["cdc.live_hits"] > 0
    assert sink.lines == _expected_lines(r, 1, r.commit_min)
    dup_rec = json.loads(sink.lines[-1])
    assert dup_rec["result"] == int(CreateTransferResult.exists)

    # consumer restart: progress past the cursor ack is REDELIVERED and
    # dedupable by op; the stream continues with no gap
    acked_op, _ = cursor.load()
    assert acked_op >= 2
    pump.detach()
    seen_before = {json.loads(line)["op"] for line in sink.lines}
    sink2 = MemorySink()
    pump2 = CdcPump(r, sink2, cursor, window=4, ack_interval=2)
    pump2.attach()
    _drive_batches(cl, c, 200, 2)
    while pump2.pump(budget_ops=4):
        pass
    ops2 = [json.loads(line)["op"] for line in sink2.lines]
    assert ops2 == sorted(ops2)
    assert min(ops2) == acked_op + 1  # redelivery starts after the ack
    assert set(o for o in ops2 if o <= r.commit_min) | seen_before == {
        op for op in range(2, r.commit_min + 1)
    }  # op 1 is the register: record-less
    # full redelivered content matches the original stream where they
    # overlap (dedup by op is sufficient — content is identical)
    overlap = [line for line in sink2.lines
               if json.loads(line)["op"] in seen_before]
    assert overlap == [line for line in sink.lines
                       if json.loads(line)["op"] > acked_op]


def test_pump_backpressure_pauses_pump_never_replica():
    cl = _oracle_cluster(replica_count=1)
    r = cl.replicas[0]
    sink = MemorySink(capacity=3)  # refuses once 3 lines are buffered
    pump = CdcPump(r, sink, MemoryCursor(), window=64)
    pump.attach()
    c = cl.add_client()
    accounts = [types.Account(id=i, ledger=1, code=1) for i in (1, 2)]
    cl.execute(c, Operation.create_accounts,
               types.accounts_to_np(accounts).tobytes())
    commits_before = r.commit_min
    _drive_batches(cl, c, 300, 5)
    assert r.commit_min == commits_before + 5  # replica never paused
    for _ in range(4):
        pump.pump()  # repeated refusals: ONE pause transition
    m = r.metrics.snapshot()
    assert m["counters"]["cdc.backpressure_pauses"] == 1
    assert m["gauges"]["cdc.lag_ops"] > 0
    stalled = len(sink.lines)
    sink.capacity = None  # consumer catches up
    while pump.pump(budget_ops=8):
        pass
    assert len(sink.lines) > stalled
    assert sink.lines == _expected_lines(r, 1, r.commit_min)
    assert r.metrics.snapshot()["gauges"]["cdc.lag_ops"] == 0


def test_udp_sink_reuses_statsd_mtu_batching():
    import socket

    from tigerbeetle_tpu_torch.cdc import UdpSink

    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.bind(("127.0.0.1", 0))
    rx.settimeout(2)
    sink = UdpSink("127.0.0.1", rx.getsockname()[1])
    lines = [record_line({"op": i, "kind": "transfer", "x": "y" * 80})
             for i in range(40)]
    assert sink.emit_lines(lines)
    assert sink.datagrams >= 2  # MTU-packed, not one datagram per line
    got = []
    for _ in range(sink.datagrams):
        payload = rx.recv(2048)
        assert len(payload) <= 1400
        got += payload.decode().split("\n")
    assert got == lines  # order and framing survive the packing
    sink.close()
    rx.close()


def test_aof_replay_source_serves_across_a_hole(tmp_path):
    """An AOF hole (ops the replica never executed — a state-sync jump)
    must not swallow the first record beyond it: read() keeps a lookahead,
    next_available() bounds the declared gap, and the CLI backfill emits
    an explicit gap record then continues (the reviewed failure mode:
    AOF-covered history mis-declared as gone)."""
    from tigerbeetle_tpu_torch.aof import AOF
    from tigerbeetle_tpu_torch.cdc import AofReplaySource
    from tigerbeetle_tpu_torch.cli import main as cli_main

    path = str(tmp_path / "holed.aof")
    aof = AOF(path)
    for op in (1, 2, 5, 6):  # ops 3-4 never executed here
        t = types.Transfer(id=op, debit_account_id=1, credit_account_id=2,
                           amount=1, ledger=1, code=1)
        body = types.transfers_to_np([t]).tobytes()
        h = _prepare_header(op, Operation.create_transfers, 100 + op)
        h.set_checksum_body(body)
        h.set_checksum()
        aof.append(h, body)
    aof.close()

    src = AofReplaySource(path)
    assert src.read(1)[0].op == 1
    assert src.read(2)[0].op == 2
    assert src.read(3) is None  # the hole...
    assert src.next_available() == 5  # ...bounded where the log resumes
    assert src.read(4) is None
    got = src.read(5)
    assert got is not None and got[0].op == 5  # lookahead not dropped
    assert src.read(6)[0].op == 6

    out = str(tmp_path / "holed.jsonl")
    assert cli_main(["cdc", "--sink", f"jsonl:{out}", path]) == 0
    recs = [json.loads(line) for line in open(out).read().splitlines()]
    kinds = [(r.get("kind"), r.get("op", r.get("from"))) for r in recs]
    assert kinds == [
        ("transfer", 1), ("transfer", 2), ("gap", 3),
        ("transfer", 5), ("transfer", 6),
    ]
    assert recs[2] == {"kind": "gap", "from": 3, "to": 4}


# ------------------------------------------------------------ CLI replay


def test_cdc_cli_replays_aof_with_cursor_resume(tmp_path, capsys):
    from tigerbeetle_tpu_torch.aof import AOF
    from tigerbeetle_tpu_torch.cli import main as cli_main

    cl = _oracle_cluster(replica_count=1)
    r = cl.replicas[0]
    aof_path = str(tmp_path / "log.aof")
    r.aof = AOF(aof_path)
    live_sink = MemorySink()
    pump = CdcPump(r, live_sink, MemoryCursor())
    pump.attach()
    c = cl.add_client()
    accounts = [types.Account(id=i, ledger=1, code=1) for i in (1, 2)]
    cl.execute(c, Operation.create_accounts,
               types.accounts_to_np(accounts).tobytes())
    _drive_batches(cl, c, 500, 3)
    # one failed event so oracle-derived result codes are actually tested
    dup = types.Transfer(id=500, debit_account_id=1, credit_account_id=2,
                         amount=1, ledger=1, code=1)
    cl.execute(c, Operation.create_transfers,
               types.transfers_to_np([dup]).tobytes())
    while pump.pump(budget_ops=8):
        pass
    r.aof.close()

    out_path = str(tmp_path / "stream.jsonl")
    rc = cli_main(["cdc", "--sink", f"jsonl:{out_path}", aof_path])
    assert rc == 0
    replayed = open(out_path).read().splitlines()
    # the offline oracle replay reproduces the live stream byte for byte
    assert replayed == live_sink.lines
    # resume: the cursor is at the end — a second run emits nothing new
    rc = cli_main(["cdc", "--sink", f"jsonl:{out_path}", aof_path])
    assert rc == 0
    assert open(out_path).read().splitlines() == replayed
    assert "0 records over 0 ops" in capsys.readouterr().err


# ------------------------------------------------- simulator consumer


def test_simulator_cdc_consumer_crash_restart_no_gaps_no_dup_effects():
    """The acceptance run: the VOPR crashes/restarts the CDC consumer
    mid-stream (and replicas too); the checker inside Simulator._check
    proves coverage with zero gaps and apply-once effects, and two
    same-seed runs dump byte-identical streams."""
    from tigerbeetle_tpu_torch.testing.simulator import Simulator

    dumps = []
    stats = None
    for _ in range(2):
        sim = Simulator(7, ticks=500, cdc_consumer=True,
                        cdc_crash_probability=0.02)
        stats = sim.run()  # _check_cdc runs inside
        dumps.append("\n".join(sim.cdc.stream))
    assert stats["cdc_crashes"] >= 1, "consumer never crashed mid-stream"
    assert stats["cdc_redelivered_ops"] >= 1, (
        "no crash landed between sink-accept and cursor-ack; the dedup "
        "contract went unexercised"
    )
    assert stats["cdc_gaps"] == 0
    assert stats["cdc_records"] > 0
    assert dumps[0] == dumps[1], "same seed must dump identical streams"


@pytest.mark.slow
def test_simulator_cdc_more_seeds():
    from tigerbeetle_tpu_torch.testing.simulator import run_simulation

    for seed in (3, 11, 42):
        stats = run_simulation(seed, ticks=700, cdc_consumer=True)
        assert stats["cdc_records"] > 0
