"""`inspect` of the port against the JAX package's: the scenarios of
tests/test_inspect.py (a driven data file, a torn WAL tail, a misdirected
WAL write, an LSM manifest, a live server's [stats] and flight history)
with both CLIs' `inspect --json` reports equal on the same data file, for
a file written by either package's replica."""

import io
import json
import os
import signal
import time

import numpy as np
import pytest

import tests.conftest  # noqa: F401  (jax on the CPU before it initializes)
from tigerbeetle_tpu import cli as j_cli
from tigerbeetle_tpu import inspect as j_inspect
from tigerbeetle_tpu_torch import cli as t_cli
from tigerbeetle_tpu_torch import inspect as t_inspect
from tigerbeetle_tpu_torch.testing import process as P

TOPICS = ("superblock", "wal", "replies", "grid", "lsm", "client-table")


def _drive_data_file(path: str, package: str) -> int:
    """tests/test_inspect.py's data file, written by `package`'s replica
    (oracle backend) over a real FileStorage: register, accounts,
    transfers, a checkpoint, one op after it. Returns the head op."""
    if package == "port":
        from tigerbeetle_tpu_torch import types
        from tigerbeetle_tpu_torch.constants import TEST_PROCESS, ConfigCluster
        from tigerbeetle_tpu_torch.io.network import InProcessNetwork
        from tigerbeetle_tpu_torch.io.storage import FileStorage, ZoneLayout
        from tigerbeetle_tpu_torch.io.time import DeterministicTime
        from tigerbeetle_tpu_torch.models.oracle import OracleStateMachine
        from tigerbeetle_tpu_torch.vsr.client import Client
        from tigerbeetle_tpu_torch.vsr.replica import Replica
        main = t_cli.main
    else:
        from tigerbeetle_tpu import types
        from tigerbeetle_tpu.constants import TEST_PROCESS, ConfigCluster
        from tigerbeetle_tpu.io.network import InProcessNetwork
        from tigerbeetle_tpu.io.storage import FileStorage, ZoneLayout
        from tigerbeetle_tpu.io.time import DeterministicTime
        from tigerbeetle_tpu.models.oracle import OracleStateMachine
        from tigerbeetle_tpu.vsr.client import Client
        from tigerbeetle_tpu.vsr.replica import Replica
        main = j_cli.main
    Op = types.Operation
    assert main(["format", "--cluster", "0", "--replica", "0", "--replica-count", "1", path]) == 0
    cluster = ConfigCluster()
    storage = FileStorage(path, ZoneLayout(cluster, grid_size=64 * 1024 * 1024), create=False)
    net = InProcessNetwork()
    r = Replica(0, 1, storage, net, DeterministicTime(), cluster, TEST_PROCESS,
                backend_factory=OracleStateMachine)
    r.sync_payload_async = False
    r.open()
    c = Client(1 << 64, net, 1)
    c.register()
    net.run()
    c.take_reply()

    def execute(op, body):
        c.request(op, body)
        net.run()
        return c.take_reply()

    acct = np.zeros(2, dtype=types.ACCOUNT_DTYPE)
    acct["id_lo"] = [1, 2]
    acct["ledger"], acct["code"] = 1, 1
    execute(Op.create_accounts, acct.tobytes())

    def transfer(id_):
        t = np.zeros(1, dtype=types.TRANSFER_DTYPE)
        t["id_lo"], t["debit_account_id_lo"], t["credit_account_id_lo"] = id_, 1, 2
        t["amount_lo"], t["ledger"], t["code"] = 1, 1, 1
        return t.tobytes()

    for i in range(3):
        execute(Op.create_transfers, transfer(100 + i))
    r.checkpoint()
    execute(Op.create_transfers, transfer(999))
    head = r.op
    storage.close()
    return head


def _reports(path, capsys, topics=TOPICS, extra=()):
    """Both CLIs' `inspect <topic> --json` on `path`: {topic: (port, jax)}."""
    out = {}
    for topic in topics:
        got = []
        for main in (t_cli.main, j_cli.main):
            assert main(["inspect", topic, "--json", *extra, path]) == 0
            got.append(json.loads(capsys.readouterr().out))
        out[topic] = got
    return out


def _texts(path, capsys, topic="all"):
    got = []
    for main in (t_cli.main, j_cli.main):
        assert main(["inspect", topic, path]) == 0
        got.append(capsys.readouterr().out)
    return got


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_inspect_reports_equal_on_a_driven_data_file(writer, tmp_path, capsys):
    from tigerbeetle_tpu_torch.constants import ConfigCluster

    path = str(tmp_path / "data.tb")
    head = _drive_data_file(path, writer)
    capsys.readouterr()
    for topic, (port, jax) in _reports(path, capsys).items():
        assert port == jax, topic
    port_all, jax_all = _texts(path, capsys)
    assert port_all == jax_all
    assert "quorum: sequence" in port_all and "replayable chain" in port_all
    for main in (t_cli.main, j_cli.main):
        assert main(["inspect", "wal", "--op", str(head), "--json", path]) == 0
    a, b = capsys.readouterr().out.strip().split("\n}\n")
    assert json.loads(a + "\n}") == json.loads(b)

    storage = t_inspect.open_storage(path, ConfigCluster())
    try:
        sb = t_inspect.inspect_superblock(storage)
        assert sb["quorum_copies"] == 4
        assert all(c["verdict"] == "valid" for c in sb["copies"])
        state = sb["state"]
        assert state.commit_min == head - 1
        wal = t_inspect.inspect_wal(storage, ConfigCluster(), state)
        assert wal["stats"]["valid"] == head and wal["chain_end"] == head
        assert wal["chain_break"] is None
        one = t_inspect.inspect_wal_op(storage, ConfigCluster(), head)
        assert one["verdict"] == "valid" and one["header"]["operation"] == "create_transfers"
        table = t_inspect.inspect_client_table(storage, state)
        assert (table["sessions"], table["source"]) == (1, "inline")
        grid = t_inspect.inspect_grid(storage, ConfigCluster(), state)
        assert all(b["checksum_ok"] for b in grid["blobs"])
    finally:
        storage.close()


def _tear(path, head, how):
    from tigerbeetle_tpu_torch.constants import ConfigCluster
    from tigerbeetle_tpu_torch.io.storage import FileStorage, Zone, ZoneLayout

    cluster = ConfigCluster()
    storage = FileStorage(path, ZoneLayout(cluster, grid_size=64 * 1024 * 1024), create=False)
    msg_max = cluster.message_size_max
    slot = head % cluster.journal_slot_count
    if how == "torn":
        raw = bytearray(storage.read(Zone.wal_prepares, slot * msg_max, 4096))
        for i in range(200, 264):
            raw[i] ^= 0xFF
        storage.write(Zone.wal_prepares, slot * msg_max, bytes(raw))
        out = slot
    else:  # a checksum-valid prepare in the wrong slot, nothing in its own
        wrong = (slot + 7) % cluster.journal_slot_count
        raw = storage.read(Zone.wal_prepares, slot * msg_max, msg_max)
        storage.write(Zone.wal_prepares, wrong * msg_max, raw)
        storage.write(Zone.wal_prepares, slot * msg_max, b"\0" * 4096)
        hsec = slot * 128 // 4096 * 4096
        sector = bytearray(storage.read(Zone.wal_headers, hsec, 4096))
        off = slot * 128 - hsec
        sector[off:off + 128] = b"\0" * 128
        storage.write(Zone.wal_headers, hsec, bytes(sector))
        out = wrong
    storage.close()
    return out


@pytest.mark.parametrize("how", ["torn", "misdirected"])
def test_inspect_diagnoses_a_damaged_wal_as_the_jax_inspect(how, tmp_path, capsys):
    path = str(tmp_path / "data.tb")
    head = _drive_data_file(path, "port")
    slot = _tear(path, head, how)
    capsys.readouterr()
    (port, jax), = _reports(path, capsys, ("wal",)).values()
    assert port == jax
    assert port["chain_end"] == head - 1
    why = "torn_prepare" if how == "torn" else "misdirected (found in wrong slot)"
    assert port["chain_break"] == {"op": head, "slot": slot, "why": why}
    port_text, jax_text = _texts(path, capsys, "wal")
    assert port_text == jax_text
    if how == "torn":
        assert f"TORN TAIL: chain breaks at op {head}" in port_text


def test_inspect_lsm_decodes_manifest_per_groove_as_the_jax_inspect(tmp_path, capsys):
    from tigerbeetle_tpu_torch.constants import ConfigCluster
    from tigerbeetle_tpu_torch.io.storage import FileStorage, ZoneLayout
    from tigerbeetle_tpu_torch.lsm.grid import Grid
    from tigerbeetle_tpu_torch.lsm.groove import Forest
    from tigerbeetle_tpu_torch.vsr.superblock import SuperBlock, VSRState

    layout = ZoneLayout(ConfigCluster(), grid_size=64 * 1024 * 1024, forest_blocks=192)
    path = str(tmp_path / "lsm.tb")
    storage = FileStorage(path, layout, create=True)
    forest = Forest(Grid(storage, offset=layout.forest_offset, block_count=192), memtable_max=8)
    for ts in range(1, 33):
        forest.posted.put(ts.to_bytes(8, "big"), b"\x01")
    meta = {"manifest": forest.checkpoint(), "spilled_blocks": [], "spilled_count": 0}
    SuperBlock(storage).checkpoint(VSRState(sequence=1, meta={"spill": meta}))
    storage.close()
    reports = _reports(path, capsys, ("lsm", "grid"), ("--forest-blocks", "192"))
    for topic, (port, jax) in reports.items():
        assert port == jax, topic
    posted = next(t for t in reports["lsm"][0]["trees"] if t["name"] == "posted")
    assert sum(lv["entries"] for lv in posted["levels"]) == 32
    fs = reports["grid"][0]["free_set"]
    assert fs["acquired"] > 0 and fs["corrupt"] == []


def test_inspect_live_against_a_port_server(tmp_path):
    """`inspect live` of both packages against a running port server; the
    SIGQUIT hang dump keeps it serving; the flight history rides the wire
    and `inspect live --watch` renders it; the SIGTERM [stats] line reads
    the same registry, every name of it in the JAX metric catalog."""
    from tigerbeetle_tpu.metrics import CATALOG

    path = str(tmp_path / "live.tb")
    P.format_file(path)
    port = P.free_port()
    proc, _ = P.spawn(path, f"127.0.0.1:{port}", args=(
        "--grid-mb", "8", "--account-slots-log2", "10", "--transfer-slots-log2", "12",
        "--device", "cpu", "--backend", "native"))
    try:
        snap = t_inspect.inspect_live("127.0.0.1", port)
        assert (snap["status"], snap["replica"]) == ("normal", 0)
        assert snap["metrics"]["counters"]["inspect.live_requests"] == 1
        jsnap = j_inspect.inspect_live("127.0.0.1", port)
        assert set(jsnap) == set(snap)
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline:  # the recorder takes an entry a second
            snap = t_inspect.inspect_live("127.0.0.1", port)
            if len(snap.get("history") or []) >= 2:
                break
            time.sleep(0.2)
        assert len(snap["history"]) >= 2 and snap["history"][1]["dt"] is not None
        assert "latency.e2e_us" in snap["metrics"]["histograms"]
        os.kill(proc.pid, signal.SIGQUIT)
        while time.monotonic() < deadline + 10:
            snap = t_inspect.inspect_live("127.0.0.1", port)
            if snap["metrics"]["counters"].get("trace.sigquit_dumps"):
                break
            time.sleep(0.1)
        assert proc.poll() is None, "SIGQUIT must not kill the server"
        assert snap["metrics"]["counters"]["trace.sigquit_dumps"] == 1
        for watch in (t_inspect.watch_live, j_inspect.watch_live):
            out = io.StringIO()
            assert watch("127.0.0.1", port, interval_s=1.0, count=1, out=out) == 0
            assert "t=" in out.getvalue() and "ops/s=" in out.getvalue(), out.getvalue()
        out = io.StringIO()
        t_inspect.watch_live("127.0.0.1", port, interval_s=1.0, count=1, out=out, as_json=True)
        lines = [ln for ln in out.getvalue().splitlines() if ln]
        assert lines and all("t" in json.loads(ln) for ln in lines)
    finally:
        stats, text = P.terminate(proc)
    assert stats["metrics"]["counters"]["trace.sigquit_dumps"] == 1
    emitted = set(stats["metrics"]["counters"]) | set(stats["metrics"]["gauges"])
    assert not emitted - set(CATALOG), emitted - set(CATALOG)
    assert "[quit] status=" in text and "Current thread" in text
    quit_line = next(ln for ln in text.splitlines() if ln.startswith("[quit] stats "))
    quit_stats = json.loads(quit_line[len("[quit] stats "):])
    assert quit_stats.get("history") and "latency_slowest" in quit_stats
    assert "kernel_launches" in quit_stats
