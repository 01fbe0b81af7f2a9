"""The port's server-process units against the JAX package's: the argument
parser, the flight recorder, the statsd datagrams, the AOF, the planner's
`split_stats` view, `format`'s data files, and the `start` refusals (no
CUDA, a flag of a module not ported yet, `--backend sharded` without
`--shards`). No server is spawned here but for the refusals that need a
process of their own."""

import dataclasses
import os
import socket
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401  (jax on the CPU before it initializes)
from tigerbeetle_tpu import aof as j_aof
from tigerbeetle_tpu import cli as j_cli
from tigerbeetle_tpu import flags as j_flags
from tigerbeetle_tpu import metrics as j_metrics
from tigerbeetle_tpu import statsd as j_statsd
from tigerbeetle_tpu.models.ledger import HazardTracker as JHazardTracker
from tigerbeetle_tpu.vsr import header as j_header
from tigerbeetle_tpu_torch import aof as t_aof
from tigerbeetle_tpu_torch import cli as t_cli
from tigerbeetle_tpu_torch import flags as t_flags
from tigerbeetle_tpu_torch import metrics as t_metrics
from tigerbeetle_tpu_torch import statsd as t_statsd
from tigerbeetle_tpu_torch import types
from tigerbeetle_tpu_torch.models.ledger import HazardTracker as THazardTracker
from tigerbeetle_tpu_torch.testing import hazards
from tigerbeetle_tpu_torch.testing.process import REPO_ROOT, free_port
from tigerbeetle_tpu_torch.vsr import header as t_header

ARGV = {
    "format": [
        ["data.tb"],
        ["--cluster", "7", "--replica", "2", "--replica-count", "3", "--grid-mb=16", "d.tb"],
        ["--clients-max", "64", "--client-reply-slots", "8", "x"],
    ],
    "start": [
        ["--addresses", "127.0.0.1:3001", "--backend", "device", "f.tb"],
        ["--addresses=:3001,:3002,:3003", "--replica", "1", "--aof", "a.aof",
         "--commit-window", "0", "--fuse-window-us", "500", "--backend", "dual",
         "--device-lag-window", "64", "--hash-log", "record:h.log", "f.tb"],
        ["--addresses", "h:1", "--backend", "sharded", "--shards", "8",
         "--account-slots-log2", "14", "--transfer-slots-log2", "16",
         "--flight-interval-s", "0.5", "--latency-sample-every", "1",
         "--statsd", ":8125", "--trace", "t.json", "f"],
        ["--addresses", "h:1", "--backend", "native", "--ingress-backlog", "16",
         "--ingress-accept-budget", "4", "--ingress-dispatch-budget", "8",
         "--device-trace", "d", "--device-trace-s", "1.5", "f"],
    ],
    "repl": [["--addresses", "127.0.0.1:3001"], ["--addresses", "a:1,b:2", "--cluster", "5"]],
    "inspect": [
        ["superblock", "d.tb"],
        ["wal", "--op", "5", "--slot", "3", "--json", "--clients-max", "64", "d.tb"],
        ["live", "--addresses", ":3001", "--watch", "1.5", "--watch-count", "2"],
        ["lsm", "--forest-blocks", "192", "f"],
    ],
}
CASES = [(cmd, i) for cmd, lists in ARGV.items() for i in range(len(lists))]


@pytest.mark.parametrize("cmd,i", CASES, ids=[f"{c}-{i}" for c, i in CASES])
def test_flags_parse_gives_the_jax_dataclasses(cmd, i):
    argv = ARGV[cmd][i]
    want = dataclasses.asdict(j_flags.parse(j_cli.COMMANDS[cmd][0], argv))
    got = dataclasses.asdict(t_flags.parse(t_cli.COMMANDS[cmd][0], argv))
    if cmd == "start":  # the port's one extra flag
        assert got.pop("device") == "cuda"
    assert got == want


@pytest.mark.parametrize("argv", [
    ["--bogus", "f"], ["--replica", "x", "f"], ["--commit-window"], [], ["a", "b"],
    ["--ingress=1", "--addresses", "h:1", "f"],
])
def test_flags_errors_exit_as_the_jax_parser(argv, capsys):
    with pytest.raises(SystemExit) as j:
        j_flags.parse(j_cli.StartArgs, argv)
    j_err = capsys.readouterr().err
    with pytest.raises(SystemExit) as t:
        t_flags.parse(t_cli.StartArgs, argv)
    assert (t.value.code, capsys.readouterr().err) == (j.value.code, j_err)


def test_start_differs_from_the_jax_cli_only_in_device_and_default_backend():
    jf = {f.name: f.default for f in dataclasses.fields(j_cli.StartArgs)}
    tf = {f.name: f.default for f in dataclasses.fields(t_cli.StartArgs)}
    assert tf.pop("device") == "cuda"
    assert (jf.pop("backend"), tf.pop("backend")) == ("native", "device")
    assert tf == jf
    for cmd in ("format", "repl", "client", "inspect", "cdc"):
        fields = [(f.name, f.default) for f in dataclasses.fields(t_cli.COMMANDS[cmd][0])]
        assert fields == [(f.name, f.default) for f in dataclasses.fields(j_cli.COMMANDS[cmd][0])]
    assert set(t_cli.COMMANDS) == set(j_cli.COMMANDS) - {"chaos"}


def _flight_sequence(m, fr):
    """tests/test_metrics.py's flight-recorder case, entry by entry."""
    c = m.counter("ops")
    h = m.histogram("lat")
    g = m.gauge("depth")
    out = []
    c.add(10)
    for _ in range(100):
        h.observe(10.0)
    out.append(fr.record(1.0))
    for _ in range(4):
        h.observe(40_000.0)
    g.set(3)
    out.append(fr.record(2.0))
    out.append(fr.record(3.0))
    fr.set_phase("steady")
    for t in range(4, 9):
        c.add(1)
        h.observe(float(t * 100))
        fr.record(float(t))
    m.counter("float").add(0.125)
    out.append(fr.record(9.5))
    return out


def test_flight_recorder_history_equals_the_jax_recorder():
    jm, tm = j_metrics.Metrics(), t_metrics.Metrics()
    jfr, tfr = j_metrics.FlightRecorder(jm, capacity=4), t_metrics.FlightRecorder(tm, capacity=4)
    assert _flight_sequence(tm, tfr) == _flight_sequence(jm, jfr)
    assert tfr.history() == jfr.history()
    assert tfr.history(last=2) == jfr.history(last=2)
    assert tfr.phase_log == jfr.phase_log
    assert tm.snapshot() == jm.snapshot()


def _datagrams(mod, metrics_mod, rounds):
    sink = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sink.bind(("127.0.0.1", 0))
    sink.settimeout(5)
    s = mod.StatsD("127.0.0.1", sink.getsockname()[1])
    m = metrics_mod.Metrics()
    em = mod.StatsDEmitter(s, m)
    got = []
    for r in range(rounds):
        for i in range(60):  # enough names to need several datagrams
            m.counter(f"c{i:02d}.ops").add(r * (i % 3))
            m.gauge(f"g{i:02d}.depth").set(i * r)
        if r != 2:
            m.histogram("commit_us").observe(17.0 * (r + 1))
        n = em.flush()
        got.append([sink.recv(2048) for _ in range(n)])
    s.count("one", 3)
    s.gauge("g", 1.5)
    s.timing("t", 0.25)
    got.append([sink.recv(2048) for _ in range(3)])
    s.close()
    sink.close()
    return got


def test_statsd_datagrams_equal_the_jax_emitter_byte_for_byte():
    want = _datagrams(j_statsd, j_metrics, 4)
    assert _datagrams(t_statsd, t_metrics, 4) == want
    assert all(len(d) <= j_statsd.MTU_PAYLOAD for r in want for d in r)
    for addr in ("host", ":9", "h:10", " 127.0.0.1:8125 "):
        assert t_statsd.parse_addr(addr) == j_statsd.parse_addr(addr)


def _prepares(hmod, n):
    rng = np.random.default_rng(17)
    out = []
    for op in range(1, n + 1):
        body = rng.integers(0, 256, int(rng.integers(0, 3000)), dtype=np.uint8).tobytes()
        h = hmod.Header(command=int(hmod.Command.prepare), operation=130, op=op,
                        client=1 << 70, request=op, timestamp=10**12 + op)
        h.set_checksum_body(body)
        h.set_checksum()
        out.append((h, body))
    return out


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_aof_written_by_either_package_replays_in_the_other(writer, tmp_path, capsys):
    wmod, whdr, rmod = ((t_aof, t_header, j_aof) if writer == "port"
                        else (j_aof, j_header, t_aof))
    path = str(tmp_path / "log.aof")
    log = wmod.AOF(path)
    recs = _prepares(whdr, 7)
    for h, body in recs:
        log.append(h, body)
    log.close()
    got = list(rmod.replay(path))
    assert [(h.to_bytes(), b) for h, b in got] == [(h.to_bytes(), b) for h, b in recs]
    # a torn tail stops both replays at the same record with the same warning
    with open(path, "ab") as f:
        f.write(b"\x01" * 100)
    t_got = list(t_aof.replay(path))
    t_err = capsys.readouterr().err
    j_got = list(j_aof.replay(path))
    assert len(t_got) == len(j_got) == 7
    assert t_err == capsys.readouterr().err != ""


def test_split_stats_equals_the_jax_view_after_the_hazard_requests():
    rng_t, rng_j = np.random.default_rng(5), np.random.default_rng(5)
    th, jh = THazardTracker(), JHazardTracker()
    for case in hazards.CASES:
        req = types.transfers_to_np(hazards.hazard_request(case, rng_t, 12, 1))
        jreq = types.transfers_to_np(hazards.hazard_request(case, rng_j, 12, 1))
        th.plan(req)
        jh.plan(jreq)
        assert th.split_stats == jh.split_stats, case
    assert th.split_stats is th.plan_stats
    assert sum(th.split_stats[k] for k in ("fast", "fast_pv", "serial", "split", "split_pv")) \
        == len(hazards.CASES)


@pytest.mark.parametrize("argv", [
    [],
    ["--cluster", "9", "--replica", "2", "--replica-count", "3"],
    ["--clients-max", "40", "--client-reply-slots", "8"],
])
def test_format_writes_the_jax_data_file_byte_for_byte(argv, tmp_path, capsys):
    jp, tp = str(tmp_path / "j.tb"), str(tmp_path / "t.tb")
    assert j_cli.main(["format", "--grid-mb", "8", *argv, jp]) == 0
    j_out = capsys.readouterr().out
    assert t_cli.main(["format", "--grid-mb", "8", *argv, tp]) == 0
    assert capsys.readouterr().out == j_out.replace(jp, tp)
    with open(jp, "rb") as a, open(tp, "rb") as b:
        assert a.read() == b.read()


def test_version_and_usage(capsys):
    assert t_cli.main(["version"]) == 0
    assert capsys.readouterr().out == f"tigerbeetle_tpu_torch {j_cli.VERSION}\n"
    assert t_cli.main([]) == 1
    usage = capsys.readouterr().out
    assert "inspect" in usage and "cdc" in usage and "A7" in usage and "A6" not in usage
    with pytest.raises(SystemExit):
        t_cli.main(["chaos"])
    assert "unknown command 'chaos'" in capsys.readouterr().err


@pytest.mark.parametrize("flag", [
    ["--commitment-interval", "8"], ["--federation-regions", "2"],
    ["--federation-region", "0"],
])
def test_start_refuses_a_flag_of_a_module_not_ported(flag, capsys):
    name = flag[0][2:].replace("-", "_")
    with pytest.raises(SystemExit) as e:
        t_cli.main(["start", "--addresses", "127.0.0.1:1", "--device", "cpu", *flag, "nofile"])
    assert e.value.code == 1
    err = capsys.readouterr().err
    assert flag[0] in err and f"queue {t_cli.UNPORTED_START_FLAGS[name]}" in err


@pytest.mark.parametrize("flag", [
    ["--cdc-jsonl", "s.jsonl"], ["--cdc-udp", ":9"], ["--cdc-window", "8"], ["--cdc-fanout"],
    ["--ingress"], ["--ingress-sessions-max", "10"],
])
def test_start_takes_the_cdc_and_ingress_flags(flag):
    """The change stream's and the gateway's flags parse as the JAX CLI's
    and pass the check that refuses the flags of modules not ported."""
    argv = ["--addresses", "127.0.0.1:1", "--device", "cpu", *flag, "nofile"]
    args = t_flags.parse(t_cli.StartArgs, argv)
    t_cli._refuse_unported(args)
    got = dataclasses.asdict(args)
    assert got.pop("device") == "cpu" and got.pop("backend") == "device"
    want = dataclasses.asdict(j_flags.parse(j_cli.StartArgs, argv[:2] + argv[4:]))
    want.pop("backend")
    assert got == want


def test_cdc_command_parses_as_the_jax_cli():
    argv = ["--sink", "jsonl:o.jsonl", "--consumer", "c", "--cursor", "k", "--limit", "3", "a.aof"]
    assert dataclasses.asdict(t_flags.parse(t_cli.CdcArgs, argv)) == \
        dataclasses.asdict(j_flags.parse(j_cli.CdcArgs, argv))


def test_inspect_commitments_is_refused(capsys):
    with pytest.raises(SystemExit) as e:
        t_cli.main(["inspect", "commitments", "--stream", "s.jsonl"])
    assert e.value.code == 1 and "A7" in capsys.readouterr().err


def _start(tmp_path, *args):
    path = str(tmp_path / "d.tb")
    if not os.path.exists(path):
        assert t_cli.main(["format", "--grid-mb", "8", path]) == 0
    return subprocess.run(
        [sys.executable, "-m", "tigerbeetle_tpu_torch", "start",
         "--addresses", f"127.0.0.1:{free_port()}", "--grid-mb", "8",
         "--account-slots-log2", "10", "--transfer-slots-log2", "12", *args, path],
        cwd=REPO_ROOT, env=dict(os.environ, PYTHONPATH=str(REPO_ROOT)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=120,
    )


def test_start_without_cuda_exits_before_listening_and_names_cuda(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: start would serve")
    out = _start(tmp_path)  # --device cuda by default
    capsys.readouterr()
    assert out.returncode != 0
    assert "listening" not in out.stdout and "CUDA" in out.stdout
    out = _start(tmp_path, "--backend", "dual")
    assert out.returncode != 0 and "CUDA" in out.stdout and "listening" not in out.stdout


def test_start_sharded_needs_shards(tmp_path, capsys):
    out = _start(tmp_path, "--device", "cpu", "--backend", "sharded")
    capsys.readouterr()
    assert out.returncode == 1 and "listening" not in out.stdout
    assert "--shards" in out.stdout


class _Clock:
    def __init__(self):
        self.now = 100.0

    def monotonic(self):
        return self.now


class _Backlog:
    """A change-stream pump with `ops` committed ops to stream, each taking
    `cost` seconds of the fake clock to encode."""

    def __init__(self, clock, ops, cost):
        self.clock, self.ops, self.cost, self.budgets = clock, ops, cost, []

    def pump(self, budget_ops=8):
        self.budgets.append(budget_ops)
        n = min(budget_ops, self.ops)
        self.ops -= n
        self.clock.now += n * self.cost
        return n


@pytest.mark.parametrize("status", ["view_change", "recovering"])
def test_change_stream_waits_while_the_replica_is_not_normal(status, monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(t_cli, "time", clock)
    pump = _Backlog(clock, ops=5, cost=0.001)
    pacer = t_cli.ChangeStreamPacer(pump)
    replica = SimpleNamespace(status=status)
    assert pacer.turn(replica, busy=False, tick_s=0.01) == 0
    assert pump.budgets == []
    replica.status = "normal"
    assert pacer.turn(replica, busy=False, tick_s=0.01) == 5
    assert set(pump.budgets) == {1}


def test_change_stream_takes_one_op_a_busy_turn_and_eight_an_idle_one(monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(t_cli, "time", clock)
    pump = _Backlog(clock, ops=20, cost=0.0)
    pacer = t_cli.ChangeStreamPacer(pump)
    replica = SimpleNamespace(status="normal")
    assert pacer.turn(replica, busy=True, tick_s=0.01) == 1
    assert pacer.turn(replica, busy=False, tick_s=0.01) == 8
    assert pacer.turn(replica, busy=False, tick_s=0.01) == 8
    assert pacer.turn(replica, busy=False, tick_s=0.01) == 3
    assert pacer.turn(replica, busy=False, tick_s=0.01) == 0


def test_change_stream_yields_the_loop_as_long_as_an_encode_took(monkeypatch):
    """An op that takes longer than a tick ends the turn's bite, and the
    loop then runs as long again before the stream's next op."""
    clock = _Clock()
    monkeypatch.setattr(t_cli, "time", clock)
    pump = _Backlog(clock, ops=20, cost=0.15)
    pacer = t_cli.ChangeStreamPacer(pump)
    replica = SimpleNamespace(status="normal")
    assert pacer.turn(replica, busy=False, tick_s=0.01) == 1
    for _ in range(14):  # the loop's next turns, 0.01 s each
        clock.now += 0.01
        assert pacer.turn(replica, busy=False, tick_s=0.01) == 0
    clock.now += 0.011
    assert pacer.turn(replica, busy=False, tick_s=0.01) == 1
    assert pump.ops == 18
