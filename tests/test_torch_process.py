"""The port's server process against the JAX package's, over real TCP: a
port server (`python -m tigerbeetle_tpu_torch start --backend device
--device cpu`) and a JAX server (`TB_JAX_PLATFORM=cpu python -m
tigerbeetle_tpu start --backend device`) take the same request stream and
give the same result codes and the same lookups (timestamps aside: each
server stamps from its own clock); each package's clients (`NativeClient`,
`Repl`) talk to the other's server; the pure-C example client runs
against the port's build of the library; the `[stats]` line at SIGTERM
has the JAX server's keys, `compile_sentinel` replaced by
`kernel_launches`."""

import subprocess

import pytest

import tests.conftest  # noqa: F401  (jax on the CPU before it initializes)
from tigerbeetle_tpu_torch import native
from tigerbeetle_tpu_torch.testing import process as P
from tigerbeetle_tpu_torch.types import Account, CreateTransferResult, Transfer

SMALL = ("--grid-mb", "8", "--account-slots-log2", "10", "--transfer-slots-log2", "12")
JAX_ENV = {"TB_JAX_PLATFORM": "cpu"}


def _server(tmp, module, args, env=None):
    path = str(tmp / "data.tb")
    P.format_file(path, module=module, env=env)
    port = P.free_port()
    proc, line = P.spawn(path, f"127.0.0.1:{port}", args=args, module=module, env=env)
    return {"proc": proc, "port": port, "path": path, "line": line}


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    out = {}
    try:
        out["port"] = _server(tmp_path_factory.mktemp("port"), P.MODULE,
                              (*SMALL, "--backend", "device", "--device", "cpu"))
        out["jax"] = _server(tmp_path_factory.mktemp("jax"), "tigerbeetle_tpu",
                             (*SMALL, "--backend", "device"), env=JAX_ENV)
        yield out
    finally:
        for s in out.values():
            P.kill_group(s["proc"])


def test_port_server_answers_the_stream_as_the_jax_server(servers):
    from tigerbeetle_tpu_torch.client_ffi import NativeClient

    line = servers["port"]["line"]
    assert "listening on" in line and "(op=0, commit=0)" in line
    replies = {}
    for name in ("port", "jax"):
        client = NativeClient("127.0.0.1", servers[name]["port"])
        replies[name] = P.run_stream(client, P.request_stream())
        client.close()
    assert replies["port"] == replies["jax"]
    # the stream's failures are there to compare: creates that fail, a
    # broken chain, a post of a missing pending
    assert sum(len(r) for r in replies["port"][:5]) >= 8


def test_port_clients_against_the_jax_server_and_back(servers):
    """Each package's NativeClient and Repl against the other's server."""
    from tigerbeetle_tpu.client_ffi import NativeClient as JClient
    from tigerbeetle_tpu.repl import Repl as JRepl
    from tigerbeetle_tpu.repl import parse_statement as j_parse
    from tigerbeetle_tpu_torch.client_ffi import NativeClient as TClient
    from tigerbeetle_tpu_torch.repl import Repl as TRepl
    from tigerbeetle_tpu_torch.repl import parse_statement as t_parse

    for client_cls, server, base in ((TClient, "jax", 1000), (JClient, "port", 2000)):
        c = client_cls("127.0.0.1", servers[server]["port"])
        assert c.create_accounts([Account(id=base + i, ledger=1, code=1) for i in (1, 2, 3)]) == []
        assert c.create_transfers([
            Transfer(id=base + 10, debit_account_id=base + 1, credit_account_id=base + 2,
                     amount=100, ledger=1, code=1),
            Transfer(id=base + 11, debit_account_id=base + 1, credit_account_id=base + 2,
                     amount=5, ledger=1, code=1, flags=2),
            Transfer(id=base + 12, pending_id=base + 11, flags=4),
            Transfer(id=base + 13, debit_account_id=base + 1, credit_account_id=base + 1,
                     amount=5, ledger=1, code=1),
        ]) == [(3, int(CreateTransferResult.accounts_must_be_different))]
        a = c.lookup_accounts([base + 1, base + 2, base + 404])
        assert len(a) == 2 and a[0].debits_posted == 105 and a[1].credits_posted == 105
        assert c.lookup_transfers([base + 12])[0].amount == 5
        c.close()

    outs = {}
    for repl_cls, parse, server in ((TRepl, t_parse, "jax"), (JRepl, j_parse, "port")):
        repl = repl_cls([("127.0.0.1", servers[server]["port"])])
        repl.connect()
        outs[server] = [
            repl.execute(*parse("create_accounts id=500 ledger=1 code=9;")),
            repl.execute(*parse("create_accounts id=500 ledger=1 code=8;")),
            repl.execute(*parse("lookup_accounts id=500;")),
            repl.execute(*parse("lookup_accounts id=501;")),
        ]
    assert outs["jax"][:2] == outs["port"][:2] == ["ok", "[0] exists_with_different_code"]
    for out in outs.values():
        assert "id=500" in out[2] and "code=9" in out[2]
        assert out[3] == "(not found)"
    stmt = "create_transfers id=77 debit_account_id=2 credit_account_id=3 amount=7 ledger=1 code=1;"
    assert repr(t_parse(stmt)) == repr(j_parse(stmt))


def test_c_example_client_against_the_port_server(servers, tmp_path):
    """The pure-C example program, compiled into tmp_path and linked with
    the port's build of the library (nothing is written into native/)."""
    lib = native.build()
    exe = str(tmp_path / "example_client")
    cc = subprocess.run(
        ["gcc", "-O2", "-o", exe, str(native.NATIVE_DIR / "example_client.c"),
         f"-I{native.NATIVE_DIR}", f"-L{lib.parent}", "-ltb_native", "-lpthread",
         f"-Wl,-rpath,{lib.parent}"],
        capture_output=True, text=True,
    )
    assert cc.returncode == 0, cc.stderr
    run = subprocess.run([exe, f"127.0.0.1:{servers['port']['port']}"],
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stdout + run.stderr
    assert "transfer: ok" in run.stdout
    assert "account 901:" in run.stdout and "account 902:" in run.stdout


def test_inspect_live_and_stats_line_have_the_jax_keys(servers):
    """`inspect live` of each package against the port server, then the
    SIGTERM [stats] line of both servers: the same top-level keys, with
    compile_sentinel replaced by kernel_launches."""
    from tigerbeetle_tpu.inspect import inspect_live as j_live
    from tigerbeetle_tpu.metrics import CATALOG
    from tigerbeetle_tpu_torch.inspect import inspect_live as t_live

    port = servers["port"]["port"]
    snaps = [t_live("127.0.0.1", port), j_live("127.0.0.1", port)]
    assert snaps[0].keys() == snaps[1].keys()
    assert snaps[1]["metrics"]["counters"]["inspect.live_requests"] == 2
    jsnap = j_live("127.0.0.1", servers["jax"]["port"])
    assert set(snaps[0]) == set(jsnap) | {"kernel_launches"}

    t_stats, _ = P.terminate(servers["port"]["proc"])
    j_stats, _ = P.terminate(servers["jax"]["proc"])
    want = set(j_stats) - {"compile_sentinel"} | {"kernel_launches"}
    assert set(t_stats) == want
    assert t_stats["split"].keys() == j_stats["split"].keys()
    assert t_stats["group"].keys() == j_stats["group"].keys()
    assert t_stats["loop"].keys() == j_stats["loop"].keys()
    # the device backend on the CPU runs the plain versions: no launch
    assert set(t_stats["kernel_launches"]) >= {"lookup", "commit_transfers_fast", "group_commit"}
    assert not any(t_stats["kernel_launches"].values())
    # the same requests but the C client's took the same planner tiers
    assert t_stats["split"]["serial"] == j_stats["split"]["serial"] >= 1
    assert t_stats["split"]["waves"] == j_stats["split"]["waves"]
    emitted = set(t_stats["metrics"]["counters"]) | set(t_stats["metrics"]["gauges"])
    assert not emitted - set(CATALOG), emitted - set(CATALOG)
