"""A port server with its change stream and its ingress gateway on, against
a JAX server with the same flags, over real TCP: `python -m
tigerbeetle_tpu_torch start --backend device --device cpu --ingress
--cdc-jsonl ... --aof ...` and `TB_JAX_PLATFORM=cpu python -m
tigerbeetle_tpu start --backend device --ingress --cdc-jsonl ... --aof
...` take the same request stream (the process tests' stream, then a
request of pendings with their posts and voids, which plans as waves).
Their replies are equal (timestamps aside: each server stamps from its own
clock), and so are their JSONL change records with the `ts` field taken
out. Each server's stream equals what the `cdc` command of either package
replays from its AOF, byte for byte."""

import json
import subprocess
import sys

import pytest

import tests.conftest  # noqa: F401  (jax on the CPU before it initializes)
from tigerbeetle_tpu_torch.testing import process as P
from tigerbeetle_tpu_torch.types import Operation

SMALL = ("--grid-mb", "8", "--account-slots-log2", "10", "--transfer-slots-log2", "12")
JAX_ENV = {"TB_JAX_PLATFORM": "cpu"}
MODULES = {"port": (P.MODULE, None, ("--device", "cpu")), "jax": ("tigerbeetle_tpu", JAX_ENV, ())}


def _wave_request(base: int):
    """16 pendings and, in the same request, a post or void of each."""
    rows = [(base + 100 + i, base + 1 + i % 3, base + 4 + i % 3, 10 + i, 0, 2) for i in range(16)]
    rows += [(base + 200 + i, 0, 0, 0, base + 100 + i, 4 if i % 2 else 8) for i in range(16)]
    return Operation.create_transfers, P._transfers(rows)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from tigerbeetle_tpu_torch.client_ffi import NativeClient

    out = {}
    for name, (module, env, extra) in MODULES.items():
        tmp = tmp_path_factory.mktemp(name)
        path, port = str(tmp / "data.tb"), P.free_port()
        P.format_file(path, module=module, env=env)
        jsonl, aof = str(tmp / "stream.jsonl"), str(tmp / "data.aof")
        proc, _line = P.spawn(path, f"127.0.0.1:{port}", module=module, env=env, args=(
            *SMALL, "--backend", "device", *extra, "--ingress", "--cdc-jsonl", jsonl,
            "--aof", aof))
        try:
            client = NativeClient("127.0.0.1", port)
            replies = P.run_stream(client, P.request_stream() + [_wave_request(0)])
            client.close()
            stats, _ = P.terminate(proc)
        finally:
            P.kill_group(proc)
        with open(jsonl) as f:
            lines = f.read().splitlines()
        out[name] = {"replies": replies, "stats": stats, "lines": lines, "aof": aof, "tmp": tmp}
    return out


def test_replies_and_records_equal_the_jax_server(runs):
    assert runs["port"]["replies"] == runs["jax"]["replies"]

    def no_ts(lines):
        recs = [json.loads(line) for line in lines]
        for r in recs:
            r.pop("ts", None)
        return recs

    assert len(runs["port"]["lines"]) > 40
    assert no_ts(runs["port"]["lines"]) == no_ts(runs["jax"]["lines"])
    for name in runs:
        counters = runs[name]["stats"]["metrics"]["counters"]
        assert counters["ingress.admitted"] > 0
        assert counters.get("cdc.results_unknown", 0) == 0
    # the last request went through the wave path on the port's server
    assert runs["port"]["stats"]["metrics"]["counters"]["waves.batches"] >= 1


@pytest.mark.parametrize("src", ["port", "jax"])
def test_cdc_command_of_either_package_replays_the_aof(runs, src):
    for module in ("tigerbeetle_tpu_torch", "tigerbeetle_tpu"):
        out = runs[src]["tmp"] / f"replay_{module}.jsonl"
        r = subprocess.run(
            [sys.executable, "-m", module, "cdc", "--sink", f"jsonl:{out}",
             "--cursor", str(out) + ".cursor", runs[src]["aof"]],
            cwd=P.REPO_ROOT, env=P._env(JAX_ENV), capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stderr
        assert out.read_text().splitlines() == runs[src]["lines"], module
