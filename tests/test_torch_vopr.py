"""The port's VOPR runner (`python -m tigerbeetle_tpu_torch.testing.vopr`):
its per-seed records equal `run_simulation` of the JAX package on the JAX
`random_options` draws; `--device cpu` runs a fleet to exit 0; a seed made
to fail (a tampered hash-log recording) is reported with its replay line
and the process exits nonzero."""

import json
import pathlib
import subprocess
import sys

import pytest

from tigerbeetle_tpu.testing.simulator import random_options as jax_options
from tigerbeetle_tpu.testing.simulator import run_simulation as jax_run
from tigerbeetle_tpu_torch.testing import vopr

REPO = pathlib.Path(__file__).resolve().parents[1]
TICKS = 300


def _vopr(*args, timeout=300):
    return subprocess.run([sys.executable, "-m", "tigerbeetle_tpu_torch.testing.vopr", *args],
                          cwd=REPO, capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_runner_record_equals_jax(seed):
    stats, desc = vopr.run_seed(seed, TICKS, 0.0, False, device="cpu")
    assert stats == jax_run(seed, ticks=TICKS, **jax_options(seed))
    assert desc.startswith(vopr.describe_options(vopr.random_options(seed)))


def test_fleet_on_cpu_exits_zero_and_writes_records(tmp_path):
    out = tmp_path / "fleet.jsonl"
    p = _vopr("--device", "cpu", "--seeds", "3", "--ticks", str(TICKS), "--json", str(out))
    assert p.returncode == 0, p.stdout + p.stderr
    assert "3/3 passed" in p.stdout
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["seed"] for r in recs] == [1, 2, 3] and all(r["ok"] for r in recs)
    assert recs[0]["stats"] == jax_run(1, ticks=TICKS, **jax_options(1))


def test_failing_seed_is_reported_and_exits_nonzero(tmp_path):
    prefix = str(tmp_path / "hl")
    p = _vopr("--device", "cpu", "--start", "9", "--seeds", "1", "--ticks", "250",
              "--hash-log", prefix)
    assert p.returncode == 0, p.stdout + p.stderr
    path = pathlib.Path(f"{prefix}.9.jsonl")
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    victim = lines[len(lines) // 2]
    victim["prepare"] = hex(int(victim["prepare"], 16) ^ 1)
    path.write_text("".join(json.dumps(r) + "\n" for r in lines))
    p = _vopr("--device", "cpu", "--start", "9", "--seeds", "1", "--ticks", "250",
              "--hash-log", prefix)
    assert p.returncode == 1
    assert "seed      9 FAIL" in p.stdout
    assert f"first divergence at op {victim['op']}" in p.stdout
    assert ("replay with: python -m tigerbeetle_tpu_torch.testing.vopr --start 9 --seeds 1 "
            "--ticks 250 --device cpu") in p.stdout


@pytest.mark.parametrize("flag", ["--federation-fraction"])
def test_unported_slices_are_refused(flag):
    with pytest.raises(SystemExit):
        vopr.parse_args([flag, "0.2"])
    assert getattr(vopr.parse_args([flag, "0"]), flag[2:].replace("-", "_")) == 0.0


@pytest.mark.parametrize("flag,seed", [("cdc", 1), ("ingress", 2)])
def test_cdc_and_ingress_slices_equal_jax(flag, seed):
    """A seed of the CDC slice (the deterministic consumer) and one of the
    ingress slice (gateway, connect storm, CDC fan-out) give the JAX
    package's `run_simulation` record with the same options."""
    stats, desc = vopr.run_seed(seed, TICKS, 0.0, False, device="cpu",
                                **{f"{flag}_fraction": 1.0})
    opts = jax_options(seed)
    if flag == "cdc":
        opts["cdc_consumer"] = True
    else:
        opts.update(ingress_gateway=True, storm_clients=4 + seed % 8, cdc_fanout=3)
    assert desc.endswith(flag.upper())
    assert stats == jax_run(seed, ticks=TICKS, **opts)
