"""The port's hash log (`tigerbeetle_tpu_torch/testing/hash_log.py`) against
the JAX package's: the same spec parsing, recordings that each package's
simulator checks clean in the other with the same saved bytes and digest,
and a divergence caught at its first op (`tests/test_hash_log.py`)."""

import json

import pytest

from tigerbeetle_tpu.testing import hash_log as JH
from tigerbeetle_tpu.testing.simulator import run_simulation as jax_run
from tigerbeetle_tpu_torch import types
from tigerbeetle_tpu_torch.testing.cluster import Cluster
from tigerbeetle_tpu_torch.testing.hash_log import (
    HashLog,
    HashLogDivergence,
    parse_hash_log_spec,
)
from tigerbeetle_tpu_torch.testing.simulator import run_simulation
from tigerbeetle_tpu_torch.testing.workload import WorkloadGenerator


@pytest.mark.parametrize("spec", ["record:/tmp/x.jsonl", "check:/tmp/x.jsonl",
                                  "/tmp/x.jsonl", "x.jsonl", "other:/tmp/x.jsonl",
                                  "check:", "c:/a:b"])
def test_parse_hash_log_spec_equals_jax(spec):
    assert parse_hash_log_spec(spec) == JH.parse_hash_log_spec(spec)


def test_parse_hash_log_spec():
    assert parse_hash_log_spec("record:/tmp/x.jsonl") == ("record", "/tmp/x.jsonl")
    assert parse_hash_log_spec("check:/tmp/x.jsonl") == ("check", "/tmp/x.jsonl")
    assert parse_hash_log_spec("/tmp/x.jsonl") == ("record", "/tmp/x.jsonl")


@pytest.mark.parametrize("seed", [9, 21])
def test_recordings_cross_check_between_packages(tmp_path, seed):
    """A seed recorded by the JAX simulator checks clean in the port's, and
    the reverse; both recordings are the same bytes."""
    pj, pp = str(tmp_path / "j.jsonl"), str(tmp_path / "p.jsonl")
    sj = jax_run(seed, ticks=250, hash_log=("record", pj))
    sp = run_simulation(seed, ticks=250, hash_log=("record", pp))
    assert sp == sj
    assert sp["hash_log_ops"] >= 1
    assert open(pp, "rb").read() == open(pj, "rb").read()
    assert run_simulation(seed, ticks=250, hash_log=("check", pj)) == {
        **sp, "hash_log_mode": "check"}
    assert jax_run(seed, ticks=250, hash_log=("check", pp))["hash_log_ops"] == sp["hash_log_ops"]
    assert HashLog("check", pp).digest() == JH.HashLog("check", pj).digest()


def test_simulator_tampered_recording_fails_at_its_op(tmp_path):
    path = str(tmp_path / "seed9.jsonl")
    stats = run_simulation(9, ticks=250, hash_log=("record", path))
    lines = [json.loads(x) for x in open(path)]
    victim = lines[len(lines) // 2]
    victim["prepare"] = hex(int(victim["prepare"], 16) ^ 1)
    with open(path, "w") as f:
        for rec in lines:
            f.write(json.dumps(rec) + "\n")
    assert stats["hash_log_ops"] == len(lines)
    with pytest.raises(HashLogDivergence) as e:
        run_simulation(9, ticks=250, hash_log=("check", path))
    assert e.value.op == int(victim["op"])
    assert e.value.kind == "prepare"


def _run(log: HashLog, tamper_batch: int | None = None) -> None:
    """tests/test_hash_log.py's run on the port's cluster (device ledger on
    the CPU)."""
    cluster = Cluster(replica_count=1, device="cpu")
    log.attach(cluster.replicas[0])
    client = cluster.add_client()
    gen = WorkloadGenerator(33)
    for b in range(5):
        if b % 2 == 0:
            op, events = gen.gen_accounts_batch(10)
            body = types.accounts_to_np(events).tobytes()
        else:
            op, events = gen.gen_transfers_batch(10)
            arr = types.transfers_to_np(events)
            if tamper_batch == b:
                arr["amount_lo"][3] += 1
            body = arr.tobytes()
        cluster.execute(client, op, body)


def test_injected_divergence_caught_at_first_op(tmp_path):
    path = str(tmp_path / "run.hashlog")
    rec = HashLog("record")
    _run(rec)
    rec.save(path)
    chk = HashLog("check", path)
    _run(chk)
    assert chk.digest() == rec.digest()
    chk = HashLog("check", path)
    with pytest.raises(HashLogDivergence) as e:
        _run(chk, tamper_batch=3)
    assert e.value.op == 5
    assert e.value.kind == "prepare"


def test_reply_stream_catches_execution_divergence(tmp_path):
    path = str(tmp_path / "run.hashlog")
    rec = HashLog("record")
    _run(rec)
    rec.entries[5][1] ^= 1
    rec.save(path)
    with pytest.raises(HashLogDivergence) as e:
        _run(HashLog("check", path))
    assert e.value.op == 5
    assert e.value.kind == "reply"
