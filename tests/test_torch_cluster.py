"""The port's replica and cluster harness against the JAX package's: the
JAX `Cluster` and the port's `Cluster(device="cpu")`, both with
TEST_CLUSTER, TEST_PROCESS and the device backend, run the scenarios of
`tests/test_cluster.py` on the same seeded requests
(`tigerbeetle_tpu_torch/testing/cluster_cases.py`). Bit for bit after each
step: every reply (header and body), every replica's commit numbers and
prepare hash chain, and every replica's storage zone by zone (the WAL and
client replies whole, the checkpoint blobs but their dump rows, the
superblock copies but the checksums of the blobs holding dump rows)."""

import pytest

from tigerbeetle_tpu.testing.cluster import Cluster as JCluster
from tigerbeetle_tpu.vsr.header import Header as JHeader
from tigerbeetle_tpu_torch.testing import cluster_cases as C
from tigerbeetle_tpu_torch.testing.cluster import Cluster
from tigerbeetle_tpu_torch.vsr.header import Header


def run_both(name, **port_kw):
    scenario = C.SCENARIOS[name]
    jax_records = scenario(JCluster, JHeader)
    port_records = scenario(Cluster, Header, device="cpu", **port_kw)
    assert len(jax_records) == len(port_records)
    for step, (a, b) in enumerate(zip(jax_records, port_records)):
        assert a["replies"] == b["replies"], (name, step)
        for i, (ra, rb) in enumerate(zip(a["replicas"], b["replicas"])):
            assert ra == rb, (name, step, i)
        assert a == b, (name, step)
    return port_records


def _converged(rec, replicas=(0, 1, 2)):
    rs = [rec["replicas"][i] for i in replicas]
    assert len({r["commit_min"] for r in rs}) == 1, [r["commit_min"] for r in rs]
    assert len({r["commit_checksum"] for r in rs}) == 1


@pytest.mark.parametrize("name", sorted(C.SCENARIOS))
def test_port_cluster_equals_jax(name):
    recs = run_both(name)
    last = recs[-1]
    bodies = [body for _h, body in last["replies"]]
    if name == "commit_and_converge":
        _converged(last)
        assert any(bodies[1:-1]), "no request failed an event: the codes went unchecked"
        assert len(bodies[-1]) == 16 * 128  # the lookup found every account
    elif name == "duplicate_request":
        assert last["replies"][-1] == last["replies"][-2]  # answered from the table
    elif name == "backup_restart":
        _converged(recs[0])
        _converged(last)
    elif name == "checkpoint_and_restart":
        assert all(r["checkpoint_op"] > 0 for r in last["replicas"])
        _converged(last)
    elif name == "pipelined_clients":
        _converged(last)
    elif name == "reply_persisted":
        assert len(last["replies"]) == 2, "the retransmit got no reply"
        assert last["replies"][1][0][:16] == last["replies"][0][0][:16]  # same checksum
    elif name == "group_commit":
        assert last["fused_ops"] >= 4, "the group commit never fused"
        assert bodies[-1] != b"" and not any(bodies[1:-1])
    elif name == "standby_follows":
        _converged(recs[0], (0, 1, 2, 3))
        _converged(last, (1, 2, 3))
