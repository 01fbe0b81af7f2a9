"""The port's spilling cluster against the JAX package's: three replicas
with a forest block area each (`tests/test_cluster_spill.py`,
`test_cluster_spills_identically_and_syncs`) spill their cold transfer tail
alike, and a backup detached past its WAL catches up by state sync with the
forest blocks. After each step, bit for bit: every reply, every replica's
commit numbers, hash chain, spilled set and cycle count, and its storage
zone by zone, the grid's forest blocks included (the checkpoint blobs but
their dump rows)."""

from tigerbeetle_tpu.testing.cluster import Cluster as JCluster
from tigerbeetle_tpu.vsr.header import Header as JHeader
from tigerbeetle_tpu_torch.testing import cluster_cases as C
from tigerbeetle_tpu_torch.testing.cluster import Cluster
from tigerbeetle_tpu_torch.vsr.header import Header


def test_cluster_spills_identically_and_syncs():
    jax_records = C.spill_and_sync(JCluster, JHeader)
    port_records = C.spill_and_sync(Cluster, Header, device="cpu")
    for step, (a, b) in enumerate(zip(jax_records, port_records)):
        assert a["replies"] == b["replies"], step
        for i, (ra, rb) in enumerate(zip(a["replicas"], b["replicas"])):
            assert ra == rb, (step, i)
    first, detached, synced = port_records
    assert all(r["cycles"] >= 1 and r["spilled"] for r in first["replicas"])
    assert detached["replicas"][0]["checkpoint_op"] > 0
    head = synced["replicas"][0]
    assert synced["replicas"][2]["commit_min"] == head["commit_min"]
    assert synced["replicas"][2]["spilled"] == head["spilled"]
    assert any(body for _h, body in synced["replies"])
