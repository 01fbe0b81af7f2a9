"""The port's replica over its other backends, bit for bit against the JAX
replica: the native engine (`NativeLedger`), the sharded ledger
(`ShardedLedger(8, ..., device="cpu")` against the JAX one on the
conftest's 8-device CPU mesh), both on the scenarios of
`tests/test_mesh_replica.py`; and the dual-commit follower
(`DualLedger(..., follower=True, device="cpu")`) on the Cluster cases of
`tests/test_dual_backend.py` (a checkpoint mid apply lag and a restart; the
lag bounded by admission under a slow applier). The follower's replies and
checkpoints are the native engine's, so its run is held against the JAX
replica over the JAX native engine on the same requests."""

import numpy as np
import pytest

from tigerbeetle_tpu.testing.cluster import Cluster as JCluster
from tigerbeetle_tpu.vsr.header import Header as JHeader
from tigerbeetle_tpu_torch.constants import ConfigProcess
from tigerbeetle_tpu_torch.models.dual_ledger import DualLedger
from tigerbeetle_tpu_torch.models.native_ledger import NativeLedger
from tigerbeetle_tpu_torch.parallel.mesh import ShardedLedger
from tigerbeetle_tpu_torch.testing import cluster_cases as C
from tigerbeetle_tpu_torch.testing.cluster import Cluster
from tigerbeetle_tpu_torch.types import Operation
from tigerbeetle_tpu_torch.vsr.header import Header

SCENARIOS = {"commit": C.backend_commit, "checkpoint_restart": C.backend_checkpoint_restart}


def _assert_equal(a_records, b_records):
    assert len(a_records) == len(b_records)
    for a, b in zip(a_records, b_records):
        assert a["replies"] == b["replies"]
        assert a["replicas"] == b["replicas"]


def _check(name, recs):
    bodies = [body for _h, body in recs[-1]["replies"]]
    if name == "commit":
        rows = np.frombuffer(bodies[2], dtype=np.uint64).reshape(-1, 16)
        assert rows.shape[0] == 24 and rows[:, 4].sum() == 96  # debits_posted_lo
        assert bodies[3] != b""  # the resubmission fails `exists`
    else:
        assert recs[-1]["replicas"][0]["commit_min"] > recs[-1]["replicas"][0]["checkpoint_op"]
        rows = np.frombuffer(bodies[3], dtype=np.uint64).reshape(-1, 16)
        assert rows.shape[0] == 8


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_replica_over_native_ledger(name):
    from tigerbeetle_tpu.models.native_ledger import NativeLedger as JNativeLedger

    a = SCENARIOS[name](JCluster, JHeader, backend_factory=lambda: JNativeLedger(10, 12))
    b = SCENARIOS[name](Cluster, Header, device="cpu",
                        backend_factory=lambda: NativeLedger(10, 12))
    _assert_equal(a, b)
    _check(name, b)


@pytest.fixture(scope="module")
def mesh8():
    import jax
    from jax.sharding import Mesh

    devices = jax.devices()
    assert len(devices) >= 8, "the conftest gives 8 virtual CPU devices"
    return Mesh(np.array(devices[:8]), ("shard",))


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_replica_over_sharded_ledger(mesh8, name):
    from tigerbeetle_tpu.constants import ConfigProcess as JConfigProcess
    from tigerbeetle_tpu.parallel.mesh import ShardedLedger as JShardedLedger

    jp = JConfigProcess(account_slots_log2=8, transfer_slots_log2=10)
    tp = ConfigProcess(account_slots_log2=8, transfer_slots_log2=10)
    a = SCENARIOS[name](JCluster, JHeader, process=jp,
                        backend_factory=lambda: JShardedLedger(mesh8, jp))
    b = SCENARIOS[name](Cluster, Header, device="cpu", process=tp,
                        backend_factory=lambda: ShardedLedger(8, tp, device="cpu"))
    _assert_equal(a, b)
    _check(name, b)
    # the sharded blob was checkpointed and its dump rows masked, not skipped
    if name == "checkpoint_restart":
        blobs = b[-1]["replicas"][0]["storage"]["superblock"][0]["blobs"]
        assert [x["name"] for x in blobs] == ["oracle"] and blobs[0]["size"] > 0


def _valid_accounts(start: int, n: int) -> bytes:
    return C.accounts_body(range(start, start + n))


def _valid_transfers(start: int, n: int, flags: int = 0, pend_ids=None) -> bytes:
    k = np.arange(n)
    if pend_ids is None:
        return C.transfers_array(start + k, 1 + k % 9, 1 + (k + 1) % 9, 1, flags).tobytes()
    return C.transfers_array(start + k, 0, 0, 0, flags, pend_ids).tobytes()


def _mid_lag_run(cluster, dual: bool):
    """`test_dual_follower_checkpoint_restart_mid_lag`'s requests; with
    `dual`, the applier is slowed to build real lag before the checkpoint,
    and the checks of that test run."""
    r = cluster.replicas[0]
    c = cluster.add_client()
    replies = [cluster.execute(c, int(Operation.create_accounts), _valid_accounts(1, 10))]
    for g in range(3):
        replies.append(cluster.execute(c, int(Operation.create_transfers),
                                       _valid_transfers(100 + 32 * g, 32)))
    if dual:
        assert r._dual_apply
        r.ledger._test_apply_delay_s = 0.2
    for g in range(3):
        replies.append(cluster.execute(c, int(Operation.create_transfers),
                                       _valid_transfers(500 + 32 * g, 32)))
    if dual:
        assert r.ledger.apply_lag_ops() > 0, "the test built no apply lag"
        r.ledger._test_apply_delay_s = 0.0
    r.checkpoint()
    if dual:
        assert r.ledger.apply_lag_ops() == 0, "the checkpoint must drain the applier"
    replies.append(cluster.execute(c, int(Operation.create_transfers),
                                   _valid_transfers(700, 32)))
    r2 = cluster.restart_replica(0)
    assert r2.commit_min > r2.checkpoint_op  # the tail replayed
    c2 = cluster.add_client()
    pend = C.transfers_array(800 + np.arange(16), 1 + np.arange(16) % 9,
                             1 + (np.arange(16) + 1) % 9, 1, flags=2)
    replies.append(cluster.execute(c2, int(Operation.create_transfers), pend.tobytes()))
    replies.append(cluster.execute(c2, int(Operation.create_transfers),
                                   _valid_transfers(900, 16, flags=4, pend_ids=pend["id_lo"])))
    assert all(body == b"" for _h, body in replies)
    if dual:
        assert r2.ledger.drain_applier(500)
        report = r2.ledger.finalize(timeout=500)
        assert report["verified"] is True, report
        assert report["hash_log"]["ok"] is True
    return C.cluster_record(cluster, replies)


def test_dual_follower_checkpoint_restart_mid_lag():
    from tigerbeetle_tpu.models.native_ledger import NativeLedger as JNativeLedger

    port = _mid_lag_run(Cluster(replica_count=1, device="cpu", backend_factory=lambda:
                                DualLedger(12, 14, follower=True, device="cpu")), dual=True)
    ref = _mid_lag_run(JCluster(replica_count=1,
                                backend_factory=lambda: JNativeLedger(12, 14)), dual=False)
    assert port == ref


def test_dual_follower_backpressure_bounds_lag():
    """Sustained overload against a slow applier: the lag excess feeds
    `ingress_occupancy`, the credit regulator (the JAX package's, over the
    port's replica) sheds, and the lag stays within the window plus one
    pipeline cap."""
    import time

    from tigerbeetle_tpu.ingress import CreditRegulator

    cluster = Cluster(replica_count=1, device="cpu", backend_factory=lambda: DualLedger(
        12, 14, follower=True, lag_window=2, device="cpu"))
    r = cluster.replicas[0]
    c = cluster.add_client()
    cluster.execute(c, int(Operation.create_accounts), _valid_accounts(1, 10))
    cluster.execute(c, int(Operation.create_transfers), _valid_transfers(100, 8))
    r.ledger._test_apply_delay_s = 0.25
    reg = CreditRegulator(r)
    _used, cap = r.ingress_occupancy()
    shed = admitted = max_lag = 0
    for g in range(12):
        if not reg.try_admit():
            shed += 1
            reg.drain()
            time.sleep(0.02)
        else:
            _h, body = cluster.execute(c, int(Operation.create_transfers),
                                       _valid_transfers(1000 + 8 * g, 8))
            assert body == b""
            admitted += 1
        max_lag = max(max_lag, r.ledger.apply_lag_ops())
    assert shed > 0, "the regulator never shed under applier overload"
    assert admitted > 0
    assert max_lag <= r.ledger.lag_window + cap, (max_lag, cap)
    r.ledger._test_apply_delay_s = 0.0
    assert r.ledger.drain_applier(500)
    report = r.ledger.finalize(timeout=500)
    assert report["verified"] is True, report
