"""The port's durability against the JAX package's: `DurableLedger` (format,
WAL-before-commit, a checkpoint at the WAL wrap, a restart that restores
the blobs and replays the WAL tail) gives the JAX replies and the JAX
storage bytes but for the dump rows; and a checkpoint written by either
package's replica restores in the other's, which then commits the same
replies as the replica that wrote it."""

import importlib
import types as pytypes

import pytest

from tigerbeetle_tpu_torch.testing import cluster_cases as C
from tigerbeetle_tpu_torch.types import Operation

PACKAGES = ("tigerbeetle_tpu", "tigerbeetle_tpu_torch")


def _pkg(name: str):
    ns = pytypes.SimpleNamespace()
    for m in ("constants", "io.storage", "vsr.durable", "vsr.client", "testing.cluster"):
        setattr(ns, m.split(".")[-1], importlib.import_module(f"{name}.{m}"))
    return ns


@pytest.fixture(scope="module")
def both():
    return [_pkg(p) for p in PACKAGES]


def _on_cpu(p) -> dict:
    """The port's constructors take device="cpu"; the JAX ones take none."""
    return {"device": "cpu"} if p.constants.__name__.startswith("tigerbeetle_tpu_torch") else {}


def _durable(p, storage):
    d = p.durable.DurableLedger(storage, p.constants.TEST_CLUSTER, p.constants.TEST_PROCESS,
                                **_on_cpu(p))
    d.open()
    return d


def _durable_run(p):
    layout = p.storage.ZoneLayout(p.constants.TEST_CLUSTER, grid_size=8 * 1024 * 1024)
    storage = p.storage.MemoryStorage(layout, seed=3)
    p.durable.format_data_file(storage, p.constants.TEST_CLUSTER)
    d = _durable(p, storage)
    req = C.Requests(12)
    interval = p.constants.TEST_CLUSTER.checkpoint_interval
    replies = [d.submit(op, body) for op, body in req.mixed(interval + 5, batch_size=6)]
    assert d.checkpoint_op > 0
    lookup = (Operation.lookup_accounts, C.encode_ids(req.accounts))
    replies.append(d.submit(*lookup))
    rec = [C.storage_record(storage, p.constants.TEST_PROCESS), d.op, d.parent_checksum]
    # restart over the surviving bytes: the blobs restore, the tail replays
    d2 = _durable(p, storage)
    assert (d2.op, d2.parent_checksum) == (d.op, d.parent_checksum)
    replies.append(d2.submit(*lookup))
    replies += [d2.submit(op, body) for op, body in req.mixed(3, batch_size=6)]
    rec += [C.storage_record(storage, p.constants.TEST_PROCESS), d2.op, d2.checkpoint_op]
    return replies, rec


def test_durable_ledger_checkpoint_restart(both):
    (ja, jr), (ta, tr) = (_durable_run(p) for p in both)
    assert ja == ta
    assert jr == tr
    assert any(ja) and ja[-4] == ja[-5]  # failures seen; a lookup the same after restart


def _cross_run(src, dst):
    """A one-replica cluster of `src` commits, checkpoints and commits a WAL
    tail; its storage bytes go into a `dst` cluster, whose replica opens
    them. Both then take the same requests from the same client."""
    a = src.cluster.Cluster(replica_count=1, **_on_cpu(src))
    client = a.add_client()
    req = C.Requests(17)
    for op, body in req.mixed(9, batch_size=12):
        a.execute(client, op, body)
    a.replicas[0].checkpoint()
    for op, body in req.mixed(4, batch_size=12)[1:]:
        a.execute(client, op, body)
    b = dst.cluster.Cluster(replica_count=1, **_on_cpu(dst))
    b.storages[0].data[:] = a.storages[0].data
    r = b.restart_replica(0)
    assert r.commit_min == a.replicas[0].commit_min > r.checkpoint_op > 0
    twin = dst.client.Client(client.client_id, b.network, 1)
    twin.session, twin.request_number = client.session, client.request_number
    out = []
    for op, body in req.mixed(5, batch_size=12) + [
            (int(Operation.lookup_accounts), C.encode_ids(req.accounts)),
            (int(Operation.lookup_transfers), C.encode_ids(range(1 << 20, (1 << 20) + 60)))]:
        ha, ra = a.execute(client, op, body)
        hb, rb = b.execute(twin, op, body)
        assert (ha.to_bytes(), ra) == (hb.to_bytes(), rb)
        out.append(ra)
    assert any(out[:-2]) and out[-1]
    assert r.commit_min == a.replicas[0].commit_min


def test_jax_checkpoint_restores_in_port(both):
    j, t = both
    _cross_run(j, t)


def test_port_checkpoint_restores_in_jax(both):
    j, t = both
    _cross_run(t, j)


def test_restore_rejects_a_bad_blob():
    """A blob whose bytes no longer match its checksum refuses to restore."""
    from tigerbeetle_tpu_torch.constants import TEST_CLUSTER, TEST_PROCESS
    from tigerbeetle_tpu_torch.io.storage import MemoryStorage, Zone, ZoneLayout
    from tigerbeetle_tpu_torch.vsr.durable import DurableLedger, format_data_file

    storage = MemoryStorage(ZoneLayout(TEST_CLUSTER, grid_size=8 * 1024 * 1024))
    format_data_file(storage, TEST_CLUSTER)
    d = DurableLedger(storage, TEST_CLUSTER, TEST_PROCESS, device="cpu")
    d.open()
    d.submit(*C.Requests(1).accounts_batch(8))
    d.checkpoint()
    ref = d.superblock.state.blobs[1]
    storage.fault(Zone.grid, ref.offset + 4096, 8)
    with pytest.raises(RuntimeError, match="bad checksum"):
        DurableLedger(storage, TEST_CLUSTER, TEST_PROCESS, device="cpu").open()
