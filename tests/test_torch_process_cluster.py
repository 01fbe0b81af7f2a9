"""The port's server processes over real sockets on the CPU (`--device
cpu`): a three-replica TCP cluster with a backup killed and restarted, and
the two dual-backend server cases of tests/test_dual_backend.py
(`--backend native+device` and `--backend dual`) driven by four client
threads, each ending with the SIGTERM parity report."""

import threading
import time

import numpy as np
import pytest

import tests.conftest  # noqa: F401  (jax on the CPU before it initializes)
from tigerbeetle_tpu_torch import types
from tigerbeetle_tpu_torch.testing import process as P
from tigerbeetle_tpu_torch.types import Account, Operation, Transfer

SMALL = ("--grid-mb", "8", "--account-slots-log2", "10", "--transfer-slots-log2", "12",
         "--device", "cpu")


def test_three_replica_tcp_cluster(tmp_path):
    """Three port servers over real sockets, driven by the native C
    client; backup 2 is killed, misses a request, restarts from its data
    file and catches up to the primary's commit number."""
    from tigerbeetle_tpu_torch.client_ffi import NativeClient
    from tigerbeetle_tpu_torch.inspect import inspect_live

    ports = [P.free_port() for _ in range(3)]
    addresses = ",".join(f"127.0.0.1:{p}" for p in ports)
    paths = [str(tmp_path / f"r{i}.tb") for i in range(3)]
    procs = []
    try:
        for i, path in enumerate(paths):
            P.format_file(path, replica=i, replica_count=3)
        procs.extend(P.spawn_cluster(paths, addresses, args=SMALL))
        assert all(p.boot_lines == [] for p in procs)
        client = NativeClient(addresses)  # rotates to find the primary
        assert client.create_accounts([Account(id=i, ledger=1, code=1) for i in (1, 2)]) == []
        assert client.create_transfers([Transfer(id=10, debit_account_id=1, credit_account_id=2,
                                                 amount=42, ledger=1, code=1)]) == []
        P.kill_group(procs[2])
        assert client.create_transfers([Transfer(id=11, debit_account_id=2, credit_account_id=1,
                                                 amount=2, ledger=1, code=1)]) == []
        procs[2] = P.spawn(paths[2], addresses, replica=2, args=SMALL)[0]
        assert client.create_transfers([Transfer(id=12, debit_account_id=1, credit_account_id=2,
                                                 amount=1, ledger=1, code=1)]) == []
        accounts = client.lookup_accounts([1, 2])
        assert (accounts[0].debits_posted, accounts[0].credits_posted) == (43, 2)
        assert (accounts[1].debits_posted, accounts[1].credits_posted) == (2, 43)
        client.close()
        for _ in range(200):  # up to about 10 s for the backup to catch up
            lives = [inspect_live("127.0.0.1", p) for p in ports]
            if len({x["commit_min"] for x in lives}) == 1:
                break
            time.sleep(0.05)
        assert len({x["commit_min"] for x in lives}) == 1, lives
        assert [x["status"] for x in lives] == ["normal"] * 3
    finally:
        for p in procs:
            P.kill_group(p)


def _drive_e2e(tmp_path, backend):
    """tests/test_dual_backend.py's run_e2e shape: 200 accounts, one warm-up
    batch, then 64 x 8 transfers in batches of 64 from four client threads;
    returns the SIGTERM [stats]."""
    from tigerbeetle_tpu_torch.client_ffi import NativeClient

    path = str(tmp_path / "bench.tb")
    P.format_file(path)
    port = P.free_port()
    proc, _ = P.spawn(path, f"127.0.0.1:{port}", args=(
        "--grid-mb", "8", "--account-slots-log2", "14", "--transfer-slots-log2", "14",
        "--backend", backend, "--device", "cpu"))
    try:
        client = NativeClient("127.0.0.1", port)
        acct = np.zeros(200, dtype=types.ACCOUNT_DTYPE)
        acct["id_lo"] = np.arange(1, 201)
        acct["ledger"], acct["code"] = 1, 1
        assert client._request(Operation.create_accounts, acct.tobytes()) == b""
        rng = np.random.default_rng(7)

        def batch(first):
            x = np.zeros(64, dtype=types.TRANSFER_DTYPE)
            x["id_lo"] = np.arange(first, first + 64)
            x["debit_account_id_lo"] = rng.integers(1, 101, 64)
            x["credit_account_id_lo"] = rng.integers(101, 201, 64)
            x["amount_lo"] = rng.integers(1, 100, 64)
            x["ledger"], x["code"] = 1, 1
            return x.tobytes()

        assert client._request(Operation.create_transfers, batch(1_000_000)) == b""
        client.close()
        bodies = [batch(2_000_000 + 64 * i) for i in range(8)]
        errors = []

        def work(k):
            c = NativeClient("127.0.0.1", port)
            for body in bodies[k::4]:
                if c._request(Operation.create_transfers, body) != b"":
                    errors.append(k)
            c.close()

        threads = [threading.Thread(target=work, args=(k,)) for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors
        stats, _ = P.terminate(proc)
    finally:
        P.kill_group(proc)
    return stats


@pytest.mark.parametrize("backend", ["native+device", "dual"])
def test_dual_server_end_to_end(backend, tmp_path):
    stats = _drive_e2e(tmp_path, backend)
    shadow = stats.get("device_shadow")
    assert shadow is not None, stats
    assert shadow["verified"] is True, shadow
    assert shadow["shadow_batches"] >= 10  # accounts + warm-up + 8 timed
    d = shadow["code_stream_digest"]
    assert d["native"] == d["device"]
    if backend == "dual":
        assert shadow["hash_log"]["ok"] is True, shadow
        assert shadow["hash_log"]["ops"] >= 10
        assert "shadow.device_lag_ops" in stats["metrics"]["gauges"]
