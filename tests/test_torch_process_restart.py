"""Durability of the port's server process on the CPU: kill -9 and a
restart from the data file answer byte-identical lookups (timestamps
included: the WAL replays each prepare's own timestamp), the AOF holds the
committed history for either package's replay, and a data file written by
one package's server, killed, is restarted by the other's server with the
same answers. The JAX server runs its native backend here: a data file
without a checkpoint holds no backend's state, only the WAL, and the JAX
device backend would compile its kernels anew in the replay."""

import pytest

import tests.conftest  # noqa: F401  (jax on the CPU before it initializes)
from tigerbeetle_tpu_torch.testing import process as P
from tigerbeetle_tpu_torch.types import Account, Operation

SMALL = ("--grid-mb", "8", "--account-slots-log2", "10", "--transfer-slots-log2", "12")
PORT = (P.MODULE, (*SMALL, "--backend", "device", "--device", "cpu"), None)
JAX = ("tigerbeetle_tpu", (*SMALL, "--backend", "native"), {"TB_JAX_PLATFORM": "cpu"})


def _start(path, side, extra=()):
    module, args, env = side
    port = P.free_port()
    proc, _ = P.spawn(path, f"127.0.0.1:{port}", args=(*args, *extra), module=module, env=env)
    return proc, port


def _lookups(port, stream):
    from tigerbeetle_tpu_torch.client_ffi import NativeClient

    client = NativeClient("127.0.0.1", port)  # a fresh client id each time
    try:
        return P.run_stream(client, stream[-2:], timestamps=True)
    finally:
        client.close()


def _kill9(proc):
    P.kill_group(proc)
    assert proc.returncode is not None


def test_kill9_restart_gives_identical_lookups_and_the_aof_replays(tmp_path):
    from tigerbeetle_tpu import aof as j_aof
    from tigerbeetle_tpu_torch import aof as t_aof
    from tigerbeetle_tpu_torch.client_ffi import NativeClient

    path, log = str(tmp_path / "data.tb"), str(tmp_path / "data.aof")
    P.format_file(path)
    stream = P.request_stream()
    procs = []
    try:
        proc, port = _start(path, PORT, ("--aof", log))
        procs.append(proc)
        client = NativeClient("127.0.0.1", port)
        first = P.run_stream(client, stream, timestamps=True)
        client.close()
        _kill9(proc)  # no cleanup: the WAL and the AOF are all there is

        t_ops, j_ops = list(t_aof.replay(log)), list(j_aof.replay(log))
        assert [(h.to_bytes(), b) for h, b in t_ops] == [(h.to_bytes(), b) for h, b in j_ops]
        creates = [h for h, _ in t_ops if h.operation in (int(Operation.create_accounts),
                                                         int(Operation.create_transfers))]
        assert len(creates) == 5 and all(h.valid_checksum() for h in creates)

        proc, port = _start(path, PORT, ("--aof", log + "2"))
        procs.append(proc)
        assert _lookups(port, stream) == first[-2:]
        client = NativeClient("127.0.0.1", port)
        assert client.create_accounts([Account(id=600, ledger=1, code=1)]) == []
        client.close()
        _kill9(proc)
        proc, port = _start(path, PORT)
        procs.append(proc)
        assert proc.boot_lines == []  # "listening" is the first line
        assert _lookups(port, stream) == first[-2:]
    finally:
        for p in procs:
            P.kill_group(p)


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_a_data_file_restarts_across_packages(writer, reader, tmp_path):
    from tigerbeetle_tpu_torch.client_ffi import NativeClient

    sides = {"port": PORT, "jax": JAX}
    path = str(tmp_path / "data.tb")
    P.format_file(path, module=sides[writer][0], env=sides[writer][2])
    stream = P.request_stream(base=5000)
    procs = []
    try:
        proc, port = _start(path, sides[writer])
        procs.append(proc)
        client = NativeClient("127.0.0.1", port)
        first = P.run_stream(client, stream, timestamps=True)
        client.close()
        _kill9(proc)
        proc, port = _start(path, sides[reader])
        procs.append(proc)
        assert _lookups(port, stream) == first[-2:]
        # and the other package's server goes on serving writes on it
        client = NativeClient("127.0.0.1", port)
        assert client.create_accounts([Account(id=700, ledger=1, code=1)]) == []
        client.close()
    finally:
        for p in procs:
            P.kill_group(p)
