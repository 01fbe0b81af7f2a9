"""The port's column-wise change-record encoder (`cdc.record.encode_lines`,
which the live pump runs) against the JAX package's per-record encoder,
`record_line` over `encode_batch`, byte for byte: random account and
transfer rows (every transfer flag, 128-bit values with both halves set,
zero fields), with the results unknown, all ok, and sparse failures."""

from types import SimpleNamespace

import numpy as np
import pytest

import tigerbeetle_tpu  # noqa: F401  (x64 before any input is built)
from tigerbeetle_tpu.cdc import record as j_record
from tigerbeetle_tpu_torch import types
from tigerbeetle_tpu_torch.cdc import record as t_record

N = 2048
FLAGS = [0, 1, 2, 4, 8, 16, 32, 3, 2 | 16, 64]


def _rows(dtype, rng):
    rows = np.zeros(N, dtype=dtype)
    for name in dtype.names:
        kind, size = dtype[name].kind, dtype[name].itemsize
        if kind != "u":
            continue
        values = rng.integers(0, 2 ** min(8 * size, 63), N, dtype=np.uint64)
        rows[name] = (values * (rng.random(N) < 0.7)).astype(dtype[name])
    if dtype is types.TRANSFER_DTYPE:
        rows["flags"] = rng.choice(FLAGS, N)
    return rows


def _reply(kind, rng):
    if kind == "unknown":
        return None
    if kind == "ok":
        return b""
    sparse = np.zeros(N // 3, dtype=types.CREATE_TRANSFERS_RESULT_DTYPE)
    sparse["index"] = np.sort(rng.choice(N, N // 3, replace=False))
    sparse["result"] = rng.integers(1, 60, N // 3)
    return sparse.tobytes()


@pytest.mark.parametrize("reply", ["unknown", "ok", "failures"])
@pytest.mark.parametrize("operation", ["create_accounts", "create_transfers"])
def test_encode_lines_equals_the_jax_records(operation, reply):
    rng = np.random.default_rng(len(operation) * 7 + len(reply))
    dtype = (types.ACCOUNT_DTYPE if operation == "create_accounts"
             else types.TRANSFER_DTYPE)
    body = _rows(dtype, rng).tobytes()
    reply_body = _reply(reply, rng)
    header = SimpleNamespace(operation=int(types.Operation[operation]), op=77,
                             timestamp=1_700_000_000_000_000_000)
    want = [j_record.record_line(r) for r in j_record.encode_batch(header, body, reply_body)]
    got = t_record.encode_lines(header, body, reply_body)
    assert len(got) == N
    assert got == want


def test_encode_lines_of_other_operations_is_empty():
    header = SimpleNamespace(operation=int(types.Operation.lookup_accounts), op=3,
                             timestamp=10)
    assert t_record.encode_lines(header, b"\0" * 32, b"") == []
