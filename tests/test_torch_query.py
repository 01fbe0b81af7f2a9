"""The secondary-index queries of the PyTorch port against the JAX package,
bit for bit: the equality filter scan (K8) and `DeviceLedger.query_accounts`
/ `query_transfers`.

The port runs its plain PyTorch version of K8 on the CPU; the JAX package
runs its jitted `LedgerKernels.filter_scan` on the CPU, as its own tests run
it. Inputs come from seeds (numpy, testing.workload.WorkloadGenerator).
Tolerance: zero. The query paths over a spilling ledger are held in
tests/test_torch_spill.py.
"""

import dataclasses
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tigerbeetle_tpu  # noqa: F401  (x64 before any input is built)
from tigerbeetle_tpu.constants import ConfigProcess as JConfigProcess
from tigerbeetle_tpu.constants import TEST_PROCESS as J_TEST_PROCESS
from tigerbeetle_tpu.models import ledger as jledger
from tigerbeetle_tpu.testing.workload import WorkloadGenerator
from tigerbeetle_tpu_torch import types as ttypes
from tigerbeetle_tpu_torch.constants import TEST_PROCESS, ConfigProcess
from tigerbeetle_tpu_torch.models import ledger as tledger
from tigerbeetle_tpu_torch.types import Operation

LOG2 = 14  # 2^14 slots: more than QUERY_LIMIT rows can match
FIELDS = [("acct", f) for f in tledger.ACCOUNT_QUERY_WORDS] + [
    ("xfer", f) for f in tledger.TRANSFER_QUERY_WORDS
]


def test_query_words_match_the_jax_package():
    assert tledger.ACCOUNT_QUERY_WORDS == jledger._ACCOUNT_QUERY_WORDS
    assert tledger.TRANSFER_QUERY_WORDS == jledger._TRANSFER_QUERY_WORDS
    assert tledger.QUERY_LIMIT == jledger.QUERY_LIMIT


def scan_table(rng, spec, value_words):
    """A [2^14 + 1, 32] u32 table: ~8% empty slots, ~4% tombstones, a
    nonzero dump row; 11,000 random slots (live or not) hold the value in
    the field, 300 more match on the field's first word only (a near miss
    for wide fields), and a half-word field's high 16 bits are random."""
    n = (1 << LOG2) + 1
    rows = rng.integers(0, 1 << 32, (n, 32), dtype=np.uint64).astype(np.uint32)
    slots = rng.permutation(n - 1)
    rows[slots[:1300], :4] = 0
    rows[slots[1300:2000], :4] = 0xFFFFFFFF
    word0, nwords, halfword = spec
    hits = rng.choice(n, 11_000, replace=False)  # the dump row may be among them
    if halfword:
        rows[hits, word0] = (rows[hits, word0] & 0xFFFF0000) | value_words[0]
    else:
        rows[hits, word0:word0 + nwords] = value_words[:nwords]
        near = rng.choice(n, 300, replace=False)
        rows[near, word0] = value_words[0]
    return rows


def run_both(table, field, rows, value_words):
    log2 = LOG2
    jk = jledger.get_kernels(JConfigProcess(account_slots_log2=log2, transfer_slots_log2=log2))
    j_rows, j_total = jk.filter_scan(table, field)(
        jnp.asarray(rows), jnp.asarray(np.array(value_words, dtype=np.uint32))
    )
    spec = (tledger.ACCOUNT_QUERY_WORDS if table == "acct" else tledger.TRANSFER_QUERY_WORDS)[field]
    t_rows, t_total = tledger.filter_scan(
        torch.from_numpy(rows.view(np.int32)), log2, spec, value_words
    )
    assert t_rows.dtype == torch.int32 and t_total.dtype == torch.int32
    assert int(t_total) == int(j_total)
    np.testing.assert_array_equal(t_rows.numpy().view(np.uint32), np.asarray(j_rows))
    return int(t_total)


@pytest.mark.parametrize("table,field", FIELDS)
def test_filter_scan_plain_matches_jax(table, field):
    """K8's plain version against the JAX filter_scan on every indexed field
    of both tables: more than QUERY_LIMIT matches (the first ones in slot
    order), a few matches (padded with the nonzero dump row), none."""
    spec = (tledger.ACCOUNT_QUERY_WORDS if table == "acct" else tledger.TRANSFER_QUERY_WORDS)[field]
    rng = np.random.default_rng(zlib.crc32(f"{table}.{field}".encode()))
    width = 16 if spec[2] else 32 * spec[1]
    value = int(rng.integers(1, 1 << min(width, 62))) | (1 << (width - 1))
    vw = [(value >> (32 * i)) & 0xFFFFFFFF for i in range(4)]
    rows = scan_table(rng, spec, vw)
    assert run_both(table, field, rows, vw) > tledger.QUERY_LIMIT
    # a handful of live matches: the tail is the dump row's content
    live = ~((rows[:-1, :4] == 0).all(1) | (rows[:-1, :4] == 0xFFFFFFFF).all(1))
    few = np.nonzero(live)[0][:37]
    other = [((value + 1) % (1 << width)) >> (32 * i) & 0xFFFFFFFF for i in range(4)]
    rows2 = rows.copy()
    w0, nw, half = spec
    if half:
        rows2[few, w0] = (rows2[few, w0] & 0xFFFF0000) | other[0]
    else:
        rows2[few, w0:w0 + nw] = other[:nw]
    assert run_both(table, field, rows2, other) == 37
    assert run_both(table, field, rows, [0, 0, 0, 0] if width < 32 else [7, 7, 7, 7]) == 0


def fields(objs):
    return [dataclasses.asdict(o) for o in objs]


def test_query_parity_without_spill():
    """DeviceLedger.query_accounts / query_transfers of the port against the
    JAX ledger's on a resident-only workload (the fields and values of
    tests/test_query_index.py), results in ascending timestamp order."""
    jd = jledger.DeviceLedger(process=J_TEST_PROCESS, mode="auto")
    td = tledger.DeviceLedger(TEST_PROCESS, device="cpu")
    gen = WorkloadGenerator(21, ledgers=(1, 2, 3), invalid_rate=0.05)
    ts = 1_000_000_000
    for b in range(8):
        op, events = gen.gen_accounts_batch(40) if b % 3 == 0 else gen.gen_transfers_batch(40)
        ts += len(events)
        assert jd.execute_dense(op, ts, events) == td.execute_dense(op, ts, events)
    n_hits = 0
    for field in ("ledger", "code", "user_data_32", "debits_posted"):
        for v in (0, 1, 2, 3, 77):
            got = td.query_accounts(field, v)
            assert fields(got) == fields(jd.query_accounts(field, v)), (field, v)
            n_hits += len(got)
    some_acct = next(iter(jd.extract()[0]))
    for field, v in (
        ("ledger", 1), ("ledger", 2), ("code", 50), ("code", 7),
        ("debit_account_id", some_acct), ("credit_account_id", some_acct),
        ("amount", 1), ("timeout", 0), ("pending_id", 0), ("user_data_64", 0),
        ("user_data_128", 0),
    ):
        got = td.query_transfers(field, v)
        assert fields(got) == fields(jd.query_transfers(field, v)), (field, v)
        assert [t.timestamp for t in got] == sorted(t.timestamp for t in got)
        n_hits += len(got)
    assert n_hits > 100


def test_query_value_range_checks():
    """A copy of tests/test_query_index.py's argument checks."""
    td = tledger.DeviceLedger(TEST_PROCESS, device="cpu")
    with pytest.raises(ValueError):
        td.query_transfers("code", 1 << 16)
    with pytest.raises(ValueError):
        td.query_accounts("ledger", 1 << 32)
    with pytest.raises(ValueError):
        td.query_transfers("amount", -1)
    with pytest.raises(KeyError):
        td.query_transfers("flags", 1)  # not indexed (reference: ignored)
    with pytest.raises(KeyError):
        td.query_accounts("id", 1)


def test_query_limit():
    """More than QUERY_LIMIT matching rows raise, on the device scan alone;
    one row fewer in the match does not."""
    td = tledger.DeviceLedger(ConfigProcess(account_slots_log2=10, transfer_slots_log2=15),
                              device="cpu")
    acc = np.zeros(2, dtype=ttypes.ACCOUNT_DTYPE)
    acc["id_lo"] = [1, 2]
    acc["ledger"] = 7
    acc["code"] = 1
    assert td.execute_dense(Operation.create_accounts, 10, acc) == [0, 0]
    n = tledger.QUERY_LIMIT + 1
    t = np.zeros(n, dtype=ttypes.TRANSFER_DTYPE)
    t["id_lo"] = np.arange(100, 100 + n)
    t["debit_account_id_lo"] = 1
    t["credit_account_id_lo"] = 2
    t["amount_lo"] = 1
    t["ledger"] = 7
    t["code"] = 3
    t["code"][0] = 4  # one row with another code
    for lo in range(0, n, 8190):
        part = t[lo:lo + 8190]
        assert not any(td.execute_dense(Operation.create_transfers, 100 + lo + len(part), part))
    with pytest.raises(RuntimeError, match="QUERY_LIMIT"):
        td.query_transfers("ledger", 7)
    got = td.query_transfers("code", 3)
    assert len(got) == tledger.QUERY_LIMIT
    assert [x.id for x in got] == list(range(101, 101 + tledger.QUERY_LIMIT))
    assert len(td.query_accounts("ledger", 7)) == 2

