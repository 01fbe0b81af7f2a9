"""The PyTorch port's device ledger against the JAX package, bit for bit.

- K1-K4 (lookup, account commit fast and serial, transfer commit fast and
  fast_pv with the wave mask, serial transfer commit) start from one JAX
  state carried across with tigerbeetle_tpu_torch.convert; result codes and
  every state leaf must match.
- DeviceLedger(mode=...) on WorkloadGenerator batches and on the wave
  scheduler's shapes, against the JAX DeviceLedger and the oracle: dense
  codes, plan decisions and raw tables.

The port runs its plain PyTorch versions on the CPU. Table leaves are
compared without their last row: the JAX kernels send masked writes there
(garbage by design, in unspecified scatter order) and the port never
writes it. Tolerance: zero.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tigerbeetle_tpu  # noqa: F401  (x64 before any input is built)
from tigerbeetle_tpu.constants import TEST_PROCESS as J_TEST_PROCESS
from tigerbeetle_tpu.models import ledger as jledger
from tigerbeetle_tpu.models.oracle import OracleStateMachine
from tigerbeetle_tpu.testing.workload import WorkloadGenerator
from tigerbeetle_tpu.types import (
    Account,
    AccountFlags,
    Operation,
    Transfer,
    TransferFlags,
    accounts_to_np,
    transfers_to_np,
)
from tigerbeetle_tpu_torch import convert
from tigerbeetle_tpu_torch.constants import TEST_PROCESS
from tigerbeetle_tpu_torch.models import ledger as tledger

F_LINKED = int(TransferFlags.linked)
F_PENDING = int(TransferFlags.pending)
F_POST = int(TransferFlags.post_pending_transfer)
F_VOID = int(TransferFlags.void_pending_transfer)
F_BAL_DR = int(TransferFlags.balancing_debit)
F_BAL_CR = int(TransferFlags.balancing_credit)
A_LOG2 = TEST_PROCESS.account_slots_log2
T_LOG2 = TEST_PROCESS.transfer_slots_log2


def jax_state_np(state) -> dict:
    return {k: np.asarray(v) for k, v in state.items()}


def assert_state_equal(want_np: dict, port_state: dict) -> None:
    got = convert.state_to_numpy(port_state)
    assert want_np.keys() == got.keys()
    for k, want in want_np.items():
        g = got[k]
        if want.ndim:  # tables: every row but the dump row
            want, g = want[:-1], g[:-1]
        assert g.dtype == want.dtype, k
        np.testing.assert_array_equal(g, want, err_msg=k)


# ----------------------------------------------------------------------
# K1-K4 from one JAX state
# ----------------------------------------------------------------------


def _base_state():
    """A JAX ledger with accounts (two ledgers, limit flags), transfers,
    open pendings and the tombstones of a rolled-back chain."""
    dev = jledger.DeviceLedger(process=J_TEST_PROCESS, mode="auto")
    ts = 10_000
    accts = [Account(id=i, ledger=1 if i <= 40 else 2, code=1,
                     flags=int(AccountFlags.debits_must_not_exceed_credits) if i == 7 else 0)
             for i in range(1, 61)]
    ts += len(accts)
    assert dev.execute_dense(Operation.create_accounts, ts, accts) == [0] * 60
    tr = [Transfer(id=1000 + i, debit_account_id=1 + i % 30, credit_account_id=2 + i % 30,
                   amount=10 + i, ledger=1, code=1) for i in range(40)]
    tr += [Transfer(id=2000 + i, debit_account_id=3 + i % 20, credit_account_id=25 + i % 10,
                    amount=50 + i, ledger=1, code=1, flags=F_PENDING) for i in range(20)]
    tr += [  # a chain that breaks: its inserts leave tombstones
        Transfer(id=3000, debit_account_id=1, credit_account_id=2, amount=5, ledger=1,
                 code=1, flags=F_LINKED),
        Transfer(id=3001, debit_account_id=2, credit_account_id=3, amount=5, ledger=1,
                 code=1, flags=F_LINKED),
        Transfer(id=3002, debit_account_id=2, credit_account_id=3, amount=0, ledger=1, code=1),
    ]
    ts += len(tr)
    dense = dev.execute_dense(Operation.create_transfers, ts, tr)
    assert dense[-3:] == [1, 1, 18]
    dev.check_fault()
    return jax_state_np(dev.state), ts


@pytest.fixture(scope="module")
def base():
    return _base_state()


def _pad(rows: np.ndarray, n_pad: int) -> np.ndarray:
    out = np.zeros((n_pad, 32), dtype=np.uint32)
    out[: len(rows)] = rows.view(np.uint32).reshape(len(rows), 32)
    return out


def _run_both(base_np, jax_call, port_call):
    """Run one kernel on a fresh copy of the state in each package; return
    (JAX codes, port codes, JAX state as numpy, port state)."""
    js = {k: jnp.asarray(v) for k, v in base_np.items()}
    ts = convert.state_from_numpy(base_np, "cpu")
    js, r_j = jax_call(js)
    r_t = port_call(ts)
    return np.asarray(r_j), r_t.numpy().view(np.uint32), jax_state_np(js), ts


def test_k1_lookup(base):
    base_np, _ = base
    kern = jledger.get_kernels(J_TEST_PROCESS)
    ids = list(range(1, 70)) + [0, (1 << 128) - 1, 1000, 1039, 1040, 2005, 3000, 3001]
    n = len(ids)
    js = {k: jnp.asarray(v) for k, v in base_np.items()}
    ts = convert.state_from_numpy(base_np, "cpu")
    key4 = tledger.ids_to_batch(ids, "cpu")["key4"]
    for table, jfn, log2 in (("acct_rows", kern.lookup_accounts, A_LOG2),
                             ("xfer_rows", kern.lookup_transfers, T_LOG2)):
        fj, rj, resj = jfn(js, jledger.ids_to_batch(ids, 128))
        ft, rt, rest = tledger.table_lookup(key4, ts[table], log2)
        np.testing.assert_array_equal(ft.numpy(), np.asarray(fj)[:n])
        np.testing.assert_array_equal(rt.numpy().view(np.uint32), np.asarray(rj)[:n])
        np.testing.assert_array_equal(rest.numpy(), np.asarray(resj)[:n])
        assert ft.any() and not ft.all()


def _account_batch(serial: bool):
    accts = [Account(id=100 + i, ledger=1, code=1) for i in range(40)]
    accts += [
        Account(id=3, ledger=1, code=1),  # exists
        Account(id=4, ledger=2, code=1),  # exists_with_different_ledger
        Account(id=0, ledger=1, code=1),
        Account(id=200, ledger=0, code=1),
        Account(id=201, ledger=1, code=1, reserved=1),
        Account(id=202, ledger=1, code=1, flags=6),
        Account(id=203, ledger=1, code=1, debits_posted=5),
    ]
    if serial:
        accts += [
            Account(id=300, ledger=1, code=1, flags=1),
            Account(id=301, ledger=1, code=1, flags=1),
            Account(id=5, ledger=1, code=1),  # exists: breaks the chain
            Account(id=310, ledger=1, code=1, flags=1),
            Account(id=311, ledger=1, code=1),
            Account(id=100, ledger=1, code=1),  # duplicate of an in-batch id
            Account(id=320, ledger=1, code=1, flags=1),  # chain left open
        ]
    return accounts_to_np(accts)


@pytest.mark.parametrize("mode", ["fast", "serial"])
def test_k2_commit_accounts(base, mode):
    base_np, t0 = base
    kern = jledger.get_kernels(J_TEST_PROCESS)
    arr = _account_batch(mode == "serial")
    n = len(arr)
    ts = t0 + 1000
    rows_t = tledger.accounts_to_batch(arr, "cpu")["rows"]
    fn = tledger.commit_accounts_serial if mode == "serial" else tledger.commit_accounts_fast
    r_j, r_t, s_j, s_t = _run_both(
        base_np,
        lambda js: kern.commit_accounts(js, {"rows": jnp.asarray(_pad(arr, 64))},
                                        jnp.int32(n), jnp.uint64(ts), mode=mode),
        lambda st: fn(st, rows_t, n, ts, A_LOG2),
    )
    np.testing.assert_array_equal(r_t, r_j[:n])
    assert r_j[:n].any() and not r_j[:n].all()
    assert_state_equal(s_j, s_t)


def _transfer_batch(pv: bool):
    tr = [Transfer(id=5000 + i, debit_account_id=1 + i % 35, credit_account_id=2 + (i * 7) % 35,
                   amount=1 + i, ledger=1, code=1, flags=F_PENDING if i % 5 == 0 else 0)
          for i in range(40) if 1 + i % 35 != 2 + (i * 7) % 35]
    tr += [
        Transfer(id=5100, debit_account_id=99, credit_account_id=2, amount=1, ledger=1, code=1),
        Transfer(id=5101, debit_account_id=1, credit_account_id=99, amount=1, ledger=1, code=1),
        Transfer(id=5102, debit_account_id=1, credit_account_id=50, amount=1, ledger=1, code=1),
        Transfer(id=5103, debit_account_id=50, credit_account_id=51, amount=1, ledger=1, code=1),
        Transfer(id=1000, debit_account_id=1, credit_account_id=2, amount=10, ledger=1, code=1),
        Transfer(id=1001, debit_account_id=2, credit_account_id=3, amount=11, ledger=1, code=1),
        Transfer(id=1002, debit_account_id=1, credit_account_id=2, amount=10, ledger=1, code=1),
        Transfer(id=5104, debit_account_id=1, credit_account_id=2, amount=0, ledger=1, code=1),
        Transfer(id=5105, debit_account_id=1, credit_account_id=2, amount=1, ledger=1, code=1,
                 timeout=3),
        Transfer(id=0, debit_account_id=1, credit_account_id=2, amount=1, ledger=1, code=1),
        Transfer(id=5106, debit_account_id=1, credit_account_id=2, amount=1 << 127, ledger=1,
                 code=1, flags=F_PENDING),
    ]
    if pv:
        tr += [Transfer(id=6000 + i, pending_id=2000 + i, amount=0 if i % 3 else 10,
                        flags=F_POST if i % 2 else F_VOID) for i in range(12)]
        tr += [
            Transfer(id=6100, pending_id=1005, flags=F_POST),  # not pending
            Transfer(id=6101, pending_id=7777, flags=F_VOID),  # not found
            Transfer(id=6102, pending_id=2015, amount=1000, flags=F_POST),  # exceeds
            Transfer(id=6103, pending_id=2016, amount=1, flags=F_VOID),  # different amount
            Transfer(id=6104, pending_id=2017, flags=F_POST | F_VOID),
        ]
    return transfers_to_np(tr)


@pytest.mark.parametrize("mode", ["fast", "fast_pv"])
def test_k3_commit_transfers(base, mode):
    base_np, t0 = base
    kern = jledger.get_kernels(J_TEST_PROCESS)
    arr = _transfer_batch(mode == "fast_pv")
    n = len(arr)
    ts = t0 + 1000
    mask = None
    mask_j = np.zeros(128, dtype=bool)
    mask_j[:n] = True
    if mode == "fast_pv":  # a wave: only some lanes are live
        mask_j[:n] = np.random.default_rng(3).random(n) < 0.75
        mask = torch.from_numpy(mask_j[:n].copy())
    rows_t = tledger.transfers_to_batch(arr, "cpu")["rows"]
    r_j, r_t, s_j, s_t = _run_both(
        base_np,
        lambda js: kern.commit_transfers(
            js, {"rows": jnp.asarray(_pad(arr, 128)), "mask": jnp.asarray(mask_j)},
            jnp.int32(n), jnp.uint64(ts), mode=mode),
        lambda st: tledger.commit_transfers_fast(st, rows_t, n, ts, A_LOG2, T_LOG2,
                                                 mode == "fast_pv", mask),
    )
    np.testing.assert_array_equal(r_t, r_j[:n])
    assert (r_j[:n] == 0).sum() > 10 and len(np.unique(r_j[:n])) > 6
    assert_state_equal(s_j, s_t)


def _serial_batch():
    tr = [
        Transfer(id=7000, debit_account_id=1, credit_account_id=2, amount=5, ledger=1, code=1,
                 flags=F_LINKED),
        Transfer(id=7001, debit_account_id=2, credit_account_id=3, amount=5, ledger=1, code=1,
                 flags=F_LINKED | F_PENDING),
        Transfer(id=7002, debit_account_id=3, credit_account_id=4, amount=5, ledger=1, code=1),
        Transfer(id=7010, debit_account_id=1, credit_account_id=2, amount=5, ledger=1, code=1,
                 flags=F_LINKED),
        Transfer(id=7011, pending_id=2001, flags=F_POST | F_LINKED),
        Transfer(id=7012, debit_account_id=3, credit_account_id=3, amount=5, ledger=1,
                 code=1),  # breaks the chain: post rolled back
        Transfer(id=7020, debit_account_id=8, credit_account_id=7, amount=40, ledger=1, code=1),
        Transfer(id=7021, debit_account_id=7, credit_account_id=9, amount=100, ledger=1,
                 code=1),  # limit account: exceeds_credits
        Transfer(id=7022, debit_account_id=7, credit_account_id=9, amount=0, ledger=1, code=1,
                 flags=F_BAL_DR),
        Transfer(id=7023, debit_account_id=9, credit_account_id=10, amount=0, ledger=1, code=1,
                 flags=F_BAL_CR),
        Transfer(id=7030, debit_account_id=11, credit_account_id=12, amount=9, ledger=1,
                 code=1, flags=F_PENDING),
        Transfer(id=7031, pending_id=7030, amount=4, flags=F_POST),
        Transfer(id=7032, pending_id=7030, flags=F_VOID),  # already posted
        Transfer(id=7033, pending_id=2002, flags=F_VOID),
        Transfer(id=7040, debit_account_id=13, credit_account_id=14, amount=2, ledger=1, code=1),
        Transfer(id=7040, debit_account_id=13, credit_account_id=14, amount=3, ledger=1, code=1),
        Transfer(id=7040, debit_account_id=13, credit_account_id=14, amount=2, ledger=1, code=1),
        Transfer(id=7050, debit_account_id=1, credit_account_id=2, amount=1, ledger=1, code=1,
                 flags=F_LINKED),  # chain left open
    ]
    return transfers_to_np(tr)


@pytest.mark.parametrize("entry", ["serial", "residue"])
def test_k4_serial_transfers(base, entry):
    base_np, t0 = base
    kern = jledger.get_kernels(J_TEST_PROCESS)
    arr = _serial_batch()
    n = len(arr)
    t_end = t0 + 1000
    if entry == "serial":
        ts_np = np.uint64(t_end - n + 1) + np.arange(n, dtype=np.uint64)
    else:  # a residue keeps its events' original, scattered timestamps
        ts_np = np.uint64(t0 + 500) + np.arange(n, dtype=np.uint64) * np.uint64(3)
    ts_pad = np.zeros(32, dtype=np.uint64)
    ts_pad[:n] = ts_np
    rows_t = tledger.transfers_to_batch(arr, "cpu")["rows"]

    def jax_call(js):
        batch = {"rows": jnp.asarray(_pad(arr, 32))}
        if entry == "serial":
            return kern.commit_transfers(js, batch, jnp.int32(n), jnp.uint64(t_end), mode="serial")
        return kern.commit_transfers_residue(js, {**batch, "ts": jnp.asarray(ts_pad)},
                                             jnp.int32(n))

    r_j, r_t, s_j, s_t = _run_both(
        base_np, jax_call,
        lambda st: tledger.commit_transfers_serial(
            st, rows_t, torch.from_numpy(ts_np.view(np.int64)), n, A_LOG2, T_LOG2),
    )
    np.testing.assert_array_equal(r_t, r_j[:n])
    assert {1, 2, 33, 54}.issubset(set(r_j[:n].tolist())), r_j[:n]
    assert_state_equal(s_j, s_t)


def test_sticky_fault_and_capacity_gate(base):
    """A faulted state turns every commit into a no-op in both packages;
    the serial entry gate charges all n events against the load limit."""
    base_np, t0 = base
    kern = jledger.get_kernels(J_TEST_PROCESS)
    faulted = dict(base_np, fault=np.uint32(jledger.FAULT_PROBE))
    arr = _transfer_batch(False)
    n = len(arr)
    rows_t = tledger.transfers_to_batch(arr, "cpu")["rows"]
    r_j, r_t, s_j, s_t = _run_both(
        faulted,
        lambda js: kern.commit_transfers(js, {"rows": jnp.asarray(_pad(arr, 128))},
                                         jnp.int32(n), jnp.uint64(t0 + 99), mode="fast"),
        lambda st: tledger.commit_transfers_fast(st, rows_t, n, t0 + 99, A_LOG2, T_LOG2, False),
    )
    np.testing.assert_array_equal(r_t, r_j[:n])
    assert_state_equal(s_j, s_t)
    assert_state_equal(faulted, s_t)  # nothing applied
    full = dict(base_np, xfer_used_slots=np.uint64((1 << T_LOG2) // 2 - 3))
    arr = _serial_batch()
    n = len(arr)
    rows_t = tledger.transfers_to_batch(arr, "cpu")["rows"]
    r_j, r_t, s_j, s_t = _run_both(
        full,
        lambda js: kern.commit_transfers(js, {"rows": jnp.asarray(_pad(arr, 32))},
                                         jnp.int32(n), jnp.uint64(t0 + 99), mode="serial"),
        lambda st: tledger.commit_transfers_serial(
            st, rows_t, tledger.batch_timestamps(t0 + 99, n, n, "cpu"), n, A_LOG2, T_LOG2),
    )
    np.testing.assert_array_equal(r_t, r_j[:n])
    assert int(s_j["fault"]) == jledger.FAULT_CAPACITY
    assert_state_equal(s_j, s_t)


def _exhausted(base_np, tombs: int):
    """The base state with every empty transfer slot filled with a random
    row and `tombs` random slots turned into tombstones: probe windows find
    no empty slot, so lookups do not resolve and inserts can only reuse
    tombstones."""
    rng = np.random.default_rng(tombs)
    rows = base_np["xfer_rows"].copy()
    empty = np.nonzero((rows[:-1, :4] == 0).all(1))[0]
    rows[empty] = rng.integers(1, 1 << 32, (len(empty), 32), dtype=np.uint64).astype(np.uint32)
    rows[rng.choice(len(rows) - 1, tombs, replace=False)] = 0xFFFFFFFF
    return dict(base_np, xfer_rows=rows)


@pytest.mark.parametrize("mode", ["fast", "serial"])
def test_exhausted_probe_windows(base, mode):
    """Windows with no empty slot: the fast commit must fault before any
    write (probe and claim bits); the serial scan marks the state corrupt
    and goes on applying, with the JAX package's choice of slot for every
    unresolved probe."""
    base_np, t0 = base
    kern = jledger.get_kernels(J_TEST_PROCESS)
    start = _exhausted(base_np, tombs=600)
    arr = _transfer_batch(False) if mode == "fast" else _serial_batch()
    n, n_pad, ts = len(arr), 128 if mode == "fast" else 32, t0 + 1000
    rows_t = tledger.transfers_to_batch(arr, "cpu")["rows"]

    def port(st):
        if mode == "fast":
            return tledger.commit_transfers_fast(st, rows_t, n, ts, A_LOG2, T_LOG2, False)
        ts_vec = tledger.batch_timestamps(ts, n, n, "cpu")
        return tledger.commit_transfers_serial(st, rows_t, ts_vec, n, A_LOG2, T_LOG2)

    r_j, r_t, s_j, s_t = _run_both(
        start,
        lambda js: kern.commit_transfers(js, {"rows": jnp.asarray(_pad(arr, n_pad))},
                                         jnp.int32(n), jnp.uint64(ts), mode=mode),
        port,
    )
    np.testing.assert_array_equal(r_t, r_j[:n])
    want = jledger.FAULT_SERIAL if mode == "serial" else jledger.FAULT_PROBE
    assert int(s_j["fault"]) & want
    assert_state_equal(s_j, s_t)


# ----------------------------------------------------------------------
# DeviceLedger against the JAX DeviceLedger and the oracle
# ----------------------------------------------------------------------


class Trio:
    """The oracle, the JAX DeviceLedger and the port's DeviceLedger (plain
    versions on the CPU), fed the same batches."""

    def __init__(self, mode="auto"):
        self.oracle = OracleStateMachine()
        self.jax = jledger.DeviceLedger(process=J_TEST_PROCESS, mode=mode)
        self.port = tledger.DeviceLedger(process=TEST_PROCESS, mode=mode, device="cpu")

    def run(self, op, ts, events):
        dense_o = self.oracle.execute_dense(op, ts, events)
        dense_j = self.jax.execute_dense(op, ts, events)
        dense_t = self.port.execute_dense(op, ts, events)
        assert dense_t == dense_j == dense_o, [
            (i, t, j, o) for i, (t, j, o) in enumerate(zip(dense_t, dense_j, dense_o))
            if not t == j == o
        ][:8]
        assert self.port.hazards.plan_stats == self.jax.hazards.plan_stats
        assert self.port._xfer_used == self.jax._xfer_used
        assert self.port._acct_used == self.jax._acct_used
        return dense_t

    def check_state(self):
        assert_state_equal(jax_state_np(self.jax.state), self.port.state)
        accounts, transfers, posted = self.port.extract()
        # the port has its own Account/Transfer classes: compare field values
        assert fields(accounts) == fields(self.oracle.accounts)
        assert fields(transfers) == fields(self.oracle.transfers)
        assert posted == self.oracle.posted
        assert self.port.commit_timestamp == self.oracle.commit_timestamp


def fields(objs):
    """{id: record} -> {id: field dict}, for records of either package."""
    if isinstance(objs, dict):
        return {k: dataclasses.asdict(v) for k, v in objs.items()}
    return [dataclasses.asdict(v) for v in objs]


def run_workload(seed, n_batches, batch_size, mode, **wl_kwargs):
    trio = Trio(mode)
    gen = WorkloadGenerator(seed, **wl_kwargs)
    ts = 1_000_000_000
    for b in range(n_batches):
        if b % 4 == 0:
            op, events = gen.gen_accounts_batch(batch_size)
        else:
            op, events = gen.gen_transfers_batch(batch_size)
        ts += len(events)
        trio.run(op, ts, events)
        if b % 4 == 3:
            trio.check_state()
    trio.check_state()
    return trio, gen


@pytest.mark.parametrize("seed", [3, 4])
def test_auto_workload_parity(seed):
    trio, gen = run_workload(seed, n_batches=8, batch_size=32, mode="auto")
    st = trio.port.hazards.plan_stats
    assert st["fast"] + st["fast_pv"] + st["serial"] + st["waves"] == 6
    ids_a = gen.account_ids[:30] + [12345, 0]
    ids_t = gen.transfer_ids[:30] + [6789]
    assert fields(trio.port.lookup_accounts(ids_a)) == fields(trio.jax.lookup_accounts(ids_a)) \
        == fields(trio.oracle.lookup_accounts(ids_a))
    assert fields(trio.port.lookup_transfers(ids_t)) \
        == fields(trio.jax.lookup_transfers(ids_t)) \
        == fields(trio.oracle.lookup_transfers(ids_t))


def test_serial_workload_parity():
    run_workload(1, n_batches=6, batch_size=24, mode="serial")


def test_forced_fast_clean_workload_parity():
    run_workload(6, n_batches=8, batch_size=40, mode="fast", chain_rate=0.0,
                 two_phase_rate=0.0, balancing_rate=0.0, limit_account_rate=0.0,
                 conflict_rate=0.0, invalid_rate=0.3)


def _trio_with_accounts(n_accounts=24, limit_accounts=(), funded=200):
    trio = Trio("auto")
    ts = 10_000
    accounts = [
        Account(id=i, ledger=1, code=1,
                flags=int(AccountFlags.debits_must_not_exceed_credits)
                if i in limit_accounts else 0)
        for i in range(1, n_accounts + 1)
    ]
    ts += len(accounts)
    trio.run(Operation.create_accounts, ts, accounts)
    if limit_accounts:
        fund = [Transfer(id=900_000 + a, debit_account_id=n_accounts, credit_account_id=a,
                         amount=funded, ledger=1, code=1) for a in limit_accounts]
        ts += len(fund)
        trio.run(Operation.create_transfers, ts, fund)
    return trio, ts


def _deep_limit_batch():
    n = jledger.WAVE_CAP + 8
    tr = []
    for i in range(n):
        tr.append(Transfer(id=7000 + i, debit_account_id=5, credit_account_id=6 + i % 8,
                           amount=2, ledger=1, code=1))
        tr.append(Transfer(id=7500 + i, debit_account_id=10 + i % 20,
                           credit_account_id=31 + i % 16, amount=1, ledger=1, code=1))
    return tr


def _chains_next_to_waves():
    return [
        Transfer(id=9000, debit_account_id=1, credit_account_id=2, amount=5, ledger=1, code=1,
                 flags=F_LINKED | F_PENDING),
        Transfer(id=9001, debit_account_id=1, credit_account_id=2, amount=0, ledger=1, code=1),
        Transfer(id=9002, pending_id=9000, amount=5, flags=F_POST),
        Transfer(id=9010, debit_account_id=3, credit_account_id=4, amount=2, ledger=1, code=1,
                 flags=F_LINKED),
        Transfer(id=9011, debit_account_id=3, credit_account_id=4, amount=2, ledger=1, code=1),
    ] + [
        t for i in range(8) for t in (
            Transfer(id=9100 + i, debit_account_id=5 + i % 6, credit_account_id=11 + i % 6,
                     amount=9, ledger=1, code=1, flags=F_PENDING),
            Transfer(id=9200 + i, pending_id=9100 + i, amount=4, flags=F_POST),
        )
    ]


def _pend_post_void_races():
    return [
        Transfer(id=8000, debit_account_id=1, credit_account_id=2, amount=30, ledger=1, code=1,
                 flags=F_PENDING),
        Transfer(id=8001, pending_id=8000, amount=30, flags=F_POST),
        Transfer(id=8002, pending_id=8000, flags=F_VOID),
        Transfer(id=8003, pending_id=8010, amount=5, flags=F_POST),
        Transfer(id=8010, debit_account_id=3, credit_account_id=4, amount=5, ledger=1, code=1,
                 flags=F_PENDING),
        Transfer(id=8020, debit_account_id=5, credit_account_id=6, amount=7, ledger=1, code=1,
                 flags=F_PENDING),
        Transfer(id=8021, pending_id=8020, flags=F_VOID),
        Transfer(id=8022, pending_id=8020, amount=7, flags=F_POST),
        Transfer(id=9500, debit_account_id=1, credit_account_id=1, amount=1, ledger=1, code=1),
        Transfer(id=9500, debit_account_id=1, credit_account_id=2, amount=1, ledger=1, code=1),
        Transfer(id=9500, debit_account_id=1, credit_account_id=2, amount=2, ledger=1, code=1),
    ] + [
        Transfer(id=8100 + i, debit_account_id=7 + i % 8, credit_account_id=15 + i % 8,
                 amount=1, ledger=1, code=1)
        for i in range(16)
    ]


@pytest.mark.parametrize("case,setup,batch,decision,residue", [
    ("deeper_than_cap", dict(n_accounts=48, limit_accounts=(5,), funded=3 * 32),
     _deep_limit_batch, "waves", True),
    ("chains_next_to_waves", {}, _chains_next_to_waves, "waves", True),
    ("pend_post_void_races", {}, _pend_post_void_races, "waves", False),
])
def test_wave_and_residue_parity(case, setup, batch, decision, residue):
    trio, ts = _trio_with_accounts(**setup)
    tr = batch()
    arr = transfers_to_np(tr)
    probe_j = jledger.HazardTracker()
    probe_t = tledger.HazardTracker()
    for probe, src in ((probe_j, trio.jax.hazards), (probe_t, trio.port.hazards)):
        probe.limit_account_ids = set(src.limit_account_ids)
        probe._limit_lo = src._limit_lo.copy()
        probe.pending_accounts = dict(src.pending_accounts)
    (dj, pj), (dt, pt) = probe_j.plan(arr.copy()), probe_t.plan(arr.copy())
    assert dj == dt == decision
    assert pj.wave_of.tobytes() == pt.wave_of.tobytes()
    assert (pj.n_waves, pj.has_pv, pj.residue_n) == (pt.n_waves, pt.has_pv, pt.residue_n)
    assert (pt.residue_n > 0) == residue
    ts += len(tr)
    trio.run(Operation.create_transfers, ts, tr)
    trio.check_state()


def test_capacity_guard_and_fault_check():
    from tigerbeetle_tpu_torch.constants import ConfigProcess

    dev = tledger.DeviceLedger(ConfigProcess(account_slots_log2=4, transfer_slots_log2=6),
                               device="cpu")
    accounts = [Account(id=i, ledger=1, code=1) for i in range(1, 16)]
    with pytest.raises(RuntimeError, match="load-factor"):
        dev.execute_dense(Operation.create_accounts, 100, accounts)
    dev.check_fault()
    dev.state["fault"].fill_(tledger.FAULT_SERIAL)
    with pytest.raises(RuntimeError, match="CORRUPT"):
        dev.check_fault()
