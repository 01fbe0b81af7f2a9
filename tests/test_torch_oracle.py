"""The port's scalar oracle (`tigerbeetle_tpu_torch/models/oracle.py`) and
workload generator against the JAX package's.

Every scenario of `tests/test_oracle.py` runs twice: as written, and with
its module names (the oracle, the record classes, the flags and result
enums) pointed at the port. Each oracle it builds records its execute()
calls; the two runs must give the same sparse results call for call, and
each oracle the same `fingerprint()` and `snapshot_bytes()` (which reach a
checkpoint blob). Exact: everything compared is integers or bytes."""

import inspect
import types as pytypes

import numpy as np
import pytest

import tests.test_oracle as JT
from tigerbeetle_tpu import constants as JC
from tigerbeetle_tpu import types as JTY
from tigerbeetle_tpu.models.oracle import OracleStateMachine as JOracle
from tigerbeetle_tpu.testing.workload import WorkloadGenerator as JGen
from tigerbeetle_tpu_torch import constants as PC
from tigerbeetle_tpu_torch import types as PTY
from tigerbeetle_tpu_torch.models.ledger import fp_rows_np
from tigerbeetle_tpu_torch.models.oracle import OracleStateMachine as POracle
from tigerbeetle_tpu_torch.testing.workload import WorkloadGenerator as PGen

SCENARIOS = sorted(name for name, fn in vars(JT).items()
                   if name.startswith("test_") and inspect.isfunction(fn))


def _recording(cls, log):
    class Recording(cls):
        def __init__(self):
            super().__init__()
            self.calls = []
            log.append(self)

        def execute(self, operation, timestamp, events):
            out = super().execute(operation, timestamp, events)
            self.calls.append((int(operation), timestamp, [(int(i), int(r)) for i, r in out]))
            return out

    return Recording


def _rebound(oracle_cls, tys, consts):
    """The scenario module's functions with their globals pointed at one
    package (a fresh namespace, so the two runs share nothing)."""
    g = dict(vars(JT))
    g.update(OracleStateMachine=oracle_cls, Account=tys.Account, Transfer=tys.Transfer,
             AccountFlags=tys.AccountFlags, AR=tys.CreateAccountResult,
             TR=tys.CreateTransferResult, Operation=tys.Operation, F=tys.TransferFlags,
             NS_PER_S=consts.NS_PER_S, U64_MAX=consts.U64_MAX, U128_MAX=consts.U128_MAX)
    for name, fn in vars(JT).items():
        if inspect.isfunction(fn) and fn.__globals__ is vars(JT):
            g[name] = pytypes.FunctionType(fn.__code__, g, name, fn.__defaults__, fn.__closure__)
    return g


def _record(oracles):
    return [(o.calls, o.fingerprint(), o.snapshot_bytes()) for o in oracles]


@pytest.mark.parametrize("name", SCENARIOS)
def test_oracle_scenario_equals_jax(name):
    jax_log, port_log = [], []
    _rebound(_recording(JOracle, jax_log), JTY, JC)[name]()
    _rebound(_recording(POracle, port_log), PTY, PC)[name]()
    assert len(port_log) == len(jax_log) >= 1
    assert _record(port_log) == _record(jax_log)


def _drive_workload(gen_cls, oracle, seed, tys, rounds=6):
    gen = gen_cls(seed)
    ts, out = 0, []
    for _ in range(rounds):
        op, accounts = gen.gen_accounts_batch(50)
        ts += len(accounts)
        out.append(tys.accounts_to_np(accounts).tobytes())
        out.append(oracle.execute_dense(op, ts, accounts))
        op, transfers = gen.gen_transfers_batch(200)
        ts += len(transfers)
        out.append(tys.transfers_to_np(transfers).tobytes())
        out.append(oracle.execute_dense(op, ts, transfers))
        for kind in ("accounts", "transfers"):
            op, ids = gen.gen_lookup_batch(16, kind)
            out.append((int(op), ids))
    return out


@pytest.mark.parametrize("seed", range(8))
def test_workload_batches_and_oracle_equal_jax(seed):
    """The same seed gives the same wire bytes batch for batch, and both
    oracles the same codes, state and serialization on them."""
    jo, po = JOracle(), POracle()
    assert _drive_workload(PGen, po, seed, PTY) == _drive_workload(JGen, jo, seed, JTY)
    assert po.fingerprint() == jo.fingerprint()
    assert po.snapshot_bytes() == jo.snapshot_bytes()
    afp, alive = fp_rows_np(PTY.accounts_to_np(list(po.accounts.values())))
    assert (afp, alive) == (po.fingerprint()["accounts_fp"], len(po.accounts))


@pytest.mark.parametrize("seed", [0, 5])
def test_restore_bytes_crosses_packages(seed):
    jo, po = JOracle(), POracle()
    _drive_workload(JGen, jo, seed, JTY, rounds=3)
    _drive_workload(PGen, po, seed, PTY, rounds=3)
    back_p, back_j = POracle(), JOracle()
    back_p.restore_bytes(jo.snapshot_bytes())
    back_j.restore_bytes(po.snapshot_bytes())
    assert back_p.snapshot_bytes() == back_j.snapshot_bytes() == po.snapshot_bytes()
    assert back_p.fingerprint() == jo.fingerprint()
    assert back_p.commit_timestamp == jo.commit_timestamp
    accounts, transfers, posted = back_p.extract()
    assert posted == jo.posted
    assert PTY.accounts_to_np([accounts[k] for k in sorted(accounts)]).tobytes() == \
        JTY.accounts_to_np([jo.accounts[k] for k in sorted(jo.accounts)]).tobytes()
    assert PTY.transfers_to_np([transfers[k] for k in sorted(transfers)]).tobytes() == \
        JTY.transfers_to_np([jo.transfers[k] for k in sorted(jo.transfers)]).tobytes()


def test_verify_audits_run_and_agree(monkeypatch):
    """With VERIFY on, both oracles audit conservation every eighth batch
    and still agree; a broken balance trips the port's audit."""
    monkeypatch.setattr(PC, "VERIFY", True)
    monkeypatch.setattr(JC, "VERIFY", True)
    jo, po = JOracle(), POracle()
    port = _drive_workload(PGen, po, 3, PTY, rounds=8)
    assert port == _drive_workload(JGen, jo, 3, JTY, rounds=8)
    assert po._audit_count == jo._audit_count == 16
    victim = next(iter(po.accounts.values()))
    victim.debits_posted += 1
    with pytest.raises(AssertionError, match="conservation"):
        po.verify_conservation()


def test_wire_rows_execute_like_records():
    """execute() on wire rows (a structured array) gives what it gives on
    record classes."""
    gen = PGen(11)
    a, b = POracle(), POracle()
    op, accounts = gen.gen_accounts_batch(64)
    rows = PTY.accounts_to_np(accounts)
    assert a.execute(op, 64, accounts) == b.execute(op, 64, rows)
    op, transfers = gen.gen_transfers_batch(128)
    rows = PTY.transfers_to_np(transfers)
    assert a.execute(op, 300, transfers) == b.execute(op, 300, np.array(rows))
    assert a.snapshot_bytes() == b.snapshot_bytes()
