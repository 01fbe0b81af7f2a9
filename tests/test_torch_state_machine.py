"""StateMachine over the PyTorch port against StateMachine over the JAX
package: the same wire bodies in, byte-identical replies out.

Both backends are DeviceLedgers at the test geometry; the port runs its
plain PyTorch versions on the CPU.
"""

import numpy as np
import pytest

import tigerbeetle_tpu  # noqa: F401  (x64 before any input is built)
from tigerbeetle_tpu import state_machine as jsm
from tigerbeetle_tpu.constants import TEST_PROCESS as J_TEST_PROCESS
from tigerbeetle_tpu.models.ledger import DeviceLedger as JaxLedger
from tigerbeetle_tpu.testing.workload import WorkloadGenerator
from tigerbeetle_tpu.types import (
    Account,
    Operation,
    Transfer,
    accounts_to_np,
    transfers_to_np,
)
from tigerbeetle_tpu_torch import state_machine as tsm
from tigerbeetle_tpu_torch.constants import TEST_PROCESS
from tigerbeetle_tpu_torch.models.ledger import DeviceLedger as PortLedger


def _pair():
    return (jsm.StateMachine(JaxLedger(process=J_TEST_PROCESS, mode="auto")),
            tsm.StateMachine(PortLedger(TEST_PROCESS, device="cpu")))


def _bodies(seed, n_batches, size):
    gen = WorkloadGenerator(seed)
    out = []
    for b in range(n_batches):
        if b % 3 == 0:
            op, events = gen.gen_accounts_batch(size)
            out.append((op, accounts_to_np(events).tobytes()))
        else:
            op, events = gen.gen_transfers_batch(size)
            out.append((op, transfers_to_np(events).tobytes()))
    for kind in ("accounts", "transfers"):
        op, ids = gen.gen_lookup_batch(size, kind)
        out.append((op, jsm.encode_ids(ids)))
    return out


@pytest.mark.parametrize("seed", [11])
def test_commit_reply_bytes(seed):
    sm_j, sm_t = _pair()
    ts = 10**9
    replies = 0
    for op, body in _bodies(seed, 7, 32):
        assert sm_t.input_valid(op, body) == sm_j.input_valid(op, body)
        assert sm_t.input_count(op, body) == sm_j.input_count(op, body)
        sm_j.prepare(op, body)
        sm_t.prepare(op, body)
        assert sm_t.prepare_timestamp == sm_j.prepare_timestamp
        ts = sm_j.prepare_timestamp + 10**9
        r_j = sm_j.commit(op, ts, body)
        r_t = sm_t.commit(op, ts, body)
        assert r_t == r_j, (op, tsm.decode_results(r_t, op) if op < 130 else len(r_t))
        replies += len(r_t)
    assert replies > 0


def test_commit_async_finish():
    sm_j, sm_t = _pair()
    ts = 10**9
    bodies = _bodies(13, 5, 24)
    handles = []
    for op, body in bodies:
        ts += 100
        handles.append((sm_j.commit_async(op, ts, body), sm_t.commit_async(op, ts, body)))
    assert sm_t.backend.hazards.plan_stats == sm_j.backend.hazards.plan_stats
    for h_j, h_t in handles:
        assert sm_t.commit_finish(h_t) == sm_j.commit_finish(h_j)
        assert sm_t.handle_plan(h_t) == sm_j.handle_plan(h_j)
    sm_t.backend.check_fault()

    # group commit: three create_transfers bodies fused into one dispatch
    # (one padding slot), some of whose events fail
    ts += 100
    accounts = [Account(id=9000 + i, ledger=1, code=1) for i in range(8)]
    body = accounts_to_np(accounts).tobytes()
    for sm in (sm_j, sm_t):
        sm.prepare(Operation.create_accounts, body)
    assert sm_t.commit(Operation.create_accounts, ts, body) == \
        sm_j.commit(Operation.create_accounts, ts, body)
    batches = []
    for b, size in enumerate((20, 32, 7)):
        tr = [Transfer(id=70_000 + 100 * b + i, debit_account_id=9000 + i % 8,
                       credit_account_id=9000 + (i + 1 + b) % 8, amount=0 if i % 9 == 4 else i,
                       ledger=1, code=1) for i in range(size)]
        ts += size
        batches.append((ts, transfers_to_np(tr).tobytes()))
    g_j = sm_j.commit_group_async(Operation.create_transfers, batches)
    g_t = sm_t.commit_group_async(Operation.create_transfers, batches)
    assert g_j is not None and g_t is not None and len(g_t) == 3
    sm_j.commit_finish_many(g_j)
    sm_t.commit_finish_many(g_t)
    replies = [sm_t.commit_finish(h) for h in g_t]
    assert replies == [sm_j.commit_finish(h) for h in g_j]
    assert all(replies) and [sm_t.handle_plan(h) for h in g_t] == [None] * 3
    assert sm_t.commit_group_async(Operation.create_transfers, batches[:1]) is None
    sm_t.backend.check_fault()
    for op in Operation:
        assert sm_t.batch_max(op) == sm_j.batch_max(op)


def test_encode_decode_helpers():
    codes = np.array([0, 3, 0, 46, 0, 0, 1], dtype=np.uint32)
    for op in (Operation.create_accounts, Operation.create_transfers):
        assert tsm.encode_sparse_results(codes, op) == jsm.encode_sparse_results(codes, op)
        sparse = [(1, 3), (3, 46), (6, 1)]
        assert tsm.encode_results(sparse, op) == jsm.encode_results(sparse, op)
        assert tsm.decode_results(tsm.encode_results(sparse, op), op) == sparse
    ids = [1, (1 << 128) - 1, 1 << 64, 12345]
    assert tsm.encode_ids(ids) == jsm.encode_ids(ids)
    assert tsm.decode_ids(tsm.encode_ids(ids)) == ids
