"""The port's sharded ledger against the JAX package's, bit for bit (serial tiers).

Hazard batches (linked chains, post/void, balancing, duplicate ids, limit
accounts) go to the serial scans on both, where every lookup is an
owner-masked probe of all shards and every write lands on its owner shard;
a broken chain rolls back each shard's writes. Compared per batch as in
tests/test_torch_mesh.py (codes, every shard's tables but the dump rows,
per-shard counters, scalars, fault, host guard), with the oracle as a third
party. Tolerance: zero.
"""

import numpy as np
import pytest

from tests.test_torch_mesh import (  # noqa: F401  (the mesh fixture)
    Pair,
    base,
    fields,
    kernel_pair,
    mesh,
    owned_by,
    rows_of,
    run_workload,
)
from tigerbeetle_tpu.types import Account, Operation, Transfer, TransferFlags
from tigerbeetle_tpu_torch.models import ledger as tledger

S = 8


@pytest.mark.parametrize("seed", [11, 12])
def test_hazard_workload(mesh, seed):
    """The workload generator's chains, two-phase, balancing, limits and
    conflicts route through the serial tiers of both packages."""
    run_workload(Pair(mesh, oracle=True), seed, n_batches=8, batch_size=32)


def _accounts(pair, ids, ts=10_000):
    ts += len(ids)
    assert pair.run(Operation.create_accounts, ts,
                    [Account(id=i, ledger=1, code=1) for i in ids]) == [0] * len(ids)
    return ts


def test_linked_chain_rollback(mesh):
    """A mid-batch chain break rolls back every shard's writes."""
    pair = Pair(mesh, oracle=True)
    ts = _accounts(pair, (1, 2, 3))
    transfers = [
        Transfer(id=10, debit_account_id=1, credit_account_id=2, amount=5, ledger=1, code=1,
                 flags=1),
        Transfer(id=11, debit_account_id=2, credit_account_id=3, amount=7, ledger=1, code=1,
                 flags=1),
        Transfer(id=12, debit_account_id=1, credit_account_id=3, amount=0, ledger=1, code=1),
        Transfer(id=13, debit_account_id=1, credit_account_id=2, amount=9, ledger=1, code=1),
    ]
    assert pair.run(Operation.create_transfers, ts + 4, transfers) == [1, 1, 18, 0]
    _, transfers_d, _ = pair.port.extract()
    assert 13 in transfers_d and 10 not in transfers_d


def _on_distinct_shards(start, k):
    out, seen = [], set()
    i = start
    while len(out) < k:
        if owned_by(i) not in seen:
            seen.add(owned_by(i))
            out.append(i)
        i += 1
    return out


def test_chain_rollback_spans_shards(mesh):
    """A chain whose accounts and transfer rows lie on distinct shards,
    broken at its last link: balances and inserts roll back on every shard
    they touched (tombstones on the owners), and the same ids commit again."""
    pair = Pair(mesh, oracle=True)
    a1, a2, a3 = _on_distinct_shards(1, 3)
    t_ids = _on_distinct_shards(1000, 3)
    ts = _accounts(pair, (a1, a2, a3), 50_000)
    transfers = [
        Transfer(id=t_ids[0], debit_account_id=a1, credit_account_id=a2, amount=5, ledger=1,
                 code=1, flags=1),
        Transfer(id=t_ids[1], debit_account_id=a2, credit_account_id=a3, amount=7, ledger=1,
                 code=1, flags=1),
        Transfer(id=t_ids[2], debit_account_id=a3, credit_account_id=a1, amount=0, ledger=1,
                 code=1),
    ]
    ts += 3
    dense = pair.run(Operation.create_transfers, ts, transfers)
    assert dense[0] == dense[1] == 1 and dense[2] != 0
    tombs = [int((pair.port.state["xfer_rows"][owned_by(t), :-1, :4] == -1).all(1).sum())
             for t in t_ids[:2]]
    assert tombs == [1, 1]
    retry = [Transfer(id=t_ids[0], debit_account_id=a1, credit_account_id=a2, amount=5,
                      ledger=1, code=1)]
    assert pair.run(Operation.create_transfers, ts + 1, retry) == [0]


def test_two_phase(mesh):
    """Pending, post and void across shards: the fulfill word lives on the
    pending's owner shard."""
    pair = Pair(mesh, oracle=True)
    ts = _accounts(pair, (1, 2))
    transfers = [
        Transfer(id=20, debit_account_id=1, credit_account_id=2, amount=100, ledger=1, code=1,
                 flags=int(TransferFlags.pending)),
        Transfer(id=21, pending_id=20, amount=60, ledger=0, code=0,
                 flags=int(TransferFlags.post_pending_transfer)),
        Transfer(id=22, pending_id=20, ledger=0, code=0,
                 flags=int(TransferFlags.void_pending_transfer)),
    ]
    assert pair.run(Operation.create_transfers, ts + 3, transfers) == [0, 0, 33]
    ful = pair.port.state["fulfill"][owned_by(20)]
    assert int((ful == 1).sum()) == 1 and int(ful.count_nonzero()) == 1
    _, _, posted = pair.port.extract()
    assert posted == pair.oracle.posted


def _serial_batch(gen, rng, n, first_id):
    """Plain transfers between the workload's accounts with a linked chain
    broken at its second link, a pending and its post."""
    ids = gen.account_ids
    out = []
    for i in range(n):
        dr, cr = rng.choice(len(ids), 2, replace=False)
        out.append(Transfer(id=first_id + i, debit_account_id=ids[dr],
                            credit_account_id=ids[cr], amount=int(rng.integers(1, 100)),
                            ledger=1, code=1))
    out[0].flags = out[1].flags = 1
    out[1].amount = 0
    out[4].flags = int(TransferFlags.pending)
    out[5] = Transfer(id=first_id + 5, pending_id=first_id + 4, ledger=0, code=0,
                      flags=int(TransferFlags.post_pending_transfer))
    return out


def test_serial_fault_gates(mesh, base):
    """The serial tiers charge all n events against every shard (a tripped
    gate: every code 0, FAULT_CAPACITY, no write); a sticky fault no-ops
    them; an unresolved probe on one shard sets FAULT_SERIAL and the scan
    goes on."""
    state_np, ts, gen = base
    rng = np.random.default_rng(6)
    events = _serial_batch(gen, rng, 32, 920_000)
    rows = rows_of(events, 32)
    codes, _ = kernel_pair(mesh, state_np, "commit_transfers_serial", rows, 32, ts + 32)
    assert (codes == 0).sum() > 0 and (codes == 1).sum() >= 1

    # every shard is charged all 32 events: one with 31 slots of room trips
    # the gate, though it may own none of them
    full = {k: v.copy() for k, v in state_np.items()}
    full["xfer_used_slots"][3] = (1 << 12) // 2 - 31
    codes, pst = kernel_pair(mesh, full, "commit_transfers_serial", rows, 32, ts + 32)
    assert int(pst["fault"]) == tledger.FAULT_CAPACITY and not codes.any()
    accts = [Account(id=800_000 + i, ledger=1, code=1, flags=1 if i % 5 < 2 else 0)
             for i in range(16)]
    arows = rows_of(accts, 16, accounts=True)
    kernel_pair(mesh, state_np, "commit_accounts_serial", arows, 16, ts + 16)
    full = {k: v.copy() for k, v in state_np.items()}
    full["acct_used_slots"][5] = (1 << 10) // 2 - 15
    codes, pst = kernel_pair(mesh, full, "commit_accounts_serial", arows, 16, ts + 16)
    assert int(pst["fault"]) == tledger.FAULT_CAPACITY and not codes.any()
    faulted = {k: v.copy() for k, v in state_np.items()}
    faulted["fault"] = np.uint32(tledger.FAULT_CLAIM)
    _, pst = kernel_pair(mesh, faulted, "commit_transfers_serial", rows, 32, ts + 32)
    assert int(pst["fault"]) == tledger.FAULT_CLAIM

    # one shard's empty transfer rows filled with random words: its probes
    # do not resolve (the pending's accounts of a plain transfer are probed
    # with key 0, on key 0's owner, all the same)
    ex = {k: v.copy() for k, v in state_np.items()}
    s = owned_by(920_002)
    x = ex["xfer_rows"][s]
    empty = np.nonzero((x[:-1, :4] == 0).all(1))[0]
    x[empty] = rng.integers(1, 1 << 32, (len(empty), 32), dtype=np.uint64).astype(np.uint32)
    _, pst = kernel_pair(mesh, ex, "commit_transfers_serial", rows, 32, ts + 32)
    assert int(pst["fault"]) == tledger.FAULT_SERIAL


def test_serial_accounts_chains(mesh):
    """Linked account chains and duplicate ids on the serial account tier:
    a broken chain tombstones its inserts on their owner shards."""
    pair = Pair(mesh, oracle=True)
    accts = [Account(id=i, ledger=1, code=1) for i in range(1, 13)]
    accts[0].flags = accts[1].flags = 1
    accts[2].id = 1  # the chain's last member exists: the chain breaks
    accts[5].flags = 1  # a healthy chain
    accts[9].id = accts[8].id  # duplicate ids
    dense = pair.run(Operation.create_accounts, 10_012, accts)
    assert dense[0] == dense[1] == 1 and dense[9] != 0
    assert fields(pair.port.lookup_accounts([1, 2, 7])) == \
        fields(pair.oracle.lookup_accounts([1, 2, 7]))
