"""Cluster correctness checkers (reference:
src/testing/cluster/state_checker.zig:25, storage_checker.zig).

- StateChecker: every replica's committed state is identical (one linear
  history) and matches a model-based oracle replay of the committed ops.
- convergence(): all replicas reached the same commit_min/op/chain head.

The port's copy of `tigerbeetle_tpu/testing/state_checker.py`.
"""

from __future__ import annotations

from tigerbeetle_tpu_torch.models.oracle import OracleStateMachine
from tigerbeetle_tpu_torch.state_machine import StateMachine
from tigerbeetle_tpu_torch.types import Operation


def assert_convergence(replicas) -> None:
    heads = {(r.commit_min, r.op, r.parent_checksum) for r in replicas}
    assert len(heads) == 1, f"replicas diverged: {heads}"


def assert_identical_state(replicas) -> None:
    """Bit-exact state parity across replicas (the reference's
    StorageChecker compares checkpoints byte-for-byte; our state lives in
    the ledger tables — extract() is the canonical view)."""
    base = replicas[0].ledger.extract()
    for r in replicas[1:]:
        other = r.ledger.extract()
        assert other[0] == base[0], f"replica {r.replica}: accounts diverged"
        assert other[1] == base[1], f"replica {r.replica}: transfers diverged"
        assert other[2] == base[2], f"replica {r.replica}: posted diverged"
    tables = {
        tuple(sorted((c, e["session"], e["request"]) for c, e in r.client_table.items()))
        for r in replicas
    }
    assert len(tables) == 1, "client tables diverged"


def assert_matches_oracle(replica, committed: list[tuple[Operation, int, bytes]]):
    """Replay (operation, timestamp, body) through the scalar oracle and
    compare state bit-for-bit with the replica's device ledger."""
    sm = StateMachine(OracleStateMachine(), replica.cluster.message_size_max)
    for operation, timestamp, body in committed:
        if operation in (Operation.create_accounts, Operation.create_transfers):
            sm.commit(operation, timestamp, body)
    oracle = sm.backend
    accounts, transfers, posted = replica.ledger.extract()
    assert accounts == oracle.accounts
    assert transfers == oracle.transfers
    assert posted == oracle.posted
