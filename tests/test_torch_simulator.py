"""The port's simulator (`tigerbeetle_tpu_torch/testing/simulator.py`)
against the JAX package's, with the oracle backend, on the seeds and
settings of `tests/test_simulator.py`: equal `run()` dicts, every
replica's committed history, commit_min, view and status, and every
replica's storage byte for byte. Each case also keeps the JAX test's own
floors."""

import pytest

from tests.torch_sim_helpers import case_kwargs, run_both
from tigerbeetle_tpu_torch.testing import sim_cases
from tigerbeetle_tpu_torch.testing.simulator import Simulator, run_simulation

FLOORS = {  # the JAX tests' assertions on each case's stats
    "heavy_faults": lambda s: s["committed_ops"] > 10,
    "wal_faults": lambda s: s["crashes"] >= 2 and s["wal_faults"] >= 1 and s["committed_ops"] > 20,
    "torn_writes_and_zone_faults": lambda s: s["crashes"] >= 2 and s["committed_ops"] > 20 and (
        s["torn_writes"] + s["replies_faults"] + s["superblock_faults"] >= 2),
    "five_replicas": lambda s: s["committed_ops"] > 20,
    "standbys": lambda s: s["committed_ops"] > 10,
}


@pytest.mark.parametrize("name", sorted(sim_cases.ORACLE_CASES))
def test_simulation_equals_jax(name):
    seed, make_kwargs = sim_cases.ORACLE_CASES[name]
    stats = run_both(seed, *case_kwargs(make_kwargs))
    floor = FLOORS.get(name, lambda s: s["committed_ops"] > 15 and s["replies"] > 10)
    assert floor(stats), stats


def test_simulation_deterministic():
    assert run_simulation(42, ticks=400) == run_simulation(42, ticks=400)


@pytest.mark.parametrize("option, value", [
    ("commitment_interval", 8), ("tick_hook", lambda sim, now: None),
])
def test_unported_options_raise(option, value):
    with pytest.raises(NotImplementedError, match="queue A7"):
        Simulator(1, ticks=10, **{option: value})


@pytest.mark.parametrize("options", [
    {"cdc_consumer": True}, {"cdc_fanout": 3}, {"ingress_gateway": True},
    {"storm_clients": 4}, {"tail_aof": True},
    {"cdc_fanout": 3, "ingress_gateway": True, "storm_clients": 5},
], ids=lambda o: "+".join(o))
def test_cdc_and_ingress_options_equal_jax(options):
    """The change-stream, fan-out, ingress, connect-storm and AOF-tail
    options run (the CDC and ingress modules, queue A6) and replay the JAX
    simulator's run with the same options: stats, histories, storages."""
    stats = run_both(211, dict(ticks=300, **options), dict(ticks=300, **options))
    assert stats["committed_ops"] > 0


def test_state_checker_on_a_device_cluster():
    """`tests/test_cluster.py`'s checks through the port's state checker:
    three replicas of the device ledger (on the CPU) converge, hold the same
    state, and the primary's equals the oracle's replay, also after a
    backup's restart; and the primary's replies equal the oracle's."""
    from tigerbeetle_tpu_torch import types
    from tigerbeetle_tpu_torch.models.oracle import OracleStateMachine
    from tigerbeetle_tpu_torch.state_machine import StateMachine
    from tigerbeetle_tpu_torch.testing.cluster import Cluster
    from tigerbeetle_tpu_torch.testing.state_checker import (
        assert_convergence,
        assert_identical_state,
        assert_matches_oracle,
    )
    from tigerbeetle_tpu_torch.testing.workload import WorkloadGenerator

    cluster = Cluster(replica_count=3, device="cpu")
    client = cluster.add_client()
    gen = WorkloadGenerator(4)
    sm = StateMachine(OracleStateMachine(), cluster.cluster_config.message_size_max)
    committed = []
    for b in range(9):
        if b % 3 == 0:
            op, events = gen.gen_accounts_batch(24)
            body = types.accounts_to_np(events).tobytes()
        else:
            op, events = gen.gen_transfers_batch(24)
            body = types.transfers_to_np(events).tobytes()
        header, reply = cluster.execute(client, op, body)
        committed.append((op, header.timestamp, body))
        assert reply == sm.commit(op, header.timestamp, body)
    assert_convergence(cluster.replicas)
    assert_identical_state(cluster.replicas)
    assert cluster.replicas[0].commit_min == len(committed) + 1  # + register
    assert_matches_oracle(cluster.replicas[0], committed)
    cluster.restart_replica(2)
    assert_identical_state(cluster.replicas)
    with pytest.raises(AssertionError):
        assert_matches_oracle(cluster.replicas[0], committed[1:])  # no accounts
