"""The simulator's seeds and settings that the tests hold the port to (those
of the JAX package's `tests/test_simulator.py`), and the spill seed that
`chip_smoke.py` runs on the card.

Each case is (seed, kwargs function): the function takes a package's
`PacketSimulatorOptions` and `ConfigProcess` classes, so the same settings
build for either package.
"""

from __future__ import annotations


def _heavy(P, C) -> dict:
    return dict(
        ticks=700, crash_probability=0.004,
        options=P(packet_loss_probability=0.05, packet_replay_probability=0.05,
                  partition_probability=0.01),
    )


def _wal(P, C) -> dict:
    return dict(ticks=900, crash_probability=0.008, restart_ticks_max=40,
                wal_fault_probability=1.0)


def _torn(P, C) -> dict:
    return dict(ticks=900, crash_probability=0.008, restart_ticks_max=40,
                torn_write_probability=1.0, replies_fault_probability=0.5,
                superblock_fault_probability=0.5)


def _five(P, C) -> dict:
    return dict(
        ticks=800, replica_count=5, crash_probability=0.004,
        options=P(packet_loss_probability=0.02, packet_replay_probability=0.02,
                  partition_probability=0.01),
    )


def _standbys(P, C) -> dict:
    return dict(ticks=900, replica_count=3, standby_count=2, n_clients=2,
                crash_probability=0.004)


def device_backend(P, C) -> dict:
    """`test_simulation_device_backend`: every replica on its own
    DeviceLedger at TEST_PROCESS."""
    return dict(ticks=260, backend_factory=None, n_clients=1,
                crash_probability=0.003)


def spill(P, C) -> dict:
    """`test_simulation_grid_read_latency_off_hot_loop` (seed 7): two
    replicas of a tiny DeviceLedger with a forest, so that the run reads
    the spill store."""
    return dict(
        ticks=240, backend_factory=None, replica_count=2, n_clients=1,
        client_batch=24, crash_probability=0.0, wal_fault_probability=0.0,
        torn_write_probability=0.0, replies_fault_probability=0.0,
        superblock_fault_probability=0.0, forest_blocks=192,
        grid_size=64 * 1024 * 1024,
        process=C(account_slots_log2=10, transfer_slots_log2=7, lsm_memtable_max=48),
        workload_knobs=dict(
            ledgers=(1,), invalid_rate=0.0, conflict_rate=0.02, chain_rate=0.0,
            two_phase_rate=0.1, balancing_rate=0.0, limit_account_rate=0.0,
        ),
    )


SPILL_SEED = 7

# the oracle-backend cases: name -> (seed, kwargs function)
ORACLE_CASES = {
    **{f"seed{s}": (s, lambda P, C: dict(ticks=600)) for s in (1, 2, 3, 7, 14)},
    "heavy_faults": (5, _heavy),
    "wal_faults": (9, _wal),
    "torn_writes_and_zone_faults": (11, _torn),
    "five_replicas": (17, _five),
    "standbys": (29, _standbys),
}

# the device-backend cases (run on the CPU in the tests)
DEVICE_CASES = {
    "device_backend": (3, device_backend),
    "spill": (SPILL_SEED, spill),
}
