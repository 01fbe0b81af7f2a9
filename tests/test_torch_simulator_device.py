"""The simulator's device slice on the CPU: every replica on its own
DeviceLedger (the port's with device="cpu", the kernels' plain versions)
against the JAX simulator's, on `test_simulation_device_backend`'s seed 3
at 260 ticks and on `test_simulation_grid_read_latency_off_hot_loop`'s
seed-7 spill settings (a forest behind each ledger, read back through the
replica's deferred spill IO). Equal `run()` dicts, histories and replica
states; storages equal with the device checkpoints' dump rows masked."""

import pytest

from tests.torch_sim_helpers import case_kwargs, run_both
from tigerbeetle_tpu_torch.testing import sim_cases
from tigerbeetle_tpu_torch.testing.simulator import run_simulation


@pytest.mark.parametrize("name", sorted(sim_cases.DEVICE_CASES))
def test_device_slice_equals_jax(name):
    seed, make_kwargs = sim_cases.DEVICE_CASES[name]
    jax_kw, port_kw = case_kwargs(make_kwargs)
    stats = run_both(seed, jax_kw, dict(port_kw, device="cpu"), masked=True)
    assert stats["committed_ops"] > 5
    if name == "spill":
        assert stats["grid_reads"] > 0, "the run never touched the spill store"


def test_spill_seed_read_latency_leaves_the_run_unchanged():
    """A grid-read latency on the storage seam changes nothing of the run:
    the spill IO is off the replica's hot loop."""
    _j, kw = case_kwargs(sim_cases.spill)
    base = run_simulation(sim_cases.SPILL_SEED, device="cpu", **kw)
    _j, kw = case_kwargs(sim_cases.spill)
    slow = run_simulation(sim_cases.SPILL_SEED, device="cpu", grid_read_latency_s=0.0003, **kw)
    assert slow == base
