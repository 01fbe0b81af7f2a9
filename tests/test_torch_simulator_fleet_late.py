"""The port's simulator against the JAX package's on the VOPR fleet's
seed-drawn topologies and fault mixes, `random_options(s)` for s = 8-15
(oracle backend, each draw's own tick budget): equal `run()` dicts,
histories, replica states and storages byte for byte."""

import pytest

from tests.torch_sim_helpers import run_both
from tigerbeetle_tpu.testing.simulator import random_options as jax_options
from tigerbeetle_tpu_torch.testing.simulator import describe_options, random_options


@pytest.mark.parametrize("seed", range(8, 16))
def test_fleet_seed_equals_jax(seed):
    jo, po = jax_options(seed), random_options(seed)
    assert describe_options(po) == describe_options(jo)
    stats = run_both(seed, jo, po)
    assert stats["committed_ops"] > 0
