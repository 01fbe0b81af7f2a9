"""Every fuzzer of the port's `testing/fuzz.py` (EWAH, LSM tree, forest,
manifest log, set-associative cache, free set, journal format, superblock)
over the port's own `lsm/`, `vsr/` and `stdx.py`, at seeds 1-4 with the
default step counts. Each raises AssertionError on any divergence from its
model or invariant."""

import pytest

from tigerbeetle_tpu_torch.testing.fuzz import ALL_FUZZERS


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
@pytest.mark.parametrize("name", sorted(ALL_FUZZERS))
def test_fuzzer(name, seed):
    ALL_FUZZERS[name](seed)


def test_fuzzers_are_the_jax_set():
    from tigerbeetle_tpu.testing.fuzz import ALL_FUZZERS as JAX_FUZZERS

    assert sorted(ALL_FUZZERS) == sorted(JAX_FUZZERS)
