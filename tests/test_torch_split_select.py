"""The spill cycle's split (K10s): the port's plain version,
`spill_split_plain`, against the JAX package's `SpillKernels._split_idx`,
bit for bit: the watermark select and both padded index lists.

On the card the split narrows a histogram of the live timestamps to the
watermark and partitions the live slots in one pass over a compact list
(csrc/spill_split.cu), so its answer must not depend on how the timestamps
fall. The tables of `tigerbeetle_tpu_torch.testing.split_cases` aim at
that: duplicates, all-equal timestamps, two far-apart clusters, live
timestamps near and at u64 max, rising timestamps, tombstones and a dump
row with small timestamps that the mask hides, each split at n_cold 0, 1,
the middle, live - 1 and live. Here, on the CPU, the wrapper runs the plain
version (the kernel's CPU route) at 2^12 and 2^14 slots; `chip_smoke.py`
holds the kernel against the plain version on the same tables at 2^20 and
2^24. Tolerance: zero.
"""

import types as pytypes
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tigerbeetle_tpu  # noqa: F401  (x64 before any input is built)
from tigerbeetle_tpu.models import spill as jspill
from tigerbeetle_tpu_torch.models import spill as tspill
from tigerbeetle_tpu_torch.testing import split_cases

_JAX = {}


def _jax_split(rows: np.ndarray, cap_log2: int, n_cold: int):
    if cap_log2 not in _JAX:
        _JAX[cap_log2] = jspill.SpillKernels(pytypes.SimpleNamespace(transfer_slots_log2=cap_log2))
    cold, hot = _JAX[cap_log2].split_idx(jnp.asarray(rows), n_cold)
    return np.asarray(cold), np.asarray(hot)


@pytest.mark.parametrize("rank", split_cases.RANKS)
@pytest.mark.parametrize("cap_log2", [12, 14])
@pytest.mark.parametrize("case", split_cases.CASES)
def test_split_matches_jax(case, cap_log2, rank):
    rng = np.random.default_rng(zlib.crc32(f"{case}.{cap_log2}".encode()))
    rows = split_cases.split_case(case, cap_log2, rng)
    t_rows = torch.from_numpy(rows.view(np.int32))
    live = int(tspill.spill_head(t_rows, torch.zeros((), dtype=torch.int32), cap_log2)[0])
    assert 0.3 < live / (1 << cap_log2) < 0.45
    dump = 1 << cap_log2
    n_cold = split_cases.n_cold_of(rank, live)
    want_cold, want_hot = _jax_split(rows, cap_log2, n_cold)
    cold, hot = tspill.spill_split(t_rows, cap_log2, n_cold)
    np.testing.assert_array_equal(cold.numpy(), want_cold, err_msg="cold")
    np.testing.assert_array_equal(hot.numpy(), want_hot, err_msg="hot")
    # both lists ascending, disjoint, covering the live slots, dump-padded
    n_c = int((cold != dump).sum())
    n_h = int((hot != dump).sum())
    assert n_c + n_h == live
    assert (cold[n_c:] == dump).all() and (hot[n_h:] == dump).all()
    for side, k in ((cold, n_c), (hot, n_h)):
        assert bool((side[1:k] > side[:max(k - 1, 0)]).all())
    if case in ("distinct", "consecutive") or n_cold == 0:  # unique timestamps
        assert n_c == n_cold
