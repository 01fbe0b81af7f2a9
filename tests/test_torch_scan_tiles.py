"""The equality filter scan (K8) at the edges of its tiles: the port's plain
version against the JAX package's `LedgerKernels.filter_scan`, bit for bit.

K8 on the card is one single-pass launch over tiles of `kernels.FILTER_TILE`
slots (csrc/filter_scan.cu); the tables of
`tigerbeetle_tpu_torch.testing.scan_cases` aim at its tile edges, the last
slot before the dump row, the last tile, QUERY_LIMIT and one past it, dead
rows and the dump row carrying the value, and no match. Here, on the CPU,
the port runs its plain PyTorch version (the kernel's CPU route) and the
JAX package its jitted scan, as its own tests run it, on the same tables
(2^14 slots: eight tiles and the dump row's tile), for a field of each
shape. `chip_smoke.py` holds the kernel against the plain version on the
same cases at 2^24 slots. Tolerance: zero.
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tigerbeetle_tpu  # noqa: F401  (x64 before any input is built)
from tigerbeetle_tpu.constants import ConfigProcess as JConfigProcess
from tigerbeetle_tpu.models import ledger as jledger
from tigerbeetle_tpu_torch import kernels
from tigerbeetle_tpu_torch.models import ledger as tledger
from tigerbeetle_tpu_torch.testing import scan_cases

LOG2 = 14


def test_tile_constants():
    assert kernels.FILTER_TILE == 2048 and (1 << LOG2) // kernels.FILTER_TILE == 8
    assert kernels.QUERY_LIMIT == tledger.QUERY_LIMIT == jledger.QUERY_LIMIT


@pytest.mark.parametrize("table,field", scan_cases.FIELDS)
@pytest.mark.parametrize("case", scan_cases.CASES)
def test_scan_case_matches_jax(case, table, field):
    spec = (tledger.ACCOUNT_QUERY_WORDS if table == "acct"
            else tledger.TRANSFER_QUERY_WORDS)[field]
    rng = np.random.default_rng(zlib.crc32(f"{case}.{table}.{field}".encode()))
    width = 16 if spec[2] else 32 * spec[1]
    value = int(rng.integers(1, 1 << min(width, 62))) | (1 << (width - 1))
    vw = [(value >> (32 * i)) & 0xFFFFFFFF for i in range(4)]
    rows = scan_cases.scan_case(case, LOG2, spec, vw, rng)
    want_total = scan_cases.expected_total(rows, spec, vw)

    jk = jledger.get_kernels(JConfigProcess(account_slots_log2=LOG2, transfer_slots_log2=LOG2))
    j_rows, j_total = jk.filter_scan(table, field)(
        jnp.asarray(rows), jnp.asarray(np.array(vw, dtype=np.uint32)))
    t_rows, t_total = tledger.filter_scan(torch.from_numpy(rows.view(np.int32)), LOG2, spec, vw)
    assert int(t_total) == int(j_total) == want_total
    np.testing.assert_array_equal(t_rows.numpy().view(np.uint32), np.asarray(j_rows))

    # what the case aims at shows in the output
    out = t_rows.numpy().view(np.uint32)
    filled = min(want_total, tledger.QUERY_LIMIT)
    assert (out[filled:] == rows[-1]).all()  # the dump row's content pads
    expected = {"tile_edges": 2 * 8, "last_before_dump": 1, "exactly_limit": tledger.QUERY_LIMIT,
                "limit_plus_one": tledger.QUERY_LIMIT + 1, "dead_rows_carry_value": 37,
                "no_match": 0}
    if case in expected:
        assert want_total == expected[case]
    if case == "last_before_dump":
        np.testing.assert_array_equal(out[0], rows[(1 << LOG2) - 1])
    if case == "last_tile_only":
        assert want_total > 0
        tile0 = (1 << LOG2) - kernels.FILTER_TILE
        live_slots = [s for s in range(1 << LOG2)
                      if (rows[s, :4] != 0).any() and (rows[s, :4] != 0xFFFFFFFF).any()]
        first_hit = next(s for s in live_slots if (out[0] == rows[s]).all())
        assert first_hit >= tile0
