"""The state fingerprint (K6) on the cases of
`tigerbeetle_tpu_torch.testing.fp_cases`: the port's plain version,
`state_fingerprint_plain`, and its wrapper's CPU route,
`state_fingerprint_vec`, against the JAX package's `state_fingerprint`, bit
for bit, and against its numpy twin `fp_rows_np` over the rows before the
dump row.

On the card K6 is one launch whose grid strides over one table and then
the other, the last block to finish adding up the others' sums
(csrc/fingerprint.cu), so the cases vary where the live rows lie and how
many there are (none, every slot, one in 997, only the first and last
slots), the keys that decide
liveness (one word set, three words all ones, all zero, all ones), a dump
row that looks live, and the tables' slot counts (the ledger's powers of
two, counts that are no multiple of a block's rows nor of a warp's, an
empty account table). The JAX function is compiled once per geometry.
`chip_smoke.py` holds the kernel against the plain version on the same
cases at larger geometries. Tolerance: zero.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tigerbeetle_tpu  # noqa: F401  (x64 before any input is built)
from tigerbeetle_tpu.models import ledger as jledger
from tigerbeetle_tpu_torch.models import ledger as tledger
from tigerbeetle_tpu_torch.ops.u128 import to_i64
from tigerbeetle_tpu_torch.testing import fp_cases

U64 = (1 << 64) - 1
_JAX_FP = jax.jit(jledger.state_fingerprint)


def _torch_state(st: dict) -> dict:
    return {"acct_rows": torch.from_numpy(st["acct_rows"].view(np.int32).copy()),
            "xfer_rows": torch.from_numpy(st["xfer_rows"].view(np.int32).copy()),
            "commit_ts": torch.tensor(to_i64(int(st["commit_ts"])), dtype=torch.int64)}


@pytest.mark.parametrize("geometry", fp_cases.GEOMETRIES_CPU, ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("name", fp_cases.CASES)
def test_fp_case_matches_jax(name, geometry):
    a_slots, x_slots = geometry
    rng = np.random.default_rng(zlib.crc32(f"{name}.{a_slots}.{x_slots}".encode()))
    st = fp_cases.fp_case(name, a_slots, x_slots, rng)
    want = _JAX_FP({k: jnp.asarray(v) for k, v in st.items()})
    want = [int(np.asarray(want[k])) for k in tledger.FP_KEYS]
    t_st = _torch_state(st)
    plain = [v & U64 for v in tledger.state_fingerprint_plain(t_st).tolist()]
    wrapper = [v & U64 for v in tledger.state_fingerprint_vec(t_st).tolist()]
    assert plain == want
    assert wrapper == want
    host = [jledger.fp_rows_np(st[t][:-1]) for t in ("acct_rows", "xfer_rows")]
    assert (host[0][0], host[1][0], host[0][1], host[1][1]) == tuple(want[:4])
    assert want[4] == int(st["commit_ts"])


def test_fp_cases_cover_each_layout():
    """Live counts the cases are built for, at a geometry of ragged slot
    counts."""
    a_slots, x_slots = fp_cases.GEOMETRIES_CPU[1]
    assert a_slots % 32 and x_slots % 32 and x_slots % fp_cases.BLOCK_ROWS
    live = {}
    for name in fp_cases.CASES:
        st = fp_cases.fp_case(name, a_slots, x_slots, np.random.default_rng(1))
        live[name] = [jledger.fp_rows_np(st[t][:-1])[1] for t in ("acct_rows", "xfer_rows")]
        if name == "dump_nonzero":
            k4 = st["xfer_rows"][-1, :4]
            assert (k4 != 0).any() and (k4 != fp_cases.TOMB).any()
    assert live["empty"] == [0, 0]
    assert live["dense"] == [a_slots, x_slots]
    assert live["last_slot"] == [2, 2]
    assert 0 < live["sparse"][1] <= x_slots // 997 + 1
    assert 0.15 < live["tombstones"][1] / x_slots < 0.25
    assert 0.4 < live["key_words"][1] / x_slots < 0.6  # one word set, or three all ones
