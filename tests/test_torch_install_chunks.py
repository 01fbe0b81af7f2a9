"""The snapshot install (K9) across its chunks: the port's plain version of
a whole table's install against the JAX package's `DeviceLedger._install_fn`
driven chunk by chunk, bit for bit.

K9 on the card is one launch a table that runs the chunks in order
(csrc/install.cu); the restores of `tigerbeetle_tpu_torch.testing.
install_cases` aim at the claim rounds within a chunk (rows sharing a probe
window, some losing all four rounds: FAULT_INSTALL), a partial last chunk,
a chunk whose free slots the chunk before filled, and tombstones reused.
Here, on the CPU, the port runs `install_rows_chunked` (its plain version,
the kernel's CPU route) and the JAX package its jitted `_install_fn` on
each padded chunk, as `install_snapshot_rows` drives it, at the test
geometry (2^10 account / 2^12 transfer slots) with chunks of 64 and 40
rows. Every state leaf is compared but the dump rows (the JAX function
writes masked lanes there; the port never writes them). `chip_smoke.py`
holds the kernel against the plain version on the same cases at chunks of
64 and 8192. Tolerance: zero.
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tigerbeetle_tpu  # noqa: F401  (x64 before any input is built)
from tigerbeetle_tpu.constants import TEST_PROCESS as J_TEST_PROCESS
from tigerbeetle_tpu.models import ledger as jledger
from tigerbeetle_tpu_torch import convert
from tigerbeetle_tpu_torch.constants import TEST_PROCESS
from tigerbeetle_tpu_torch.models import ledger as tledger
from tigerbeetle_tpu_torch.testing import install_cases

_JAX = {}


def _jax_ledger():
    """One JAX ledger for the module: its install functions compile once per
    table and chunk length."""
    if "led" not in _JAX:
        _JAX["led"] = jledger.DeviceLedger(process=J_TEST_PROCESS, mode="auto")
    return _JAX["led"]


def _jax_install(state_np, table, rows, ful, chunk):
    led = _jax_ledger()
    led.state = {k: jnp.asarray(v) for k, v in state_np.items()}
    fn = led._install_fn(table)
    for i in range(0, len(rows), chunk):
        part = rows[i:i + chunk]
        rows_b = np.zeros((chunk, 32), dtype=np.uint32)
        rows_b[:len(part)] = part
        fv = np.zeros(chunk, dtype=np.uint32)
        if ful is not None:
            fv[:len(part)] = ful[i:i + chunk]
        led.state = fn(led.state, jnp.asarray(rows_b), jnp.asarray(fv), jnp.int32(len(part)))
    return {k: np.asarray(v) for k, v in led.state.items()}


@pytest.mark.parametrize("chunk", [64, 40])
@pytest.mark.parametrize("table", ["xfer", "acct"])
@pytest.mark.parametrize("case", install_cases.CASES)
def test_install_case_matches_jax(case, table, chunk):
    log2 = TEST_PROCESS.account_slots_log2 if table == "acct" else TEST_PROCESS.transfer_slots_log2
    rng = np.random.default_rng(zlib.crc32(f"{case}.{table}.{chunk}".encode()))
    c = install_cases.install_case(case, log2, chunk, table, rng)
    start = convert.state_to_numpy(tledger.init_state(TEST_PROCESS, "cpu"))
    start[f"{table}_rows"] = c["base"].copy()

    want = _jax_install(start, table, c["rows"], c["ful"], chunk)
    state = convert.state_from_numpy(start, "cpu")
    ful = None if c["ful"] is None else torch.from_numpy(c["ful"].view(np.int32))
    tledger.install_rows_chunked(state, table, torch.from_numpy(c["rows"].view(np.int32)), ful,
                                 log2, chunk)
    got = convert.state_to_numpy(state)
    assert want.keys() == got.keys()
    for k, w in want.items():
        g = got[k]
        if w.ndim:  # tables: every row but the dump row
            w, g = w[:-1], g[:-1]
        np.testing.assert_array_equal(g, w, err_msg=k)

    fault = int(got["fault"])
    assert fault == (tledger.FAULT_INSTALL if c["fault"] else 0)
    placed = int(got[f"{table}_count"])
    assert placed < len(c["rows"]) if c["fault"] else placed == len(c["rows"])
    if case == "tomb_reuse":  # rows landed where tombstones were
        was_tomb = (c["base"][:-1, :4] == 0xFFFFFFFF).all(axis=1)
        now_live = ~((got[f"{table}_rows"][:-1, :4] == 0xFFFFFFFF).all(axis=1)
                     | (got[f"{table}_rows"][:-1, :4] == 0).all(axis=1))
        assert (was_tomb & now_live).sum() >= len(c["rows"]) // 4
