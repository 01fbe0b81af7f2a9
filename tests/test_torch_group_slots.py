"""The group commit (K5) slot by slot: the port's plain version against the
JAX package's `DeviceLedger._group_stepper`, bit for bit, on the cases of
`tigerbeetle_tpu_torch.testing.group_cases`.

On the card K5 is one launch that runs the slots in order
(csrc/group_commit.cu); each case makes a stale read of what an earlier slot
wrote, or a wrong slot order, change a code, a slot placement or the fault
word: a reused id, an account whose balance limit the slot before crossed,
ids whose probe window the slot before filled, padding slots in the middle
and at the end, a slot in which every lane fails, the capacity gate tripped
by slot 2, and a fault word set before the group. Here, on the CPU, the port
runs `commit_transfers_group_plain` (the kernel's CPU route) and the JAX
package its jitted stepper, at k = 4 and k = 16 slots of n_pad = 64 lanes
and the test geometry (2^10 account / 2^12 transfer slots). Compared: the
flat codes with the fault word, the summary, and every state leaf but the
dump rows (the JAX kernels write garbage there; the port never writes
them). `chip_smoke.py` holds the kernel against the plain version on the
same cases. Tolerance: zero.
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
from tigerbeetle_tpu_torch.testing import group_cases

N_PAD = 64
A_LOG2 = TEST_PROCESS.account_slots_log2
T_LOG2 = TEST_PROCESS.transfer_slots_log2
_JAX = {}


def _jax_ledger():
    """One JAX ledger for the module: its stepper compiles once per k."""
    if "led" not in _JAX:
        _JAX["led"] = jledger.DeviceLedger(process=J_TEST_PROCESS, mode="auto")
    return _JAX["led"]


@pytest.mark.parametrize("k", [4, 16])
@pytest.mark.parametrize("case", group_cases.CASES)
def test_group_case_matches_jax(case, k):
    rng = np.random.default_rng(zlib.crc32(f"{case}.{k}".encode()))
    c = group_cases.group_case(case, k, N_PAD, T_LOG2, rng)
    state = group_cases.base_state(c, TEST_PROCESS, "cpu")
    start = convert.state_to_numpy(state)

    step = _jax_ledger()._group_stepper(k, N_PAD)
    j_state, j_flat, j_summary = step(
        {key: jnp.asarray(v) for key, v in start.items()},
        jnp.asarray(c["rows"].view(np.uint32)), jnp.asarray(c["ns"]),
        jnp.asarray(np.array(c["tss"], dtype=np.uint64)))
    flat, summary = tledger.commit_transfers_group_plain(
        state, torch.from_numpy(c["rows"]), c["ns"], c["tss"], A_LOG2, T_LOG2)

    flat_np = flat.numpy().view(np.uint32)
    np.testing.assert_array_equal(flat_np, np.asarray(j_flat))
    np.testing.assert_array_equal(summary.numpy().view(np.uint32), np.asarray(j_summary))
    got = convert.state_to_numpy(state)
    for key, want in j_state.items():
        want, g = np.asarray(want), got[key]
        if want.ndim:  # tables: every row but the dump row
            want, g = want[:-1], g[:-1]
        np.testing.assert_array_equal(g, want, err_msg=key)

    # the case does what it is built to do
    codes = flat_np[:-1].reshape(k, N_PAD)
    for slot, lane, code in c["expect"]:
        if code is None:
            assert codes[slot, lane] != 0, (slot, lane)
        else:
            assert codes[slot, lane] == code, (slot, lane, codes[slot, lane])
    assert flat_np[-1] == summary[-1] == c["fault_after"]
    for s in range(k):
        assert summary[s] == np.count_nonzero(codes[s, :c["ns"][s]])
        assert not codes[s, c["ns"][s]:].any()
    ok = (codes == 0) & (np.arange(N_PAD) < c["ns"][:, None])
    if c["fault_after"]:  # only the slots before the faulting one applied
        applied = 2 if case == "capacity" else 0
        assert int(got["xfer_count"]) == int(ok[:applied].sum())
    else:
        assert int(got["xfer_count"]) == int(ok.sum())
