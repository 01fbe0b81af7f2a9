"""The wave commit (K12) wave by wave: the port's plain version against the
JAX package's `DeviceLedger._wave_stepper`, bit for bit, on the cases of
`tigerbeetle_tpu_torch.testing.wave_cases`.

On the card K12 is one launch that runs the waves of one batch in order
(csrc/wave_commit.cu); each case makes a stale read of what an earlier wave
wrote, a wave run out of order or a code written in the wrong wave change a
code, a table row or the fault word: pendings posted and voided in the next
wave, a limit account's chain as deep as the waves and one touch more in no
wave, the capacity gate tripped by wave 1, a fault word set before the
call, a wave with no live lane, and a pending that one wave posts and the
next voids. Here, on the CPU, the port runs `commit_transfers_waves_plain`
(the kernel's CPU route) and the JAX package its jitted stepper, called
directly at W = 2, 3, 8 and 24 (`WAVE_CAP`) over 64 lanes at the test
geometry (2^10 account / 2^12 transfer slots). Compared: the codes, the
fault word, every state leaf but the dump rows (the JAX kernels write
garbage there; the port never writes them) and `state_fingerprint`.
`chip_smoke.py` holds the kernel against the plain version on the same
cases. Tolerance: zero.
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
from tigerbeetle_tpu_torch.testing import wave_cases

N_PAD = 64
A_LOG2 = TEST_PROCESS.account_slots_log2
T_LOG2 = TEST_PROCESS.transfer_slots_log2
U64 = (1 << 64) - 1
_JAX = {}


def _jax_ledger():
    """One JAX ledger for the module: its stepper compiles once per (W, mode)."""
    if "led" not in _JAX:
        _JAX["led"] = jledger.DeviceLedger(process=J_TEST_PROCESS, mode="auto")
    return _JAX["led"]


def test_waves_match_jax_wave_cap():
    assert tledger.WAVE_CAP == jledger.WAVE_CAP == 24


@pytest.mark.parametrize("W", [2, 3, 8, 24])
@pytest.mark.parametrize("case", wave_cases.CASES)
def test_wave_case_matches_jax(case, W):
    rng = np.random.default_rng(zlib.crc32(f"{case}.{W}".encode()))
    c = wave_cases.wave_case(case, W, N_PAD, T_LOG2, rng)
    state = wave_cases.base_state(c, TEST_PROCESS, "cpu")
    start = convert.state_to_numpy(state)
    masks = np.zeros((W, N_PAD), dtype=bool)
    live = np.nonzero(c["wave_of"] >= 0)[0]
    masks[c["wave_of"][live], live] = True
    mode = "fast_pv" if c["pv"] else "fast"

    step = _jax_ledger()._wave_stepper(W, N_PAD, mode)
    j_state, j_codes = step(
        {key: jnp.asarray(v) for key, v in start.items()},
        jnp.asarray(c["rows"].view(np.uint32)), jnp.asarray(masks),
        jnp.int32(c["n"]), jnp.uint64(c["timestamp"]))
    codes = tledger.commit_transfers_waves_plain(
        state, torch.from_numpy(c["rows"]), torch.from_numpy(wave_cases.wave_bytes(c["wave_of"])),
        W, c["n"], c["timestamp"], A_LOG2, T_LOG2, c["pv"])

    codes_np = codes.numpy().view(np.uint32)
    np.testing.assert_array_equal(codes_np, np.asarray(j_codes))
    got = convert.state_to_numpy(state)
    for key, want in j_state.items():
        want, g = np.asarray(want), got[key]
        if want.ndim:  # tables: every row but the dump row
            want, g = want[:-1], g[:-1]
        np.testing.assert_array_equal(g, want, err_msg=key)
    j_fp = {k: int(np.asarray(v)) for k, v in jledger.state_fingerprint(j_state).items()}
    assert {k: int(v) & U64 for k, v in tledger.state_fingerprint(state).items()} == j_fp

    # the case does what it is built to do
    assert wave_cases.wave_codes_ok(c, codes_np) == []
    assert int(got["fault"]) == c["fault_after"]
    ok = (codes_np == 0) & (c["wave_of"] >= 0)
    if case == "capacity":  # only wave 0 applied
        assert int(got["xfer_count"]) == int((ok & (c["wave_of"] == 0)).sum())
    elif c["fault_after"]:
        assert int(got["xfer_count"]) == 0
    else:
        assert int(got["xfer_count"]) == int(ok.sum())


def test_wave_dispatcher_takes_the_plain_version_on_the_cpu():
    """`commit_transfers_waves` on CPU tensors is the plain version (no
    launch), and `LedgerKernels.commit_waves` refuses a serial mode."""
    from tigerbeetle_tpu_torch import kernels

    rng = np.random.default_rng(7)
    c = wave_cases.wave_case("pend_post_void", 3, N_PAD, T_LOG2, rng)
    s1 = wave_cases.base_state(c, TEST_PROCESS, "cpu")
    s2 = wave_cases.base_state(c, TEST_PROCESS, "cpu")
    rows = torch.from_numpy(c["rows"])
    wave_of = torch.from_numpy(wave_cases.wave_bytes(c["wave_of"]))
    before = dict(kernels.LAUNCHES)
    r1 = tledger.LedgerKernels(TEST_PROCESS).commit_waves(s1, rows, wave_of, 3, c["n"],
                                                          c["timestamp"], mode="fast_pv")
    r2 = tledger.commit_transfers_waves_plain(s2, rows, wave_of, 3, c["n"], c["timestamp"],
                                              A_LOG2, T_LOG2, True)
    assert kernels.LAUNCHES == before
    assert torch.equal(r1, r2)
    for key in s1:
        assert torch.equal(s1[key], s2[key]), key
    with pytest.raises(ValueError):
        tledger.LedgerKernels(TEST_PROCESS).commit_waves(s1, rows, wave_of, 3, c["n"],
                                                         c["timestamp"], mode="serial")
