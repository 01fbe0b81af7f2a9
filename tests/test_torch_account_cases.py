"""The fast create_accounts commit's plain versions against the JAX package
on the requests of `tigerbeetle_tpu_torch.testing.account_cases`, bit for
bit.

K2 fast (csrc/commit_accounts.cu) and K11af (csrc/mesh_commit_accounts.cu)
are one launch of one thread-block cluster over csrc/acct_commit.cuh: the
probe and validation a lane an event, claim round 0 at once, rounds 1-3
with a cluster barrier each, one warp's fault gate, the rows written only
if it passed. The cases aim at the claim rounds (ids sharing a whole probe
window, so two lanes lose all four; ids sharing a first position), windows
with no empty slot (with and without a tombstone), the load guard exactly
at its limit and one past (on the sharded ledger one shard's), the sticky
fault, a batch in which every event fails, padding lanes, tombstones
reused, a batch timestamp below the stored commit_ts and one below n, and
a new id twice in one batch. Each goes through:

- the single table: `models/ledger.py` commit_accounts_fast_plain against
  the JAX `LedgerKernels._commit_accounts` (commit_accounts, mode fast);
- the sharded ledger: `parallel/mesh.py` commit_accounts_fast_plain
  against the JAX `ShardedLedgerKernels._commit_accounts_fast` on the
  conftest's 8-device CPU mesh,

at the test geometry (2^10 account slots a table, batches of 128 lanes).
Codes, the fault word, the counters and every table row but the dump rows
must be equal (tolerance zero), and each case must leave the fault word it
is built for. chip_smoke.py holds the kernels against their plain versions
on the same cases on the card.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tigerbeetle_tpu  # noqa: F401  (x64 before any input is built)
from tests.test_torch_ledger import assert_state_equal as assert_single_equal
from tests.test_torch_mesh import assert_state_equal as assert_mesh_equal
from tests.test_torch_mesh import jax_ledger, mesh  # noqa: F401  (the mesh fixture)
from tigerbeetle_tpu.constants import ConfigProcess as JConfigProcess
from tigerbeetle_tpu.models import ledger as jledger
from tigerbeetle_tpu_torch import convert
from tigerbeetle_tpu_torch.constants import ConfigProcess
from tigerbeetle_tpu_torch.models import ledger as tledger
from tigerbeetle_tpu_torch.parallel import mesh as tmesh
from tigerbeetle_tpu_torch.testing import account_cases as AC

S = 8
A_LOG2 = 10
B = 128
J_PROCESS = JConfigProcess(account_slots_log2=A_LOG2, transfer_slots_log2=12)
PROCESS = ConfigProcess(account_slots_log2=A_LOG2, transfer_slots_log2=12)


def _case(name, n_shards):
    rng = np.random.default_rng(zlib.crc32(f"{name}.{n_shards}".encode()))
    return AC.account_case(name, A_LOG2, n_shards, B, rng)


def _start(base_np, c):
    """`base_np` with the case's table and scalars."""
    st = {k: v.copy() for k, v in base_np.items()}
    st["acct_rows"] = c["acct_rows"].copy()
    st["acct_used_slots"] = np.asarray(c["used"], dtype=np.uint64).reshape(
        st["acct_used_slots"].shape)
    st["acct_count"] = np.uint64(c["count"])
    st["commit_ts"] = np.uint64(c["commit_ts"])
    st["fault"] = np.uint32(c["fault"])
    return st


def _check_case(name, c, st, got, codes):
    """The reference's result shows what the case is built for."""
    fault = int(got["fault"])
    assert fault == c["want_fault"]
    codes = np.asarray(codes).astype(np.int64)
    n = c["n"]
    assert not codes[n:].any()
    ok = int((codes[:n] == 0).sum())
    added = int(got["acct_count"]) - int(st["acct_count"])
    stored = int(st["commit_ts"]) != int(got["commit_ts"])
    if fault:
        assert added == 0 and not stored
    else:
        assert added == ok
        assert stored == (ok > 0)
    if name == "all_fail":
        assert ok == 0
    if name == "ts_below_commit":
        assert int(got["commit_ts"]) < int(st["commit_ts"])
    if name == "ts_wrap":  # the last ok timestamp is an unsigned maximum
        ts = [(c["timestamp"] - n + int(i) + 1) % (1 << 64) for i in np.flatnonzero(codes[:n] == 0)]
        assert int(got["commit_ts"]) == max(ts) > c["timestamp"]
    if name == "tomb_reuse":  # rows landed where tombstones were
        was = (c["acct_rows"][..., :-1, :4] == AC.TOMB).all(-1)
        now = got["acct_rows"][..., :-1, :4]
        live = ~((now == AC.TOMB).all(-1) | (now == 0).all(-1))
        assert (was & live).sum() >= ok // 4
    if name == "dup_id":  # both lanes of a pair stored, in distinct slots
        rows = got["acct_rows"][..., :-1, :].reshape(-1, 32)
        keys = rows[:, :4]
        key, counts = np.unique(c["rows"][:n, :4], axis=0, return_counts=True)
        for k in key[counts == 2]:
            assert int((keys == k).all(-1).sum()) == 2


@pytest.fixture(scope="module")
def single_base():
    return convert.state_to_numpy(tledger.init_state(PROCESS, "cpu"))


@pytest.fixture(scope="module")
def mesh_led(mesh):  # noqa: F811
    led = jax_ledger(mesh, J_PROCESS)
    return led, {k: np.array(v) for k, v in led.state.items()}


@pytest.mark.parametrize("case", AC.CASES)
def test_single_table_account_case(single_base, case):
    c = _case(case, None)
    st = _start(single_base, c)
    kern = jledger.get_kernels(J_PROCESS)
    js, jr = kern.commit_accounts({k: jnp.asarray(v) for k, v in st.items()},
                                  {"rows": jnp.asarray(c["rows"])}, jnp.int32(c["n"]),
                                  jnp.uint64(c["timestamp"]), mode="fast")
    js, jr = {k: np.asarray(v) for k, v in js.items()}, np.asarray(jr)
    pst = convert.state_from_numpy(st, "cpu")
    pr = tledger.commit_accounts_fast_plain(pst, torch.from_numpy(c["rows"].view(np.int32)),
                                            c["n"], c["timestamp"], A_LOG2)
    np.testing.assert_array_equal(pr.numpy().view(np.uint32), jr)
    assert_single_equal(js, pst)
    _check_case(case, c, st, js, jr)


@pytest.mark.parametrize("case", AC.CASES)
def test_sharded_account_case(mesh_led, case):
    led, base_np = mesh_led
    c = _case(case, S)
    st = _start(base_np, c)
    jstate = {k: jax.device_put(v, led.state[k].sharding) for k, v in st.items()}
    jstate, jr = led.kernels.commit_accounts_fast(jstate, {"rows": jnp.asarray(c["rows"])},
                                                  jnp.int32(c["n"]), jnp.uint64(c["timestamp"]))
    jr = np.asarray(jr)
    pst = convert.state_from_numpy(st, "cpu")
    pr = tmesh.commit_accounts_fast_plain(pst, torch.from_numpy(c["rows"].view(np.int32)),
                                          c["n"], c["timestamp"], A_LOG2)
    np.testing.assert_array_equal(pr.numpy().view(np.uint32), jr)
    assert_mesh_equal(jstate, pst)
    _check_case(case, c, st, {k: np.asarray(v) for k, v in jstate.items()}, jr)


def test_cases_reach_their_hazards():
    """The shared-window case shares whole windows at this geometry (two
    lanes a group lose all four rounds), and the capacity pair sits exactly
    at the guard's limit and one past it."""
    for n_shards in (None, S):
        assert AC.exact_windows(A_LOG2, n_shards)
        at, past = _case("capacity_at", n_shards), _case("capacity_past", n_shards)
        assert (at["want_fault"], past["want_fault"]) == (0, AC.FAULT_CAPACITY)
