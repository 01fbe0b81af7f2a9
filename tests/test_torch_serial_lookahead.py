"""The serial transfer commit's plain versions against the JAX package on
the hazard requests of the sharded serial kernel's lookahead, bit for bit.

K11ts (csrc/mesh_serial_transfers.cu over csrc/serial_walk.cuh) resolves the
lookups of later events ahead of the event it commits and must then see
every write in between: a rewritten account row, an insert into a probe
window, a fulfill word, a rollback's tombstones. The requests of
tigerbeetle_tpu_torch/testing/hazards.py aim at each (a chain broken late
whose tombstones later inserts reuse, one id four times, pendings posted
and voided in the same request, a post and a void of one pending, a hot
account under its balance limits and balancing clamps, ids crafted to
share a probe window, posts and voids of missing pendings whose lookup
ends on a rollback's tombstone or in a full window). Here they go through
both packages' serial tiers from one state holding their accounts:

- sharded: `parallel/mesh.py` commit_transfers_serial_plain against the JAX
  `ShardedLedgerKernels._commit_transfers_serial` on the conftest's
  8-device CPU mesh;
- single table: `models/ledger.py` commit_transfers_serial_plain against
  the JAX `LedgerKernels._serial_transfers_core`, in mode serial and
  through the wave executor's residue entry `commit_transfers_residue`
  with scattered per-event timestamps (K4, csrc/serial_transfers.cu, over
  the same walk). Its accounts table has the tombstone key's window filled
  (`hazards.fill_tomb_window`), so a missing pending read from a tombstone
  sets FAULT_SERIAL there as the JAX scan does.

Codes, the fault word and every table leaf but the dump rows must be equal
(tolerance zero), and each request must show the hazard it aims at.
chip_smoke.py holds K4 (phase 2) and K11ts (phase 10) against their plain
versions on the same requests.
"""

import dataclasses

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
from tigerbeetle_tpu.types import Account as JAccount
from tigerbeetle_tpu.types import Operation
from tigerbeetle_tpu_torch import convert, types
from tigerbeetle_tpu_torch.models import ledger as tledger
from tigerbeetle_tpu_torch.ops import hashtable as ht
from tigerbeetle_tpu_torch.parallel import mesh as tmesh
from tigerbeetle_tpu_torch.testing import hazards as H

S = 8
A_LOG2, T_LOG2 = 12, 14
J_PROCESS = JConfigProcess(account_slots_log2=A_LOG2, transfer_slots_log2=T_LOG2)
SEED = 2024
TS = 10**12
N_PAD = 128  # the single table's batch: the longest request has 76 events
FAULT_SERIAL = 8


def _accounts():
    return [JAccount(**dataclasses.asdict(a)) for a in H.hazard_accounts()]


@pytest.fixture(scope="module")
def mesh_base(mesh):  # noqa: F811
    led = jax_ledger(mesh, J_PROCESS)
    accts = _accounts()
    assert led.execute_dense(Operation.create_accounts, 10_000, accts) == [0] * len(accts)
    return led, {k: np.asarray(v) for k, v in led.state.items()}


@pytest.fixture(scope="module")
def single_base():
    led = jledger.DeviceLedger(process=J_PROCESS, mode="auto")
    accts = _accounts()
    assert led.execute_dense(Operation.create_accounts, 10_000, accts) == [0] * len(accts)
    state = {k: np.array(v) for k, v in led.state.items()}
    H.fill_tomb_window(state["acct_rows"].view(np.int32), A_LOG2, np.random.default_rng(SEED))
    return state


def _request(case, n_shards):
    events = H.hazard_request(case, np.random.default_rng(SEED), T_LOG2, n_shards)
    return events, types.transfers_to_np(events)


def _tombs(xfer_rows) -> int:
    return int((xfer_rows[..., :-1, :4] == -1).all(-1).sum())


def _first_probe(state, t_id):
    """The row of transfer id `t_id`'s first probe position (on its owner
    shard for a sharded state)."""
    x = state["xfer_rows"]
    key4 = tledger.ids_to_batch([t_id], "cpu")["key4"]
    pos = int(ht.hash_key4(key4, T_LOG2)[0])
    if x.dim() == 3:
        return x[int(tmesh.owner_of_key4(key4, x.shape[0])[0]), pos]
    return x[pos]


def _check_hazard(case, events, codes, state, base_tombs, single):
    """The request shows the hazard it aims at (on the reference's codes
    and the port's state), and the fault word is the one it should give:
    FAULT_SERIAL for a missing pending's lookup that does not resolve (its
    own, or, on the single table, that of the tombstone's keys), else 0."""
    codes = list(codes)
    x = state["xfer_rows"]
    missing = [i for i, t in enumerate(events) if t.flags & (H._POST | H._VOID)]
    want_fault = FAULT_SERIAL if case == "missing_full" or (case == "missing_tomb" and single) \
        else 0
    assert int(state["fault"]) == want_fault
    if case == "chain_break_reuse":
        assert codes[4:15] == [1] * 11 and codes[15] == 18
        assert codes[19:25] == [0] * 6  # the rolled-back ids commit again
        assert _tombs(x) == base_tombs + 11 - 6  # six inserts reused tombstones
    elif case == "duplicate_id":
        assert {46, 39, 36} <= set(codes)
        assert codes.count(0) == len(codes) - 6  # 46 twice, 39, 36, the chain's two 1s
    elif case == "pending_post":
        assert codes.count(33) == 1 and codes.count(0) == len(codes) - 1
        ful = state["fulfill"]
        assert int((ful == 1).sum()) == 2 and int((ful == 2).sum()) == 1
    elif case == "post_and_void":
        assert codes.count(33) == 1 and codes.count(34) == 1
    elif case == "hot_account":
        assert 54 in codes and 55 in codes
        lo = convert.state_to_numpy(state)["acct_rows"].reshape(-1, 32)
        hot = [r for r in lo if int(r[0]) == H.HOT_DR and not r[1:4].any()][0]
        w = hot.astype(np.uint64)
        debits = int(w[4]) + int(w[8])  # low words of pending and posted debits
        credits = int(w[16])
        assert debits <= credits  # the limit held through the clamps
    elif case == "shared_window":
        ids = [t.id for t in events if t.id >= 1_000_000 + 10_000]
        key4 = tledger.ids_to_batch(ids[:1], "cpu")["key4"]
        base = int(ht.hash_key4(key4, T_LOG2)[0])
        pos = ht.probe_positions(tledger.ids_to_batch(ids[1:2], "cpu")["key4"], T_LOG2, 64)[0]
        assert int(pos[0]) == base  # b's first probe is a's slot
        assert codes[-21] != 0 and codes.count(0) == len(codes) - 1  # b again: exists
    elif case in ("missing_tomb", "missing_full"):
        assert len(missing) == 2 and [codes[i] for i in missing] == [25, 25]
        pid = events[missing[0]].pending_id
        if case == "missing_tomb":  # its first probe holds the rollback's tombstone
            assert codes[3:6] == [1, 1, 18]
            assert bool((_first_probe(state, pid)[:4] == -1).all())
        else:  # no empty slot is left in its window
            key4 = tledger.ids_to_batch([pid], "cpu")["key4"]
            pos = ht.probe_positions(key4, T_LOG2, 64)[0]
            rows = x[int(tmesh.owner_of_key4(key4, x.shape[0])[0])] if x.dim() == 3 else x
            assert bool((rows[pos, :4] != 0).any(-1).all())


@pytest.mark.parametrize("case", H.CASES)
def test_sharded_serial_hazard(mesh_base, case):
    led, state_np = mesh_base
    events, arr = _request(case, S)
    n = len(arr)
    rows = tmesh.batch_rows(arr)
    jstate = {k: jax.device_put(v, led.state[k].sharding) for k, v in state_np.items()}
    jstate, jr = led.kernels.commit_transfers_serial(
        jstate, {"rows": jnp.asarray(rows.view(np.uint32))}, jnp.int32(n), jnp.uint64(TS))
    pst = convert.state_from_numpy(state_np, "cpu")
    pr = tmesh.commit_transfers_serial_plain(pst, torch.from_numpy(rows), n, TS, A_LOG2,
                                             T_LOG2)
    jr = np.asarray(jr)
    np.testing.assert_array_equal(pr.numpy().view(np.uint32), jr)
    assert_mesh_equal(jstate, pst)
    _check_hazard(case, events, jr[:n], pst, _tombs(state_np["xfer_rows"].view(np.int32)),
                  single=False)


def _single_table(state_np, case, entry):
    """The request of `case` through the JAX single-table scan (`entry`:
    mode serial, or the residue entry with scattered timestamps) and the
    port's plain K4 from one state; checks codes and state equal."""
    events, arr = _request(case, 1)
    n = len(arr)
    rows = np.zeros((N_PAD, 32), dtype=np.uint32)
    rows[:n] = arr.view(np.uint32).reshape(n, 32)
    kern = jledger.get_kernels(J_PROCESS)
    js = {k: jnp.asarray(v) for k, v in state_np.items()}
    if entry == "serial":
        js, jr = kern.commit_transfers(js, {"rows": jnp.asarray(rows)}, jnp.int32(n),
                                       jnp.uint64(TS), mode="serial")
        ts_np = (np.uint64(TS - n + 1) + np.arange(n, dtype=np.uint64))
    else:  # a residue keeps its events' original, scattered batch timestamps
        gaps = np.random.default_rng(SEED + 1).integers(1, 9, n).astype(np.uint64)
        ts_np = np.uint64(TS) + np.cumsum(gaps, dtype=np.uint64)
        ts_pad = np.zeros(N_PAD, dtype=np.uint64)
        ts_pad[:n] = ts_np
        js, jr = kern.commit_transfers_residue(
            js, {"rows": jnp.asarray(rows), "ts": jnp.asarray(ts_pad)}, jnp.int32(n))
    st = convert.state_from_numpy(state_np, "cpu")
    pr = tledger.commit_transfers_serial_plain(
        st, torch.from_numpy(rows[:n].view(np.int32)), torch.from_numpy(ts_np.view(np.int64)),
        n, A_LOG2, T_LOG2)
    jr = np.asarray(jr)[:n]
    np.testing.assert_array_equal(pr.numpy().view(np.uint32), jr)
    assert_single_equal({k: np.asarray(v) for k, v in js.items()}, st)
    _check_hazard(case, events, jr, st, _tombs(state_np["xfer_rows"].view(np.int32)),
                  single=True)
    return ts_np, st


@pytest.mark.parametrize("case", H.CASES)
def test_single_table_serial_hazard(single_base, case):
    _single_table(single_base, case, "serial")


@pytest.mark.parametrize("case", H.CASES)
def test_single_table_residue_hazard(single_base, case):
    """The residue entry: commit_ts is the largest applied timestamp."""
    ts_np, st = _single_table(single_base, case, "residue")
    assert int(st["commit_ts"]) in [int(t) for t in ts_np]
