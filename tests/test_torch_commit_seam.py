"""The replica's commit seam in the PyTorch port against the JAX package,
bit for bit: the fused group commit (K5), the state fingerprint (K6) and the
snapshot row install (K9).

The port runs its plain PyTorch versions on the CPU; the JAX package runs as
its own tests run it, on the CPU. Inputs come from seeds
(testing.workload.WorkloadGenerator, numpy). Table leaves are compared
without their last (dump) row, which the JAX kernels write garbage into and
the port never writes. Tolerance: zero.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import tigerbeetle_tpu  # noqa: F401  (x64 before any input is built)
from tigerbeetle_tpu.constants import TEST_PROCESS as J_TEST_PROCESS
from tigerbeetle_tpu.models import ledger as jledger
from tigerbeetle_tpu.testing.workload import WorkloadGenerator
from tigerbeetle_tpu.types import (
    ACCOUNT_DTYPE,
    TRANSFER_DTYPE,
    Account,
    Operation,
    Transfer,
    TransferFlags,
    transfers_to_np,
)
from tigerbeetle_tpu_torch import convert
from tigerbeetle_tpu_torch.constants import TEST_PROCESS
from tigerbeetle_tpu_torch.models import ledger as tledger

U64 = (1 << 64) - 1


def assert_state_equal(want_np: dict, port_state: dict) -> None:
    got = convert.state_to_numpy(port_state)
    assert want_np.keys() == got.keys()
    for k, want in want_np.items():
        g = got[k]
        if want.ndim:  # tables: every row but the dump row
            want, g = want[:-1], g[:-1]
        assert g.dtype == want.dtype, k
        np.testing.assert_array_equal(g, want, err_msg=k)


def jax_state_np(state) -> dict:
    return {k: np.asarray(v) for k, v in state.items()}


def assert_hazards_equal(jh, th) -> None:
    assert th.amount_sum == jh.amount_sum
    assert th.plan_stats == jh.plan_stats
    assert th.limit_account_ids == jh.limit_account_ids
    np.testing.assert_array_equal(th._limit_lo, jh._limit_lo)
    assert th.pending_accounts == jh.pending_accounts


class Pair:
    """The JAX DeviceLedger and the port's (plain versions on the CPU)."""

    def __init__(self, mode="auto"):
        self.jax = jledger.DeviceLedger(process=J_TEST_PROCESS, mode=mode)
        self.port = tledger.DeviceLedger(process=TEST_PROCESS, mode=mode, device="cpu")

    def run(self, op, ts, events):
        dj = self.jax.execute_dense(op, ts, events)
        dt = self.port.execute_dense(op, ts, events)
        assert dt == dj
        return dt

    def check(self):
        assert_state_equal(jax_state_np(self.jax.state), self.port.state)
        assert_hazards_equal(self.jax.hazards, self.port.hazards)
        assert (self.port._acct_used, self.port._xfer_used) == \
            (self.jax._acct_used, self.jax._xfer_used)


# ----------------------------------------------------------------------
# K5: group commit
# ----------------------------------------------------------------------


def _fast_generator(seed):
    """Traffic the planner proves fast: one ledger, no chains, two-phase,
    balancing, limit accounts or duplicate ids; invalid events stay."""
    return WorkloadGenerator(seed, ledgers=(1,), invalid_rate=0.2, conflict_rate=0.0,
                             chain_rate=0.0, two_phase_rate=0.0, balancing_rate=0.0,
                             limit_account_rate=0.0)


def _group_items(gen, sizes, ts):
    """[(timestamp, transfers ndarray)] with increasing timestamps, each
    batch one the planner proves fast (a drawn batch with a duplicate id,
    such as two invalid id-0 events, is drawn again). The first batch is
    all valid, so both drains (summary only, and codes) run."""
    probe = tledger.HazardTracker()
    items = []
    for i, size in enumerate(sizes):
        if i == 0:
            ids = gen.account_ids
            arr = transfers_to_np([
                Transfer(id=gen._fresh_id(), debit_account_id=ids[j % len(ids)],
                         credit_account_id=ids[(j + 1) % len(ids)], amount=1 + j,
                         ledger=1, code=1) for j in range(size)])
        else:
            while True:
                arr = transfers_to_np(gen.gen_transfers_batch(size)[1])
                if probe.plan(arr)[0] == "fast":
                    break
        ts += size
        items.append((ts, arr))
    return items, ts


@pytest.mark.parametrize("sizes", [(64, 37, 50), (64, 23, 64, 41, 9)], ids=["k4", "k16"])
def test_k5_group_commit(sizes):
    """try_execute_group_async on the same items in both packages: per-batch
    drained codes, the group summary, every state leaf, the planner's stats
    and amount bound; and the same codes and state as sequential
    execute_async in the port."""
    gen = _fast_generator(len(sizes))
    pair = Pair()
    seq = tledger.DeviceLedger(process=TEST_PROCESS, device="cpu")
    ts = 10**9
    _, accounts = gen.gen_accounts_batch(48)
    ts += len(accounts)
    pair.run(Operation.create_accounts, ts, accounts)
    seq.execute_dense(Operation.create_accounts, ts, accounts)
    items, ts = _group_items(gen, sizes, ts)

    pj = pair.jax.try_execute_group_async(items)
    pt = pair.port.try_execute_group_async(items)
    assert pj is not None and pt is not None and len(pt) == len(items)
    k = 4 if len(items) <= 4 else 16
    assert pt[0].group.k == pj[0].group.k == k
    assert pt[0].group.n_pad == pj[0].group.n_pad == 64
    np.testing.assert_array_equal(pt[0].group.summary.numpy().view(np.uint32),
                                  np.asarray(pj[0].group.summary))
    np.testing.assert_array_equal(pt[0].group.results.numpy().view(np.uint32),
                                  np.asarray(pj[0].group.results))
    pair.port.drain_many(pt)
    pair.jax.drain_many(pj)
    codes = [pair.port.drain(p) for p in pt]
    assert codes == [pair.jax.drain(p) for p in pj]
    assert not any(codes[0]) and any(any(c) for c in codes[1:])
    pair.check()
    pair.port.check_fault()

    # the group is the fast commit of each batch, in order
    seq_codes = [seq.drain(seq.execute_async(Operation.create_transfers, t, arr))
                 for t, arr in items]
    assert seq_codes == codes
    assert_state_equal(convert.state_to_numpy(seq.state), pair.port.state)
    assert seq.hazards.amount_sum == pair.port.hazards.amount_sum
    assert seq._xfer_used == pair.port._xfer_used


def test_k5_group_declines():
    """A group that holds a linked-chain batch returns None in both packages
    with the planner's amount bound and stats rolled back; so does a single
    item, and a ledger in a forced mode."""
    gen = _fast_generator(7)
    pair = Pair()
    ts = 10**9
    _, accounts = gen.gen_accounts_batch(32)
    ts += len(accounts)
    pair.run(Operation.create_accounts, ts, accounts)
    items, ts = _group_items(gen, (40, 30), ts)
    linked = items[1][1].copy()
    linked["flags"][:3] |= np.uint16(int(TransferFlags.linked))
    mixed = [items[0], (items[1][0], linked)]
    before = (pair.port.hazards.amount_sum, dict(pair.port.hazards.plan_stats))
    assert pair.jax.try_execute_group_async(mixed) is None
    assert pair.port.try_execute_group_async(mixed) is None
    assert (pair.port.hazards.amount_sum, pair.port.hazards.plan_stats) == before
    assert pair.port.try_execute_group_async(items[:1]) is None
    assert pair.jax.try_execute_group_async(items[:1]) is None
    pair.check()
    forced = tledger.DeviceLedger(process=TEST_PROCESS, mode="fast", device="cpu")
    assert forced.try_execute_group_async(items) is None
    # the declined items then commit one by one, as the replica does
    for t, arr in mixed:
        pair.run(Operation.create_transfers, t, arr)
    pair.check()


def test_k5_group_fault_is_sticky():
    """Slot 2 of 4 trips the device's load-factor guard: slots 3 and 4 are
    no-ops in both packages, and the fault word ends the flat results and
    the summary."""
    gen = _fast_generator(9)
    pair = Pair()
    ts = 10**9
    _, accounts = gen.gen_accounts_batch(32)
    ts += len(accounts)
    pair.run(Operation.create_accounts, ts, accounts)
    items, ts = _group_items(gen, (64, 64, 64, 64), ts)
    limit = (1 << J_TEST_PROCESS.transfer_slots_log2) // 2
    used = np.uint64(limit - 64 - 20)  # slot 1 fits, slot 2 does not
    js = dict(jax_state_np(pair.jax.state), xfer_used_slots=used)
    pair.jax.state = {k: jnp.asarray(v) for k, v in js.items()}
    pair.port.state = convert.state_from_numpy(js, "cpu")
    pj = pair.jax.try_execute_group_async(items)
    pt = pair.port.try_execute_group_async(items)
    summary = pt[0].group.summary.numpy().view(np.uint32)
    np.testing.assert_array_equal(summary, np.asarray(pj[0].group.summary))
    np.testing.assert_array_equal(pt[0].group.results.numpy().view(np.uint32),
                                  np.asarray(pj[0].group.results))
    assert summary[-1] == jledger.FAULT_CAPACITY
    assert_state_equal(jax_state_np(pair.jax.state), pair.port.state)
    assert int(pair.port.state["xfer_used_slots"]) == int(used) + 64
    with pytest.raises(RuntimeError, match="capacity-guard"):
        pair.port.drain(pt[1])


# ----------------------------------------------------------------------
# K6: state fingerprint
# ----------------------------------------------------------------------


def _state_with_tombstones():
    """A JAX ledger holding accounts, transfers, open pendings, and the
    tombstones of a broken linked chain."""
    pair = Pair()
    ts = 10_000
    accts = [Account(id=i, ledger=1, code=1) for i in range(1, 41)]
    ts += len(accts)
    pair.run(Operation.create_accounts, ts, accts)
    tr = [Transfer(id=1000 + i, debit_account_id=1 + i % 30, credit_account_id=2 + i % 30,
                   amount=10 + i, ledger=1, code=1,
                   flags=int(TransferFlags.pending) if i % 4 == 0 else 0) for i in range(40)]
    tr += [
        Transfer(id=3000, debit_account_id=1, credit_account_id=2, amount=5, ledger=1, code=1,
                 flags=int(TransferFlags.linked)),
        Transfer(id=3001, debit_account_id=2, credit_account_id=3, amount=5, ledger=1, code=1,
                 flags=int(TransferFlags.linked)),
        Transfer(id=3002, debit_account_id=2, credit_account_id=3, amount=0, ledger=1, code=1),
    ]
    ts += len(tr)
    assert pair.run(Operation.create_transfers, ts, tr)[-3:] == [1, 1, 18]
    pair.check()
    return pair


def test_k6_state_fingerprint():
    """state_fingerprint through the JAX function and the port on one state
    (carried across by convert) that holds tombstones and a garbage dump
    row; both against fp_rows_np over the host rows, and the ledgers'
    fingerprint() dicts against each other."""
    pair = _state_with_tombstones()
    st = jax_state_np(pair.jax.state)
    xfer = st["xfer_rows"][:-1]
    assert (xfer[:, :4] == 0xFFFFFFFF).all(axis=1).sum() == 2  # the chain's inserts
    rng = np.random.default_rng(5)
    for table in ("acct_rows", "xfer_rows"):
        st[table] = st[table].copy()
        st[table][-1] = rng.integers(1, 1 << 32, 32, dtype=np.uint64).astype(np.uint32)
    want = {k: int(np.asarray(v)) for k, v in
            jledger.state_fingerprint({k: jnp.asarray(v) for k, v in st.items()}).items()}
    got = {k: int(v) & U64 for k, v in
           tledger.state_fingerprint(convert.state_from_numpy(st, "cpu")).items()}
    assert got == want
    assert got["accounts"] == 40 and got["transfers"] == 40
    assert tledger.fp_rows_np(st["acct_rows"][:-1]) == jledger.fp_rows_np(st["acct_rows"][:-1]) \
        == (want["accounts_fp"], want["accounts"])
    assert tledger.fp_rows_np(xfer) == (want["transfers_fp"], want["transfers"])
    assert pair.port.fingerprint() == pair.jax.fingerprint()
    lazy = pair.port.fingerprint_lazy()
    assert {k: int(v) & U64 for k, v in lazy.items()} == pair.port.fingerprint()


# ----------------------------------------------------------------------
# K9: snapshot row install
# ----------------------------------------------------------------------


def _live(rows: np.ndarray) -> np.ndarray:
    k4 = rows[:, :4]
    return ~(k4 == 0).all(axis=1) & ~(k4 == 0xFFFFFFFF).all(axis=1)


def _snapshot():
    """Live row images, fulfill column and commit timestamp of a JAX ledger
    that ran mixed traffic: limit accounts, posted and voided pendings,
    tombstones."""
    gen = WorkloadGenerator(21, ledgers=(1,))
    src = jledger.DeviceLedger(process=J_TEST_PROCESS, mode="auto")
    ts = 10**9
    for b in range(10):
        op, events = gen.gen_accounts_batch(40) if b % 5 == 0 else gen.gen_transfers_batch(64)
        ts += len(events)
        src.execute_dense(op, ts, events)
    src.check_fault()
    st = jax_state_np(src.state)
    acct, xfer, ful = st["acct_rows"][:-1], st["xfer_rows"][:-1], st["fulfill"][:-1]
    a_live, t_live = _live(acct), _live(xfer)
    accounts = np.frombuffer(acct[a_live].tobytes(), dtype=ACCOUNT_DTYPE)
    transfers = np.frombuffer(xfer[t_live].tobytes(), dtype=TRANSFER_DTYPE)
    return src, accounts, transfers, ful[t_live].copy(), src.commit_timestamp


@pytest.mark.parametrize("case", ["restore", "exhausted"])
def test_k9_install_snapshot_rows(case):
    """reset_state + install_snapshot_rows in both packages on the same rows,
    with INSTALL_CHUNK = 64 so that chunk boundaries are crossed: every
    state leaf, the rebuilt hazard fields and occupancy. `exhausted` first
    fills every empty transfer slot, so rows find no slot and FAULT_INSTALL
    (bit 30) is set in both."""
    src, accounts, transfers, fulfill, commit_ts = _snapshot()
    assert len(transfers) > 2 * 64 and fulfill.any()
    pair = Pair()
    for led in (pair.jax, pair.port):
        led.INSTALL_CHUNK = 64
        led.reset_state()
    if case == "exhausted":
        rng = np.random.default_rng(8)
        st = jax_state_np(pair.jax.state)
        rows = st["xfer_rows"].copy()
        rows[:-1] = rng.integers(1, 1 << 32, rows[:-1].shape, dtype=np.uint64).astype(np.uint32)
        rows[rng.choice(len(rows) - 1, 40, replace=False)] = 0xFFFFFFFF
        st["xfer_rows"] = rows
        pair.jax.state = {k: jnp.asarray(v) for k, v in st.items()}
        pair.port.state = convert.state_from_numpy(st, "cpu")
    for led in (pair.jax, pair.port):
        led.install_snapshot_rows(accounts, transfers, fulfill, commit_ts)
    pair.check()
    fault = int(pair.port.state["fault"])
    if case == "exhausted":
        assert fault == tledger.FAULT_INSTALL
        with pytest.raises(RuntimeError, match="install-probe"):
            pair.port.check_fault()
        return
    assert fault == 0
    assert pair.port.fingerprint() == src.fingerprint()
    assert pair.port.commit_timestamp == commit_ts
    ids = [int(a["id_lo"]) | (int(a["id_hi"]) << 64) for a in accounts[:20]]
    assert [a.id for a in pair.port.lookup_accounts(ids)] == ids
