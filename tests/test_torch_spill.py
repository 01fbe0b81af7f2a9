"""The bounded-memory ledger of the PyTorch port against the JAX package, bit
for bit: the spill kernels (K10) and the spilling DeviceLedger over the
port's own copy of the LSM forest.

The port runs its plain PyTorch versions on the CPU; the JAX package runs
its jitted SpillKernels and DeviceLedger(forest=...) on the CPU, as
tests/test_spill.py runs them. Both spill stores use the deterministic
"deferred" IO executor, so the grid's block allocation does not depend on
thread timing. Inputs come from seeds (numpy,
testing.workload.WorkloadGenerator). Table leaves are compared without
their last (dump) row, which the JAX kernels write garbage into and the
port never writes. Tolerance: zero.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tigerbeetle_tpu  # noqa: F401  (x64 before any input is built)
from tigerbeetle_tpu.constants import TEST_CLUSTER as J_TEST_CLUSTER
from tigerbeetle_tpu.constants import TEST_PROCESS as J_TEST_PROCESS
from tigerbeetle_tpu.io.storage import MemoryStorage as JMemoryStorage
from tigerbeetle_tpu.io.storage import ZoneLayout as JZoneLayout
from tigerbeetle_tpu.lsm.grid import Grid as JGrid
from tigerbeetle_tpu.lsm.groove import Forest as JForest
from tigerbeetle_tpu.models import ledger as jledger
from tigerbeetle_tpu.models.spill import get_spill_kernels
from tigerbeetle_tpu.testing.workload import WorkloadGenerator
from tigerbeetle_tpu.types import transfers_to_np
from tigerbeetle_tpu_torch import convert
from tigerbeetle_tpu_torch.constants import TEST_CLUSTER, TEST_PROCESS
from tigerbeetle_tpu_torch.io.storage import MemoryStorage, ZoneLayout
from tigerbeetle_tpu_torch.lsm.grid import Grid
from tigerbeetle_tpu_torch.lsm.groove import Forest
from tigerbeetle_tpu_torch.models import ledger as tledger
from tigerbeetle_tpu_torch.models import spill as tspill
from tigerbeetle_tpu_torch.types import Operation

T_LOG2 = TEST_PROCESS.transfer_slots_log2
T_DUMP = 1 << T_LOG2
GRID = dict(offset=0, block_count=640, cache_blocks=64)  # as tests/test_spill.py
GRID_SIZE = 96 * 1024 * 1024
# the knobs of tests/test_spill.py run_spill_parity: the store fills past
# the 2048-row limit, and conflicts and two-phase events keep referencing
# long-spilled ids (the reload path)
KNOBS = dict(ledgers=(1,), invalid_rate=0.03, conflict_rate=0.06, chain_rate=0.02,
             two_phase_rate=0.15, balancing_rate=0.05, limit_account_rate=0.05)


def records(objs: dict):
    """{key: record} -> [(key, field dict)], insertion order kept, for the
    records of either package."""
    return [(k, dataclasses.asdict(v)) for k, v in objs.items()]


def assert_leaves_equal(jax_leaves: dict, port_leaves: dict) -> None:
    got = convert.state_to_numpy(port_leaves)
    for k, want in jax_leaves.items():
        want = np.asarray(want)
        g = got[k]
        if want.ndim:  # tables and columns: every slot but the dump slot
            want, g = want[:-1], g[:-1]
        np.testing.assert_array_equal(g, want, err_msg=k)


# ----------------------------------------------------------------------
# K10: the plain versions against the JAX SpillKernels
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def table():
    """A transfer table at TEST_PROCESS from a workload with linked chains
    (rolled-back chains leave tombstones), with a nonzero dump row whose
    timestamp would be the smallest: as int32 tensors and u32 numpy."""
    led = tledger.DeviceLedger(TEST_PROCESS, device="cpu")
    gen = WorkloadGenerator(5, ledgers=(1,), invalid_rate=0.05, chain_rate=0.2,
                            two_phase_rate=0.2, conflict_rate=0.05)
    ts = 10**9
    for b in range(28):
        op, ev = gen.gen_accounts_batch(32) if b < 2 else gen.gen_transfers_batch(80)
        ts += len(ev)
        led.execute_dense(op, ts, ev)
    st = led.state
    st["xfer_rows"][-1] = torch.arange(1, 33, dtype=torch.int32)
    st["xfer_rows"][-1, 30:] = 0
    st["fulfill"][-1] = 9
    rows = st["xfer_rows"].numpy().view(np.uint32)
    occ = ~((rows[:-1, :4] == 0).all(1) | (rows[:-1, :4] == 0xFFFFFFFF).all(1))
    tombs = int((rows[:-1, :4] == 0xFFFFFFFF).all(1).sum())
    assert tombs > 0 and occ.sum() > 800
    return st, int(occ.sum())


def jax_spill():
    return get_spill_kernels(J_TEST_PROCESS)


def test_spill_head_plain_matches_jax(table):
    st, live = table
    jk = jax_spill()
    for fault in (0, 0x40000010):
        f = torch.tensor(fault, dtype=torch.int32)
        got = tspill.spill_head_plain(st["xfer_rows"], f)
        want = np.asarray(jk.cycle_head(jnp.asarray(st["xfer_rows"].numpy().view(np.uint32)),
                                        jnp.uint32(fault)))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
        assert int(got[0]) == live


@pytest.mark.parametrize("cut", ["zero", "one", "third", "all_but_one", "all"])
def test_spill_split_plain_matches_jax(table, cut):
    """Both index arrays, on a table with tombstones and a nonzero dump row;
    with n_cold == live every live row is cold (the watermark is u64 max)."""
    st, live = table
    n_cold = {"zero": 0, "one": 1, "third": live // 3, "all_but_one": live - 1, "all": live}[cut]
    cold, hot = tspill.spill_split_plain(st["xfer_rows"], n_cold)
    j_cold, j_hot = jax_spill().split_idx(
        jnp.asarray(st["xfer_rows"].numpy().view(np.uint32)), jnp.int32(n_cold)
    )
    assert cold.dtype == hot.dtype == torch.int32
    assert cold.shape == (T_DUMP + tspill.CHUNK,)
    np.testing.assert_array_equal(cold.numpy(), np.asarray(j_cold))
    np.testing.assert_array_equal(hot.numpy(), np.asarray(j_hot))
    assert int((cold < T_DUMP).sum()) == n_cold
    assert int((hot < T_DUMP).sum()) == live - n_cold


@pytest.mark.parametrize("cut", ["zero", "third", "all"])
def test_cycle_split_over_its_head_matches_jax(table, cut):
    """The cycle's pairing: `SpillKernels.cycle_head` returns the handle of
    its table pass and `split_idx` takes it; the live count and both lists
    equal the JAX `cycle_head` and `split_idx`."""
    st, live = table
    kernels = tspill.SpillKernels(TEST_PROCESS)
    scan = kernels.cycle_head(st)
    j_rows = jnp.asarray(st["xfer_rows"].numpy().view(np.uint32))
    want_head = np.asarray(jax_spill().cycle_head(j_rows, jnp.uint32(int(st["fault"]))))
    np.testing.assert_array_equal(scan.head.numpy().view(np.uint32), want_head)
    n_cold = {"zero": 0, "third": live // 3, "all": live}[cut]
    cold, hot = kernels.split_idx(scan, st["xfer_rows"], n_cold)
    j_cold, j_hot = jax_spill().split_idx(j_rows, jnp.int32(n_cold))
    np.testing.assert_array_equal(cold.numpy(), np.asarray(j_cold))
    np.testing.assert_array_equal(hot.numpy(), np.asarray(j_hot))


def _written_by_a_row(st):
    st["xfer_rows"][5, 0] += 1


def _written_by_a_commit(st):
    rows_b = torch.zeros((4, 32), dtype=torch.int32)
    rows_b[:, 0] = torch.arange(1, 5, dtype=torch.int32) + (1 << 30)  # new ids
    rows_b[:, 4], rows_b[:, 8], rows_b[:, 24] = 1, 2, 10  # debit, credit, amount
    rows_b[:, 29] = 1 << 16 | 1  # ledger 1, code 1
    tledger.commit_transfers_fast_plain(st, rows_b, 4, 10**12, TEST_PROCESS.account_slots_log2,
                                        T_LOG2, False)


def _written_by_a_reload(st):
    rows_b, ful_b = tspill.spill_gather_plain(st["xfer_rows"], st["fulfill"],
                                              torch.arange(8, dtype=torch.int32))
    rows_b[:, 0] = torch.arange(8, dtype=torch.int32) + (1 << 29)  # ids not resident
    rows_b[:, 1:4] = 0
    tspill.spill_reload_plain(st, rows_b, ful_b, torch.ones(8, dtype=torch.bool), T_LOG2)


@pytest.mark.parametrize("write", [_written_by_a_row, _written_by_a_commit,
                                   _written_by_a_reload, None])
def test_split_refuses_a_scan_of_a_written_table(table, write):
    """A split handed a head's handle whose table was written after the
    scan (a row set in place, a commit, a reload), or another table, raises
    instead of using the pass's stale list; a read of the table in between
    does not stop it; a handle serves one split."""
    st = {k: v.clone() for k, v in table[0].items()}
    scan = tspill.spill_scan(st["xfer_rows"], st["fault"], T_LOG2)
    tspill.spill_gather_plain(st["xfer_rows"], st["fulfill"], torch.arange(4))
    live = int(scan.head[0])
    if write is None:  # another table with the same rows; a second split
        with pytest.raises(RuntimeError):
            scan.split(st["xfer_rows"].clone(), live // 2)
        cold, hot = scan.split(st["xfer_rows"], live // 2)
        want = tspill.spill_split_plain(st["xfer_rows"], live // 2)
        assert torch.equal(cold, want[0]) and torch.equal(hot, want[1])
        with pytest.raises(RuntimeError, match="served a split"):
            scan.split(st["xfer_rows"], live // 2)
        return
    write(st)
    with pytest.raises(RuntimeError, match="written after its scan"):
        scan.split(st["xfer_rows"], live // 2)


def test_kernel_table_writes_move_the_version():
    """A launcher's `wrote` tensors get their version counters moved, as a
    torch in-place op moves them (a kernel writes through a raw pointer,
    which torch does not see)."""
    from tigerbeetle_tpu_torch import kernels

    class Lib:
        def tb_fake(self):
            return 0

    t = torch.zeros(4)
    before, saved = t._version, kernels._lib
    kernels._lib = Lib()
    try:
        kernels._launch("tb_fake", "spill_head", wrote=(t,))
    finally:
        kernels._lib = saved
        kernels.LAUNCHES["spill_head"] -= 1
    assert t._version == before + 1


def test_spill_gather_plain_matches_jax(table):
    st, _ = table
    rng = np.random.default_rng(3)
    idx = rng.integers(0, T_DUMP + 1, tspill.CHUNK).astype(np.int32)
    idx[:5] = T_DUMP  # padding lanes read the dump row
    rows, ful = tspill.spill_gather_plain(st["xfer_rows"], st["fulfill"], torch.from_numpy(idx))
    j_rows, j_ful = jax_spill().gather(jnp.asarray(st["xfer_rows"].numpy().view(np.uint32)),
                                       jnp.asarray(st["fulfill"].numpy().view(np.uint32)),
                                       jnp.asarray(idx))
    np.testing.assert_array_equal(rows.numpy().view(np.uint32), np.asarray(j_rows))
    np.testing.assert_array_equal(ful.numpy().view(np.uint32), np.asarray(j_ful))


RELOAD_LEAVES = ("xfer_rows", "fulfill", "xfer_claim", "xfer_used_slots", "fault")


def reload_both(tbl: dict, rows_b: np.ndarray, ful_b: np.ndarray, active: np.ndarray):
    """The JAX reload and the port's plain one on copies of `tbl` (u32/u64
    numpy leaves): every leaf and the probe word must be equal. Returns the
    port's leaves after the reload."""
    j_out = jax_spill().reload(
        *(jnp.asarray(np.array(tbl[k])) for k in RELOAD_LEAVES),
        jnp.asarray(rows_b), jnp.asarray(ful_b), jnp.asarray(active),
    )
    t_tbl = convert.state_from_numpy(tbl, "cpu")
    probe = tspill.spill_reload_plain(
        t_tbl, torch.from_numpy(rows_b.view(np.int32)), torch.from_numpy(ful_b.view(np.int32)),
        torch.from_numpy(active), T_LOG2,
    )
    assert_leaves_equal(dict(zip(RELOAD_LEAVES, j_out[:5])), t_tbl)
    assert probe.dtype == torch.int32
    assert int(probe) & 0xFFFFFFFF == int(np.asarray(j_out[5]))
    return convert.state_to_numpy(t_tbl)


def leaves(st) -> dict:
    return {k: v for k, v in convert.state_to_numpy(st).items() if k in RELOAD_LEAVES}


def test_spill_reload_plain_matches_jax(table):
    """Reload on every leaf: the rebuild of a fresh table from the hot tail
    chunk by chunk, a reload of absent and resident rows into the live
    table and its idempotent re-reload, then each fault: PROBE and CLAIM on
    exhausted probe windows, CAPACITY past half the slots, and an earlier
    fault, each leaving the table as it was."""
    st, live = table
    src = leaves(st)
    rows_np, ful_np = src["xfer_rows"], src["fulfill"]
    _, hot = tspill.spill_split_plain(st["xfer_rows"], live // 4)
    hot = hot.numpy()
    fresh = convert.state_to_numpy(tspill.fresh_table(T_LOG2, "cpu"))
    n_hot = live - live // 4
    for start in range(0, n_hot, 1024):  # the rebuild's pattern, in smaller chunks
        idx = hot[start:start + 1024]
        active = np.arange(1024) < min(1024, n_hot - start)
        fresh = reload_both(fresh, rows_np[idx], ful_np[idx], active)
    assert int(fresh["xfer_used_slots"]) == n_hot and int(fresh["fault"]) == 0

    # absent rows (the cold ones) and resident ones (hot) into the rebuilt
    # table, some lanes inactive; then the same chunk again: a no-op
    cold, _ = tspill.spill_split_plain(st["xfer_rows"], live // 4)
    idx = np.concatenate([cold.numpy()[:200], hot[:56]])
    active = np.ones(256, dtype=bool)
    active[[3, 250]] = False
    once = reload_both(fresh, rows_np[idx], ful_np[idx], active)
    assert int(once["xfer_used_slots"]) == n_hot + 199
    twice = reload_both(once, rows_np[idx], ful_np[idx], active)
    for k in RELOAD_LEAVES:
        np.testing.assert_array_equal(twice[k], once[k], err_msg=k)

    # exhausted windows: every empty slot filled with random keys
    rng = np.random.default_rng(11)
    full = {k: np.array(v) for k, v in fresh.items()}
    empty = np.nonzero((full["xfer_rows"][:-1, :4] == 0).all(1))[0]
    full["xfer_rows"][empty] = rng.integers(1, 1 << 32, (len(empty), 32), dtype=np.uint64)
    probe_claim = reload_both(full, rows_np[idx], ful_np[idx], active)
    assert int(probe_claim["fault"]) == tledger.FAULT_PROBE | tledger.FAULT_CLAIM
    # capacity: one slot short of room for the new rows
    cap = dict(fresh)
    cap["xfer_used_slots"] = np.uint64(T_DUMP // 2 - 198)
    out = reload_both(cap, rows_np[idx], ful_np[idx], active)
    assert int(out["fault"]) == tledger.FAULT_CAPACITY
    # an earlier fault: no write, the word stays
    sticky = dict(fresh)
    sticky["fault"] = np.uint32(tledger.FAULT_SERIAL)
    out = reload_both(sticky, rows_np[idx], ful_np[idx], active)
    assert int(out["fault"]) == tledger.FAULT_SERIAL
    np.testing.assert_array_equal(out["xfer_rows"], fresh["xfer_rows"])


# ----------------------------------------------------------------------
# the slice end to end: the spilling DeviceLedger in both packages
# ----------------------------------------------------------------------


class SpillPair:
    """The JAX DeviceLedger(forest=...) and the port's, each over its own
    MemoryStorage and Forest, both with the deferred IO executor."""

    def __init__(self):
        self.j_storage = JMemoryStorage(JZoneLayout(J_TEST_CLUSTER, grid_size=GRID_SIZE))
        self.t_storage = MemoryStorage(ZoneLayout(TEST_CLUSTER, grid_size=GRID_SIZE))
        self.jax = jledger.DeviceLedger(process=J_TEST_PROCESS, mode="auto",
                                        forest=JForest(JGrid(self.j_storage, **GRID)),
                                        spill_io="deferred")
        self.port = tledger.DeviceLedger(TEST_PROCESS, device="cpu",
                                         forest=Forest(Grid(self.t_storage, **GRID)),
                                         spill_io="deferred")
        self.cycles = 0

    def run(self, op, ts, events, b):
        dj = self.jax.execute_dense(op, ts, events)
        dt = self.port.execute_dense(op, ts, events)
        assert dt == dj, (b, [(i, t, j) for i, (t, j) in enumerate(zip(dt, dj)) if t != j][:8])
        assert (self.port._xfer_used, self.port._acct_used) == \
            (self.jax._xfer_used, self.jax._acct_used), b
        cycles = self.port.spill.stats["cycles"]
        assert cycles == self.jax.spill.stats["cycles"], b
        if cycles != self.cycles:  # after every cycle: the rebuilt table
            self.cycles = cycles
            self.check_tables()

    def check_tables(self, prefilter=True):
        """Every state leaf and the spilled-id set; with `prefilter`, also
        the sorted lo-limb prefilter (it may hold stale ids between cycles,
        so a store restored from a checkpoint rebuilds a smaller one)."""
        assert_leaves_equal({k: np.asarray(v) for k, v in self.jax.state.items()},
                            self.port.state)
        assert self.port.spill.spilled == self.jax.spill.spilled
        if prefilter:
            np.testing.assert_array_equal(self.port.spill._lo, self.jax.spill._lo)

    def check_extract(self):
        ja, jt, jp = self.jax.extract()
        ta, tt, tp = self.port.extract()
        assert records(ta) == records(ja)
        assert records(tt) == records(jt)
        assert list(tp.items()) == list(jp.items())
        return jt


def run_pair(seed, n_transfer_batches, pair=None, gen=None, ts=1_000_000_000):
    pair = pair or SpillPair()
    gen = gen or WorkloadGenerator(seed, **KNOBS)
    if not pair.port.state["acct_count"]:
        for b in range(4):
            op, events = gen.gen_accounts_batch(40)
            ts += len(events)
            pair.run(op, ts, events, b)
    for b in range(n_transfer_batches):
        op, events = gen.gen_transfers_batch(72)
        ts += len(events)
        pair.run(op, ts, events, 4 + b)
        if b % 10 == 9:
            pair.check_extract()
    return pair, gen, ts


def check_queries(pair, transfers: dict):
    """query_accounts / query_transfers on the fields tests/test_query_index.py
    uses; at least one transfer query must reach a spilled row."""
    some_acct = next(iter(pair.jax.extract()[0]))
    for field, v in (("ledger", 1), ("code", 1), ("code", 50)):
        assert [dataclasses.asdict(a) for a in pair.port.query_accounts(field, v)] == \
            [dataclasses.asdict(a) for a in pair.jax.query_accounts(field, v)], (field, v)
    checks = [("ledger", 1), ("code", 7), ("code", 50), ("debit_account_id", some_acct),
              ("credit_account_id", some_acct), ("amount", 1), ("user_data_32", 0)]
    spilled_hit = False
    for field, v in checks:
        got = pair.port.query_transfers(field, v)
        assert [dataclasses.asdict(t) for t in got] == \
            [dataclasses.asdict(t) for t in pair.jax.query_transfers(field, v)], (field, v)
        spilled_hit |= any(t.id in pair.port.spill.spilled for t in got)
    assert spilled_hit


def check_lookups(pair, transfers: dict):
    ids = sorted(transfers)
    rng = np.random.default_rng(0)
    sample = [ids[i] for i in rng.choice(len(ids), size=80, replace=False)] + [9_999_999_999]
    body = pair.port.lookup_rows(Operation.lookup_transfers, sample)
    assert body == pair.jax.lookup_rows(Operation.lookup_transfers, sample)
    assert len(body) == 128 * 80
    assert any(i in pair.port.spill.spilled for i in sample)
    accts = sorted(pair.jax.extract()[0])[:20] + [123456789]
    assert pair.port.lookup_rows(Operation.lookup_accounts, accts) == \
        pair.jax.lookup_rows(Operation.lookup_accounts, accts)


@pytest.mark.parametrize("seed,n_batches", [(11, 60), (22, 52)])
def test_spilling_ledger_matches_jax(seed, n_batches):
    """run_spill_parity's workload (tests/test_spill.py) through both
    spilling ledgers: equal codes and occupancy batch by batch; after every
    cycle the same table bytes and spilled-id set; equal extract() every 10
    batches; then equal queries and lookups, and after checkpoint_meta() the
    same meta and the same storage bytes (the grid-identity contract that
    replicas repair by, tests/test_grid_identity.py)."""
    pair, _, _ = run_pair(seed, n_batches)
    stats = pair.port.spill.stats
    assert stats["cycles"] >= 1 and stats["reloaded"] >= 1 and pair.port.spill.spilled
    assert dict(stats)["spilled"] == dict(pair.jax.spill.stats)["spilled"]
    assert stats["reloaded"] == pair.jax.spill.stats["reloaded"]
    pair.check_tables()
    transfers = pair.check_extract()
    check_queries(pair, transfers)
    check_lookups(pair, transfers)
    meta_j = pair.jax.spill.checkpoint_meta()
    meta_t = pair.port.spill.checkpoint_meta()
    assert meta_t == meta_j
    assert pair.t_storage.data == pair.j_storage.data


def test_group_commit_is_off_under_spill():
    """A spill store's reloads change the state between batches: the group
    path declines, and StateMachine commits batch by batch."""
    pair = SpillPair()
    gen = WorkloadGenerator(3, ledgers=(1,), invalid_rate=0.0, conflict_rate=0.0,
                            chain_rate=0.0, two_phase_rate=0.0, balancing_rate=0.0,
                            limit_account_rate=0.0)
    _, accounts = gen.gen_accounts_batch(16)
    pair.port.execute_dense(Operation.create_accounts, 100, accounts)
    items = [(200 + 64 * i, transfers_to_np(gen.gen_transfers_batch(64)[1])) for i in range(3)]
    assert pair.port.try_execute_group_async(items) is None

