"""The port's sharded ledger against the JAX package's, bit for bit (fast tiers).

The JAX `ShardedLedger` runs on the conftest's 8-device CPU mesh; the
port's `ShardedLedger(8, ..., device="cpu")` runs its plain versions, which
keep the JAX programs' shape (every shard probes every lane, an owner mask,
a sum over the shard axis for the psum). Per batch: the dense codes, every
shard's table bytes, the per-shard used counters, the scalars and the fault
word, and the host's occupancy guard and amount bound. Table leaves are
compared without each shard's dump row (their last row): the JAX kernels
send masked writes there and the port never writes it. Tolerance: zero.

Here: the owner hash, lookups, a clean workload on the fast tiers, the
fast tiers' fault gates from one carried state, the load guard, the
combined overflow, checkpoint blobs in both directions, carrying a JAX
ledger across with `convert.carry_sharded`, and StateMachine over the port.
tests/test_torch_mesh_serial.py holds the serial tiers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import tigerbeetle_tpu  # noqa: F401  (x64 before any input is built)
from tigerbeetle_tpu.constants import ConfigProcess as JConfigProcess
from tigerbeetle_tpu.models import ledger as jledger
from tigerbeetle_tpu.models.oracle import OracleStateMachine
from tigerbeetle_tpu.parallel import mesh as jmesh
from tigerbeetle_tpu.testing.workload import WorkloadGenerator
from tigerbeetle_tpu.types import (
    Account,
    Operation,
    Transfer,
    TransferFlags,
    accounts_to_np,
    transfers_to_np,
)
from tigerbeetle_tpu_torch import convert
from tigerbeetle_tpu_torch.constants import ConfigProcess
from tigerbeetle_tpu_torch.models import ledger as tledger
from tigerbeetle_tpu_torch.parallel import mesh as tmesh

S = 8
J_PROCESS = JConfigProcess(account_slots_log2=10, transfer_slots_log2=12)
PROCESS = ConfigProcess(account_slots_log2=10, transfer_slots_log2=12)
# the leaves whose last row per shard is the dump row, masked in every
# comparison; the [S] counters and the scalars are compared whole
DUMP_LEAVES = ("acct_rows", "xfer_rows", "fulfill", "acct_claim", "xfer_claim", "bal_acc")


@pytest.fixture(scope="module")
def mesh():
    devices = jax.devices()[:S]
    assert len(devices) == S, "conftest must provide 8 virtual CPU devices"
    return Mesh(np.array(devices), ("shard",))


_JAX_KERNELS = {}


def jax_ledger(mesh, process=J_PROCESS):
    """A JAX ShardedLedger whose jitted kernels are shared with every other
    ledger of this geometry in the process (each new kernel object would
    compile anew)."""
    led = jmesh.ShardedLedger(mesh, process)
    key = (mesh.devices.size, process.account_slots_log2, process.transfer_slots_log2)
    led.kernels = _JAX_KERNELS.setdefault(key, led.kernels)
    return led


def assert_state_equal(jstate, port_state) -> None:
    want = {k: np.asarray(v) for k, v in jstate.items()}
    got = convert.state_to_numpy(port_state)
    assert want.keys() == got.keys()
    for k, w in want.items():
        g = got[k]
        if k in DUMP_LEAVES:
            w, g = w[:, :-1], g[:, :-1]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def fields(objs):
    """{id: record} or [record] -> field dicts, for records of either package."""
    if isinstance(objs, dict):
        return {k: dataclasses.asdict(v) for k, v in objs.items()}
    return [dataclasses.asdict(v) for v in objs]


class Pair:
    """The JAX ShardedLedger and the port's (plain versions on the CPU), and
    with `oracle` the oracle too, fed the same batches."""

    def __init__(self, mesh, oracle=False):
        self.jax = jax_ledger(mesh)
        self.port = tmesh.ShardedLedger(S, PROCESS, device="cpu")
        self.oracle = OracleStateMachine() if oracle else None

    def run(self, op, ts, events):
        dense_j = self.jax.execute_dense(op, ts, events)
        dense_t = self.port.execute_dense(op, ts, events)
        assert dense_t == dense_j, [
            (i, t, j) for i, (t, j) in enumerate(zip(dense_t, dense_j)) if t != j][:8]
        if self.oracle is not None:
            assert self.oracle.execute_dense(op, ts, events) == dense_j
        self.check()
        return dense_t

    def check(self):
        assert_state_equal(self.jax.state, self.port.state)
        np.testing.assert_array_equal(self.port._acct_used, self.jax._acct_used)
        np.testing.assert_array_equal(self.port._xfer_used, self.jax._xfer_used)
        assert self.port.hazards.amount_sum == self.jax.hazards.amount_sum
        assert self.port.hazards.limit_account_ids == self.jax.hazards.limit_account_ids
        if self.oracle is not None:
            accounts, transfers, posted = self.port.extract()
            assert fields(accounts) == fields(self.oracle.accounts)
            assert fields(transfers) == fields(self.oracle.transfers)
            assert posted == self.oracle.posted
            assert self.port.commit_timestamp == self.oracle.commit_timestamp


def run_workload(pair, seed, n_batches, batch_size, ts=1_000_000_000, **wl_kwargs):
    gen = WorkloadGenerator(seed, **wl_kwargs)
    for b in range(n_batches):
        op, events = (gen.gen_accounts_batch(batch_size) if b % 4 == 0
                      else gen.gen_transfers_batch(batch_size))
        ts += len(events)
        pair.run(op, ts, events)
    return gen, ts


CLEAN = dict(chain_rate=0.0, two_phase_rate=0.0, balancing_rate=0.0,
             limit_account_rate=0.0, conflict_rate=0.0)


# ----------------------------------------------------------------------
# the owner hash
# ----------------------------------------------------------------------


@pytest.mark.parametrize("n_shards", [2, 7, 8])
def test_owner_hash(n_shards):
    """Device and host owner hashes of both packages agree on every key,
    high bits included (the u64 modulo of the port is unsigned)."""
    rng = np.random.default_rng(3)
    lo = rng.integers(0, 1 << 64, size=512, dtype=np.uint64)
    hi = rng.integers(0, 1 << 64, size=512, dtype=np.uint64)
    hi[:64] = 0
    lo[64:72] = np.uint64(0xFFFFFFFFFFFFFFFF)
    k4 = np.stack([lo & 0xFFFFFFFF, lo >> 32, hi & 0xFFFFFFFF, hi >> 32], axis=1).astype(np.uint32)
    want = np.asarray(jmesh.owner_of_key4(jnp.asarray(k4), n_shards))
    np.testing.assert_array_equal(jmesh.owner_of_ids_np(lo, hi, n_shards), want)
    got = tmesh.owner_of_key4(torch.from_numpy(k4.view(np.int32)), n_shards).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tmesh.owner_of_ids_np(lo, hi, n_shards), want)
    assert set(want.tolist()) == set(range(n_shards))


# ----------------------------------------------------------------------
# the host's tier choice
# ----------------------------------------------------------------------

HAZARDS = {
    "clean": ({}, False),
    "pending": ({"flags": int(TransferFlags.pending)}, False),
    "linked": ({"flags": int(TransferFlags.linked)}, True),
    "post": ({"flags": int(TransferFlags.post_pending_transfer)}, True),
    "void": ({"flags": int(TransferFlags.void_pending_transfer)}, True),
    "balancing_debit": ({"flags": int(TransferFlags.balancing_debit)}, True),
    "balancing_credit": ({"flags": int(TransferFlags.balancing_credit)}, True),
    "duplicate_ids": ({"id": 200}, True),  # the batch's first id
    "limit_account": ({"debit_account_id": 7}, True),
    "amount_bound": ({"amount": 1 << 126}, True),
}


@pytest.mark.parametrize("case", list(HAZARDS))
def test_transfers_hazard(case):
    """HazardTracker.transfers_hazard (with _SLOW_FLAGS and the running
    amount bound) decides as the JAX tracker's on the same batches."""
    change, want = HAZARDS[case]
    limit = accounts_to_np([Account(id=7, ledger=1, code=1, flags=2)])
    trackers = (jledger.HazardTracker(), tledger.HazardTracker())
    for hz in trackers:
        hz.note_limit_accounts(limit)

    def batch(first, changed):
        events = [Transfer(id=first + i, debit_account_id=1, credit_account_id=2, amount=5,
                           ledger=1, code=1) for i in range(8)]
        for k, v in (changed.items() if changed else ()):
            setattr(events[3], k, v)
            if k == "amount":
                events[5].amount = v
        return transfers_to_np(events)

    for first, changed, expect in ((100, None, False), (200, change, want), (300, None, None)):
        arr = batch(first, changed)
        got = [hz.transfers_hazard(arr) for hz in trackers]
        assert got[0] == got[1], case
        assert expect is None or got[0] == expect, case
        assert trackers[0].amount_sum == trackers[1].amount_sum
    # the amount bound, once crossed, keeps every later batch serial
    assert got[0] == (case == "amount_bound")


# ----------------------------------------------------------------------
# workloads on the fast tiers, lookups
# ----------------------------------------------------------------------


def test_clean_workload_fast_tiers(mesh):
    """A hazard-free workload stays on the fast tiers (both packages pick
    them: the amount bound and the state agree batch by batch)."""
    pair = Pair(mesh, oracle=True)
    run_workload(pair, 13, n_batches=8, batch_size=32, invalid_rate=0.3, **CLEAN)


def test_lookups(mesh):
    """The sharded lookup per lane (found, row, resolved) and through the
    ledgers, present, missing and zero ids."""
    pair = Pair(mesh, oracle=True)
    gen, _ = run_workload(pair, 14, n_batches=6, batch_size=24)
    ids_a = gen.account_ids[:30] + [123_456, 0]
    ids_t = gen.transfer_ids[:30] + [6789]
    for ids, jk, table, log2 in ((ids_a, pair.jax.kernels.lookup_accounts, "acct_rows", 10),
                                 (ids_t, pair.jax.kernels.lookup_transfers, "xfer_rows", 12)):
        jf, jr, jres = (np.asarray(x)[:len(ids)]
                        for x in jk(pair.jax.state, jledger.ids_to_batch(ids, 32)))
        key4 = tledger.ids_to_batch(ids, "cpu")["key4"]
        tf, tr, tres = tmesh.lookup_plain(pair.port.state[table], key4, log2)
        np.testing.assert_array_equal(tf.numpy(), jf)
        np.testing.assert_array_equal(tr.numpy().view(np.uint32), jr)
        np.testing.assert_array_equal(tres.numpy(), jres)
    assert fields(pair.port.lookup_accounts(ids_a)) == fields(pair.jax.lookup_accounts(ids_a)) \
        == fields(pair.oracle.lookup_accounts(ids_a))
    assert fields(pair.port.lookup_transfers(ids_t)) \
        == fields(pair.jax.lookup_transfers(ids_t)) \
        == fields(pair.oracle.lookup_transfers(ids_t))


# ----------------------------------------------------------------------
# the fast tiers' fault gates, from one carried state
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def base(mesh):
    """A state after a hazard workload (tombstones included), as numpy, with
    the next timestamp and the generator's ids."""
    pair = Pair(mesh)
    gen, ts = run_workload(pair, 21, n_batches=8, batch_size=32)
    return {k: np.asarray(v) for k, v in pair.jax.state.items()}, ts, gen


def kernel_pair(mesh, state_np, name, rows_np, n, ts):
    """One JAX kernel (`ShardedLedgerKernels.<name>`) and the port's plain
    version from the same state: codes and every leaf must be equal.
    Returns (codes, the port's state)."""
    jl = jax_ledger(mesh)
    jstate = {k: jax.device_put(v, jl.state[k].sharding) for k, v in state_np.items()}
    jstate, jr = getattr(jl.kernels, name)(jstate, {"rows": jnp.asarray(rows_np)},
                                           jnp.int32(n), jnp.uint64(ts))
    pst = convert.state_from_numpy(state_np, "cpu")
    kern = tmesh.ShardedLedgerKernels(S, PROCESS)
    pr = getattr(kern, name)(pst, {"rows": torch.from_numpy(rows_np.view(np.int32))}, n, ts)
    np.testing.assert_array_equal(pr.numpy().view(np.uint32), np.asarray(jr))
    assert_state_equal(jstate, pst)
    return np.asarray(jr), pst


def fresh_transfers(gen, n, first_id, rng):
    """n fresh transfers between random accounts of the workload."""
    ids = gen.account_ids
    out = []
    for i in range(n):
        dr, cr = rng.choice(len(ids), 2, replace=False)
        out.append(Transfer(id=first_id + i, debit_account_id=ids[dr], credit_account_id=ids[cr],
                            amount=int(rng.integers(1, 1000)), ledger=1, code=1))
    return out


def rows_of(events, n_pad, accounts=False):
    arr = accounts_to_np(events) if accounts else transfers_to_np(events)
    return jledger._to_rows_np(arr, n_pad)


def owned_by(id_, n_shards=S):
    return int(tmesh.owner_of_ids_np(np.array([id_], dtype=np.uint64),
                                     np.array([0], dtype=np.uint64), n_shards)[0])


def test_fast_fault_gates(mesh, base):
    """The fast tiers decide PROBE, CLAIM, OVERFLOW and CAPACITY over all
    shards before any write; the capacity gate charges each shard only the
    inserts it owns; a sticky fault no-ops the batch."""
    state_np, ts, gen = base
    rng = np.random.default_rng(5)
    events = fresh_transfers(gen, 32, 900_000, rng)
    rows = rows_of(events, 32)
    codes, _ = kernel_pair(mesh, state_np, "commit_transfers_fast", rows, 32, ts + 32)
    assert (codes == 0).sum() > 0

    # capacity: the shard with the most inserts one slot short of room,
    # then exactly full after the batch
    owners = np.array([owned_by(t.id) for t in events])
    inserts = np.bincount(owners[codes[:32] == 0], minlength=S)
    limit = (1 << 12) // 2
    s_in = int(np.argmax(inserts))
    full = {k: v.copy() for k, v in state_np.items()}
    full["xfer_used_slots"][s_in] = limit - inserts[s_in] + 1
    _, pst = kernel_pair(mesh, full, "commit_transfers_fast", rows, 32, ts + 32)
    assert int(pst["fault"]) == tledger.FAULT_CAPACITY
    full["xfer_used_slots"][s_in] -= 1  # exactly full after the batch
    _, pst = kernel_pair(mesh, full, "commit_transfers_fast", rows, 32, ts + 32)
    assert int(pst["fault"]) == 0

    # accounts: capacity over owned inserts, and a sticky fault
    accts = [Account(id=700_000 + i, ledger=1, code=1) for i in range(32)]
    arows = rows_of(accts, 32, accounts=True)
    a_own = np.bincount([owned_by(a.id) for a in accts], minlength=S)
    full = {k: v.copy() for k, v in state_np.items()}
    full["acct_used_slots"][0] = (1 << 10) // 2 - a_own[0] + 1
    _, pst = kernel_pair(mesh, full, "commit_accounts_fast", arows, 32, ts + 32)
    assert int(pst["fault"]) == tledger.FAULT_CAPACITY
    faulted = {k: v.copy() for k, v in state_np.items()}
    faulted["fault"] = np.uint32(tledger.FAULT_PROBE)
    _, pst = kernel_pair(mesh, faulted, "commit_accounts_fast", arows, 32, ts + 32)
    assert int(pst["fault"]) == tledger.FAULT_PROBE

    # probe exhaustion on one shard: its empty transfer rows filled with
    # random words, so lookups of keys it owns do not resolve
    ex = {k: v.copy() for k, v in state_np.items()}
    x = ex["xfer_rows"][s_in]
    empty = np.nonzero((x[:-1, :4] == 0).all(1))[0]
    x[empty] = rng.integers(1, 1 << 32, (len(empty), 32), dtype=np.uint64).astype(np.uint32)
    _, pst = kernel_pair(mesh, ex, "commit_transfers_fast", rows, 32, ts + 32)
    assert int(pst["fault"]) & tledger.FAULT_PROBE

    # the overflow backstop: 2^127 pending + 2^127 posted on two fresh
    # accounts, each event valid alone
    pair_ids = [950_001, 950_002]
    _, pst = kernel_pair(mesh, state_np, "commit_accounts_fast",
                         rows_of([Account(id=i, ledger=1, code=1) for i in pair_ids], 8, True),
                         2, ts + 2)
    big = [Transfer(id=910_000 + k, debit_account_id=pair_ids[0],
                    credit_account_id=pair_ids[1], amount=1 << 127, ledger=1, code=1,
                    flags=f) for k, f in enumerate((int(TransferFlags.pending), 0))]
    codes, pst = kernel_pair(mesh, convert.state_to_numpy(pst), "commit_transfers_fast",
                             rows_of(big, 8), 2, ts + 4)
    assert int(pst["fault"]) == tledger.FAULT_OVERFLOW and (codes == 0).all()


def test_fast_claim_contention(mesh):
    """Lanes of one shard whose first free probe positions collide: the
    lowest lane wins each (shard, slot), as in the JAX claim rounds."""
    pair = Pair(mesh)
    ts = 10_000
    pair.run(Operation.create_accounts, ts, [Account(id=i, ledger=1, code=1) for i in (1, 2)])
    from tigerbeetle_tpu_torch.ops import hashtable as ht

    # ids owned by shard 0 whose base slots coincide in a 2^12 table
    by_slot = {}
    i = 10_000
    while True:
        i += 1
        if owned_by(i) != 0:
            continue
        k4 = torch.tensor([[i & 0xFFFFFFFF, i >> 32, 0, 0]], dtype=torch.int32)
        by_slot.setdefault(int(ht.hash_key4(k4, 12)), []).append(i)
        group = next((g for g in by_slot.values() if len(g) == 3), None)
        if group:
            break
    xfers = [Transfer(id=t, debit_account_id=1, credit_account_id=2, amount=1, ledger=1, code=1)
             for t in group]
    ts += 3
    assert pair.run(Operation.create_transfers, ts, xfers) == [0, 0, 0]


def test_load_guard(mesh):
    """The per-shard occupancy guard raises before dispatch, on both."""
    j_small = JConfigProcess(account_slots_log2=4, transfer_slots_log2=6)
    jl = jmesh.ShardedLedger(Mesh(np.array(jax.devices()[:2]), ("shard",)), j_small)
    tl = tmesh.ShardedLedger(2, ConfigProcess(account_slots_log2=4, transfer_slots_log2=6),
                             device="cpu")
    accounts = [Account(id=i, ledger=1, code=1) for i in range(1, 40)]
    for led in (jl, tl):
        with pytest.raises(RuntimeError, match="load-factor"):
            led.execute_dense(Operation.create_accounts, 100, accounts)
    np.testing.assert_array_equal(tl._acct_used, jl._acct_used)
    assert int(tl.state["acct_count"]) == 0


def test_combined_overflow(mesh):
    """Codes 51/52 are exact: the amount bound routes the batch to the
    serial tier on both."""
    pair = Pair(mesh, oracle=True)
    ts = 10_000
    pair.run(Operation.create_accounts, ts, [Account(id=i, ledger=1, code=1) for i in (1, 2)])
    big = 1 << 127
    transfers = [
        Transfer(id=40, debit_account_id=1, credit_account_id=2, amount=big,
                 ledger=1, code=1, flags=int(TransferFlags.pending)),
        Transfer(id=41, debit_account_id=1, credit_account_id=2, amount=big, ledger=1, code=1),
    ]
    assert pair.run(Operation.create_transfers, ts + 2, transfers) == [0, 51]


# ----------------------------------------------------------------------
# checkpoints and carrying a ledger across
# ----------------------------------------------------------------------


def _blob_leaves(raw: bytes):
    """(head dict, {leaf: bytes}) of a snapshot blob."""
    import json

    hn = int.from_bytes(raw[:4], "little")
    head = json.loads(raw[4:4 + hn])
    off, out = 4 + hn, {}
    for name, size in zip(tmesh.SNAP_SHARDED + tmesh.SNAP_REPLICATED, head["sizes"]):
        out[name] = raw[off:off + size]
        off += size
    assert off == len(raw)
    return head, out


def assert_blobs_equal(a: bytes, b: bytes) -> None:
    """Equal heads and leaves, each shard's dump row masked (DUMP_LEAVES)."""
    ha, la = _blob_leaves(a)
    hb, lb = _blob_leaves(b)
    assert ha == hb
    for k in la:
        x, y = np.frombuffer(la[k], np.uint32), np.frombuffer(lb[k], np.uint32)
        if k in DUMP_LEAVES:
            x, y = x.reshape(S, -1), y.reshape(S, -1)
            width = 32 if k in ("acct_rows", "xfer_rows", "bal_acc") else 1
            x, y = x[:, :-width], y[:, :-width]
        np.testing.assert_array_equal(x, y, err_msg=k)


def test_snapshot_bytes_both_ways(mesh):
    """A port blob restores in the JAX package and a JAX blob in the port;
    the blobs are equal but for the dump rows, and every ledger answers one
    more batch alike."""
    pair = Pair(mesh)
    gen, ts = run_workload(pair, 17, n_batches=6, batch_size=32)
    jblob, tblob = pair.jax.snapshot_bytes(), pair.port.snapshot_bytes()
    assert_blobs_equal(jblob, tblob)
    j2 = jax_ledger(mesh)
    j2.restore_bytes(tblob)
    t2 = tmesh.ShardedLedger(S, PROCESS, device="cpu")
    t2.restore_bytes(jblob)
    assert_blobs_equal(j2.snapshot_bytes(), t2.snapshot_bytes())
    op, events = gen.gen_transfers_batch(32)
    ts += len(events)
    want = pair.run(op, ts, events)
    assert j2.execute_dense(op, ts, events) == t2.execute_dense(op, ts, events) == want
    assert_state_equal(j2.state, t2.state)
    assert_state_equal(pair.jax.state, t2.state)
    with pytest.raises(RuntimeError, match="geometry"):
        tmesh.ShardedLedger(S, ConfigProcess(account_slots_log2=10, transfer_slots_log2=13),
                            device="cpu").restore_bytes(jblob)


def test_carry_sharded(mesh):
    """convert.carry_sharded takes a JAX ShardedLedger's state and host
    counters across; both go on alike, hazards included."""
    pair = Pair(mesh)
    gen, ts = run_workload(pair, 18, n_batches=5, batch_size=32)
    port = tmesh.ShardedLedger(S, PROCESS, device="cpu")
    convert.carry_sharded(port, pair.jax, {k: np.asarray(v) for k, v in pair.jax.state.items()})
    assert port.prepare_timestamp == pair.jax.prepare_timestamp
    pair.port = port
    pair.check()
    for _ in range(3):
        op, events = gen.gen_transfers_batch(32)
        ts += len(events)
        pair.run(op, ts, events)


def test_wire_state_machine(mesh):
    """StateMachine runs unchanged over the port's ShardedLedger."""
    from tigerbeetle_tpu import types as jtypes
    from tigerbeetle_tpu.state_machine import StateMachine as JStateMachine
    from tigerbeetle_tpu.state_machine import encode_ids
    from tigerbeetle_tpu_torch.state_machine import StateMachine

    sm_o = JStateMachine(OracleStateMachine())
    sm_d = StateMachine(tmesh.ShardedLedger(S, PROCESS, device="cpu"))
    body = jtypes.accounts_to_np([Account(id=i, ledger=1, code=1) for i in (1, 2)]).tobytes()
    for sm in (sm_o, sm_d):
        sm.prepare(Operation.create_accounts, body)
    ts = sm_d.prepare_timestamp
    assert ts == sm_o.prepare_timestamp == 2
    assert sm_o.commit(Operation.create_accounts, ts, body) == \
        sm_d.commit(Operation.create_accounts, ts, body) == b""
    body = jtypes.transfers_to_np([Transfer(id=10, debit_account_id=1, credit_account_id=2,
                                            amount=7, ledger=1, code=1),
                                   Transfer(id=11, debit_account_id=1, credit_account_id=3,
                                            amount=7, ledger=1, code=1)]).tobytes()
    for sm in (sm_o, sm_d):
        sm.prepare(Operation.create_transfers, body)
    ts = sm_d.prepare_timestamp
    reply = sm_d.commit(Operation.create_transfers, ts, body)
    assert reply == sm_o.commit(Operation.create_transfers, ts, body) != b""
    for op, ids in ((Operation.lookup_accounts, [1, 2, 3]), (Operation.lookup_transfers, [10, 11])):
        look = encode_ids(ids)
        assert sm_o.commit(op, ts, look) == sm_d.commit(op, ts, look)
