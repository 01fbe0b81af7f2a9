"""The spill store's host side in the PyTorch port.

Carrying a spilling JAX ledger into the port at a checkpoint
(convert.carry_ledger): the device state, the host's counters and planner
state, and the spill store (the grid's storage bytes and the spill
manager's checkpoint meta, restored through the port's own
SpillManager.restore). Both ledgers then run the same batches and must stay
equal: codes, tables, spilled ids, extract(), and the storage bytes after
the next checkpoint. The threaded IO worker, which must touch no torch
tensor and make no CUDA call. And the prefetch pipeline on the threaded
worker (prefetch_async, overlap_report, io_pump, io_pending) against the
JAX SpillManager's. The port runs its plain versions on the CPU.
"""

import numpy as np

from tests.test_torch_spill import (
    GRID,
    GRID_SIZE,
    KNOBS,
    SpillPair,
    assert_leaves_equal,
    records,
)
from tigerbeetle_tpu.constants import TEST_CLUSTER as J_TEST_CLUSTER
from tigerbeetle_tpu.constants import TEST_PROCESS as J_TEST_PROCESS
from tigerbeetle_tpu.io.storage import MemoryStorage as JMemoryStorage
from tigerbeetle_tpu.io.storage import ZoneLayout as JZoneLayout
from tigerbeetle_tpu.lsm.grid import Grid as JGrid
from tigerbeetle_tpu.lsm.groove import Forest as JForest
from tigerbeetle_tpu.models import ledger as jledger
from tigerbeetle_tpu.testing.workload import WorkloadGenerator
from tigerbeetle_tpu.types import transfers_to_np
from tigerbeetle_tpu_torch import convert
from tigerbeetle_tpu_torch.constants import TEST_CLUSTER, TEST_PROCESS
from tigerbeetle_tpu_torch.io.storage import MemoryStorage, ZoneLayout
from tigerbeetle_tpu_torch.lsm.grid import Grid
from tigerbeetle_tpu_torch.lsm.groove import Forest
from tigerbeetle_tpu_torch.models import ledger as tledger
from tigerbeetle_tpu_torch.types import Operation


def test_carry_spilling_ledger_into_the_port():
    pair = SpillPair()
    jd, td = pair.jax, pair.port
    gen = WorkloadGenerator(33, **KNOBS)
    ts = 1_000_000_000
    for b in range(56):  # the JAX ledger alone, until it has spilled
        op, events = gen.gen_accounts_batch(40) if b < 4 else gen.gen_transfers_batch(72)
        ts += len(events)
        jd.execute_dense(op, ts, events)
    assert jd.spill.stats["cycles"] >= 1 and jd.spill.spilled
    meta = jd.spill.checkpoint_meta()
    convert.carry_ledger(td, jd, {k: np.asarray(v) for k, v in jd.state.items()},
                         bytes(pair.j_storage.data), meta)
    assert td.spill.spilled == jd.spill.spilled
    pair.check_tables(prefilter=False)
    pair.check_extract()

    j_cycles = jd.spill.stats["cycles"]
    for b in range(10):
        op, events = gen.gen_transfers_batch(72)
        ts += len(events)
        assert td.execute_dense(op, ts, events) == jd.execute_dense(op, ts, events), b
        assert td._xfer_used == jd._xfer_used
        assert td.spill.stats["cycles"] == jd.spill.stats["cycles"] - j_cycles
        pair.check_tables(prefilter=False)
    assert td.spill.stats["reloaded"] > 0  # the carried store served reloads
    assert td.hazards.plan_stats == jd.hazards.plan_stats
    pair.check_tables(prefilter=False)
    ja, jt, _ = jd.extract()
    ta, tt, _ = td.extract()
    assert records(ta) == records(ja) and records(tt) == records(jt)
    assert td.spill.checkpoint_meta() == jd.spill.checkpoint_meta()
    assert pair.t_storage.data == pair.j_storage.data


def test_spill_io_worker_makes_no_torch_call():
    """The threaded IO worker gets host copies and touches neither the card
    nor any torch tensor: a profiler on the worker thread sees no torch
    code and no torch builtin, while the worker inserts and settles."""
    import threading

    seen = []

    def profile(frame, event, arg):
        if threading.current_thread().name.startswith("spill-io"):
            where = frame.f_code.co_filename
            module = (getattr(arg, "__module__", None) or "") if event == "c_call" else ""
            if "/torch/" in where or module.startswith("torch"):
                seen.append((event, where, module))

    storage = MemoryStorage(ZoneLayout(TEST_CLUSTER, grid_size=GRID_SIZE))
    led = tledger.DeviceLedger(TEST_PROCESS, device="cpu",
                               forest=Forest(Grid(storage, **GRID)), spill_io="threaded")
    gen = WorkloadGenerator(7, ledgers=(1,), invalid_rate=0.0, conflict_rate=0.05,
                            chain_rate=0.0, two_phase_rate=0.2, balancing_rate=0.0,
                            limit_account_rate=0.0)
    threading.setprofile(profile)
    try:
        ts = 10**9
        for b in range(22):
            op, events = gen.gen_accounts_batch(40) if b < 2 else gen.gen_transfers_batch(200)
            ts += len(events)
            led.execute_dense(op, ts, events)
        led.spill.io_drain()
    finally:
        threading.setprofile(None)
        led.spill._io._ex.shutdown()
    assert led.spill.stats["cycles"] >= 1 and led.spill.stats["t_lsm_worker"] > 0
    assert not seen, seen[:5]


def test_prefetch_pipeline_matches_jax():
    """The overlapped spill pipeline of tests/test_spill.py
    (test_spill_overlap_pipeline_smoke) through the JAX ledger and the
    port's, both on the threaded IO worker: a window of three batches in
    flight, batch g+1's referenced spilled rows prefetched on the worker
    while batch g commits, drains lagging dispatch, the replica's
    tick-boundary io_pump. Equal codes batch by batch, equal counters of
    the cycle, the prefetches and the batched LSM reads, equal tables,
    spilled ids and extract(), and equal overlap_report()s but for the
    timing share."""
    j_storage = JMemoryStorage(JZoneLayout(J_TEST_CLUSTER, grid_size=GRID_SIZE))
    t_storage = MemoryStorage(ZoneLayout(TEST_CLUSTER, grid_size=GRID_SIZE))
    jd = jledger.DeviceLedger(process=J_TEST_PROCESS, mode="auto",
                              forest=JForest(JGrid(j_storage, **GRID)))
    td = tledger.DeviceLedger(TEST_PROCESS, device="cpu", forest=Forest(Grid(t_storage, **GRID)))
    gen = WorkloadGenerator(21, ledgers=(1,), invalid_rate=0.0, conflict_rate=0.1,
                            chain_rate=0.0, two_phase_rate=0.2, balancing_rate=0.0,
                            limit_account_rate=0.0)
    ts = 1_000_000_000
    try:
        for _ in range(2):
            op, events = gen.gen_accounts_batch(40)
            ts += len(events)
            assert td.execute_dense(op, ts, events) == jd.execute_dense(op, ts, events)
        batches = [transfers_to_np(gen.gen_transfers_batch(96)[1]) for _ in range(60)]
        window = []
        for g, arr in enumerate(batches):
            ts += len(arr)
            window.append((g, jd.execute_async(Operation.create_transfers, ts, arr),
                           td.execute_async(Operation.create_transfers, ts, arr)))
            if g + 1 < len(batches):
                jd.spill.prefetch_async(batches[g + 1])
                td.spill.prefetch_async(batches[g + 1])
            while len(window) > 3 or (window and g + 1 == len(batches)):
                gi, pj, pt = window.pop(0)
                assert td.drain(pt) == jd.drain(pj), f"batch {gi}"
            if g % 8 == 7:
                jd.spill.io_pump()
                td.spill.io_pump()
        jd.spill.io_drain()
        td.spill.io_drain()
        assert td.spill.io_pending() == jd.spill.io_pending() == 0
        s, sj = dict(td.spill.stats), dict(jd.spill.stats)
        assert s["cycles"] >= 2 and s["reloaded"] >= 1
        assert s["prefetches"] >= 1 and s["prefetched"] >= 1
        for key in ("cycles", "spilled", "reloaded", "prefetches", "prefetched",
                    "lookup_batches", "lookup_ids"):
            assert s[key] == sj[key], key
        rep, rep_j = td.spill.overlap_report(), jd.spill.overlap_report()
        assert rep.keys() == rep_j.keys()
        assert rep["spill_lookup_batch"] == rep_j["spill_lookup_batch"] >= 1
        assert 0.0 <= rep["spill_overlap"] <= 1.0
        assert_leaves_equal({k: np.asarray(v) for k, v in jd.state.items()}, td.state)
        assert td.spill.spilled == jd.spill.spilled
        ja, jt, jp = jd.extract()
        ta, tt, tp = td.extract()
        assert records(ta) == records(ja) and records(tt) == records(jt)
        assert list(tp.items()) == list(jp.items())
    finally:
        jd.spill._io._ex.shutdown()
        td.spill._io._ex.shutdown()
