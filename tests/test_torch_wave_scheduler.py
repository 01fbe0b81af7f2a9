"""The port's conflict-wave scheduler (HazardTracker.plan + _execute_waves),
the mirror of `tests/test_wave_scheduler.py` on the port's DeviceLedger on
the CPU (its waves through `commit_transfers_waves_plain`, K12's CPU route):
deterministic wave layout, bit-exact parity against the port's scalar oracle
on adversarial hot-account workloads, the decision plumbing, and the
`waves.*` metrics under the names of the port's `metrics.CATALOG`.

The determinism contract under test: the wave layout is a PURE FUNCTION
of the batch bytes plus the tracker's committed-history state — no
seeds, no wall clock, no unordered iteration — so every replica and the
simulator plan (and execute) a batch identically. The parity contract:
whatever the layout, the committed result codes and the full state are
bit-exact against the oracle's strictly-serial semantics.
"""

import numpy as np
import pytest

from tigerbeetle_tpu_torch.constants import TEST_PROCESS
from tigerbeetle_tpu_torch.metrics import Metrics
from tigerbeetle_tpu_torch.models.ledger import (
    WAVE_CAP,
    DeviceLedger,
    HazardTracker,
)
from tigerbeetle_tpu_torch.models.oracle import OracleStateMachine
from tigerbeetle_tpu_torch.types import (
    Account,
    AccountFlags,
    Operation,
    Transfer,
    TransferFlags,
    transfers_to_np,
)

F_PENDING = int(TransferFlags.pending)
F_POST = int(TransferFlags.post_pending_transfer)
F_VOID = int(TransferFlags.void_pending_transfer)
F_LINKED = int(TransferFlags.linked)


def _pair(n_accounts=24, limit_accounts=(), funded=200):
    """(oracle, device, ts): n accounts; `limit_accounts` get
    debits_must_not_exceed_credits and `funded` of credit headroom."""
    oracle = OracleStateMachine()
    dev = DeviceLedger(process=TEST_PROCESS, mode="auto", device="cpu")
    ts = 10_000
    accounts = [
        Account(
            id=i, ledger=1, code=1,
            flags=int(AccountFlags.debits_must_not_exceed_credits)
            if i in limit_accounts else 0,
        )
        for i in range(1, n_accounts + 1)
    ]
    ts += len(accounts)
    assert oracle.execute_dense(Operation.create_accounts, ts, accounts) == \
        dev.execute_dense(Operation.create_accounts, ts, accounts)
    if limit_accounts:
        fund = [
            Transfer(id=900_000 + a, debit_account_id=n_accounts,
                     credit_account_id=a, amount=funded, ledger=1, code=1)
            for a in limit_accounts
        ]
        ts += len(fund)
        assert oracle.execute_dense(Operation.create_transfers, ts, fund) == \
            dev.execute_dense(Operation.create_transfers, ts, fund)
    return oracle, dev, ts


def _check(oracle, dev, ts, transfers):
    ts += len(transfers)
    dense_o = oracle.execute_dense(Operation.create_transfers, ts, transfers)
    dense_d = dev.execute_dense(Operation.create_transfers, ts, transfers)
    assert dense_d == dense_o, [
        (i, d, o) for i, (d, o) in enumerate(zip(dense_d, dense_o)) if d != o
    ][:6]
    oracle.assert_parity(dev)
    return ts


# ----------------------------------------------------------------------
# determinism of the layout itself
# ----------------------------------------------------------------------


def _adversarial_batch():
    tr = []
    for i in range(10):  # same-batch pend->post pairs on a hot account
        tr.append(Transfer(id=1000 + i, debit_account_id=1,
                           credit_account_id=2 + i % 5, amount=10, ledger=1,
                           code=1, flags=F_PENDING))
    for i in range(10):
        tr.append(Transfer(id=2000 + i, pending_id=1000 + i, amount=5,
                           flags=F_POST))
    for _ in range(3):  # duplicate-id chain
        tr.append(Transfer(id=3000, debit_account_id=3, credit_account_id=4,
                           amount=1, ledger=1, code=1))
    for i in range(12):  # limit-account touches (order-sensitive)
        tr.append(Transfer(id=4000 + i, debit_account_id=7,
                           credit_account_id=8 + i % 4, amount=3, ledger=1,
                           code=1))
    return transfers_to_np(tr)


def _tracker(reverse_registry=False):
    t = HazardTracker()
    t.limit_account_ids = {7}
    t._limit_lo = np.array([7], dtype=np.uint64)
    pend = [(500 + i, (11 + i, 12 + i)) for i in range(6)]
    for pid, acc in (reversed(pend) if reverse_registry else pend):
        t.pending_accounts[pid] = acc
    return t


def test_wave_layout_is_a_pure_function_of_batch_and_state():
    """Same batch bytes + same tracker state => byte-identical layout,
    including with the pending registry built in a different insertion
    order (layout must not depend on dict ordering)."""
    arr = _adversarial_batch()
    d1, p1 = _tracker().plan(arr.copy())
    d2, p2 = _tracker().plan(arr.copy())
    d3, p3 = _tracker(reverse_registry=True).plan(arr.copy())
    assert d1 == d2 == d3 == "waves"
    assert p1.wave_of.tobytes() == p2.wave_of.tobytes() == p3.wave_of.tobytes()
    assert p1.n_waves == p2.n_waves == p3.n_waves
    assert p1.has_pv == p2.has_pv == p3.has_pv
    # the layout is genuinely multi-wave: posts after creators, dup ids
    # and limit touches chained
    assert p1.n_waves >= 3


def test_wave_layout_identical_across_replica_instances():
    """Two independent device ledgers fed the same committed op stream
    plan every batch identically AND produce byte-identical state — the
    cross-replica half of the determinism contract."""
    devs = [DeviceLedger(process=TEST_PROCESS, mode="auto", device="cpu") for _ in range(2)]
    ts = 10_000
    accounts = [Account(id=i, ledger=1, code=1) for i in range(1, 25)]
    ts += len(accounts)
    for d in devs:
        d.execute_dense(Operation.create_accounts, ts, accounts)
    rng = np.random.default_rng(9)
    for batch in range(4):
        tr = []
        base = 10_000 * (batch + 1)
        for i in range(8):
            tr.append(Transfer(id=base + i, debit_account_id=1,
                               credit_account_id=2 + i % 6, amount=4,
                               ledger=1, code=1, flags=F_PENDING))
        for i in range(8):
            tr.append(Transfer(id=base + 100 + i, pending_id=base + i,
                               flags=F_POST if i % 2 else F_VOID))
        for i in range(16):
            a = int(rng.integers(2, 24))
            tr.append(Transfer(id=base + 200 + i, debit_account_id=1,
                               credit_account_id=a, amount=1, ledger=1,
                               code=1))
        arr = transfers_to_np(tr)
        plans = []
        for d in devs:
            probe = HazardTracker()
            probe.pending_accounts = dict(d.hazards.pending_accounts)
            probe.limit_account_ids = set(d.hazards.limit_account_ids)
            probe._limit_lo = d.hazards._limit_lo.copy()
            plans.append(probe.plan(arr.copy()))
        (d1, p1), (d2, p2) = plans
        assert d1 == d2
        if p1 is not None:
            assert p1.wave_of.tobytes() == p2.wave_of.tobytes()
        ts += len(tr)
        dense = [d.execute_dense(Operation.create_transfers, ts, arr.copy())
                 for d in devs]
        assert dense[0] == dense[1]
    f1, f2 = devs[0].fingerprint(), devs[1].fingerprint()
    assert f1 == f2


# ----------------------------------------------------------------------
# parity on adversarial hot-account workloads
# ----------------------------------------------------------------------


def test_one_account_in_every_event_stays_single_wave():
    """1 hot PLAIN account in 100% of events: balance adds commute and
    non-limit validation never reads a balance, so the planner must keep
    the whole batch on ONE wave (no edges), bit-exact."""
    oracle, dev, ts = _pair()
    tr = [
        Transfer(id=5000 + i, debit_account_id=1,
                 credit_account_id=2 + i % 20, amount=1 + i % 3, ledger=1,
                 code=1)
        for i in range(64)
    ]
    probe = HazardTracker()
    decision, plan = probe.plan(transfers_to_np(tr))
    assert decision == "fast" and plan is None
    _check(oracle, dev, ts, tr)


def test_hot_limit_account_exhaustion_order():
    """A hot LIMIT account whose credit headroom runs out mid-batch: each
    touch is one wave deep (validation must see every prior touch), and
    the exact lane where exceeds_credits starts firing must match the
    strictly-serial oracle."""
    oracle, dev, ts = _pair(limit_accounts=(5,), funded=50)
    tr = []
    for i in range(12):  # 12 x 6 = 72 > 50: later lanes must fail
        tr.append(Transfer(id=6000 + i, debit_account_id=5,
                           credit_account_id=6 + i % 8, amount=6, ledger=1,
                           code=1))
        tr.append(Transfer(id=6100 + i, debit_account_id=2 + i % 3,
                           credit_account_id=10 + i % 8, amount=1, ledger=1,
                           code=1))
    probe = HazardTracker()
    probe.limit_account_ids = set(oracle.accounts) and {5}
    probe._limit_lo = np.array([5], dtype=np.uint64)
    decision, plan = probe.plan(transfers_to_np(tr))
    assert decision == "waves"
    assert plan.n_waves == 12  # one wave per limit touch
    ts = _check(oracle, dev, ts, tr)
    assert dev.hazards.plan_stats["waves"] >= 1


def test_hot_limit_chain_deeper_than_cap_falls_to_residue():
    """More touches of one limit account than WAVE_CAP: the tail falls to
    the serial residue (the escape hatch), results still bit-exact."""
    n = WAVE_CAP + 8
    oracle, dev, ts = _pair(n_accounts=48, limit_accounts=(5,),
                            funded=3 * n)
    tr = []
    for i in range(n):
        tr.append(Transfer(id=7000 + i, debit_account_id=5,
                           credit_account_id=6 + i % 8, amount=2, ledger=1,
                           code=1))
        tr.append(Transfer(id=7500 + i, debit_account_id=10 + i % 20,
                           credit_account_id=31 + i % 16, amount=1,
                           ledger=1, code=1))
    probe = HazardTracker()
    probe.limit_account_ids = {5}
    probe._limit_lo = np.array([5], dtype=np.uint64)
    decision, plan = probe.plan(transfers_to_np(tr))
    assert decision == "waves"
    assert plan.n_waves == WAVE_CAP
    assert plan.residue_n == 8  # the capped tail, in original order
    _check(oracle, dev, ts, tr)


def test_same_batch_pend_post_void_races():
    """post AND void of the same same-batch pending (first resolve wins),
    a post of a pending created LATER in the batch (not_found, creator
    still succeeds), and a void-then-post pair — all order semantics the
    waves must preserve exactly."""
    oracle, dev, ts = _pair()
    tr = [
        Transfer(id=8000, debit_account_id=1, credit_account_id=2,
                 amount=30, ledger=1, code=1, flags=F_PENDING),
        Transfer(id=8001, pending_id=8000, amount=30, flags=F_POST),
        Transfer(id=8002, pending_id=8000, flags=F_VOID),  # already posted
        # post BEFORE its creator: must fail not_found; creator succeeds
        Transfer(id=8003, pending_id=8010, amount=5, flags=F_POST),
        Transfer(id=8010, debit_account_id=3, credit_account_id=4,
                 amount=5, ledger=1, code=1, flags=F_PENDING),
        # void then post of another same-batch pending
        Transfer(id=8020, debit_account_id=5, credit_account_id=6,
                 amount=7, ledger=1, code=1, flags=F_PENDING),
        Transfer(id=8021, pending_id=8020, flags=F_VOID),
        Transfer(id=8022, pending_id=8020, amount=7, flags=F_POST),
    ] + [
        Transfer(id=8100 + i, debit_account_id=7 + i % 8,
                 credit_account_id=15 + i % 8, amount=1, ledger=1, code=1)
        for i in range(16)
    ]
    _check(oracle, dev, ts, tr)


def test_linked_chains_next_to_waves():
    """Linked chains (serial residue) coexisting with same-batch two-phase
    waves; a post referencing a CHAIN-created pending must be pulled into
    the residue with its creator (entanglement closure)."""
    oracle, dev, ts = _pair()
    tr = [
        # chain creating a pending, then failing -> rollback
        Transfer(id=9000, debit_account_id=1, credit_account_id=2,
                 amount=5, ledger=1, code=1,
                 flags=F_LINKED | F_PENDING),
        Transfer(id=9001, debit_account_id=1, credit_account_id=2,
                 amount=0, ledger=1, code=1),  # breaks the chain
        # post of the rolled-back pending: must see not_found
        Transfer(id=9002, pending_id=9000, amount=5, flags=F_POST),
        # a healthy chain
        Transfer(id=9010, debit_account_id=3, credit_account_id=4,
                 amount=2, ledger=1, code=1, flags=F_LINKED),
        Transfer(id=9011, debit_account_id=3, credit_account_id=4,
                 amount=2, ledger=1, code=1),
    ] + [
        t
        for i in range(8)
        for t in (
            Transfer(id=9100 + i, debit_account_id=5 + i % 6,
                     credit_account_id=11 + i % 6, amount=9, ledger=1,
                     code=1, flags=F_PENDING),
            Transfer(id=9200 + i, pending_id=9100 + i, amount=4,
                     flags=F_POST),
        )
    ]
    probe = HazardTracker()
    decision, plan = probe.plan(transfers_to_np(tr))
    assert decision == "waves"
    assert plan.wave_of[2] < 0  # the chain-pending post joined the residue
    assert plan.n_waves >= 2  # the healthy pairs still wave
    _check(oracle, dev, ts, tr)


def test_duplicate_id_first_occurrence_fails():
    """Duplicate-id group where occurrence 1 FAILS validation: occurrence
    2 must then succeed, occurrence 3 must see exists — the waves walk
    the group in lane order."""
    oracle, dev, ts = _pair()
    tr = [
        Transfer(id=9500, debit_account_id=1, credit_account_id=1,
                 amount=1, ledger=1, code=1),  # accounts equal: fails
        Transfer(id=9500, debit_account_id=1, credit_account_id=2,
                 amount=1, ledger=1, code=1),  # now succeeds
        Transfer(id=9500, debit_account_id=1, credit_account_id=2,
                 amount=2, ledger=1, code=1),  # exists_with_different...
        Transfer(id=9500, debit_account_id=1, credit_account_id=2,
                 amount=1, ledger=1, code=1),  # exists
    ] + [
        Transfer(id=9600 + i, debit_account_id=3 + i % 10,
                 credit_account_id=13 + i % 10, amount=1, ledger=1, code=1)
        for i in range(12)
    ]
    _check(oracle, dev, ts, tr)


@pytest.mark.parametrize("seed", [31, 32, 33])
def test_zipfian_hot_mix_randomized_parity(seed):
    """Randomized zipfian hot-account batches with same-batch two-phase
    pairs, duplicate ids, limit-account traffic and occasional chains —
    run through auto dispatch; every batch bit-exact and the wave path
    demonstrably engaged."""
    rng = np.random.default_rng(seed)
    oracle, dev, ts = _pair(n_accounts=40, limit_accounts=(3,),
                            funded=10_000)
    next_id = 20_000
    for _ in range(5):
        tr = []
        n_pairs = 6
        for i in range(n_pairs):
            tr.append(Transfer(
                id=next_id + i, debit_account_id=1,
                credit_account_id=int(rng.integers(4, 40)), amount=3,
                ledger=1, code=1, flags=F_PENDING,
            ))
        for i in range(n_pairs):
            tr.append(Transfer(
                id=next_id + 100 + i, pending_id=next_id + i,
                amount=0 if i % 2 else 3, flags=F_POST if i % 3 else F_VOID,
            ))
        for i in range(36):
            # zipf-ish: most traffic on accounts 1-3 (3 is limited)
            u = float(rng.random())
            a = 1 + int(39 * u**4)
            b = int(rng.integers(1, 41))
            if b == a:
                b = a % 40 + 1
            tr.append(Transfer(
                id=next_id + 200 + i, debit_account_id=a,
                credit_account_id=b, amount=1 + int(rng.integers(0, 3)),
                ledger=1, code=1,
            ))
        if rng.random() < 0.6:  # occasional duplicate id
            tr.append(Transfer(id=next_id + 200, debit_account_id=2,
                               credit_account_id=5, amount=1, ledger=1,
                               code=1))
        if rng.random() < 0.5:  # occasional chain
            tr.append(Transfer(id=next_id + 300, debit_account_id=6,
                               credit_account_id=7, amount=2, ledger=1,
                               code=1, flags=F_LINKED))
            tr.append(Transfer(id=next_id + 301, debit_account_id=6,
                               credit_account_id=7, amount=2, ledger=1,
                               code=1))
        ts = _check(oracle, dev, ts, tr)
        next_id += 1000
    assert dev.hazards.plan_stats["waves"] >= 3, dev.hazards.plan_stats


# ----------------------------------------------------------------------
# plumbing: decision on the handle, metrics catalog, stats compat
# ----------------------------------------------------------------------


def test_handle_plan_and_wave_metrics():
    """The wave decision rides the commit_async handle (replica surfaces
    it as commit.group.wave_*), the waves.* metrics are registered under
    CATALOG'd names, and split_stats stays a readable compat view."""
    from tigerbeetle_tpu_torch.state_machine import StateMachine

    dev = DeviceLedger(process=TEST_PROCESS, mode="auto", device="cpu")
    metrics = Metrics()
    dev.instrument(metrics, dev.tracer)
    sm = StateMachine(dev)
    ts = 10_000
    accounts = [Account(id=i, ledger=1, code=1) for i in range(1, 12)]
    ts += len(accounts)
    dev.execute_dense(Operation.create_accounts, ts, accounts)
    tr = [
        Transfer(id=100 + i, debit_account_id=1, credit_account_id=2 + i % 9,
                 amount=2, ledger=1, code=1, flags=F_PENDING)
        for i in range(8)
    ] + [
        Transfer(id=200 + i, pending_id=100 + i, flags=F_POST)
        for i in range(8)
    ] + [
        Transfer(id=300 + i, debit_account_id=2 + i % 9,
                 credit_account_id=3 + i % 8 if 3 + i % 8 != 2 + i % 9
                 else 11, amount=1, ledger=1, code=1)
        for i in range(16)
    ]
    body = transfers_to_np(tr).tobytes()
    ts += len(tr)
    handle = sm.commit_async(Operation.create_transfers, ts, body)
    plan = sm.handle_plan(handle)
    assert plan is not None and plan[0] == "waves" and plan[1] >= 2
    assert sm.commit_finish(handle) == b""  # all-success
    # waves.* metrics live under CATALOG'd names
    names = {
        c.name for c in metrics._counters.values()
    } | {g.name for g in metrics._gauges.values()} | {
        h.name for h in metrics._histograms.values()
    }
    wave_names = {n for n in names if n.startswith("waves.")}
    assert {"waves.batches", "waves.per_batch", "waves.chain_len_max",
            "waves.occupancy"} <= wave_names
    from tigerbeetle_tpu_torch.metrics import CATALOG

    assert all(n in CATALOG for n in wave_names), wave_names - set(CATALOG)
    # legacy stat surface: same dict, legacy keys present
    s = dict(dev.hazards.split_stats)
    for key in ("fast", "fast_pv", "serial", "split", "split_pv", "waves"):
        assert key in s, s


def test_simulator_seed_matrix_with_waves():
    """Same seed, conflict-heavy workload, REAL device backend: two runs
    are byte-identical (the full stats dict, which folds in the committed
    history via the checker) — the wave planner introduces no
    nondeterminism under consensus, crashes included."""
    from tigerbeetle_tpu_torch.testing.simulator import run_simulation

    kwargs = dict(
        ticks=220,
        backend_factory=None,  # the DeviceLedger (wave planner live)
        device="cpu",
        n_clients=1,
        crash_probability=0.002,
        workload_knobs={
            "conflict_rate": 0.3,
            "two_phase_rate": 0.35,
            "chain_rate": 0.1,
            "limit_account_rate": 0.2,
        },
    )
    a = run_simulation(17, **kwargs)
    b = run_simulation(17, **kwargs)
    assert a == b
    assert a["committed_ops"] > 3


def test_port_catalog_is_the_jax_catalog():
    """The port's metric catalog names and documents every metric as the
    JAX package's does, so a port server's names can be held to it."""
    from tigerbeetle_tpu.metrics import CATALOG as J_CATALOG
    from tigerbeetle_tpu_torch.metrics import CATALOG

    assert CATALOG == J_CATALOG


def test_warm_up_runs_the_wave_commit(monkeypatch):
    """The server's warm-up (`warm_device_kernels`) commits a batch that
    plans as two waves and a serial residue, so it launches K12 (here its
    CPU route) before the server listens."""
    from tigerbeetle_tpu_torch.constants import ConfigProcess
    from tigerbeetle_tpu_torch.models import dual_ledger
    from tigerbeetle_tpu_torch.models import ledger as tledger

    calls = []
    plain = tledger.commit_transfers_waves

    def counted(*a, **kw):
        calls.append(a[3])  # the wave count
        return plain(*a, **kw)

    monkeypatch.setattr(tledger, "commit_transfers_waves", counted)
    dual_ledger.warm_device_kernels(ConfigProcess(account_slots_log2=10,
                                                  transfer_slots_log2=14), "cpu")
    assert calls and min(calls) >= 2
