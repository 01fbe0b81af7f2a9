"""The dual-commit follower in the PyTorch port against the JAX package,
bit for bit: the reply-code fold (K7) in its four JAX forms, its numpy twin,
and DualLedger in follower and shadow mode over the native C++ engine.

The port runs its plain PyTorch versions on the CPU; the JAX package runs
as its own tests run it, on the CPU. Inputs come from seeds (numpy, and the
JAX package's testing.workload.WorkloadGenerator). The device ring is
compared without its DUMP slot, which takes inactive and de-duplicated
lanes (the JAX scatter writes it in unspecified order). Tolerance: zero.
"""

from time import perf_counter_ns

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tigerbeetle_tpu  # noqa: F401  (x64 before any input is built)
from tigerbeetle_tpu import types as jtypes
from tigerbeetle_tpu.models import dual_ledger as jdual
from tigerbeetle_tpu.models import ledger as jledger
from tigerbeetle_tpu.testing.workload import WorkloadGenerator
from tigerbeetle_tpu_torch import convert, types
from tigerbeetle_tpu_torch.latency import DEVICE_LEGS, device_leg_totals
from tigerbeetle_tpu_torch.metrics import Metrics
from tigerbeetle_tpu_torch.models import ledger as tledger
from tigerbeetle_tpu_torch.models.dual_ledger import (
    APPLY_RING,
    DualLedger,
    _ring_indices,
    raise_on_parity_divergence,
)
from tigerbeetle_tpu_torch.ops.u128 import to_i64
from tigerbeetle_tpu_torch.state_machine import StateMachine
from tigerbeetle_tpu_torch.testing.hash_log import HashLogDivergence
from tigerbeetle_tpu_torch.tracer import Tracer
from tigerbeetle_tpu_torch.types import Operation

U64 = (1 << 64) - 1
N_PAD = 64


def codes_u32(rng, n: int) -> np.ndarray:
    """Reply codes with the high bit set in some lanes (a u32 must not
    sign-extend into the lane hash)."""
    c = rng.integers(0, 60, n).astype(np.uint32)
    c[rng.random(n) < 0.2] |= np.uint32(0x8000_0000)
    c[rng.random(n) < 0.1] = 0xFFFF_FFFF
    return c


def t_chk(x: int):
    return torch.tensor(to_i64(x), dtype=torch.int64)


def t_codes(c: np.ndarray):
    return torch.from_numpy(c.view(np.int32).copy())


# ----------------------------------------------------------------------
# K7: the plain version against the four JAX forms
# ----------------------------------------------------------------------


@pytest.mark.parametrize("n", [0, 1, 37, N_PAD])
def test_fold_reply_codes_matches_jax(n):
    """`fold_reply_codes`: one batch, lanes < n of n_pad, the fault word
    after them; then a chain of 5 batches."""
    rng = np.random.default_rng(100 + n)
    fold = jax.jit(jledger.fold_reply_codes)
    chk_j = jnp.uint64(int(rng.integers(0, 1 << 63)) * 2 + 1)
    chk_t = t_chk(int(chk_j))
    for _ in range(5):
        c = codes_u32(rng, N_PAD + 1)
        chk_j = fold(chk_j, jnp.asarray(c), jnp.int32(n))
        tledger.fold_codes_plain(chk_t, t_codes(c), N_PAD + 1, [n], [True])
        assert int(chk_t) & U64 == int(np.asarray(chk_j))
        # the wrapper takes the plain version for a CPU tensor
        a, b = t_chk(7), t_chk(7)
        tledger.fold_codes(a, t_codes(c), N_PAD + 1, [n], [True])
        tledger.fold_codes_plain(b, t_codes(c), N_PAD + 1, [n], [True])
        assert int(a) == int(b)


def group_case(rng, k: int, m: int, ns_pick):
    """k slots of N_PAD lanes, the first m active with counts ns_pick, the
    rest padding (n = 0, inactive), and the fault word at the end."""
    flat = codes_u32(rng, k * N_PAD + 1)
    ns = np.zeros(k, dtype=np.int32)
    ns[:m] = ns_pick
    active = np.arange(k) < m
    return flat, ns, active


GROUP_CASES = {
    "k16_padding": (16, 11, [N_PAD, 0, 1, 5, N_PAD - 1, 17, 33, 2, N_PAD, 8, 1]),
    "k4_n1": (4, 4, [1, N_PAD, 0, 9]),
    "k4_one_active": (4, 1, [5]),
}


@pytest.mark.parametrize("case", GROUP_CASES)
def test_fold_group_matches_jax(case):
    """`_fold_group_fn`: the shadow mode's fused fold over up to 16 slots,
    padding slots left out of the chain; three groups chained."""
    k, m, pick = GROUP_CASES[case]
    rng = np.random.default_rng(7)
    fn = jdual._fold_group_fn(k, N_PAD)
    chk_j = jnp.uint64(12345)
    chk_t = t_chk(12345)
    for _ in range(3):
        flat, ns, active = group_case(rng, k, m, pick)
        chk_j = fn(chk_j, jnp.asarray(flat), jnp.asarray(ns), jnp.asarray(active))
        tledger.fold_codes_plain(chk_t, t_codes(flat), N_PAD, ns, active)
        assert int(chk_t) & U64 == int(np.asarray(chk_j))


@pytest.mark.parametrize("case", GROUP_CASES)
def test_fold_group_ring_matches_jax(case):
    """`_fold_group_ring_fn`: the follower's fused fold writes each slot's
    chain value into the ring; padding slots and all but the last of two
    congruent ops go to the DUMP slot (`_ring_indices`)."""
    k, m, pick = GROUP_CASES[case]
    rng = np.random.default_rng(8)
    fn = jdual._fold_group_ring_fn(k, N_PAD)
    ring0 = rng.integers(0, 1 << 63, APPLY_RING + 1).astype(np.uint64)
    ring_j = jnp.asarray(ring0)
    ring_t = convert.ring_from_numpy(ring0, "cpu")
    chk_j = jnp.uint64(99)
    chk_t = t_chk(99)
    for g in range(3):
        flat, ns, active = group_case(rng, k, m, pick)
        # op numbers with a collision mod APPLY_RING in the first group
        ops = [g * 100 + 4000 + i for i in range(m)]
        if g == 0 and m >= 2:
            ops[1] = ops[0] + APPLY_RING
        idxs = _ring_indices(ops, k)
        chk_j, ring_j = fn(chk_j, ring_j, jnp.asarray(idxs), jnp.asarray(flat),
                           jnp.asarray(ns), jnp.asarray(active))
        tledger.fold_codes_plain(chk_t, t_codes(flat), N_PAD, ns, active, ring_t, idxs)
        assert int(chk_t) & U64 == int(np.asarray(chk_j))
        got = ring_t.numpy().view(np.uint64)[:APPLY_RING]
        np.testing.assert_array_equal(got, np.asarray(ring_j)[:APPLY_RING])


@pytest.mark.parametrize("n", [0, 1, 50])
def test_fold_ring_matches_jax(n):
    """`_fold_ring_fn`: the follower's solo fold, chain and one ring write."""
    rng = np.random.default_rng(9 + n)
    fn = jdual._fold_ring_fn()
    ring_j = jnp.zeros(APPLY_RING + 1, dtype=jnp.uint64)
    ring_t = torch.zeros(APPLY_RING + 1, dtype=torch.int64)
    chk_j = jnp.uint64(0)
    chk_t = t_chk(0)
    for op in (3, 4, 3 + APPLY_RING, APPLY_RING - 1, 0):
        c = codes_u32(rng, N_PAD + 1)
        idx = op % APPLY_RING
        chk_j, ring_j = fn(chk_j, ring_j, jnp.int32(idx), jnp.asarray(c), jnp.int32(n))
        tledger.fold_codes_plain(chk_t, t_codes(c), N_PAD, [n], [True], ring_t, [idx])
        assert int(chk_t) & U64 == int(np.asarray(chk_j))
    np.testing.assert_array_equal(ring_t.numpy().view(np.uint64)[:APPLY_RING],
                                  np.asarray(ring_j)[:APPLY_RING])


def test_fold_reply_codes_np_matches_jax():
    rng = np.random.default_rng(11)
    a = b = 0
    for n in (0, 1, 8190, 5, 100):
        c = codes_u32(rng, n)
        a = tledger.fold_reply_codes_np(a, c)
        b = jledger.fold_reply_codes_np(b, c)
        assert a == b
    # and against the device form on the same codes
    c = codes_u32(rng, 40)
    chk = t_chk(a)
    tledger.fold_codes_plain(chk, t_codes(c), 40, [40], [True])
    assert tledger.fold_reply_codes_np(a, c) == int(chk) & U64


def test_group_ring_fold_dump_slot_no_collision():
    """Inactive lanes of a partly filled group go to the DUMP slot: slot 0
    keeps the active op's chain value (the JAX regression test's case)."""
    k, n_pad = 4, 8
    flat = torch.arange(k * n_pad + 1, dtype=torch.int32)
    ns, active = [5, 0, 0, 0], [True, False, False, False]
    idxs = _ring_indices([APPLY_RING], k)  # op 4096 -> slot 0
    assert idxs.tolist() == [0, APPLY_RING, APPLY_RING, APPLY_RING]
    ring = torch.full((APPLY_RING + 1,), 999, dtype=torch.int64)
    chk = t_chk(7)
    one = t_chk(7)
    tledger.fold_codes_plain(one, flat[:n_pad], n_pad, [5], [True])
    expect = int(one)
    tledger.fold_codes_plain(chk, flat, n_pad, ns, active, ring, idxs)
    assert int(chk) == expect
    assert int(ring[0]) == expect
    j_chk = jax.jit(jledger.fold_reply_codes)(jnp.uint64(7), jnp.arange(n_pad, dtype=jnp.uint32),
                                               jnp.int32(5))
    assert expect & U64 == int(np.asarray(j_chk))


# ----------------------------------------------------------------------
# DualLedger over the native engine, device ledger on the CPU
# ----------------------------------------------------------------------


def valid_accounts(start: int, n: int) -> np.ndarray:
    a = np.zeros(n, dtype=types.ACCOUNT_DTYPE)
    a["id_lo"] = np.arange(start, start + n, dtype=np.uint64)
    a["ledger"] = 1
    a["code"] = 1
    return a


def valid_transfers(start: int, n: int, flags: int = 0, pend_ids=None) -> np.ndarray:
    x = np.zeros(n, dtype=types.TRANSFER_DTYPE)
    x["id_lo"] = np.arange(start, start + n, dtype=np.uint64)
    x["debit_account_id_lo"] = 1 + np.arange(n) % 9
    x["credit_account_id_lo"] = 1 + (np.arange(n) + 1) % 9
    x["amount_lo"] = 1
    x["ledger"] = 1
    x["code"] = 1
    x["flags"] = flags
    if pend_ids is not None:
        x["pending_id_lo"] = pend_ids
        x["debit_account_id_lo"] = 0
        x["credit_account_id_lo"] = 0
        x["amount_lo"] = 0
    return x


def drive_follower(led, op, arr, op_no: int, sampled: bool = False) -> None:
    """One committed op through the follower seam, as the replica does it:
    native execute (the reply), then apply_commit at finalize with the
    native dense codes; a sampled op also carries a trace id and the
    latency anatomy's enqueue stamp."""
    led.prepare(op, len(arr))
    ts = led.prepare_timestamp
    p = led.execute_async(op, ts, arr)
    led.drain(p)
    extra = {"trace": 0x7000 + op_no, "lat_ns": perf_counter_ns()} if sampled else {}
    led.apply_commit(op_no, op, ts, arr, p.codes, prepare_checksum=0xABCD_0000 + op_no, **extra)


def follower(**kw):
    return DualLedger(12, 14, follower=True, device="cpu", **kw)


def mixed_stream():
    """The mixed workload: accounts, a run of plain transfers (fused when
    the applier is held), a pending batch and its posts, and a seeded
    generator tail of valid and invalid events."""
    ops = [(Operation.create_accounts, valid_accounts(1, 16))]
    ops += [(Operation.create_transfers, valid_transfers(1000 + 64 * g, 64)) for g in range(5)]
    pend = valid_transfers(5000, 32, flags=2)
    ops.append((Operation.create_transfers, pend))
    ops.append((Operation.create_transfers,
                valid_transfers(6000, 32, flags=4, pend_ids=pend["id_lo"])))
    gen = WorkloadGenerator(13)
    for b in range(4):
        op, events = gen.gen_accounts_batch(32) if b % 2 == 0 else gen.gen_transfers_batch(32)
        arr = (jtypes.accounts_to_np(events) if op == Operation.create_accounts
               else jtypes.transfers_to_np(events))
        ops.append((op, arr))
    return ops


def run_stream(led, ops, hold_run=True, sampled=False):
    """Drive `ops` with op numbers 1.., holding the applier for the run of
    plain transfers so that it fuses; returns the finalize() report."""
    for i, (op, arr) in enumerate(ops):
        if hold_run and i == 1:
            led._test_apply_delay_s = 0.3
        drive_follower(led, op, arr, i + 1, sampled)
        if hold_run and i == 5:
            led._test_apply_delay_s = 0.0
            # drain before the two-phase ops: a pending batch in the same
            # stretch would (correctly) refuse fusion
            assert led.drain_applier(100)
    return led.finalize(timeout=300)


@pytest.fixture(scope="module")
def jax_follower_run():
    """ONE run of the JAX follower over the mixed stream, shared by the
    module: its report, device chain value and device ring."""
    led = jdual.DualLedger(12, 14, follower=True)
    report = run_stream(led, mixed_stream())
    return report, int(np.asarray(led._chk_device_scalar)), np.asarray(led._dev_ring_out)


def test_follower_parity_mixed_workload_with_fused_runs(jax_follower_run):
    """Bit-exact parity after the mixed workload with forced fused apply
    runs; the port's device chain and ring equal the JAX follower's on the
    same stream."""
    led = follower()
    ops = mixed_stream()
    report = run_stream(led, ops)
    assert report["verified"] is True, report
    assert report["shadow_batches"] == len(ops)
    assert report["hash_log"] == {"ops": len(ops), "ok": True, "first_divergent_op": None}
    assert report["shadow"]["groups"] >= 1, report["shadow"]
    j_report, j_chk, j_ring = jax_follower_run
    assert j_report["verified"] is True, j_report
    assert int(led._chk_device_scalar) & U64 == j_chk
    assert report["code_stream_digest"] == j_report["code_stream_digest"]
    np.testing.assert_array_equal(led._dev_ring_out.numpy().view(np.uint64)[:APPLY_RING],
                                  j_ring[:APPLY_RING])
    assert report["fingerprint_device"] == j_report["fingerprint_device"]


class RecordingTracer(Tracer):
    """Records the name and arguments of every span opened."""

    enabled = True

    def __init__(self):
        self.spans = []

    def span(self, name: str, **args):
        self.spans.append((name, args))
        return super().span(name, **args)


def test_follower_instrumented_device_anatomy(jax_follower_run):
    """instrument() onto a shared registry and tracer, and every op sampled
    (trace id and enqueue stamp): the device anatomy folds each op into
    every sub-leg histogram and the slowest ring, the apply lag and the
    counters reach the registry, the upload spans carry the ops' trace ids,
    and the run still verifies with the JAX follower's chain."""
    led = follower()
    metrics, tracer = Metrics(), RecordingTracer()
    led.instrument(metrics, tracer)
    ops = mixed_stream()
    report = run_stream(led, ops, sampled=True)
    assert report["verified"] is True, report
    assert report["shadow"]["groups"] >= 1, report["shadow"]
    assert int(led._chk_device_scalar) & U64 == jax_follower_run[1]

    snap = metrics.snapshot()
    hists, counters = snap["histograms"], snap["counters"]
    n = len(ops)
    assert hists["device.apply_e2e_us"]["count"] == n
    assert hists["latency.device_apply_lag_us"]["count"] == n
    assert counters["device.samples"] == n
    for leg in ("queue_wait", "coalesce_hold", "dispatch", "device_busy", "finalize_visible"):
        assert hists[f"device.{leg}_us"]["count"] == n, leg
    # the upload seam exists on the group path only
    assert 1 <= hists["device.h2d_stage_us"]["count"] < n
    totals = device_leg_totals(snap)
    assert set(totals) == set(DEVICE_LEGS)
    assert totals["queue_wait"]["count"] == n
    # groups count their padded staging buffer, solo ops their rows
    assert counters["device.h2d_bytes"] >= sum(arr.nbytes for _, arr in ops)
    assert counters["device.dispatches"] == report["shadow"]["groups"] + report["shadow"]["solo"]
    assert counters["shadow.batches"] == n
    assert snap["gauges"]["shadow.device_lag_ops"] == 0

    slow = led.device_anatomy.slowest()
    assert 1 <= len(slow) <= n
    assert slow[0]["e2e_us"] >= slow[-1]["e2e_us"]
    assert slow[0]["dominant"] in DEVICE_LEGS
    assert report["shadow"]["device_slowest"] == slow[:4]
    traces = {args["trace"] for name, args in tracer.spans if name == "shadow.upload"}
    assert traces and traces <= {0x7000 + i for i in range(1, n + 1)}


def test_follower_names_first_divergent_op():
    """A fault injected into the device applier at op 4 fails the check AT
    op 4, with that op's prepare checksum."""
    led = follower()
    led._test_corrupt_apply_op = 4
    drive_follower(led, Operation.create_accounts, valid_accounts(1, 16), 1)
    for g in range(6):
        drive_follower(led, Operation.create_transfers, valid_transfers(1000 + 32 * g, 32), g + 2)
    report = led.finalize(timeout=300)
    assert report["verified"] is False
    assert report["hash_log"]["ok"] is False
    assert report["hash_log"]["first_divergent_op"] == 4, report["hash_log"]
    assert report["hash_log"]["prepare"] == hex(0xABCD_0000 + 4)
    with pytest.raises(HashLogDivergence) as exc:
        raise_on_parity_divergence(report)
    assert exc.value.op == 4
    assert exc.value.kind == "device-apply"


def test_apply_lag_counts_items_not_op_distance():
    """Lag is items enqueued less items applied, not op-number distance."""
    led = follower()
    led._test_apply_delay_s = 0.5  # hold the applier so the lag shows
    drive_follower(led, Operation.create_accounts, valid_accounts(1, 8), 100_000)
    drive_follower(led, Operation.create_transfers, valid_transfers(100, 8), 100_050)
    assert led.apply_lag_ops() <= 2, led.apply_lag_ops()
    led._test_apply_delay_s = 0.0
    assert led.drain_applier(100)
    assert led.apply_lag_ops() == 0
    assert led.apply_lag_excess() == 0
    assert led.finalize(timeout=300)["verified"] is True


def test_fused_run_ring_slot_collision_last_wins():
    """Two active ops of one fused run congruent mod APPLY_RING: the earlier
    one goes to the DUMP slot, both rings keep the LAST op of the slot, and
    the run stays verified."""
    led = follower()
    # the applier holds each run: both transfers queue up while it holds
    # the accounts op, and it takes them as one run
    led._test_apply_delay_s = 0.3
    drive_follower(led, Operation.create_accounts, valid_accounts(1, 16), 1)
    drive_follower(led, Operation.create_transfers, valid_transfers(1000, 64), 10)
    drive_follower(led, Operation.create_transfers, valid_transfers(2000, 64), 10 + APPLY_RING)
    report = led.finalize(timeout=300)
    assert report["verified"] is True, report
    assert report["hash_log"]["ok"] is True, report["hash_log"]
    assert report["hash_log"]["ops"] == 2  # the accounts slot and the shared slot
    assert report["shadow"]["groups"] == 1, report["shadow"]


def test_follower_under_thread_switch_stress():
    """The reply side and the applier share the queue, the watermarks and
    the counters: with the interpreter switching threads every 10 us, 40
    ops in native groups and alone must all be applied and verified."""
    import sys

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        led = follower()
        drive_follower(led, Operation.create_accounts, valid_accounts(1, 10), 1)
        op_no = 1
        for g in range(8):
            items = []
            for j in range(4):
                arr = valid_transfers(10_000 + 1000 * g + 16 * j, 16)
                led.prepare(Operation.create_transfers, len(arr))
                items.append((led.prepare_timestamp, arr))
            pendings = led.try_execute_group_async(items)
            led.drain_many(pendings)
            for (ts, arr), p in zip(items, pendings):
                op_no += 1
                led.apply_commit(op_no, Operation.create_transfers, ts, arr, p.codes)
            op_no += 1
            drive_follower(led, Operation.create_transfers, valid_transfers(90_000 + 8 * g, 8),
                           op_no)
        assert led.drain_applier(100)
        assert led.apply_lag_ops() == 0
        assert led._consumed_seq == led._put_seq
        report = led.finalize(timeout=300)
    finally:
        sys.setswitchinterval(old)
    assert report["verified"] is True, report
    assert report["shadow_batches"] == op_no
    assert report["hash_log"]["ops"] == op_no


def test_follower_restart_from_snapshot():
    """The restart, cut to the ledger: a follower's native snapshot restores
    a fresh follower (the device re-seeded by K9 in the applier), which
    then follows more ops, among them posts of RESTORED pendings, and
    verifies with both probes of the commitment chain."""
    led_a = follower()
    drive_follower(led_a, Operation.create_accounts, valid_accounts(1, 10), 1)
    drive_follower(led_a, Operation.create_transfers, valid_transfers(100, 32), 2)
    pend = valid_transfers(800, 16, flags=2)
    drive_follower(led_a, Operation.create_transfers, pend, 3)
    led_a.commitment_probe(3, led_a.fingerprint())
    assert led_a.drain_applier(100)
    snap = led_a.snapshot_bytes()
    assert led_a.finalize(timeout=300)["verified"] is True

    led_b = follower()
    led_b.restore_bytes(snap)
    led_b.prepare_timestamp = led_a.prepare_timestamp
    drive_follower(led_b, Operation.create_transfers,
                   valid_transfers(900, 16, flags=4, pend_ids=pend["id_lo"]), 4)
    drive_follower(led_b, Operation.create_transfers, valid_transfers(1000, 32), 5)
    led_b.commitment_probe(5, led_b.fingerprint())
    report = led_b.finalize(timeout=300)
    assert report["verified"] is True, report
    assert report["hash_log"]["ok"] is True
    assert report["hash_log"]["ops"] == 2
    assert report["commitments"] == {"checked": 1, "ok": True, "first_divergent_op": None}
    assert report["fingerprint_device"]["transfers"] == 32 + 16 + 16 + 32


def test_follower_install_resets_nonempty_device():
    """A state-sync-shaped restore onto a follower whose device already
    applied another history: the install resets the tables first."""
    led_a = follower()
    drive_follower(led_a, Operation.create_accounts, valid_accounts(1, 10), 1)
    drive_follower(led_a, Operation.create_transfers, valid_transfers(100, 16), 2)
    snap = led_a.snapshot_bytes()
    assert led_a.finalize(timeout=300)["verified"] is True
    led_b = follower()
    drive_follower(led_b, Operation.create_accounts, valid_accounts(1, 10), 1)
    drive_follower(led_b, Operation.create_transfers, valid_transfers(5000, 16), 2)
    assert led_b.drain_applier(100)
    led_b.restore_bytes(snap)
    drive_follower(led_b, Operation.create_transfers, valid_transfers(200, 16), 3)
    report = led_b.finalize(timeout=300)
    assert report["verified"] is True, report
    assert report["hash_log"]["ok"] is True


def test_commitment_probe_names_divergent_checkpoint():
    """A host fingerprint that disagrees with the device's at a probe fails
    the commitment check at that op."""
    led = follower()
    drive_follower(led, Operation.create_accounts, valid_accounts(1, 10), 1)
    fp = led.fingerprint()
    led.commitment_probe(1, fp)
    drive_follower(led, Operation.create_transfers, valid_transfers(100, 16), 2)
    led.commitment_probe(2, dict(fp))  # the state after op 1, claimed for op 2
    report = led.finalize(timeout=300)
    assert report["verified"] is False
    c = report["commitments"]
    assert (c["checked"], c["ok"], c["first_divergent_op"]) == (2, False, 2), c


def test_follower_warm_kernels_and_device_trace(tmp_path):
    """warm_kernels runs every launcher once on scratch tables before the
    applier starts; an armed trace window writes its Chrome trace."""
    led = follower(warm_kernels=True)
    led.start_device_trace(tmp_path, window_s=0.0)
    drive_follower(led, Operation.create_accounts, valid_accounts(1, 10), 1)
    drive_follower(led, Operation.create_transfers, valid_transfers(100, 16), 2)
    report = led.finalize(timeout=300)
    assert report["verified"] is True, report
    assert (tmp_path / "device_trace.json").exists()
    assert (tmp_path / "device_trace_meta.json").exists()


def test_shadow_mode_through_state_machine():
    """Shadow mode as a StateMachine backend: replies come from the native
    engine (equal to the port's device ledger's), every create batch is
    mirrored on the device, also through the group commit, and finalize
    verifies the digests and fingerprints."""
    led = DualLedger(12, 14, device="cpu")
    assert not led.follower
    sm = StateMachine(led)
    ref = StateMachine(tledger.DeviceLedger(tledger.ConfigProcess(12, 14), device="cpu"))
    gen = WorkloadGenerator(21)
    bodies = [(Operation.create_accounts, valid_accounts(1, 10)),
              (Operation.create_accounts, jtypes.accounts_to_np(gen.gen_accounts_batch(48)[1]))]
    bodies += [(Operation.create_transfers, jtypes.transfers_to_np(gen.gen_transfers_batch(40)[1]))
               for _ in range(3)]
    for op, arr in bodies:
        body = arr.tobytes()
        replies = []
        for s in (sm, ref):
            s.prepare(op, body)
            replies.append(s.commit_finish(s.commit_async(op, s.prepare_timestamp, body)))
        assert replies[0] == replies[1]
    group = [valid_transfers(50_000 + 64 * g, 64) for g in range(3)]
    batches = []
    for arr in group:
        sm.prepare(Operation.create_transfers, arr.tobytes())
        batches.append((sm.prepare_timestamp, arr.tobytes()))
    handles = sm.commit_group_async(Operation.create_transfers, batches)
    assert handles is not None
    sm.commit_finish_many(handles)
    assert [sm.commit_finish(h) for h in handles] == [b""] * 3
    report = led.finalize(timeout=300)
    assert report["verified"] is True, report
    assert report["shadow_batches"] == len(bodies) + len(group)
    assert report["code_stream_digest"]["native"] == report["code_stream_digest"]["device"]
