"""DualLedger: the native C++ engine answers, the port's device ledger
follows: the dual-commit modes, counterpart of
`tigerbeetle_tpu/models/dual_ledger.py`.

The native engine (native/ledger.cc, models/native_ledger.py) computes every
reply at host speed, and a background thread applies the SAME committed ops,
with the same timestamps and in the same order, to the port's DeviceLedger
on the card: uploads and kernel launches only, nothing read back until
finalize(). The device state is real state, kept batch by batch by the same
commit kernels as the main path (K2-K5), and the device stays off the reply
path.

Two modes:

- **shadow**: every create batch is enqueued at execute time; the device
  is a passive mirror verified at finalize(). No op numbers.
- **follower** (the replica's `dual` plan): the replica enqueues each
  committed op at commit finalize through apply_commit(op, ...), so the
  device follows the committed op stream with an explicit watermark. This
  gives a rolling per-op hash-log ring on both sides (the first divergent
  op is named, not only "the digests differ"), bounded-lag admission
  backpressure (apply_lag_excess), drains for checkpoints and state sync,
  and restart recovery: restore_bytes re-seeds the device from the native
  snapshot's row images through DeviceLedger.install_snapshot_rows (K9).

Verification (hash-log semantics, reference: src/testing/hash_log.zig):
- every batch's dense reply codes are folded into a chained u64 digest on
  both sides: on the device by K7 (fold_codes, no host read) and on the host
  over the native engine's codes (fold_reply_codes_np), in stream order;
- in follower mode each op's chain value is also written into a rolling
  ring (a host list and its device twin, written inside K7), so finalize()
  walks the rings and fails AT the first divergent op;
- finalize() drains the apply queue and only then reads the device: the
  chain values must match, the rings entry for entry, and the state
  fingerprints (K6 on the device, tb_ledger_fingerprint on the host) field
  for field.

On the card the applier's thread launches on its own current stream (the
default stream unless a caller sets one); ctypes releases the GIL, so
native execution on the reply side and launches on the apply side overlap.
"""

from __future__ import annotations

import queue
import threading
from pathlib import Path

import numpy as np
import torch

from tigerbeetle_tpu_torch import types
from tigerbeetle_tpu_torch.constants import BENCH_BATCH, ConfigProcess
from tigerbeetle_tpu_torch.federation.commitment import FP_FIELDS
from tigerbeetle_tpu_torch.latency import (
    DLEG_BUSY,
    DLEG_COALESCE,
    DLEG_DISPATCH,
    DLEG_H2D,
    NULL_DEVICE_ANATOMY,
    DeviceAnatomy,
)
from tigerbeetle_tpu_torch.metrics import Metrics
from tigerbeetle_tpu_torch.models.ledger import (
    GROUP_KS,
    DeviceLedger,
    fold_codes,
    fold_reply_codes_np,
)
from tigerbeetle_tpu_torch.models.native_ledger import NativeLedger
from tigerbeetle_tpu_torch.testing.hash_log import HashLogDivergence
from tigerbeetle_tpu_torch.tracer import NULL_TRACER
from tigerbeetle_tpu_torch.types import Operation

_STOP = object()
_INSTALL = "__install__"  # control item: re-seed the device from a snapshot
_PROBE = "__probe__"  # control item: checkpoint-commitment fingerprint probe

# Rolling per-op digest ring (follower mode): one chained-fold value per
# committed create op, at op % APPLY_RING. The device ring has one more
# entry, the DUMP slot, for inactive group lanes and de-duplicated slots.
APPLY_RING = 1 << 12

U64 = (1 << 64) - 1
TRACE_DIR = Path(__file__).resolve().parents[2] / "build" / "trace" / "dual"


def _ring_indices(ops, k: int) -> np.ndarray:
    """K7's ring index for each of a fused group's k slots: each active
    op's ring slot, the DUMP slot for padding slots, and the DUMP slot for
    all but the LAST of two active ops congruent mod APPLY_RING (the host
    ring keeps the last op per slot too)."""
    idxs = np.full(k, APPLY_RING, dtype=np.int32)
    seen: dict[int, int] = {}
    for lane, op in enumerate(ops):
        slot = op % APPLY_RING
        if slot in seen:
            idxs[seen[slot]] = APPLY_RING
        seen[slot] = lane
        idxs[lane] = slot
    return idxs


def raise_on_parity_divergence(report: dict) -> None:
    """Hash-log check mode over a finalize() report: a failed run raises
    HashLogDivergence AT the first divergent op when the rings localized
    one, else a plain AssertionError."""
    if report.get("verified") is not False:
        return
    hl = report.get("hash_log") or {}
    op = hl.get("first_divergent_op")
    if op is not None:
        raise HashLogDivergence(op, "device-apply", hl.get("want", 0), hl.get("got", 0))
    raise AssertionError(f"dual-commit parity failed: {report}")


def warm_device_kernels(process: ConfigProcess, device) -> None:
    """Build the kernel library and launch every launcher once against a
    SCRATCH ledger of the same geometry: account commit fast and
    serial, transfer commit fast and fast_pv, the waves with a serial
    residue, the group commit at both capacities, every form of the
    fold, a lookup, the fingerprint and the install. A failed build or
    launch raises here, in the caller's thread (the follower's constructor,
    or the server before it listens)."""
    scratch = DeviceLedger(process=process, mode="auto", device=device)
    # ~10n transfer rows and n accounts land in the scratch tables; the
    # warm batch shrinks for small geometries
    n = min(BENCH_BATCH, scratch._xfer_limit // 12, scratch._acct_limit // 2)
    if n < 4:
        raise ValueError(f"geometry {process} too small to warm the kernels")
    ts = 1 << 40

    acct = np.zeros(n, dtype=types.ACCOUNT_DTYPE)
    acct["id_lo"] = np.arange(1, n + 1, dtype=np.uint64)
    acct["ledger"] = 1
    acct["code"] = 1
    ts += n
    scratch.execute_async(Operation.create_accounts, ts, acct)
    linked = acct[:2].copy()  # a linked pair: the serial account commit
    linked["id_lo"] = [n + 1, n + 2]
    linked["flags"] = [1, 0]
    ts += 2
    scratch.execute_async(Operation.create_accounts, ts, linked)

    def simple(base):
        x = np.zeros(n, dtype=types.TRANSFER_DTYPE)
        x["id_lo"] = np.arange(base, base + n, dtype=np.uint64)
        x["debit_account_id_lo"] = 1 + np.arange(n) % (n - 1)
        x["credit_account_id_lo"] = 1 + (np.arange(n) + 1) % (n - 1)
        x["amount_lo"] = 1
        x["ledger"] = 1
        x["code"] = 1
        return x

    ts += n
    scratch.execute_async(Operation.create_transfers, ts, simple(1_000_000))
    pend = simple(2_000_000)
    pend["flags"] = 2
    ts += n
    scratch.execute_async(Operation.create_transfers, ts, pend)
    post = np.zeros(n, dtype=types.TRANSFER_DTYPE)
    post["id_lo"] = np.arange(3_000_000, 3_000_000 + n, dtype=np.uint64)
    post["pending_id_lo"] = pend["id_lo"]
    post["flags"] = 4
    ts += n
    scratch.execute_async(Operation.create_transfers, ts, post)
    # pendings and their posts in one batch: the waves, and a linked
    # pair at the end for the serial residue
    half = n // 2
    wav = simple(5_000_000)
    wav["flags"][:half] = 2
    wav["pending_id_lo"][half:2 * half] = wav["id_lo"][:half]
    for f in ("debit_account_id_lo", "credit_account_id_lo", "amount_lo"):
        wav[f][half:2 * half] = 0
    wav["flags"][half:2 * half] = 4
    wav["flags"][2 * half - 2] |= 1
    ts += n
    scratch.execute_async(Operation.create_transfers, ts, wav)
    # both group capacities and the fold over each, then the solo folds
    chk = torch.zeros((), dtype=torch.int64, device=device)
    ring = torch.zeros(APPLY_RING + 1, dtype=torch.int64, device=device)
    for k in (5, 2):  # 5 -> the 16-slot group, 2 -> the 4-slot group
        items = []
        for j in range(k):
            ts += n
            items.append((ts, simple(4_000_000 + j * n)))
        pendings = scratch.try_execute_group_async(items)
        if pendings is None:
            raise RuntimeError("warm-up: the group commit declined plain transfers")
        g = pendings[0].group
        ns = [n] * k + [0] * (g.k - k)
        active = [True] * k + [False] * (g.k - k)
        fold_codes(chk, g.results, g.n_pad, ns, active)
        fold_codes(chk, g.results, g.n_pad, ns, active, ring, _ring_indices(range(k), g.k))
    results = torch.zeros(n + 1, dtype=torch.int32, device=device)
    fold_codes(chk, results, n, [n], [True])
    fold_codes(chk, results, n, [n], [True], ring, [0])
    scratch.lookup_rows(Operation.lookup_accounts, [1, 2])
    scratch.fingerprint()
    scratch.check_fault()
    scratch.reset_state()
    scratch.install_snapshot_rows(acct[:2], post[:2], np.zeros(2, dtype=np.uint32), ts)
    scratch.check_fault()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class DualLedger:
    """Replica backend: NativeLedger semantics plus an asynchronous device
    apply loop. Every reply-serving call delegates to the native engine;
    the device never blocks or touches the reply path.

    `device` defaults to "cuda" and raises if CUDA is not available; pass
    `device="cpu"` to run the device ledger on the plain versions."""

    zero_copy_events = True  # both consumers only read the event rows

    SHADOW_KEYS = ("batches", "groups", "solo", "stage_s", "idle_s", "overlapped")

    def instrument(self, metrics, tracer) -> None:
        """Re-bind onto a shared registry and tracer (the replica's).
        Accumulated values carry over; the apply loop reads shadow_stats and
        tracer per use, so an update racing the rebind may land in the old
        group. instrument() runs at setup, before commits flow."""
        for key in self.SHADOW_KEYS:
            metrics.counter(f"shadow.{key}").add(self.shadow_stats[key])
        self.metrics = metrics
        self.tracer = tracer
        self.shadow_stats = metrics.group("shadow", self.SHADOW_KEYS)
        if self.follower:
            # bound once; the apply thread is the only writer
            self._lag_gauge = metrics.gauge("shadow.device_lag_ops")
            self._overlap_gauge = metrics.gauge("shadow.device_apply_overlap")
            self._h_apply_lag = metrics.histogram("latency.device_apply_lag_us")
            self.device_anatomy = DeviceAnatomy(metrics)
        self._g_qdepth = metrics.gauge("device.queue_depth")
        self._c_dispatch = metrics.counter("device.dispatches")
        self.device.instrument(metrics, tracer)

    def __init__(
        self,
        acct_slots_log2: int = 16,
        xfer_slots_log2: int = 20,
        queue_max: int = 256,
        warm_kernels: bool = False,
        follower: bool = False,
        lag_window: int = 128,
        device=None,
    ):
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "DualLedger: CUDA is not available "
                    "(pass device='cpu' to run the plain versions)"
                )
            device = "cuda"
        device = torch.device(device)
        self._cuda = device.type == "cuda"
        self.native = NativeLedger(acct_slots_log2, xfer_slots_log2)
        # follower: the replica enqueues ops at commit finalize through
        # apply_commit; the execute paths do not enqueue
        self.follower = self.dual_follower = follower
        # bounded-lag admission window (ops): lag beyond it is the
        # replica's signal to throttle admission before put() blocks
        self.lag_window = lag_window
        process = ConfigProcess(
            account_slots_log2=acct_slots_log2,
            transfer_slots_log2=xfer_slots_log2,
        )
        # build the kernels and launch each once BEFORE serving, on scratch
        # tables freed before the real ones are allocated: a failed build
        # or launch raises here, not in the apply thread
        if warm_kernels:
            warm_device_kernels(process, device)
        self.device = DeviceLedger(process=process, mode="auto", device=device)
        self.process = None  # replica duck-typing (native backend shape)
        self.spill = None
        self.hazards = self.device.hazards
        # chained digests of the dense reply-code stream: shadow mode folds
        # the native codes on the engine's done-callbacks, follower mode on
        # the apply thread
        self._chk_native = 0  # guarded by _chk_lock
        self._chk_lock = threading.Lock()
        # written only by the apply thread; finalize() joins the thread
        # before reading them
        self._shadow_error: Exception | None = None
        self._shadow_batches = 0
        # follower watermarks: _enq_ops written at apply_commit,
        # _applied_op/_done_ops/_consumed_seq by the apply thread. Lag counts
        # ITEMS (one per committed create op), not op-number distance:
        # non-create ops and the op jump after a restart never enter the
        # queue.
        self._applied_op = 0
        self._enq_ops = 0
        self._done_ops = 0
        self._put_seq = 0  # caller thread only (apply_commit/restore_bytes)
        self._consumed_seq = 0
        self._apply_cond = threading.Condition()
        # follower hash-log rings: the host ring holds (op, prepare
        # checksum, native chain value) per applied op; the device ring is
        # its twin on the card, read once at finalize
        self._op_ring: list = [None] * APPLY_RING
        self._dev_ring_out = None
        self._chk_native_thread = 0
        self._chk_device_scalar = None
        # test hooks: seeded fault injection, set before traffic flows
        self._test_corrupt_apply_op: int | None = None
        self._test_apply_delay_s = 0.0
        # commitment probes: (op, host fingerprint, device fingerprint as
        # 0-d tensors) per checkpoint boundary, compared at finalize
        self._probe_out: list = []
        # loop cost accounting: stage_s = host seconds staging and
        # dispatching, idle_s = blocked on an empty queue, overlapped =
        # groups whose staging and dispatch finished while the previous
        # group's kernels were still running
        self.metrics = Metrics()
        self.tracer = NULL_TRACER
        self.shadow_stats = self.metrics.group("shadow", self.SHADOW_KEYS)
        self.device_anatomy = NULL_DEVICE_ANATOMY
        self._g_qdepth = self.metrics.gauge("device.queue_depth")
        self._c_dispatch = self.metrics.counter("device.dispatches")
        if follower:
            self._lag_gauge = self.metrics.gauge("shadow.device_lag_ops")
            self._overlap_gauge = self.metrics.gauge("shadow.device_apply_overlap")
            self._h_apply_lag = self.metrics.histogram("latency.device_apply_lag_us")
            self.device_anatomy = DeviceAnatomy(self.metrics)
        # the device trace: a bounded torch.profiler window started and
        # stopped by the apply thread, armed by the caller
        self._trace_armed = False
        self._trace_dir = ""
        self._trace_window_s = 3.0
        self._trace_prof = None
        # set when the device cannot follow a snapshot restore (shadow mode,
        # or a snapshot beyond the device geometry): the loop stands down
        self._restored = False
        self._q: queue.Queue = queue.Queue(maxsize=queue_max)
        self._thread = threading.Thread(
            target=self._apply_loop,
            name="device-applier" if follower else "device-shadow",
            daemon=True,
        )
        self._thread.start()

    def _record_done(self):
        """A CUDA event after the work enqueued so far on this thread's
        stream (None on the CPU, where every launch has finished)."""
        if not self._cuda:
            return None
        ev = torch.cuda.Event()
        ev.record()
        return ev

    # -- the device apply loop --------------------------------------------

    def _apply_loop(self) -> None:
        """One loop serves both modes: items are (op, operation, ts, arr,
        codes, prepare_checksum, trace, lat_ns). Shadow mode enqueues
        op=None/codes=None (its digests fold on the engine's done-callbacks);
        follower mode carries the committed op number, the native dense
        codes, the prepare checksum, the op's trace id and the latency
        anatomy's enqueue stamp. Control items (first element a str)
        re-seed the device or probe its fingerprint between runs. No host
        read of the device happens here."""
        import time as _time

        dev = self.device.device
        chk = torch.zeros((), dtype=torch.int64, device=dev)
        chk_nat = 0
        # +1: the DUMP slot; real ops land in [0, APPLY_RING)
        dev_ring = (
            torch.zeros(APPLY_RING + 1, dtype=torch.int64, device=dev)
            if self.follower else None
        )
        group_max = GROUP_KS[0]
        prev_done = None  # the previous fused group's done event (overlap probe)
        stop = False

        def note_applied(op: int | None, n_items: int) -> None:
            if op is not None:
                self._applied_op = op
                self._done_ops += n_items
                self._lag_gauge.set(max(0, self._enq_ops - self._done_ops))

        def fold_native_run(items) -> None:
            """Chain the native codes and ring entries of a run, in op
            order (follower mode)."""
            nonlocal chk_nat
            for op2, _o, _t, _a, codes, prep, *_rest in items:
                chk_nat = fold_reply_codes_np(chk_nat, codes)
                self._op_ring[op2 % APPLY_RING] = (op2, prep, chk_nat)

        def control(item) -> None:
            nonlocal chk, chk_nat, dev_ring
            try:
                if item[0] == _INSTALL:
                    chk, chk_nat, dev_ring = self._apply_install(item[1])
                elif item[0] == _PROBE:
                    self._apply_probe(item[1], item[2])
            except Exception as e:
                self._shadow_error = e
            self._consumed_seq += 1

        trace_until = 0.0  # the device trace window's deadline
        while not stop:
            t_wait = _time.perf_counter()
            run = [self._q.get()]
            self.shadow_stats.add("idle_s", _time.perf_counter() - t_wait)
            if run[0] is _STOP:
                break
            if self._trace_armed:
                self._trace_armed = False
                trace_until = self._start_trace_window()
            if isinstance(run[0][0], str):
                control(run[0])
                with self._apply_cond:
                    self._apply_cond.notify_all()
                continue
            # device anatomy: a record per SAMPLED item (slot 7, the commit
            # path's enqueue stamp), keyed by the trace id (slot 6) or the
            # op number
            anat = self.device_anatomy
            toks = [anat.open(run[0][6] or run[0][0], run[0][7]) if run[0][7] else 0]
            self._g_qdepth.set(self._q.qsize())
            # drain a run of queued create_transfers batches: one fused
            # group covers up to GROUP_KS[0] of them
            deferred_control = None
            while len(run) < group_max and run[-1][1] == Operation.create_transfers:
                try:
                    nxt = self._q.get_nowait()
                except queue.Empty:
                    break
                if nxt is _STOP:
                    stop = True
                    break
                if isinstance(nxt[0], str):
                    # a control item ends the run: apply the run first
                    deferred_control = nxt
                    break
                run.append(nxt)
                toks.append(anat.open(nxt[6] or nxt[0], nxt[7]) if nxt[7] else 0)
            if self._test_apply_delay_s:
                _time.sleep(self._test_apply_delay_s)
            if self._shadow_error is not None or self._restored:
                for t in toks:
                    anat.discard(t)
                self._consumed_seq += len(run)
                note_applied(run[-1][0], len(run))
                if deferred_control is not None:
                    self._consumed_seq += 1
                with self._apply_cond:
                    self._apply_cond.notify_all()
                continue  # drain without applying; finalize reports why
            any_tok = any(toks)
            try:
                if self._test_corrupt_apply_op is not None:
                    # seeded divergence injection: corrupt the DEVICE
                    # applier's view of one op's rows
                    run = [
                        item if item[0] != self._test_corrupt_apply_op
                        else self._corrupt_item(item)
                        for item in run
                    ]
                i = 0
                while i < len(run):
                    # the longest create_transfers stretch from i
                    j = i
                    while j < len(run) and run[j][1] == Operation.create_transfers:
                        j += 1
                    stretch_toks = ()
                    if any_tok:
                        stretch_toks = [t for t in toks[i:j if j > i else i + 1] if t]
                        if stretch_toks:
                            t_co = _time.perf_counter_ns()
                            for t in stretch_toks:
                                anat.stamp(t, DLEG_COALESCE, t_co)
                    pendings = None
                    if j - i >= 2:
                        t_stage = _time.perf_counter()
                        with self.tracer.span("shadow.upload", batches=j - i, trace=run[i][6]):
                            pendings = self.device.try_execute_group_async(
                                [(t, a) for _, _, t, a, *_ in run[i:j]]
                            )
                    if pendings is not None:
                        g = pendings[0].group
                        m = j - i
                        ns = [len(a) for _, _, _, a, *_ in run[i:j]] + [0] * (g.k - m)
                        active = [True] * m + [False] * (g.k - m)
                        if self.follower:
                            idxs = _ring_indices([it[0] for it in run[i:j]], g.k)
                            fold_codes(chk, g.results, g.n_pad, ns, active, dev_ring, idxs)
                            fold_native_run(run[i:j])
                        else:
                            fold_codes(chk, g.results, g.n_pad, ns, active)
                        done = self._record_done()
                        self._shadow_batches += m
                        self._c_dispatch.add()
                        stats = self.shadow_stats
                        stats.add("batches", m)
                        stats.add("groups")
                        stats.add("stage_s", _time.perf_counter() - t_stage)
                        if prev_done is not None and not prev_done.query():
                            # this group's staging and dispatch finished
                            # while the previous group's kernels still ran
                            stats.add("overlapped")
                        if self.follower and stats["groups"]:
                            self._overlap_gauge.set(round(stats["overlapped"] / stats["groups"], 4))
                        prev_done = done
                        if stretch_toks:
                            # h2d_stage closes at the upload-issued seam;
                            # device_busy waits for the group's kernels
                            # (no read), which serializes this sampled run
                            h2d_ns = self.device.last_h2d_done_ns
                            t_disp = _time.perf_counter_ns()
                            for t in stretch_toks:
                                if h2d_ns:
                                    anat.stamp(t, DLEG_H2D, h2d_ns)
                                anat.stamp(t, DLEG_DISPATCH, t_disp)
                            if done is not None:
                                done.synchronize()
                            t_busy = _time.perf_counter_ns()
                            for t in stretch_toks:
                                anat.stamp(t, DLEG_BUSY, t_busy)
                    else:
                        # fusion refused (a batch not proven fast-tier) or
                        # a single batch: one by one. j == i means run[i]
                        # is not create_transfers (accounts): one batch.
                        end = j if j > i else i + 1
                        t_stage = _time.perf_counter()
                        with self.tracer.span("shadow.upload", batches=end - i, solo=True,
                                              trace=run[i][6]):
                            for op2, opn2, ts2, arr2, *_rest in run[i:end]:
                                pending = self.device.execute_async(opn2, ts2, arr2)
                                n2 = len(arr2)
                                if self.follower:
                                    fold_codes(chk, pending.results, n2, [n2], [True],
                                               dev_ring, [op2 % APPLY_RING])
                                else:
                                    fold_codes(chk, pending.results, n2, [n2], [True])
                                self._shadow_batches += 1
                                self.shadow_stats.add("batches")
                                self.shadow_stats.add("solo")
                        if self.follower:
                            fold_native_run(run[i:end])
                        self.shadow_stats.add("stage_s", _time.perf_counter() - t_stage)
                        self._c_dispatch.add(end - i)
                        if stretch_toks:
                            # no upload seam on the per-batch path: the
                            # dispatch sub-leg absorbs the upload
                            t_disp = _time.perf_counter_ns()
                            for t in stretch_toks:
                                anat.stamp(t, DLEG_DISPATCH, t_disp)
                            done = self._record_done()
                            if done is not None:
                                done.synchronize()
                            t_busy = _time.perf_counter_ns()
                            for t in stretch_toks:
                                anat.stamp(t, DLEG_BUSY, t_busy)
                        j = end
                    i = j
            except Exception as e:  # the divergence surfaces at finalize
                self._shadow_error = e
            if self.follower:
                # the device-apply lane: enqueue at commit finalize ->
                # this run's uploads and launches issued (sampled ops)
                t_done = _time.perf_counter_ns()
                for item in run:
                    if item[7]:
                        self._h_apply_lag.observe((t_done - item[7]) / 1000.0)
            self._consumed_seq += len(run)
            note_applied(run[-1][0], len(run))
            if any_tok:
                t_fin = _time.perf_counter_ns()
                for t in toks:
                    if t:
                        anat.finish(t, t_fin)
            if deferred_control is not None:
                control(deferred_control)
            with self._apply_cond:
                self._apply_cond.notify_all()
            if trace_until and _time.monotonic() >= trace_until:
                trace_until = 0.0
                self._stop_trace_window()
        if trace_until:
            self._stop_trace_window()
        # written once at loop exit; finalize() joins before reading
        self._chk_device_scalar = chk
        self._chk_native_thread = chk_nat
        self._dev_ring_out = dev_ring

    @staticmethod
    def _corrupt_item(item):
        """Test hook payload: reroute EVERY lane's debit account (or ledger)
        to an invalid value, so that every valid lane's DEVICE reply code
        diverges from the native engine's."""
        op2, opn2, ts2, arr2, codes, prep, tr, lat = item
        bad = arr2.copy()
        if opn2 == Operation.create_transfers:
            bad["debit_account_id_lo"][:] = 0xDEAD_BEEF_DEAD_BEEF
            bad["debit_account_id_hi"][:] = 0xDEAD_BEEF_DEAD_BEEF
        else:
            bad["ledger"][:] = 0  # ledger_must_not_be_zero on valid lanes
        return (op2, opn2, ts2, bad, codes, prep, tr, lat)

    def _fresh_chains(self):
        dev = self.device.device
        return (
            torch.zeros((), dtype=torch.int64, device=dev),
            0,
            torch.zeros(APPLY_RING + 1, dtype=torch.int64, device=dev),
        )

    def _apply_install(self, raw: bytes):
        """An _INSTALL control item, on the apply thread: re-seed the device
        tables from a native snapshot's row images (reset_state, then
        install_snapshot_rows: uploads and K9 only) and restart both digest
        chains and rings from the installed state."""
        accounts, transfers, fulfill, commit_ts = _parse_native_snapshot(raw)
        if len(accounts) > self.device._acct_limit or len(transfers) > self.device._xfer_limit:
            # beyond the device geometry: stand down (finalize reports it)
            self._restored = True
            return self._fresh_chains()
        # a state-sync jump installs onto a device that already holds rows:
        # reset first, or every present key would claim a second slot
        self.device.reset_state()
        self.hazards = self.device.hazards
        self.device.install_snapshot_rows(accounts, transfers, fulfill, commit_ts)
        for i in range(APPLY_RING):
            self._op_ring[i] = None
        return self._fresh_chains()

    def _apply_probe(self, op: int, fp_host: dict) -> None:
        """A _PROBE control item, on the apply thread: keep the DEVICE state
        fingerprint at a checkpoint-commitment boundary. Finalizes run in op
        order, so every create <= op is ahead of the probe in the queue and
        none after it. A launch only (K6); the values are read at finalize."""
        if self._restored:
            return
        self._probe_out.append((op, fp_host, self.device.fingerprint_lazy()))

    def _commitment_probe_check(self) -> dict:
        """Read the probed device fingerprints (at finalize) and compare each
        with the host engine's at the same op: names the FIRST checkpoint
        where the device state diverged from the committed history."""
        first = None
        detail = {}
        for op, fp_host, fp_dev_lazy in self._probe_out:
            fp_dev = {k: int(v) & U64 for k, v in fp_dev_lazy.items()}
            for k in FP_FIELDS:
                if int(fp_host[k]) != fp_dev[k]:
                    if first is None:
                        first = op
                        detail = {"field": k, "host": int(fp_host[k]), "device": fp_dev[k]}
                    break
        return {
            "checked": len(self._probe_out),
            "ok": first is None,
            "first_divergent_op": first,
            **detail,
        }

    # -- follower apply seam (driven by the replica at commit finalize) ----

    def apply_commit(
        self,
        op: int,
        operation: Operation,
        timestamp: int,
        arr: np.ndarray,
        codes: np.ndarray,
        prepare_checksum: int = 0,
        trace: int = 0,
        lat_ns: int = 0,
    ) -> None:
        """Enqueue one COMMITTED op for the device applier (follower mode):
        called at commit finalize, in op order, with the event rows (a
        read-only view is enough) and the native engine's dense reply codes.
        `trace` is the op's cluster trace id (tags the shadow.upload span);
        `lat_ns` the latency anatomy's enqueue stamp for a sampled op
        (perf_counter_ns), observed into latency.device_apply_lag_us. The
        bounded queue blocks the caller only when it is full."""
        assert self.follower
        self._enq_ops += 1
        self._put_seq += 1
        self._q.put((op, operation, timestamp, arr, codes, prepare_checksum, trace, lat_ns))

    def commitment_probe(self, op: int, fp_host: dict) -> None:
        """Enqueue a checkpoint-commitment fingerprint probe (follower
        mode), with the HOST engine's fingerprint at the boundary op;
        finalize() compares the device's at the same point of the stream."""
        assert self.follower
        self._put_seq += 1
        self._q.put((_PROBE, op, fp_host))

    # -- device trace window ------------------------------------------------

    def start_device_trace(self, out_dir: str | Path = TRACE_DIR, window_s: float = 3.0) -> None:
        """Arm a bounded torch.profiler window: the APPLY thread starts it at
        its next dequeue (so it brackets real apply work), runs it for about
        `window_s` and stops it after the run that crosses the deadline,
        writing `device_trace.json` (Chrome format) and a
        `device_trace_meta.json` clock anchor into `out_dir`."""
        self._trace_dir = str(out_dir)
        self._trace_window_s = float(window_s)
        self._trace_armed = True

    def _start_trace_window(self) -> float:
        """APPLY thread: start the profiler and write the clock anchor.
        Returns the monotonic deadline (0.0 when the profiler failed)."""
        import json
        import os
        import time as _time

        from torch.profiler import ProfilerActivity, profile

        try:
            os.makedirs(self._trace_dir, exist_ok=True)
            activities = [ProfilerActivity.CPU]
            if self._cuda:
                activities.append(ProfilerActivity.CUDA)
            self._trace_prof = profile(activities=activities)
            self._trace_prof.start()
            meta = {
                # perf_counter_ns at the profiler's start: the spans' clock
                # at the trace's start
                "anchor_perf_ns": _time.perf_counter_ns(),
                "anchor_unix_s": round(_time.time(), 6),
                "window_s": self._trace_window_s,
            }
            with open(os.path.join(self._trace_dir, "device_trace_meta.json"), "w") as f:
                json.dump(meta, f, indent=1)
            self.metrics.counter("device.trace_windows").add()
            return _time.monotonic() + self._trace_window_s
        except Exception as e:  # profiling must never take the applier down
            self._trace_dir = f"<failed: {e}>"
            self._trace_prof = None
            return 0.0

    def _stop_trace_window(self) -> None:
        import os

        prof, self._trace_prof = self._trace_prof, None
        if prof is None:
            return
        try:
            prof.stop()
            prof.export_chrome_trace(os.path.join(self._trace_dir, "device_trace.json"))
        except Exception:
            pass

    # -- lag and drains ---------------------------------------------------

    def apply_lag_ops(self) -> int:
        """Committed create ops not yet dispatched to the device (items
        enqueued minus items consumed). The kernels run in stream order
        behind a dispatch; nothing on the host waits for them."""
        return max(0, self._enq_ops - self._done_ops)

    def apply_lag_excess(self) -> int:
        """Lag beyond the admission window: the replica's signal to throttle
        admission before the apply queue's put() blocks."""
        return max(0, self.apply_lag_ops() - self.lag_window)

    def drain_applier(self, timeout: float = 600.0) -> bool:
        """Block until every enqueued item (ops and control items) has been
        consumed by the apply loop: the checkpoint and state-sync barrier.
        Returns False on timeout or a dead apply thread."""
        import time as _time

        deadline = _time.monotonic() + timeout
        with self._apply_cond:
            while self._consumed_seq < self._put_seq:
                if not self._thread.is_alive():
                    return False
                left = deadline - _time.monotonic()
                if left <= 0 or not self._apply_cond.wait(timeout=min(left, 1.0)):
                    if _time.monotonic() >= deadline:
                        return False
        return True

    def _enqueue_shadow(self, operation, timestamp: int, arr) -> None:
        # a full queue briefly blocks the caller rather than dropping a
        # shadow batch (a dropped batch would be an unverifiable run)
        self._q.put((None, operation, timestamp, arr, None, 0, 0, 0))

    def _fold_native(self, pending) -> None:
        """Chain the native codes into the host digest when the engine
        worker completes the batch (one FIFO worker: stream order matches
        the shadow queue's). Shadow mode only."""

        def _cb(_fut, codes=pending.codes):
            with self._chk_lock:
                self._chk_native = fold_reply_codes_np(self._chk_native, codes)

        pending.fut.add_done_callback(_cb)

    # -- backend protocol (reply path: native) ----------------------------

    @property
    def prepare_timestamp(self) -> int:
        return self.native.prepare_timestamp

    @prepare_timestamp.setter
    def prepare_timestamp(self, value: int) -> None:
        self.native.prepare_timestamp = value

    def prepare(self, operation: Operation, event_count: int) -> None:
        self.native.prepare(operation, event_count)

    def execute_async(self, operation, timestamp: int, events):
        arr = events if isinstance(events, np.ndarray) else None
        pending = self.native.execute_async(operation, timestamp, events)
        if self.follower:
            return pending  # the replica enqueues at commit finalize
        if operation in (Operation.create_accounts, Operation.create_transfers):
            if arr is None:
                arr = (
                    types.accounts_to_np(events)
                    if operation == Operation.create_accounts
                    else types.transfers_to_np(events)
                )
            self._fold_native(pending)
            self._enqueue_shadow(operation, timestamp, arr)
        return pending

    def try_execute_group_async(self, items):
        pendings = self.native.try_execute_group_async(items)
        if pendings is None:
            return None
        if not self.follower:
            for (ts, arr), p in zip(items, pendings):
                self._fold_native(p)
                self._enqueue_shadow(Operation.create_transfers, ts, arr)
        return pendings

    def drain(self, pending):
        return self.native.drain(pending)

    def drain_many(self, pendings) -> None:
        self.native.drain_many(pendings)

    def drain_reply(self, pending, operation) -> bytes:
        return self.native.drain_reply(pending, operation)

    def execute_dense(self, operation, timestamp: int, events):
        return self.drain(self.execute_async(operation, timestamp, events))

    def execute(self, operation, timestamp: int, events):
        dense = self.execute_dense(operation, timestamp, events)
        return [(i, c) for i, c in enumerate(dense) if c]

    def lookup_rows(self, operation: Operation, ids) -> bytes:
        return self.native.lookup_rows(operation, ids)

    def lookup_accounts(self, ids):
        return self.native.lookup_accounts(ids)

    def lookup_transfers(self, ids):
        return self.native.lookup_transfers(ids)

    def counts(self) -> dict:
        return self.native.counts()

    @property
    def commit_timestamp(self) -> int:
        return self.native.commit_timestamp

    def fingerprint(self) -> dict:
        """The host engine's state digest (the commitment chain's input);
        the device's is compared per checkpoint through commitment_probe."""
        return self.native.fingerprint()

    def snapshot_bytes(self) -> bytes:
        return self.native.snapshot_bytes()

    def restore_bytes(self, raw: bytes) -> None:
        self.native.restore_bytes(raw)
        if self.follower:
            # re-seed the device from the SAME snapshot's row images, as a
            # control item in queue order (the replica drains the applier
            # before a state-replacing restore); the chains restart
            if len(raw) <= 64:
                return  # an empty snapshot: nothing to install
            self._put_seq += 1
            self._q.put((_INSTALL, raw))
            return
        # shadow mode cannot rebuild the device from a mid-history snapshot
        # (no op-tagged apply seam): the shadow stands down
        if len(raw) > 64 and self.native.counts()["accounts"] > 0:
            self._restored = True

    # -- shutdown verification --------------------------------------------

    def _shadow_report(self) -> dict:
        """The apply loop's cost and overlap summary. upload_overlap is the
        share of fused groups staged and dispatched while the previous
        group's kernels still ran."""
        s = dict(self.shadow_stats)
        s["stage_s"] = round(s["stage_s"], 3)
        s["idle_s"] = round(s["idle_s"], 3)
        s["upload_overlap"] = round(s["overlapped"] / s["groups"], 4) if s["groups"] else None
        if self.follower:
            s["applied_op"] = self._applied_op
            s["lag_ops"] = self.apply_lag_ops()
            ds = self.device_anatomy.slowest(4)
            if ds:
                s["device_slowest"] = ds
        return s

    def _hash_ring_check(self) -> dict:
        """Walk the host and device per-op rings (one read of the device
        ring) and name the FIRST divergent op. Follower mode only."""
        dev = self._dev_ring_out.cpu().numpy().view(np.uint64)
        entries = sorted((e for e in self._op_ring if e is not None), key=lambda e: e[0])
        first = None
        want = got = prep = 0
        for op, prep_chk, nat_chk in entries:
            dv = int(dev[op % APPLY_RING])
            if dv != nat_chk:
                first, want, got, prep = op, nat_chk, dv, prep_chk
                break
        return {
            "ops": len(entries),
            "ok": first is None,
            "first_divergent_op": first,
            # the op's PREPARE checksum ties the divergence to the consensus
            # stream (the WAL holds the batch both engines executed)
            **({"want": want, "got": got, "prepare": f"{prep:#x}"} if first is not None else {}),
        }

    def finalize(self, timeout: float = 600.0) -> dict:
        """Drain the apply queue, then read the device for the first time:
        compare the two reply-code digests, the per-op rings (follower mode)
        and the two state fingerprints. Returns the verification report."""
        self._q.put(_STOP)
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            return {"verified": False, "error": "shadow drain timed out",
                    "shadow": self._shadow_report()}
        if self._restored:
            return {"verified": None, "skipped": "snapshot restore: shadow stood down"}
        if self._shadow_error is not None:
            return {
                "verified": False,
                "error": f"{type(self._shadow_error).__name__}: {self._shadow_error}",
            }
        try:
            self.device.check_fault()  # the deferred fault word: report it
        except Exception as e:
            return {"verified": False, "error": f"{type(e).__name__}: {e}"}
        chk_dev = int(self._chk_device_scalar) & U64
        if self.follower:
            chk_nat = self._chk_native_thread
        else:
            # a barrier through the engine's FIFO worker: a job submitted
            # now starts after every earlier execute's done-callbacks ran
            self.native._submit(lambda: 0).result()
            with self._chk_lock:
                chk_nat = self._chk_native
        fp_nat = self.native.fingerprint()
        fp_dev = self.device.fingerprint()
        ok = chk_nat == chk_dev and all(fp_nat[k] == fp_dev[k] for k in FP_FIELDS)
        report = {
            "verified": bool(ok),
            "shadow_batches": self._shadow_batches,
            "shadow": self._shadow_report(),
            "code_stream_digest": {"native": chk_nat, "device": chk_dev},
            "fingerprint_native": fp_nat,
            "fingerprint_device": fp_dev,
        }
        if self.follower and self._dev_ring_out is not None:
            report["hash_log"] = self._hash_ring_check()
            if not report["hash_log"]["ok"]:
                report["verified"] = False
        if self._probe_out:
            report["commitments"] = self._commitment_probe_check()
            if not report["commitments"]["ok"]:
                report["verified"] = False
        return report


def _parse_native_snapshot(raw: bytes):
    """Decode the native engine's snapshot blob (native/ledger.cc
    tb_ledger_snapshot: a 64-byte header, the live account rows, the live
    transfer rows, the posted {ts, val} pairs) into the wire-row arrays and
    the per-transfer fulfill column that install_snapshot_rows takes."""
    head = np.frombuffer(raw[:64], dtype=np.uint64)
    n_a, n_t, n_p = int(head[0]), int(head[1]), int(head[2])
    commit_ts = int(head[3])
    off = 64
    accounts = np.frombuffer(raw[off:off + n_a * 128], dtype=types.ACCOUNT_DTYPE)
    off += n_a * 128
    transfers = np.frombuffer(raw[off:off + n_t * 128], dtype=types.TRANSFER_DTYPE)
    off += n_t * 128
    posted = np.frombuffer(raw[off:off + n_p * 16], dtype=np.uint64).reshape(n_p, 2)
    # the posted pairs key the PENDING transfer by its timestamp; the device
    # keeps the same fact in the fulfill column, 1:1 with transfer rows
    fulfill = np.zeros(n_t, dtype=np.uint32)
    if n_p and n_t:
        order = np.argsort(posted[:, 0])
        pts = posted[order, 0]
        pvals = posted[order, 1]
        idx = np.searchsorted(pts, transfers["timestamp"])
        idxc = np.minimum(idx, len(pts) - 1)
        match = pts[idxc] == transfers["timestamp"]
        fulfill = np.where(match, pvals[idxc], 0).astype(np.uint32)
    return accounts, transfers, fulfill, commit_ts
