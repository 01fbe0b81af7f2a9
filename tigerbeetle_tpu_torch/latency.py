"""Device-applier latency anatomy (the counterpart of the device half of
`tigerbeetle_tpu/latency.py`).

The dual-commit follower's apply loop (models/dual_ledger.py) stamps each
sampled apply item as it crosses consecutive sub-legs, from the commit
path's enqueue to the moment the applied op is visible, and folds the
intervals into one `device.<leg>_us` histogram per sub-leg plus
`device.apply_e2e_us`: for any sampled item the sub-legs sum to its e2e.
"""

from __future__ import annotations

from time import perf_counter_ns

from tigerbeetle_tpu_torch.metrics import NULL_METRICS

# -- device applier anatomy (models/dual_ledger.py apply loop) ---------
#
# The replica's request anatomy names `commit_wait` as one leg; the
# device anatomy decomposes the applier's copy of that window into
# CONSECUTIVE sub-legs, so for a sampled item sum(sub-legs) == the
# enqueue -> finalize-visible span exactly — accounted_ratio is 1.0 at
# device granularity by construction. All stamps after open() land on
# the apply thread; the enqueue stamp travels in the 8-slot apply tuple
# (slot 7, `lat_ns`) from the commit path, same perf_counter domain.

DLEG_QUEUE = 0  # apply_commit enqueue -> apply-loop dequeue
DLEG_COALESCE = 1  # dequeue -> this item's stretch enters staging
DLEG_H2D = 2  # staging entry -> h2d upload issued (group path)
DLEG_DISPATCH = 3  # upload issued -> kernel dispatch call returned
DLEG_BUSY = 4  # dispatch -> fold digest fence ready (device compute)
DLEG_FINALIZE = 5  # fence ready -> applied counters/parity visible

DEVICE_LEGS = (
    "queue_wait", "coalesce_hold", "h2d_stage",
    "dispatch", "device_busy", "finalize_visible",
)


class DeviceAnatomy:
    """Per-apply-item stamp collector for the dual-commit device
    applier: folds consecutive sub-leg intervals into the `device.*`
    histogram family plus a top-K slowest ring naming the dominant
    sub-leg. One per DualLedger; driven ONLY by the apply thread
    (open/stamp/finish), so no locking — the enqueue timestamp arrives
    by value inside the apply tuple.  # vet: owner=device-shadow
    """

    def __init__(self, metrics=None, clock=None, top_k: int = 32,
                 capacity: int = 512):
        m = metrics if metrics is not None else NULL_METRICS
        self.metrics = m
        self._clock = clock if clock is not None else perf_counter_ns
        self.top_k = top_k
        self.capacity = capacity
        self._h = [m.histogram(f"device.{leg}_us") for leg in DEVICE_LEGS]
        self._h_e2e = m.histogram("device.apply_e2e_us")
        self._c_samples = m.counter("device.samples")
        # open records: trace id -> [t_enq, leg, t, leg, t, ...]
        self._recs: dict[int, list] = {}
        self._slow: list[tuple[int, dict]] = []
        self._slow_min = -1

    def open(self, tid: int, t_enq: int, t_deq: int = 0) -> int:
        """Begin a record for a sampled apply item: `tid` is any
        nonzero per-item key (the cluster trace id when one flows, the
        op number otherwise), `t_enq` the commit path's enqueue stamp
        (apply tuple slot 7), `t_deq` the dequeue time (defaults to
        now) — together they close the queue_wait sub-leg immediately.
        Returns the token (the tid) or 0 when the record cannot open
        (zero/duplicate id)."""
        recs = self._recs
        if not tid or tid in recs:
            return 0
        if len(recs) >= self.capacity:
            recs.pop(next(iter(recs)))
        recs[tid] = [t_enq, DLEG_QUEUE, t_deq or self._clock()]
        return tid

    def stamp(self, tok: int, leg: int, t: int = 0) -> None:
        r = self._recs.get(tok)
        if r is not None:
            r.append(leg)
            r.append(t or self._clock())

    def finish(self, tok: int, t: int = 0) -> None:
        """Final stamp (finalize_visible) + fold. Idempotent."""
        r = self._recs.pop(tok, None)
        if r is None:
            return
        r.append(DLEG_FINALIZE)
        r.append(t or self._clock())
        t0 = r[0]
        e2e = r[-1] - t0
        hs = self._h
        prev = t0
        for i in range(1, len(r), 2):
            ti = r[i + 1]
            hs[r[i]].observe((ti - prev) / 1000.0)
            prev = ti
        self._h_e2e.observe(e2e / 1000.0)
        self._c_samples.add()
        if e2e > self._slow_min or len(self._slow) < self.top_k:
            self._slow_insert(tok, t0, e2e, r)

    def discard(self, tok) -> None:
        if tok:
            self._recs.pop(tok, None)

    def _slow_insert(self, tok: int, t0: int, e2e: int, r: list) -> None:
        legs: dict[str, float] = {}
        prev = t0
        for i in range(1, len(r), 2):
            t = r[i + 1]
            d = (t - prev) / 1000.0
            prev = t
            if d or r[i] == DLEG_FINALIZE:
                name = DEVICE_LEGS[r[i]]
                legs[name] = round(legs.get(name, 0.0) + d, 3)
        rec = {
            "trace": f"{tok:016x}",
            "t0_ns": t0,
            "e2e_us": round(e2e / 1000.0, 3),
            "legs": legs,
            "dominant": max(legs, key=legs.get) if legs else None,
        }
        slow = self._slow
        slow.append((e2e, rec))
        slow.sort(key=lambda x: x[0])
        if len(slow) > self.top_k:
            slow.pop(0)
        self._slow_min = slow[0][0]

    def slowest(self, limit: int = 0) -> list[dict]:
        """Slowest sampled apply items, worst first (the SIGQUIT dump,
        [stats] wire snapshot and `inspect live` read this)."""
        out = [rec for _e2e, rec in reversed(self._slow)]
        return out[:limit] if limit else out


class _NullDeviceAnatomy(DeviceAnatomy):
    def __init__(self):
        super().__init__(metrics=NULL_METRICS)

    def open(self, tid, t_enq, t_deq=0):
        return 0


NULL_DEVICE_ANATOMY = _NullDeviceAnatomy()


def device_leg_totals(metrics_snapshot: dict) -> dict[str, dict]:
    """Per-device-sub-leg {count, total_us} from a registry snapshot —
    same shape as leg_totals(), feeding the same dominant_leg() delta
    math for the frontier's per-step sub-leg attribution."""
    hists = metrics_snapshot.get("histograms", {})
    out = {}
    for leg in DEVICE_LEGS:
        h = hists.get(f"device.{leg}_us")
        if h and h.get("count"):
            out[leg] = {
                "count": h["count"],
                "total_us": h["count"] * h.get("mean", 0.0),
            }
    return out
