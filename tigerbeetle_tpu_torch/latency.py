"""Latency anatomy (the counterpart of `tigerbeetle_tpu/latency.py`, cut to
what the replica, the ingress gateway and the dual-commit follower use).

The replica stamps each sampled request as it crosses the consecutive legs
of its pipeline (`LatencyAnatomy`, `LEG_*`), from admission to reply egress,
and folds the intervals into one `latency.<leg>_us` histogram per leg plus
`latency.e2e_us`; the clock is the replica's Time seam, so simulated runs
stamp virtual ticks. The dual-commit follower's apply loop (models/dual_ledger.py) stamps each
sampled apply item as it crosses consecutive sub-legs, from the commit
path's enqueue to the moment the applied op is visible, and folds the
intervals into one `device.<leg>_us` histogram per sub-leg plus
`device.apply_e2e_us`: for any sampled item the sub-legs sum to its e2e.
"""

from __future__ import annotations

from time import perf_counter_ns

from tigerbeetle_tpu_torch.metrics import NULL_METRICS

# Leg ids (stamp order on the primary's durable path; a leg a request
# never crosses — e.g. fuse_hold with the window off — folds as 0us and
# is dropped from its breakdown record).
LEG_INGRESS = 0  # arrival (gateway admit) -> admission/dedup done
LEG_WAL = 1  # prepare built + WAL write issued (sync path: completed)
LEG_QUORUM = 2  # broadcast -> replication quorum reached
LEG_FUSE = 3  # quorum-ready -> commit dispatch entry (group-fuse hold)
LEG_DISPATCH = 4  # commit dispatch (stage + launch)
LEG_WAIT = 5  # dispatch -> finalize entry (async window / device compute)
LEG_FINALIZE = 6  # finalize (WAL ack wait + drain + reply build)
LEG_EGRESS = 7  # reply built -> reply leaves (bus flush / send)

LEGS = (
    "ingress_admission", "wal_write", "quorum_wait", "fuse_hold",
    "commit_dispatch", "commit_wait", "commit_finalize", "reply_egress",
)

# A gateway arrival stamp older than this is stale evidence (the frame
# it timed was dropped before the replica opened a record — a dup, a
# shed, a non-primary pass-through) and must not inflate the NEXT
# sampled request's ingress_admission leg.
_ARRIVAL_STALE_NS = 100_000_000


class LatencyAnatomy:
    """Per-request stamp collector + per-leg histogram folder + top-K
    slowest ring. One per replica; the gateway and bus hold references.

    Protocol (the replica drives it):
      if anatomy.want():                  # sampling countdown
          tok = anatomy.open(trace_id)    # begin the record
      ...
      if tok: anatomy.stamp(tok, LEG_X)   # consecutive leg boundaries
      ...
      anatomy.egress(tok, client, ctx)    # finish (or hand to the bus)
    """

    def __init__(self, metrics=None, clock=None, sample_every: int = 16,
                 capacity: int = 512, top_k: int = 32):
        m = metrics if metrics is not None else NULL_METRICS
        self.metrics = m
        self._clock = clock if clock is not None else perf_counter_ns
        self.sample_every = sample_every
        self.capacity = capacity
        self.top_k = top_k
        # leg-indexed histogram handles, bound once (a registry lookup
        # per stamp would dwarf the stamp)
        self._h = [m.histogram(f"latency.{leg}_us") for leg in LEGS]
        self._h_e2e = m.histogram("latency.e2e_us")
        self._c_samples = m.counter("latency.samples")
        self._c_dropped = m.counter("latency.dropped")
        # open records: trace id -> [t0, leg, t1, leg, t2, ...]
        self._recs: dict[int, list] = {}
        # deferred-egress handoff to the TCP bus: (client, context) ->
        # token; the bus pops the match when the reply frame is queued
        # and finishes the record at the flush that writes it
        self.defer_egress = False
        self.pending_egress: dict[tuple, int] = {}
        # sampling state: _take flags the NEXT request as sampled; the
        # countdown advances in want() on the unsampled path
        self._take = sample_every > 0
        self._since = 0
        self._arrival = 0  # gateway arrival stamp for the sampled-next req
        # top-K slowest sampled requests, ascending by e2e; _slow_min is
        # the current cutoff so the common case is ONE compare
        self._slow: list[tuple[int, dict]] = []
        self._slow_min = -1

    # -- the hot path ---------------------------------------------------

    def arrive(self) -> None:
        """Gateway admission stamp (ingress/gateway.py): records the
        arrival time IF the next request is the sampled one — one attr
        test per admitted frame otherwise."""
        if self._take:
            self._arrival = self._clock()

    def want(self) -> bool:
        """Advance the sampling countdown; True when the caller should
        open() a record for this request. The unsampled path is this one
        call: a compare or two, an increment, done. sample_every <= 0
        disables outright — checked first, because the knob can be
        turned off at runtime while `_take` is still armed from
        construction."""
        if self.sample_every <= 0:
            return False
        if self._take:
            return True
        self._since += 1
        if self._since + 1 >= self.sample_every:
            self._since = 0
            self._take = True
        return False

    def open(self, tid: int) -> int:
        """Begin the sampled record for trace id `tid`; returns the
        token (the tid) the caller guards later stamps with, or 0 when
        the record cannot open (duplicate id, sampling raced off)."""
        if not self._take:
            return 0
        self._take = self.sample_every <= 1
        now = self._clock()
        a = self._arrival
        self._arrival = 0
        t0 = a if (a and now - a < _ARRIVAL_STALE_NS) else now
        recs = self._recs
        if tid in recs:
            return 0
        if len(recs) >= self.capacity:
            # evict the oldest open record (its reply was shed/lost)
            recs.pop(next(iter(recs)))
            self._c_dropped.add()
        recs[tid] = [t0, LEG_INGRESS, now]
        return tid

    def stamp(self, tok: int, leg: int) -> None:
        r = self._recs.get(tok)
        if r is not None:
            r.append(leg)
            r.append(self._clock())

    def egress(self, tok: int, client: int, context: int) -> None:
        """Close the record at reply egress. With `defer_egress` (TCP
        bus installed) the record is parked for the bus, keyed by the
        reply frame's (client, context) pair; otherwise it finishes
        now (in-process transports deliver synchronously)."""
        if self.defer_egress:
            pe = self.pending_egress
            if len(pe) >= 128:  # replies that never flushed (conn died)
                self.discard(pe.pop(next(iter(pe))))
            pe[(client, context)] = tok
        else:
            self.finish(tok)

    def finish(self, tok: int) -> None:
        """Final stamp (reply_egress) + fold into the histograms and the
        top-K ring. Idempotent: a second finish for the same token is a
        dict miss."""
        r = self._recs.pop(tok, None)
        if r is None:
            return
        r.append(LEG_EGRESS)
        r.append(self._clock())
        t0 = r[0]
        e2e = r[-1] - t0
        hs = self._h
        prev = t0
        for i in range(1, len(r), 2):
            t = r[i + 1]
            hs[r[i]].observe((t - prev) / 1000.0)
            prev = t
        self._h_e2e.observe(e2e / 1000.0)
        self._c_samples.add()
        if e2e > self._slow_min or len(self._slow) < self.top_k:
            self._slow_insert(tok, t0, e2e, r)

    # -- cold paths -----------------------------------------------------

    def discard(self, tok) -> None:
        """Drop an open record without folding (view change abandoned
        the op; capacity eviction)."""
        if tok is not None:
            self._recs.pop(tok, None)

    def _slow_insert(self, tok: int, t0: int, e2e: int, r: list) -> None:
        legs: dict[str, float] = {}
        prev = t0
        for i in range(1, len(r), 2):
            t = r[i + 1]
            d = (t - prev) / 1000.0
            prev = t
            if d or r[i] == LEG_EGRESS:
                name = LEGS[r[i]]
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
        """The slowest sampled requests, worst first (the SIGQUIT dump,
        the [stats] wire snapshot and `tigerbeetle inspect live` all
        read this)."""
        out = [rec for _e2e, rec in reversed(self._slow)]
        return out[:limit] if limit else out


class _NullAnatomy(LatencyAnatomy):
    """Stamping disabled entirely (sample_every=0 shares the same fast
    path; this exists for callers that want a shared inert instance)."""

    def __init__(self):
        super().__init__(metrics=NULL_METRICS, sample_every=0)


NULL_ANATOMY = _NullAnatomy()


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
