"""Metric registry: counters, gauges, timing histograms (the counterpart
of `tigerbeetle_tpu/metrics.py`: what the port's dual-commit follower,
device ledger and server process use, and the metric catalog).

- one `Metrics` registry per process, so the follower's `shadow.*`
  counters, its lag and overlap gauges and the device ledger's staging and
  upload metrics all read one store;
- `Counter` / `Gauge` are plain accumulators (float-capable: several
  stats are cumulative seconds);
- `Histogram` is a fixed-bucket (powers of two, microseconds) timing
  histogram with p50/p95/p99/max snapshots;
- `StatGroup` is a dict-compatible view over a prefix of registry
  counters (`shadow_stats["groups"]`, `dict(stats)`);
- `FlightRecorder` is a ring of periodic registry snapshots (counter
  deltas, windowed histogram percentiles), the history the server's
  `[stats]` wire command and `inspect live --watch` read;
- `NULL_METRICS` is the no-op backend: every handle is a shared singleton
  whose methods do nothing;
- `CATALOG` names every metric the instrumented pipeline emits, with its
  kind, unit and meaning: the JAX package's catalog, so that both packages'
  servers are held to the same names.
"""

from __future__ import annotations

import threading
import time
from collections.abc import Mapping

# Histogram buckets: bucket i holds observations <= 2**i (unit: the
# histogram's unit, microseconds by default). 2^0 us .. 2^26 us (~67 s)
# plus one overflow bucket — timing from a sub-microsecond span to a full
# checkpoint fits without ever resizing.
BUCKETS = 27


class Counter:
    __slots__ = ("name", "unit", "value", "_lock")

    def __init__(self, name: str, unit: str = ""):
        self.name = name
        self.unit = unit
        # One counter is written from several seams at once (the WAL
        # writer pool, the spill IO worker, the device-shadow loop,
        # native-engine done-callbacks). `value += v` is three bytecodes
        # — a thread switch between the read and the store LOSES an
        # increment — so mutation takes the lock (vet: races found the
        # unguarded cross-thread writes this protects against).
        self._lock = threading.Lock()
        self.value = 0  # vet: guarded-by=_lock

    def add(self, v=1) -> None:
        with self._lock:
            self.value += v

    def set(self, v) -> None:  # restore/rebind support
        with self._lock:
            self.value = v


class Gauge:
    __slots__ = ("name", "unit", "value")

    def __init__(self, name: str, unit: str = ""):
        self.name = name
        self.unit = unit
        self.value = 0

    def set(self, v) -> None:
        self.value = v


class _Timed:
    """Context manager: observe the wall time of a block into a histogram
    (microseconds)."""

    __slots__ = ("hist", "t0")

    def __init__(self, hist: "Histogram"):
        self.hist = hist

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *a):
        self.hist.observe((time.perf_counter_ns() - self.t0) / 1000.0)
        return False


class Histogram:
    """Fixed-bucket timing histogram. observe() is O(1): bit_length of the
    integer value picks the power-of-two bucket. Percentiles come from the
    bucket upper bound, clamped to the true observed max — exact at the
    top, within a factor of two elsewhere (the resolution the reference's
    statsd aggregation works at too)."""

    __slots__ = ("name", "unit", "counts", "count", "total", "max", "_lock")

    def __init__(self, name: str, unit: str = "us"):
        self.name = name
        self.unit = unit
        # Same cross-seam exposure as Counter: journal.write_us is
        # observed from the WAL writer pool while the event loop observes
        # it on the sync path — `count += 1` / `total += v` lose updates
        # on a thread switch, so observe() takes the lock. Reads
        # (percentile/snapshot) stay lock-free: counts never resizes, and
        # a smeared in-flight observation only staleness-skews a report.
        self._lock = threading.Lock()
        self.counts = [0] * (BUCKETS + 1)  # vet: guarded-by=_lock
        self.count = 0   # vet: guarded-by=_lock
        self.total = 0.0  # vet: guarded-by=_lock
        self.max = 0.0   # vet: guarded-by=_lock

    def observe(self, v: float) -> None:
        i = int(v).bit_length()  # v <= 2**i for all v >= 0
        with self._lock:
            self.count += 1
            self.total += v
            if v > self.max:
                self.max = v
            self.counts[i if i <= BUCKETS else BUCKETS] += 1

    def time(self) -> _Timed:
        return _Timed(self)

    def percentile(self, q: float) -> float:
        """Upper bound of the bucket holding the q-quantile observation,
        clamped to the observed max (so p100 == max exactly)."""
        if self.count == 0:
            return 0.0
        rank = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank:
                return min(float(1 << i), self.max)
        return self.max

    def snapshot(self) -> dict:
        return {
            "count": self.count,
            "mean": round(self.total / self.count, 3) if self.count else 0.0,
            "p50": round(self.percentile(0.50), 3),
            "p95": round(self.percentile(0.95), 3),
            "p99": round(self.percentile(0.99), 3),
            "max": round(self.max, 3),
            "unit": self.unit,
        }


class StatGroup(Mapping):
    """Dict-compatible read view over `prefix.key` registry counters.

    Existing stat surfaces keep their shape (`stats["cycles"]`,
    `dict(stats)`, `stats.items()`) while the storage lives in the shared
    registry — the "replace the ad-hoc dicts" move without breaking any
    reader. Writers use .add()."""

    __slots__ = ("_counters",)

    def __init__(self, metrics: "Metrics", prefix: str, keys):
        self._counters = {
            k: metrics.counter(f"{prefix}.{k}") for k in keys
        }

    def add(self, key: str, v=1) -> None:
        self._counters[key].add(v)

    def __getitem__(self, key: str):
        return self._counters[key].value

    def __iter__(self):
        return iter(self._counters)

    def __len__(self):
        return len(self._counters)

    def __repr__(self):
        return repr(dict(self))


class Metrics:
    """The registry: create-once named metrics, full snapshot for the
    [stats] line / bench artifacts / batched StatsD emission."""

    enabled = True

    def __init__(self):
        # REENTRANT: the server's SIGTERM handler snapshots the registry
        # on the same main thread that may be interrupted inside a lazy
        # metric creation — a plain Lock would deadlock the shutdown path
        self._lock = threading.RLock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    def counter(self, name: str, unit: str = "") -> Counter:
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name, Counter(name, unit))
        return c

    def gauge(self, name: str, unit: str = "") -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(name, Gauge(name, unit))
        return g

    def histogram(self, name: str, unit: str = "us") -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            with self._lock:
                h = self._histograms.setdefault(name, Histogram(name, unit))
        return h

    def group(self, prefix: str, keys) -> StatGroup:
        return StatGroup(self, prefix, keys)

    def snapshot(self) -> dict:
        """Point-in-time dump of every registered metric (counters and
        gauges as raw values, histograms as percentile snapshots). The
        registry dicts are copied under the creation lock: worker threads
        (journal writer, spill IO) lazily create metrics on first use,
        and iterating live dicts against a concurrent insert would raise
        mid-flush on the event loop."""
        with self._lock:
            counters = sorted(self._counters.items())
            gauges = sorted(self._gauges.items())
            histograms = sorted(self._histograms.items())
        return {
            "counters": {
                n: (round(c.value, 6) if isinstance(c.value, float)
                    else c.value)
                for n, c in counters
            },
            "gauges": {n: g.value for n, g in gauges},
            "histograms": {n: h.snapshot() for n, h in histograms},
        }


# -- time-series flight recorder ---------------------------------------


def _rank_percentile(counts, count: int, q: float, vmax: float) -> float:
    """Percentile over a (delta) bucket-count vector: upper bound of the
    bucket holding the q-quantile, clamped to `vmax` (the registry's
    cumulative max — a window has no exact max of its own)."""
    if count <= 0:
        return 0.0
    rank = q * count
    seen = 0
    for i, c in enumerate(counts):
        seen += c
        if seen >= rank:
            return round(min(float(1 << i), vmax), 3)
    return round(vmax, 3)


class FlightRecorder:
    """Fixed-capacity ring of periodic registry snapshots — the metric
    HISTORY a cumulative snapshot cannot give: a 2-second stall inside a
    60-second run is invisible in end-of-run totals, but jumps out of a
    per-interval series ("commit_dispatch_us p99 jumped 40x for 3s
    starting at t=41s").

    Each record() call (the server loop drives it ~1/s) appends one
    compact entry:
      - counters as DELTAS since the previous entry (zero deltas
        dropped — an idle counter costs no history bytes),
      - gauges raw,
      - histograms as WINDOWED percentiles computed from the bucket-
        count deltas (only histograms that observed in the interval),
    so an entry is a few KB and the default 180-entry ring holds ~3
    minutes. The ring rides the `[stats]` wire command as `history`
    (`inspect live --watch` renders it as per-second rates) and the
    SIGQUIT hang dump.

    The caller supplies the timestamp (the server loop's monotonic
    seconds) — the recorder itself reads no clock, so it stays inert in
    the determinism closure."""

    def __init__(self, metrics: Metrics, capacity: int = 180):
        assert capacity > 0
        self.metrics = metrics
        self.capacity = capacity
        self.entries: list[dict] = []  # ring, oldest-first after unwrap
        self._head = 0
        self._prev_t: float | None = None
        self._prev_counters: dict[str, float] = {}
        # histogram window state: name -> (count, total, counts[:])
        self._prev_hist: dict[str, tuple] = {}
        # Scenario phase (the prodday harness's `mark` wire command):
        # every entry recorded while a phase is set carries it, so the
        # SLO scorer slices the ring per phase. Only ever written from
        # the event loop that drives record() (replica._on_mark and the
        # server loop run on the same thread).
        # vet: owner=event-loop
        self.phase: str | None = None
        self.phase_log: list[tuple[float, str]] = []  # (t, name)

    def set_phase(self, name: str, now_s: float | None = None) -> float:
        """Stamp a phase transition: subsequent entries carry `name`.
        With no timestamp the transition is stamped at the last record's
        time base — within one interval of the truth and clock-free, so
        the sim twin's recorder stays inside the determinism closure."""
        t = now_s if now_s is not None else (self._prev_t or 0.0)
        self.phase = name
        self.phase_log.append((round(t, 3), name))
        self.metrics.counter("flight.marks").add()
        return t

    def record(self, now_s: float) -> dict:
        m = self.metrics
        with m._lock:
            counters = list(m._counters.items())
            gauges = list(m._gauges.items())
            histograms = list(m._histograms.items())
        dt = (now_s - self._prev_t) if self._prev_t is not None else None
        self._prev_t = now_s
        c_delta: dict[str, float] = {}
        for name, c in sorted(counters):
            if name == "flight.records":
                continue  # the recorder's own heartbeat: a constant
                # `+1` in every entry is payload noise, not signal
            v = c.value
            d = v - self._prev_counters.get(name, 0)
            if d < 0:
                # the attached registry was swapped for a fresh one (the
                # prodday sim twin re-attaches across a replica restart):
                # count the new registry's value as this interval's delta
                d = v
            if d:
                self._prev_counters[name] = v
                c_delta[name] = round(d, 6) if isinstance(d, float) else d
        h_win: dict[str, dict] = {}
        for name, h in sorted(histograms):
            # lock-free reads (the Histogram contract): a smeared
            # in-flight observation only staleness-skews one interval
            count, total, vmax = h.count, h.total, h.max
            cs = list(h.counts)
            p_count, p_total, p_cs = self._prev_hist.get(
                name, (0, 0.0, None)
            )
            if count < p_count or (
                p_cs is not None
                and any(a < b for a, b in zip(cs, p_cs))
            ):
                # registry swap (see the counter clamp above): total
                # count or any bucket went BACKWARDS, impossible for a
                # monotone histogram — the window restarts from zero
                # against the fresh histogram
                p_count, p_total, p_cs = 0, 0.0, None
            dc = count - p_count
            if dc > 0:
                dcs = (
                    [a - b for a, b in zip(cs, p_cs)]
                    if p_cs is not None else cs
                )
                h_win[name] = {
                    "count": dc,
                    "mean": round((total - p_total) / dc, 3),
                    "p50": _rank_percentile(dcs, dc, 0.50, vmax),
                    "p95": _rank_percentile(dcs, dc, 0.95, vmax),
                    "p99": _rank_percentile(dcs, dc, 0.99, vmax),
                }
                self._prev_hist[name] = (count, total, cs)
        entry = {
            "t": round(now_s, 3),
            "dt": round(dt, 3) if dt is not None else None,
            "counters": c_delta,
            "gauges": {n: g.value for n, g in sorted(gauges)},
            "histograms": h_win,
        }
        if self.phase is not None:
            entry["phase"] = self.phase
        if len(self.entries) < self.capacity:
            self.entries.append(entry)
        else:
            self.entries[self._head] = entry
            self._head = (self._head + 1) % self.capacity
        m.counter("flight.records").add()
        return entry

    def history(self, last: int = 0) -> list[dict]:
        """Entries oldest-first (unwrapping the ring); `last` trims to
        the newest N (the wire snapshot bounds its payload with it)."""
        out = self.entries[self._head:] + self.entries[: self._head]
        return out[-last:] if last else out


# -- the zero-allocation no-op backend ---------------------------------


class _NullTimed:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


_NULL_TIMED = _NullTimed()


class _NullCounter:
    __slots__ = ()
    name = unit = ""
    value = 0

    def add(self, v=1) -> None:
        pass

    def set(self, v) -> None:
        pass


class _NullGauge(_NullCounter):
    __slots__ = ()


class _NullHistogram:
    __slots__ = ()
    name = ""
    unit = "us"
    count = 0
    total = 0.0
    max = 0.0

    def observe(self, v) -> None:
        pass

    def time(self) -> _NullTimed:
        return _NULL_TIMED

    def percentile(self, q) -> float:
        return 0.0

    def snapshot(self) -> dict:
        return {"count": 0}


_NULL_COUNTER = _NullCounter()
_NULL_GAUGE = _NullGauge()
_NULL_HISTOGRAM = _NullHistogram()


class NullMetrics:
    """Every handle is a shared no-op singleton: instrumented hot paths
    stay permanently wired at (attribute lookup + call) cost, with zero
    allocation per event."""

    enabled = False

    def counter(self, name: str, unit: str = "") -> _NullCounter:
        return _NULL_COUNTER

    def gauge(self, name: str, unit: str = "") -> _NullGauge:
        return _NULL_GAUGE

    def histogram(self, name: str, unit: str = "us") -> _NullHistogram:
        return _NULL_HISTOGRAM

    def group(self, prefix: str, keys) -> dict:
        # a PLAIN dict: no-op groups must still be read/writable in place
        # (callers do stats["k"] reads) — a dict of zeros is exactly that,
        # and writers go through .add which dict lacks; null groups are
        # therefore real dicts with an add shim
        return _NullGroup(keys)


class _NullGroup(dict):
    """Readable like the real StatGroup, writes discarded cheaply."""

    def __init__(self, keys):
        super().__init__({k: 0 for k in keys})

    def add(self, key: str, v=1) -> None:
        pass


NULL_METRICS = NullMetrics()


# -- metric-name catalog (units; surfaced in README's observability
# section; the registry does not enforce it — it documents the names the
# instrumented pipeline emits) --

CATALOG = {
    # replica commit pipeline
    "commit.group.fused_ops": ("counter", "ops", "ops committed via a fused group dispatch"),
    "commit.group.solo_ops": ("counter", "ops", "ops committed via the per-op fallback"),
    "commit.group.fused_groups": ("counter", "groups", "fused group dispatches"),
    "commit.group.fuse_holds": ("counter", "", "fuse-window holds opened on a short run"),
    "commit.group.fuse_expired": ("counter", "", "holds expired with the run still short"),
    "commit.group.wave_ops": ("counter", "ops", "ops committed via the conflict-wave scheduler"),
    "commit.group.wave_dispatches": (
        "counter", "waves", "waves dispatched across wave-scheduled ops"
    ),
    # conflict-wave scheduler (models/ledger.py HazardTracker.plan +
    # DeviceLedger._execute_waves)
    "waves.batches": ("counter", "", "batches executed through the wave scheduler"),
    "waves.per_batch": ("histogram", "waves", "dependency-ordered waves per scheduled batch"),
    "waves.chain_len_max": ("gauge", "waves", "deepest dependency chain wave-executed so far"),
    "waves.occupancy": ("gauge", "", "active-lane fraction per wave of the last scheduled batch"),
    "waves.residue_events": ("counter", "events", "events that fell to the serial residue"),
    "replica.quorum_wait_us": ("histogram", "us", "prepare broadcast -> replication quorum"),
    "replica.fuse_hold_us": ("histogram", "us", "group-commit fuse-window hold duration"),
    "replica.commit_dispatch_us": ("histogram", "us", "host time staging+launching one commit"),
    "replica.commit_finalize_us": ("histogram", "us", "drain + reply build + reply-slot write"),
    "replica.checkpoint_us": ("histogram", "us", "durable checkpoint (snapshot + trailers)"),
    "replica.checkpoints": ("counter", "", "checkpoints taken"),
    "grid.repair_requests": ("counter", "", "block repair rounds requested from peers"),
    # journal
    "journal.write_us": ("histogram", "us", "WAL prepare+header write (sync or worker)"),
    "journal.writes": ("counter", "", "prepares written to the WAL"),
    # message bus
    "bus.frames": ("counter", "", "frames parsed and dispatched"),
    "bus.tx_bytes": ("counter", "bytes", "bytes written to sockets"),
    "bus.flushes": ("counter", "", "deferred-send flush passes"),
    "bus.pump_us": ("histogram", "us", "event-loop pump turns that dispatched frames"),
    "bus.reconnects": ("counter", "conns", "successful re-dials to a previously reached replica"),
    "bus.dial_failures": ("counter", "", "dials refused/errored (arms the reconnect backoff)"),
    # client runtime (vsr/client.py tick state machine)
    "client.timeouts": ("counter", "", "request timeouts fired (loss ladder)"),
    "client.resends": ("counter", "", "request retransmissions (timeout, busy, legacy resend)"),
    "client.retargets": ("counter", "", "timeout resends aimed off-primary (round-robin walk)"),
    "client.busy_sheds": ("counter", "", "typed busy replies accepted for the in-flight request"),
    "client.pings": ("counter", "", "idle ping_client rounds (view discovery)"),
    "client.pongs": ("counter", "", "pong_client replies (view learned while idle)"),
    "client.evictions": ("counter", "", "sessions evicted by the cluster"),
    "client.reregisters": ("counter", "", "automatic post-eviction re-registrations"),
    "client.deadline_timeouts": ("counter", "", "requests dropped at their per-request deadline"),
    "client.stale_replies": ("counter", "", "duplicate/stale replies ignored (dedup)"),
    # live chaos harness (testing/chaos.py)
    "chaos.kills": ("counter", "", "replica processes SIGKILLed"),
    "chaos.restarts": ("counter", "", "replica processes respawned"),
    "chaos.gray_stops": ("counter", "", "SIGSTOP gray failures injected"),
    "chaos.conn_resets": ("counter", "", "client connection reset storms injected"),
    "chaos.recovery_ms": ("histogram", "ms", "fault to first client reply after it"),
    # server event loop (cli.py)
    "loop.busy_s": ("counter", "s", "event-loop busy wall time (pump+commit+flush)"),
    "loop.turns": ("counter", "", "busy event-loop turns"),
    "server.ops_committed": ("counter", "ops", "ops committed since boot"),
    "server.commit_min": ("gauge", "op", "highest committed op"),
    # LSM
    "lsm.lookup_batches": ("counter", "", "batched multi-point-reads (Tree.get_many)"),
    "lsm.lookup_ids": ("counter", "", "ids resolved through get_many"),
    "lsm.bloom_probes": ("counter", "", "per-table bloom-filter probes"),
    "lsm.bloom_negatives": ("counter", "", "candidates pruned by a bloom filter"),
    "lsm.get_many_us": ("histogram", "us", "one batched multi-point-read"),
    "lsm.compact_us": ("histogram", "us", "one tree settle/compaction step"),
    "grid.block_reads": ("counter", "", "block-cache misses read from storage"),
    "grid.corrupt_blocks": ("counter", "", "reads that tripped GridBlockCorrupt"),
    # spill pipeline (models/spill.py `spill.*` StatGroup + timings)
    "spill.cycles": ("counter", "", "spill cycles (cold tail -> LSM)"),
    "spill.spilled": ("counter", "rows", "rows spilled to the forest"),
    "spill.reloaded": ("counter", "rows", "spilled rows reloaded into HBM"),
    "spill.prefetches": ("counter", "", "prefetch_async jobs started"),
    "spill.prefetched": ("counter", "rows", "rows served from a prefetch"),
    "spill.t_prefetch_worker": ("counter", "s", "executor seconds gathering prefetched rows"),
    "spill.t_prefetch_wait": ("counter", "s", "seconds admit blocked on an unfinished prefetch"),
    "spill.staging_wait_us": ("histogram", "us", "reload staging-slot fence waits"),
    "spill.admit_us": ("histogram", "us", "pre-commit admission (reload + cycle)"),
    # device shadow (models/dual_ledger.py `shadow.*` StatGroup)
    "shadow.batches": ("counter", "", "batches applied by the device shadow"),
    "shadow.groups": ("counter", "", "fused shadow group dispatches"),
    "shadow.solo": ("counter", "", "per-batch shadow dispatches"),
    "shadow.stage_s": ("counter", "s", "host seconds staging+dispatching shadow work"),
    "shadow.idle_s": ("counter", "s", "shadow loop seconds blocked on an empty queue"),
    "shadow.overlapped": ("counter", "", "groups staged while the previous kernel ran"),
    # dual-commit follower mode (`--backend dual`)
    "shadow.device_lag_ops": ("gauge", "ops", "committed ops not yet device-dispatched"),
    "shadow.device_apply_overlap": ("gauge", "", "fused applies staged while the prior kernel ran"),
    "shadow.drain_timeouts": ("counter", "", "applier drains that timed out (parity at risk)"),
    # device ledger
    "ledger.staging_wait_us": ("histogram", "us", "group staging double-buffer fence waits"),
    # change-data-capture (tigerbeetle_tpu_torch/cdc/pump.py)
    "cdc.ops": ("counter", "ops", "committed ops streamed (gap spans excluded)"),
    "cdc.records": ("counter", "records", "change records accepted by the sink"),
    "cdc.gap_ops": ("counter", "ops", "ops covered by declared gap records"),
    "cdc.lag_ops": ("gauge", "ops", "commit_min minus the next un-streamed op"),
    "cdc.backpressure_pauses": ("counter", "", "pump pauses on a refusing sink (transitions)"),
    "cdc.live_hits": ("counter", "ops", "ops served from the live hook window"),
    "cdc.journal_reads": ("counter", "ops", "ops re-read from the WAL ring"),
    "cdc.aof_reads": ("counter", "ops", "ops replayed from the AOF (oracle-derived results)"),
    "cdc.results_unknown": ("counter", "ops", "create ops streamed without a reply buffer"),
    "cdc.resume_forks": ("counter", "", "cursor checksum mismatches detected at resume"),
    "cdc.cursor_writes": ("counter", "", "durable cursor acks (atomic write-rename)"),
    "cdc.pump_us": ("histogram", "us", "one bounded pump turn (encode + emit)"),
    "cdc.commitment_records": (
        "counter", "records", "checkpoint state-commitment records emitted"
    ),
    # cross-ledger federation (tigerbeetle_tpu_torch/federation): the
    # settlement agent's per-region counters — at-least-once delivery
    # means the leg counters can exceed unique-event counts across agent
    # crash/redelivery (the conservation check is the authority)
    "federation.inflight_legs": (
        "gauge", "legs", "settlement legs staged and unresolved in the agent window"
    ),
    "federation.outbound_seen": (
        "counter", "legs", "outbound origin pendings recognized in the stream"
    ),
    "federation.legs_posted": (
        "counter", "legs", "origin pendings settled (mirror leg ok, origin posted)"
    ),
    "federation.legs_voided": (
        "counter", "legs", "origin pendings voided (mirror leg terminally rejected)"
    ),
    "federation.sink_refusals": (
        "counter", "", "ops refused at the agent window (pump retries them)"
    ),
    "federation.anomalies": (
        "counter", "legs", "resolve replies outside the expected code family"
    ),
    # ingress gateway + bus front door (tigerbeetle_tpu_torch/ingress)
    "ingress.sessions": ("gauge", "sessions", "live logical sessions in the gateway table"),
    "ingress.admitted": ("counter", "requests", "requests admitted by the credit regulator"),
    "ingress.shed": ("counter", "requests", "requests answered with a typed busy reply"),
    "ingress.shed_sessions": ("counter", "requests", "new sessions shed at the gateway cap"),
    "ingress.retransmits": ("counter", "requests", "retransmits bypassing admission"),
    "ingress.passthrough_backup": (
        "counter", "requests", "requests passed through on a non-primary"
    ),
    "ingress.accepts": ("counter", "conns", "connections taken by the accept-drain loop"),
    "ingress.shed_conn": ("counter", "sends", "sends refused at a per-connection queue cap"),
    "ingress.shed_pool": ("counter", "sends", "sends refused at the shared message-pool budget"),
    "ingress.disconnect_wedged": ("counter", "conns", "wedged consumers cut at the strike limit"),
    "ingress.fanout_consumers": ("gauge", "consumers", "CDC fan-out consumers on one tail"),
    "ingress.fanout_lag_ops": ("gauge", "ops", "slowest fan-out consumer vs the watermark"),
    # per-request critical-path attribution (tigerbeetle_tpu_torch/latency.py;
    # legs are CONSECUTIVE intervals, so a request's legs sum to its e2e)
    "latency.ingress_admission_us": (
        "histogram", "us", "arrival/gateway admit -> request admission+dedup done"
    ),
    "latency.wal_write_us": (
        "histogram", "us", "prepare built + WAL write issued (sync path: completed)"
    ),
    "latency.quorum_wait_us": (
        "histogram", "us", "prepare broadcast -> replication quorum reached"
    ),
    "latency.fuse_hold_us": (
        "histogram", "us", "quorum-ready -> commit dispatch entry (group-fuse hold)"
    ),
    "latency.commit_dispatch_us": (
        "histogram", "us", "commit dispatch (stage + device launch)"
    ),
    "latency.commit_wait_us": (
        "histogram", "us", "dispatch -> finalize entry (async window / device compute)"
    ),
    "latency.commit_finalize_us": (
        "histogram", "us", "finalize (WAL ack wait + drain + reply build)"
    ),
    "latency.reply_egress_us": (
        "histogram", "us", "reply built -> reply leaves (bus flush / send)"
    ),
    "latency.e2e_us": (
        "histogram", "us", "arrival -> reply egress (the legs above sum to this)"
    ),
    "latency.samples": ("counter", "requests", "requests stamped end to end"),
    "latency.dropped": (
        "counter", "requests", "open records evicted unfinished (shed/lost replies)"
    ),
    # parallel lanes (observed off the critical path, never in e2e)
    "latency.device_apply_lag_us": (
        "histogram", "us", "dual mode: commit finalize enqueue -> device upload"
    ),
    "latency.wal_lane_us": (
        "histogram", "us", "async WAL: submit -> durable on the writer pool"
    ),
    # device applier anatomy (latency.py DeviceAnatomy, stamped by
    # models/dual_ledger.py's apply loop; sub-legs are CONSECUTIVE, so a
    # sampled item's sub-legs sum to its apply_e2e exactly — this is the
    # decomposition of the replica's commit_wait leg)
    "device.queue_wait_us": (
        "histogram", "us", "apply_commit enqueue -> apply-loop dequeue"
    ),
    "device.coalesce_hold_us": (
        "histogram", "us", "dequeue -> item's stretch enters staging (run assembly)"
    ),
    "device.h2d_stage_us": (
        "histogram", "us", "staging entry -> h2d upload issued (group path)"
    ),
    "device.dispatch_us": (
        "histogram", "us", "upload issued -> kernel dispatch call returned"
    ),
    "device.device_busy_us": (
        "histogram", "us", "dispatch -> fold digest fence ready (device compute)"
    ),
    "device.finalize_visible_us": (
        "histogram", "us", "fence ready -> applied counters/parity visible"
    ),
    "device.apply_e2e_us": (
        "histogram", "us", "enqueue -> finalize-visible (the sub-legs sum to this)"
    ),
    "device.samples": ("counter", "items", "apply items stamped end to end"),
    # device applier throughput surfaces (flight-recorder device columns)
    "device.queue_depth": ("gauge", "items", "apply-queue depth at the last dequeue"),
    "device.h2d_bytes": ("counter", "bytes", "event bytes staged for device upload"),
    "device.dispatches": ("counter", "", "device kernel dispatches (group or solo)"),
    # compile sentinel (models/ledger.py CompileSentinel wrapping every
    # jit entry point; post-warmup compiles are hot-path events)
    "device.compiles": ("counter", "", "XLA compiles observed at any jit entry point"),
    "device.compiles_post_warmup": (
        "counter", "", "compiles landing AFTER warmup — hot-path recompile events"
    ),
    "device.compile_ms": ("histogram", "ms", "wall time of one observed XLA compile"),
    # XLA trace bridge (--device-trace profiler window on the applier)
    "device.trace_windows": ("counter", "", "bounded jax.profiler windows captured"),
    # time-series flight recorder (metrics.py FlightRecorder)
    "flight.records": ("counter", "", "flight-recorder snapshots taken"),
    "flight.marks": ("counter", "", "phase-marker transitions stamped (prodday `mark`)"),
    "inspect.marks": ("counter", "", "`mark` wire commands served (vsr/replica.py _on_mark)"),
    # cluster-causal tracing + introspection (tracer.py, inspect.py)
    "trace.sigquit_dumps": ("counter", "", "SIGQUIT hang-diagnosis dumps taken"),
    "inspect.live_requests": ("counter", "", "live [stats] snapshots served over the wire"),
    # bench driver
    "bench.batch_latency_us": ("histogram", "us", "synced single-batch dispatch latency"),
}
