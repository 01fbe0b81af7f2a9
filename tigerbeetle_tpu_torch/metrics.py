"""Metric registry: counters, gauges, timing histograms (the counterpart
of `tigerbeetle_tpu/metrics.py`, cut to what the port's dual-commit
follower, device ledger and server process use).

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
  whose methods do nothing.
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
