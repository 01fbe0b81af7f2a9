"""Span tracer (the counterpart of `tigerbeetle_tpu/tracer.py`; reference:
src/tracer.zig:48-77: commit, prefetch, compact and io spans, backends
none|Tracy).

Backends:

- `none` (the default everywhere): start/stop do nothing and span()
  returns a shared singleton context manager, so hot paths stay
  instrumented at the cost of one call;
- `json` (JsonTracer): an in-memory RING of spans dumped in Chrome
  trace-event format (about://tracing or Perfetto). When the ring is full
  the OLDEST events are overwritten (a long run keeps its tail); spans
  still open at dump() are emitted as incomplete `ph: "B"` events;
- deterministic (SimTracer, or any JsonTracer with a virtual clock): spans
  are timestamped with SIMULATOR TICKS instead of wall time, and dump()
  writes canonical JSON (sorted keys, fixed separators), so the same VOPR
  seed produces a byte-identical trace across runs.

A JsonTracer constructed with `metrics=` also feeds each completed span's
duration into the registry histogram `span.<name>` (metrics.py). The dump
bytes are the JAX package's for the same events.
"""


from __future__ import annotations

import json
import threading
import time


class Tracer:
    """No-op base (the `none` backend)."""

    enabled = False

    def start(self, name: str, **args) -> int:
        return 0

    def stop(self, token: int) -> None:
        pass

    def annotate(self, token: int, **args) -> None:
        """Attach args to a still-open span (facts learned mid-span, e.g.
        the trace ids of the frames a bus.frame_parse pass dispatched)."""

    def span(self, name: str, **args):
        return _NULL_SPAN

    def dump(self, path: str) -> None:
        pass


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


_NULL_SPAN = _NullSpan()
NULL_TRACER = Tracer()


class JsonTracer(Tracer):
    """Ring of complete events in Chrome trace format.

    `clock` defaults to wall time (perf_counter_ns; ts_div=1000 converts
    to the microseconds Chrome traces use). A deterministic harness passes
    a virtual clock (ticks) and ts_div=1.0 — see SimTracer."""

    enabled = True

    def __init__(self, capacity: int = 65536, clock=None,
                 ts_div: float = 1000.0, metrics=None, pid: int = 0):
        assert capacity > 0
        self.events: list[dict] = []
        self.capacity = capacity
        self.clock = clock if clock is not None else time.perf_counter_ns
        self.ts_div = ts_div
        self.metrics = metrics  # optional: span durations -> histograms
        self.pid = pid
        self._next = 1
        self._head = 0  # ring overwrite position once at capacity
        self._open: dict[int, tuple[str, int, dict]] = {}
        # spans stop from worker threads too (journal writer, spill IO).
        # REENTRANT: the server's SIGTERM handler dumps the trace on the
        # same main thread that may be interrupted inside start()/stop() —
        # a plain Lock would deadlock the shutdown dump.
        self._lock = threading.RLock()

    def start(self, name: str, **args) -> int:
        with self._lock:
            token = self._next
            self._next += 1
            self._open[token] = (name, self.clock(), args)
        return token

    def annotate(self, token: int, **args) -> None:
        with self._lock:
            entry = self._open.get(token)
            if entry is not None:
                entry[2].update(args)

    def stop(self, token: int) -> None:
        now = self.clock()
        with self._lock:
            name, t0, args = self._open.pop(token)
            event = {
                "name": name,
                "ph": "X",  # complete event
                "ts": t0 / self.ts_div,
                "dur": (now - t0) / self.ts_div,
                "pid": self.pid,
                "tid": 0,
                "args": args,
            }
            if len(self.events) < self.capacity:
                self.events.append(event)
            else:
                # ring: overwrite the oldest (keep the newest tail)
                self.events[self._head] = event
                self._head = (self._head + 1) % self.capacity
        if self.metrics is not None:
            if self.ts_div == 1000.0:  # wall clock: dur is already ns
                self.metrics.histogram(f"span.{name}").observe(
                    (now - t0) / 1000.0
                )

    def span(self, name: str, **args):
        return _Span(self, name, args)

    def events_ordered(self) -> list[dict]:
        """Events oldest-first (unwrapping the ring), then any still-open
        spans as incomplete `ph: "B"` begin events."""
        with self._lock:
            out = self.events[self._head:] + self.events[: self._head]
            for token in sorted(self._open):
                name, t0, args = self._open[token]
                out.append({
                    "name": name,
                    "ph": "B",  # begin without end: incomplete at dump
                    "ts": t0 / self.ts_div,
                    "pid": self.pid,
                    "tid": 0,
                    "args": args,
                })
            return out

    def dump(self, path: str) -> None:
        # canonical encoding (sorted keys, fixed separators): with a
        # deterministic clock the dump is byte-identical across runs
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events_ordered()}, f,
                      sort_keys=True, separators=(",", ":"))


class SimTracer(JsonTracer):
    """Deterministic tracer for the simulator/VOPR: timestamps are sim
    ticks (the virtual clock the whole cluster runs on), so a seed's trace
    is byte-identical across runs and two dumps of a diverging seed can be
    diffed line by line."""

    def __init__(self, clock, capacity: int = 65536, pid: int = 0):
        super().__init__(capacity=capacity, clock=clock, ts_div=1.0,
                         pid=pid)


# -- cluster-causal stitching ------------------------------------------
#
# Spans tagged with a trace id (args `trace` = one u64, or `traces` = a
# list of them — vsr/header.py trace_id) become Perfetto FLOW events at
# stitch time: for each id that appears in at least two spans, the first
# occurrence emits a flow-start ("s"), the last a flow-end ("f", bound to
# the enclosing slice), and everything between a step ("t") — clicking
# any leg of an op in Perfetto then draws arrows through its whole
# causal tree across processes. Flows are GENERATED from the surviving
# span events (never recorded into the ring), so a ring that overwrote
# an op's early spans simply shortens its flow — a dangling flow id is
# impossible by construction, and stitching is a pure deterministic
# function of the dumps (same-seed simulator runs stitch byte-identical).


def _span_trace_ids(event: dict) -> list[int]:
    args = event.get("args") or {}
    out = []
    t = args.get("trace")
    if t:
        out.append(t)
    for t in args.get("traces") or ():
        if t:
            out.append(t)
    return out


def flow_events(events: list[dict]) -> list[dict]:
    """Generate s/t/f flow events from the trace tags of `events`
    (complete or incomplete span events, any mix of pids). Ids seen in
    only ONE span emit nothing — a one-point flow is noise and a lone
    start would dangle."""
    occurrences: dict[int, list[tuple]] = {}
    for i, e in enumerate(events):
        if e.get("ph") not in ("X", "B"):
            continue
        for t in _span_trace_ids(e):
            occurrences.setdefault(t, []).append(
                (e["ts"], e["pid"], e.get("tid", 0), i)
            )
    flows: list[dict] = []
    for t in sorted(occurrences):
        occ = occurrences[t]
        if len(occ) < 2:
            continue
        occ.sort()  # (ts, pid, tid, event index): canonical causal order
        for j, (ts, pid, tid, _i) in enumerate(occ):
            ph = "s" if j == 0 else ("f" if j == len(occ) - 1 else "t")
            ev = {
                "ph": ph,
                "cat": "op",
                "name": "op",
                "id": f"{t:x}",
                "ts": ts,
                "pid": pid,
                "tid": tid,
            }
            if ph == "f":
                ev["bp"] = "e"  # bind the end to the ENCLOSING slice
            flows.append(ev)
    return flows


def stitch(event_lists: list[list[dict]],
           labels: list[str] | None = None) -> list[dict]:
    """Merge per-process span dumps into ONE event list: dump i's events
    are re-assigned pid=i (each process traced with its own local pid 0),
    named via process_name metadata, and the cross-process flow events
    are generated over the union. Pure + deterministic: byte-identical
    inputs stitch byte-identically."""
    out: list[dict] = []
    for pid in range(len(event_lists)):
        label = labels[pid] if labels and pid < len(labels) else f"pid {pid}"
        out.append({
            "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "ts": 0, "args": {"name": label},
        })
    for pid, events in enumerate(event_lists):
        for e in events:
            out.append(dict(e, pid=pid))
    out.extend(flow_events(out))
    return out


def dump_stitched(path: str, event_lists: list[list[dict]],
                  labels: list[str] | None = None) -> int:
    """Write a stitched trace as canonical JSON (sorted keys, fixed
    separators — the same byte-reproducibility contract as
    JsonTracer.dump). Returns the stitched event count."""
    events = stitch(event_lists, labels)
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f,
                  sort_keys=True, separators=(",", ":"))
    return len(events)


class _Span:
    __slots__ = ("tracer", "name", "args", "token")

    def __init__(self, tracer: JsonTracer, name: str, args: dict):
        self.tracer = tracer
        self.name = name
        self.args = args

    def __enter__(self):
        self.token = self.tracer.start(self.name, **self.args)
        return self

    def __exit__(self, *a):
        self.tracer.stop(self.token)
        return False
