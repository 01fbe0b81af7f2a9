"""StatsD metrics emitter (reference: src/statsd.zig:12 — UDP, fire and
forget, used by the benchmark's --statsd flag).

Two layers:

- `StatsD`: the raw socket. count/gauge/timing send one datagram each
  (kept for one-off emission and the existing tests); `send_batch` packs
  many metric lines into MTU-sized datagrams (newline-separated, the
  standard statsd multi-metric packet) — the reference's statsd.zig
  aggregates and flushes the same way rather than paying a syscall per
  metric.
- `StatsDEmitter`: periodic flush of a whole metrics registry
  (tigerbeetle_tpu/metrics.py): counters as deltas since the last flush,
  gauges as-is, histogram percentile snapshots as gauges — one batched
  send per flush interval instead of one packet per metric per tick.

The port's copy of `tigerbeetle_tpu/statsd.py`, the same code with the
same default prefix, so that a registry gives the JAX package's datagrams
byte for byte.
"""

from __future__ import annotations

import socket

DEFAULT_HOST = "127.0.0.1"
DEFAULT_PORT = 8125
# Conservative UDP payload budget: fits any common MTU (1500 ethernet
# minus IP/UDP headers) without fragmentation.
MTU_PAYLOAD = 1400


def parse_addr(s: str) -> tuple[str, int]:
    """Parse a --statsd address. Accepts `host`, `:port`, and `host:port`
    (a bare host previously crashed on int("") after rpartition)."""
    host, sep, port = s.strip().rpartition(":")
    if not sep:  # bare host (no colon at all): rpartition put it in `port`
        return (port or DEFAULT_HOST, DEFAULT_PORT)
    return (host or DEFAULT_HOST, int(port) if port else DEFAULT_PORT)


class StatsD:
    def __init__(self, host: str = DEFAULT_HOST, port: int = DEFAULT_PORT,
                 prefix: str = "tigerbeetle_tpu"):
        self.addr = (host, port)
        self.prefix = prefix
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.setblocking(False)

    def _send(self, payload: str) -> None:
        try:
            self.sock.sendto(payload.encode(), self.addr)
        except OSError:
            pass  # metrics are best-effort

    def count(self, name: str, value: int = 1) -> None:
        self._send(f"{self.prefix}.{name}:{value}|c")

    def gauge(self, name: str, value: float) -> None:
        self._send(f"{self.prefix}.{name}:{value}|g")

    def timing(self, name: str, ms: float) -> None:
        self._send(f"{self.prefix}.{name}:{ms}|ms")

    def send_batch(self, lines: list[str]) -> int:
        """Pack metric lines into newline-separated datagrams, each at
        most MTU_PAYLOAD bytes. Returns the number of datagrams sent."""
        sent = 0
        buf: list[str] = []
        size = 0
        for line in lines:
            n = len(line) + (1 if buf else 0)
            if buf and size + n > MTU_PAYLOAD:
                self._send("\n".join(buf))
                sent += 1
                buf, size = [], 0
                n = len(line)
            buf.append(line)
            size += n
        if buf:
            self._send("\n".join(buf))
            sent += 1
        return sent

    def close(self) -> None:
        self.sock.close()


class StatsDEmitter:
    """Batched flush of a Metrics registry through one StatsD socket.

    Counters emit DELTAS since the previous flush (statsd `|c` semantics)
    and are skipped entirely when unchanged; gauges always emit; histogram
    snapshots emit p50/p95/p99/max as gauges under `<name>.<stat>` plus
    the observation-count delta as `<name>.count|c` — so a downstream
    aggregator can compute observation RATES, and a histogram that saw no
    new observations since the last flush costs no datagram bytes at all
    (an idle server used to re-emit every percentile every second)."""

    def __init__(self, statsd: StatsD, metrics):
        self.statsd = statsd
        self.metrics = metrics
        self._last: dict[str, float] = {}
        self._last_hist: dict[str, int] = {}

    def _lines(self) -> list[str]:
        snap = self.metrics.snapshot()
        prefix = self.statsd.prefix
        lines: list[str] = []
        for name, value in snap["counters"].items():
            delta = value - self._last.get(name, 0)
            if delta:
                self._last[name] = value
                lines.append(f"{prefix}.{name}:{delta}|c")
        for name, value in snap["gauges"].items():
            lines.append(f"{prefix}.{name}:{value}|g")
        for name, h in snap["histograms"].items():
            count = h.get("count", 0)
            delta = count - self._last_hist.get(name, 0)
            if not delta:
                continue  # nothing observed since the last flush
            self._last_hist[name] = count
            lines.append(f"{prefix}.{name}.count:{delta}|c")
            for stat in ("p50", "p95", "p99", "max"):
                lines.append(f"{prefix}.{name}.{stat}:{h[stat]}|g")
        return lines

    def flush(self) -> int:
        """One batched emission pass; returns datagrams sent."""
        return self.statsd.send_batch(self._lines())
