"""CDC sinks: where change-record lines go.

The sink contract is NON-BLOCKING: `emit_lines(lines)` either accepts the
whole batch (True) or refuses it (False) — it must never block the caller,
because the pump runs on the server's event loop. A refusal is
backpressure: the pump pauses and retries the same op later (the WAL
ring / AOF hold the history, so nothing is lost by waiting). `lines` is
always one committed op's records, emitted atomically — op-granular
delivery is what keeps redelivery dedupable by the cursor's op.
"""

from __future__ import annotations

import sys
import time


class MemorySink:
    """In-memory sink (tests, the simulator's downstream store). An
    optional capacity bound turns it into a backpressuring consumer:
    emit_lines refuses once `capacity` lines are buffered, until drain()
    frees room — the deliberately-slow-consumer model."""

    def __init__(self, capacity: int | None = None):
        self.lines: list[str] = []
        self.capacity = capacity
        self.flushes = 0

    def emit_lines(self, lines: list[str]) -> bool:
        if (
            self.capacity is not None
            and len(self.lines) + len(lines) > self.capacity
        ):
            return False
        self.lines.extend(lines)
        return True

    def drain(self, n: int | None = None) -> list[str]:
        n = len(self.lines) if n is None else n
        out, self.lines = self.lines[:n], self.lines[n:]
        return out

    def flush(self) -> None:
        self.flushes += 1

    def close(self) -> None:
        pass


class JsonlFileSink:
    """Append-only JSONL file. O_APPEND like the AOF: concurrent writers
    would interleave whole lines, and a crash mid-write leaves a torn tail
    line a reader skips (newline-framed)."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "a", buffering=1 << 16)

    def emit_lines(self, lines: list[str]) -> bool:
        self._f.write("\n".join(lines) + "\n")
        return True

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class StdoutSink:
    """The `tigerbeetle cdc` subcommand's default: the stream on stdout,
    one record per line (pipe it wherever)."""

    def emit_lines(self, lines: list[str]) -> bool:
        sys.stdout.write("\n".join(lines) + "\n")
        return True

    def flush(self) -> None:
        sys.stdout.flush()

    def close(self) -> None:
        pass


class UdpSink:
    """Fire-and-forget UDP delivery reusing the statsd MTU batching
    (statsd.StatsD.send_batch packs newline-separated lines into <=1400 B
    datagrams — the same packing the metrics emitter uses). Lossy by
    nature; the durable cursor/AOF replay is what makes the stream
    recoverable, the datagrams are just the live feed."""

    def __init__(self, host: str, port: int):
        from tigerbeetle_tpu_torch.statsd import StatsD

        self._statsd = StatsD(host, port)
        self.datagrams = 0

    def emit_lines(self, lines: list[str]) -> bool:
        self.datagrams += self._statsd.send_batch(lines)
        return True

    def flush(self) -> None:
        pass

    def close(self) -> None:
        self._statsd.close()


class ThrottleSink:
    """Non-blocking slow-consumer wrapper: accepts at most one emission
    per `interval_us`, REFUSING (not sleeping) in between. This is how the
    bench models a deliberately slow sink without ever blocking the event
    loop — the pump sees backpressure and pauses while the replica keeps
    committing at full speed."""

    def __init__(self, inner, interval_us: int):
        self.inner = inner
        self.interval_s = interval_us / 1e6
        self._not_before = 0.0

    def emit_lines(self, lines: list[str]) -> bool:
        now = time.monotonic()
        if now < self._not_before:
            return False
        if not self.inner.emit_lines(lines):
            return False
        self._not_before = now + self.interval_s
        return True

    def flush(self) -> None:
        self.inner.flush()

    def close(self) -> None:
        self.inner.close()


class CountThrottleSink:
    """Count-based slow-consumer wrapper: accepts only every
    `accept_every`-th emission attempt, refusing the rest. The live
    analog of the simulator's `_FanoutStore(throttle_every=k)` — no
    clock involved, so the refusal pattern is deterministic in attempt
    order and the prodday timeline's "slow CDC consumer" event means the
    same thing in both harnesses. Behind the fan-out hub the laggard
    pauses only itself; the WAL/AOF reads cover what the live window
    released past it."""

    def __init__(self, inner, accept_every: int):
        assert accept_every >= 1
        self.inner = inner
        self.accept_every = accept_every
        self.attempts = 0
        self.refusals = 0

    def emit_lines(self, lines: list[str]) -> bool:
        self.attempts += 1
        if self.attempts % self.accept_every:
            self.refusals += 1
            return False
        return self.inner.emit_lines(lines)

    def flush(self) -> None:
        self.inner.flush()

    def close(self) -> None:
        self.inner.close()
