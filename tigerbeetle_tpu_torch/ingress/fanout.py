"""CdcFanoutHub: one change-stream tail, N independent consumers.

A single CdcPump binds one consumer (sink + cursor) to one live window;
serving N sinks means N windows and N hook chains, or one fan-out sink
whose slowest member backpressured everyone. The hub fixes both:

- ONE `CdcTail` (cdc/pump.py) holds the shared live window and the
  WAL-ring fallback — reads are non-destructive, so every consumer
  reads the same ops at its own position (the deep AOF-replay source is
  per-consumer: it is forward-only, tracking ONE position);
- each consumer is a full `CdcPump` (its own cursor, sink, pause state,
  ack cadence) constructed over the shared tail — pausing, crashing or
  resuming one consumer never moves another's position;
- the hub releases the live window at the SLOWEST consumer's position,
  and the window stays bounded regardless: a consumer lagging past
  `window` ops falls back to WAL-ring (then AOF) reads while the fast
  consumers keep riding the O(1) live window. Backpressure isolation
  is therefore structural, not scheduled.

Budgeting: `pump(budget_ops)` gives EVERY consumer its own budget per
turn (a paused consumer spends none of it — its sink refusal returns
immediately), so one throttled sink cannot starve the others' turns.
"""

from __future__ import annotations

from tigerbeetle_tpu_torch.cdc.pump import CdcPump, CdcTail


class CdcFanoutHub:
    def __init__(self, replica, window: int = 256,
                 aof_path: str | None = None):
        self.replica = replica
        self.tail = CdcTail(replica, window=window, aof_path=aof_path)
        self.pumps: dict[str, CdcPump] = {}
        self._attached = False
        m = replica.metrics
        self._g_consumers = m.gauge("ingress.fanout_consumers")
        self._g_lag = m.gauge("ingress.fanout_lag_ops")

    def add_consumer(self, name: str, sink, cursor,
                     ack_interval: int = 32,
                     commitments: bool = False) -> CdcPump:
        assert name not in self.pumps, f"duplicate consumer {name!r}"
        pump = CdcPump(
            self.replica, sink, cursor,
            window=self.tail.window, ack_interval=ack_interval,
            tail=self.tail, commitments=commitments,
        )
        self.pumps[name] = pump
        self._g_consumers.set(len(self.pumps))
        return pump

    def remove_consumer(self, name: str) -> None:
        pump = self.pumps.pop(name)
        pump.flush()
        self._g_consumers.set(len(self.pumps))
        self._release()

    # -- lifecycle (the hub owns the shared tail's hook) --

    def attach(self) -> None:
        if not self._attached:
            self.tail.attach()
            self._attached = True

    def detach(self) -> None:
        if self._attached:
            self.tail.detach()
            self._attached = False

    # -- stream progress --

    def pump(self, budget_ops: int = 8) -> int:
        """One bounded turn per consumer; returns total ops streamed.
        Never blocks, never touches the commit path (the per-consumer
        CdcPump contract, N times over)."""
        total = 0
        for pump in self.pumps.values():
            total += pump.pump(budget_ops=budget_ops)
        self._release()
        return total

    def _release(self) -> None:
        if not self.pumps:
            return
        slowest = min(p.next_op for p in self.pumps.values())
        self.tail.release_below(slowest)
        self._g_lag.set(
            max(0, self.replica.cdc_commit_min - slowest + 1)
        )

    def flush(self) -> None:
        """Shutdown: every consumer's cursor to its streamed head, every
        sink flushed."""
        for pump in self.pumps.values():
            pump.flush()

    def close(self) -> None:
        self.flush()
        for pump in self.pumps.values():
            pump.sink.close()

    def lag_ops(self) -> dict[str, int]:
        """Per-consumer distance from the finalized watermark (tests /
        the [stats] line)."""
        head = self.replica.cdc_commit_min
        return {
            name: max(0, head - p.next_op + 1)
            for name, p in self.pumps.items()
        }
