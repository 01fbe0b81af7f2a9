"""Change-data-capture: durable change streams over the committed op log.

The reference ships a CDC runner (`tigerbeetle amqp`, src/cdc/runner.zig)
that tails the committed double-entry history and publishes change events
downstream without ever stalling the state machine. This package is that
subsystem for the TPU build:

- `record`: the change-record encoder — per-transfer/per-account records
  with exact result codes and balance deltas, derived from the committed
  prepare plus the reply buffer the replica already materialized (no new
  device->host transfer anywhere in the pipeline);
- `cursor`: the durable per-consumer cursor — an atomic write-rename file
  (superblock-style: checksummed payload, torn writes read as absent)
  storing `(op, checksum)` so redelivery is dedupable: the at-least-once
  contract;
- `sink`: pluggable delivery — JSONL file, in-memory (tests/simulator),
  UDP datagrams (reusing the statsd MTU batching), and a non-blocking
  throttle wrapper that models a deliberately slow consumer;
- `pump`: `CdcPump` — tails live commits via the replica's `cdc_hook`
  with a bounded in-flight window, degrades to WAL-ring reads when the
  window overflows, and cold-starts/resumes by replaying the AOF through
  the scalar oracle (parity-locked with the device engines, so replayed
  result codes are exact). Backpressure pauses the PUMP, never the
  replica: a refusing sink simply stops stream progress and `cdc.lag_ops`
  grows.

Delivery semantics: at-least-once, in op order, gap-free up to the WAL
ring (beyond it the AOF is the backfill source; a state-synced replica
declares the ops it never executed as an explicit `gap` record instead of
skipping them silently).
"""

from tigerbeetle_tpu_torch.cdc.cursor import FileCursor, MemoryCursor
from tigerbeetle_tpu_torch.cdc.pump import AofReplaySource, CdcPump
from tigerbeetle_tpu_torch.cdc.record import encode_batch, gap_record, record_line
from tigerbeetle_tpu_torch.cdc.sink import (
    CountThrottleSink,
    JsonlFileSink,
    MemorySink,
    StdoutSink,
    ThrottleSink,
    UdpSink,
)

__all__ = [
    "AofReplaySource",
    "CdcPump",
    "CountThrottleSink",
    "FileCursor",
    "JsonlFileSink",
    "MemoryCursor",
    "MemorySink",
    "StdoutSink",
    "ThrottleSink",
    "UdpSink",
    "encode_batch",
    "gap_record",
    "record_line",
]
