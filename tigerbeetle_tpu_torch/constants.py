"""Configuration constants the device ledger needs (the counterpart of
`tigerbeetle_tpu/constants.py`, cut to what this package uses).

Table capacities are in slots, powers of two; the wire sizes follow the
reference (src/constants.zig:167-168, src/config.zig:137).
"""

from __future__ import annotations

import dataclasses

U64_MAX = (1 << 64) - 1
U128_MAX = (1 << 128) - 1

NS_PER_S = 1_000_000_000

HEADER_SIZE = 128
MESSAGE_SIZE_MAX = 1 << 20  # 1 MiB
MESSAGE_BODY_SIZE_MAX = MESSAGE_SIZE_MAX - HEADER_SIZE
TRANSFER_SIZE = 128

# (1 MiB - 128 B) / 128 B = 8191 events per batch; the reference benchmark
# sends 8190 (src/benchmark.zig:52-59).
BATCH_MAX = MESSAGE_BODY_SIZE_MAX // TRANSFER_SIZE
assert BATCH_MAX == 8191
BENCH_BATCH = 8190
# The JAX package pads every batch to this static shape; the port launches
# exactly n lanes and keeps the constant for callers that size buffers.
BATCH_PAD = 8192


@dataclasses.dataclass(frozen=True)
class ConfigProcess:
    """Per-replica table geometry (reference: src/config.zig:73-121)."""

    account_slots_log2: int = 20  # 1M account slots
    transfer_slots_log2: int = 24  # 16.7M transfer slots


DEFAULT_PROCESS = ConfigProcess()
# Small geometry for tests (reference: src/config.zig:232-272 test_min).
TEST_PROCESS = ConfigProcess(account_slots_log2=10, transfer_slots_log2=12)
