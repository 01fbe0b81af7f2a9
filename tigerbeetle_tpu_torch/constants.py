"""Configuration constants the device ledger and its LSM backing store need
(the counterpart of `tigerbeetle_tpu/constants.py`, cut to what this package
uses).

Table capacities are in slots, powers of two; the wire sizes follow the
reference (src/constants.zig:167-168, src/config.zig:137). ConfigCluster
sizes the storage zones under the LSM forest (io/storage.py ZoneLayout).
"""

from __future__ import annotations

import dataclasses
import os

# Intensive online-verification tier (reference: src/constants.zig:592):
# TB_VERIFY=1 turns on the LSM level-invariant audit after every compaction
# (lsm/tree.py). Read at check time, so tests may set it directly.
VERIFY = os.environ.get("TB_VERIFY", "0") == "1"

U64_MAX = (1 << 64) - 1
U128_MAX = (1 << 128) - 1

NS_PER_S = 1_000_000_000

HEADER_SIZE = 128
MESSAGE_SIZE_MAX = 1 << 20  # 1 MiB
MESSAGE_BODY_SIZE_MAX = MESSAGE_SIZE_MAX - HEADER_SIZE
ACCOUNT_SIZE = 128
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
class ConfigCluster:
    """The consensus-affecting constants that size the storage zones under
    the LSM forest (reference: src/config.zig:130-144), with the JAX
    package's defaults, so that a ZoneLayout and its grid offsets come out
    the same in both packages."""

    message_size_max: int = MESSAGE_SIZE_MAX
    journal_slot_count: int = 1024
    clients_max: int = 32
    # durable reply slots; 0 = clients_max
    client_reply_slots: int = 0
    block_size: int = 1 << 17  # 128 KiB grid blocks

    @property
    def reply_slot_count(self) -> int:
        return self.client_reply_slots or self.clients_max


@dataclasses.dataclass(frozen=True)
class ConfigProcess:
    """Per-replica table geometry (reference: src/config.zig:73-121)."""

    account_slots_log2: int = 20  # 1M account slots
    transfer_slots_log2: int = 24  # 16.7M transfer slots


DEFAULT_CLUSTER = ConfigCluster()
DEFAULT_PROCESS = ConfigProcess()
# Small configs for tests (reference: src/config.zig:232-272 test_min).
TEST_CLUSTER = ConfigCluster(journal_slot_count=64)
TEST_PROCESS = ConfigProcess(account_slots_log2=10, transfer_slots_log2=12)
