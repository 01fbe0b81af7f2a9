"""Cluster/process configuration constants.

Mirrors the reference's two-tier comptime config (reference: src/config.zig:130-144
ConfigCluster, :73-121 ConfigProcess; derived values src/constants.zig). Cluster
values are consensus-affecting and must match across replicas; process values are
per-replica tuning knobs. The port's copy of `tigerbeetle_tpu/constants.py`:
the same fields and defaults, so that a config's fingerprint, a ZoneLayout
and its grid offsets come out the same in both packages.
"""

from __future__ import annotations

import dataclasses
import os

# Intensive online-verification tier (reference: src/constants.zig:592
# `constants.verify` compiles extra invariant checks into hot paths).
# TB_VERIFY=1 enables: LSM level-invariant audits after every compaction,
# journal read-after-write verification, replica hash-chain re-checks at
# commit, and periodic conservation audits in the oracle state machine.
# Tests may also toggle `constants.VERIFY` directly; hot paths read it at
# check time, not import time.
VERIFY = os.environ.get("TB_VERIFY", "0") == "1"

U64_MAX = (1 << 64) - 1
U128_MAX = (1 << 128) - 1

NS_PER_S = 1_000_000_000

# --- wire sizes (reference: src/constants.zig:167-168, src/config.zig:137) ---
HEADER_SIZE = 128
MESSAGE_SIZE_MAX = 1 << 20  # 1 MiB
MESSAGE_BODY_SIZE_MAX = MESSAGE_SIZE_MAX - HEADER_SIZE

ACCOUNT_SIZE = 128
TRANSFER_SIZE = 128

# The max batch size: (1 MiB - 128 B) / 128 B = 8191 in this snapshot
# (reference: src/state_machine.zig:46-65 operation_batch_max,
# src/benchmark.zig:52-59 @divExact). Note BASELINE.md's benchmark protocol
# quotes batch=8190; BENCH_BATCH follows the protocol, BATCH_MAX the formula.
BATCH_MAX = MESSAGE_BODY_SIZE_MAX // TRANSFER_SIZE
assert BATCH_MAX == 8191
BENCH_BATCH = 8190

# The JAX package pads every batch to this static shape; the port launches
# exactly n lanes and keeps the constant for callers that size buffers.
BATCH_PAD = 8192
assert BATCH_PAD >= BATCH_MAX


@dataclasses.dataclass(frozen=True)
class ConfigCluster:
    """Consensus-affecting constants (reference: src/config.zig:130-144)."""

    cluster_id: int = 0
    replica_count: int = 1
    message_size_max: int = MESSAGE_SIZE_MAX
    journal_slot_count: int = 1024
    clients_max: int = 32
    # Durable reply slots (client_replies zone), decoupled from
    # clients_max for the ingress gateway's many-session mode: each slot
    # costs message_size_max on disk, so 10k+ multiplexed sessions cannot
    # each own one. 0 = clients_max (every session gets a slot — the
    # pre-ingress behavior). Sessions beyond the slot count register with
    # slot=None: their duplicate requests after a restart fall back to
    # the reply-lost paths instead of replaying cached reply bytes.
    client_reply_slots: int = 0
    pipeline_prepare_queue_max: int = 8
    view_change_headers_suffix_max: int = 8 + 1
    quorum_replication_max: int = 3
    block_size: int = 1 << 17  # 128 KiB grid blocks
    lsm_levels: int = 7
    lsm_growth_factor: int = 8
    lsm_batch_multiple: int = 64  # ops per "bar" (checkpoint interval unit)

    @property
    def batch_max(self) -> int:
        return (self.message_size_max - HEADER_SIZE) // TRANSFER_SIZE

    @property
    def reply_slot_count(self) -> int:
        return self.client_reply_slots or self.clients_max

    @property
    def checkpoint_interval(self) -> int:
        # reference: src/vsr.zig:2003-2035 Checkpoint arithmetic.
        return self.journal_slot_count - self.lsm_batch_multiple

    def fingerprint(self) -> int:
        """Checksum of the consensus-affecting constants. Stored in the
        superblock at format and verified on open, so replicas built with
        mismatched cluster configs cannot silently join one cluster
        (reference: src/config.zig:167-179 cluster-config checksum)."""
        import json

        from tigerbeetle_tpu_torch import native

        payload = json.dumps(dataclasses.asdict(self), sort_keys=True)
        return native.checksum(payload.encode())


@dataclasses.dataclass(frozen=True)
class ConfigProcess:
    """Per-replica tuning (reference: src/config.zig:73-121)."""

    tick_ms: int = 10
    # Device table capacities (slots; power of two). The analog of the
    # reference's cache_entries_accounts/transfers + grid cache: here the
    # full working store is resident in device memory.
    account_slots_log2: int = 20  # 1M account slots
    transfer_slots_log2: int = 24  # 16.7M transfer slots
    # Sequential-repair scan capacity for the hybrid kernel (Tier B).
    repair_slots: int = 1024
    journal_iops_read_max: int = 8
    journal_iops_write_max: int = 8
    # LSM forest mutable-table budget (rows buffered before a flush packs
    # them into grid blocks; reference: table_memory sizing via config).
    lsm_memtable_max: int = 2048


DEFAULT_CLUSTER = ConfigCluster()
DEFAULT_PROCESS = ConfigProcess()

# Small configs for tests/simulator (reference: src/config.zig:232-272 test_min).
TEST_CLUSTER = ConfigCluster(journal_slot_count=64, lsm_batch_multiple=4)
TEST_PROCESS = ConfigProcess(account_slots_log2=10, transfer_slots_log2=12)
