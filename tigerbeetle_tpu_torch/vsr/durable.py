"""Single-replica durability: WAL-before-commit + checkpointed device state.

The reference's two-level durability (SURVEY.md §5.4; reference:
src/vsr/journal.zig WAL, src/vsr/replica.zig:3489-3561 checkpoint chain):

1. Every prepare is durable in the WAL BEFORE the state machine executes it.
2. Every `checkpoint_interval` ops, the full ledger state is snapshotted:
   the device tables copy to the host and write to the grid zone (ping-ponged by
   sequence parity), THEN the superblock durably records the new
   checkpoint op + blob references — state first, mark second, exactly the
   reference's ordering, so a crash between the two recovers from the
   PREVIOUS checkpoint + WAL replay.

Recovery = superblock quorum open -> load snapshot blobs into device state
-> journal scan -> replay prepares (checkpoint_op, head] through the same
kernels. Replay is deterministic: the hazard tracker's admission state is
part of the snapshot, so tier selection repeats identically.

This is the durability seam the VSR replica builds on; with replica_count=1
it IS the `format`/`start` lifecycle of the process (reference:
src/tigerbeetle/main.zig:54-60).

The port's copy of `tigerbeetle_tpu/vsr/durable.py`. Its device branch
copies the port's int32 / int64 leaves to and from the host with the same
bits (`convert.state_to_numpy` / `state_from_numpy`): the blobs are the
uint32 tables and the meta the uint64 counters, as the JAX package writes
them, so either package restores the other's checkpoint. The copies report
into the ledger's metrics registry (`durable.checkpoint_d2h_us`,
`durable.checkpoint_write_us`, `durable.restore_read_us`,
`durable.restore_upload_us`).
"""

from __future__ import annotations

import dataclasses
from time import perf_counter_ns

import numpy as np

from tigerbeetle_tpu_torch import native
from tigerbeetle_tpu_torch.convert import state_from_numpy, state_to_numpy
from tigerbeetle_tpu_torch.constants import (
    ConfigCluster,
    ConfigProcess,
    DEFAULT_CLUSTER,
    DEFAULT_PROCESS,
)
from tigerbeetle_tpu_torch.io.storage import Storage, Zone
from tigerbeetle_tpu_torch.metrics import NULL_METRICS
from tigerbeetle_tpu_torch.models.ledger import DeviceLedger, init_state
from tigerbeetle_tpu_torch.state_machine import StateMachine
from tigerbeetle_tpu_torch.types import Operation
from tigerbeetle_tpu_torch.vsr.header import Command, Header
from tigerbeetle_tpu_torch.vsr.journal import Journal
from tigerbeetle_tpu_torch.vsr.superblock import BlobRef, SuperBlock, VSRState

SNAPSHOT_LEAVES = ("acct_rows", "xfer_rows", "fulfill")
# Checkpoint blobs that are replica HOST state, not ledger state: they
# ride the same grid area / sync-shipping machinery but the ledger
# restore skips them (the replica reads its own back by name). Today:
# the many-session client table (ingress mode), which at 10k+ sessions
# overflows the 64 KiB superblock copy it used to inline into.
HOST_BLOBS = frozenset({"client_table"})
COUNTER_LEAVES = (
    "commit_ts", "acct_count", "xfer_count",
    "acct_used_slots", "xfer_used_slots",
)


def format_data_file(storage: Storage, cluster: ConfigCluster = DEFAULT_CLUSTER,
                     cluster_id: int = 0, replica: int = 0) -> None:
    """Create a fresh data file: superblock sequence 1, empty WAL
    (reference: src/vsr/replica_format.zig)."""
    sb = SuperBlock(storage)
    sb.checkpoint(VSRState(
        cluster=cluster_id, replica=replica, sequence=1,
        meta={"config_fingerprint": str(cluster.fingerprint())},
    ))


def check_config_fingerprint(state, cluster: ConfigCluster) -> None:
    """Mixed-config guard (reference: src/config.zig:167-179): refuse to
    open a data file formatted with different consensus-affecting
    constants."""
    want = state.meta.get("config_fingerprint")
    if want is not None and int(want) != cluster.fingerprint():
        raise RuntimeError(
            "data file was formatted with a different cluster config "
            "(consensus-affecting constants differ) — refusing to start"
        )


def snapshot_to_superblock(
    storage: Storage,
    ledger: DeviceLedger,
    sm: StateMachine,
    superblock: SuperBlock,
    commit_min: int,
    commit_min_checksum: int,
    extra_meta: dict | None = None,
    extra_blobs: list[tuple[str, bytes]] | None = None,
) -> None:
    """Checkpoint the ledger state: blobs to the grid zone (ping-ponged by
    sequence parity), THEN the superblock records them — state first, mark
    second (reference: src/vsr/replica.zig:3489-3561 ordering). Shared by
    the single-replica DurableLedger and the VSR Replica."""
    state = superblock.state
    assert state is not None
    sequence = state.sequence + 1
    # Explicit ping-pong: blobs go to the OTHER area than the live
    # checkpoint's (sequence numbers may advance without blob writes — view
    # persistence — so parity alone would not alternate correctly).
    area = 1 - state.area
    area_size = storage.layout.snapshot_area_size
    base = area * area_size

    carry = {  # format-time identity survives every checkpoint
        k: state.meta[k]
        for k in ("config_fingerprint",)
        if k in state.meta
    }
    blobs: list[BlobRef] = []
    off = base
    # backend seam: device ledger snapshots its device leaves as blobs; any
    # backend with snapshot_bytes (native engine, dual follower, sharded
    # ledger) snapshots one opaque blob
    if hasattr(ledger, "state") and not hasattr(ledger, "snapshot_bytes"):
        m = getattr(ledger, "metrics", NULL_METRICS)
        t0 = perf_counter_ns()
        dev = state_to_numpy({
            k: ledger.state[k] for k in SNAPSHOT_LEAVES + COUNTER_LEAVES + ("fault",)
        })
        t1 = perf_counter_ns()
        m.histogram("durable.checkpoint_d2h_us").observe((t1 - t0) / 1000.0)
        for name in SNAPSHOT_LEAVES:
            data = dev[name].tobytes()
            assert off + len(data) <= base + area_size, "grid area overflow"
            storage.write(Zone.grid, off, data)
            blobs.append(BlobRef(name, off, len(data), native.checksum(data)))
            off += (len(data) + 4095) // 4096 * 4096
        m.histogram("durable.checkpoint_write_us").observe(
            (perf_counter_ns() - t1) / 1000.0
        )
        h = ledger.hazards
        meta = {
            "counters": {k: int(dev[k]) for k in COUNTER_LEAVES},
            "fault": int(dev["fault"]),
            "acct_used": ledger._acct_used,
            "xfer_used": ledger._xfer_used,
            "amount_sum": str(h.amount_sum),  # may exceed u64: JSON as str
            "limit_account_ids": [str(x) for x in sorted(h.limit_account_ids)],
            **carry,
            **(extra_meta or {}),
        }
        if getattr(ledger, "spill", None) is not None:
            # flush the LSM backing store and record its manifest + the
            # spilled-id set (models/spill.py checkpoint contract); the
            # forest's grid blocks are durable before storage.sync() below
            meta["spill"] = ledger.spill.checkpoint_meta()
        assert meta["fault"] == 0, "refusing to checkpoint a faulted ledger"
    else:  # oracle / native / sharded backend: one opaque blob
        data = ledger.snapshot_bytes()
        assert off + len(data) <= base + area_size, "grid area overflow"
        storage.write(Zone.grid, off, data)
        blobs.append(BlobRef("oracle", off, len(data), native.checksum(data)))
        off += (len(data) + 4095) // 4096 * 4096
        meta = {"fault": 0, **carry, **(extra_meta or {})}
    # host-state blobs (e.g. a many-session client table too large for
    # the 64 KiB superblock copy): same area, same checksum discipline;
    # restore_from_snapshot skips them (HOST_BLOBS) — the replica reads
    # its own back via the superblock's refs
    for name, data in extra_blobs or ():
        assert name in HOST_BLOBS, name
        assert off + len(data) <= base + area_size, "grid area overflow"
        storage.write(Zone.grid, off, data)
        blobs.append(BlobRef(name, off, len(data), native.checksum(data)))
        off += (len(data) + 4095) // 4096 * 4096
    storage.sync()  # blobs durable before the superblock points at them

    superblock.checkpoint(VSRState(
        cluster=state.cluster,
        replica=state.replica,
        sequence=sequence,
        commit_min=commit_min,
        commit_min_checksum=commit_min_checksum,
        commit_max=commit_min,
        prepare_timestamp=sm.prepare_timestamp,
        area=area,
        blobs=blobs,
        meta=meta,
    ))


def persist_view(superblock: SuperBlock, view: int, log_view: int) -> None:
    """Durably record view participation WITHOUT a state snapshot (blob refs
    carry over; the grid areas are untouched). VSR requires the view to be
    durable before voting/acking in it — otherwise a crash-restart could
    regress and form an intersecting quorum in an abandoned view."""
    state = superblock.state
    assert state is not None
    meta = dict(state.meta)
    meta["view"] = view
    meta["log_view"] = log_view
    superblock.checkpoint(
        dataclasses.replace(state, sequence=state.sequence + 1, meta=meta)
    )


def restore_from_snapshot(
    storage: Storage,
    ledger: DeviceLedger,
    sm: StateMachine,
    process: ConfigProcess,
    state: VSRState,
) -> None:
    """Load a checkpoint back into the ledger backend (inverse of
    snapshot_to_superblock; fresh state when the superblock has no blobs)."""
    if hasattr(ledger, "restore_bytes"):  # oracle/native/sharded backend
        for ref in state.blobs:
            if ref.name in HOST_BLOBS:
                continue  # replica host state, not ledger state
            if ref.name != "oracle":
                raise RuntimeError(
                    f"checkpoint blob {ref.name!r} was written by the DEVICE "
                    "backend; this replica is running the native/oracle "
                    "backend — restart with --backend device (or re-format)"
                )
            raw = storage.read(Zone.grid, ref.offset, ref.size)
            if native.checksum(raw) != ref.checksum:
                raise RuntimeError(f"snapshot blob {ref.name}: bad checksum")
            ledger.restore_bytes(raw)
        sm.prepare_timestamp = state.prepare_timestamp
        return

    m = getattr(ledger, "metrics", NULL_METRICS)
    dev = init_state(process, ledger.device)
    if state.blobs:
        t_read = t_upload = 0
        for ref in state.blobs:
            if ref.name in HOST_BLOBS:
                continue  # replica host state, not ledger state
            if ref.name == "oracle":
                raise RuntimeError(
                    "checkpoint blob was written by the native/oracle "
                    "backend; this replica is running the DEVICE backend — "
                    "restart with --backend native (or re-format)"
                )
            t0 = perf_counter_ns()
            raw = storage.read(Zone.grid, ref.offset, ref.size)
            if native.checksum(raw) != ref.checksum:
                raise RuntimeError(f"snapshot blob {ref.name}: bad checksum")
            host = np.frombuffer(raw, dtype=np.uint32).reshape(
                tuple(dev[ref.name].shape)
            )
            t1 = perf_counter_ns()
            del dev[ref.name]  # free the fresh leaf before its upload
            dev.update(state_from_numpy({ref.name: host}, ledger.device))
            t_read += t1 - t0
            t_upload += perf_counter_ns() - t1
        m.histogram("durable.restore_read_us").observe(t_read / 1000.0)
        m.histogram("durable.restore_upload_us").observe(t_upload / 1000.0)
        counters = state.meta["counters"]
        # .get: checkpoints from before a counter existed restore as 0
        dev.update(state_from_numpy(
            {k: np.uint64(int(counters.get(k, 0))) for k in COUNTER_LEAVES},
            ledger.device,
        ))
        ledger._acct_used = int(state.meta["acct_used"])
        ledger._xfer_used = int(state.meta["xfer_used"])
        h = ledger.hazards
        h.amount_sum = int(state.meta["amount_sum"])
        h.limit_account_ids = {int(x) for x in state.meta["limit_account_ids"]}
        h._limit_lo = np.sort(
            np.array(
                [int(x) & ((1 << 64) - 1) for x in state.meta["limit_account_ids"]],
                dtype=np.uint64,
            )
        )
        if "spill" in state.meta:
            if getattr(ledger, "spill", None) is None:
                raise RuntimeError(
                    "checkpoint has spilled LSM state but the ledger was "
                    "constructed without a forest: restoring would silently "
                    "lose every spilled transfer — pass forest= to "
                    "DeviceLedger"
                )
            ledger.spill.restore(state.meta["spill"])
    ledger.state = dev
    sm.prepare_timestamp = state.prepare_timestamp


class DurableLedger:
    """The durable single-replica process around the device ledger, on
    `device` ("cuda" when None: the ledger raises where CUDA is missing;
    "cpu" runs the kernels' plain versions)."""

    def __init__(
        self,
        storage: Storage,
        cluster: ConfigCluster = DEFAULT_CLUSTER,
        process: ConfigProcess = DEFAULT_PROCESS,
        mode: str = "auto",
        device=None,
    ):
        self.storage = storage
        self.cluster = cluster
        self.process = process
        # With a forest block area in the layout, the ledger spills its
        # cold transfer tail to an LSM forest in the grid zone's tail
        # (models/spill.py); checkpoints then persist the forest manifest
        # + spilled-id set in the superblock meta.
        self.forest = None
        if storage.layout.forest_blocks:
            from tigerbeetle_tpu_torch.lsm.grid import Grid
            from tigerbeetle_tpu_torch.lsm.groove import Forest

            self.forest = Forest(Grid(
                storage,
                offset=storage.layout.forest_offset,
                block_count=storage.layout.forest_blocks,
            ), memtable_max=getattr(process, "lsm_memtable_max", 2048))
        self.ledger = DeviceLedger(process, mode=mode, device=device,
                                   forest=self.forest)
        self.sm = StateMachine(self.ledger, cluster.message_size_max)
        self.journal = Journal(storage, cluster)
        self.superblock = SuperBlock(storage)
        self.op = 0  # latest prepared+committed op (single replica: equal)
        self.parent_checksum = 0  # prepare hash chain
        self.checkpoint_op = 0

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def open(self) -> None:
        """Superblock quorum -> snapshot restore -> WAL replay."""
        state = self.superblock.open()
        check_config_fingerprint(state, self.cluster)
        self._restore_snapshot(state)
        self.checkpoint_op = state.commit_min
        self.op = state.commit_min
        self.parent_checksum = state.commit_min_checksum
        # Replay the WAL tail in op order through the same kernels.
        recovered = self.journal.recover()
        op = state.commit_min + 1
        while op in recovered:
            header, body = self.journal.read_prepare(op)  # type: ignore
            assert header.parent == self.parent_checksum, (
                f"hash chain break at op {op}"
            )
            operation = Operation(header.operation)
            self.sm.prepare(operation, body)
            assert self.sm.prepare_timestamp == header.timestamp, (
                "replay timestamp drift"
            )
            self.sm.commit(operation, header.timestamp, body)
            self.parent_checksum = header.checksum
            self.op = op
            op += 1

    # ------------------------------------------------------------------
    # the request path (reference: WAL-before-commit invariant)
    # ------------------------------------------------------------------

    def submit(self, operation: Operation, body: bytes) -> bytes:
        """Durably log, then execute; returns the wire reply body."""
        if operation in (Operation.create_accounts, Operation.create_transfers):
            op = self.op + 1
            # WAL wrap guard: never overwrite an un-checkpointed slot
            # (reference: src/vsr.zig:2003-2035 keeps a bar of headroom).
            if op - self.checkpoint_op >= self.cluster.checkpoint_interval:
                self.checkpoint()
            self.sm.prepare(operation, body)
            header = Header(
                parent=self.parent_checksum,
                cluster=self.superblock.state.cluster if self.superblock.state else 0,
                op=op,
                commit=self.op,
                timestamp=self.sm.prepare_timestamp,
                command=int(Command.prepare),
                operation=int(operation),
            )
            header.set_checksum_body(body)
            header.set_checksum()
            self.journal.write_prepare(header, body)  # durable BEFORE commit
            reply = self.sm.commit(operation, header.timestamp, body)
            self.parent_checksum = header.checksum
            self.op = op
            return reply
        # Lookups don't prepare (read-only; reference: lookups still go
        # through consensus for linearizability — the replica layer does
        # that; single-replica reads are trivially linearizable).
        return self.sm.commit(operation, self.sm.prepare_timestamp, body)

    # ------------------------------------------------------------------
    # checkpoint (state first, superblock second)
    # ------------------------------------------------------------------

    def checkpoint(self) -> None:
        snapshot_to_superblock(
            self.storage, self.ledger, self.sm, self.superblock,
            commit_min=self.op, commit_min_checksum=self.parent_checksum,
        )
        self.checkpoint_op = self.op

    def _restore_snapshot(self, state: VSRState) -> None:
        restore_from_snapshot(
            self.storage, self.ledger, self.sm, self.process, state
        )
