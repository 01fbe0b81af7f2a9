"""StateMachine: the wire-facing execution interface the VSR layer drives.

The analog of the reference's StateMachine lifecycle
(reference: src/state_machine.zig:336-540 prepare/commit and :208-214 the
operation enum): one entry point accepts an operation (128-131) plus the
prepare's body bytes, and returns the reply body bytes in the reference's
wire encoding:

- create_accounts / create_transfers: sparse ``{index: u32, result: u32}``
  result structs, only non-ok entries, chain rollbacks in FIFO order
  (reference: src/tigerbeetle.zig:231-249, src/state_machine.zig:612-698).
- lookup_accounts / lookup_transfers: the found objects' 128-byte wire rows,
  in request order, missing ids skipped (reference:
  src/state_machine.zig:701-736).

The counterpart of `tigerbeetle_tpu/state_machine.py`. The backend is
anything with the ledger driver API (execute_dense / execute_async / drain /
prepare / lookup_*; device backends also expose lookup_rows and the group
commit, try_execute_group_async / drain_many): here the port's DeviceLedger,
on a CUDA card or on the CPU, or its DualLedger (the native engine answers,
the device ledger follows).
"""

from __future__ import annotations

import numpy as np

from tigerbeetle_tpu_torch import types
from tigerbeetle_tpu_torch.constants import HEADER_SIZE, MESSAGE_SIZE_MAX
from tigerbeetle_tpu_torch.types import (
    ACCOUNT_DTYPE,
    CREATE_ACCOUNTS_RESULT_DTYPE,
    CREATE_TRANSFERS_RESULT_DTYPE,
    TRANSFER_DTYPE,
    Operation,
)

ID_SIZE = 16  # lookup request: packed little-endian u128 ids
EVENT_SIZE = 128
RESULT_SIZE = 8

_EVENT_DTYPES = {
    Operation.create_accounts: ACCOUNT_DTYPE,
    Operation.create_transfers: TRANSFER_DTYPE,
}
_RESULT_DTYPES = {
    Operation.create_accounts: CREATE_ACCOUNTS_RESULT_DTYPE,
    Operation.create_transfers: CREATE_TRANSFERS_RESULT_DTYPE,
}


def encode_results(sparse: list[tuple[int, int]], operation: Operation) -> bytes:
    """Sparse (index, result) pairs -> reply body bytes (reference:
    src/tigerbeetle.zig:231-249)."""
    out = np.zeros(len(sparse), dtype=_RESULT_DTYPES[operation])
    for i, (index, result) in enumerate(sparse):
        out[i]["index"] = index
        out[i]["result"] = result
    return out.tobytes()


def encode_sparse_results(codes: np.ndarray, operation: Operation) -> bytes:
    """Dense u32 codes -> sparse non-ok reply body, vectorized (reference:
    src/tigerbeetle.zig:231-249). Shared by the device and native
    backends' drain_reply."""
    idx = np.nonzero(codes)[0]
    out = np.zeros(len(idx), dtype=_RESULT_DTYPES[operation])
    out["index"] = idx.astype(np.uint32)
    out["result"] = codes[idx]
    return out.tobytes()


def decode_results(body: bytes, operation: Operation) -> list[tuple[int, int]]:
    assert len(body) % RESULT_SIZE == 0, len(body)
    arr = np.frombuffer(body, dtype=_RESULT_DTYPES[operation])
    return [(int(r["index"]), int(r["result"])) for r in arr]


def encode_ids(ids: list[int]) -> bytes:
    out = np.zeros(2 * len(ids), dtype=np.uint64)
    for i, x in enumerate(ids):
        lo, hi = types.split_u128(x)
        out[2 * i] = lo
        out[2 * i + 1] = hi
    return out.tobytes()


def decode_ids(body: bytes) -> list[int]:
    assert len(body) % ID_SIZE == 0, len(body)
    arr = np.frombuffer(body, dtype=np.uint64)
    return [types.join_u128(arr[2 * i], arr[2 * i + 1]) for i in range(len(arr) // 2)]


def decode_accounts(body: bytes) -> np.ndarray:
    assert len(body) % EVENT_SIZE == 0, len(body)
    return np.frombuffer(body, dtype=ACCOUNT_DTYPE).copy()


def decode_transfers(body: bytes) -> np.ndarray:
    assert len(body) % EVENT_SIZE == 0, len(body)
    return np.frombuffer(body, dtype=TRANSFER_DTYPE).copy()


class StateMachine:
    """Drives a ledger backend with wire-format bodies.

    Lifecycle mirrors the reference (src/state_machine.zig:336-540):
      count = sm.input_count(op, body)   # body validation / batch sizing
      sm.prepare(op, count)              # advances prepare_timestamp
      reply = sm.commit(op, timestamp, body)
    """

    def __init__(self, backend, message_size_max: int = MESSAGE_SIZE_MAX):
        self.backend = backend
        self.message_size_max = message_size_max

    # -- body validation & batch sizing --

    def batch_max(self, operation: Operation) -> int:
        """Per-op batch max = body_size_max / max(event_size, result_size)
        (reference: src/state_machine.zig:59-64 operation_batch_max) — the
        REPLY must fit in one message too, which is what bounds lookups
        (16-byte id events but 128-byte object results)."""
        body_max = self.message_size_max - HEADER_SIZE
        event = EVENT_SIZE if operation in _EVENT_DTYPES else ID_SIZE
        result = RESULT_SIZE if operation in _EVENT_DTYPES else EVENT_SIZE
        return body_max // max(event, result)

    def input_valid(self, operation: Operation, body: bytes) -> bool:
        if operation in _EVENT_DTYPES:
            event_size = EVENT_SIZE
        elif operation in (Operation.lookup_accounts, Operation.lookup_transfers):
            event_size = ID_SIZE
        else:
            return False
        if len(body) == 0 or len(body) % event_size != 0:
            return False
        return len(body) // event_size <= self.batch_max(operation)

    def input_count(self, operation: Operation, body: bytes) -> int:
        assert self.input_valid(operation, body)
        size = (
            EVENT_SIZE
            if operation in _EVENT_DTYPES
            else ID_SIZE
        )
        return len(body) // size

    def prepare(self, operation: Operation, body: bytes) -> None:
        self.backend.prepare(operation, self.input_count(operation, body))

    @property
    def prepare_timestamp(self) -> int:
        return self.backend.prepare_timestamp

    @prepare_timestamp.setter
    def prepare_timestamp(self, value: int) -> None:
        self.backend.prepare_timestamp = value

    # -- commit: wire body in, wire reply out --

    def commit_async(self, operation: Operation, timestamp: int, body: bytes):
        """Dispatch a commit WITHOUT materializing results (the device
        launch is queued; results stay on device). Returns a handle for
        commit_finish. Only create ops are truly asynchronous; lookups are
        reads and compute their reply inline (the handle is the bytes).
        This is the replica's commit-stage overlap seam (reference:
        src/vsr/replica.zig:3045-3103 commit_dispatch stages)."""
        if operation not in _EVENT_DTYPES or not hasattr(
            self.backend, "execute_async"
        ):
            return self.commit(operation, timestamp, body)  # reads / oracle
        if getattr(self.backend, "zero_copy_events", False):
            # the backend only reads the rows: skip the 1 MiB defensive copy
            events = np.frombuffer(body, dtype=_EVENT_DTYPES[operation])
        else:
            events = (
                decode_accounts(body)
                if operation == Operation.create_accounts
                else decode_transfers(body)
            )
        return (operation, self.backend.execute_async(operation, timestamp, events))

    @staticmethod
    def handle_plan(handle):
        """The backend's wave-planner decision for a commit_async handle:
        (decision, wave_count), e.g. ("waves", 3), or None when the backend
        has no planner, the op was not a create, or the batch was part of a
        fused group."""
        if isinstance(handle, bytes):
            return None
        return getattr(handle[1], "plan", None)

    def commit_group_async(self, operation: Operation, batches):
        """Fuse consecutive create_transfers commits into one device
        dispatch (group commit). `batches` = [(timestamp, body), ...].
        Returns a list of commit_async-compatible handles, or None when
        fusion does not apply: callers then commit batch by batch."""
        if operation != Operation.create_transfers or len(batches) < 2:
            return None
        if not hasattr(self.backend, "try_execute_group_async"):
            return None
        # read-only views (no 1 MiB copy per batch): the group path only
        # reads the rows into its staging buffer
        items = [
            (ts, np.frombuffer(body, dtype=TRANSFER_DTYPE))
            for ts, body in batches
        ]
        pendings = self.backend.try_execute_group_async(items)
        if pendings is None:
            return None
        return [(operation, p) for p in pendings]

    def commit_finish_many(self, handles) -> None:
        """Materialize several commit_async handles at once (see
        DeviceLedger.drain_many); the commit_finish calls after it read the
        cached results."""
        pendings = [h[1] for h in handles if not isinstance(h, bytes)]
        if pendings and hasattr(self.backend, "drain_many"):
            self.backend.drain_many(pendings)

    def commit_finish(self, handle) -> bytes:
        """Materialize a commit_async handle into the reply body bytes."""
        if isinstance(handle, bytes):
            return handle
        operation, pending = handle
        if hasattr(self.backend, "drain_reply"):
            # vectorized sparse encoding; empty for all-success without
            # materializing dense codes at all
            return self.backend.drain_reply(pending, operation)
        dense = self.backend.drain(pending)
        return encode_results(
            [(i, c) for i, c in enumerate(dense) if c], operation
        )

    def commit(self, operation: Operation, timestamp: int, body: bytes) -> bytes:
        if operation == Operation.create_accounts:
            events = decode_accounts(body)
            dense = self.backend.execute_dense(operation, timestamp, events)
            return encode_results(
                [(i, c) for i, c in enumerate(dense) if c], operation
            )
        if operation == Operation.create_transfers:
            events = decode_transfers(body)
            dense = self.backend.execute_dense(operation, timestamp, events)
            return encode_results(
                [(i, c) for i, c in enumerate(dense) if c], operation
            )
        if operation in (Operation.lookup_accounts, Operation.lookup_transfers):
            ids = decode_ids(body)
            if hasattr(self.backend, "lookup_rows"):  # device backends:
                return self.backend.lookup_rows(operation, ids)  # raw wire rows
            found = (
                self.backend.lookup_accounts(ids)
                if operation == Operation.lookup_accounts
                else self.backend.lookup_transfers(ids)
            )
            if operation == Operation.lookup_accounts:
                return types.accounts_to_np(found).tobytes()
            return types.transfers_to_np(found).tobytes()
        raise AssertionError(operation)
