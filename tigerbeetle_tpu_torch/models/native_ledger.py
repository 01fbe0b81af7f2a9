"""NativeLedger: ctypes wrapper over the repo's C++ ledger engine
(native/ledger.cc), the counterpart of
`tigerbeetle_tpu/models/native_ledger.py`.

The reference's state machine is a CPU engine (reference:
src/state_machine.zig:612-1077). The native engine computes reply codes at
host speed with exact result-code parity against the device ledger; the
dual-commit follower (models/dual_ledger.py) answers every request with it
while the port's device ledger applies the same committed ops.

Implements the backend protocol the replica and StateMachine drive:
prepare / execute_async / drain / drain_reply / lookup_rows /
snapshot_bytes / restore_bytes, plus the fused group execute and the state
fingerprint.
"""

from __future__ import annotations

import ctypes
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np

from tigerbeetle_tpu_torch import native, types
from tigerbeetle_tpu_torch.types import Operation


class _NativePending:
    """Pending handle for a commit running on the engine worker thread
    (ctypes releases the GIL during tb_ledger_execute, so the event loop
    keeps receiving/journaling batch N+1 while batch N executes — the
    replica's commit-stage overlap, reference: src/vsr/replica.zig:52-70).
    Commits stay serial: ONE worker, FIFO."""

    __slots__ = ("operation", "n", "codes", "failures", "results", "group",
                 "summary", "dense", "fut", "arr")

    def __init__(self, operation, n, codes, fut, arr):
        self.operation = operation
        self.n = n
        self.codes = codes  # np.uint32 dense result codes (filled by fut)
        self.fut: Future = fut  # resolves to the failure count
        self.arr = arr  # keeps the zero-copy event rows alive until done
        self.failures = None
        self.results = None
        self.group = None
        self.summary = None
        self.dense = None

    def is_ready(self) -> bool:
        return self.fut.done()

    def wait(self) -> None:
        if self.failures is None:
            self.failures = int(self.fut.result())
            self.arr = None
            assert self.failures >= 0, "tb_ledger_execute: invalid arguments"


class NativeLedger:
    process = None  # no device table geometry (Replica backend duck-typing)
    zero_copy_events = True  # engine only reads event rows (no defensive copy)

    def __init__(self, acct_slots_log2: int = 16, xfer_slots_log2: int = 20):
        self._lib = native.lib()
        self._h = self._lib.tb_ledger_new(acct_slots_log2, xfer_slots_log2)
        assert self._h
        self.prepare_timestamp = 0
        # ONE worker = serial commits in submission order; lookups ride the
        # same queue so reads see every prior commit (linearizable at the
        # engine seam).
        self._executor: ThreadPoolExecutor | None = None

    def _submit(self, fn, *args) -> Future:
        if self._executor is None:
            self._executor = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="native-ledger"
            )
        return self._executor.submit(fn, *args)

    def __del__(self):
        try:
            ex = getattr(self, "_executor", None)
            if ex is not None:
                ex.shutdown(wait=True)
            h = getattr(self, "_h", None)
            if h:
                self._lib.tb_ledger_free(h)
                self._h = None
        except Exception:
            pass  # interpreter teardown: modules may already be gone

    # -- lifecycle (oracle-compatible) --

    def prepare(self, operation: Operation, event_count: int) -> None:
        if operation in (Operation.create_accounts, Operation.create_transfers):
            self.prepare_timestamp += event_count

    # -- execution --

    def _events_bytes(self, operation, events) -> tuple[bytes, int]:
        # ndarray inputs never reach here: execute_async takes the
        # zero-copy pointer path for them
        if events and not isinstance(events[0], (bytes, bytearray)):
            arr = (
                types.accounts_to_np(events)
                if operation == Operation.create_accounts
                else types.transfers_to_np(events)
            )
            return arr.tobytes(), len(arr)
        raw = b"".join(events) if events else b""
        return raw, len(raw) // 128

    def execute_async(self, operation, timestamp: int, events) -> _NativePending:
        arr = None
        if isinstance(events, np.ndarray):
            arr = np.ascontiguousarray(events)  # zero-copy pass-through
            n = len(arr)
            raw = arr.ctypes.data_as(ctypes.c_char_p)
        else:
            raw, n = self._events_bytes(operation, events)
        codes = np.empty(n, dtype=np.uint32)
        fut = self._submit(
            self._lib.tb_ledger_execute,
            self._h, int(operation), raw, n, timestamp,
            codes.ctypes.data_as(ctypes.c_void_p),
        )
        return _NativePending(operation, n, codes, fut, arr if arr is not None else raw)

    GROUP_MAX = 16  # fused prepares per worker call (mirrors Replica.GROUP_MAX)

    def try_execute_group_async(self, items) -> list[_NativePending] | None:
        """Fused commit: a run of quorum-ready create_transfers prepares
        executed by ONE worker-queue call (one GIL release + one FIFO hop
        instead of k), preserving exact per-batch semantics — each batch
        keeps its own timestamp and dense codes. `items` =
        [(timestamp, transfer_rows_ndarray), ...]. The group seam the
        device backend exposes for kernel fusion serves here to amortize
        the per-submit overhead of the host engine (reference pipelining:
        src/vsr/replica.zig:3263-3315)."""
        k = len(items)
        if k < 2:
            return None
        # never truncate silently: callers zip the returned pendings with
        # their items — a shorter list would drop batches without a trace
        assert k <= self.GROUP_MAX, (k, self.GROUP_MAX)
        arrs = [np.ascontiguousarray(a) for _, a in items]
        codes = [np.empty(len(a), dtype=np.uint32) for a in arrs]
        fails = np.full(k, -1, dtype=np.int64)
        ns = (ctypes.c_uint32 * k)(*[len(a) for a in arrs])
        tss = (ctypes.c_uint64 * k)(*[int(ts) for ts, _ in items])
        ptrs = (ctypes.c_void_p * k)(*[a.ctypes.data for a in arrs])
        outs = (ctypes.c_void_p * k)(*[c.ctypes.data for c in codes])
        keepalive = (arrs, codes, fails, ns, tss, ptrs, outs)

        def _run():
            rc = self._lib.tb_ledger_execute_group(
                self._h, int(Operation.create_transfers), ptrs, ns, tss, k,
                outs, fails.ctypes.data_as(ctypes.c_void_p),
            )
            assert rc == 0, "tb_ledger_execute_group: invalid arguments"
            return keepalive

        gfut = self._submit(_run)
        pendings = []
        for j in range(k):
            f: Future = Future()

            def _chain(gf, j=j, f=f):
                if gf.exception() is not None:
                    f.set_exception(gf.exception())
                else:
                    f.set_result(int(fails[j]))

            gfut.add_done_callback(_chain)
            pendings.append(_NativePending(
                Operation.create_transfers, len(arrs[j]), codes[j], f, arrs[j]
            ))
        return pendings

    def fingerprint(self) -> dict:
        """Order-independent digest of the live table contents (rides the
        worker queue: sees every prior commit). Matches the DeviceLedger's
        state_fingerprint iff the logical row sets are bit-identical — the
        dual-commit verification seam."""
        out = np.zeros(8, dtype=np.uint64)
        self._submit(
            self._lib.tb_ledger_fingerprint,
            self._h, out.ctypes.data_as(ctypes.c_void_p),
        ).result()
        return {
            "accounts_fp": int(out[0]),
            "transfers_fp": int(out[1]),
            "accounts": int(out[2]),
            "transfers": int(out[3]),
            "posted": int(out[4]),
            "commit_timestamp": int(out[5]),
        }

    def drain(self, pending: _NativePending) -> list[int]:
        pending.wait()
        if pending.dense is None:
            pending.dense = [int(x) for x in pending.codes]
        return pending.dense

    def drain_many(self, pendings) -> None:
        for p in pendings:
            if p is not None:
                p.wait()

    def drain_reply(self, pending: _NativePending, operation) -> bytes:
        pending.wait()
        if not pending.failures:
            return b""
        from tigerbeetle_tpu_torch.state_machine import encode_sparse_results

        return encode_sparse_results(pending.codes, operation)

    def execute_dense(self, operation, timestamp: int, events) -> list[int]:
        return self.drain(self.execute_async(operation, timestamp, events))

    def execute(self, operation, timestamp: int, events) -> list[tuple[int, int]]:
        dense = self.execute_dense(operation, timestamp, events)
        return [(i, c) for i, c in enumerate(dense) if c]

    # -- lookups --

    def lookup_rows(self, operation: Operation, ids: list[int]) -> bytes:
        n = len(ids)
        raw = np.zeros(2 * n, dtype=np.uint64)
        for i, x in enumerate(ids):
            raw[2 * i] = x & 0xFFFFFFFFFFFFFFFF
            raw[2 * i + 1] = x >> 64
        out = np.empty(n * 128, dtype=np.uint8)
        # ride the engine worker queue: the read sees every prior commit
        found = self._submit(
            self._lib.tb_ledger_lookup,
            self._h, int(operation), raw.tobytes(), n,
            out.ctypes.data_as(ctypes.c_void_p),
        ).result()
        return out[: found * 128].tobytes()

    def lookup_accounts(self, ids) -> list[types.Account]:
        body = self.lookup_rows(Operation.lookup_accounts, list(ids))
        arr = np.frombuffer(body, dtype=types.ACCOUNT_DTYPE)
        return [types.Account.from_np(arr[i]) for i in range(len(arr))]

    def lookup_transfers(self, ids) -> list[types.Transfer]:
        body = self.lookup_rows(Operation.lookup_transfers, list(ids))
        arr = np.frombuffer(body, dtype=types.TRANSFER_DTYPE)
        return [types.Transfer.from_np(arr[i]) for i in range(len(arr))]

    # -- counters --

    @property
    def commit_timestamp(self) -> int:
        return self.counts()["commit_timestamp"]

    def counts(self) -> dict:
        out = np.zeros(4, dtype=np.uint64)
        self._submit(
            self._lib.tb_ledger_counts,
            self._h, out.ctypes.data_as(ctypes.c_void_p),
        ).result()
        return {
            "accounts": int(out[0]),
            "transfers": int(out[1]),
            "posted": int(out[2]),
            "commit_timestamp": int(out[3]),
        }

    # -- checkpoint blobs (the replica's oracle-backend snapshot path) --

    def snapshot_bytes(self) -> bytes:
        def _snap():
            size = self._lib.tb_ledger_snapshot_size(self._h)
            buf = ctypes.create_string_buffer(size)
            self._lib.tb_ledger_snapshot(self._h, buf)
            return buf.raw

        return self._submit(_snap).result()

    def restore_bytes(self, raw: bytes) -> None:
        rc = self._submit(
            self._lib.tb_ledger_restore, self._h, raw, len(raw)
        ).result()
        assert rc == 0, "tb_ledger_restore: truncated snapshot"
