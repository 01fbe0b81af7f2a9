"""The device ledger's bounded-memory story: spill to the LSM forest.

The counterpart of `tigerbeetle_tpu/models/spill.py`. The device ledger's
transfer table is a capacity-bounded hash table on the card
(models/ledger.py); the reference's store is an unbounded LSM forest with a
residency-guaranteed in-memory cache (reference: src/lsm/groove.zig:602-760
prefetch contract; src/lsm/cache_map.zig:10-25 CacheMap residency). This
module closes that gap:

- The device table is the CacheMap: every row a batch can touch is resident
  BEFORE the kernels run, so the kernels stay pure and data-parallel.
- The LSM forest (lsm/groove.py over the grid) is the backing store: when
  the table's occupancy reaches the spill trigger, the OLDEST transfers
  spill to the forest (timestamp order: the reference's object trees are
  timestamp-keyed for this access pattern) and the table is rebuilt with
  only the hot tail. Rebuilding also sheds rollback tombstones, so a cycle
  resets probe-chain density to the live load.
- Before every commit, the host checks the batch's id and pending_id
  references against the spilled-id set (a sorted lo-limb prefilter plus
  the exact set: the host analog of the reference's per-table bloom
  filters, src/lsm/bloom_filter.zig) and RELOADS referenced spilled rows
  into the table. This is the prefetch contract: after admit(), the
  kernels' lookups are equivalent to lookups against the full store.

The pipeline around the cycle: the prefetch of an upcoming batch's spilled
rows runs on the IO executor (`prefetch_async`), the LSM multi-point reads
are batched per tree (lsm/tree.py Tree.get_many), and the reload staging
buffers double-buffer against the card (pinned host memory, a
non-blocking upload and a CUDA event as the reuse fence). The IO worker
touches host data only: it never makes a CUDA call.

The device side is K10 (`SpillKernels`): the cycle head (live count and
fault), the cold/hot split (a select of the timestamp watermark and a
stable partition of the live slots into two lists), the row gather, and
the reload (probe, claim, all-or-nothing gate, scatter). Each has a plain
PyTorch version here (`spill_*_plain`), which the wrappers run for CPU
tensors; for CUDA tensors they launch the kernels of `csrc/spill_split.cu`
and `csrc/spill_reload.cu`. The rebuild's slot placement depends on the
chunking (CHUNK rows a reload, ascending slot order, the claim rule), and
slot placement is state, so the chunking is the JAX package's; the rebuild
reloads all its chunks in one call (`spill_reload_chunks`, one launch on a
card), each as one reload. The gather is not chunked: a cycle gathers
each side in one call (the JAX cycle gathers CHUNK windows because XLA
wants one compiled shape), the cold side into a kept device staging buffer
whose chunks are copied to the host in the JAX package's order, the hot
side padded to whole chunks, whose slices feed the reloads.

Accounts do not spill: account rows are the working set of every batch
(debit/credit balance updates), and the reference's workload is a bounded
account population with an unbounded transfer history (10k accounts, 10M+
transfers). The account table's guard stays hard.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import torch

from tigerbeetle_tpu_torch import kernels as _k
from tigerbeetle_tpu_torch import types
from tigerbeetle_tpu_torch.metrics import Metrics
from tigerbeetle_tpu_torch.models.ledger import (
    FAULT_CAPACITY,
    FAULT_CLAIM,
    FAULT_PROBE,
    _check_device,
    raise_on_fault,
)
from tigerbeetle_tpu_torch.models.validate import F_POST, F_VOID
from tigerbeetle_tpu_torch.ops import hashtable as ht
from tigerbeetle_tpu_torch.ops import u128
from tigerbeetle_tpu_torch.tracer import NULL_TRACER

I32 = torch.int32
I64 = torch.int64
ROW_WORDS = 32

CHUNK = 8192  # rows a reload moves and a host copy stages (the JAX package's BATCH_PAD)
KEEP_FRAC = 0.25  # share of the live rows a cycle keeps in the table
U64_MAX_I64 = -1  # 0xFFFF_FFFF_FFFF_FFFF as an int64 value


# ----------------------------------------------------------------------
# the IO executor seam (reference: ALL storage IO rides one event loop off
# the replica's hot path, src/io/linux.zig:17-42). Two implementations:
#
# - ThreadedSpillIO (production): ONE worker thread, FIFO — the insert
#   order is deterministic, and LSM insertion/compaction truly overlaps
#   the caller's commits in wall time.
# - DeferredSpillIO (deterministic harnesses — the VSR replica, cluster
#   tests, the simulator): jobs queue and run inline at pump()/drain() on
#   the caller's thread, so seeded runs never depend on thread timing,
#   while the commit dispatch path still never executes LSM insertion —
#   jobs run at the event loop's tick boundary (Replica.tick pumps).
#   Grid-block ALLOCATION order stays identical to the threaded executor's
#   (same FIFO job order), which is what cross-replica repair-by-address
#   depends on.
# ----------------------------------------------------------------------


class ThreadedSpillIO:
    """Single-worker FIFO executor: real async IO for wall-clock overlap."""

    settle_in_worker = True  # jobs may settle trees (raises surface at drain)

    def __init__(self):
        self._ex = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="spill-io"
        )
        self._jobs: list[Future] = []

    def submit(self, fn, *args) -> Future:
        f = self._ex.submit(fn, *args)
        self._jobs.append(f)
        return f

    def drain(self) -> None:
        """Barrier: wait for EVERY queued job even when an earlier one
        raised — dropping the tail would let a healed-and-retried caller
        read trees the worker is still mutating. The first exception
        surfaces after the whole queue has settled."""
        jobs, self._jobs = self._jobs, []
        err = None
        for f in jobs:
            try:
                f.result()
            except BaseException as e:
                if err is None:
                    err = e
        if err is not None:
            raise err

    def pump(self) -> None:
        """Reap finished jobs (surfacing their exceptions) without
        blocking on the ones still running. Finished jobs are evicted
        BEFORE any exception propagates — a failed job must raise once,
        not on every subsequent pump."""
        keep, finished = [], []
        for f in self._jobs:
            (keep if not f.done() else finished).append(f)
        self._jobs = keep
        err = None
        for f in finished:
            try:
                f.result()
            except BaseException as e:
                if err is None:
                    err = e
        if err is not None:
            raise err

    def wait(self, fut: Future):
        return fut.result()

    def pending(self) -> int:
        return len(self._jobs)


class DeferredSpillIO:
    """Deterministic executor: jobs queue and run inline at pump()/drain()
    — off the commit dispatch path, with zero thread timing. Jobs here
    must be pure pending-appends (settle_in_worker=False): a
    GridBlockCorrupt raised from a tick-boundary pump would have no
    heal-and-retry context, so settles stay in admit's _settle_forest,
    where the replica's repair path catches them."""

    settle_in_worker = False

    def __init__(self):
        self._q: deque = deque()

    def submit(self, fn, *args) -> Future:
        f: Future = Future()
        self._q.append((f, fn, args))
        return f

    def _run_one(self) -> None:
        f, fn, args = self._q.popleft()
        try:
            r = fn(*args)
        except BaseException as e:
            f.set_exception(e)
            raise
        f.set_result(r)

    def pump(self) -> None:
        while self._q:
            self._run_one()

    drain = pump

    def wait(self, fut: Future):
        while self._q and not fut.done():
            self._run_one()
        return fut.result()

    def pending(self) -> int:
        return len(self._q)


def _make_io(io: str):
    if io == "threaded":
        return ThreadedSpillIO()
    if io == "deferred":
        return DeferredSpillIO()
    raise ValueError(f"spill IO must be 'threaded' or 'deferred', not {io!r}")


# ----------------------------------------------------------------------
# K10: the spill kernels' plain versions and wrappers
# ----------------------------------------------------------------------


def spill_ts_occ_plain(rows):
    """Per-slot (timestamp, live) of a transfer table: words 30-31 as u64
    bits in int64, and the occupied mask with the dump row (the last)
    cleared; the cycle's scan (`SpillKernels._ts_occ`)."""
    occ = ht.occupied_mask(rows)
    occ[-1] = False
    ts = (rows[:, 30].to(I64) & 0xFFFFFFFF) | (rows[:, 31].to(I64) << 32)
    return ts, occ


def spill_head_plain(rows, fault):
    """Plain version of K10's cycle head (`SpillKernels._cycle_head`):
    int32 [2] = [live count, fault word], the only words the cycle reads
    back before it decides the split."""
    _, occ = spill_ts_occ_plain(rows)
    return torch.stack([occ.sum().to(I32), fault.reshape(())])


def spill_head(rows, fault, cap_log2: int):
    """K10 cycle head wrapper: the plain version for CPU tensors, the CUDA
    kernel else."""
    if _check_device(rows):
        return _k.spill_head(rows, fault, cap_log2)
    return spill_head_plain(rows, fault)


def spill_split_plain(rows, n_cold: int):
    """Plain version of K10's split (`SpillKernels._split_idx`): the
    watermark is the n_cold-th smallest (0-based) masked timestamp (u64 max
    for dead slots and the dump row, compared unsigned); cold = live slots
    below it, hot = the other live slots; each an int32 index list in slot
    order, padded with the dump slot to capacity + CHUNK entries."""
    ts, occ = spill_ts_occ_plain(rows)
    dump = rows.shape[0] - 1
    ts_m = torch.where(occ, ts, U64_MAX_I64)
    watermark = (torch.sort(ts_m ^ u128.SIGN).values[n_cold] ^ u128.SIGN).item()
    below = u128.ult(ts_m, watermark)
    size = dump + CHUNK
    out = []
    for sel in (occ & below, occ & ~below):
        hits = torch.nonzero(sel).squeeze(1)
        idx = torch.full((size,), dump, dtype=I32, device=rows.device)
        idx[:hits.shape[0]] = hits.to(I32)
        out.append(idx)
    return out[0], out[1]


def spill_split(rows, cap_log2: int, n_cold: int):
    """K10 split wrapper: the plain version for CPU tensors, the CUDA kernel
    else."""
    if _check_device(rows):
        return _k.spill_split(rows, cap_log2, n_cold)
    return spill_split_plain(rows, n_cold)


def spill_gather_plain(rows, fulfill, idx):
    """Plain version of K10's gather (`SpillKernels._gather`): the rows and
    fulfill words at the slots `idx`."""
    return rows[idx], fulfill[idx]


def spill_gather(rows, fulfill, idx, out=None):
    """K10 gather wrapper: the plain version for CPU tensors, the CUDA
    kernel else (one launch for the whole of `idx`). With `out`, a pair of
    [B, 32] and [B] int32 tensors, the rows and words go there."""
    if _check_device(rows):
        return _k.spill_gather(rows, fulfill, idx, out)
    got = spill_gather_plain(rows, fulfill, idx)
    if out is None:
        return got
    out[0].copy_(got[0])
    out[1].copy_(got[1])
    return out


def spill_reload_plain(tbl, rows_b, ful_b, active, cap_log2: int):
    """Plain version of K10's reload (`SpillKernels._reload`): insert the
    stored rows `rows_b` (with their fulfill words `ful_b`) of the `active`
    lanes whose key is not resident into the transfer table of `tbl` (a
    dict with xfer_rows, fulfill, xfer_claim, xfer_used_slots and fault), in
    place, verbatim. The chunk is all or nothing: an active lane's
    unresolved probe (FAULT_PROBE), a lane with no slot (FAULT_CLAIM) or
    used_slots + new rows above half the slots (FAULT_CAPACITY) set the
    sticky fault word, and any fault, earlier ones included, leaves the
    table as it was. Returns the probe word (int32 0-d): (u32)used_slots ^
    fault, which nothing else consumes."""
    rows = tbl["xfer_rows"]
    key4 = rows_b[:, :4]
    _, found, res = ht.lookup(key4, rows, cap_log2)
    need = active & ~found
    slots, ins_res = ht.claim_slots(key4, need, rows, tbl["xfer_claim"], cap_log2)
    n_new = need.sum()
    cap_bad = u128.ult((1 << cap_log2) // 2, tbl["xfer_used_slots"] + n_new)
    fault = tbl["fault"] | (
        (active & ~res).any().to(I32) * FAULT_PROBE
        | (~ins_res).any().to(I32) * FAULT_CLAIM
        | cap_bad.to(I32) * FAULT_CAPACITY
    )
    tbl["fault"].copy_(fault)
    if int(fault) == 0:
        w = slots[need]
        rows[w] = rows_b[need]
        tbl["fulfill"][w] = ful_b[need]
        tbl["xfer_used_slots"] += n_new
    return (tbl["xfer_used_slots"] & 0xFFFFFFFF).to(I32) ^ tbl["fault"]


def spill_reload(tbl, rows_b, ful_b, active, cap_log2: int):
    """K10 reload wrapper: the plain version for CPU tensors, the CUDA
    kernel else."""
    if _check_device(rows_b):
        return _k.spill_reload(tbl, rows_b, ful_b, active, cap_log2)
    return spill_reload_plain(tbl, rows_b, ful_b, active, cap_log2)


def spill_reload_chunks_plain(tbl, rows_b, ful_b, n: int, cap_log2: int, chunk: int = CHUNK):
    """Plain version of the rebuild's reloads (the JAX cycle's chunk loop
    over `SpillKernels._reload`): the first `n` rows of `rows_b` (fulfill
    words `ful_b`) in chunks of `chunk` rows, in order, each chunk one
    `spill_reload_plain` on its slice with the lanes below its length
    active. A chunk after a fault still probes and claims and ORs its bits
    into the fault word, and writes nothing. Returns the last probe word
    (that of the table as it stands where n is 0)."""
    lane = torch.arange(chunk, device=rows_b.device)
    probe = (tbl["xfer_used_slots"] & 0xFFFFFFFF).to(I32) ^ tbl["fault"]
    for start in range(0, n, chunk):
        k = min(chunk, n - start)
        part = rows_b[start : start + chunk]
        probe = spill_reload_plain(tbl, part, ful_b[start : start + chunk],
                                   lane[:part.shape[0]] < k, cap_log2)
    return probe


def spill_reload_chunks(tbl, rows_b, ful_b, n: int, cap_log2: int, chunk: int = CHUNK):
    """K10 rebuild wrapper: the plain chunk loop for CPU tensors, one launch
    of the CUDA kernel for all the chunks else."""
    if _check_device(rows_b):
        return _k.spill_reload_chunks(tbl, rows_b, ful_b, n, cap_log2, chunk)
    return spill_reload_chunks_plain(tbl, rows_b, ful_b, n, cap_log2, chunk)


class SpillKernels:
    """The spill cycle's device entry points, closed over the transfer
    table's geometry (the counterpart of the JAX `SpillKernels`)."""

    def __init__(self, process):
        self.t_log2 = process.transfer_slots_log2
        self.t_dump = 1 << self.t_log2

    def cycle_head(self, state):
        return spill_head(state["xfer_rows"], state["fault"], self.t_log2)

    def split_idx(self, rows, n_cold: int):
        return spill_split(rows, self.t_log2, n_cold)

    def gather(self, rows, fulfill, idx, out=None):
        return spill_gather(rows, fulfill, idx, out)

    def reload(self, tbl, rows_b, ful_b, active):
        return spill_reload(tbl, rows_b, ful_b, active, self.t_log2)

    def reload_chunks(self, tbl, rows_b, ful_b, n: int, chunk: int):
        return spill_reload_chunks(tbl, rows_b, ful_b, n, self.t_log2, chunk)


def fresh_table(t_log2: int, device) -> dict:
    """An empty transfer table with its columns and words: the rebuild's
    target."""
    cap1 = (1 << t_log2) + 1
    return {
        "xfer_rows": torch.zeros((cap1, ROW_WORDS), dtype=I32, device=device),
        "fulfill": torch.zeros(cap1, dtype=I32, device=device),
        "xfer_claim": torch.full((cap1,), ht.CLAIM_FREE, dtype=I32, device=device),
        "xfer_used_slots": torch.zeros((), dtype=I64, device=device),
        "fault": torch.zeros((), dtype=I32, device=device),
    }


class SpillManager:
    """Owns the spilled-id set, the LSM backing store, and the cycle.

    Attached to a DeviceLedger via ``DeviceLedger(forest=...)``; the ledger
    calls ``admit(arr, n)`` before every create_transfers commit and merges
    spilled rows into lookups/extract.
    """

    STAT_KEYS = (
        "cycles", "spilled", "reloaded",
        "t_scan", "t_gather_d2h", "t_stage",
        "t_rebuild", "t_reload", "t_lsm_worker",
        "prefetches", "prefetched",
        "t_prefetch_worker", "t_prefetch_wait",
        "lookup_batches", "lookup_ids",
    )

    def instrument(self, metrics, tracer) -> None:
        """Re-bind onto a shared registry/tracer (the replica's, or the
        bench's). Accumulated values carry over; the forest's trees
        and grid report into the same registry. A worker-side stat update
        racing the carry-over/rebind window lands in the discarded old
        group and is dropped from the new registry — at most one update,
        and instrument() runs at setup before IO jobs flow."""
        for key in self.STAT_KEYS:
            metrics.counter(f"spill.{key}").add(self.stats[key])
        self.metrics = metrics
        # rebound on the event loop while IO-worker jobs read per use —
        # a GIL-atomic reference swap (worst case one span lands in the
        # old tracer); registry counters serialize internally
        self.tracer = tracer  # vet: handoff
        self.stats = metrics.group("spill", self.STAT_KEYS)  # vet: handoff
        for tree in self.forest._trees():
            tree.metrics = metrics
            tree.tracer = tracer
        self.forest.grid.metrics = metrics

    def __init__(self, ledger, forest, io: str = "threaded"):
        self.ledger = ledger
        self.forest = forest
        self.kernels = SpillKernels(ledger.process)
        # ids present ONLY in the LSM store (reloading removes the id; the
        # stale LSM row is overwritten on the next spill of that id).
        self.spilled: set[int] = set()
        # Sorted lo-limb prefilter over `spilled` (may carry stale entries
        # between cycles; exactness comes from the set).
        self._lo = np.empty(0, dtype=np.uint64)
        # Grid block chain holding the checkpointed spilled-id set (the
        # set can exceed the superblock's copy size; only the addresses
        # ride the superblock meta — the trailer pattern, reference:
        # src/vsr/superblock.zig:31-34).
        self._id_chain: list[int] = []
        # t_* keys: cumulative seconds per cycle stage (the spill bench's
        # isolating artifact — which part of the cycle carries the bill).
        # Overlap accounting: t_prefetch_worker = executor seconds spent
        # gathering prefetched rows; t_prefetch_wait = seconds admit
        # BLOCKED on an unfinished prefetch (0 wait = the gather fully hid
        # behind the previous batch's commit). lookup_ids/lookup_batches =
        # multi-lookup amortization (mean ids per batched LSM read).
        # `stats` is a registry-backed Mapping (tigerbeetle_tpu/metrics.py
        # StatGroup under the `spill.` prefix): dict reads everywhere stay
        # valid, and instrument() re-binds the storage onto the replica's /
        # bench's shared registry so overlap_report and the [stats] line
        # read the same numbers.
        self.metrics = Metrics()
        self.tracer = NULL_TRACER
        self.stats = self.metrics.group("spill", self.STAT_KEYS)
        # the IO executor seam (see module docstring / ThreadedSpillIO vs
        # DeferredSpillIO)
        self._io = _make_io(io)
        # rows in flight to the LSM sit in _staged (id -> (row, ful));
        # fetches check _staged first and barrier on the executor before
        # any direct forest read
        self._staged: dict[int, tuple[np.ndarray, int]] = {}  # vet: guarded-by=_staged_lock
        self._staged_lock = threading.Lock()
        # one outstanding prefetch (consumed by the next reload) + its two
        # alternating host staging slots
        self._prefetch: dict | None = None
        self._pf_slots = {"i": 0, "slots": [None, None]}
        # double-buffered reload staging (pad -> two fenced slots)
        self._reload_slots: dict[int, dict] = {}
        # the cycle's pinned landing buffer for cold rows (grown, kept)
        self._gather_buf: dict | None = None
        self._gather_dev: dict | None = None

    # ------------------------------------------------------------------
    # the IO executor seam
    # ------------------------------------------------------------------

    def _io_submit(self, fn, *args) -> None:
        self._io.submit(fn, *args)

    def io_drain(self) -> None:
        """Barrier: every queued LSM job has run (and surfaced its
        exception, if any). After this the forest is safe to read inline —
        only the commit thread submits jobs, so none can appear while the
        caller holds the drained state."""
        self._io.drain()

    def io_pump(self) -> None:
        """Non-blocking housekeeping: run deferred jobs (DeferredSpillIO)
        or reap finished worker jobs (ThreadedSpillIO). The replica calls
        this at its tick boundary — LSM insertion then never runs inside
        the commit dispatch path."""
        self._io.pump()

    def io_pending(self) -> int:
        """Queued-but-undrained job count (the replica's scrub pass skips
        a turn while inserts are in flight rather than reading blocks the
        worker may be mid-writing)."""
        return self._io.pending()

    # ------------------------------------------------------------------
    # membership
    # ------------------------------------------------------------------

    def _prefilter(self, lo: np.ndarray) -> np.ndarray:
        """Lanes whose id lo-limb appears in the sorted prefilter."""
        if len(self._lo) == 0:
            return np.zeros(len(lo), dtype=bool)
        pos = np.searchsorted(self._lo, lo)
        pos_c = np.minimum(pos, len(self._lo) - 1)
        return self._lo[pos_c] == lo

    def referenced_spilled(self, arr: np.ndarray) -> list[int]:
        """Distinct spilled ids this batch references: its own ids (the
        exists/idempotency checks, reference: src/state_machine.zig:767-777,
        886-905) and post/void pending_id references (reference: :907-1014).
        """
        out: set[int] = set()
        if not self.spilled:
            return []
        cand = self._prefilter(arr["id_lo"])
        for i in np.nonzero(cand)[0]:
            key = int(arr["id_lo"][i]) | (int(arr["id_hi"][i]) << 64)
            if key in self.spilled:
                out.add(key)
        pv = (arr["flags"] & np.uint16(F_POST | F_VOID)) != 0
        if pv.any():
            cand = self._prefilter(arr["pending_id_lo"]) & pv
            for i in np.nonzero(cand)[0]:
                key = int(arr["pending_id_lo"][i]) | (
                    int(arr["pending_id_hi"][i]) << 64
                )
                if key in self.spilled:
                    out.add(key)
        return sorted(out)

    # ------------------------------------------------------------------
    # prefetch/commit overlap
    # ------------------------------------------------------------------

    @property
    def prefetch_enabled(self) -> bool:
        """True when prefetch_async can actually overlap (threaded
        executor) — callers gate side work (e.g. the backup's WAL peek)
        on this."""
        return self._io.settle_in_worker

    def _pf_slot(self, k: int) -> dict:
        """One of two alternating prefetch staging slots, grown to cover
        k rows. Only one prefetch is ever outstanding and its rows are
        copied out synchronously at consume time, so alternation alone
        keeps a lingering job from racing a fresh submission."""
        pool = self._pf_slots
        i = pool["i"]
        pool["i"] = 1 - i
        slot = pool["slots"][i]
        cap = _next_pow2(k)
        if slot is None or slot["cap"] < cap:
            slot = pool["slots"][i] = {
                "rows": np.zeros((cap, ROW_WORDS), dtype=np.uint32),
                "ful": np.zeros(cap, dtype=np.uint32),
                "cap": cap,
            }
        return slot

    def prefetch_async(self, arr: np.ndarray) -> None:
        """Start gathering the referenced-spilled rows of an UPCOMING
        batch on the IO executor: the id scan runs inline (cheap numpy —
        and `spilled` mutates only on the commit thread, so the scan must
        not move to the worker), the LSM point reads + row staging run as
        one FIFO job behind every queued insert (so no drain barrier is
        needed). The admit() that commits the batch consumes the staged
        rows; content is stable meanwhile because an id's LSM row can only
        change after a reload removes it from `spilled`, and reloads
        happen only in admit on this same thread.

        Threaded executors only: on DeferredSpillIO the job would run
        inline on this same thread (no overlap to win), and its
        read-triggered settle could raise GridBlockCorrupt at the tick
        pump — outside the admit context where the replica's
        heal-and-retry contract lives."""
        if not self.prefetch_enabled or not self.spilled:
            return
        pf = self._prefetch
        if pf is not None and not pf["fut"].done():
            return  # one outstanding prefetch; don't pile up slot reuse
        ids = self.referenced_spilled(arr)
        if not ids:
            return
        slot = self._pf_slot(len(ids))
        fut = self._io.submit(self._prefetch_job, ids, slot)
        self._prefetch = {
            "fut": fut,
            "rows": slot["rows"],
            "ful": slot["ful"],
            "by_id": {id_: j for j, id_ in enumerate(ids)},
        }
        self.stats.add("prefetches")

    def _prefetch_job(self, ids: list[int], slot: dict) -> None:
        t0 = time.perf_counter()
        with self.tracer.span("spill.prefetch_worker", ids=len(ids)):
            rows, ful = slot["rows"], slot["ful"]
            missing: list[tuple[int, int]] = []
            with self._staged_lock:
                for j, id_ in enumerate(ids):
                    hit = self._staged.get(id_)
                    if hit is not None:
                        rows[j] = hit[0]
                        ful[j] = hit[1]
                    else:
                        missing.append((j, id_))
            if missing:
                # FIFO position: every earlier insert already landed
                self._fetch_forest(missing, rows, ful)
            self.stats.add("t_prefetch_worker", time.perf_counter() - t0)

    def _consume_prefetch(self, ids, rows: np.ndarray,
                          ful: np.ndarray) -> list[tuple[int, int]]:
        """Fill rows/ful lanes served by the outstanding prefetch; returns
        the (lane, id) pairs it did not cover. Consumed once on any hit;
        a COMPLETE miss keeps it armed for a later batch (a caller may
        prefetch op N+1 before op N's own reload runs) — sound because a
        kept entry's id is still in `spilled` (only a reload that served
        it would have removed it), and an id's backing content is stable
        while spilled (see prefetch_async)."""
        pf = self._prefetch
        if pf is None:
            return list(enumerate(ids))
        by_id = pf["by_id"]
        if not any(id_ in by_id for id_ in ids):
            return list(enumerate(ids))  # foreign batch: keep it armed
        self._prefetch = None
        t0 = time.perf_counter()
        with self.tracer.span("spill.prefetch_wait"):
            # pump-aware (DeferredSpillIO runs inline)
            self._io.wait(pf["fut"])
        self.stats.add("t_prefetch_wait", time.perf_counter() - t0)
        prows, pful = pf["rows"], pf["ful"]
        remaining: list[tuple[int, int]] = []
        for i, id_ in enumerate(ids):
            j = by_id.get(id_)
            if j is None:
                remaining.append((i, id_))
            else:
                rows[i] = prows[j]
                ful[i] = pful[j]
                self.stats.add("prefetched")
        return remaining

    # ------------------------------------------------------------------
    # admission: called before every create_transfers commit
    # ------------------------------------------------------------------

    def admit(self, arr: np.ndarray, n: int) -> None:
        with self.tracer.span("spill.admit", n=n), \
                self.metrics.histogram("spill.admit_us").time():
            self._admit(arr, n)

    def _admit(self, arr: np.ndarray, n: int) -> None:
        led = self.ledger
        # Capacity to free: the CONSERVATIVE occupancy transient, not the
        # true row growth. True growth is <= n + n_pv (an event's own id
        # yields a fresh insert OR a reload-then-exists, never both), but
        # the ledger charges +n at dispatch and only reconciles at drain —
        # so between reload and drain the counter can read
        # reloads (<= n + n_pv) + n. `need` must cover that transient or
        # the hard load guard would raise on a batch that actually fits.
        n_pv = int(((arr["flags"] & np.uint16(F_POST | F_VOID)) != 0).sum())
        reload_ids = self.referenced_spilled(arr)
        if led._xfer_used + n + len(reload_ids) > led._xfer_limit:
            self.cycle(need=2 * n + n_pv)
            # the cycle may have spilled rows this batch references
            reload_ids = self.referenced_spilled(arr)
        if reload_ids:
            self._reload_rows(reload_ids)
        if not self._io.settle_in_worker:
            # deferred mode: discharge the deferred settles /
            # compaction debt HERE, after the cycle has committed (HBM
            # rebuilt, counters updated) — a GridBlockCorrupt raise from a
            # settle leaves the cycle done, so the replica's heal-and-retry
            # re-enters this admit with nothing to re-cycle and the settle
            # RESUMES
            self._settle_forest()

    def _settle_forest(self) -> None:
        """Discharge compaction debt and settle trees whose pending
        buffers crossed the size threshold, in the forest's fixed tree
        order (deterministic across replicas). Thresholded, not eager:
        settling every admit would write many tiny tables and churn the
        grid; below-threshold pendings settle lazily at reads/flush."""
        for tree in self.forest._trees():
            if (
                tree._compact_debt
                or tree._pending_rows >= tree.settle_max
            ):
                tree._settle()

    def _fetch(self, id_: int) -> tuple[bytes, int]:
        """One spilled row + fulfill byte: the in-flight staging area
        first (no barrier), then the LSM store (barrier: the queued
        inserts must land before a direct forest read)."""
        with self._staged_lock:
            hit = self._staged.get(id_)
        if hit is not None:
            return hit[0].tobytes(), hit[1]
        self.io_drain()
        g = self.forest.transfers
        ts_key = g.ids.get(g._id_key(id_))
        assert ts_key is not None, f"spilled id {id_} missing from LSM"
        row = g.objects.get(ts_key)
        assert row is not None
        ful = self.forest.posted.get(ts_key)
        return row, (ful[0] if ful else 0)

    def _fetch_forest(self, missing: list[tuple[int, int]],
                      rows: np.ndarray, ful: np.ndarray) -> None:
        """Resolve (lane, id) pairs against the forest with ONE vectorized
        multi-point-read per tree (IdTree -> ObjectTree -> posted) — the
        bloom/index amortization lives in Tree.get_many. Caller guarantees
        the forest is current (drained, or running ON the FIFO worker)."""
        g = self.forest.transfers
        ids_list = [id_ for _, id_ in missing]
        row_list, ts_keys = g.get_many_rows(ids_list)
        fuls = self.forest.posted.get_many(
            [t if t is not None else b"\x00" * 8 for t in ts_keys]
        )
        for (i, id_), row, tsk, f in zip(missing, row_list, ts_keys, fuls):
            assert tsk is not None and row is not None, (
                f"spilled id {id_} missing from LSM"
            )
            rows[i] = np.frombuffer(row, dtype=np.uint32)
            ful[i] = f[0] if f else 0
        self.stats.add("lookup_batches")
        self.stats.add("lookup_ids", len(missing))

    def _fetch_many(self, ids: list[int], rows: np.ndarray,
                    ful: np.ndarray) -> None:
        """Fill rows[:k]/ful[:k] for `ids`: prefetched rows first (no IO),
        then staged hits (no barrier), then ONE batched forest read after
        ONE io_drain."""
        remaining = self._consume_prefetch(ids, rows, ful)
        if not remaining:
            return
        missing: list[tuple[int, int]] = []
        with self._staged_lock:
            for i, id_ in remaining:
                hit = self._staged.get(id_)
                if hit is not None:
                    rows[i] = hit[0]
                    ful[i] = hit[1]
                else:
                    missing.append((i, id_))
        if not missing:
            return
        self.io_drain()
        self._fetch_forest(missing, rows, ful)

    def _reload_slot(self, pad: int) -> dict:
        """One of TWO alternating preallocated reload staging buffers per
        pad (the group commit's staging pattern, models/ledger.py
        _group_staging_slot): batch N+1's rows stage into buffer B while
        buffer A's upload and reload (batch N) may still run. On a card the
        buffers are pinned, the upload is non-blocking, and `fence` is a
        CUDA event recorded after the reload dispatched from the buffer:
        the buffer is written again only after it fired. `used` bounds the
        stale-tail zeroing."""
        pool = self._reload_slots
        entry = pool.get(pad)
        if entry is None:
            entry = pool[pad] = {"i": 0, "slots": [None, None]}
        i = entry["i"]
        entry["i"] = 1 - i
        slot = entry["slots"][i]
        if slot is None:
            pin = self.ledger.device.type == "cuda"
            rows = torch.zeros((pad, ROW_WORDS), dtype=I32, pin_memory=pin)
            ful = torch.zeros(pad, dtype=I32, pin_memory=pin)
            slot = entry["slots"][i] = {
                "rows_t": rows, "ful_t": ful,
                "rows": rows.numpy().view(np.uint32), "ful": ful.numpy().view(np.uint32),
                "used": 0, "fence": None,
            }
        if slot["fence"] is not None:
            with self.tracer.span("spill.staging_wait"), \
                    self.metrics.histogram("spill.staging_wait_us").time():
                slot["fence"].synchronize()
            slot["fence"] = None
        return slot

    def _reload_rows(self, ids: list[int]) -> None:
        t0 = time.perf_counter()
        led = self.ledger
        dev = led.device
        for start in range(0, len(ids), CHUNK):
            chunk = ids[start : start + CHUNK]
            k = len(chunk)
            pad = CHUNK if len(ids) > CHUNK else _next_pow2(k)
            slot = self._reload_slot(pad)
            rows, ful = slot["rows"], slot["ful"]
            if slot["used"] > k:  # zero only the stale tail
                rows[k : slot["used"]] = 0
                ful[k : slot["used"]] = 0
            slot["used"] = k
            self._fetch_many(chunk, rows, ful)
            active = torch.arange(pad, device=dev) < k
            self.kernels.reload(
                led.state,
                slot["rows_t"].to(dev, non_blocking=True),
                slot["ful_t"].to(dev, non_blocking=True),
                active,
            )
            if dev.type == "cuda":
                slot["fence"] = torch.cuda.Event()
                slot["fence"].record()
            for id_ in chunk:
                self.spilled.discard(id_)
            led._xfer_used += k
            self.stats.add("reloaded", k)
        self.stats.add("t_reload", time.perf_counter() - t0)

    def _stage_and_submit(self, rows: np.ndarray, ful: np.ndarray,
                          ids_lo: np.ndarray, ids_hi: np.ndarray,
                          ts_np: np.ndarray) -> None:
        """Stage one gathered cold chunk (rows visible to _fetch at once)
        and queue its LSM insertion on the IO worker. The job unstages
        only entries it staged itself (identity check): a later cycle may
        re-spill an id and overwrite the staged tuple before this job
        lands — its newer insert is FIFO-behind ours, so the LSM ends
        newest-wins either way."""
        k = len(rows)
        entries: dict[int, tuple] = {}
        with self._staged_lock:
            for i in range(k):
                key = int(ids_lo[i]) | (int(ids_hi[i]) << 64)
                tup = (rows[i], int(ful[i]))
                self._staged[key] = tup
                entries[key] = tup

        def job():
            t0 = time.perf_counter()
            # APPEND-THEN-SETTLE, always: the appends (settle=False) are
            # pure pending-appends that CANNOT raise, so every row and
            # fulfillment lands — and unstages — exactly once even when
            # the settle below trips GridBlockCorrupt. A raise then only
            # interrupts settling/compaction, which is resume-safe by the
            # _pending/_compact_debt contract (the next settle — a later
            # job, admit's _settle_forest, or the checkpoint flush —
            # resumes it); the old settle-inside-append ordering lost the
            # chunk's posted flags + unstage when a threaded worker raised
            # mid-insert and the tick pump routed the error to repair.
            g = self.forest.transfers
            g.insert_bulk(rows.view(np.uint8).reshape(k, 128), ts_np,
                          settle=False)
            nz = np.nonzero(ful)[0]
            if len(nz):
                self.forest.posted.put_array(
                    np.ascontiguousarray(
                        ts_np[nz].astype(">u8")
                    ).view(np.uint8).reshape(len(nz), 8),
                    ful[nz].astype(np.uint8).reshape(len(nz), 1),
                    settle=False,
                )
            with self._staged_lock:
                for key, tup in entries.items():
                    if self._staged.get(key) is tup:
                        del self._staged[key]
            # worker-thread seconds (accumulated under the stats lock's
            # coarse protection — a float add race would only smear stats)
            self.stats.add("t_lsm_worker", time.perf_counter() - t0)
            if self._io.settle_in_worker:
                # threaded mode settles on the worker; deferred mode
                # leaves it to admit's _settle_forest (heal-retry context)
                self._settle_forest()

        self._io_submit(job)

    # ------------------------------------------------------------------
    # the spill cycle
    # ------------------------------------------------------------------

    def cycle(self, need: int) -> None:
        """Spill the cold majority to the LSM forest and rebuild the HBM
        table with the hot tail, guaranteeing room for `need` new rows.
        A host-paced maintenance op (the analog of the reference's paced
        compaction beats trading throughput for bounded memory). The scan
        and cold/hot split run ON DEVICE (SpillKernels.cycle_head /
        split_idx): the host fetches two words, not the whole table."""
        with self.tracer.span("spill.cycle", need=need):
            self._cycle(need)

    def _gather_host(self, n: int) -> dict:
        """The cycle's host landing buffer for `n` cold rows, grown to a
        power of two and kept: pinned on a card, so the chunks' copies run
        asynchronously (each fenced by its own CUDA event)."""
        buf = self._gather_buf
        if buf is None or buf["cap"] < n:
            cap = _next_pow2(n)
            pin = self.ledger.device.type == "cuda"
            rows = torch.empty((cap, ROW_WORDS), dtype=I32, pin_memory=pin)
            ful = torch.empty(cap, dtype=I32, pin_memory=pin)
            buf = self._gather_buf = {"cap": cap, "rows": rows, "ful": ful}
        return buf

    def _gather_staging(self, n: int) -> dict:
        """The cycle's staging buffer on the ledger's device for `n` cold
        rows, grown to a power of two and kept: the cold side's one gather
        writes it, the chunks' copies to the host read it."""
        buf = self._gather_dev
        if buf is None or buf["cap"] < n:
            cap = _next_pow2(n)
            dev = self.ledger.device
            buf = self._gather_dev = {
                "cap": cap,
                "rows": torch.empty((cap, ROW_WORDS), dtype=I32, device=dev),
                "ful": torch.empty(cap, dtype=I32, device=dev),
            }
        return buf

    def _cycle(self, need: int) -> None:
        led = self.ledger
        st = led.state
        dev = led.device
        on_card = dev.type == "cuda"
        t0 = time.perf_counter()
        head = self.kernels.cycle_head(st).cpu().numpy().view(np.uint32)
        live, fault = int(head[0]), int(head[1])
        if fault:
            raise_on_fault(fault, "spill cycle")
        if led._xfer_limit - need < 0:
            raise RuntimeError(
                f"batch needs {need} transfer slots but the table limit is "
                f"{led._xfer_limit}: grow ConfigProcess.transfer_slots_log2"
            )
        keep = min(int(live * KEEP_FRAC), led._xfer_limit - need)
        n_cold = live - keep
        if n_cold <= 0:
            return  # nothing live to spill
        cold_idx, hot_idx = self.kernels.split_idx(st["xfer_rows"], n_cold)
        n_hot = live - n_cold
        self.stats.add("t_scan", time.perf_counter() - t0)
        t0 = time.perf_counter()

        # 1. Cold rows -> host. The d2h gather is synchronous (the spilled
        # set must be exact before the next admit()): one gather of the
        # whole cold side into the device staging buffer, then every
        # chunk's copy into the pinned landing buffer is enqueued, then
        # each chunk is staged as soon as its copy has landed. LSM insertion
        # is NOT synchronous: rows stage in _staged and the IO worker drains
        # them into the forest while commits continue (reference keeps all
        # storage IO off the replica's hot path, src/io/linux.zig:17-42).
        # The worker gets host copies; it never touches the card.
        host = self._gather_host(n_cold)
        staging = self._gather_staging(n_cold)
        rows_d, ful_d = self.kernels.gather(
            st["xfer_rows"], st["fulfill"], cold_idx[:n_cold],
            out=(staging["rows"][:n_cold], staging["ful"][:n_cold]),
        )
        landed = []
        for start in range(0, n_cold, CHUNK):
            k = min(CHUNK, n_cold - start)
            host["rows"][start : start + k].copy_(rows_d[start : start + k],
                                                  non_blocking=on_card)
            host["ful"][start : start + k].copy_(ful_d[start : start + k],
                                                 non_blocking=on_card)
            event = None
            if on_card:
                event = torch.cuda.Event()
                event.record()
            landed.append((start, k, event))
        rows_all = host["rows"].numpy().view(np.uint32)
        ful_all = host["ful"].numpy().view(np.uint32)
        for start, k, event in landed:
            if event is not None:
                event.synchronize()
            rows = rows_all[start : start + k].copy()
            ful = ful_all[start : start + k].copy()
            self.stats.add("t_gather_d2h", time.perf_counter() - t0)
            t0 = time.perf_counter()
            ids_lo = rows[:, 0].astype(np.uint64) | (
                rows[:, 1].astype(np.uint64) << np.uint64(32)
            )
            ids_hi = rows[:, 2].astype(np.uint64) | (
                rows[:, 3].astype(np.uint64) << np.uint64(32)
            )
            ts_np = rows[:, 30].astype(np.uint64) | (
                rows[:, 31].astype(np.uint64) << np.uint64(32)
            )
            self._stage_and_submit(rows, ful, ids_lo, ids_hi, ts_np)
            self.spilled.update(
                (int(lo) | (int(hi) << 64))
                for lo, hi in zip(ids_lo, ids_hi)
            )
            self.stats.add("spilled", k)
            self.stats.add("t_stage", time.perf_counter() - t0)
            t0 = time.perf_counter()

        # 2. Rebuild: a fresh table, the hot tail reinserted chunk by chunk
        #    in slot order (device to device; hot rows never visit the host).
        #    One gather of the hot side up to a whole number of chunks (the
        #    split pads its indices with the dump slot), then one call that
        #    reloads the chunks in order: the lanes the JAX cycle's chunks
        #    hold, one device launch on a card.
        new = fresh_table(self.kernels.t_log2, dev)
        n_pad = -(-n_hot // CHUNK) * CHUNK
        if n_pad:
            rows_h, ful_h = self.kernels.gather(st["xfer_rows"], st["fulfill"], hot_idx[:n_pad])
            self.kernels.reload_chunks(new, rows_h, ful_h, n_hot, CHUNK)
        new_fault = int(new["fault"])
        if new_fault:
            raise_on_fault(new_fault, "spill rebuild")
        # exactly four leaves change: xfer_count and fault stay as they were
        st["xfer_rows"] = new["xfer_rows"]
        st["fulfill"] = new["fulfill"]
        st["xfer_claim"] = new["xfer_claim"]
        st["xfer_used_slots"] = new["xfer_used_slots"]
        led._xfer_used = n_hot
        led._occupancy_epoch += 1
        self._lo = np.sort(
            np.array([x & ((1 << 64) - 1) for x in self.spilled], dtype=np.uint64)
        )
        self.stats.add("t_rebuild", time.perf_counter() - t0)
        self.stats.add("cycles")

    # ------------------------------------------------------------------
    # lookup / extract merging
    # ------------------------------------------------------------------

    def merge_lookup_rows(self, ids: list[int], found: np.ndarray,
                          rows: np.ndarray) -> bytes:
        """Reply body: wire rows in request order, HBM hits from the device
        lookup, spilled hits from the LSM store, misses skipped (_fetch
        barriers internally when it must read the forest)."""
        out = []
        for i, id_ in enumerate(ids):
            if found[i]:
                out.append(rows[i].tobytes())
            elif id_ in self.spilled:
                out.append(self._fetch(id_)[0])
        return b"".join(out)

    def extract_into(self, transfers: dict, posted: dict) -> None:
        """Merge spilled rows into extract() results (parity surface).
        Sorted: dict insertion order is part of the extract surface
        (parity dumps serialize it), and set order is not stable."""
        self.io_drain()
        for id_ in sorted(self.spilled):
            row, ful = self._fetch(id_)
            t = types.Transfer.from_np(
                np.frombuffer(row, dtype=types.TRANSFER_DTYPE)[0]
            )
            transfers[t.id] = t
            if ful:
                posted[t.timestamp] = ful

    # ------------------------------------------------------------------
    # durability
    # ------------------------------------------------------------------

    def checkpoint_meta(self) -> dict:
        """Persist the spill store: the spilled-id set goes into a grid
        block chain (it can exceed the superblock copy size; the forest's
        IdTree holds a superset — this exact set exists to exclude
        reloaded-and-stale LSM entries), then the forest checkpoint flushes
        trees, writes the manifest log, and encodes the free set LAST (so
        the id blocks created here are covered, and the previous chain's
        staged releases apply)."""
        from tigerbeetle_tpu_torch.lsm.grid import BLOCK_PAYLOAD_MAX

        self.io_drain()  # queued inserts are part of this checkpoint
        g = self.forest.grid
        for address in self._id_chain:
            g.release(address)  # staged until the encode below
        payload = b"".join(
            x.to_bytes(16, "little") for x in sorted(self.spilled)
        )
        per_block = BLOCK_PAYLOAD_MAX // 16 * 16
        self._id_chain = [
            g.create_block(payload[i : i + per_block])
            for i in range(0, len(payload), per_block)
        ]
        manifest = self.forest.checkpoint()
        return {
            "manifest": manifest,
            "spilled_blocks": list(self._id_chain),
            "spilled_count": len(self.spilled),
        }

    def restore(self, meta: dict) -> None:
        self.io_drain()
        with self._staged_lock:
            self._staged.clear()
        self._prefetch = None  # gathered against the pre-restore store
        self.forest.restore(meta["manifest"])
        self._id_chain = list(meta["spilled_blocks"])
        self.spilled = set()
        for address in self._id_chain:
            raw = self.forest.grid.read_block(address)
            for i in range(0, len(raw), 16):
                self.spilled.add(int.from_bytes(raw[i : i + 16], "little"))
        assert len(self.spilled) == int(meta["spilled_count"])
        self._lo = np.sort(
            np.array([x & ((1 << 64) - 1) for x in self.spilled], dtype=np.uint64)
        )

    def overlap_report(self) -> dict:
        """The bench's overlap-accounting artifact (the analog of the dual
        mode's shadow_upload_overlap): spill_overlap = fraction of prefetch-
        gather seconds hidden behind commits (1.0 = admit never waited);
        spill_lookup_batch = mean ids per batched LSM multi-lookup."""
        s = self.stats
        worker = s["t_prefetch_worker"]
        overlap = (
            round(max(0.0, 1.0 - s["t_prefetch_wait"] / worker), 4)
            if worker > 0 else None
        )
        batch = (
            round(s["lookup_ids"] / s["lookup_batches"], 1)
            if s["lookup_batches"] else None
        )
        return {"spill_overlap": overlap, "spill_lookup_batch": batch}


def _next_pow2(n: int, floor: int = 8) -> int:
    p = floor
    while p < n:
        p <<= 1
    return p
