"""The write-ahead log: two on-disk circular rings over the Storage seam.

The reference's journal design (reference: src/vsr/journal.zig:18-47): a
`wal_prepares` ring of `journal_slot_count` message-sized slots holding the
full prepare (header + body), plus a redundant `wal_headers` ring holding
only the 128-byte headers. The redundant copy disambiguates torn writes: a
torn PREPARE write leaves a valid redundant header pointing at a broken
prepare (slot faulty, repairable); a torn HEADER write leaves a valid
prepare whose own header wins (reference: src/vsr/journal.zig:374-535
recovery decision matrix — the single-replica subset implemented here).

Slot assignment: op % slot_count (ring). The checkpoint interval keeps a
bar of headroom so un-checkpointed ops are never overwritten (reference:
src/vsr.zig:2003-2035 checkpoint arithmetic).

The port's copy of `tigerbeetle_tpu/vsr/journal.py`, the same code with its imports
pointed at this package, so that its bytes on disk and on the wire are the
JAX package's.
"""

from __future__ import annotations

import threading
from concurrent.futures import Future, ThreadPoolExecutor
from time import perf_counter_ns

from tigerbeetle_tpu_torch.constants import ConfigCluster
from tigerbeetle_tpu_torch.io.storage import SECTOR_SIZE, Storage, Zone
from tigerbeetle_tpu_torch.metrics import NULL_METRICS
from tigerbeetle_tpu_torch.tracer import NULL_TRACER
from tigerbeetle_tpu_torch.vsr.header import HEADER_SIZE, Command, Header


class Journal:
    # observability seams — the owning replica (or the composition root)
    # re-points these at its shared registry/tracer; defaults are the
    # zero-cost no-op backends
    metrics = NULL_METRICS
    tracer = NULL_TRACER

    def __init__(self, storage: Storage, cluster: ConfigCluster):
        # crossed by the writer pool, but every concurrent write targets
        # a disjoint region: prepare slots are op-owned, shared header
        # SECTORS serialize through _sector_locks, and evidence surgery
        # (invalidate_above/recover) quiesces the pool first
        self.storage = storage  # vet: handoff
        self.cluster = cluster
        self.slot_count = cluster.journal_slot_count
        self.msg_max = cluster.message_size_max
        # In-memory mirror of the redundant header ring (so a slot's header
        # write is a single-sector read-modify-write against this mirror).
        self._headers = bytearray(self.slot_count * HEADER_SIZE)
        # Async write path (reference: journal IOPS pools, 8 write iops,
        # src/config.zig:97-98): a small writer pool overlaps the 1 MiB
        # O_DSYNC prepare writes with device commits and other requests.
        # Created lazily — deterministic tests never touch it.
        self._executor: ThreadPoolExecutor | None = None
        self._sector_locks: dict[int, threading.Lock] = {}
        self._locks_guard = threading.Lock()
        # add() on the event loop, discard() on the completing worker via
        # add_done_callback — both GIL-atomic set ops; quiesce() snapshots
        # with list() before iterating (join-before-read)
        self._pending_writes: set[Future] = set()  # vet: handoff
        # Durable-header mirror: a slot's header enters this mirror (and
        # therefore reaches the redundant ring on disk) only AFTER its own
        # prepare write completed — a neighbor slot's sector write must
        # never publish a header whose prepare is still in flight (the
        # prepare-before-header ordering contract, per slot). Worker
        # writes hold the slot's sector lock; event-loop writes happen
        # only on the sync path (no pool) or after quiesce()
        self._headers_durable = bytearray(  # vet: handoff
            self.slot_count * HEADER_SIZE
        )

    def slot_for_op(self, op: int) -> int:
        return op % self.slot_count

    # -- write path --

    def write_prepare(self, header: Header, body: bytes) -> None:
        """Write prepare (header+body) to its slot, then the redundant
        header — prepare FIRST, matching the reference's ordering so a torn
        redundant-header write still recovers from the prepare ring
        (reference: src/vsr/journal.zig write_prepare_header sequencing)."""
        assert header.command == Command.prepare
        assert header.size == HEADER_SIZE + len(body)
        assert header.size <= self.msg_max
        slot = self.slot_for_op(header.op)
        with self.tracer.span(
            "journal.write_prepare", op=header.op,
            trace=header.trace() if self.tracer.enabled else 0,
        ), self.metrics.histogram("journal.write_us").time():
            self.storage.write(
                Zone.wal_prepares, slot * self.msg_max,
                header.to_bytes() + body,
            )
            self._write_header(slot, header)
        self.metrics.counter("journal.writes").add()
        from tigerbeetle_tpu_torch import constants

        if constants.VERIFY:
            # intensive tier: read-after-write — the slot must round-trip
            # through the storage seam with both checksums intact
            got = self.read_prepare(header.op)
            assert got is not None and got[0].checksum == header.checksum, (
                f"VERIFY: prepare op {header.op} failed read-after-write"
            )

    def _write_header(self, slot: int, header: Header) -> None:
        off = slot * HEADER_SIZE
        wire = header.to_bytes()
        self._headers[off : off + HEADER_SIZE] = wire
        self._headers_durable[off : off + HEADER_SIZE] = wire
        self._write_header_sector(off // SECTOR_SIZE * SECTOR_SIZE)

    def _write_header_sector(self, sector: int) -> None:
        self.storage.write(
            Zone.wal_headers, sector,
            bytes(self._headers_durable[sector : sector + SECTOR_SIZE]),
        )

    # -- async write path (the reply/ack waits on the future; everything
    # else overlaps: reference journal write IOPS, src/config.zig:97-98) --

    def write_prepare_async(self, header: Header, body: bytes) -> Future:
        """Mirror-update now (synchronously — evidence scans see the op
        immediately); the durable prepare + header-sector writes run on
        the writer pool. The caller MUST await the future before acking
        (prepare_ok / client reply): WAL-before-ack is the contract."""
        assert header.command == Command.prepare
        assert header.size == HEADER_SIZE + len(body)
        slot = self.slot_for_op(header.op)
        off = slot * HEADER_SIZE
        hb = header.to_bytes()
        self._headers[off : off + HEADER_SIZE] = hb
        sector = off // SECTOR_SIZE * SECTOR_SIZE
        if self._executor is None:
            self._executor = ThreadPoolExecutor(
                max_workers=8, thread_name_prefix="journal"
            )
        # header and body ship separately: the 1 MiB header+body concat
        # happens on the WRITER thread, not the event loop (a measured
        # per-batch copy on the reply-serving core). The trace id is
        # derived HERE (event loop, header in hand) and handed to the
        # worker as a plain int for its span tag.
        tid = header.trace() if self.tracer.enabled else 0
        fut = self._executor.submit(
            # submit stamp for the WAL parallel lane (latency.py): the
            # reply only waits on the RESIDUAL of this write at finalize,
            # so its full submit->durable time is invisible to the
            # critical-path legs — latency.wal_lane_us carries it
            self._write_task, slot, sector, hb, body, tid,
            perf_counter_ns(),
        )
        self._pending_writes.add(fut)
        fut.add_done_callback(self._pending_writes.discard)
        return fut

    def quiesce(self) -> None:
        """Wait for every in-flight async prepare write. Evidence surgery
        (invalidate_above) and recovery-order-sensitive transitions must
        not race a queued write that would re-populate a zeroed slot."""
        for fut in list(self._pending_writes):
            fut.result()

    def submit_io(self, fn, *args) -> Future:
        """FIFO background IO (client-reply slot writes): one worker, so
        successive writes to the same slot land in submission order."""
        if getattr(self, "_io_executor", None) is None:
            self._io_executor = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="journal-io"
            )
            # same discipline as _pending_writes: GIL-atomic add/discard,
            # drain_io() snapshots with list() (join-before-read)
            self._pending_io: set[Future] = set()  # vet: handoff
        fut = self._io_executor.submit(fn, *args)
        self._pending_io.add(fut)
        fut.add_done_callback(self._pending_io.discard)
        return fut

    def drain_io(self) -> None:
        """Wait for queued background IO. The checkpoint chain must call
        this before persisting the client table: a recorded reply_checksum
        whose slot write never landed would wedge that session forever
        (duplicate requests dropped, reply unreadable)."""
        for fut in list(getattr(self, "_pending_io", ())):
            fut.result()

    def _write_task(self, slot: int, sector: int, hb: bytes,
                    body: bytes, tid: int = 0, t_submit: int = 0) -> None:
        # prepare FIRST, then the redundant header (same ordering contract
        # as the sync path). Concurrent slots may share a header sector:
        # a slot's header enters the DURABLE mirror only here — after its
        # own prepare landed — so a neighbor's sector write can never
        # publish a header whose prepare is still in flight.
        with self.tracer.span("journal.write_prepare", slot=slot,
                              trace=tid), \
                self.metrics.histogram("journal.write_us").time():
            self.storage.write(
                Zone.wal_prepares, slot * self.msg_max, hb + body
            )
            off = slot * HEADER_SIZE
            with self._locks_guard:
                lock = self._sector_locks.setdefault(
                    sector, threading.Lock()
                )
            with lock:
                self._headers_durable[off : off + HEADER_SIZE] = hb
                self._write_header_sector(sector)
        self.metrics.counter("journal.writes").add()
        if t_submit:
            # WAL lane: event-loop submit -> durable (queue wait + the
            # 1 MiB O_DSYNC write), observed on the writer thread
            self.metrics.histogram("latency.wal_lane_us").observe(
                (perf_counter_ns() - t_submit) / 1000.0
            )

    def invalidate_above(self, op_max: int) -> None:
        """Destroy journal evidence for every op above `op_max` — BOTH the
        header-mirror/redundant ring and the prepare ring.

        Called when a view change completes: the quorum decided the log
        ends at `op_max`, so any surviving slot above it holds a superseded
        prepare from an abandoned view. Left in place, the next
        _dvc_suffix_headers scan would re-advertise those headers under
        this replica's NEW log_view, where best-log merging treats them as
        authoritative — a truncated prepare could be resurrected and shadow
        the op committed in the intervening view (replica divergence). The
        disk writes make the invalidation survive a restart (recover()
        would otherwise rebuild the mirror from the stale rings)."""
        # An in-flight async write for a superseded op would land AFTER
        # the zeroing below and resurrect the evidence: drain first.
        self.quiesce()
        for slot in range(self.slot_count):
            off = slot * HEADER_SIZE
            h = Header.from_bytes(bytes(self._headers[off : off + HEADER_SIZE]))
            if not (h.valid_checksum() and h.command == Command.prepare):
                continue
            if h.op <= op_max:
                continue
            self._headers[off : off + HEADER_SIZE] = bytes(HEADER_SIZE)
            self._headers_durable[off : off + HEADER_SIZE] = bytes(HEADER_SIZE)
            self._write_header_sector(off // SECTOR_SIZE * SECTOR_SIZE)
            # Tear the prepare's own header sector too: recover() must not
            # resurrect the slot from the prepare ring.
            praw = self.storage.read(
                Zone.wal_prepares, slot * self.msg_max, HEADER_SIZE
            )
            p = Header.from_bytes(praw[:HEADER_SIZE])
            if p.valid_checksum() and p.command == Command.prepare and p.op > op_max:
                self.storage.write(
                    Zone.wal_prepares, slot * self.msg_max, bytes(SECTOR_SIZE)
                )
            if getattr(self, "faulty", None):
                if self.faulty.get(slot, 0) > op_max:
                    del self.faulty[slot]

    def get_header(self, op: int) -> Header | None:
        """The op's header from the in-memory redundant-header mirror (valid
        for faulty slots too — that is the point of the redundant ring)."""
        slot = self.slot_for_op(op)
        h = Header.from_bytes(
            bytes(self._headers[slot * HEADER_SIZE : (slot + 1) * HEADER_SIZE])
        )
        if h.valid_checksum() and h.command == Command.prepare and h.op == op:
            return h
        return None

    # -- read path --

    def read_prepare(self, op: int) -> tuple[Header, bytes] | None:
        """The prepare for `op`, or None if the slot holds a different op or
        fails its checksums."""
        slot = self.slot_for_op(op)
        raw = self.storage.read(Zone.wal_prepares, slot * self.msg_max, self.msg_max)
        header = Header.from_bytes(raw[:HEADER_SIZE])
        if not header.valid_checksum() or header.op != op:
            return None
        if header.command != Command.prepare:
            return None
        body = raw[HEADER_SIZE : header.size]
        if not header.valid_checksum_body(body):
            return None
        return header, body

    # -- recovery --

    def recover(self) -> dict[int, Header]:
        """Scan both rings; return op -> header for every slot whose prepare
        is intact (the replayable set). Rebuilds the in-memory header mirror
        from BOTH rings, records faulty slots, and classifies each slot
        into the decision matrix (reference: src/vsr/journal.zig:374-535):

        - valid:       prepare intact, rings agree (or redundant torn — the
                       prepare's own header wins: torn_header)
        - faulty:      redundant header survives but the prepare body is
                       torn — the op is KNOWN, the body repairable from any
                       acker (`faulty` records it; normal-status WAL scrub
                       and view-change adoption refetch it)
        - wrap_stale:  BOTH rings valid but the redundant header carries a
                       NEWER op for the slot — the newer prepare's write
                       was lost/rolled back while the previous ring pass's
                       prepare survives underneath. The redundant header is
                       the later evidence (it is only ever written AFTER
                       its prepare landed), so the slot is FAULTY for the
                       newer op; trusting the stale prepare would advertise
                       a superseded op in DVCs and could false-nack an
                       acked one.
        - misdirected: a checksum-valid prepare whose op does not map to
                       this slot — the write landed in the wrong place
                       (reference classifies misdirected reads/writes);
                       never evidence, the true slot content is lost.
        - blank:       neither ring holds anything usable.

        `recover_stats` counts the classifications (simulator assertions
        + observability)."""
        out: dict[int, Header] = {}
        self.faulty: dict[int, int] = {}  # slot -> op whose body is lost
        self.recover_stats = {
            "valid": 0, "torn_header": 0, "faulty": 0, "wrap_stale": 0,
            "misdirected": 0, "blank": 0,
        }
        raw_headers = self.storage.read(
            Zone.wal_headers, 0,
            (self.slot_count * HEADER_SIZE + SECTOR_SIZE - 1)
            // SECTOR_SIZE * SECTOR_SIZE,
        )
        for slot in range(self.slot_count):
            praw = self.storage.read(
                Zone.wal_prepares, slot * self.msg_max, self.msg_max
            )
            p_header = Header.from_bytes(praw[:HEADER_SIZE])
            p_valid = (
                p_header.valid_checksum()
                and p_header.command == Command.prepare
                and p_header.size <= self.msg_max
                and p_header.valid_checksum_body(
                    praw[HEADER_SIZE : p_header.size]
                )
            )
            p_here = p_valid and self.slot_for_op(p_header.op) == slot
            off = slot * HEADER_SIZE
            r_header = Header.from_bytes(raw_headers[off : off + HEADER_SIZE])
            r_ok = (
                r_header.valid_checksum()
                and r_header.command == Command.prepare
                and self.slot_for_op(r_header.op) == slot
            )
            if p_valid and not p_here:
                # misdirected write: the prepare belongs elsewhere; fall
                # back to the redundant ring for THIS slot's evidence
                self.recover_stats["misdirected"] += 1
                if r_ok:
                    self.faulty[slot] = r_header.op
                    self._headers[off : off + HEADER_SIZE] = (
                        r_header.to_bytes()
                    )
                continue
            if p_here and (not r_ok or r_header.op <= p_header.op):
                # the prepare is the newest evidence for the slot
                out[p_header.op] = p_header
                self._headers[off : off + HEADER_SIZE] = p_header.to_bytes()
                self.recover_stats[
                    "valid" if r_ok and r_header.op == p_header.op
                    else "torn_header"
                ] += 1
                continue
            if r_ok:
                # redundant header is the newest evidence; the body for its
                # op is lost (torn prepare, or a stale wrap underneath)
                self.faulty[slot] = r_header.op
                self._headers[off : off + HEADER_SIZE] = r_header.to_bytes()
                self.recover_stats[
                    "wrap_stale" if p_here else "faulty"
                ] += 1
                continue
            self.recover_stats["blank"] += 1
        self._headers_durable = bytearray(self._headers)
        return out
