"""CdcPump: tail the committed op log into a sink, off the commit path.

Source hierarchy for one op's `(header, body, reply_body)` — cheapest
first, each a strict fallback for the one above:

1. LIVE window: the replica's `cdc_hook` fires once per op at commit
   finalize with references the replica already holds (prepare body +
   reply body — no copies, no device->host). The window is bounded; when
   the pump lags past it the OLDEST entries are simply evicted, because:
2. WAL ring: `journal.read_prepare(op)` re-reads any op the ring still
   covers, and the replica's bounded `cdc_replies` ring (reply bodies are
   tiny — sparse failure structs, usually empty) supplies the result
   codes. The durable log is the real buffer; the live window is only a
   read-avoidance cache.
3. AOF replay: ops older than the WAL ring replay from the append-only
   disaster-recovery log through the scalar oracle (parity-locked with
   the device engines), regenerating exact result codes from op 1 —
   the cold-start / deep-resume path.
4. Declared gap: with no AOF and the ring wrapped (or the op skipped by a
   state-sync install), the pump emits an explicit `gap` record rather
   than silently dropping history.

The hierarchy lives in `CdcTail`, which is READ-SHARED: reads are
non-destructive, so one tail can feed N consumers at N different
positions (the ingress CDC fan-out hub, tigerbeetle_tpu_torch/ingress/fanout).
`CdcPump` is the single-consumer composition of a tail + sink + cursor —
the hub is the same machinery with per-consumer cursors.

Backpressure pauses the PUMP, never the replica: a sink refusal stops
stream progress for this turn (`cdc.backpressure_pauses` counts the
transitions, `cdc.lag_ops` the distance) and the commit path never
notices. Work per `pump()` call is bounded by `budget_ops`, so the server
event loop stays responsive regardless of batch sizes.
"""

from __future__ import annotations

import sys

from tigerbeetle_tpu_torch.cdc.record import (
    _CREATE_OPS,
    commitment_record,
    encode_lines,
    gap_record,
    record_line,
)
from tigerbeetle_tpu_torch.vsr.header import HEADER_SIZE, Header


class AofReplaySource:
    """Sequential (header, body, reply_body) source over an AOF file.

    The AOF holds every committed prepare from op 1 (reference:
    src/aof.zig — appended before the reply), but not the replies; result
    codes are regenerated by executing each prepare through the scalar
    oracle, which is parity-locked with the device/native engines (the
    simulator's state checker enforces that), so replayed codes match
    what the live stream carried. Strictly forward-only: the pump
    consumes ops in order and `read(op)` below the high-water mark
    returns None (the cursor never moves backward).

    The file may GROW while we read it — a live replica appends at every
    commit, and a lagging fan-out consumer tails the same log the
    replica is writing. Each scan resumes at the byte offset past the
    last valid record, so appends land on the next read instead of
    vanishing behind a one-shot snapshot; an incomplete tail (or a torn
    one) stops the scan WITHOUT advancing the offset, so a record whose
    tail bytes arrive later is retried, not skipped."""

    def __init__(self, path: str):
        from tigerbeetle_tpu_torch.constants import DEFAULT_CLUSTER
        from tigerbeetle_tpu_torch.models.oracle import OracleStateMachine
        from tigerbeetle_tpu_torch.state_machine import StateMachine

        self._path = path
        self._offset = 0  # file position past the last valid record
        self._warned_tail = False
        self._sm = StateMachine(OracleStateMachine(), DEFAULT_CLUSTER.message_size_max)
        self._next = 1
        # one-record lookahead: reading past an AOF hole (ops the replica
        # never executed — a state-sync jump) lands on the first record
        # BEYOND the hole, which must be served later, not dropped
        self._pending: tuple | None = None
        # one-record memo: a backpressured pump RE-reads the op it is
        # stuck on every turn until its sink accepts — re-serving the
        # last record keeps those retries exact instead of degrading
        # them to reply-unknown journal reads
        self._last: tuple | None = None

    def _more_records(self):
        """Valid records appended since the last scan, oldest first.
        `_offset` advances per yielded record (before the yield), so a
        caller that stops mid-scan never re-reads what it consumed."""
        from tigerbeetle_tpu_torch.aof import MAGIC, SECTOR

        try:
            with open(self._path, "rb") as f:
                f.seek(self._offset)
                data = f.read()
        except OSError:
            return
        off, n = 0, len(data)
        while off + 16 + HEADER_SIZE <= n:
            if int.from_bytes(data[off:off + 8], "little") != MAGIC:
                self._warn_tail(n - off)
                return
            size = int.from_bytes(data[off + 8:off + 16], "little")
            if size < HEADER_SIZE or off + 16 + size > n:
                return
            header = Header.from_bytes(data[off + 16:off + 16 + HEADER_SIZE])
            body = data[off + 16 + HEADER_SIZE:off + 16 + size]
            if (not header.valid_checksum()
                    or not header.valid_checksum_body(body)):
                self._warn_tail(n - off)
                return
            span = 16 + size
            span += (-span) % SECTOR  # records are sector-aligned
            off += span
            self._offset += span
            yield header, body

    def _warn_tail(self, leftover: int) -> None:
        """Bytes at the scan head that can never parse (bad magic or a
        failed checksum — NOT a short read, which a later append can
        complete): the log ends in a tear. Same operator signal as
        aof.replay(), once per source."""
        if not self._warned_tail:
            self._warned_tail = True
            sys.stderr.write(
                f"aof: torn/corrupt tail record in {self._path} "
                f"({leftover} trailing bytes ignored)\n"
            )

    def read(self, op: int):
        from tigerbeetle_tpu_torch.types import Operation

        if self._last is not None and self._last[0].op == op:
            return self._last  # backpressure retry of the stuck op
        if self._pending is not None:
            if self._pending[0].op == op:
                got, self._pending = self._pending, None
                self._last = got
                return got
            if self._pending[0].op > op:
                return None  # inside the hole the lookahead skipped
        if op < self._next:
            return None
        for header, body in self._more_records():
            if header.op < self._next:
                continue  # restart re-appended a duplicate: already replayed
            reply = None
            if header.operation != int(Operation.register):
                reply = self._sm.commit(
                    Operation(header.operation), header.timestamp, body
                )
            self._next = header.op + 1
            if header.op == op:
                got = (header, body, reply)
                self._last = got
                return got
            if header.op > op:
                # a hole: keep the overshoot record for its own read()
                self._pending = (header, body, reply)
                return None
        return None

    def next_available(self) -> int | None:
        """After a read() miss: the op of the first AOF record beyond the
        hole (the gap a pump declares must stop where the log resumes)."""
        return self._pending[0].op if self._pending is not None else None


class CdcTail:
    """The shared live window + source hierarchy over ONE replica's
    committed op log. Reads are non-destructive; a caller that has
    advanced past an op releases it via `release_below` (the fan-out hub
    releases at the SLOWEST consumer's position, so a lagging consumer
    pauses only itself — the window, then the WAL ring, then the AOF
    still cover whatever it has not read)."""

    def __init__(self, replica, window: int = 256, aof_path: str | None = None):
        self.replica = replica
        self.window = window
        # AOF replay sources are per-CONSUMER, not per-tail: a source is
        # strictly forward-only, so sharing one between consumers at
        # different positions would blind the laggard (the fast reader
        # advances the high-water mark past ops the slow one still
        # needs). The tail only carries the path; each CdcPump owns its
        # source and passes it into read()/probe_gap_end().
        self.aof_path = aof_path
        self._live: dict[int, tuple] = {}  # op -> (header, body, reply)
        self._prev_hook = None
        self._attached = False
        # the ONE bound-method object this tail installs: `self._on_commit`
        # mints a new bound method per access, so chain membership tests
        # (detach's splice) need a stable identity
        self._hook = self._on_commit
        m = replica.metrics
        self._c_live = m.counter("cdc.live_hits")
        self._c_journal = m.counter("cdc.journal_reads")
        self._c_aof = m.counter("cdc.aof_reads")

    # -- live tail (the replica-side hot path: O(1), no encoding) --

    def attach(self) -> None:
        """Chain onto the replica's cdc seam. The reply-retention ring
        (`cdc_retain`) stays on after detach: a restarted pump needs the
        result codes for ops committed while it was down."""
        assert not self._attached
        self._prev_hook = self.replica.cdc_hook
        self.replica.cdc_hook = self._hook
        self.replica.cdc_retain = True
        self._attached = True

    def detach(self) -> None:
        """Unchain WITHOUT clobbering tails that attached after us: a
        second subscriber (e.g. a fan-out hub next to a sim consumer)
        chains on top, so blindly restoring our saved _prev_hook would
        silently unhook IT. Splice this tail out of the middle instead."""
        if not self._attached:
            return
        self._attached = False
        if self.replica.cdc_hook is self._hook:
            self.replica.cdc_hook = self._prev_hook
            self._prev_hook = None
            return
        hook = self.replica.cdc_hook
        while hook is not None:
            owner = getattr(hook, "__self__", None)
            if not isinstance(owner, CdcTail):
                break  # chain rewired by something else: leave it alone
            if owner._prev_hook is self._hook:
                owner._prev_hook = self._prev_hook
                self._prev_hook = None
                return
            hook = owner._prev_hook

    def _on_commit(self, header, body: bytes, reply_body) -> None:
        if self._prev_hook is not None:
            self._prev_hook(header, body, reply_body)
        op = header.op
        if op in self._live:
            return  # redelivery (replica recovery re-commit): already held
        if int(header.operation) not in _CREATE_OPS:
            # record-less op (register/lookup): keep only the header so
            # readers advance without a WAL read — never pin a lookup's
            # MiB-scale body/reply for an op that encodes to nothing
            self._live[op] = (header, None, None)
        elif body is None:
            return  # attach raced an in-flight dispatch: the WAL serves it
        else:
            self._live[op] = (header, body, reply_body)
        while len(self._live) > self.window:
            # evict the oldest: the WAL ring still covers it
            self._live.pop(next(iter(self._live)))

    # -- reads (consumer side) --

    def read(self, op: int, aof: AofReplaySource | None = None):
        """(header, body, reply_body) | None, cheapest source first.
        Non-destructive: the same op may be read by N consumers, each
        passing its OWN forward-only `aof` source."""
        got = self._live.get(op)
        if got is not None:
            self._c_live.add()
            return got
        jj = self.replica.journal.read_prepare(op)
        if jj is not None:
            reply = self.replica.cdc_replies.get(op)
            if (
                reply is None
                and aof is not None
                and int(jj[0].operation) in _CREATE_OPS
            ):
                # the WAL still holds the op but its reply ring entry is
                # gone (committed before this process's recovery window):
                # the AOF + oracle regenerate the exact result codes
                got = aof.read(op)
                if got is not None:
                    self._c_aof.add()
                    return got
            self._c_journal.add()
            return jj[0], jj[1], reply
        if aof is not None:
            got = aof.read(op)
            if got is not None:
                self._c_aof.add()
                return got
        return None

    def release_below(self, op: int) -> None:
        """Drop live entries every consumer has passed (ops < op)."""
        live = self._live
        while live:
            oldest = next(iter(live))
            if oldest >= op:
                return
            live.pop(oldest)

    def probe_gap_end(self, op: int, commit_min: int, probe_budget: int,
                      aof: AofReplaySource | None = None) -> int:
        """The far end of an unreachable span starting at `op`: probing
        uses the journal's in-memory header mirror (no storage reads);
        the live window and the AOF's next record past the hole bound the
        other end — history any source still holds must never be declared
        gone."""
        limit = commit_min
        na = aof.next_available() if aof is not None else None
        if na is not None and na > op:
            limit = min(limit, na - 1)
        end = op
        probes = 0
        while (
            end < limit
            and probes < max(64, probe_budget)
            and (end + 1) not in self._live
            and self.replica.journal.get_header(end + 1) is None
        ):
            end += 1
            probes += 1
        return end


class CdcPump:
    """One consumer's pump over one replica. Volatile by design: all
    durable state lives in the cursor (and the sink's own store); a
    crashed pump resumes from the cursor through the WAL/AOF sources."""

    def __init__(self, replica, sink, cursor, window: int = 256,
                 ack_interval: int = 32, aof_path: str | None = None,
                 tail: CdcTail | None = None, commitments: bool = False):
        self.replica = replica
        self.sink = sink
        self.cursor = cursor
        self.window = window
        self.ack_interval = ack_interval
        # opt-in checkpoint-commitment records: when the replica carries a
        # CommitmentLog (federation mode), boundary ops append a
        # `commitment` record after their change records so a downstream
        # verifier can check the stream against the region's state chain
        self.commitments = commitments
        # a caller-provided tail is SHARED (the ingress fan-out hub): the
        # hub owns its hook lifecycle and releases the live window at the
        # slowest consumer's position, not ours
        self._owns_tail = tail is None
        self.tail = tail or CdcTail(replica, window=window, aof_path=aof_path)
        # this consumer's own deep-resume source (forward-only, tracks
        # OUR position): never shared — see CdcTail.__init__
        self._aof = (
            AofReplaySource(self.tail.aof_path)
            if self.tail.aof_path else None
        )
        self._paused = False
        op, checksum = cursor.load()
        self.next_op = op + 1
        self._cursor_checksum = checksum
        self._acked_op = op
        self._last_checksum = checksum
        self._fork_checked = op == 0
        m = replica.metrics
        self.tracer = replica.tracer
        self._c_ops = m.counter("cdc.ops")
        self._c_records = m.counter("cdc.records")
        self._c_gap_ops = m.counter("cdc.gap_ops")
        self._c_pauses = m.counter("cdc.backpressure_pauses")
        self._c_unknown = m.counter("cdc.results_unknown")
        self._c_cursor = m.counter("cdc.cursor_writes")
        self._c_commitments = m.counter("cdc.commitment_records")
        self._g_lag = m.gauge("cdc.lag_ops")
        self._h_pump = m.histogram("cdc.pump_us")

    def attach(self) -> None:
        if self._owns_tail:
            self.tail.attach()

    def detach(self) -> None:
        if self._owns_tail:
            self.tail.detach()

    # -- stream progress (called from the event loop / consumer tick) --

    def _check_resume_fork(self) -> None:
        """One-shot on resume: the cursor's checksum must match the log's
        header at that op where the log still covers it — committed
        history never forks, so a mismatch means the consumer is pointed
        at the wrong cluster/data file."""
        self._fork_checked = True
        h = self.replica.journal.get_header(self._acked_op)
        if h is not None and self._cursor_checksum not in (0, h.checksum):
            sys.stderr.write(
                f"cdc: cursor checksum mismatch at op {self._acked_op} "
                "(wrong cluster or data file?); continuing — consumers "
                "dedup by op\n"
            )
            self.replica.metrics.counter("cdc.resume_forks").add()

    def pump(self, budget_ops: int = 8) -> int:
        """Encode + emit up to `budget_ops` committed ops. Returns ops
        streamed (gap ops count). Never blocks; never touches the commit
        path."""
        if not self._fork_checked:
            self._check_resume_fork()
        # the FINALIZED watermark, not commit_min: with an async commit
        # window an op's reply buffer exists only after finalize, and the
        # live hook fires there — streaming past it would race the hook
        commit_min = self.replica.cdc_commit_min
        if self._owns_tail:
            # fan-out consumers share this registry gauge, so N writers
            # would leave it at whoever pumped last — the hub publishes
            # ingress.fanout_lag_ops (the slowest) instead
            self._g_lag.set(max(0, commit_min - self.next_op + 1))
        if self.next_op > commit_min:
            return 0
        n = 0
        with self._h_pump.time():
            while n < budget_ops and self.next_op <= commit_min:
                op = self.next_op
                got = self.tail.read(op, self._aof)
                if got is None:
                    if not self._emit_gap(op, commit_min, budget_ops - n):
                        break
                    n += 1  # a gap span consumed one budget unit
                    continue
                header, body, reply_body = got
                if reply_body is None and int(header.operation) in _CREATE_OPS:
                    self._c_unknown.add()
                lines = encode_lines(header, body, reply_body)
                n_records = len(lines)
                if self.commitments:
                    clog = self.replica.commitment_log
                    cg = clog.get(op) if clog is not None else None
                    if cg is not None:
                        # boundary op: the chain entry follows the op's
                        # change records (a boundary on a record-less op
                        # emits a commitment-only line)
                        lines.append(
                            record_line(commitment_record(op, cg[0], cg[1]))
                        )
                if lines:
                    # trace: the op's cluster-causal id (vsr/header.py),
                    # re-derived from the prepare's (client, context) —
                    # the CDC hop joins the op's Perfetto flow
                    with self.tracer.span(
                        "cdc.emit", op=op,
                        trace=header.trace() if self.tracer.enabled else 0,
                    ):
                        ok = self.sink.emit_lines(lines)
                    if not ok:
                        if not self._paused:
                            self._paused = True
                            self._c_pauses.add()
                        break  # the tail still holds the op: retry later
                    self._c_records.add(n_records)
                    if len(lines) > n_records:
                        self._c_commitments.add()
                self._paused = False
                self.next_op = op + 1
                self._last_checksum = header.checksum
                self._c_ops.add()
                n += 1
                if op - self._acked_op >= self.ack_interval:
                    self._ack(op)
        if self._owns_tail:
            self.tail.release_below(self.next_op)
            self._g_lag.set(max(0, commit_min - self.next_op + 1))
        return n

    def _emit_gap(self, op: int, commit_min: int, probe_budget: int) -> bool:
        """Span the unreachable range [op, end] in one declared-gap
        record."""
        end = self.tail.probe_gap_end(op, commit_min, probe_budget,
                                      self._aof)
        with self.tracer.span("cdc.emit", op=op, gap=end):
            ok = self.sink.emit_lines([record_line(gap_record(op, end))])
        if not ok:
            if not self._paused:
                self._paused = True
                self._c_pauses.add()
            return False
        self._paused = False
        self._c_gap_ops.add(end - op + 1)
        self.next_op = end + 1
        self._last_checksum = 0  # unknown across the hole
        return True

    def _ack(self, op: int) -> None:
        # The cursor must never run AHEAD of the sink's durability: a
        # buffering sink (JSONL file) that only ACCEPTED lines loses them
        # with a crashed process, and a cursor past them would resume
        # BEYOND the hole — records lost forever instead of redelivered.
        # Flush-before-ack makes the at-least-once contract hold under
        # SIGKILL (found by the chaos harness's kill/restart check).
        self.sink.flush()
        self.cursor.ack(op, self._last_checksum)
        self._acked_op = op
        self._c_cursor.add()

    def flush(self) -> None:
        """Force the cursor up to the streamed head and flush the sink
        (shutdown path)."""
        if self.next_op - 1 > self._acked_op:
            self._ack(self.next_op - 1)
        self.sink.flush()
