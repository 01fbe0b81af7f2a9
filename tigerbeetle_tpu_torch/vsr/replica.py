"""The VSR replica: consensus-driven replication of the device ledger.

Viewstamped Replication (Revisited) over the Storage/Network/Time seams
(reference: src/vsr/replica.zig — normal path handlers :1208-1538, view
change :1595-1924, repair :5248+, commit dispatch :3045-3103):

NORMAL PATH — the PRIMARY (view % replica_count) sequences client requests
into prepares: assigns op + batch-final timestamp (cluster clock, monotonic
clamped), hash-chains the header, journals it (WAL-before-ack), broadcasts;
BACKUPS verify the chain, journal, ack prepare_ok; at a majority quorum the
primary commits in op order through the StateMachine (the device
ledger) and replies; backups commit when the commit number reaches them
(piggybacked + heartbeats). Client sessions are replicated state: register
ops flow through the log, duplicates are answered from the table.

VIEW CHANGE — backups that lose contact with the primary send
start_view_change for view+1; at a quorum of SVCs each sends do_view_change
(carrying its log suffix headers) to the new primary; the new primary picks
the best log (max log_view, then op), repairs missing prepares via
request_prepare, truncates its tail, then broadcasts start_view; backups
adopt the suffix, repairing the same way. Uncommitted ops that survive in
the chosen log commit in the new view (VSR's no-lost-commits invariant:
any op that reached a commit quorum is in a majority of logs, so the best
log contains it).

CLOCK — replicas ping each other; pongs return the peer's wall clock, and
Marzullo's algorithm over the offset intervals (vsr/clock.py) yields a
cluster-synchronized timestamp base (reference: src/vsr/clock.zig).

All transport is real wire bytes; all persistence goes through the Storage
seam; ticks through the Time seam — the deterministic cluster and the
simulator run this exact code.

The port's copy of `tigerbeetle_tpu/vsr/replica.py`. Without a
`backend_factory` the replica builds the port's DeviceLedger on `device`:
"cuda" when None (the ledger raises where CUDA is missing), "cpu" for the
kernels' plain versions. It asks the backend to start each commit's result
copy at dispatch (`prefetch_results`).
"""

from __future__ import annotations

import dataclasses
import json as _json
from collections import deque
from time import perf_counter_ns

import numpy as np

from tigerbeetle_tpu_torch.constants import ConfigCluster, ConfigProcess
from tigerbeetle_tpu_torch.io.network import Network
from tigerbeetle_tpu_torch.io.storage import Storage
from tigerbeetle_tpu_torch.io.time import Time
from tigerbeetle_tpu_torch.kernels import LAUNCHES
from tigerbeetle_tpu_torch.latency import (
    LEG_DISPATCH,
    LEG_FINALIZE,
    LEG_FUSE,
    LEG_QUORUM,
    LEG_WAIT,
    LEG_WAL,
    LatencyAnatomy,
)
from tigerbeetle_tpu_torch.lsm.grid import GridBlockCorrupt
from tigerbeetle_tpu_torch.metrics import Metrics
from tigerbeetle_tpu_torch.models.ledger import DeviceLedger
from tigerbeetle_tpu_torch.state_machine import StateMachine
from tigerbeetle_tpu_torch.tracer import NULL_TRACER
from tigerbeetle_tpu_torch.types import ACCOUNT_DTYPE, TRANSFER_DTYPE, Operation
from tigerbeetle_tpu_torch.vsr.client_replies import ClientReplies
from tigerbeetle_tpu_torch.vsr.clock import Clock
from tigerbeetle_tpu_torch.vsr.durable import (
    check_config_fingerprint,
    persist_view,
    restore_from_snapshot,
    snapshot_to_superblock,
)
from tigerbeetle_tpu_torch.vsr.header import HEADER_SIZE, Command, Header
from tigerbeetle_tpu_torch.vsr.journal import Journal
from tigerbeetle_tpu_torch.vsr.superblock import SuperBlock

# Tick-based timeout constants (reference: src/vsr/replica.zig:2479-2843
# timeout table; values here are in ticks of the Time seam).
HEARTBEAT_TICKS = 4  # primary: commit heartbeat cadence
PING_TICKS = 8  # clock sync cadence
VIEW_CHANGE_TICKS = 40  # backup: silence before starting a view change
RETRY_TICKS = 16  # view-change message retry cadence
GRID_SCRUB_TICKS = 8  # forest-block scrub cadence (reference: grid scrubber)
GRID_SCRUB_BLOCKS = 8  # acquired blocks verified per scrub pass
WAL_SWEEP_TICKS = 64  # in-place-fault WAL re-verify cadence (1 MiB/pass)
# Client tables whose JSON exceeds this inline into the superblock meta;
# larger ones (many-session ingress mode) spill to a checkpoint blob —
# the 64 KiB superblock copy must also hold the rest of the meta.
CLIENT_TABLE_INLINE_MAX = 24 * 1024

# CDC reply-ring retention: only create-op replies (sparse failure
# structs) are kept for resume-from-WAL; read replies are large and the
# change stream encodes no records for reads.
_CDC_RETAIN_OPS = (
    int(Operation.create_accounts), int(Operation.create_transfers)
)

# DVC suffix NACK marker: a synthetic header whose `operation` proves the
# sender's slot for that op is BLANK — it never prepared the op (the
# reference's blank header in protocol-aware recovery, src/vsr.zig:302-304).
# Valid state-machine operations are 128-131; VSR ops are < 128.
OP_NACK = 255


class Replica:
    def __init__(
        self,
        replica_index: int,
        replica_count: int,
        storage: Storage,
        network: Network,
        time: Time,
        cluster: ConfigCluster,
        process: ConfigProcess,
        mode: str = "auto",
        backend_factory=None,
        standby_count: int = 0,
        spill_io: str = "deferred",
        metrics=None,
        tracer=None,
        device=None,
    ):
        # Observability seams (tigerbeetle_tpu/metrics.py, tracer.py): one
        # registry and one tracer per replica, threaded into the journal,
        # the ledger backend and the spill pipeline below, so every stage
        # of the commit path reports into the SAME store. The default
        # registry is always live (counters are cheap ints); the default
        # tracer is the no-op `none` backend.
        self.metrics = metrics if metrics is not None else Metrics()
        self.tracer = tracer if tracer is not None else NULL_TRACER
        # Per-request critical-path attribution (tigerbeetle_tpu/
        # latency.py): sampled requests are stamped at every pipeline
        # leg and fold into the latency.* histograms at reply egress.
        # The clock is the TIME SEAM's monotonic — simulator replicas
        # stamp with virtual ticks, so seeded runs stay byte-identical
        # with stamping on (tests/test_latency.py pins it).
        self.latency = LatencyAnatomy(
            metrics=self.metrics, clock=time.monotonic
        )
        # optional metrics.FlightRecorder (the server loop installs and
        # drives it ~1/s); _on_request_stats ships its history when set
        self.flight_recorder = None
        self.replica = replica_index
        self.replica_count = replica_count
        # Standbys (reference: src/vsr/replica.zig:163-175): replicas with
        # index >= replica_count follow the log — they journal prepares
        # and commit — but never ack, never vote, and never count toward
        # any quorum; a warm spare for operator-driven replacement.
        self.standby_count = standby_count
        self.standby = replica_index >= replica_count
        self.network = network
        self.time = time
        self.cluster = cluster
        # With a forest block area in the layout, the device ledger spills
        # its cold transfer tail to an LSM forest in the grid zone's tail
        # (models/spill.py) — same wiring as the single-replica
        # DurableLedger; checkpoints carry the spill meta and state sync
        # ships the forest blocks (see _on_request_sync_checkpoint).
        self.forest = None
        if backend_factory is not None:
            backend = backend_factory()
        else:
            if storage.layout.forest_blocks:
                from tigerbeetle_tpu_torch.lsm.grid import Grid
                from tigerbeetle_tpu_torch.lsm.groove import Forest

                self.forest = Forest(Grid(
                    storage,
                    offset=storage.layout.forest_offset,
                    block_count=storage.layout.forest_blocks,
                ), memtable_max=getattr(process, "lsm_memtable_max", 2048))
            # The replica's spill/grid IO rides the SpillManager executor
            # seam instead of running inline in the commit path:
            # "deferred" (default) queues LSM insertion and runs it at the
            # tick boundary (models/spill.py DeferredSpillIO) — the commit
            # dispatch never executes LSM work, grid allocation order stays
            # the FIFO job order (deterministic across replicas, which
            # repair-by-address depends on), and seeded simulator runs
            # never depend on thread timing. "threaded" (production
            # servers, real time) moves the same jobs to a worker thread
            # for wall-clock overlap; the scrub pass skips a turn while
            # worker inserts are in flight (_scrub_grid).
            backend = DeviceLedger(process, mode=mode, device=device,
                                   forest=self.forest,
                                   spill_io=spill_io)
        if hasattr(backend, "prefetch_results"):
            # the replica drains results to serve replies: start copies at
            # dispatch (a fetch-free driver like the flagship bench must
            # NOT — see DeviceLedger.prefetch_results)
            backend.prefetch_results = True
        # Dual-commit follower plan (`--backend dual`, models/dual_ledger):
        # the native engine serves replies while the device applier follows
        # the committed op stream — this replica enqueues each create op at
        # commit FINALIZE (apply_commit), drains the applier before any
        # state-replacing transition, and feeds the applier's bounded-lag
        # excess into admission (ingress_occupancy / the _on_request cap).
        self._dual_apply = bool(getattr(backend, "dual_follower", False))
        self.ledger = backend
        # thread the observability seams through the stack: the backend's
        # staging fences, the spill pipeline (prefetch/admit/cycle spans)
        # and the WAL writes all report into this replica's registry
        if hasattr(backend, "instrument"):
            backend.instrument(self.metrics, self.tracer)
        else:
            spill = getattr(backend, "spill", None)
            if spill is not None and hasattr(spill, "instrument"):
                spill.instrument(self.metrics, self.tracer)
        self.sm = StateMachine(backend, cluster.message_size_max)
        self.journal = Journal(storage, cluster)
        self.journal.metrics = self.metrics
        self.journal.tracer = self.tracer
        self.superblock = SuperBlock(storage)
        self.client_replies = ClientReplies(storage, cluster)
        self.storage = storage
        self.clock = Clock(replica_index, replica_count, time)

        self.status = "recovering"
        self.view = 0
        self.log_view = 0  # latest view in which status was normal
        self.op = 0  # highest prepared op
        self.commit_min = 0  # highest committed op
        self.commit_max = 0  # highest known-committed op cluster-wide
        self.parent_checksum = 0  # checksum of prepare `self.op`
        self.commit_checksum = 0  # checksum of prepare `self.commit_min`
        self.checkpoint_op = 0

        # primary state
        self.pipeline: dict[int, dict] = {}  # op -> {header, body, oks}
        # replicated session state: client_id -> {session, request, reply}
        self.client_table: dict[int, dict] = {}
        # backup reorder buffer for out-of-order prepares
        self._pending_prepares: dict[int, tuple[Header, bytes]] = {}

        # repair state: ops whose prepares we asked peers for
        self._repair_wanted: set[int] = set()
        # last tick we asked a peer for a full checkpoint (rate limit)
        self._sync_request_tick = -RETRY_TICKS
        # Commit-stage overlap (reference: src/vsr/replica.zig:52-70
        # CommitStage; :3045-3103 commit_dispatch): with commit_window > 0,
        # device commits are DISPATCHED asynchronously (CUDA launches
        # — the launch is queued, the host returns immediately) and their
        # results drained later, so the journal write + broadcast of op N+1
        # overlap the device execution of op N. 0 = fully synchronous
        # (deterministic tests). The event loop calls flush_commits() when
        # idle; state-changing transitions (checkpoint, view change, state
        # sync) flush first.
        self.commit_window = 0
        # Group-commit fuse window (ns): with commit_window > 0, a
        # quorum-ready run of fewer than GROUP_MAX create_transfers
        # prepares may be HELD for up to this long — but only while
        # earlier commits are still in flight, so the engine never idles —
        # letting requests that arrive within the window coalesce into ONE
        # fused device dispatch per quorum run instead of a solo dispatch
        # per pump turn (reference: the commit pipeline overlaps stages
        # the same way, src/vsr/replica.zig:5102-5186). 0 disables the
        # hold; commit_window == 0 (deterministic tests) never defers.
        self.fuse_window_ns = 2_000_000
        self._fuse_started: int | None = None
        # Fuse-window AUTOTUNE (opt-in; the server CLI turns it on by
        # default): AIMD on hold outcomes — a hold that EXPIRES with its
        # run still short means arrivals are spaced wider than the window
        # (widen ×1.25); a run that fills to GROUP_MAX while a hold is
        # open means the window over-covers the arrival spacing (shrink
        # ×0.95 to shed hold latency). Bounded so a quiet wire cannot
        # climb the window into client-visible latency. Only active with
        # commit_window > 0 (deterministic harnesses never hold).
        self.fuse_autotune = False
        self.fuse_window_min_ns = 500_000
        self.fuse_window_max_ns = 8_000_000
        self._inflight: deque[dict] = deque()
        # grid repair state: forest-block addresses awaiting peer repair
        # (reference: src/vsr/grid_blocks_missing.zig)
        self._grid_missing: set[int] = set()
        self._scrub_cursor = 0
        self._wal_scrub_cursor = 1  # continuous WAL repair sweep position
        # group-commit observability (BENCH reports the hit rate): ops
        # committed via a fused device dispatch vs per-op fallback, plus
        # the group count (fused_ops / fused_groups = mean fusion width).
        # A registry-backed Mapping: readers keep dict access, the storage
        # lives in self.metrics (the shared pipeline registry).
        self.group_stats = self.metrics.group(
            "commit.group",
            # fuse_holds/fuse_expired instrument WHY a hit rate is what it
            # is: holds that expired short mean the window lost the race
            # against arrival spacing (the autotune's widen signal), while
            # a high hit rate with zero holds means runs formed without
            # deferral (the window is irrelevant, not well-tuned)
            # wave_ops/wave_dispatches: ops whose batch ran the
            # conflict-wave scheduler (dependent transfers executed as
            # dependency-ordered waves instead of a whole-batch serial
            # scan), and the total waves those ops dispatched
            ("fused_ops", "solo_ops", "fused_groups", "fuse_holds",
             "fuse_expired", "wave_ops", "wave_dispatches"),
        )
        # commit-pipeline timing histograms (metrics.py CATALOG for units)
        self._h_quorum = self.metrics.histogram("replica.quorum_wait_us")
        self._h_dispatch = self.metrics.histogram("replica.commit_dispatch_us")
        self._h_finalize = self.metrics.histogram("replica.commit_finalize_us")
        self._h_fuse = self.metrics.histogram("replica.fuse_hold_us")
        self._fuse_token = 0  # open fuse_hold trace span, if any
        # test/simulator observation hook: called on every committed prepare
        self.commit_hook = None
        # observation hook on every reply built at finalize (hash_log:
        # reply checksums capture result codes, so kernel nondeterminism
        # across runs surfaces even when the logs match)
        self.reply_hook = None
        # optional append-only disaster-recovery log (reference: src/aof.zig,
        # hooked before the reply at src/vsr/replica.zig:3643-3648)
        self.aof = None
        # CDC seam (tigerbeetle_tpu/cdc): cdc_hook(header, body, reply_body)
        # fires once per op at commit FINALIZE, in op order, with the reply
        # buffer the replica materialized for the client anyway — the
        # change-stream pump's live tail (no new d2h, no copies). With
        # cdc_retain on, the replies of the last journal_slot_count ops are
        # kept in cdc_replies (tiny: sparse failure structs, usually empty)
        # so a pump resuming from the WAL ring can rebuild exact records
        # for ops it missed while down.
        self.cdc_hook = None
        # Ingress gateway seam: called with the victim client id when a
        # register at clients_max evicts the oldest session, so the
        # gateway's session table tracks the replica's — without it,
        # evicted sessions on a still-open multiplexed connection would
        # pin the gateway's sessions_max cap forever (conn close never
        # fires while other sessions keep the connection alive).
        self.ingress_evict_hook = None
        # checkpoint state commitments (federation/commitment.py): when a
        # CommitmentLog is installed (cli --commitment-interval, the
        # federation harness, SimFederation), every boundary op's commit
        # dispatch folds the backend's state fingerprint into the chain;
        # the ring persists in checkpoint meta and ships via state sync.
        self.commitment_log = None
        self.cdc_retain = False
        self.cdc_replies: dict[int, bytes] = {}
        # Finalized-op watermark: with an async commit window, commit_min
        # advances at DISPATCH while replies materialize at finalize — a
        # pump bounded by commit_min would race ahead of the hook and
        # stream ops whose reply buffers don't exist yet. This is the
        # stream-safe bound: the highest op whose finalize has run (or
        # that a restore/state-sync declared executed elsewhere).
        self.cdc_commit_min = 0

        # Durable reply-slot free list (client_replies zone): maintained
        # incrementally so a register is O(1) — with the ingress gateway
        # multiplexing tens of thousands of sessions, the old per-register
        # scan over the whole client table was O(sessions^2) across a
        # connect storm. None = rebuild lazily from the table (set at
        # every point the table is wholesale replaced).
        self._reply_slots_free: list[int] | None = None

        # tick + view-change state
        self.ticks = 0
        self._primary_contact_tick = 0
        self._recover_tick = 0
        self._vc_tick = 0
        self._vc_retries = 0
        self.view_candidate = 0
        self._svc_votes: set[int] = set()
        self._dvc: dict[int, tuple[Header, list[Header]]] = {}
        self._adopt: dict[int, Header] | None = None  # op -> wanted header
        self._adopt_commit_max = 0

        network.attach(replica_index, self._on_message)

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    @property
    def primary_index(self) -> int:
        return self.view % self.replica_count

    @property
    def is_primary(self) -> bool:
        return self.replica == self.primary_index and self.status == "normal"

    @property
    def quorum_replication(self) -> int:
        return self.replica_count // 2 + 1

    @property
    def quorum_view_change(self) -> int:
        return self.replica_count // 2 + 1

    # -- ingress saturation signal + reply-slot allocator --------------

    def ingress_occupancy(self) -> tuple[int, int]:
        """(used, capacity) of the commit pipeline — the admission signal
        the ingress gateway's credit regulator reads every request (so it
        must stay O(1)). `used` counts quorum-pending pipeline entries
        plus dispatched-but-unfinalized commits beyond the steady async
        window; `capacity` is the same cap _on_request backpressures at,
        so the gateway sheds with a typed busy reply just before the
        replica would start dropping silently."""
        cap = max(
            self.cluster.pipeline_prepare_queue_max, 2 * self.commit_window
        )
        backlog = max(0, len(self._inflight) - max(1, self.commit_window))
        used = len(self.pipeline) + backlog
        if self._dual_apply:
            # dual-commit bounded-lag backpressure: device-applier lag
            # beyond its window counts as occupancy, so the credit
            # regulator sheds (typed busy replies) BEFORE the bounded
            # apply queue's put() would stall the event loop
            used += self.ledger.apply_lag_excess()
        return used, cap

    def _reply_slot_alloc(self) -> int | None:
        """Pop a free client_replies slot (None when every slot is owned
        — the session registers without durable reply persistence)."""
        if self._reply_slots_free is None:
            used = {
                e.get("slot") for e in self.client_table.values()
            } - {None}
            self._reply_slots_free = [
                i for i in range(self.client_replies.slot_count - 1, -1, -1)
                if i not in used
            ]
        return self._reply_slots_free.pop() if self._reply_slots_free else None

    def _reply_slot_release(self, slot: int | None) -> None:
        if slot is not None and self._reply_slots_free is not None:
            self._reply_slots_free.append(slot)

    def open(self) -> None:
        """Superblock -> snapshot -> WAL replay (same recovery as the
        single-replica DurableLedger, then join the cluster)."""
        state = self.superblock.open()
        check_config_fingerprint(state, self.cluster)
        restore_from_snapshot(
            self.storage, self.ledger, self.sm, self.ledger.process, state
        )
        self.client_table = {
            int(c): dict(e, reply=None)
            for c, e in self._load_client_table(state).items()
        }
        self._reply_slots_free = None  # rebuilt from the restored table
        self._restore_client_replies()
        persisted_view = int(state.meta.get("view", 0))
        persisted_log_view = int(state.meta.get("log_view", persisted_view))
        self.view = self.log_view = persisted_log_view
        self.checkpoint_op = state.commit_min
        self.commit_min = self.commit_max = self.op = state.commit_min
        self.cdc_commit_min = state.commit_min  # executed pre-restart
        if self.commitment_log is not None:
            # restore BEFORE the WAL-tail replay below: replayed boundary
            # ops re-record against the restored head (the persisted head
            # is the last boundary <= the checkpoint's commit_min, so the
            # replay's boundaries extend the chain contiguously)
            self.commitment_log.restore(state.meta.get("commitments"))
        self.parent_checksum = self.commit_checksum = state.commit_min_checksum
        recovered = self.journal.recover()
        op = state.commit_min + 1
        while op in recovered:
            header, body = self.journal.read_prepare(op)  # type: ignore
            if header.parent != self.parent_checksum:
                # Stale-timeline slot: a crash between OUT-OF-ORDER async
                # WAL writes (write N lost, write N+1 landed) leaves a gap;
                # after restart re-fills the gap on a new timeline, the
                # surviving higher slot no longer chains. No reply can have
                # left for it (replies finalize in op order, each waiting
                # its own WAL future), so the chain — and durability —
                # ends at the last op that chains.
                break
            if self.replica_count == 1 and not self.standby:
                # Single replica: every journaled op was committed (WAL is
                # written before execution, and there is no one else).
                self._commit_prepare(header, body)
                self.commit_min = self.commit_max = op
                self.commit_checksum = header.checksum
            # Multi-replica: the WAL tail is PREPARED, not necessarily
            # committed — rebuild the log head only; the cluster's commit
            # numbers (SV / heartbeats) drive execution through
            # _commit_up_to, and divergent tails get truncated by adoption.
            self.op = op
            self.parent_checksum = header.checksum
            op += 1
        if self.replica_count == 1 and not self.standby:
            # Destroy journal evidence above the replay head: slots beyond a
            # gap or chain break are unreachable stale timelines (never
            # acked — see the ordering argument above), and left in place
            # they would be re-filled piecemeal and crash-loop a SECOND
            # restart on the broken chain. Multi-replica keeps its tail:
            # acked prepares above a torn slot are DVC evidence that
            # protocol-aware recovery needs (adoption truncates instead).
            self.journal.invalidate_above(self.op)
        genesis = state.sequence == 1 and self.op == 0
        if self.replica_count == 1 or genesis:
            # Cold boot of a fresh cluster (or single replica): view 0 with
            # replica 0 as primary is the trusted starting point.
            self.status = "normal"
        else:
            # RESTART: our replayed log is only a candidate — we may have
            # missed commits (torn WAL tail) or whole views. Never resume as
            # primary on local evidence (reference: status=recovering until
            # a start_view arrives). Ask the presumed primary for an SV; the
            # recovering timeout forces a re-election if nobody answers.
            self.status = "recovering"
            self._recover_tick = self.ticks
            rsv = Header(
                command=int(Command.request_start_view), view=self.view
            )
            self._broadcast(rsv)
        self._primary_contact_tick = self.ticks
        # Crashed mid-view-change (view voted > last normal view): resume
        # the view change rather than acting normal in a view we never
        # finished entering (self-promotion would bypass the DVC quorum).
        if persisted_view > self.log_view:
            self._start_view_change(persisted_view)

    def checkpoint(self) -> None:
        """Durably snapshot the committed state AT commit_min (pipelined
        ops beyond it stay replayable in the WAL). The replicated client
        table rides in the snapshot meta — it is part of the replicated
        state (reference: src/vsr/superblock.zig ClientSessions trailer)."""
        with self.tracer.span("replica.checkpoint", op=self.commit_min), \
                self.metrics.histogram("replica.checkpoint_us").time():
            self._checkpoint()
        self.metrics.counter("replica.checkpoints").add()

    def _checkpoint(self) -> None:
        self.flush_commits()  # snapshot sees finalized client-table state
        if self._dual_apply:
            # dual-commit contract: the device applier drains to the
            # checkpoint's commit_min before the snapshot is cut, so the
            # checkpoint never races an in-flight device apply and the
            # applier's lag is re-bounded at every checkpoint
            self._drain_applier_checked("checkpoint")
        # Queued reply-slot writes must land before the client table (with
        # their checksums) is persisted: a crash after the superblock commit
        # but before a queued write would record a reply_checksum for bytes
        # that never hit disk — that session's duplicate requests would be
        # dropped forever (reply absent, request number already recorded).
        self.journal.drain_io()
        table = {
            str(c): {
                "session": e["session"],
                "request": e["request"],
                "slot": e.get("slot"),
                "reply_checksum": str(e.get("reply_checksum", 0)),
            }
            for c, e in self.client_table.items()
        }
        extra_meta = {"view": self.view, "log_view": self.log_view}
        if self.commitment_log is not None:
            # the chain rides checkpoint meta (and therefore state-sync
            # shipping): a restored/synced replica resumes the chain from
            # the last boundary at or before this checkpoint's commit_min
            extra_meta["commitments"] = self.commitment_log.snapshot()
        extra_blobs = None
        encoded = _json.dumps(table, sort_keys=True).encode()
        if len(encoded) > CLIENT_TABLE_INLINE_MAX:
            # many-session ingress mode: the table no longer fits the
            # 64 KiB superblock copy — spill it to a checkpoint blob in
            # the grid area (rides the same sync-shipping machinery;
            # _load_client_table reads it back by name)
            extra_meta["client_table_blob"] = True
            extra_blobs = [("client_table", encoded)]
        else:
            extra_meta["client_table"] = table
        snapshot_to_superblock(
            self.storage, self.ledger, self.sm, self.superblock,
            commit_min=self.commit_min,
            commit_min_checksum=self.commit_checksum,
            extra_meta=extra_meta,
            extra_blobs=extra_blobs,
        )
        self.checkpoint_op = self.commit_min

    def _load_client_table(self, state) -> dict:
        """The checkpointed client table: inline in the superblock meta,
        or — when a many-session table overflowed the copy — from its
        grid blob (written by _checkpoint, shipped by state sync)."""
        if not state.meta.get("client_table_blob"):
            return state.meta.get("client_table", {})
        from tigerbeetle_tpu_torch import native
        from tigerbeetle_tpu_torch.io.storage import Zone

        for ref in state.blobs:
            if ref.name == "client_table":
                raw = self.storage.read(Zone.grid, ref.offset, ref.size)
                if native.checksum(raw) != ref.checksum:
                    raise RuntimeError(
                        "client_table checkpoint blob: bad checksum"
                    )
                return _json.loads(raw.decode())
        raise RuntimeError(
            "checkpoint flags a client_table blob but the superblock "
            "references none"
        )

    def _drain_applier_checked(self, where: str) -> None:
        """Drain the dual-commit device applier and make a timeout LOUD:
        proceeding with applies still in flight breaks the
        drain-before-snapshot/restore contract, and a later parity
        failure at finalize would be undebuggable back to this cause
        without the record."""
        if not self.ledger.drain_applier():
            self.metrics.counter("shadow.drain_timeouts").add()
            import sys as _sys

            _sys.stderr.write(
                f"[dual] WARNING: device applier drain timed out at "
                f"{where} (lag {self.ledger.apply_lag_ops()} ops) — "
                "device parity is no longer assured for this run\n"
            )

    def _maybe_checkpoint(self, next_op: int) -> None:
        """WAL-wrap guard: never let a prepare overwrite an op that is not
        covered by a checkpoint (reference: src/vsr.zig:2003-2035 keeps a
        bar of headroom)."""
        if next_op - self.checkpoint_op >= self.cluster.checkpoint_interval:
            self.checkpoint()  # snapshots at commit_min
        assert next_op - self.checkpoint_op < self.cluster.journal_slot_count, (
            "WAL would wrap uncommitted ops: pipeline stuck"
        )

    # ------------------------------------------------------------------
    # ticks / timeouts
    # ------------------------------------------------------------------

    def tick(self) -> None:
        self.ticks += 1
        spill = getattr(self.ledger, "spill", None)
        if spill is not None:
            # run deferred LSM insert jobs (or reap finished worker jobs)
            # at the tick boundary — never inside the commit dispatch path
            try:
                spill.io_pump()
            except GridBlockCorrupt as e:
                # a threaded worker's settle hit a corrupt block: route it
                # to peer repair instead of crashing the event loop (the
                # staged rows keep serving fetches; the tree's compaction
                # debt resumes at the next settle once healed)
                if not self._request_block_repair([e.address]):
                    raise
        self.pump_commits()  # deferred group commits (event-loop safety)
        # finalize whatever results have LANDED (never block the tick on
        # in-flight device compute; the idle-loop flush and the next ticks
        # drain the rest as it lands)
        self.flush_commits(only_ready=True)
        if self.status == "normal":
            if self.is_primary:
                if self.ticks % HEARTBEAT_TICKS == 0:
                    h = Header(command=int(Command.commit), commit=self.commit_max)
                    self._broadcast(h)
                if self.ticks % RETRY_TICKS == 0 and self.pipeline:
                    # Prepare timeout: retransmit the oldest unacked prepare
                    # (its broadcast may have been lost; backups re-ack
                    # duplicates; reference: prepare_timeout).
                    entry = self.pipeline[min(self.pipeline)]
                    h, body = entry["header"], entry["body"]
                    for r in range(self.replica_count):
                        if r != self.replica and r not in entry["oks"]:
                            self.network.send(
                                self.replica, r, h.to_bytes() + body
                            )
            else:
                if self.ticks - self._primary_contact_tick > VIEW_CHANGE_TICKS:
                    self._start_view_change(self.view + 1)
            if self.ticks % PING_TICKS == 0:
                ping = Header(command=int(Command.ping), op=self.time.monotonic())
                self._broadcast(ping)
            if (
                self.forest is not None
                and self.replica_count > 1
                and self.ticks % GRID_SCRUB_TICKS == 0
            ):
                self._scrub_grid()
            if self.replica_count > 1 and self.ticks % GRID_SCRUB_TICKS == 0:
                self._scrub_wal()
            if self._grid_missing and self.ticks % RETRY_TICKS == 0:
                self._request_block_repair(())  # retransmit lost requests
            if (
                getattr(self, "_sync_payload_cache", None) is not None
                and self.ticks - self._sync_payload_tick > 4 * RETRY_TICKS
            ):
                # the full checkpoint image (tens of MiB) must not stay
                # pinned after the lagging replica finished its transfer
                self._sync_payload_cache = None
        elif self.status == "recovering":
            if self.ticks - self._recover_tick > VIEW_CHANGE_TICKS:
                # Nobody sent a start_view (the cluster may lack a primary):
                # force a re-election; best-log selection recovers commits.
                self._start_view_change(self.view + 1)
            elif self.ticks % RETRY_TICKS == 0:
                rsv = Header(
                    command=int(Command.request_start_view), view=self.view
                )
                self._broadcast(rsv)
        elif self.status == "view_change":
            if self.ticks - self._vc_tick > RETRY_TICKS:
                self._vc_retries += 1
                if self._adopt is not None and self._vc_retries < 4:
                    # Mid-adoption: re-request missing fills (lost packets),
                    # don't abandon the view change while it can progress.
                    self._vc_tick = self.ticks
                    self._repair_wanted.clear()
                    self._request_catchup_window()
                    for op, h in self._adopt.items():
                        got = self.journal.read_prepare(op)
                        if got is None or got[0].checksum != h.checksum:
                            self._request_prepare(op, self._adopt_src)
                elif self._vc_retries >= 2:
                    # The candidate view is not completing (its primary may
                    # be down too): escalate to the next view (reference:
                    # view_change_status_timeout increments the view).
                    self._start_view_change(self.view_candidate + 1)
                else:
                    self._vc_tick = self.ticks
                    svc = Header(
                        command=int(Command.start_view_change),
                        view=self.view_candidate,
                    )
                    self._broadcast(svc)
                    if len(self._svc_votes) >= self.quorum_view_change:
                        self._send_do_view_change()

    # ------------------------------------------------------------------
    # message dispatch
    # ------------------------------------------------------------------

    def _on_message(self, src, data: bytes) -> None:
        header = Header.from_bytes(data[:HEADER_SIZE])
        if not header.valid_checksum():
            return  # corrupt: drop (reference: message_bus checksum gate)
        body = data[HEADER_SIZE : header.size]
        if not header.valid_checksum_body(body):
            return
        cmd = Command(header.command)
        # Commands valid in any status:
        if cmd == Command.ping:
            pong = Header(
                command=int(Command.pong), op=header.op,
                timestamp=self.clock.realtime(),
            )
            self._send(header.replica, pong)
            return
        if cmd == Command.pong:
            self.clock.learn(
                header.replica, header.op, header.timestamp,
                self.time.monotonic(),
            )
            return
        if cmd == Command.ping_client:
            # Client view discovery (reference: src/vsr/replica.zig
            # on_ping_client): answer only in normal status — the pong's
            # view (stamped by _send) tells an idle client where the
            # primary is, so its next request targets the current view.
            if self.status == "normal" and header.client:
                pong = Header(
                    command=int(Command.pong_client), client=header.client
                )
                self._send(header.client, pong)
            return
        if cmd == Command.request_stats:
            self._on_request_stats(header)
            return
        if cmd == Command.mark:
            self._on_mark(header, body)
            return
        if cmd == Command.request_prepare:
            self._on_request_prepare(header)
            return
        if cmd == Command.request_blocks:
            self._on_request_blocks(header, body)
            return
        if cmd == Command.block:
            self._on_block(header, body)
            return
        if cmd == Command.request_sync_manifest:  # request full checkpoint
            self._on_request_sync_checkpoint(header)
            return
        if cmd == Command.sync_manifest:  # checkpoint (state + trailers)
            self._on_sync_checkpoint(header, body)
            return
        if cmd == Command.start_view_change:
            self._on_start_view_change(header)
            return
        if cmd == Command.do_view_change:
            self._on_do_view_change(header, body)
            return
        if cmd == Command.start_view:
            self._on_start_view(header, body)
            return
        if cmd == Command.request_start_view:
            self._on_request_start_view(header)
            return

        if self.status == "view_change":
            if header.view > self.view_candidate and cmd in (
                Command.prepare, Command.commit
            ):
                # the cluster moved past our candidate view: catch up via
                # the authoritative start_view instead of slow escalation
                rsv = Header(
                    command=int(Command.request_start_view), view=header.view
                )
                self._send(header.view % self.replica_count, rsv)
                return
            if cmd == Command.prepare:
                self._on_repair_prepare(header, body)
                return
        if self.status == "recovering":
            if cmd in (Command.prepare, Command.commit) and header.view >= self.view:
                # a live primary exists: ask it for the current start_view
                rsv = Header(
                    command=int(Command.request_start_view), view=header.view
                )
                self._send(header.view % self.replica_count, rsv)
            return
        if self.status != "normal":
            return
        # A message from a newer view: we missed a view change — catch up.
        if header.view > self.view and cmd in (Command.prepare, Command.commit):
            rsv = Header(command=int(Command.request_start_view), view=header.view)
            self._send(header.view % self.replica_count, rsv)
            return
        if cmd == Command.request:
            self._on_request(header, body)
        elif cmd == Command.prepare:
            self._on_prepare(header, body)
        elif cmd == Command.prepare_ok:
            self._on_prepare_ok(header)
        elif cmd == Command.commit:
            self._on_commit(header)

    def _send(self, dst, header: Header, body: bytes = b"") -> None:
        header.set_checksum_body(body)
        header.replica = self.replica
        if header.view == 0 and header.command != int(Command.start_view_change):
            header.view = self.view
        header.cluster = self.superblock.state.cluster if self.superblock.state else 0
        header.set_checksum()
        self.network.send(self.replica, dst, header.to_bytes() + body)

    def _broadcast(self, header: Header, body: bytes = b"") -> None:
        # standbys receive the replicated stream too (prepares, commits,
        # SVs); they just never answer with votes or acks
        for r in range(self.replica_count + self.standby_count):
            if r != self.replica:
                self._send(r, dataclasses.replace(header), body)

    # ------------------------------------------------------------------
    # primary: request -> prepare
    # ------------------------------------------------------------------

    def _on_request(self, header: Header, body: bytes) -> None:
        if not self.is_primary:
            return  # client retries against the right primary
        client = header.client
        entry = self.client_table.get(client)
        operation = Operation(header.operation)

        if operation == Operation.register:
            # A register retransmit must not create a second session — the
            # client's real session would be silently replaced and its next
            # request evicted (reference: duplicate register replies from
            # the client table).
            if entry is not None:
                if entry["reply"] is not None:
                    self.network.send(self.replica, client, entry["reply"])
                elif entry["request"] == 0:
                    # reply bytes were lost across a restart/state sync, but
                    # the session number IS the stored entry: reconstruct
                    reply = Header(
                        command=int(Command.reply),
                        client=client,
                        request=0,
                        op=entry["session"],
                        commit=entry["session"],
                        operation=int(Operation.register),
                    )
                    body_r = entry["session"].to_bytes(8, "little")
                    reply.set_checksum_body(body_r)
                    reply.replica = self.replica
                    reply.view = self.view
                    reply.set_checksum()
                    wire = reply.to_bytes() + body_r
                    entry["reply"] = wire
                    self.network.send(self.replica, client, wire)
                return
        else:
            if entry is None or header.context != entry["session"]:
                self._send_eviction(client)
                return
            if header.request <= entry["request"]:
                if header.request == entry["request"] and entry["reply"] is not None:
                    self.network.send(self.replica, client, entry["reply"])
                return  # duplicate/stale: drop (reply resent above)
        # Retransmission of a request still awaiting quorum: already in
        # the pipeline — preparing it again would execute it twice
        # (reference: pipeline_prepare_queue message_by_client check).
        # Dispatched-but-unfinalized commits (async window) are equally
        # in flight: the client table only learns the request at finalize.
        for entry_p in self.pipeline.values():
            h = entry_p["header"]
            if (
                h.client == client
                and h.request == header.request
                and h.operation == header.operation
            ):
                return
        for entry_i in self._inflight:
            h = entry_i["header"]
            if h.client == client and h.request == header.request:
                return

        # Pipeline backpressure (reference: pipeline_prepare_queue_max=8):
        # while commits stall (lost quorum, partition), new requests must
        # not grow the uncommitted tail without bound — the WAL headroom is
        # finite. The client retries. With a commit window the cap widens
        # to hold one full turn of deferred group commits (still far under
        # the WAL-wrap guard).
        cap = max(
            self.cluster.pipeline_prepare_queue_max, 2 * self.commit_window
        )
        # Dual-commit mode: device-applier lag beyond its window throttles
        # admission here too (gateway-less deployments) — the client
        # retries, the lag stays bounded, the apply queue never wedges the
        # event loop on a blocking put.
        lag_excess = self.ledger.apply_lag_excess() if self._dual_apply else 0
        if len(self.pipeline) + lag_excess >= cap:
            return

        # Latency anatomy: the request survived dedup/backpressure and
        # will become an op — open the sampled record (keyed by the
        # cluster-causal trace id; the id derivation is paid only for
        # sampled requests). ingress_admission closes here: gateway
        # arrival (or now) -> admission+dedup done.
        lat = self.latency
        lt = lat.open(header.trace()) if lat.want() else 0
        op = self.op + 1
        assert op not in self.pipeline
        self._maybe_checkpoint(op)
        if operation != Operation.register:
            # Timestamp base: cluster-synchronized wall clock, clamped
            # monotonic (reference: src/vsr/replica.zig:5121-5131).
            rt = self.clock.realtime_synchronized()
            if rt is None:
                rt = self.clock.realtime()
            self.sm.prepare_timestamp = max(self.sm.prepare_timestamp, rt)
            self.sm.prepare(operation, body)
        prepare = Header(
            parent=self.parent_checksum,
            client=client,
            context=header.checksum,  # checksum of the client's request
            request=header.request,
            op=op,
            commit=self.commit_max,
            timestamp=(
                self.sm.prepare_timestamp
                if operation != Operation.register
                else self.time.realtime()
            ),
            command=int(Command.prepare),
            operation=int(operation),
            view=self.view,
            cluster=self.superblock.state.cluster if self.superblock.state else 0,
            replica=self.replica,
        )
        # The prepare's body IS the request's body: reuse the checksum the
        # request carried (verified on receive) instead of re-hashing the
        # full 1 MiB per prepare.
        prepare.size = HEADER_SIZE + len(body)
        prepare.checksum_body = header.checksum_body
        prepare.set_checksum()
        if self.commit_window > 0 and self.replica_count == 1:
            # async WAL (reference: journal write IOPS): the reply waits
            # on this future at finalize — WAL-before-ack holds while the
            # 1 MiB O_DSYNC write overlaps device commits + other requests.
            # Single replica only: a multi-replica primary's self-vote in
            # `oks` is an implicit ack, and acks require a DURABLE prepare
            # (a backup acks only after its synchronous write) — counting
            # an un-landed write toward quorum could commit an op with
            # fewer than quorum durable copies.
            wal = self.journal.write_prepare_async(prepare, body)
        else:
            self.journal.write_prepare(prepare, body)
            wal = None
        if lt:
            # sync path: the completed WAL write; async path: the submit
            # (the durable wait lands in commit_finalize; the write's
            # own submit->durable time is the latency.wal_lane_us lane)
            lat.stamp(lt, LEG_WAL)
            if self.quorum_replication == 1:
                # the self-vote below IS the quorum: close the leg now
                lat.stamp(lt, LEG_QUORUM)
        self.op = op
        self.parent_checksum = prepare.checksum
        self.pipeline[op] = {"header": prepare, "body": body,
                             "oks": {self.replica}, "wal": wal, "lt": lt,
                             # quorum-wait accounting: broadcast -> quorum
                             "t": perf_counter_ns(),
                             # ingress anchor of the op's causal trace:
                             # the id every later span derives from the
                             # prepare's (client, context) pair
                             "qtok": self.tracer.start(
                                 "replica.quorum_wait", op=op,
                                 trace=self._tid(prepare))}
        # Stream prepares to standbys too (they journal + commit but never
        # ack — _ack_prepare declines): without this a standby would learn
        # each op only via a commit heartbeat plus one request_prepare round
        # trip, lagging unboundedly under sustained load (the reference
        # streams prepares to standbys).
        for r in range(self.replica_count + self.standby_count):
            if r != self.replica:
                self.network.send(self.replica, r, prepare.to_bytes() + body)
        if self.commit_window > 0 and self.replica_count == 1:
            # defer to the event loop's end-of-pump pump_commits(): every
            # request that arrived this turn then commits as ONE fused
            # group instead of k separate device launches
            return
        self._maybe_commit_pipeline()

    def _restore_client_replies(self) -> None:
        """Repopulate reply bytes from the client_replies zone (restart
        path). Slots are validated against the checkpointed reply
        checksum, so stale bytes (state sync adopted a foreign table; a
        torn write; a newer uncheckpointed reply) read as absent and the
        reply-lost fallbacks apply."""
        for entry in self.client_table.values():
            slot = entry.get("slot")
            want = int(entry.get("reply_checksum", 0) or 0)
            if slot is None or not want:
                continue
            wire = self.client_replies.read(slot, want)
            if wire is not None:
                entry["reply"] = wire

    def _send_eviction(self, client: int) -> None:
        h = Header(command=int(Command.eviction), client=client)
        self._send(client, h)

    # ------------------------------------------------------------------
    # backup: prepare -> prepare_ok
    # ------------------------------------------------------------------

    def _on_prepare(self, header: Header, body: bytes) -> None:
        # Repair fills (any view):
        if header.op in self._repair_wanted:
            if header.op == self.op + 1 and header.parent == self.parent_checksum:
                # catch-up beyond our log head, verified by the hash chain
                self.journal.write_prepare(header, body)
                self.op = header.op
                self.parent_checksum = header.checksum
                self._repair_wanted.discard(header.op)
                self._ack_prepare(header)
                self._commit_up_to(self.commit_max)  # continues / asks next
                # drain buffered out-of-order successors (a normal prepare
                # may have been parked while this gap filled)
                nxt = self._pending_prepares.pop(self.op + 1, None)
                if nxt is not None:
                    self._on_prepare(*nxt)
                return
            # in-log gap (faulty slot): verified against the expected
            # checksum from the redundant-header mirror
            want = self.journal.get_header(header.op)
            if want is not None and want.checksum == header.checksum:
                if self.journal.read_prepare(header.op) is None:
                    self.journal.write_prepare(header, body)
                self._repair_wanted.discard(header.op)
                self._commit_up_to(self.commit_max)
                return
            # Unresolvable by point repair: our uncommitted tail above
            # commit_min is stale (left over from an abandoned view) and the
            # fill doesn't chain. Re-adopt the whole log via start_view —
            # adoption truncates to the committed prefix and reverifies.
            self._repair_wanted.discard(header.op)
            if self.status == "normal" and not self.is_primary:
                rsv = Header(
                    command=int(Command.request_start_view), view=self.view
                )
                self._send(self.primary_index, rsv)
            return
        if header.view < self.view or self.is_primary:
            return
        self._primary_contact_tick = self.ticks
        if header.op <= self.op:
            self._ack_prepare(header)  # duplicate: re-ack
            self._commit_up_to(header.commit)
            return
        if header.op > self.op + 1:
            self._pending_prepares[header.op] = (header, body)
            self._request_prepare(header.op - 1, header.replica)
            return
        if header.parent != self.parent_checksum:
            return  # chain break: resolved by the view-change/repair layer
        self._maybe_checkpoint(header.op)
        self.journal.write_prepare(header, body)
        self.op = header.op
        self.parent_checksum = header.checksum
        self._ack_prepare(header)
        self._commit_up_to(header.commit)
        # drain any buffered successors
        nxt = self._pending_prepares.pop(self.op + 1, None)
        if nxt is not None:
            self._on_prepare(*nxt)

    def _ack_prepare(self, prepare: Header) -> None:
        if self.standby:
            return  # standbys follow; they never contribute to quorums
        ok = Header(
            command=int(Command.prepare_ok),
            op=prepare.op,
            context=prepare.checksum,
            client=prepare.client,
            request=prepare.request,
            timestamp=prepare.timestamp,
            operation=prepare.operation,
        )
        self._send(self.primary_index, ok)

    # ------------------------------------------------------------------
    # repair: fetching missing prepares
    # ------------------------------------------------------------------

    def _request_prepare(self, op: int, from_replica: int) -> None:
        self._repair_wanted.add(op)
        rp = Header(command=int(Command.request_prepare), op=op)
        self._send(from_replica, rp)

    def _on_request_prepare(self, header: Header) -> None:
        got = self.journal.read_prepare(header.op)
        if got is None:
            return
        p_header, body = got
        self.network.send(
            self.replica, header.replica, p_header.to_bytes() + body
        )

    # ------------------------------------------------------------------
    # live introspection (`tigerbeetle inspect live`, inspect.py)
    # ------------------------------------------------------------------

    def _on_request_stats(self, header: Header) -> None:
        """Serve the live [stats] snapshot over the wire: the metric
        registry plus the consensus state an operator asks about first.
        Answered in ANY status — a wedged replica is exactly the one
        worth inspecting — and routed back to the asking client id (the
        bus learned the peer from this very frame)."""
        self.metrics.counter("inspect.live_requests").add()
        snap = {
            "replica": self.replica,
            "status": self.status,
            "view": self.view,
            "op": self.op,
            "commit_min": self.commit_min,
            "commit_max": self.commit_max,
            "checkpoint_op": self.checkpoint_op,
            "pipeline": len(self.pipeline),
            "inflight": len(self._inflight),
            "sessions": len(self.client_table),
            "metrics": self.metrics.snapshot(),
            # per-request breakdowns of the slowest sampled requests
            # (latency.py top-K ring) — `inspect live` renders them
            "latency_slowest": self.latency.slowest(limit=16),
            # this process's kernel launches by counter (the counts the
            # server's SIGTERM [stats] line carries as kernel_launches)
            "kernel_launches": dict(LAUNCHES),
        }
        if self.commitment_log is not None:
            snap["commitments"] = self.commitment_log.stats_snapshot()
        da = getattr(self.ledger, "device_anatomy", None)
        if da is not None:
            ds = da.slowest(limit=8)
            if ds:
                # dual mode: the slowest sampled APPLY items with their
                # commit_wait sub-leg breakdowns (latency.py DeviceAnatomy)
                snap["device_slowest"] = ds
        if self.flight_recorder is not None:
            # the time-series ring: `inspect live --watch` renders the
            # per-interval deltas/rates as they accumulate
            snap["history"] = self.flight_recorder.history()
        body = _json.dumps(snap, sort_keys=True).encode()
        if HEADER_SIZE + len(body) > self.cluster.message_size_max:
            # shed detail in layers, never validity: the full history is
            # the biggest payload — try the newest slice, then drop it
            if "history" in snap:
                snap["history"] = snap["history"][-30:]
                body = _json.dumps(snap, sort_keys=True).encode()
            if HEADER_SIZE + len(body) > self.cluster.message_size_max:
                snap.pop("history", None)
                body = _json.dumps(snap, sort_keys=True).encode()
        if HEADER_SIZE + len(body) > self.cluster.message_size_max:
            # a registry too large for one frame loses its detail, never
            # its validity: the consensus state is the part that must land
            snap["metrics"] = {"truncated": True}
            body = _json.dumps(snap, sort_keys=True).encode()
        reply = Header(command=int(Command.stats), client=header.client)
        self._send(header.client or header.replica, reply, body)

    def _on_mark(self, header: Header, body: bytes) -> None:
        """Phase marker (the prodday harness, inspect.send_mark): stamp
        the named scenario phase into the flight recorder so every
        subsequent per-interval entry — and therefore the SLO scorer's
        history slices — carries it. Served in ANY status (the driver
        marks phase boundaries straight through kills and view changes)
        and acked with a small `stats` frame so the driver knows the
        boundary landed before it changes the offered load."""
        self.metrics.counter("inspect.marks").add()
        name = body.decode(errors="replace")[:256]
        snap: dict = {"marked": name, "replica": self.replica}
        if self.flight_recorder is not None:
            snap["t"] = self.flight_recorder.set_phase(name)
        ack = _json.dumps(snap, sort_keys=True).encode()
        reply = Header(command=int(Command.stats), client=header.client)
        self._send(header.client or header.replica, reply, ack)

    # ------------------------------------------------------------------
    # grid block repair: a corrupt forest block heals from any peer that
    # holds an intact copy — no full state sync needed (reference:
    # src/vsr/grid_blocks_missing.zig + src/vsr/grid.zig:731). Detection
    # is (a) a periodic scrub pass over acquired blocks and (b) lazy, at
    # the read that trips GridBlockCorrupt in the commit path (which then
    # stalls that op and retries once the block is healed).
    # ------------------------------------------------------------------

    def _request_block_repair(self, addresses) -> bool:
        """Record missing blocks and ask ONE peer (rotating on retries —
        broadcasting would draw (n-1) duplicate 128 KiB replies per block;
        the reference's grid_blocks_missing requests from one replica at a
        time too). Returns False when repair is impossible (no forest /
        single replica) — the caller should treat corruption as fatal."""
        if self.forest is None or self.replica_count == 1:
            return False
        self.metrics.counter("grid.repair_requests").add()
        self._grid_missing.update(addresses)
        body = b"".join(
            a.to_bytes(8, "little") for a in sorted(self._grid_missing)
        )
        self._repair_peer_rotation = getattr(self, "_repair_peer_rotation", 0) + 1
        # 1 + (rot mod n-1) ∈ [1, n-1], so the offset never lands on self
        peer = (
            self.replica + 1 + (self._repair_peer_rotation % (self.replica_count - 1))
        ) % self.replica_count
        rq = Header(command=int(Command.request_blocks))
        self._send(peer, rq, body)
        return True

    def _on_request_blocks(self, header: Header, body: bytes) -> None:
        if self.forest is None:
            return
        grid = self.forest.grid
        for i in range(0, len(body), 8):
            a = int.from_bytes(body[i : i + 8], "little")
            if not (1 <= a <= grid.block_count):
                continue
            raw = grid.read_block_raw(a)  # verified: never spread corruption
            if raw is None:
                continue
            reply = Header(command=int(Command.block), op=a)
            self._send(header.replica, reply, raw)

    def _on_block(self, header: Header, body: bytes) -> None:
        if self.forest is None or header.op not in self._grid_missing:
            return
        spill = getattr(self.ledger, "spill", None)
        if spill is not None and spill.io_pending():
            # a threaded worker may be mid-settle on grid state (a freed
            # address can be re-acquired mid-install): defer — the block
            # stays in _grid_missing and the tick-cadence retry re-requests
            return
        grid = self.forest.grid
        # A late duplicate reply must not overwrite an address that has
        # healed and since been released + reused — the stale bytes carry
        # a valid checksum, so the clobber would be silent.
        if grid.free_set.is_free(header.op) or grid.verify_block(header.op):
            self._grid_missing.discard(header.op)
        elif grid.install_block_raw(header.op, body):
            self._grid_missing.discard(header.op)
        else:
            return  # corrupt in flight: the tick retry re-requests
        if not self._grid_missing and self.status == "normal":
            # healed: retry whatever stalled on the corrupt block
            if self.is_primary:
                self._maybe_commit_pipeline()
            else:
                self._commit_up_to(self.commit_max)

    def _scrub_grid(self) -> None:
        """Verify a few acquired forest blocks per pass, round-robin
        (the reference's grid scrubber): corruption below the WAL is found
        and repaired from peers BEFORE a commit needs the block."""
        spill = getattr(self.ledger, "spill", None)
        if spill is not None and spill.io_pending():
            # inserts in flight: a threaded worker may be mid-write on a
            # freshly acquired block — verifying it now would misreport
            # corruption (deferred mode: the tick pump already emptied the
            # queue, so this never skips there)
            return
        grid = self.forest.grid
        checked = scanned = 0
        a = self._scrub_cursor
        n = grid.block_count
        corrupt = []
        while checked < GRID_SCRUB_BLOCKS and scanned < n:
            a = a % n + 1
            scanned += 1
            if grid.free_set.is_free(a):
                continue
            checked += 1
            if not grid.verify_block(a):
                corrupt.append(a)
        self._scrub_cursor = a
        if corrupt:
            self._request_block_repair(corrupt)

    def _scrub_wal(self) -> None:
        """Continuous WAL repair in NORMAL status (reference: the replica
        repairs faulty journal slots outside view changes,
        src/vsr/replica.zig:5248-5654 — not only during adoption): refetch
        every slot the recovery scan classified TORN (redundant header
        survives, body lost — vsr/journal.py recover), plus a slow
        round-robin sweep that re-verifies one live slot per pass to catch
        in-place media faults after recovery. Fills arrive via the
        _repair_wanted path in _on_prepare, verified against the mirror
        header's checksum."""
        # peer rotation includes the tick so a down peer doesn't pin an op
        def ask(op: int) -> None:
            rot = (op + self.ticks // RETRY_TICKS) % (self.replica_count - 1)
            self._request_prepare(
                op, (self.replica + 1 + rot) % self.replica_count
            )

        faulty = getattr(self.journal, "faulty", None)
        if faulty:
            for slot, op in list(faulty.items()):
                h = self.journal.get_header(op)
                if h is None or h.op != op:
                    # the ring wrapped: a newer op overwrote the slot — the
                    # torn op is beyond repair relevance (without this the
                    # scrub would re-request the superseded op forever)
                    del faulty[slot]
                    continue
                if self.journal.read_prepare(op) is not None:
                    del faulty[slot]  # healed (repair fill landed)
                    continue
                ask(op)  # re-request each pass: lost requests retry
        # slow sweep for IN-PLACE media faults (after recovery): one full
        # 1 MiB slot re-verify per WAL_SWEEP_TICKS — a deliberately low
        # cadence; the verify is a synchronous read on the event loop
        if self.ticks % WAL_SWEEP_TICKS != 0:
            return
        lo = max(1, self.op - self.cluster.journal_slot_count + 1)
        if lo > self.op:
            return
        op = self._wal_scrub_cursor
        if not (lo <= op <= self.op):
            op = lo
        h = self.journal.get_header(op)
        if h is not None and self.journal.read_prepare(op) is None:
            ask(op)
        self._wal_scrub_cursor = op + 1 if op < self.op else lo

    # ------------------------------------------------------------------
    # state sync: checkpoint shipping for replicas lagging beyond the WAL
    # (reference: src/vsr/sync.zig — a lagging replica jumps to a newer
    # checkpoint, then repairs the remaining WAL tail normally)
    # ------------------------------------------------------------------

    def _sync_checkpoint_payload(self) -> tuple[bytes, int] | None:
        """(full image, checksum) to ship: state + snapshot blobs +
        (spill) forest blocks. Cached per superblock sequence — rebuilding
        or re-hashing per chunk request would be O(image) each.

        With sync_payload_async (production default), the O(checkpoint)
        read+hash runs on a side thread and requests arriving mid-build get
        no reply (the lagging peer's tick-cadence retry is the backpressure)
        — serving a sync must never stall the event loop for the whole
        image (reference: src/vsr/sync.zig streams trailers in chunks).
        Deterministic harnesses set sync_payload_async=False (thread timing
        must not leak into seeded runs). Consistency: the blob areas of the
        live sequence are immutable (ping-pong), and forest-block reuse is
        staged until the NEXT checkpoint — a checkpoint advancing mid-build
        changes the sequence and the stale build is discarded."""
        state = self.superblock.state
        if state is None or state.commit_min == 0:
            return None
        spill = getattr(self.ledger, "spill", None)
        if spill is not None:
            # the image reads the forest block area: queued spill inserts
            # must land first (drained HERE, on the event loop — the side
            # thread must not touch the executor's job list)
            spill.io_drain()
        cached = getattr(self, "_sync_payload_cache", None)
        if cached is not None and cached[0] == state.sequence:
            self._sync_payload_tick = self.ticks
            return cached[1], cached[2]
        if getattr(self, "sync_payload_async", True):
            fut = getattr(self, "_sync_payload_fut", None)
            if fut is not None:
                if not fut.done():
                    return None  # still building: the peer retries
                self._sync_payload_fut = None
                try:
                    seq, full, checksum = fut.result()
                except Exception:
                    # a failed build (transient IO error on the side
                    # thread) must not crash the event loop to serve an
                    # OPTIONAL sync — drop it; the peer's retry rebuilds
                    return None
                if seq == state.sequence:
                    self._sync_payload_cache = (seq, full, checksum)
                    self._sync_payload_tick = self.ticks
                    return full, checksum
                # checkpoint advanced mid-build: fall through, rebuild
            # a daemon thread + bare Future (not a ThreadPoolExecutor):
            # replicas have no close() hook, and a pool's non-daemon worker
            # would outlive the replica and stall interpreter exit behind
            # an O(checkpoint) build
            import threading
            from concurrent.futures import Future

            fut = Future()

            def _build(state=state, fut=fut):
                try:
                    fut.set_result(self._build_sync_payload(state))
                except BaseException as e:  # surfaced (and dropped) above
                    fut.set_exception(e)

            threading.Thread(
                target=_build, daemon=True, name="sync-payload"
            ).start()
            self._sync_payload_fut = fut
            return None
        seq, full, checksum = self._build_sync_payload(state)
        self._sync_payload_cache = (seq, full, checksum)
        self._sync_payload_tick = self.ticks
        return full, checksum

    def _build_sync_payload(self, state) -> tuple[int, bytes, int]:
        from tigerbeetle_tpu_torch.io.storage import Zone

        payload = state.to_bytes()
        blob_bytes = b"".join(
            self.storage.read(Zone.grid, ref.offset, ref.size)
            for ref in state.blobs
        )
        # With a spill store, ship the forest's acquired grid blocks too:
        # the checkpoint's spill meta references them by address, and grid
        # addresses are layout-relative, so the receiver installs them at
        # the same addresses in its own forest area.
        forest_section = b""
        if getattr(self.ledger, "spill", None) is not None:
            from tigerbeetle_tpu_torch.lsm.grid import BLOCK_SIZE

            grid = self.ledger.spill.forest.grid
            fo = self.storage.layout.forest_offset
            blocks = [
                a for a in range(1, grid.block_count + 1)
                if not grid.free_set.is_free(a)
            ]
            parts = [len(blocks).to_bytes(4, "little")]
            for a in blocks:
                raw = self.storage.read(
                    Zone.grid, fo + (a - 1) * BLOCK_SIZE, BLOCK_SIZE
                )
                parts.append(a.to_bytes(8, "little") + raw)
            forest_section = b"".join(parts)
        full = (
            len(payload).to_bytes(8, "little") + payload + blob_bytes
            + forest_section
        )
        from tigerbeetle_tpu_torch import native

        checksum = native.checksum(full)  # hashed ONCE per image, not per chunk
        return state.sequence, full, checksum

    @property
    def _sync_chunk_size(self) -> int:
        return self.cluster.message_size_max - HEADER_SIZE

    def _on_request_sync_checkpoint(self, header: Header) -> None:
        """Serve ONE bounded chunk of the checkpoint image (reference:
        src/vsr/sync.zig:9-56 — trailers ship in message-sized chunks, the
        receiver requests them progressively). header.op = chunk index.
        The reply carries commit=checkpoint op, timestamp=total size,
        parent=checksum(full image) so the receiver can detect a source
        checkpoint advancing mid-transfer and restart."""
        got = self._sync_checkpoint_payload()
        if got is None:
            return
        full, checksum = got
        state = self.superblock.state
        chunk_size = self._sync_chunk_size
        index = header.op
        if index * chunk_size >= len(full):
            return  # out of range (stale request for a shrunken image)
        chunk = full[index * chunk_size : (index + 1) * chunk_size]
        reply = Header(
            command=int(Command.sync_manifest),
            op=index,
            commit=state.commit_min,
            timestamp=len(full),
            parent=checksum,
        )
        self._send(header.replica, reply, chunk)

    def _on_sync_checkpoint(self, header: Header, body: bytes) -> None:
        """One CHUNK of a peer's checkpoint image. Gather until complete
        (requesting the next missing chunk each arrival — the transfer is
        self-clocking), verify the whole-image checksum, then install.
        A source whose checkpoint advanced mid-transfer changes the image
        checksum (header.parent): the gather restarts on the new image
        (reference: src/vsr/sync.zig stage machine with restart-on-
        target-change)."""
        adopting = (
            self.status in ("view_change", "recovering")
            and self._adopt is not None
        )
        # A NORMAL-status backup lagging beyond the primary's WAL also
        # jumps via checkpoint shipping (see _commit_up_to's escalation) —
        # installing a checkpoint with commit_min above our own only ever
        # replaces a committed prefix with a longer committed prefix.
        if not adopting and self.status != "normal":
            return
        if header.commit <= self.commit_min:
            return  # stale / not an improvement
        from tigerbeetle_tpu_torch import native

        key = (header.parent, header.commit, header.timestamp)
        gather = getattr(self, "_sync_gather", None)
        if gather is None or gather["key"] != key:
            gather = {"key": key, "chunks": {}, "total": header.timestamp}
            self._sync_gather = gather
        gather["chunks"][header.op] = body
        chunk_size = self._sync_chunk_size
        n_chunks = (gather["total"] + chunk_size - 1) // chunk_size
        missing = next(
            (i for i in range(n_chunks) if i not in gather["chunks"]), None
        )
        if missing is not None:
            rq = Header(
                command=int(Command.request_sync_manifest), op=missing
            )
            self._send(header.replica, rq)
            return
        full = b"".join(gather["chunks"][i] for i in range(n_chunks))
        self._sync_gather = None
        if len(full) != gather["total"] or native.checksum(full) != header.parent:
            return  # torn/mixed image: the tick-cadence retry restarts
        self._install_sync_checkpoint(full)

    def _install_sync_checkpoint(self, body: bytes) -> None:
        """Adopt a peer's complete checkpoint image (we are too far behind
        for WAL repair)."""
        from tigerbeetle_tpu_torch import native
        from tigerbeetle_tpu_torch.io.storage import Zone
        from tigerbeetle_tpu_torch.vsr.superblock import BlobRef, VSRState

        adopting = (
            self.status in ("view_change", "recovering")
            and self._adopt is not None
        )
        self.flush_commits()  # restore replaces the ledger state wholesale
        if self._dual_apply:
            # the device applier must quiesce before restore_bytes
            # replaces its tables (the install rides the apply queue, but
            # draining first bounds how much queued work the jump makes
            # moot and keeps the digest-ring reset unambiguous)
            self._drain_applier_checked("state-sync")
        n = int.from_bytes(body[:8], "little")
        remote = VSRState.from_bytes(body[8 : 8 + n])
        if remote.commit_min <= self.commit_min:
            return  # stale / not an improvement
        blob_raw = body[8 + n :]
        # verify + rewrite blobs into our own grid (other ping-pong area)
        own = self.superblock.state
        assert own is not None
        area = 1 - own.area
        area_size = self.storage.layout.snapshot_area_size
        off = area * area_size
        local_refs = []
        pos = 0
        for ref in remote.blobs:
            raw = blob_raw[pos : pos + ref.size]
            pos += ref.size
            if native.checksum(raw) != ref.checksum:
                return  # corrupt in flight: retry will refetch
            self.storage.write(Zone.grid, off, raw)
            local_refs.append(BlobRef(ref.name, off, ref.size, ref.checksum))
            off += (len(raw) + 4095) // 4096 * 4096
        if pos < len(blob_raw):
            # forest block section (spill store): install the source's
            # acquired blocks at the same layout-relative addresses in OUR
            # forest area; per-block payload checksums verify on first
            # read, and the spill meta's free set covers the address map
            if getattr(self.ledger, "spill", None) is None:
                return  # cannot adopt spilled state without a forest
            from tigerbeetle_tpu_torch.lsm.grid import BLOCK_SIZE

            fo = self.storage.layout.forest_offset
            count = int.from_bytes(blob_raw[pos : pos + 4], "little")
            pos += 4
            blocks: list[tuple[int, bytes]] = []
            for _ in range(count):
                a = int.from_bytes(blob_raw[pos : pos + 8], "little")
                pos += 8
                raw = blob_raw[pos : pos + BLOCK_SIZE]
                pos += BLOCK_SIZE
                # Verify the block's embedded checksum BEFORE any install
                # (the blob path above does the same): a corrupt-in-flight
                # block adopted here would only surface later as a
                # read_block error mid-commit, with no refetch path. All
                # blocks verify before any write so a rejected checkpoint
                # never leaves the forest area half-replaced (addresses
                # are shared with the CURRENT checkpoint's references).
                from tigerbeetle_tpu_torch.lsm.grid import Grid

                if Grid.validate_raw(raw) is None:
                    return  # corrupt in flight: retry will refetch
                blocks.append((a, raw))
            for a, raw in blocks:
                self.storage.write(Zone.grid, fo + (a - 1) * BLOCK_SIZE, raw)
            self.ledger.spill.forest.grid.cache.clear()
        self.storage.sync()
        meta = dict(remote.meta)
        # view durability is OURS, not the sync source's
        meta["view"] = max(
            int(meta.get("view", 0)), self.view_candidate, self.view
        )
        meta["log_view"] = self.log_view
        new_state = dataclasses.replace(
            remote,
            replica=self.replica,
            sequence=own.sequence + 1,
            area=area,
            blobs=local_refs,
            meta=meta,
        )
        self.superblock.checkpoint(new_state)
        restore_from_snapshot(
            self.storage, self.ledger, self.sm, self.ledger.process, new_state
        )
        self.client_table = {
            int(c): dict(e, reply=None)
            for c, e in self._load_client_table(new_state).items()
        }
        self._reply_slots_free = None  # rebuilt from the adopted table
        self._restore_client_replies()
        self.checkpoint_op = new_state.commit_min
        self.commit_min = self.commit_max = self.op = new_state.commit_min
        # the jumped ops executed elsewhere: unblock the CDC pump (it
        # declares whatever the journal no longer covers as a gap), and
        # prune reply-ring entries stranded below the jump — the
        # single-key eviction at finalize only ever pops op-slot_count
        # for CONSECUTIVE ops and would skip the jumped range forever
        self.cdc_commit_min = max(self.cdc_commit_min, new_state.commit_min)
        if self.cdc_replies:
            floor = new_state.commit_min - self.cluster.journal_slot_count
            self.cdc_replies = {
                k: v for k, v in self.cdc_replies.items() if k > floor
            }
        self.parent_checksum = self.commit_checksum = new_state.commit_min_checksum
        self._repair_wanted.clear()
        if adopting:
            # resume adoption from the new base
            self._catchup.clear()
            self._catchup_no_local = True  # local WAL predates the sync point
            self._vc_tick = self.ticks
            self._vc_retries = 0
            self._request_catchup_window()
            self._try_finish_view_change()
        # normal status: the next commit heartbeat resumes WAL catch-up
        # from the new checkpoint via _commit_up_to

    # ------------------------------------------------------------------
    # commit
    # ------------------------------------------------------------------

    def _on_prepare_ok(self, header: Header) -> None:
        if not self.is_primary:
            return
        entry = self.pipeline.get(header.op)
        if entry is None or entry["header"].checksum != header.context:
            return
        before = len(entry["oks"])
        entry["oks"].add(header.replica)
        if (
            before < self.quorum_replication
            and len(entry["oks"]) == self.quorum_replication
        ):
            # quorum_wait leg closes at the ack that COMPLETES the
            # quorum — transition-gated, because a duplicate re-ack
            # (retransmitted prepare) leaves len(oks) AT quorum and a
            # re-stamp would fold later legs' time into quorum_wait
            # (the _note_quorum accounting below fires later, after any
            # fuse hold — a different boundary)
            lt = entry.get("lt")
            if lt:
                self.latency.stamp(lt, LEG_QUORUM)
        self._maybe_commit_pipeline()

    # Max prepares fused into one group commit (the ledger pads smaller
    # runs into fixed-capacity scan kernels — see DeviceLedger.GROUP_KS).
    GROUP_MAX = 16

    def _spill_prefetch_body(self, header: Header, body: bytes) -> None:
        """Prefetch/commit overlap (models/spill.py): while op N's commit
        kernel runs, the spill IO executor gathers op N+1's referenced-
        spilled rows so its admit() finds them staged. Gated on an active
        spilled set — otherwise this is a free no-op per commit."""
        spill = getattr(self.ledger, "spill", None)
        if (
            spill is None
            or not spill.spilled
            or header.operation != int(Operation.create_transfers)
        ):
            return
        spill.prefetch_async(np.frombuffer(body, dtype=TRANSFER_DTYPE))

    def _tid(self, header: Header) -> int:
        """The op's cluster-causal trace id (vsr/header.py trace_id) for
        span tagging — 0 (untraced) when tracing is off, so the hot path
        never pays the hash for the no-op backend."""
        return header.trace() if self.tracer.enabled else 0

    def _drop_quorum_tokens(self) -> None:
        """Close the quorum-wait spans of pipeline entries about to be
        discarded (view change): without this a traced run leaks one open
        span per abandoned prepare into the dump. The histogram is NOT
        observed — these ops never reached quorum here."""
        for entry in self.pipeline.values():
            entry.pop("t", None)
            tok = entry.pop("qtok", 0)
            if tok:
                self.tracer.stop(tok)
            # abandoned prepares never reach egress: drop their open
            # latency records instead of leaking them to eviction
            self.latency.discard(entry.pop("lt", 0) or None)

    def _note_quorum(self, entry: dict) -> None:
        """Close a pipeline entry's quorum-wait accounting (histogram +
        trace span). Idempotent: the stall/retry paths can re-enter the
        commit for the same op."""
        t = entry.pop("t", None)
        if t is not None:
            self._h_quorum.observe((perf_counter_ns() - t) / 1000.0)
        tok = entry.pop("qtok", 0)
        if tok:
            self.tracer.stop(tok)

    def _maybe_commit_pipeline(self) -> None:
        committed = False
        while True:
            op = self.commit_min + 1
            entry = self.pipeline.get(op)
            if entry is None or len(entry["oks"]) < self.quorum_replication:
                break
            header, body = entry["header"], entry["body"]
            self._note_quorum(entry)
            try:
                if self.commit_window > 0:
                    if self._commit_group(op, header):
                        committed = True
                        continue
                    # overlapped: dispatch now, drain/reply on flush — the
                    # next request's journal write + broadcast run while
                    # the device executes this batch
                    d = self._commit_dispatch(header, body,
                                              lt=entry.get("lt", 0))
                    d["wal"] = entry.get("wal")
                    self._inflight.append(d)
                    self.group_stats.add("solo_ops")
                    self.flush_commits(keep=self.commit_window, only_ready=True)
                else:
                    lt = entry.get("lt", 0)
                    reply_wire = self._commit_prepare(header, body, lt=lt)
                    if reply_wire is not None:
                        if lt:
                            self.latency.egress(
                                lt, header.client, header.context
                            )
                        self.network.send(
                            self.replica, header.client, reply_wire
                        )
            except GridBlockCorrupt as e:
                # stall this op; retry when the block heals (_on_block)
                if not self._request_block_repair([e.address]):
                    raise  # single replica / no forest: unrecoverable
                break
            self.commit_min = self.commit_max = op
            self.commit_checksum = header.checksum
            del self.pipeline[op]
            committed = True
            # op's admit has run: start gathering op+1's spilled rows on
            # the IO executor while op's commit kernel executes
            nxt = self.pipeline.get(op + 1)
            if nxt is not None and len(nxt["oks"]) >= self.quorum_replication:
                self._spill_prefetch_body(nxt["header"], nxt["body"])
        if committed:
            # commit heartbeat so backups commit promptly (also sent on a
            # tick cadence)
            h = Header(command=int(Command.commit), commit=self.commit_max)
            self._broadcast(h)

    def _commit_group(self, first_op: int, first_header: Header) -> bool:
        """Group commit: fuse a run of quorum-ready create_transfers
        prepares into ONE device dispatch + ONE result fetch (reference
        pipelining collapsed onto the device the way the flagship
        benchmark K-fuses batches). Returns True if a group was
        dispatched; False -> the caller takes the per-op path."""
        if first_header.operation != int(Operation.create_transfers):
            return False
        run = []
        while len(run) < self.GROUP_MAX:
            e = self.pipeline.get(first_op + len(run))
            if (
                e is None
                or len(e["oks"]) < self.quorum_replication
                or e["header"].operation != int(Operation.create_transfers)
            ):
                break
            run.append(e)
            if self.commitment_log is not None and self.commitment_log.is_boundary(
                first_op + len(run) - 1
            ):
                # a commitment boundary ends its fused run: the group's
                # single device dispatch precedes every per-op
                # _commit_dispatch, so a mid-run boundary would
                # fingerprint state that already includes later ops
                break
        if len(run) < 2:
            return False
        handles = self.sm.commit_group_async(
            Operation.create_transfers,
            [(e["header"].timestamp, e["body"]) for e in run],
        )
        if handles is None:
            return False  # ineligible (hazard tier / spill / mode)
        for e, handle in zip(run, handles):
            h = e["header"]
            self._note_quorum(e)
            d = self._commit_dispatch(h, e["body"], handle=handle,
                                      lt=e.get("lt", 0))
            d["wal"] = e.get("wal")
            self._inflight.append(d)
            self.commit_min = self.commit_max = h.op
            self.commit_checksum = h.checksum
            del self.pipeline[h.op]
        self.group_stats.add("fused_ops", len(run))
        self.group_stats.add("fused_groups")
        self.flush_commits(keep=self.commit_window, only_ready=True)
        return True

    def _on_commit(self, header: Header) -> None:
        if header.view < self.view or self.is_primary:
            return
        self._primary_contact_tick = self.ticks
        self._commit_up_to(header.commit)

    def _commit_up_to(self, commit_max: int) -> None:
        self.commit_max = max(self.commit_max, commit_max)
        # Beyond-WAL lag: the ops we need have been overwritten in the
        # primary's ring (it keeps at most journal_slot_count, and
        # checkpoints every checkpoint_interval) — prepare repair cannot
        # progress; jump via checkpoint shipping instead (reference:
        # src/vsr/sync.zig — sync is not only a view-change concern).
        if (
            self.commit_max - self.commit_min
            >= self.cluster.checkpoint_interval
            and not self.is_primary
            # Rate limit: every commit heartbeat lands here while we lag,
            # and each request is answered with the FULL checkpoint —
            # unbounded amplification without a tick-cadence guard
            # (reference: sync requests ride timeouts, not messages).
            and self.ticks - self._sync_request_tick >= RETRY_TICKS
        ):
            self._sync_request_tick = self.ticks
            rq = Header(command=int(Command.request_sync_manifest))
            self._send(self.primary_index, rq)
            # fall through to WAL repair as well: at the boundary the
            # primary's checkpoint may not yet be ahead of our commit
            # (sync reply would be stale) while its ring still covers us
        while self.commit_min < self.commit_max:
            op = self.commit_min + 1
            if op > self.op:
                # Committed cluster-wide but we never prepared it (we were
                # down/partitioned): fetch it — the fill chains from our
                # head and advances self.op (lag catch-up; the reference's
                # state sync covers the beyond-one-WAL case).
                self._request_prepare(op, self.primary_index)
                return
            got = self.journal.read_prepare(op)
            if got is None:
                # journal gap (e.g. faulty slot): fetch from the primary
                self._request_prepare(op, self.primary_index)
                return
            header, body = got
            from tigerbeetle_tpu_torch import constants as _constants

            if _constants.VERIFY and self.commit_checksum:
                # intensive tier (constants.VERIFY): the hash chain is
                # re-verified at the moment of commit, not only during
                # recovery — a journal slot swapped after its write (or a
                # repair that fetched the wrong timeline) dies here
                assert header.parent == self.commit_checksum, (
                    f"VERIFY: hash chain break at commit op {op}: "
                    f"parent {header.parent:#x} != "
                    f"commit_checksum {self.commit_checksum:#x}"
                )
            try:
                if self.commit_window > 0:
                    self._inflight.append(self._commit_dispatch(header, body))
                    self.flush_commits(keep=self.commit_window, only_ready=True)
                else:
                    self._commit_prepare(header, body)
            except GridBlockCorrupt as e:
                # stall; retry when the block heals (_on_block)
                if not self._request_block_repair([e.address]):
                    raise
                return
            self.commit_min = op
            self.commit_checksum = header.checksum
            pruned = self.pipeline.pop(op, None)  # prune if pipelined
            if pruned is not None:
                self._note_quorum(pruned)
            # backup-side prefetch/commit overlap: peek the next journaled
            # prepare (gated on a threaded executor + an active spilled
            # set — the read costs a WAL slot fetch, worthless when the
            # prefetch would no-op)
            spill = getattr(self.ledger, "spill", None)
            if (
                spill is not None and spill.spilled
                and spill.prefetch_enabled
                and self.commit_min < self.commit_max
            ):
                got2 = self.journal.read_prepare(op + 1)
                if got2 is not None:
                    self._spill_prefetch_body(got2[0], got2[1])

    def _commit_prepare(self, header: Header, body: bytes,
                        lt: int = 0) -> bytes | None:
        """Execute one prepare against the replicated state (identical on
        every replica — determinism is the consensus invariant). EVERY
        replica constructs and stores the reply in its client table
        (reference: src/vsr/client_replies.zig — replies are replicated so
        a post-view-change primary can answer duplicate requests); only the
        primary actually sends it. Returns the reply wire bytes."""
        return self._commit_finalize(
            self._commit_dispatch(header, body, lt=lt)
        )

    def _commit_dispatch(self, header: Header, body: bytes,
                         handle=None, lt: int = 0) -> dict:
        if lt:
            # fuse_hold leg: quorum reached -> dispatch entry (the
            # group-fuse hold + the end-of-pump deferral)
            self.latency.stamp(lt, LEG_FUSE)
        with self.tracer.span("replica.commit_dispatch", op=header.op,
                              trace=self._tid(header)), \
                self._h_dispatch.time():
            d = self._commit_dispatch_inner(header, body, handle)
        d["lt"] = lt
        if lt:
            self.latency.stamp(lt, LEG_DISPATCH)
        return d

    def _commit_dispatch_inner(self, header: Header, body: bytes,
                               handle=None) -> dict:
        """Stage 1: apply the prepare to the replicated state WITHOUT
        materializing device results (asynchronous CUDA launches — create-op
        launches are queued and the host returns). Host-side effects that
        must be ordered (AOF, commit hooks, register sessions, the
        prepare-timestamp clamp) happen here, in op order. The
        state-machine dispatch runs FIRST: it may raise GridBlockCorrupt
        (spill reads), and the stall/retry path re-enters this method for
        the same op — AOF records and commit hooks must not duplicate.
        AOF still precedes the reply (sent at finalize)."""
        operation = Operation(header.operation)
        reply_body = None
        if handle is not None:
            # group commit already dispatched the state-machine work
            self.sm.prepare_timestamp = max(
                self.sm.prepare_timestamp, header.timestamp
            )
        elif operation == Operation.register:
            # At clients_max, evict the OLDEST session (lowest session
            # number — deterministic, so every replica evicts the same
            # one) and tell that client (reference:
            # src/vsr/replica.zig:3758-3860 + eviction command,
            # src/vsr.zig:136). Its slot is then free for the newcomer.
            prior = self.client_table.pop(header.client, None)
            if prior is not None:
                # Duplicate register EXECUTING (a view change can carry
                # the same client's register twice in the surviving log):
                # the re-insert below replaces the entry, so release its
                # slot or it leaks from the free list until the next
                # restart's rebuild (the old O(sessions) scan self-healed
                # here; the incremental list must be told). Popped BEFORE
                # the release/alloc: with the list still unbuilt (first
                # register after a restart), release is a no-op and the
                # lazy rebuild must not count the replaced entry's slot
                # as owned.
                self._reply_slot_release(prior.get("slot"))
            elif len(self.client_table) >= self.cluster.clients_max:
                victim = min(
                    self.client_table,
                    key=lambda c: self.client_table[c]["session"],
                )
                evicted = self.client_table.pop(victim)
                self._reply_slot_release(evicted.get("slot"))
                if self.is_primary:
                    self._send_eviction(victim)
                if self.ingress_evict_hook is not None:
                    self.ingress_evict_hook(victim)
            self.client_table[header.client] = {
                "session": header.op,
                "request": 0,
                "reply": None,
                # reply-persistence slot (reference: client_replies.zig);
                # None once every slot is owned (many-session ingress
                # mode: reply_slot_count < clients_max)
                "slot": self._reply_slot_alloc(),
            }
            reply_body = header.op.to_bytes(8, "little")  # session number
        else:
            handle = self.sm.commit_async(operation, header.timestamp, body)
            self.sm.prepare_timestamp = max(
                self.sm.prepare_timestamp, header.timestamp
            )
            # conflict-wave decision plumbed off the dispatch handle (the
            # backend's planner ran inside commit_async): surfaced as
            # commit.group.wave_* so the [stats] line and the bench can
            # attribute dependent-transfer ops to the wave path
            plan = self.sm.handle_plan(handle)
            if plan is not None and plan[0] == "waves":
                self.group_stats.add("wave_ops")
                self.group_stats.add("wave_dispatches", plan[1])
        clog = self.commitment_log
        if clog is not None and clog.is_boundary(header.op):
            # fold the backend's state fingerprint into the commitment
            # chain at dispatch: every op <= header.op has dispatched,
            # none after (group runs break at boundaries). Idempotent
            # across the stall/retry re-entry and WAL-tail replay — a
            # re-record with a different fingerprint raises naming this
            # checkpoint.
            clog.record(header.op, self.sm.backend.fingerprint())
        if self.commit_hook is not None:
            self.commit_hook(header, body)
        if self.aof is not None:
            self.aof.append(header, body)  # durable before the reply
        return {
            "header": header,
            "handle": handle,
            "reply_body": reply_body,
            "to_client": self.is_primary,
            # prepare body kept through finalize only for the CDC live
            # tail and the dual-commit device applier (references the
            # pipeline/journal hold anyway — but don't pin 1 MiB per
            # in-flight entry when neither consumer is on)
            "body": body
            if (self.cdc_hook is not None or self._dual_apply)
            else None,
        }

    def _commit_finalize(self, entry: dict) -> bytes | None:
        lt = entry.get("lt", 0)
        if lt:
            # commit_wait leg: dispatch exit -> finalize entry (async
            # commit window: the in-flight queue + device compute)
            self.latency.stamp(lt, LEG_WAIT)
        with self.tracer.span("replica.commit_finalize",
                              op=entry["header"].op,
                              trace=self._tid(entry["header"])), \
                self._h_finalize.time():
            wire = self._commit_finalize_inner(entry)
        if lt:
            self.latency.stamp(lt, LEG_FINALIZE)
        return wire

    def _commit_finalize_inner(self, entry: dict) -> bytes | None:
        """Stage 2: materialize the results (drains the device batch),
        build + store the reply, persist the client-replies slot."""
        header = entry["header"]
        wal = entry.get("wal")
        if wal is not None:
            wal.result()  # WAL durable before the reply leaves
        reply_body = entry["reply_body"]
        if reply_body is None:
            reply_body = self.sm.commit_finish(entry["handle"])
        reply = Header(
            command=int(Command.reply),
            client=header.client,
            context=header.context,
            request=header.request,
            op=header.op,
            commit=header.op,
            timestamp=header.timestamp,
            operation=header.operation,
        )
        reply.set_checksum_body(reply_body)
        reply.replica = self.replica
        reply.view = self.view
        reply.set_checksum()
        if self.reply_hook is not None:
            self.reply_hook(header, reply.checksum_body)
        if self.cdc_retain:
            # bounded reply ring for CDC resume-from-WAL: evict the op
            # that fell out of the journal ring this step. CREATE ops
            # only — their replies are tiny sparse failure structs; a
            # lookup's reply is a dense row dump up to message_size_max
            # that the change stream never reads (no records for reads)
            if header.operation in _CDC_RETAIN_OPS:
                self.cdc_replies[header.op] = reply_body
            self.cdc_replies.pop(
                header.op - self.cluster.journal_slot_count, None
            )
        if self.cdc_hook is not None:
            # once per op per process (finalize runs once; the dispatch
            # retry path never reaches here twice), in op order (the
            # in-flight queue drains FIFO)
            self.cdc_hook(header, entry.get("body"), reply_body)
        if (
            self._dual_apply
            and header.operation in _CDC_RETAIN_OPS  # the two create ops
            and isinstance(entry["handle"], tuple)
        ):
            # Dual-commit apply seam: the device applier follows the
            # COMMITTED op stream — enqueue exactly once, at finalize
            # (reply built, WAL durable), in op order, with the native
            # engine's dense codes for the host side of the hash-log
            # ring. Zero-copy: the rows view aliases the prepare body
            # bytes and the codes array is the one the engine filled.
            self.ledger.apply_commit(
                header.op,
                Operation(header.operation),
                header.timestamp,
                np.frombuffer(
                    entry["body"],
                    dtype=ACCOUNT_DTYPE
                    if header.operation == int(Operation.create_accounts)
                    else TRANSFER_DTYPE,
                ),
                entry["handle"][1].codes,
                prepare_checksum=header.checksum,
                trace=self._tid(header),
                # device-apply lag is a PARALLEL lane of the anatomy
                # (the reply does not wait for it): sampled ops carry
                # their enqueue stamp so the apply loop can observe
                # enqueue->upload into latency.device_apply_lag_us
                lat_ns=perf_counter_ns() if entry.get("lt") else 0,
            )
        if (
            self._dual_apply
            and self.commitment_log is not None
            and self.commitment_log.is_boundary(header.op)
        ):
            # commitment probe: finalizes run in op order, so the device
            # applier's queue holds exactly the creates <= this boundary
            # when the probe lands — the apply thread stashes the device
            # twin's lazy fingerprint there; finalize() compares it
            # against the chain's host fingerprint per checkpoint.
            fp = self.commitment_log.fingerprint_at(header.op)
            if fp is not None and hasattr(self.ledger, "commitment_probe"):
                self.ledger.commitment_probe(header.op, fp)
        self.cdc_commit_min = header.op
        wire = reply.to_bytes() + reply_body
        tentry = self.client_table.get(header.client)
        if tentry is not None:
            tentry["request"] = header.request
            tentry["reply"] = wire
            tentry["reply_checksum"] = reply.checksum
            if tentry.get("slot") is not None:
                # persist so a post-restart primary can answer a duplicate
                # with the ORIGINAL bytes (reference: client_replies.zig);
                # in window mode the O_DSYNC slot write rides the FIFO IO
                # worker — reply repair tolerates a lost tail write (the
                # checksum-validated restore reads it as absent)
                if self.commit_window > 0:
                    self.journal.submit_io(
                        self.client_replies.write, tentry["slot"], wire
                    )
                else:
                    self.client_replies.write(tentry["slot"], wire)
        return wire

    @staticmethod
    def _handle_ready(h) -> bool:
        """Readiness probe for a commit handle (shared by the event loop's
        commits_ready and the non-blocking flush)."""
        if h is None or isinstance(h, bytes):
            return True
        p = h[1]
        if hasattr(p, "is_ready"):
            return bool(p.is_ready())
        probe = getattr(p, "summary", None)
        if probe is None and getattr(p, "group", None) is not None:
            probe = p.group.summary
        if probe is None:
            probe = p.results
        is_ready = getattr(probe, "is_ready", None)
        return bool(is_ready()) if is_ready is not None else True

    def _entry_ready(self, entry: dict) -> bool:
        wal = entry.get("wal")
        if wal is not None and not wal.done():
            return False  # finalize would block on the WAL fsync
        return self._handle_ready(entry["handle"])

    def flush_commits(self, keep: int = 0, only_ready: bool = False) -> None:
        """Finalize queued async commits (oldest first) until at most
        `keep` remain in flight. The event loop calls this when the bus has
        no more incoming frames; _maybe_commit_pipeline calls it with
        keep=commit_window AND only_ready=True — the dispatch path must not
        BLOCK on its own group's device compute (that serialized recv of
        the next window behind execution of this one). A hard cap of
        4x keep still blocks to bound the in-flight window."""
        if only_ready:
            hard_cap = 4 * keep if keep else (1 << 30)
            while (
                len(self._inflight) > keep
                and (
                    self._entry_ready(self._inflight[0])
                    or len(self._inflight) > hard_cap
                )
            ):
                entry = self._inflight.popleft()
                wire = self._commit_finalize(entry)
                if wire is not None and entry["to_client"]:
                    lt = entry.get("lt", 0)
                    if lt:
                        h = entry["header"]
                        self.latency.egress(lt, h.client, h.context)
                    self.network.send(
                        self.replica, entry["header"].client, wire
                    )
            return
        n_final = len(self._inflight) - keep
        if n_final <= 0:
            return
        if n_final > 1:
            # one device->host round trip for the whole window, not one
            # per batch (high-latency transports)
            self.sm.commit_finish_many([
                e["handle"]
                for e in list(self._inflight)[:n_final]
                if e["handle"] is not None
            ])
        while len(self._inflight) > keep:
            entry = self._inflight.popleft()
            wire = self._commit_finalize(entry)
            if wire is not None and entry["to_client"]:
                lt = entry.get("lt", 0)
                if lt:
                    h = entry["header"]
                    self.latency.egress(lt, h.client, h.context)
                self.network.send(self.replica, entry["header"].client, wire)

    def pump_commits(self) -> None:
        """Event-loop hook: commit whatever reached quorum during this
        pump turn (deferred from _on_request so same-turn arrivals fuse
        into one group dispatch). A short quorum-ready run may additionally
        be HELD for up to fuse_window_ns (see _fuse_hold) so that requests
        arriving a few hundred microseconds apart still coalesce into one
        fused dispatch — the difference between a ~0.4 and a ~0.9 group-
        commit hit rate under concurrent session clients."""
        if not (self.status == "normal" and self.is_primary and self.pipeline):
            self._fuse_clear()
            return
        if self._fuse_hold():
            return
        self._maybe_commit_pipeline()

    def _fuse_clear(self) -> None:
        """End the fuse-window hold: close its trace span and record the
        hold duration (Time-seam clock, so deterministic harnesses stay
        deterministic)."""
        if self._fuse_started is not None:
            self._h_fuse.observe(
                (self.time.monotonic() - self._fuse_started) / 1000.0
            )
        self._fuse_started = None
        if self._fuse_token:
            self.tracer.stop(self._fuse_token)
            self._fuse_token = 0

    def _fuse_hold(self) -> bool:
        """True while the fuse window is holding a short quorum-ready run
        of create_transfers prepares open for more arrivals. Never holds
        when the engine is idle (_inflight empty): deferral then buys no
        fusion worth starving the engine for. The hold is bounded by
        fuse_window_ns from the run's first deferral."""
        if (
            self.commit_window <= 0
            or self.fuse_window_ns <= 0
            or not self._inflight
        ):
            self._fuse_clear()
            return False
        run = 0
        first = self.commit_min + 1
        while run < self.GROUP_MAX:
            e = self.pipeline.get(first + run)
            if (
                e is None
                or len(e["oks"]) < self.quorum_replication
                or e["header"].operation != int(Operation.create_transfers)
            ):
                break
            run += 1
        if run == 0 or run >= self.GROUP_MAX:
            if run >= self.GROUP_MAX and self._fuse_started is not None \
                    and self.fuse_autotune:
                # the held run filled before the window expired: the
                # window over-covers the arrival spacing — shed a little
                # hold latency (multiplicative-decrease half of AIMD)
                self.fuse_window_ns = max(
                    self.fuse_window_min_ns, int(self.fuse_window_ns * 0.95)
                )
            self._fuse_clear()
            return False
        now = self.time.monotonic()
        if self._fuse_started is None:
            self._fuse_started = now
            self.group_stats.add("fuse_holds")
            # tagged with the FIRST held op's trace id: clicking the op
            # in Perfetto shows the hold it waited out
            self._fuse_token = self.tracer.start(
                "replica.fuse_hold", run=run,
                trace=self._tid(self.pipeline[first]["header"]),
            )
            return True
        if now - self._fuse_started < self.fuse_window_ns:
            return True
        # hold EXPIRED with the run still short: the window lost the race
        # against this workload's arrival spacing (the r05 driver's 0.46
        # hit rate vs 0.85 in the CPU A/B was exactly this, invisible
        # without the counter) — record it, and autotune widens
        self.group_stats.add("fuse_expired")
        if self.fuse_autotune:
            self.fuse_window_ns = min(
                self.fuse_window_max_ns, int(self.fuse_window_ns * 1.25)
            )
        self._fuse_clear()
        return False

    def commits_ready(self) -> bool:
        """True when the NEWEST in-flight commit's device results are
        computed — batches execute in order, so the whole window is then
        fetchable in one transfer. The event loop uses this to defer
        flushes until one round trip can drain everything (fetching
        mid-compute would serialize a round trip per batch)."""
        if not self._inflight:
            return False
        return self._handle_ready(self._inflight[-1]["handle"])

    # ------------------------------------------------------------------
    # view change (reference: src/vsr/replica.zig:1595-1924)
    # ------------------------------------------------------------------

    def _start_view_change(self, new_view: int) -> None:
        assert new_view > self.view
        if self.standby:
            # a standby cannot vote a view in; it re-syncs via the
            # authoritative start_view instead
            rsv = Header(
                command=int(Command.request_start_view), view=new_view
            )
            self._send(new_view % self.replica_count, rsv)
            self._primary_contact_tick = self.ticks
            self._recover_tick = self.ticks
            return
        if self.status == "view_change" and new_view <= self.view_candidate:
            return
        self.flush_commits()  # no async commits across a status change
        self.status = "view_change"
        self.view_candidate = new_view
        self._svc_votes = {self.replica}
        self._dvc = {}
        self._adopt = None
        self._catchup = {}
        self._drop_quorum_tokens()
        self.pipeline = {}
        self._pending_prepares = {}
        self._repair_wanted.clear()
        self._vc_tick = self.ticks
        self._vc_retries = 0
        # Durable BEFORE voting: a crash-restart must not regress into an
        # abandoned view and form an intersecting quorum there.
        persist_view(self.superblock, new_view, self.log_view)
        svc = Header(command=int(Command.start_view_change), view=new_view)
        self._broadcast(svc)
        self._check_svc_quorum()

    def _on_start_view_change(self, header: Header) -> None:
        if self.standby or header.view <= self.view:
            return
        if self.status != "view_change" or header.view > self.view_candidate:
            self._start_view_change(header.view)
        if header.view == self.view_candidate:
            self._svc_votes.add(header.replica)
            self._check_svc_quorum()

    def _check_svc_quorum(self) -> None:
        if (
            self.status == "view_change"
            and len(self._svc_votes) >= self.quorum_view_change
        ):
            self._send_do_view_change()

    def _suffix_headers(self) -> list[Header]:
        """Headers of ops (commit_min, op] — the log suffix an SV carries.
        Only REAL headers (never nack markers — a backup would adopt one as
        a real header and wedge waiting for a prepare whose checksum can
        never match). A suffix op whose BODY is torn (in-place media fault
        after adoption verified it) still contributes its redundant-ring
        header — authoritative evidence — and we repair the body from
        backups rather than crashing (any acker can serve it; SV receivers
        independently fetch bodies from every peer in _begin_adoption)."""
        out = []
        for op in range(self.commit_min + 1, self.op + 1):
            got = self.journal.read_prepare(op)
            if got is not None:
                out.append(got[0])
                continue
            h = self.journal.get_header(op)
            assert h is not None, f"SV suffix op {op}: no journal evidence"
            out.append(h)
            for r in range(self.replica_count):
                if r != self.replica:
                    self._request_prepare(op, r)
        return out

    def _dvc_suffix_headers(self) -> tuple[list[Header], int]:
        """(suffix, head) for a DVC: the log evidence in the JOURNAL —
        NOT the in-memory head, which an earlier unfinished adoption may
        have truncated to commit_min while acked prepares still sit intact
        in the WAL (advertising only self.op there would falsely nack
        them). Per op:

        - readable prepare -> its header;
        - TORN slot (redundant header survives, body lost) -> that header:
          authoritative, peers repair the body after adoption (protocol-
          aware recovery, reference: src/vsr.zig:302-304);
        - BLANK slot -> an explicit NACK marker, counted toward the nack
          quorum that authorizes truncation.

        The scan extends past self.op while journal evidence continues; a
        run of blanks longer than the pipeline depth terminates it (the
        primary never has more than pipeline_prepare_queue_max prepares in
        flight, so a longer gap cannot hide acked ops)."""
        out: list[Header] = []
        head = self.commit_min
        gap_max = self.cluster.pipeline_prepare_queue_max
        op = self.commit_min
        limit = self.commit_min + self.cluster.journal_slot_count
        pending: list[Header] = []
        while op < limit:
            op += 1
            # the in-memory redundant-header mirror is authoritative for
            # slot EVIDENCE (valid and torn slots both carry their header;
            # the valid/torn distinction only matters for body repair,
            # which happens after adoption) — no prepare-ring reads here
            h = self.journal.get_header(op)
            if h is not None:
                out.extend(pending)
                pending = []
                out.append(h)
                head = op
                continue
            if len(pending) >= gap_max and op > self.op:
                break  # gap too long to hide acked ops: the log ends
            nack = Header(
                command=int(Command.prepare), op=op, operation=OP_NACK
            )
            nack.set_checksum_body(b"")
            nack.set_checksum()
            pending.append(nack)
        head = max(head, self.op)
        # markers for trailing blanks up to our known head still count
        out.extend(m for m in pending if m.op <= head)
        return out, head

    def _send_do_view_change(self) -> None:
        new_primary = self.view_candidate % self.replica_count
        suffix, head = self._dvc_suffix_headers()
        body = b"".join(h.to_bytes() for h in suffix)
        # DVC fields (reference: do_view_change sets request=log_view,
        # commit=commit_min, op=log head; the suffix headers ride the body).
        dvc = Header(
            command=int(Command.do_view_change),
            view=self.view_candidate,
            request=self.log_view,
            op=head,
            commit=self.commit_min,
            parent=self.commit_checksum,
            timestamp=self.checkpoint_op,  # my WAL covers (this, op]
        )
        if new_primary == self.replica:
            self._record_dvc(self.replica, dvc, suffix)
        else:
            self._send(new_primary, dvc, body)

    def _on_do_view_change(self, header: Header, body: bytes) -> None:
        if header.view % self.replica_count != self.replica:
            return
        if header.view <= self.view or header.view < self.view_candidate:
            return  # stale DVC (that view change already completed)
        if self.status != "view_change" or header.view > self.view_candidate:
            self._start_view_change(header.view)
        suffix = [
            Header.from_bytes(body[i : i + HEADER_SIZE])
            for i in range(0, len(body), HEADER_SIZE)
        ]
        self._record_dvc(header.replica, header, suffix)

    def _record_dvc(self, replica: int, header: Header, suffix: list[Header]):
        self._dvc[replica] = (header, suffix)
        if self._adopt is not None or len(self._dvc) < self.quorum_view_change:
            return
        # Choose the best log: max (log_view, op) (reference: :2845-2977
        # primary_receive_do_view_change), then MERGE per op with nack
        # accounting (protocol-aware recovery, reference:
        # src/vsr.zig:302-304): an op survives if any best-log_view DVC
        # carries its header (torn bodies repair later); it truncates only
        # under a NACK QUORUM proving no replication quorum ever acked it;
        # otherwise the change waits for more DVCs — guessing could drop
        # an acked op (data loss) or resurrect a superseded one.
        best_replica, (best_h, _) = max(
            self._dvc.items(),
            key=lambda kv: (kv[1][0].request, kv[1][0].op),
        )
        # Nack soundness rests on the WAL durability order (journal.py):
        # the redundant header is durable BEFORE an op is ever acked, so an
        # acked op's header survives a torn body and its slot reports TORN
        # (header, no nack), never BLANK. A false nack therefore requires
        # post-durability media corruption of BOTH rings' sectors on one
        # replica COMBINED with the loss of every other acker — beyond-f
        # faults, the same residual the reference accepts (its simulator
        # fault atlas guarantees one surviving copy cluster-wide,
        # reference: src/testing/storage.zig:1-25).
        best_log_view = best_h.request
        base = best_h.commit
        op_max = max(h.op for h, _ in self._dvc.values())
        commit_max = max(h.commit for h, _ in self._dvc.values())
        nack_quorum = self.replica_count - self.quorum_replication + 1
        merged: dict[int, Header] = {}
        undecided_op = None
        for op in range(base + 1, op_max + 1):
            header_for_op = None
            nacks = 0
            for _r, (h, sfx) in self._dvc.items():
                if h.op < op or op <= h.commit:
                    if h.op < op:
                        nacks += 1  # implicit nack: log head below op
                    continue
                m = next((x for x in sfx if x.op == op), None)
                if m is None or m.operation == OP_NACK:
                    nacks += 1
                elif h.request == best_log_view and header_for_op is None:
                    # headers are unique per (log_view, op): any best-
                    # log_view copy is THE header (lower log_views may hold
                    # superseded prepares and must not contribute)
                    header_for_op = m
            if header_for_op is not None:
                merged[op] = header_for_op
            elif nacks >= nack_quorum and op > commit_max:
                break  # provably never acked by a quorum: truncate here
            else:
                # No surviving header, and either no nack quorum OR a DVC
                # proves the op COMMITTED (op <= commit_max, in which case
                # nacks are contradictory evidence — truncating would drop
                # an executed op and diverge): refuse to guess.
                undecided_op = op
                break
        if undecided_op is not None:
            if len(self._dvc) < self.replica_count:
                # Wait: a further DVC can still decide this op. If the
                # missing replicas are down, the change re-runs on timeout
                # with the same inputs — a deliberate LIVENESS sacrifice:
                # with evidence destroyed on the live set, guessing either
                # way risks dropping or resurrecting a possible commit
                # (PAR blocks rather than guesses; service resumes when a
                # decisive replica returns).
                return
            raise RuntimeError(
                f"view change: op {undecided_op} unrecoverable — no "
                f"surviving header, {nacks} nacks "
                f"(quorum {nack_quorum}), commit_max {commit_max}; "
                "a possible commit would be lost (protocol-aware recovery "
                "refuses to guess)"
            )
        self._begin_adoption(
            base=base,
            suffix=merged,
            commit_max=commit_max,
            src=best_replica,
            tip=best_h.parent,  # checksum of the op at `base`
            src_checkpoint=best_h.timestamp,
        )

    # -- adoption: two phases shared by the new primary (from DVCs) and
    # backups (from SV). Phase 1: chain catch-up of COMMITTED ops up to the
    # suffix base (hash-chain-verified fills from `src`). Phase 2: the
    # suffix itself, checksum-verified against the adopted headers. --

    def _begin_adoption(self, base: int, suffix: dict[int, Header],
                        commit_max: int, src: int, tip: int,
                        src_checkpoint: int = 0) -> None:
        self._adopt = suffix
        self._adopt_base = base
        self._adopt_tip = tip  # expected checksum of the prepare at `base`
        self._adopt_commit_max = max(commit_max, base)
        self._adopt_src = src
        self._adopt_src_checkpoint = src_checkpoint
        self._catchup: dict[int, tuple[Header, bytes]] = {}
        self._catchup_no_local = False
        # Truncate the log head to the committed prefix: our uncommitted
        # tail may diverge from the chosen log (its journal rows remain and
        # are revalidated by checksum below; the state machine never saw
        # them — only committed ops execute).
        self.op = self.commit_min
        self.parent_checksum = self.commit_checksum
        self._fast_forward(limit=base)
        self._verify_catchup_tip()
        self._request_catchup_window()
        for op, h in suffix.items():
            if op <= self.commit_min:
                continue  # our committed prefix already covers it
            got = self.journal.read_prepare(op)
            if got is None or got[0].checksum != h.checksum:
                # Ask EVERY peer (not just the best-log source): the
                # adopted header may cover a slot whose BODY is torn on
                # the source itself (nack merge keeps such ops — any
                # replica that acked the prepare can serve it; fills are
                # checksum-verified so duplicates are harmless).
                for r in range(self.replica_count):
                    if r != self.replica:
                        self._request_prepare(op, r)
        self._try_finish_view_change()

    CATCHUP_WINDOW = 32

    def _request_catchup_window(self) -> None:
        """Pipeline catch-up fetches (serial round trips would make a long
        catch-up slower than the view-change timeout — livelock)."""
        if self._adopt_src == self.replica:
            return
        if self.commit_min < self._adopt_src_checkpoint:
            # Too far behind: the ops we need predate the source's
            # checkpoint (its WAL ring no longer covers them), and filling
            # more than a ring's worth would overwrite our own fills — jump
            # via state sync (checkpoint shipping) instead. commit_min (not
            # the advancing op) is the stable lag measure: the source's
            # guard bounds (src_op - src_checkpoint) within one ring, so
            # once we sync to its checkpoint every remaining fill fits
            # distinct slots.
            if self.ticks - self._sync_request_tick >= RETRY_TICKS:
                self._sync_request_tick = self.ticks
                rq = Header(command=int(Command.request_sync_manifest))
                self._send(self._adopt_src, rq)
            return
        hi = min(self._adopt_base, self.op + self.CATCHUP_WINDOW)
        for o in range(self.op + 1, hi + 1):
            if o not in self._repair_wanted and o not in self._catchup:
                self._request_prepare(o, self._adopt_src)

    def _verify_catchup_tip(self) -> None:
        """Our LOCAL chain up to the suffix base may include prepares the
        cluster discarded (we were the old primary) — locally consistent
        but wrong. The DVC/SV carries the true checksum of the op at the
        base (`tip`); on mismatch, restart catch-up from the committed
        prefix fetching everything from the source (remote fills overwrite
        the stale rows and are chain-verified from commit_checksum)."""
        if (
            self.op < self._adopt_base
            or self._adopt_base == 0
            or self._adopt_base <= self.commit_min  # we're at/ahead of base:
            # our committed prefix subsumes it (quorum intersection)
        ):
            return
        if self.parent_checksum != self._adopt_tip:
            self._catchup_no_local = True
            self.op = self.commit_min
            self.parent_checksum = self.commit_checksum
            self._repair_wanted.clear()
            self._catchup.clear()

    def _drain_catchup(self) -> None:
        while self.op < self._adopt_base:
            if not self._catchup_no_local:
                self._fast_forward(limit=self._adopt_base)
                self._verify_catchup_tip()
            got = self._catchup.pop(self.op + 1, None)
            if got is None:
                break
            header, body = got
            if header.parent != self.parent_checksum:
                # stale/wrong fill: re-request
                self._repair_wanted.discard(header.op)
                self._request_prepare(header.op, self._adopt_src)
                break
            self.journal.write_prepare(header, body)
            self.op = header.op
            self.parent_checksum = header.checksum
        if self.op >= self._adopt_base:
            self._verify_catchup_tip()

    def _fast_forward(self, limit: int) -> None:
        """Advance the log head through locally-journaled ops that chain
        correctly (avoids refetching what we already hold)."""
        while self.op < limit:
            got = self.journal.read_prepare(self.op + 1)
            if got is None or got[0].parent != self.parent_checksum:
                return
            self.op += 1
            self.parent_checksum = got[0].checksum

    def _on_repair_prepare(self, header: Header, body: bytes) -> None:
        """A prepare arriving while in view_change: either a chain catch-up
        fill below the suffix base or an adopted suffix prepare. Any
        accepted fill counts as view-change progress (resets the retry/
        escalation timer — a long catch-up must not be abandoned)."""
        if self._adopt is None:
            return
        if header.op <= self._adopt_base:
            if header.op <= self.op:
                return  # already have it
            self._repair_wanted.discard(header.op)
            self._catchup[header.op] = (header, body)
            self._vc_tick = self.ticks
            self._vc_retries = 0
            self._drain_catchup()
            self._request_catchup_window()
            self._try_finish_view_change()
            return
        want = self._adopt.get(header.op)
        if want is None or want.checksum != header.checksum:
            return
        self.journal.write_prepare(header, body)
        self._repair_wanted.discard(header.op)
        self._vc_tick = self.ticks
        self._vc_retries = 0
        self._try_finish_view_change()

    def _adoption_complete(self) -> bool:
        assert self._adopt is not None
        anchor = max(self.commit_min, self._adopt_base)
        if self.op < anchor:
            return False  # catch-up still in flight
        if (
            self._adopt_base > self.commit_min
            and self._adopt_base > 0
            and self.parent_checksum != self._adopt_tip
        ):
            return False  # local tail was stale; refetch in flight
        for op, h in self._adopt.items():
            if op <= self.commit_min:
                continue  # already committed; consistent by quorum math
            got = self.journal.read_prepare(op)
            if got is None or got[0].checksum != h.checksum:
                return False
        return True

    def _try_finish_view_change(self) -> None:
        if self._adopt is None or not self._adoption_complete():
            return
        new_primary = self.view_candidate % self.replica_count
        if new_primary == self.replica:
            self._finish_view_change(primary=True)
        else:
            self._finish_view_change(primary=False)

    def _finish_view_change(self, primary: bool) -> None:
        assert self._adopt is not None
        # The adopted log head: suffix ops above our committed prefix win;
        # otherwise whichever of (base, commit_min) is further.
        ops = sorted(o for o in self._adopt if o > self.commit_min)
        if ops:
            self.op = ops[-1]
            self.parent_checksum = self._adopt[ops[-1]].checksum
        elif self._adopt_base > self.commit_min:
            self.op = self._adopt_base
            self.parent_checksum = self._adopt_tip
        else:
            self.op = self.commit_min
            self.parent_checksum = self.commit_checksum
        self.view = self.view_candidate
        self.log_view = self.view
        persist_view(self.superblock, self.view, self.log_view)
        self.status = "normal"
        self._primary_contact_tick = self.ticks
        adopt_commit_max = self._adopt_commit_max
        self._adopt = None
        self._dvc = {}
        self._repair_wanted.clear()
        # The quorum decided the log ends at self.op: destroy journal
        # evidence above it, or the next _dvc_suffix_headers scan would
        # re-advertise superseded headers under our NEW log_view and a
        # truncated prepare could shadow a committed op (see
        # Journal.invalidate_above).
        self.journal.invalidate_above(self.op)
        if primary:
            suffix = self._suffix_headers()
            sv = Header(
                command=int(Command.start_view),
                view=self.view,
                op=self.op,
                commit=self.commit_min,
                parent=self.commit_checksum,  # checksum of op `commit`
                timestamp=self.checkpoint_op,  # my WAL covers (this, op]
            )
            self._broadcast(sv, b"".join(h.to_bytes() for h in suffix))
            # Commit the known-committed prefix FIRST, then refill the
            # pipeline with only the still-uncommitted tail (a stale
            # committed entry would poison retransmission and quorum
            # counting).
            self._commit_up_to(adopt_commit_max)
            for op in range(self.commit_min + 1, self.op + 1):
                got = self.journal.read_prepare(op)
                assert got is not None
                h, body = got
                self.pipeline[op] = {
                    "header": h, "body": body, "oks": {self.replica}
                }
        else:
            self._commit_up_to(adopt_commit_max)
            # Re-ack the adopted-but-uncommitted tail so the new primary
            # can reach quorum and commit it in the new view.
            for op in range(self.commit_min + 1, self.op + 1):
                got = self.journal.read_prepare(op)
                if got is not None:
                    self._ack_prepare(got[0])

    def _on_start_view(self, header: Header, body: bytes) -> None:
        if header.view < self.view:
            return
        if header.view == self.view and (
            self.is_primary or header.replica != self.primary_index
        ):
            return  # same-view SV only from the view's primary (requested
            # re-adoption: a backup with a stale tail asks for one)
        suffix = [
            Header.from_bytes(body[i : i + HEADER_SIZE])
            for i in range(0, len(body), HEADER_SIZE)
        ]
        self.flush_commits()  # no async commits across a status change
        self.status = "view_change"
        self.view_candidate = header.view
        self._drop_quorum_tokens()
        self.pipeline = {}
        self._pending_prepares = {}
        self._repair_wanted.clear()
        self._vc_tick = self.ticks  # fresh adoption: reset retry state so
        self._vc_retries = 0  # stale counters can't abandon it instantly
        persist_view(self.superblock, header.view, self.log_view)
        self._begin_adoption(
            base=header.commit,
            suffix={h.op: h for h in suffix},
            commit_max=header.commit,
            src=header.replica,
            tip=header.parent,
            src_checkpoint=header.timestamp,
        )

    def _on_request_start_view(self, header: Header) -> None:
        # Serve any requester at or below our view (a recovering/stale
        # replica catches up from the authoritative current SV).
        if not self.is_primary or header.view > self.view:
            return
        suffix = self._suffix_headers()
        sv = Header(
            command=int(Command.start_view),
            view=self.view,
            op=self.op,
            commit=self.commit_min,
            parent=self.commit_checksum,  # checksum of op `commit`
            timestamp=self.checkpoint_op,  # my WAL covers (this, op]
        )
        self._send(
            header.replica, sv, b"".join(h.to_bytes() for h in suffix)
        )
