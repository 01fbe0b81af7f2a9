"""Cluster scenarios that hold the port's replica against the JAX one.

Each scenario drives a `Cluster` class it is given (the port's, or the JAX
package's in the tests, which pass the JAX `Cluster` and `Header` in; this
module imports nothing of the JAX package) through the steps of one case of
`tests/test_cluster.py` with requests made by numpy from a seed, and
returns a list of records: one after each step it checks. A record holds
what both packages must give bit for bit:

- every reply, header bytes and body;
- each replica's commit numbers, status and view, and the prepare hash
  chain (the checksum of every prepare header its journal holds);
- each replica's storage, zone by zone, as SHA-256 digests: the WAL and the
  client replies in full; the grid with the checkpoint blobs' dump rows
  zeroed (the last row of each table, which the JAX kernels fill with
  masked writes in unspecified order and the port never writes); every
  superblock copy decoded, with the checksums of the blobs that hold dump
  rows zeroed.

`backend_commit` and `backend_checkpoint_restart` (`tests/test_mesh_replica.py`)
run one replica over the backend of a `backend_factory`; `spill_and_sync`
(`tests/test_cluster_spill.py`) runs a spilling cluster.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json

import numpy as np

from tigerbeetle_tpu_torch.parallel.mesh import SNAP_REPLICATED, SNAP_SHARDED
from tigerbeetle_tpu_torch.types import (
    ACCOUNT_DTYPE,
    TRANSFER_DTYPE,
    Operation,
    TransferFlags,
)
from tigerbeetle_tpu_torch.vsr.durable import SNAPSHOT_LEAVES
from tigerbeetle_tpu_torch.vsr.header import Command
from tigerbeetle_tpu_torch.vsr.superblock import SuperBlock

# leaves whose last row (per shard in a sharded blob) is the dump row
DUMP_LEAVES = ("acct_rows", "xfer_rows", "fulfill", "acct_claim", "xfer_claim", "bal_acc")
ROW_BYTES = 128


# -- requests --------------------------------------------------------------


def accounts_body(ids, ledger: int = 1, code: int = 1) -> bytes:
    arr = np.zeros(len(ids), dtype=ACCOUNT_DTYPE)
    arr["id_lo"] = np.asarray(ids, dtype=np.uint64)
    arr["ledger"] = ledger
    arr["code"] = code
    return arr.tobytes()


def transfers_array(ids, dr, cr, amount, flags=0, pending_id=0, ledger: int = 1):
    arr = np.zeros(len(ids), dtype=TRANSFER_DTYPE)
    arr["id_lo"] = np.asarray(ids, dtype=np.uint64)
    arr["debit_account_id_lo"] = dr
    arr["credit_account_id_lo"] = cr
    arr["amount_lo"] = amount
    arr["pending_id_lo"] = pending_id
    arr["flags"] = flags
    arr["ledger"] = ledger
    arr["code"] = 1
    return arr


class Requests:
    """Seeded request bodies over a growing set of accounts: each account
    request makes new accounts (a few ids repeated, so that some events
    fail `exists`); each transfer request moves random amounts between
    them, with some events failing (a missing account, the same account on
    both sides), some pending, and posts and voids of earlier pendings."""

    def __init__(self, seed: int, first_account: int = 1, first_transfer: int = 1 << 20):
        self.rng = np.random.default_rng(seed)
        self.next_account = first_account
        self.next_transfer = first_transfer
        self.accounts: list[int] = []
        self.pending: list[int] = []

    def accounts_batch(self, n: int) -> tuple[int, bytes]:
        ids = list(range(self.next_account, self.next_account + n))
        self.next_account += n
        if self.accounts:
            k = max(1, n // 8)  # repeats of existing ids fail `exists`
            ids[:k] = self.rng.choice(self.accounts, size=k).tolist()
        self.accounts += ids
        return int(Operation.create_accounts), accounts_body(ids)

    def transfers_batch(self, n: int) -> tuple[int, bytes]:
        rng, accts = self.rng, np.asarray(self.accounts, dtype=np.uint64)
        ids = np.arange(self.next_transfer, self.next_transfer + n, dtype=np.uint64)
        self.next_transfer += n
        dr = rng.choice(accts, size=n)
        cr = rng.choice(accts, size=n)
        amount = rng.integers(1, 100, size=n).astype(np.uint64)
        kind = rng.integers(0, 16, size=n)
        flags = np.zeros(n, dtype=np.uint16)
        pending_id = np.zeros(n, dtype=np.uint64)
        dr[kind == 0] = self.next_account + 1000  # a missing account
        cr[kind == 1] = dr[kind == 1]  # the same account on both sides
        flags[kind == 2] = int(TransferFlags.pending)
        settle = np.flatnonzero(kind == 3)[:len(self.pending)]
        for j, i in enumerate(settle):
            flags[i] = int(TransferFlags.post_pending_transfer if j % 2 == 0
                           else TransferFlags.void_pending_transfer)
            pending_id[i] = self.pending[j]
            amount[i] = 0
        self.pending = self.pending[len(settle):] + ids[kind == 2].tolist()
        arr = transfers_array(ids, dr, cr, amount, flags, pending_id)
        return int(Operation.create_transfers), arr.tobytes()

    def mixed(self, n_batches: int, batch_size: int = 24) -> list[tuple[int, bytes]]:
        """Every third batch (the first included) makes accounts."""
        return [self.accounts_batch(batch_size) if b % 3 == 0
                else self.transfers_batch(batch_size) for b in range(n_batches)]


def encode_ids(ids) -> bytes:
    out = np.zeros((len(ids), 2), dtype=np.uint64)
    out[:, 0] = np.asarray(ids, dtype=np.uint64)
    return out.tobytes()


# -- records ---------------------------------------------------------------


def _digest(b) -> str:
    return hashlib.sha256(b).hexdigest()


def _mask_device_area(grid: bytearray, base: int, process) -> None:
    """Zero the dump rows of a device checkpoint's blobs at `base` (the
    leaves in SNAPSHOT_LEAVES order, each 4 KiB aligned)."""
    a_rows = (1 << process.account_slots_log2) + 1
    t_rows = (1 << process.transfer_slots_log2) + 1
    off = base
    for size, tail in ((a_rows * ROW_BYTES, ROW_BYTES), (t_rows * ROW_BYTES, ROW_BYTES),
                       (t_rows * 4, 4)):
        if off + size <= len(grid):
            grid[off + size - tail:off + size] = bytes(tail)
        off += (size + 4095) // 4096 * 4096


def _mask_sharded_blob(grid: bytearray, base: int) -> None:
    """Zero each shard's dump row in a sharded checkpoint blob at `base`
    (a u32 head length, the head JSON, the leaves); anything else there is
    left as it is."""
    n = int.from_bytes(grid[base:base + 4], "little")
    try:
        head = json.loads(bytes(grid[base + 4:base + 4 + n]))
        shards = int(head["n_shards"])
        sizes = head["sizes"]
    except (ValueError, KeyError, TypeError, UnicodeDecodeError):
        return
    off = base + 4 + n
    for name, size in zip(SNAP_SHARDED + SNAP_REPLICATED, sizes):
        if name in DUMP_LEAVES:
            per = size // shards
            tail = ROW_BYTES if name in ("acct_rows", "xfer_rows", "bal_acc") else 4
            for s in range(shards):
                end = off + (s + 1) * per
                grid[end - tail:end] = bytes(tail)
        off += size


def blob_kind(ledger) -> str:
    """How a backend checkpoints: "device" (a blob a leaf, as
    `vsr/durable.py` writes the device ledger's), "sharded" (one blob with
    a dump row a shard and leaf) or "opaque" (one blob, no dump rows: the
    native engine, the dual follower)."""
    if hasattr(ledger, "state") and not hasattr(ledger, "snapshot_bytes"):
        return "device"
    return "sharded" if hasattr(ledger, "n_shards") else "opaque"


def storage_record(storage, process, kind: str = "device") -> dict:
    """A storage's zones as digests, dump rows masked (see the module
    docstring). `process` sizes a device checkpoint's blobs; `kind` is the
    backend's `blob_kind`."""
    layout = storage.layout
    zone = {z.name: z for z in layout.sizes}  # the storage's own Zone enum
    zones = {}
    for name in ("wal_headers", "wal_prepares", "client_replies"):
        zones[name] = _digest(storage.read(zone[name], 0, layout.sizes[zone[name]]))
    grid = bytearray(storage.read(zone["grid"], 0, layout.sizes[zone["grid"]]))
    copies = []
    for c in range(layout.SUPERBLOCK_COPIES):
        raw = storage.read(zone["superblock"], c * layout.SUPERBLOCK_COPY_SIZE,
                           layout.SUPERBLOCK_COPY_SIZE)
        state, verdict = SuperBlock.decode_copy(raw)
        if state is None:
            copies.append(verdict)
            continue
        d = dataclasses.asdict(state)
        for b in d["blobs"]:
            if b["name"] in SNAPSHOT_LEAVES or (kind == "sharded" and b["name"] == "oracle"):
                b["checksum"] = 0
        copies.append(d)
    area = layout.snapshot_area_size
    for a in (0, 1):
        if kind == "sharded":
            _mask_sharded_blob(grid, a * area)
        elif kind == "device":
            _mask_device_area(grid, a * area, process)
    zones["grid"] = _digest(grid)
    zones["superblock"] = copies
    return zones


def replica_record(r, process) -> dict:
    chain = []
    for op in range(max(1, r.op - r.cluster.journal_slot_count + 1), r.op + 1):
        h = r.journal.get_header(op)
        chain.append(None if h is None else h.checksum)
    return {
        "status": r.status, "view": r.view, "op": r.op,
        "commit_min": r.commit_min, "commit_max": r.commit_max,
        "checkpoint_op": r.checkpoint_op,
        "commit_checksum": r.commit_checksum, "parent_checksum": r.parent_checksum,
        "chain": chain,
        "storage": storage_record(r.storage, process, blob_kind(r.ledger)),
    }


def cluster_record(cluster, replies) -> dict:
    return {
        "replies": [(h.to_bytes(), bytes(body)) for h, body in replies],
        "replicas": [replica_record(r, cluster.process_config) for r in cluster.replicas],
    }


# -- scenarios (tests/test_cluster.py) --------------------------------------


def commit_and_converge(Cluster, Header, **kw) -> list[dict]:
    """Seven mixed requests; then a lookup of the accounts through
    consensus."""
    cluster = Cluster(replica_count=3, **kw)
    client = cluster.add_client()
    req = Requests(21)
    replies = [cluster.execute(client, op, body) for op, body in req.mixed(7)]
    replies.append(cluster.execute(client, int(Operation.lookup_accounts),
                                   encode_ids(req.accounts[:16])))
    return [cluster_record(cluster, replies)]


def duplicate_request(Cluster, Header, **kw) -> list[dict]:
    """A resent request is answered from the client table, not executed."""
    cluster = Cluster(replica_count=3, **kw)
    client = cluster.add_client()
    replies = [cluster.execute(client, op, body) for op, body in Requests(21).mixed(4)]
    body = accounts_body([999_000_001])
    client.request(int(Operation.create_accounts), body)
    cluster.network.run()
    replies.append(client.take_reply())
    client.request_number -= 1  # a lost-reply retry of the same request
    client.in_flight = None
    client.request(int(Operation.create_accounts), body)
    cluster.network.run()
    replies.append(client.take_reply())
    return [cluster_record(cluster, replies)]


def backup_restart(Cluster, Header, **kw) -> list[dict]:
    """A backup crash-restarts over its storage; the cluster serves on."""
    cluster = Cluster(replica_count=3, **kw)
    client = cluster.add_client()
    req = Requests(22)
    replies = [cluster.execute(client, op, body) for op, body in req.mixed(7)]
    cluster.restart_replica(2)
    out = [cluster_record(cluster, replies)]
    replies.append(cluster.execute(client, *req.transfers_batch(24)))
    out.append(cluster_record(cluster, replies))
    return out


def checkpoint_and_restart(Cluster, Header, **kw) -> list[dict]:
    """More ops than the checkpoint interval: every replica checkpoints,
    the WAL wraps over checkpointed ops; a backup restarts from its
    checkpoint and its WAL tail."""
    cluster = Cluster(replica_count=3, **kw)
    client = cluster.add_client()
    interval = cluster.cluster_config.checkpoint_interval
    req = Requests(9)
    replies = [cluster.execute(client, op, body)
               for op, body in req.mixed(interval + 6, batch_size=4)]
    out = [cluster_record(cluster, replies)]
    cluster.restart_replica(1)
    replies.append(cluster.execute(client, *req.transfers_batch(8)))
    out.append(cluster_record(cluster, replies))
    return out


def pipelined_clients(Cluster, Header, **kw) -> list[dict]:
    """Four clients' requests pipeline through the primary."""
    cluster = Cluster(replica_count=3, **kw)
    clients = [cluster.add_client() for _ in range(4)]
    req = Requests(31)
    replies = [cluster.execute(clients[0], *req.accounts_batch(24))]
    for c in clients:
        c.request(*req.transfers_batch(24))
    cluster.network.run()
    replies += [c.take_reply() for c in clients]
    return [cluster_record(cluster, replies)]


def reply_persisted(Cluster, Header, **kw) -> list[dict]:
    """A request retransmitted after a checkpoint and a restart of every
    replica is answered with its original reply from the client_replies
    zone, not executed again."""
    cluster = Cluster(replica_count=3, **kw)
    client = cluster.add_client()
    body = accounts_body([71])
    replies = [cluster.execute(client, int(Operation.create_accounts), body)]
    for r in cluster.replicas:
        r.checkpoint()
    for i in range(3):
        cluster.restart_replica(i)
    cluster.run_ticks(80)
    primary = next(r for r in cluster.replicas
                   if r.status == "normal" and r.view % 3 == r.replica)
    rq = Header(command=int(Command.request), operation=int(Operation.create_accounts),
                client=client.client_id, context=client.session, request=1)
    rq.set_checksum_body(body)
    rq.set_checksum()
    seen = []

    def sniff(src, dst, data):
        if dst == client.client_id:
            h = Header.from_bytes(data[:128])
            if h.command == int(Command.reply):
                seen.append((h, data[128:h.size]))
        return True

    cluster.network.filters.append(sniff)
    cluster.network.send(client.client_id, primary.replica, rq.to_bytes() + body)
    cluster.network.run()
    cluster.network.filters.remove(sniff)
    return [cluster_record(cluster, replies + seen[:1])]


def group_commit(Cluster, Header, **kw) -> list[dict]:
    """Four fast-tier transfer requests in one pump turn commit as one
    fused group on a replica with a commit window."""
    cluster = Cluster(replica_count=1, **kw)
    r = cluster.replicas[0]
    clients = [cluster.add_client() for _ in range(4)]
    r.commit_window = 8
    clients[0].request(int(Operation.create_accounts), accounts_body(range(1, 41)))
    cluster.network.run()
    r.pump_commits()
    r.flush_commits()
    cluster.network.run()
    replies = [clients[0].take_reply()]
    for i, c in enumerate(clients):
        k = np.arange(16)
        arr = transfers_array(np.arange(1000 + 16 * i, 1016 + 16 * i),
                              1 + (k + 3 * i) % 40, 1 + (k + 3 * i + 7) % 40, 1 + i)
        if i == 3:
            arr["debit_account_id_lo"][5] = 77  # one failing event
        c.request(int(Operation.create_transfers), arr.tobytes())
    cluster.network.run()
    r.pump_commits()
    fused = r.group_stats["fused_ops"]
    r.flush_commits()
    cluster.network.run()
    replies += [c.take_reply() for c in clients]
    rec = cluster_record(cluster, replies)
    rec["fused_ops"] = fused
    return [rec]


def standby_follows(Cluster, Header, **kw) -> list[dict]:
    """A standby journals and commits without voting, and follows the
    active set into a new view after the primary fails."""
    cluster = Cluster(replica_count=3, standby_count=1, **kw)
    client = cluster.add_client()
    req = Requests(81)
    replies = [cluster.execute(client, op, body) for op, body in req.mixed(4)]
    cluster.run_ticks(10)
    out = [cluster_record(cluster, replies)]
    cluster.detach_replica(0)
    cluster.run_ticks(80)
    client.request(*req.accounts_batch(16))
    cluster.network.run()
    if client.reply is None:
        client.resend()
        cluster.network.run()
    replies.append(client.take_reply())
    cluster.run_ticks(20)
    out.append(cluster_record(cluster, replies))
    return out


# -- backend scenarios (tests/test_mesh_replica.py), one replica ------------


def backend_commit(Cluster, Header, **kw) -> list[dict]:
    """Accounts, transfers, a lookup of the accounts and a resubmission
    that fails `exists`, through one replica over the backend of
    `backend_factory`."""
    cluster = Cluster(replica_count=1, **kw)
    client = cluster.add_client()
    ids = list(range(1, 25))
    replies = [cluster.execute(client, int(Operation.create_accounts), accounts_body(ids))]
    k = np.arange(48)
    xfers = transfers_array(500 + k, 1 + k % 24, 1 + (k + 11) % 24, 2)
    replies.append(cluster.execute(client, int(Operation.create_transfers), xfers.tobytes()))
    replies.append(cluster.execute(client, int(Operation.lookup_accounts), encode_ids(ids)))
    replies.append(cluster.execute(client, int(Operation.create_transfers), xfers[:4].tobytes()))
    replies.append(cluster.execute(client, *Requests(41, first_account=100).mixed(1)[0]))
    return [cluster_record(cluster, replies)]


def backend_checkpoint_restart(Cluster, Header, **kw) -> list[dict]:
    """A checkpoint, a WAL tail after it, a crash-restart that restores the
    backend's blob and replays the tail, then more commits."""
    cluster = Cluster(replica_count=1, **kw)
    client = cluster.add_client()
    replies = [cluster.execute(client, int(Operation.create_accounts),
                               accounts_body(range(1, 9)))]
    k = np.arange(16)
    replies.append(cluster.execute(client, int(Operation.create_transfers), transfers_array(
        900 + k, 1 + k % 8, 1 + (k + 3) % 8, 1, flags=np.where(k % 4 == 0, 2, 0)).tobytes()))
    cluster.replicas[0].checkpoint()
    k = np.arange(8)
    replies.append(cluster.execute(client, int(Operation.create_transfers), transfers_array(
        950 + k, 1 + k % 8, 1 + (k + 5) % 8, 1,
        flags=np.where(k < 2, int(TransferFlags.post_pending_transfer), 0),
        pending_id=np.where(k < 2, 900 + 4 * k, 0)).tobytes()))
    out = [cluster_record(cluster, replies)]
    cluster.restart_replica(0)
    client2 = cluster.add_client()
    replies.append(cluster.execute(client2, int(Operation.lookup_accounts),
                                   encode_ids(range(1, 9))))
    replies.append(cluster.execute(client2, int(Operation.create_transfers), transfers_array(
        [999, 1000], [1, 2], [2, 3], 5).tobytes()))
    out.append(cluster_record(cluster, replies))
    return out


def spill_and_sync(Cluster, Header, **kw) -> list[dict]:
    """`tests/test_cluster_spill.py`'s spilling cluster: three replicas,
    each with a forest block area, spill their cold transfer tail alike;
    a backup detached for more ops than its WAL holds catches up by state
    sync, the forest blocks shipped with the checkpoint."""
    cluster = Cluster(replica_count=3, grid_size=64 * 1024 * 1024, forest_blocks=192, **kw)
    client = cluster.add_client()
    req = Requests(51)
    replies = [cluster.execute(client, *req.accounts_batch(60))]
    replies += [cluster.execute(client, *req.transfers_batch(96)) for _ in range(30)]

    def record():
        rec = cluster_record(cluster, replies)
        for r, out in zip(cluster.replicas, rec["replicas"]):
            out["spilled"] = sorted(r.ledger.spill.spilled)
            out["cycles"] = r.ledger.spill.stats["cycles"]
        return rec

    out = [record()]
    cluster.detach_replica(2)
    replies += [cluster.execute(client, *req.transfers_batch(96)) for _ in range(66)]
    out.append(record())
    cluster.reattach_replica(2)
    cluster.run_ticks(200)
    out.append(record())
    return out


SCENARIOS = {
    "commit_and_converge": commit_and_converge,
    "duplicate_request": duplicate_request,
    "backup_restart": backup_restart,
    "checkpoint_and_restart": checkpoint_and_restart,
    "pipelined_clients": pipelined_clients,
    "reply_persisted": reply_persisted,
    "group_commit": group_commit,
    "standby_follows": standby_follows,
}
