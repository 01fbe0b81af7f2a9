#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tigerbeetle_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases (each failure exits non-zero):
1. environment: torch, CUDA, the card's name and power limit, the host's
   machine type; build the kernels from `tigerbeetle_tpu_torch/csrc/` and
   the native engine from `native/ledger.cc`; in the group commit's (K5)
   and the reload's (K10r) SASS, every cluster barrier's wait must be
   followed by an L1 invalidation before any load (their later slots and
   chunks read what earlier ones wrote); the card's dependent-load
   latency from device memory and from shared memory (pointer chases), the
   units of the serial kernels' bounds, and the rate at which it reads
   chosen 32-byte sectors of 2^24 rows of 128 bytes (the sector probe), the
   unit of the scans' (K8, K10);
2. every kernel against its plain PyTorch version on the card, at a reduced
   table geometry (2^14 account / 2^16 transfer slots): result codes and
   every state tensor must be bit-identical, on batches that exercise every
   failure path and the fault gates (overflow, capacity, sticky fault,
   exhausted probe windows, a group whose second slot faults, a group with
   a padding slot, an install with no free slot, tombstones and a nonzero
   dump row under the fingerprint; the one-launch K3 also on its capacity
   guard, a sticky fault, windows with no free slot, claim contention, one
   lane, 8192 lanes holding 8190 events and a wave mask; the serial K4 also
   on every hazard request of tigerbeetle_tpu_torch/testing/hazards.py on
   one table, missing pendings read from a tombstone and from a full window
   included); the one-launch install (K9) of a whole table on the restores
   of tigerbeetle_tpu_torch/testing/install_cases.py (rows sharing a probe
   window, some losing all four claim rounds; a partial last chunk; a chunk
   whose free slots the one before filled; tombstones reused) in chunks of
   64 and of 8192; the one-launch group commit (K5) on the cases of
   tigerbeetle_tpu_torch/testing/group_cases.py (a reused id, a balance
   limit the slot before crossed, a probe window the slot before filled,
   padding slots, a slot in which every lane fails, the capacity gate
   tripped by slot 2, a fault word set before the group) at 4 and 16
   slots of 64 and of 8192 lanes, each giving the codes and fault word it
   is built for; the reply-code fold (K7) on padding
   slots, a one-lane slot, high-bit codes and ring slots routed to the dump
   slot, and on every case of tigerbeetle_tpu_torch/testing/fold_cases.py
   (k of 1, 2, 5 and 16, n_pad of 1 to 8192, empty and inactive slots
   anywhere, repeated ring indices, chains of 0 and 2^64 - 1), its wrapper
   raising ValueError and launching nothing on a bad slot count, lane count
   or ring index; the state fingerprint (K6) on every case of
   tigerbeetle_tpu_torch/testing/fp_cases.py (no live row, tombstones, keys
   with one word set, a live dump row, every slot live, one in 997) at 2^14
   / 2^16 slots, at counts that are no multiple of a block's rows and with
   an empty account table; both leave their kept scratch words zero; the
   lookups (K1, and K11l on 1 and on 8 shards) on every case of
   tigerbeetle_tpu_torch/testing/lookup_cases.py (hits at once and after
   tombstones, misses ended by an empty slot after tombstones or at once,
   windows with one tombstone or none, the all-zero and all-ones keys, one
   key in many lanes, a table or one shard with no empty slot) at 2^16
   slots and 1, 33 and 8190 keys: found, rows and resolved of every lane,
   and each crafted lane's answer as its chain is built to give; the fast
   account commit (K2 fast) on every case of
   tigerbeetle_tpu_torch/testing/account_cases.py (ids sharing a whole
   probe window, so that two lose all four claim rounds, or a first
   position; windows with no empty slot, with and without tombstones; the
   load guard at its limit and one past; a sticky fault; every event
   failing; padding lanes; tombstones reused; a batch timestamp below the
   stored commit_ts and below n; a new id twice) at 2^10 slots and 128
   lanes and at 2^14 and 2048, each leaving the fault word it is built for;
3. the main path at deployment size: StateMachine over
   DeviceLedger(ConfigProcess()) (2^20 account / 2^24 transfer slots) with
   the reference benchmark's traffic (10,000 accounts, batches of 8190,
   uniform random accounts, reversed ids), a two-phase pair, a request with
   linked chains (one broken), then 4 groups of 16 requests through the
   replica's group commit (commit_group_async, commit_finish_many,
   commit_finish) and lookups; every account holds the balances the
   requests give, the reply bytes of the two-phase and linked requests
   equal the port's own plain versions on the CPU; the state fingerprint
   equals its plain version and fp_rows_np over the host rows; a second
   ledger rebuilt by install_snapshot_rows from the live rows (one K9 call a
   table; the upload, install and host rebuild legs are printed)
   fingerprints and looks up the same, also after one more group on both;
   every kernel ran;
4. every kernel against its plain version on copies of the main path's
   state, on batches of the shapes the main path gives it (codes and every
   state leaf equal); the kernel table's max_abs_err comes from here;
   the fold (K7) on the results of a real group (16 x 8192) and of a real
   request (8190); K9 also on three chunks of 8192 in one call;
5. a torch.profiler trace of more main-path requests (the card's busy and
   idle share; one K3 kernel and no memset a request), of one K2 fast call
   of 8190 new accounts on a copy of the account table (one kernel, no
   memset) and a cProfile of the host's share;
6. each kernel timed on the main path's state at its main-path shape,
   beside its plain version and its bound (the serial K4 also on a request
   of 8190 events: linked chains, then posts and voids; K5 also on the
   card alone; K9 on one chunk and on phase 3's restore, 133 chunks of 8192
   in one call; K6 and K7 also on the card alone, K6 beside its 64-byte
   fetch floor; K1 also on the card alone, beside its bound: the larger of
   its bytes and 1 + its longest probe chain dependent loads at phase 1's
   chase time; K2 fast and K11af also on the card alone, beside the floor
   of one cluster launch passing 4, 7 and 10 cluster barriers);
7. the dual-commit follower at deployment size: DualLedger(20, 24,
   follower=True, warm_kernels=True) on cuda, driven as the replica drives
   it (native execute answers, then apply_commit at finalize, in op order):
   10,000 accounts, 64 requests of 8190 transfers in runs of 16 committed
   as native groups and broken by account requests, a pending request and
   its posts and voids, the linked request, a commitment probe, then a
   restore from the native snapshot (K9 in the applier) and two more runs
   of 16 requests: the first under the applier's device trace window, the
   second sampled by the applier's latency anatomy (instrument(), trace
   ids and enqueue stamps: the applier waits for each sampled group on
   the card); finalize() must report verified, the hash-log ring and the
   commitment probe green, and the fold and the group commit must have
   run. The same requests through a NativeLedger alone give the reply
   rate without the follower. At 2^12 / 2^14 slots, a corrupted op 5 must
   fail the check at op 5;
8. (run right after phase 3, on its ledger, before phases 5 and 6 commit
   more) query_transfers by debit and credit account for 16 accounts against
   the script's own record of the transfers it sent, looked up by id and in
   timestamp order; query_accounts and query_transfers on ledger 2 must
   raise QUERY_LIMIT; out-of-range values and unindexed fields must raise;
   the filter scan (K8) against its plain version on six fields of both
   tables (half-word, one, two and four words) at 2^20 / 2^24 slots, and
   timed there; K8 also on the tables of
   tigerbeetle_tpu_torch/testing/scan_cases.py at 2^24 slots (matches at
   tile edges, in the last slot before the dump row, only in the last tile,
   exactly QUERY_LIMIT and one more, dead rows and the dump row carrying
   the value, none); in a process of its own under torch.profiler, each K8
   call must be one kernel and a table's K9 install one, with no memset,
   and both are timed through their wrappers and on the card alone; in
   another process (`chip_smoke.k5_child`), each K5 group of 16 x 8190
   must be one kernel and no memset, timed likewise; and in a third
   (`chip_smoke.digest_child`), each K6 call on tables of phase 6's live
   rows and each K7 call (k from 1 to 16, with a ring and without) must be
   one kernel with no memset and no copy, both timed through their
   wrappers and on the card alone; and in a fourth
   (`chip_smoke.lookup_child`), K1 and K11l (8 shards) on 2^20 account
   slots a table holding phase 3's 10,000 accounts: each wrapper call one
   kernel with no memset or copy, each lookup request of 8190 ids through
   StateMachine one kernel and one device-to-host copy, both timed through
   the wrapper and on the card alone, the request's wall time;
9. the bounded-memory ledger: StateMachine over DeviceLedger(2^20 account /
   2^20 transfer slots, forest=Forest(Grid(MemoryStorage), memtable_max=
   8192)) on cuda with the threaded IO worker: 10,000 accounts and 128
   requests of 8190 transfers (8 of pendings first, the benchmark traffic,
   then 8 of posts and voids of those pendings, spilled by then) must run
   at least 2 spill cycles and reload at least 65,000 rows; every reply,
   every account, a lookup of 8190 ids (half spilled) and the debit-account
   queries of 16 accounts equal the native engine NativeLedger(20, 24) on
   the same requests; it prints the rate, the request latency and each
   cycle's legs; the gather (K10g) must have launched once for each side
   of each cycle; then the spill kernels (K10) against their plain
   versions on a copy of the table before the first cycle (head, split,
   the gather of the whole cold side and of the whole hot side, padded to
   whole chunks, and the whole rebuild in one launch and in one launch a
   chunk, which must equal the ledger's own), the reload (K10r) on the
   cases of tigerbeetle_tpu_torch/testing/reload_cases.py (one, two and
   many chunks, resident and repeated ids, a capacity fault in a middle
   chunk before full windows, an earlier fault) at 2^14 in chunks of 256
   and at 2^18 in chunks of 8192, the split (K10s) on the tables of
   tigerbeetle_tpu_torch/testing/split_cases.py (duplicates, all-equal,
   two far-apart clusters, u64 max among the live timestamps) at 2^20 and
   2^24 at five ranks each, and at 2^24 on a copy of phase 3's state
   (split at 3/4 of live, the gather of 8192 cold rows and of both whole
   sides, a reload of 8192 rows), the reload's all-or-nothing gate on
   copies through both entry points (capacity at 2^24, an earlier fault,
   probe windows with no empty slot at 2^16), and their times (the gather
   at both sides of the cycle and at 8192 rows, beside torch.index_select;
   the rebuild in one launch; the split beside its floor at the card's
   64-byte fetch); then, in a process of its own under torch.profiler
   (`chip_smoke.cycle_child`), a spill cycle whose split must be at most
   four kernels and whose rebuild one, and a one-chunk reload one, none
   with a memset;
10. the sharded ledger on one card (K11): each sharded kernel against its
   plain version on the card at 2^12 / 2^14 slots per shard and 8 shards,
   on every failure path and fault gate (an exhausted shard, claim
   contention on one slot, a request in which no lane wants a slot, no free
   slot on any shard, overflow, both capacity gates and one shard exactly at
   and one past its load limit, a sticky fault, a linked chain across four
   shards broken mid-chain, post and void across shards), the serial
   transfer kernel on the hazard requests of
   tigerbeetle_tpu_torch/testing/hazards.py and the fast account kernel
   (K11af) on the cases of tigerbeetle_tpu_torch/testing/account_cases.py
   at 2^10 and 2^12 slots per shard; then StateMachine over
   ShardedLedger(8, ConfigProcess()) (2^20 account and 2^24 transfer slots
   per shard, about 19 GiB) with phase 3's requests (10,000 accounts, 64 x
   8190 benchmark transfers and 8190 pendings on the fast tier, their
   posts and voids and the linked request on the serial tier): every reply
   and all 10,000 accounts equal NativeLedger(20, 24)'s, and every K11
   kernel ran; the rate of the 64 benchmark requests and the wall time of
   the two-phase and linked ones; four fast requests on a fresh sharded
   ledger in a process of their own, under the profiler, must each be one
   fast-commit launch and no memset, and so must its first create_accounts
   request (8190, K11af); each kernel against its plain version on
   two copies of that state at the path's shapes (the serial ones on 1810
   accounts and on 8190 transfers: linked chains, posts and voids), their
   times (the serial transfer kernel's bound one shared-memory round trip
   an event; K11l also on the card alone, beside its bound as K1's), and
   a checkpoint blob restored into a fresh ledger on the card answering
   alike;
11. in a process of its own (`chip_smoke.account_walk_child`), the serial
   account commits (K2 serial and K11as, csrc/account_walk.cuh: a parallel
   plan, then a one-warp walk that re-probes an event only where the batch
   wrote into its window) against their plain versions on every hazard
   request of tigerbeetle_tpu_torch/testing/hazards.py (ACCOUNT_CASES: an
   insert at a later event's stop, live and rolled-back duplicates, a
   rollback's tombstone at another id's stop, a window the batch fills,
   tombstones and the empty and tombstone keys, a chain open at the end,
   chains across the walk's groups of 32, a tripped entry gate, events past
   n) at 2^14 slots a quarter full and at
   the path's 2^20 (8 shards for K11as), each with the fault it is built
   for and the events it re-probed; both at 1810 events (one linked pair)
   and 8190 (a linked pair every 50) on the 2^20 tables against the plain
   version on a host copy of the state; under torch.profiler two calls of
   each at 1810 and at 8190 events must each be one or two kernels and no
   memset; the re-probes of four more calls; both timed at 1810 events (one
   linked pair) and 8190 (a linked pair every 50) through the wrapper and
   on the card alone.
The last two lines are the kernel table and {"ok": true, "device": ...}.
"""

from __future__ import annotations

import json
import os
import platform
import subprocess
import sys
import time

import numpy as np

SEED = 20260217
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet


def log(*a):
    print(*a, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# ----------------------------------------------------------------------
# batches (numpy wire rows, from the seed)
# ----------------------------------------------------------------------


def accounts(types, ids, ledger=2, code=1, flags=0):
    a = np.zeros(len(ids), dtype=types.ACCOUNT_DTYPE)
    a["id_lo"] = np.asarray(ids, dtype=np.uint64)
    a["ledger"] = ledger
    a["code"] = code
    a["flags"] = flags
    return a


def transfers(types, ids, dr, cr, amount, ledger=2, code=1, flags=0, pending_id=0):
    t = np.zeros(len(ids), dtype=types.TRANSFER_DTYPE)
    t["id_lo"] = np.asarray(ids, dtype=np.uint64)
    t["debit_account_id_lo"] = dr
    t["credit_account_id_lo"] = cr
    t["amount_lo"] = amount
    t["pending_id_lo"] = pending_id
    t["ledger"] = ledger
    t["code"] = code
    t["flags"] = flags
    return t


def random_pairs(rng, n, n_accounts):
    dr = rng.integers(1, n_accounts + 1, n)
    cr = rng.integers(1, n_accounts, n)
    cr = cr + (cr >= dr)  # uniform over the other accounts
    return dr.astype(np.uint64), cr.astype(np.uint64)


# ----------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ----------------------------------------------------------------------


def max_abs_diff(a, b) -> int:
    """The largest |a - b| over all elements, widened to int64; 0 when the
    tensors are equal (tested first: table-sized leaves are compared whole)."""
    import torch

    if a.shape != b.shape:
        return 1 << 62
    if torch.equal(a, b):
        return 0
    d = a != b
    return int((a[d].to(torch.int64) - b[d].to(torch.int64)).abs().max())


def compare_states(sa, sb) -> int:
    return max(max_abs_diff(sa[k], sb[k]) for k in sa)


def clone_state(s):
    return {k: v.clone() for k, v in s.items()}


def seeded_state(L, types, process, rng, device):
    """A small ledger: accounts on two ledgers, committed transfers, open
    pendings, and a few tombstones from a rolled-back chain."""
    ledger = L.DeviceLedger(process, device="cpu")
    accts = accounts(types, np.arange(1, 3001))
    accts["ledger"][2000:] = 3  # ledger mismatches
    ledger.execute_dense(types.Operation.create_accounts, 10_000, accts)
    ts = 10_000
    dr, cr = random_pairs(rng, 4000, 1999)
    t = transfers(types, np.arange(100_001, 104_001), dr, cr, rng.integers(1, 1000, 4000))
    ts += 10_000
    ledger.execute_dense(types.Operation.create_transfers, ts, t)
    dr, cr = random_pairs(rng, 3000, 1999)
    p = transfers(types, np.arange(200_001, 203_001), dr, cr, rng.integers(1, 1000, 3000),
                  flags=2)
    ts += 10_000
    ledger.execute_dense(types.Operation.create_transfers, ts, p)
    # a broken chain leaves tombstones in the transfer table
    chain = transfers(types, [300_001, 300_002, 300_003], [1, 2, 3], [4, 5, 6], [5, 5, 0],
                      flags=[1, 1, 0])
    ts += 10_000
    ledger.mode = "serial"
    ledger.execute_dense(types.Operation.create_transfers, ts, chain)
    ledger.check_fault()
    return {k: v.to(device) for k, v in ledger.state.items()}, ts


def exhausted(torch, state, rng, tombs):
    """A copy of `state` whose transfer table has no empty slot left: every
    empty row gets random words, then `tombs` random rows are tombstoned."""
    out = clone_state(state)
    rows = out["xfer_rows"].cpu().numpy()
    empty = np.nonzero((rows[:-1, :4] == 0).all(1))[0]
    rows[empty] = rng.integers(-(1 << 31), 1 << 31, (len(empty), 32)).astype(np.int32)
    rows[rng.choice(len(rows) - 1, tombs, replace=False)] = -1
    out["xfer_rows"].copy_(torch.from_numpy(rows))
    return out


def fast_transfer_batch(types, rng, B, pv: bool):
    dr, cr = random_pairs(rng, B, 1999)
    amt = rng.integers(1, 1 << 40, B).astype(np.uint64)
    flags = np.where(rng.random(B) < 0.3, 2, 0).astype(np.uint16)
    t = transfers(types, np.arange(500_001, 500_001 + B), dr, cr, amt, flags=flags)
    k = B // 10
    t["debit_account_id_lo"][0:k // 2] += 1_000_000  # debit_account_not_found
    t["credit_account_id_lo"][k // 2:k] += 1_000_000  # credit_account_not_found
    t["credit_account_id_lo"][k:2 * k] = rng.integers(2001, 3001, k)  # ledger mismatch
    t["id_lo"][2 * k:3 * k] = np.arange(100_001, 100_001 + k)  # exists (with differences)
    t["amount_lo"][3 * k:3 * k + 10] = 0  # amount_must_not_be_zero
    t["id_lo"][3 * k + 10] = 0  # id_must_not_be_zero
    t["timeout"][3 * k + 11] = 7  # timeout without pending
    if pv:
        j = np.arange(4 * k, 4 * k + 2000)  # post/void of registered pendings
        t["flags"][j] = np.where(j % 2, 4, 8)
        t["pending_id_lo"][j] = 200_001 + (j - 4 * k)
        t["debit_account_id_lo"][j] = 0
        t["credit_account_id_lo"][j] = 0
        t["ledger"][j] = 0
        t["code"][j] = 0
        t["amount_lo"][j[::3]] = 0
        t["pending_id_lo"][j[-20:]] = 999_999_999  # pending_transfer_not_found
        t["pending_id_lo"][j[-40:-20]] = 100_001 + np.arange(20)  # not pending
    return t


def serial_transfer_batch(types, rng, n):
    """Linked chains (one broken), balancing flags, duplicate ids, in-batch
    post/void and plain transfers."""
    dr, cr = random_pairs(rng, n, 1999)
    t = transfers(types, np.arange(600_001, 600_001 + n), dr, cr,
                  rng.integers(1, 500, n).astype(np.uint64))
    t["flags"][0:6] = [1, 1, 0, 1, 1, 0]  # two chains
    t["amount_lo"][5] = 0  # breaks the second chain
    t["flags"][10:14] = [16, 32, 16, 32]  # balancing
    t["amount_lo"][12] = 0
    t["id_lo"][20:24] = 600_001 + 30  # duplicate ids
    t["flags"][40] = 2  # pending, posted in the same batch
    t["flags"][41] = 4
    t["pending_id_lo"][41] = t["id_lo"][40]
    t["flags"][42] = 8  # void of an already-posted pending
    t["pending_id_lo"][42] = t["id_lo"][40]
    t["flags"][43] = 8  # void of a registered pending
    t["pending_id_lo"][43] = 202_001
    for j in (41, 42, 43):
        t["debit_account_id_lo"][j] = 0
        t["credit_account_id_lo"][j] = 0
        t["ledger"][j] = 0
        t["code"][j] = 0
        t["amount_lo"][j] = 0
    t["flags"][n - 1] = 1  # chain left open at the end
    return t


def account_batch(types, rng, B, base, serial: bool):
    a = accounts(types, np.arange(base, base + B))
    k = max(B // 16, 4)
    a["id_lo"][0:k] = np.arange(1, k + 1)  # exists (ledger differs for some)
    a["ledger"][0:k:2] = 3
    a["reserved"][k] = 1
    a["flags"][k + 1] = 1 << 5  # reserved flag
    a["flags"][k + 2] = 6  # mutually exclusive limits
    a["ledger"][k + 3] = 0
    a["code"][k + 4] = 0
    a["id_lo"][k + 5] = 0
    if serial:
        a["flags"][k + 6:k + 9] = [1, 1, 0]  # broken chain: its last member exists
        a["id_lo"][k + 8] = 5
        a["flags"][k + 10:k + 12] = [1, 0]  # healthy chain
        a["id_lo"][k + 13] = a["id_lo"][k + 14]  # duplicate ids
    return a


def hold(torch, name, start, run_kernel, run_plain):
    """Run a kernel and its plain version on two copies of `start`: their
    outputs and every state leaf must be equal. Returns the plain run's
    outputs (a tuple) and state."""
    sk, sp = clone_state(start), clone_state(start)
    rk = run_kernel(sk)
    torch.cuda.synchronize()
    rp = run_plain(sp)
    torch.cuda.synchronize()
    if not isinstance(rk, tuple):
        rk, rp = (rk,), (rp,)
    outs = [max_abs_diff(a, b) for a, b in zip(rk, rp) if a is not None or b is not None]
    err = max(outs + [compare_states(sk, sp)])
    hit = ""
    if rp[0] is not None and rp[0].dtype == torch.int32 and rp[0].dim():
        codes = np.bincount(rp[0].cpu().numpy().astype(np.int64) & 0xFF)
        hit = f" codes={ {i: int(c) for i, c in enumerate(codes) if c} }"
    log(f"  {name}: max_abs_err={err} fault={int(sp['fault'])}{hit}")
    if err != 0:
        where = [(f"output {k}", a, b) for k, (a, b) in enumerate(zip(rk, rp)) if a is not None]
        where += [(k, sk[k], sp[k]) for k in sk]
        for what, a, b in where:
            if a.shape == b.shape and not torch.equal(a, b):
                idx = (a != b).nonzero()[:4].tolist()
                log(f"    {what}: {int((a != b).sum())} differ; at {idx}: kernel "
                    f"{[int(a[tuple(i)]) for i in idx]}, plain {[int(b[tuple(i)]) for i in idx]}")
        fail(f"{name} differs from its plain version")
    return rp, sp


# (cap_log2, lanes) of the account cases (testing/account_cases.py): the CPU
# tests' geometry, where ids share whole windows, and that of the fault gates
ACCOUNT_GEOMETRIES = {None: ((10, 128), (14, 2048)), 8: ((10, 128), (12, 2048))}


def account_case_kernels(torch, n_shards, dev, errs=None):
    """K2 fast (`n_shards` None) or K11af (8 shards) against its plain
    version on the card on every case of testing/account_cases.py at each
    geometry of ACCOUNT_GEOMETRIES: codes and every leaf equal, and the
    fault word each case is built for. Records errs[name] when given."""
    import zlib

    from tigerbeetle_tpu_torch import convert
    from tigerbeetle_tpu_torch import kernels as K
    from tigerbeetle_tpu_torch.constants import ConfigProcess
    from tigerbeetle_tpu_torch.models import ledger as L
    from tigerbeetle_tpu_torch.parallel import mesh as M
    from tigerbeetle_tpu_torch.testing import account_cases as AC

    if n_shards:
        name0, kern, plain = ("K11 mesh_commit_accounts fast", K.mesh_commit_accounts_fast,
                              M.commit_accounts_fast_plain)
    else:
        name0, kern, plain = ("K2 commit_accounts fast", K.commit_accounts_fast,
                              L.commit_accounts_fast_plain)
    for log2, B in ACCOUNT_GEOMETRIES[n_shards]:
        process = ConfigProcess(account_slots_log2=log2, transfer_slots_log2=8)
        base = convert.state_to_numpy(M.ShardedLedger(n_shards, process, device="cpu").state
                                      if n_shards else L.init_state(process, "cpu"))
        for case in AC.CASES:
            rng = np.random.default_rng(SEED + zlib.crc32(f"{case}.{log2}.{n_shards}".encode()))
            c = AC.account_case(case, log2, n_shards, B, rng)
            st = dict(base, acct_rows=c["acct_rows"],
                      acct_used_slots=np.asarray(c["used"], dtype=np.uint64).reshape(
                          base["acct_used_slots"].shape),
                      acct_count=np.uint64(c["count"]), commit_ts=np.uint64(c["commit_ts"]),
                      fault=np.uint32(c["fault"]))
            rows = torch.from_numpy(c["rows"].view(np.int32)).to(dev)
            n, ts = c["n"], c["timestamp"]
            where = f"2^{log2} x {n_shards}" if n_shards else f"2^{log2}"
            name = f"{name0} (case {case}, {where}, {B} lanes)"
            _, sp = hold(torch, name, convert.state_from_numpy(st, dev),
                         lambda s: kern(s, rows, n, ts, log2),
                         lambda s: plain(s, rows, n, ts, log2))
            if int(sp["fault"]) != c["want_fault"]:
                fail(f"{name}: fault {int(sp['fault'])}, not {c['want_fault']}")
            if errs is not None:
                errs[name] = 0


def phase_kernels(torch, L, types, constants, dev):
    """K1-K4 against their plain versions on the card, on every failure
    path and the fault gates, at a reduced geometry."""
    from tigerbeetle_tpu_torch import kernels as K

    process = constants.ConfigProcess(account_slots_log2=14, transfer_slots_log2=16)
    a_log2, t_log2 = process.account_slots_log2, process.transfer_slots_log2
    rng = np.random.default_rng(SEED)
    base, ts = seeded_state(L, types, process, rng, dev)

    def check(name, run_kernel, run_plain, start=None):
        hold(torch, name, base if start is None else start, run_kernel, run_plain)

    B = 8190
    ids = np.concatenate([np.arange(1, 6001), np.arange(7_000_000, 7_000_000 + B - 6001), [0]])
    key4 = L.ids_to_batch([int(x) for x in ids], dev)["key4"]
    check("K1 lookup",
          lambda s: K.lookup(key4, s["acct_rows"], a_log2),
          lambda s: L.table_lookup_plain(key4, s["acct_rows"], a_log2))

    for serial in (False, True):
        n = 512 if serial else 4096  # 2^14 slots hold 8192 live accounts
        arr = account_batch(types, rng, n, 1_000_000, serial)
        rows = L.accounts_to_batch(arr, dev)["rows"]
        name = "K2 commit_accounts (serial)" if serial else "K2 commit_accounts (fast)"
        kern = K.commit_accounts_serial if serial else K.commit_accounts_fast
        plain = L.commit_accounts_serial_plain if serial else L.commit_accounts_fast_plain
        check(name,
              lambda s: kern(s, rows, n, ts + 10_000, a_log2),
              lambda s: plain(s, rows, n, ts + 10_000, a_log2))
        if serial:
            log(f"    re-probed {K.walk_reprobes('commit_accounts_serial')} of {n} events")

    for pv in (False, True):
        arr = fast_transfer_batch(types, rng, B, pv)
        rows = L.transfers_to_batch(arr, dev)["rows"]
        mask = torch.from_numpy(rng.random(B) < 0.8).to(dev) if pv else None
        check("K3 commit_transfers (fast_pv, masked)" if pv else "K3 commit_transfers (fast)",
              lambda s: K.commit_transfers_fast(s, rows, mask, B, ts + 10_000, a_log2,
                                                t_log2, pv),
              lambda s: L.commit_transfers_fast_plain(s, rows, B, ts + 10_000, a_log2,
                                                      t_log2, pv, mask))

    k3_gates(torch, L, types, K, check, base, rng, ts, a_log2, t_log2)

    n = 512
    arr = serial_transfer_batch(types, rng, n)
    rows = L.transfers_to_batch(arr, dev)["rows"]
    tsv = L.batch_timestamps(ts + 10_000, n, n, dev)
    check("K4 commit_transfers (serial)",
          lambda s: K.commit_transfers_serial(s, rows, tsv, n, a_log2, t_log2),
          lambda s: L.commit_transfers_serial_plain(s, rows, tsv, n, a_log2, t_log2))

    # the fault gates: the overflow backstop, the load-factor guard and the
    # sticky fault must stop both versions the same way, before any write
    arr = transfers(types, [800_001, 800_002], [1, 1], [2, 2], [0, 0], flags=[2, 0])
    arr["amount_hi"] = 1 << 63  # 2^127 pending + 2^127 posted: dp + dpo overflows
    rows = L.transfers_to_batch(arr, dev)["rows"]
    check("K3 commit_transfers (overflow backstop)",
          lambda s: K.commit_transfers_fast(s, rows, None, 2, ts + 20_000, a_log2, t_log2,
                                            False),
          lambda s: L.commit_transfers_fast_plain(s, rows, 2, ts + 20_000, a_log2, t_log2,
                                                  False))
    full = clone_state(base)
    full["xfer_used_slots"].fill_((1 << t_log2) // 2 - 8)
    rows = L.transfers_to_batch(serial_transfer_batch(types, rng, 64), dev)["rows"]
    tsv = L.batch_timestamps(ts + 30_000, 64, 64, dev)
    check("K4 commit_transfers (serial, capacity gate)",
          lambda s: K.commit_transfers_serial(s, rows, tsv, 64, a_log2, t_log2),
          lambda s: L.commit_transfers_serial_plain(s, rows, tsv, 64, a_log2, t_log2),
          start=full)
    # windows with no empty slot: lookups do not resolve; the fast commit
    # faults before writing, the serial scan goes on (state marked corrupt)
    full = exhausted(torch, base, rng, tombs=4000)
    ids = np.concatenate([np.arange(100_001, 104_001), np.arange(8_000_000, 8_000_000 + 4190)])
    key4 = L.ids_to_batch([int(x) for x in ids], dev)["key4"]
    check("K1 lookup (exhausted windows)",
          lambda s: K.lookup(key4, s["xfer_rows"], t_log2),
          lambda s: L.table_lookup_plain(key4, s["xfer_rows"], t_log2), start=full)
    rows = L.transfers_to_batch(fast_transfer_batch(types, rng, B, False), dev)["rows"]
    check("K3 commit_transfers (exhausted windows)",
          lambda s: K.commit_transfers_fast(s, rows, None, B, ts + 50_000, a_log2, t_log2,
                                            False),
          lambda s: L.commit_transfers_fast_plain(s, rows, B, ts + 50_000, a_log2, t_log2,
                                                  False), start=full)
    rows = L.transfers_to_batch(serial_transfer_batch(types, rng, 256), dev)["rows"]
    tsv = L.batch_timestamps(ts + 60_000, 256, 256, dev)
    check("K4 commit_transfers (serial, exhausted windows)",
          lambda s: K.commit_transfers_serial(s, rows, tsv, 256, a_log2, t_log2),
          lambda s: L.commit_transfers_serial_plain(s, rows, tsv, 256, a_log2, t_log2),
          start=full)
    k4_hazards(torch, L, types, K, process, rng, dev)
    faulted = clone_state(base)
    faulted["fault"].fill_(1)
    arr = account_batch(types, rng, 256, 2_000_000, False)
    rows = L.accounts_to_batch(arr, dev)["rows"]
    check("K2 commit_accounts (fast, sticky fault)",
          lambda s: K.commit_accounts_fast(s, rows, 256, ts + 40_000, a_log2),
          lambda s: L.commit_accounts_fast_plain(s, rows, 256, ts + 40_000, a_log2),
          start=faulted)
    account_case_kernels(torch, None, dev)


def k4_hazards(torch, L, types, K, process, rng, dev):
    """K4 (serial_walk.cuh's walk, single-table policy) against its plain
    version on every hazard request of testing/hazards.py on one table, with
    a residue's scattered timestamps, from a state holding their accounts
    whose tombstone-key window is filled: a missing pending read from a
    rollback's tombstone, or from a full window, must set FAULT_SERIAL."""
    from tigerbeetle_tpu_torch.testing import hazards as H

    a_log2, t_log2 = process.account_slots_log2, process.transfer_slots_log2
    led = L.DeviceLedger(process, device="cpu")
    led.execute_dense(types.Operation.create_accounts, 10_000,
                      types.accounts_to_np(H.hazard_accounts()))
    led.check_fault()
    H.fill_tomb_window(led.state["acct_rows"].numpy(), a_log2, rng)
    start = {k: v.to(dev) for k, v in led.state.items()}
    for case in H.CASES:
        arr = types.transfers_to_np(H.hazard_request(case, rng, t_log2, 1))
        n = len(arr)
        rows = L.transfers_to_batch(arr, dev)["rows"]
        tsv = torch.from_numpy((10**12 + np.cumsum(rng.integers(1, 9, n))).astype(np.int64)
                               ).to(dev)
        _, sp = hold(torch, f"K4 commit_transfers serial (hazard {case}, {n} events)", start,
                     lambda s: K.commit_transfers_serial(s, rows, tsv, n, a_log2, t_log2),
                     lambda s: L.commit_transfers_serial_plain(s, rows, tsv, n, a_log2, t_log2))
        want = L.FAULT_SERIAL if case in ("missing_tomb", "missing_full") else 0
        if int(sp["fault"]) != want:
            fail(f"the hazard request {case} gave fault {int(sp['fault'])}, not {want}")


def k3_gates(torch, L, types, K, check, base, rng, ts, a_log2, t_log2):
    """K3, one cluster launch, against its plain version on its gates: the
    capacity guard, the sticky fault, windows with no free slot, claim
    contention, one lane, a slot of 8192 lanes holding 8190 events, and a
    wave mask without fast_pv."""
    from tigerbeetle_tpu_torch.ops import hashtable as ht
    from tigerbeetle_tpu_torch.testing.hazards import shared_window_ids

    def k3(name, arr, n, pv=False, mask=None, start=None):
        rows = L.transfers_to_batch(arr, rows_dev)["rows"]
        t = ts + 70_000
        check(name,
              lambda s: K.commit_transfers_fast(s, rows, mask, n, t, a_log2, t_log2, pv),
              lambda s: L.commit_transfers_fast_plain(s, rows, n, t, a_log2, t_log2, pv, mask),
              start)

    rows_dev = base["acct_rows"].device
    B = 8190
    arr = fast_transfer_batch(types, rng, B, False)
    arr["id_lo"] += 10_000_000
    full = clone_state(base)
    full["xfer_used_slots"].fill_((1 << t_log2) // 2 - 100)
    k3("K3 commit_transfers (capacity guard)", arr, B, start=full)
    faulted = clone_state(base)
    faulted["fault"].fill_(2)
    k3("K3 commit_transfers (sticky fault)", arr, B, start=faulted)
    # no empty slot and no tombstone in any window: no lane wants a slot in
    # round 0, so the claim rounds end there, and the ok lanes of every
    # warp and block report FAULT_CLAIM beside FAULT_PROBE
    k3("K3 commit_transfers (windows with no free slot)", arr, B,
       start=exhausted(torch, base, rng, tombs=0))
    # eight lanes, far apart, whose ids share their first probe position, a
    # free slot: the lowest lane wins it, the others claim on in later rounds
    lanes = [4000, 17, 900, 3, 7000, 2500, 60, 8100]
    start = 30_000_000
    while True:
        group = shared_window_ids(t_log2, 1, len(lanes), start)
        key4 = L.ids_to_batch(group[:1], rows_dev)["key4"]
        if not bool((base["xfer_rows"][ht.hash_key4(key4, t_log2)[0], :4] != 0).any()):
            break
        start += 1 << 18
    arr["id_lo"][lanes] = group
    arr["debit_account_id_lo"][lanes] = 11
    arr["credit_account_id_lo"][lanes] = 12
    arr["amount_lo"][lanes] = 5
    arr["flags"][lanes] = 0
    k3("K3 commit_transfers (claim contention: 8 lanes, one first probe)", arr, B)
    k3("K3 commit_transfers (one lane)", arr[3:4], 1)
    wide = fast_transfer_batch(types, rng, 8192, False)
    wide["id_lo"] += 20_000_000
    k3("K3 commit_transfers (8192 lanes, 8190 events)", wide, B)
    mask = torch.from_numpy(rng.random(8192) < 0.5).to(rows_dev)
    k3("K3 commit_transfers (fast, wave mask)", wide, B, mask=mask)


def plain_batch(types, rng, n, first_id, n_accounts=1999):
    """Fresh transfers between the ledger-2 accounts, a fifth of them
    pending, with failures: zero amounts, ledger mismatches, missing
    debit accounts."""
    dr, cr = random_pairs(rng, n, n_accounts)
    t = transfers(types, np.arange(first_id, first_id + n), dr, cr,
                  rng.integers(1, 1000, n).astype(np.uint64),
                  flags=np.where(rng.random(n) < 0.2, 2, 0).astype(np.uint16))
    t["amount_lo"][::50] = 0  # amount_must_not_be_zero
    t["credit_account_id_lo"][7::50] = 2500  # ledger mismatch
    t["debit_account_id_lo"][13::50] += 1_000_000  # debit_account_not_found
    return t


def group_rows(torch, L, batches, k, dev):
    """Stage batches as the group commit does: [k, n_pad, 32] rows on the
    card (n_pad the next power of two of the largest, at least 8) and the
    per-slot counts; slots past the batches are padding (n = 0)."""
    n_pad = L._next_pow2(max(len(b) for b in batches))
    rows = np.zeros((k, n_pad, 32), dtype=np.int32)
    ns = np.zeros(k, dtype=np.int32)
    for i, b in enumerate(batches):
        rows[i, :len(b)] = L._to_rows_np(b)
        ns[i] = len(b)
    return torch.from_numpy(rows).to(dev), ns


def live_rows(state, table):
    """Host copies of a table's live rows (u32 [m, 32]) and, for
    transfers, their fulfill words."""
    rows = state[f"{table}_rows"][:-1].cpu().numpy().view(np.uint32)
    k4 = rows[:, :4]
    live = ~(k4 == 0).all(axis=1) & ~(k4 == 0xFFFFFFFF).all(axis=1)
    ful = state["fulfill"][:-1].cpu().numpy().view(np.uint32)[live] if table == "xfer" else None
    return rows[live], ful


def phase_seam_kernels(torch, L, types, constants, dev):
    """K5 group commit, K6 fingerprint and K9 install against their plain
    versions on the card at the reduced geometry, on their fault gates:
    a group whose second slot trips the load-factor guard (the later slots
    are no-ops, the fault is sticky), a group with a padding slot, an
    install that finds no free slot (bit 30), and the fingerprint of states
    with tombstones and a dump row of nonzero bytes."""
    from tigerbeetle_tpu_torch import kernels as K

    process = constants.ConfigProcess(account_slots_log2=14, transfer_slots_log2=16)
    a_log2, t_log2 = process.account_slots_log2, process.transfer_slots_log2
    rng = np.random.default_rng(SEED + 6)
    base, ts = seeded_state(L, types, process, rng, dev)

    def group(name, start, batches, k, expect_fault):
        rows, ns = group_rows(torch, L, batches, k, dev)
        tss = [ts + 10_000 * (i + 1) for i in range(k)]
        (flat, summary), sp = hold(
            torch, name, start,
            lambda s: K.group_commit(s, rows, ns, tss, a_log2, t_log2),
            lambda s: L.commit_transfers_group_plain(s, rows, ns, tss, a_log2, t_log2))
        log(f"    summary {summary.cpu().tolist()}")
        if int(summary[-1]) != expect_fault or int(flat[-1]) != expect_fault:
            fail(f"{name}: fault word {int(summary[-1])}, expected {expect_fault}")

    batches = [plain_batch(types, rng, 1000, 900_001 + 10_000 * i) for i in range(4)]
    full = clone_state(base)
    full["xfer_used_slots"].fill_((1 << t_log2) // 2 - 1500)  # slot 1 fits, slot 2 does not
    group("K5 group_commit (4 slots, slot 2 trips the capacity gate)", full, batches, 4,
          L.FAULT_CAPACITY)
    batches = [plain_batch(types, rng, n, 950_001 + 10_000 * i)
               for i, n in enumerate((2000, 1500, 700))]
    group("K5 group_commit (3 items, one padding slot)", base, batches, 4, 0)

    # a restore: the seeded state's live rows into a fresh state, one chunk each
    acct, _ = live_rows(base, "acct")
    xfer, ful = live_rows(base, "xfer")
    fresh = L.init_state(process, dev)
    for table, rows_np, ful_np, log2 in (("acct", acct, None, a_log2),
                                         ("xfer", xfer, ful, t_log2)):
        rows = torch.from_numpy(rows_np.view(np.int32)).to(dev)
        fb = None if ful_np is None else torch.from_numpy(ful_np.view(np.int32)).to(dev)
        _, fresh = hold(torch, f"K9 install_rows ({len(rows_np)} {table} rows, fresh state)",
                        fresh,
                        lambda s: K.install_rows(s, table, rows, fb, len(rows_np), log2),
                        lambda s: L.install_rows_plain(s, table, rows, fb, len(rows_np), log2))
    want = L.state_fingerprint_plain(base).cpu().tolist()
    got = L.state_fingerprint_plain(fresh).cpu().tolist()
    if got[:4] != want[:4]:
        fail(f"the installed rows fingerprint {got[:4]}, the source {want[:4]}")
    # no free slot in any window: every unresolved row sets bit 30
    full = exhausted(torch, base, rng, tombs=4000)
    arr = plain_batch(types, rng, 8192, 990_001)
    rows = L.transfers_to_batch(arr, dev)["rows"]
    fb = torch.from_numpy(rng.integers(0, 3, 8192).astype(np.int32)).to(dev)
    _, sp = hold(torch, "K9 install_rows (8192 rows, exhausted windows)", full,
                 lambda s: K.install_rows(s, "xfer", rows, fb, 8192, t_log2),
                 lambda s: L.install_rows_plain(s, "xfer", rows, fb, 8192, t_log2))
    if not int(sp["fault"]) & L.FAULT_INSTALL:
        fail("an install with no free slot did not set FAULT_INSTALL")

    for name, start in (("tombstones", base), ("exhausted windows", full)):
        st = clone_state(start)
        for table in ("acct_rows", "xfer_rows"):
            st[table][-1] = torch.from_numpy(
                rng.integers(1, 1 << 31, 32).astype(np.int32)).to(dev)
        (fp,), _ = hold(torch, f"K6 fingerprint ({name}, dump rows nonzero)", st,
                        lambda s: K.fingerprint(s["acct_rows"], s["xfer_rows"], s["commit_ts"]),
                        L.state_fingerprint_plain)
        host = [L.fp_rows_np(st[t][:-1].cpu().numpy()) for t in ("acct_rows", "xfer_rows")]
        fp = [v & ((1 << 64) - 1) for v in fp.cpu().tolist()]
        if (host[0][0], host[1][0], host[0][1], host[1][1]) != tuple(fp[:4]):
            fail(f"K6 ({name}) differs from fp_rows_np over the host rows")
        log(f"    live accounts {fp[2]}, transfers {fp[3]}; equal to fp_rows_np on the host")


def k5_cases(torch, L, constants, dev):
    """K5's one launch against its plain version on every case of
    tigerbeetle_tpu_torch/testing/group_cases.py (a reused id, a balance
    limit crossed by the slot before, a probe window the slot before
    filled, padding slots, a slot in which every lane fails, the capacity
    gate tripped by slot 2, a fault word set before the group), at k = 4
    and 16 slots of 64 lanes and of 8192 (where the case's lanes sit in one
    block of the cluster and other blocks apply their rows), at 2^14 /
    2^16 slots; each case must give the codes and fault word it is built
    for."""
    import zlib

    from tigerbeetle_tpu_torch import kernels as K
    from tigerbeetle_tpu_torch.testing import group_cases as G

    process = constants.ConfigProcess(account_slots_log2=14, transfer_slots_log2=16)
    a_log2, t_log2 = process.account_slots_log2, process.transfer_slots_log2
    for n_pad in (64, 8192):
        for k in (4, 16):
            for case in G.CASES:
                rng = np.random.default_rng(SEED + zlib.crc32(f"{case}.{k}.{n_pad}".encode()))
                c = G.group_case(case, k, n_pad, t_log2, rng)
                start = G.base_state(c, process, dev)
                rows = torch.from_numpy(c["rows"]).to(dev)
                (flat, summary), _ = hold(
                    torch, f"K5 group_commit ({case}, {k} x {n_pad})", start,
                    lambda s: K.group_commit(s, rows, c["ns"], c["tss"], a_log2, t_log2),
                    lambda s: L.commit_transfers_group_plain(s, rows, c["ns"], c["tss"], a_log2,
                                                             t_log2))
                codes = flat[:-1].view(k, n_pad).cpu().numpy()
                for slot, lane, code in c["expect"]:
                    got = int(codes[slot, lane])
                    if (got == 0) if code is None else got != code:
                        fail(f"K5 ({case}, {k} x {n_pad}): slot {slot} lane {lane} gave code "
                             f"{got}, the case is built for {code}")
                if int(flat[-1]) != c["fault_after"] or int(summary[-1]) != c["fault_after"]:
                    fail(f"K5 ({case}, {k} x {n_pad}): fault word {int(flat[-1])}, the case is "
                         f"built for {c['fault_after']}")


def fold_compare(torch, L, K, name, flat, n_pad, ns, active, idxs, rng, start=None) -> int:
    """K7 and its plain version from one random chain value (and ring, when
    `idxs` is given), or from `start` = (chain int64, ring int64 numpy or
    None), on the same codes: the chain and every ring entry, the dump slot
    included, must be equal. Returns the largest difference."""
    from tigerbeetle_tpu_torch.models.dual_ledger import APPLY_RING

    dev = flat.device
    if start is None:
        start = (int(rng.integers(-(1 << 63), 1 << 63)),
                 None if idxs is None else rng.integers(-(1 << 63), 1 << 63, APPLY_RING + 1))
    chk0 = torch.tensor(start[0], dtype=torch.int64, device=dev)
    ring0 = None if start[1] is None else torch.from_numpy(start[1]).to(dev)
    ck, cp = chk0.clone(), chk0.clone()
    rk = None if ring0 is None else ring0.clone()
    rp = None if ring0 is None else ring0.clone()
    K.fold(ck, flat, n_pad, ns, active, rk, idxs)
    torch.cuda.synchronize()
    L.fold_codes_plain(cp, flat, n_pad, ns, active, rp, idxs)
    torch.cuda.synchronize()
    err = max_abs_diff(ck, cp)
    if ring0 is not None:
        err = max(err, max_abs_diff(rk, rp))
    log(f"  {name}: max_abs_err={err} chain={int(ck) & ((1 << 64) - 1):#x}")
    if err != 0:
        fail(f"{name} differs from its plain version")
    return err


def fold_codes_np(rng, n):
    """Reply codes with the high bit set in a fifth of the lanes."""
    c = rng.integers(0, 60, n).astype(np.uint32)
    c[rng.random(n) < 0.2] |= np.uint32(0x8000_0000)
    c[rng.random(n) < 0.05] = 0xFFFF_FFFF
    return c


def phase_fold_kernels(torch, L, dev):
    """K7 against its plain version on the card: 16 slots with padding
    slots (n = 0, inactive) and ring slots that collide (the earlier op
    goes to the dump slot), 4 slots with a one-lane slot and no ring, the
    solo forms with and without a ring, on codes with the high bit set."""
    from tigerbeetle_tpu_torch import kernels as K
    from tigerbeetle_tpu_torch.models.dual_ledger import APPLY_RING, _ring_indices

    rng = np.random.default_rng(SEED + 9)

    def flat(k, n_pad):
        return torch.from_numpy(fold_codes_np(rng, k * n_pad + 1).view(np.int32)).to(dev)

    ns = [8190, 1, 0, 8192, 4096, 300, 8190, 7, 8190, 2, 8191] + [0] * 5
    ops = [100 + i for i in range(11)]
    ops[3] = ops[1] + APPLY_RING  # op 3's slot collides with op 1's
    idxs = _ring_indices(ops, 16)
    if idxs[1] != APPLY_RING or list(idxs[11:]) != [APPLY_RING] * 5:
        fail(f"ring indices {idxs.tolist()} do not route to the dump slot")
    active = [True] * 11 + [False] * 5
    fold_compare(torch, L, K, "K7 fold (16 slots, 5 padding, colliding ring slots)",
                 flat(16, 8192), 8192, ns, active, idxs, rng)
    fold_compare(torch, L, K, "K7 fold (4 slots, one of 1 lane, no ring)",
                 flat(4, 8192), 8192, [8190, 1, 8190, 5000], [True] * 4, None, rng)
    fold_compare(torch, L, K, "K7 fold (4 slots, 2 inactive, ring)",
                 flat(4, 1024), 1024, [1024, 17, 0, 0], [True, True, False, False],
                 _ring_indices([APPLY_RING - 1, 5], 4), rng)
    fold_compare(torch, L, K, "K7 fold (solo, 1 lane, ring)", flat(1, 1), 1, [1], [True],
                 [APPLY_RING - 1], rng)
    fold_compare(torch, L, K, "K7 fold (solo, 8190 lanes, no ring)", flat(1, 8190), 8190,
                 [8190], [True], None, rng)
    fold_case_kernels(torch, L, K, dev)


def fold_case_kernels(torch, L, K, dev):
    """K7 against its plain version on every case of
    tigerbeetle_tpu_torch/testing/fold_cases.py (k of 1, 2, 5 and 16, n_pad
    of 1 to 8192, empty, full and inactive slots anywhere, colliding and
    repeated ring indices, the dump slot, chains of 0 and 2^64 - 1), from the
    case's own chain and ring; then the wrapper's argument checks: a slot
    count, a lane count or a ring index out of range raises ValueError and
    launches nothing."""
    import zlib

    from tigerbeetle_tpu_torch.ops.u128 import to_i64
    from tigerbeetle_tpu_torch.testing import fold_cases

    for name in fold_cases.CASES:
        c = fold_cases.fold_case(name, np.random.default_rng(SEED + zlib.crc32(name.encode())))
        flat = torch.from_numpy(c["flat"].view(np.int32)).to(dev)
        ring = None if c["ring"] is None else c["ring"].view(np.int64)
        fold_compare(torch, L, K, f"K7 fold ({name}, k {len(c['ns'])} x {c['n_pad']})", flat,
                     c["n_pad"], c["ns"], c["active"], c["idxs"], None,
                     start=(to_i64(c["chk"]), ring))
        if int(K._kept("fold", dev).abs().sum()):
            fail(f"K7 fold ({name}) left its scratch words nonzero")
    chk = torch.zeros((), dtype=torch.int64, device=dev)
    ring = torch.zeros(16, dtype=torch.int64, device=dev)
    flat = torch.zeros(17 * 8, dtype=torch.int32, device=dev)
    before = K.LAUNCHES["fold"]
    for what, args in (("17 slots", (chk, flat, 8, [8] * 17, [True] * 17)),
                       ("no slot", (chk, flat, 8, [], [])),
                       ("a count past n_pad", (chk, flat, 8, [8, 9], [True, True])),
                       ("a negative count", (chk, flat, 8, [-1], [True])),
                       ("codes past flat", (chk, flat[:15], 8, [8, 8], [True, True])),
                       ("a ring index past the ring", (chk, flat, 8, [8], [True], ring, [16])),
                       ("a negative ring index", (chk, flat, 8, [8], [True], ring, [-1]))):
        try:
            K.fold(*args)
        except ValueError:
            continue
        fail(f"K7 fold with {what} did not raise ValueError")
    torch.cuda.synchronize()
    if K.LAUNCHES["fold"] != before or int(chk) or int(ring.abs().sum()):
        fail("a K7 fold refused for its arguments launched or wrote")
    log(f"  K7 fold: {len(fold_cases.CASES)} cases of testing/fold_cases.py equal; 7 bad "
        "argument sets raise ValueError and launch nothing")


def fp_case_kernels(torch, L, K, dev):
    """K6 against its plain version on every case of
    tigerbeetle_tpu_torch/testing/fp_cases.py (no live row, tombstones, keys
    with one word set or three all ones, empty and tombstone keys over
    nonzero words, live rows only in the first and last slots, a live dump
    row, every slot live, one in 997) at GEOMETRIES_CHIP (2^14 / 2^16 slots,
    counts that are no multiple of a block's rows, an empty account table);
    its kept scratch words must be zero after each call."""
    import zlib

    from tigerbeetle_tpu_torch.ops.u128 import to_i64
    from tigerbeetle_tpu_torch.testing import fp_cases

    for a_slots, x_slots in fp_cases.GEOMETRIES_CHIP:
        for name in fp_cases.CASES:
            rng = np.random.default_rng(SEED + zlib.crc32(f"{name}.{a_slots}.{x_slots}".encode()))
            st = fp_cases.fp_case(name, a_slots, x_slots, rng)
            state = {t: torch.from_numpy(st[t].view(np.int32)).to(dev)
                     for t in ("acct_rows", "xfer_rows")}
            state["commit_ts"] = torch.tensor(to_i64(int(st["commit_ts"])), dtype=torch.int64,
                                              device=dev)
            got = K.fingerprint(state["acct_rows"], state["xfer_rows"], state["commit_ts"])
            torch.cuda.synchronize()
            want = L.state_fingerprint_plain(state)
            err = max_abs_diff(got, want)
            scratch = int(K._kept("fingerprint", dev).abs().sum())
            log(f"  K6 fingerprint ({name}, {a_slots} / {x_slots} slots): max_abs_err={err}, "
                f"live {int(want[2])} / {int(want[3])}")
            if err != 0:
                fail(f"K6 fingerprint ({name}, {a_slots} / {x_slots}) differs from its plain "
                     f"version: {got.tolist()} against {want.tolist()}")
            if scratch:
                fail(f"K6 fingerprint ({name}) left its scratch words nonzero")


def lookup_case_kernels(torch, L, K, dev):
    """K1 and K11l against their plain versions on every case of
    tigerbeetle_tpu_torch/testing/lookup_cases.py (hits at once and after
    tombstones, misses ended by an empty slot after tombstones or at once,
    windows with one tombstone or none, the all-zero and all-ones keys, one
    key in many lanes, a table or one shard with no empty slot) at
    LOG2_CHIP slots (K11l on 1 and on 8 shards of them) and batches of 1,
    33 and 8190 keys: found, rows and resolved of every lane bit-identical,
    and the crafted lanes' answers those their chains are built to give."""
    import zlib

    from tigerbeetle_tpu_torch.parallel import mesh as M
    from tigerbeetle_tpu_torch.testing import lookup_cases as LC

    log2 = LC.LOG2_CHIP
    for S in (0,) + LC.SHARDS:
        name_k = f"K11 mesh_lookup ({S} shard{'s' if S > 1 else ''})" if S else "K1 lookup"
        worst, lanes = 0, 0
        for name in LC.CASES:
            for n in LC.SIZES:
                rng = np.random.default_rng(SEED + zlib.crc32(f"{name}.{n}.{S}".encode()))
                case = LC.lookup_case(name, log2, n, rng, n_shards=S)
                rows = torch.from_numpy(case["rows"].view(np.int32)).to(dev)
                key4 = torch.from_numpy(case["key4"].view(np.int32)).to(dev)
                if S:
                    got = K.mesh_lookup(key4, rows, log2)
                    want = M.lookup_plain(rows, key4, log2)
                else:
                    got = K.lookup(key4, rows, log2)
                    want = L.table_lookup_plain(key4, rows, log2)
                torch.cuda.synchronize()
                errs = [max_abs_diff(a, b) for a, b in zip(got, want)]
                c = case["crafted"]
                found, out, res = (t.cpu().numpy() for t in got)
                crafted = case["rows"].reshape(-1, 32)[case["slot"][c]]
                if S:
                    crafted = np.where(case["found"][c][:, None], crafted, 0)
                ok = (found[c] == case["found"][c]).all() and (
                    res[c] == case["resolved"][c]).all() and (
                    out.view(np.uint32)[c] == crafted).all()
                if max(errs) or not ok:
                    for what, a, b in zip(("found", "rows", "resolved"), got, want):
                        if not torch.equal(a, b):
                            idx = (a != b).nonzero()[:4].tolist()
                            log(f"    {what}: {int((a != b).sum())} differ; at {idx}: kernel "
                                f"{[int(a[tuple(i)]) for i in idx]}, plain "
                                f"{[int(b[tuple(i)]) for i in idx]}")
                    fail(f"{name_k} ({name}, {n} keys) differs from its plain version "
                         f"({errs}) or from its crafted answers ({bool(ok)})")
                worst, lanes = max([worst] + errs), lanes + int(c.sum())
        log(f"  {name_k}: {len(LC.CASES)} cases of testing/lookup_cases.py x {LC.SIZES} keys at "
            f"2^{log2} slots equal, max_abs_err={worst}; {lanes} crafted lanes answer as built")


def mixed_batches(types, rng, n_batches, n):
    """Random traffic over every tier: limit accounts, pendings and their
    posts/voids (earlier and same batch), linked chains, balancing flags,
    duplicate ids and invalid events."""
    Op = types.Operation
    acc = accounts(types, np.arange(1, 401))
    acc["flags"][rng.random(400) < 0.1] = 2  # debits_must_not_exceed_credits
    acc["flags"][100:102] = [1, 0]
    yield Op.create_accounts, acc
    pendings = []
    next_id = 10_000_000
    for _ in range(n_batches):
        dr, cr = random_pairs(rng, n, 400)
        t = transfers(types, np.arange(next_id, next_id + n), dr, cr,
                      rng.integers(1, 200, n).astype(np.uint64))
        next_id += n
        roll = rng.random(n)
        t["flags"][roll < 0.15] = 2  # pending
        pv = (roll >= 0.15) & (roll < 0.25)
        pool = np.array(pendings + list(t["id_lo"][roll < 0.15][:8]), dtype=np.uint64)
        if len(pool):
            t["flags"][pv] = np.where(rng.random(pv.sum()) < 0.5, 4, 8)
            t["pending_id_lo"][pv] = pool[rng.integers(0, len(pool), pv.sum())]
            for f in ("debit_account_id_lo", "credit_account_id_lo", "ledger", "code"):
                t[f][pv] = 0
            t["amount_lo"][pv & (rng.random(n) < 0.5)] = 0
        t["flags"][(roll >= 0.25) & (roll < 0.30)] = rng.choice([16, 32], 1)[0]
        chains = np.nonzero((roll >= 0.30) & (roll < 0.36))[0]
        t["flags"][chains[chains < n - 1]] |= 1
        dups = np.nonzero((roll >= 0.36) & (roll < 0.40))[0]
        t["id_lo"][dups] = t["id_lo"][rng.integers(0, n, len(dups))]
        bad = np.nonzero((roll >= 0.40) & (roll < 0.44))[0]
        t["amount_lo"][bad[::2]] = 0
        t["debit_account_id_lo"][bad[1::2]] = 999_999
        pendings += list(t["id_lo"][t["flags"] == 2])
        yield Op.create_transfers, t


def phase_ledgers(torch, L, types, constants, dev):
    """DeviceLedger on the card against DeviceLedger on the CPU (plain
    versions), batch by batch, on mixed traffic: codes and every leaf."""
    process = constants.ConfigProcess(account_slots_log2=14, transfer_slots_log2=16)
    gpu = L.DeviceLedger(process, device=dev)
    cpu = L.DeviceLedger(process, device="cpu")
    ts = 10**9
    for op, arr in mixed_batches(types, np.random.default_rng(SEED + 3), 8, 512):
        ts += len(arr)
        dg = gpu.execute_dense(op, ts, arr)
        dc = cpu.execute_dense(op, ts, arr)
        if dg != dc:
            fail(f"{op.name}: codes differ between the card and the CPU")
        err = compare_states({k: v.cpu() for k, v in gpu.state.items()}, cpu.state)
        if err:
            fail(f"{op.name}: state differs between the card and the CPU")
    if gpu.hazards.plan_stats != cpu.hazards.plan_stats:
        fail("plans differ")
    log(f"  8 mixed batches of 512: codes and every leaf equal; plans "
        f"{gpu.hazards.plan_stats}")


# ----------------------------------------------------------------------
# phase 3: the main path
# ----------------------------------------------------------------------

N_ACCOUNTS = 10_000
N_REQUESTS = 64
GROUPS, GROUP_K = 4, 16  # the group path: 4 groups of 16 requests of 8190


def main_path_requests(types, rng):
    """The requests of the main path, as (operation, body) pairs."""
    B = 8190
    Op = types.Operation
    reqs = []
    acc = accounts(types, np.arange(1, N_ACCOUNTS + 1))
    acc["flags"][B + 100:B + 102] = [1, 0]  # a linked pair: this request commits serially
    reqs.append(("accounts", Op.create_accounts, acc[:B].tobytes()))
    reqs.append(("accounts", Op.create_accounts, acc[B:].tobytes()))
    # reversed id order (src/benchmark.zig id_order)
    reqs += [("transfers", Op.create_transfers, b)
             for b in benchmark_bodies(types, rng, N_REQUESTS, 1_000_000_000 + N_REQUESTS * B)]
    # two-phase pair: pendings, then posts and voids of every one of them
    pend_ids = np.arange(2_000_000_001, 2_000_000_001 + B)
    dr, cr = random_pairs(rng, B, N_ACCOUNTS)
    pend = transfers(types, pend_ids, dr, cr, rng.integers(1, 1_000_000, B).astype(np.uint64),
                     flags=2)
    reqs.append(("pending", Op.create_transfers, pend.tobytes()))
    res = transfers(types, np.arange(3_000_000_001, 3_000_000_001 + B), 0, 0, 0,
                    ledger=0, code=0, flags=np.where(np.arange(B) % 2, 4, 8),
                    pending_id=pend_ids)
    reqs.append(("resolve", Op.create_transfers, res.tobytes()))
    # linked chains of three, every tenth chain broken by a zero amount
    lk = linked_request(types, rng, np.arange(4_000_000_001, 4_000_000_001 + B), 600)
    reqs.append(("linked", Op.create_transfers, lk.tobytes()))
    return reqs


def benchmark_bodies(types, rng, n, next_id):
    """`n` create_transfers bodies of the benchmark traffic, 8190 events
    each, ids counting down from `next_id`."""
    bodies = []
    for _ in range(n):
        ids = np.arange(next_id, next_id - 8190, -1)
        next_id -= 8190
        dr, cr = random_pairs(rng, 8190, N_ACCOUNTS)
        amt = rng.integers(1, 1_000_000, 8190).astype(np.uint64)
        bodies.append(transfers(types, ids, dr, cr, amt).tobytes())
    return bodies


def prepare_group(sm, Op, bodies, t0=10**12):
    """Prepare each body in turn: [(commit timestamp, body)]."""
    batches = []
    for body in bodies:
        sm.prepare(Op.create_transfers, body)
        batches.append((sm.prepare_timestamp + t0, body))
    return batches


def commit_group(sm, Op, batches):
    """The replica's commit of quorum-ready prepares: one fused group
    (StateMachine.commit_group_async), one drain of the window
    (commit_finish_many), then each reply (commit_finish)."""
    handles = sm.commit_group_async(Op.create_transfers, batches)
    if handles is None:
        fail("the group commit declined a group of plain transfers")
    sm.commit_finish_many(handles)
    return [sm.commit_finish(h) for h in handles]


def run_requests(sm, reqs, Op, t0=10**12):
    """Commit every request through StateMachine, one at a time; returns
    the replies and the seconds each took, reply included."""
    replies = []
    seconds = []
    for _kind, op, body in reqs:
        sm.prepare(op, body)
        ts = sm.prepare_timestamp + t0
        start = time.perf_counter()
        replies.append(sm.commit(op, ts, body))
        seconds.append(time.perf_counter() - start)
    return replies, seconds


def transfer_seconds(reqs, seconds):
    """The seconds of the benchmark traffic's create_transfers requests."""
    return [s for (kind, _o, _b), s in zip(reqs, seconds) if kind == "transfers"]


def phase_main_path(torch, L, SM, types, constants, dev, card):
    from tigerbeetle_tpu_torch import kernels as K

    Op = types.Operation
    rng = np.random.default_rng(SEED + 1)
    reqs = main_path_requests(types, rng)
    group_bodies = benchmark_bodies(types, rng, GROUPS * GROUP_K, 1_500_000_000)
    ledger = L.DeviceLedger(constants.ConfigProcess(), device=dev)
    sm = SM.StateMachine(ledger)
    torch.cuda.synchronize()
    K.reset_launches()
    replies, seconds = run_requests(sm, reqs, Op)
    seconds = transfer_seconds(reqs, seconds)
    group_seconds = []
    for g in range(GROUPS):
        batches = prepare_group(sm, Op, group_bodies[g * GROUP_K:(g + 1) * GROUP_K])
        start = time.perf_counter()
        group_replies = commit_group(sm, Op, batches)
        group_seconds.append(time.perf_counter() - start)
        if any(group_replies):
            fail(f"a request of group {g} failed")
    reqs += [("group", Op.create_transfers, b) for b in group_bodies]
    ids = np.arange(1, N_ACCOUNTS + 1, dtype=np.uint64)
    id_bytes = np.stack([ids, np.zeros_like(ids)], axis=1).tobytes()
    body = b""
    for i in range(0, N_ACCOUNTS, 8190):
        chunk = id_bytes[16 * i:16 * min(i + 8190, N_ACCOUNTS)]
        body += sm.commit(Op.lookup_accounts, 0, chunk)
    ledger.check_fault()
    torch.cuda.synchronize()

    kinds = [k for k, _op, _b in reqs]
    for k, r in zip(kinds, replies):
        if k in ("transfers", "pending", "resolve") and r != b"":
            fail(f"a {k} request failed: {np.frombuffer(r, dtype=np.uint32)[:8]}")
    rows = np.frombuffer(body, dtype=types.ACCOUNT_DTYPE)
    if len(rows) != N_ACCOUNTS:
        fail(f"lookup returned {len(rows)} of {N_ACCOUNTS} accounts")

    def total(col):
        lo = int(rows[col + "_lo"].astype(object).sum())
        return lo + (int(rows[col + "_hi"].astype(object).sum()) << 64)

    # every account's posted balances, from the requests on the host
    want_dr = np.zeros(N_ACCOUNTS + 1, dtype=np.uint64)
    want_cr = np.zeros(N_ACCOUNTS + 1, dtype=np.uint64)

    def post(t, keep):
        amt = t["amount_lo"][keep].astype(np.uint64)
        np.add.at(want_dr, t["debit_account_id_lo"][keep].astype(np.int64), amt)
        np.add.at(want_cr, t["credit_account_id_lo"][keep].astype(np.int64), amt)

    for k, _op, b in reqs:
        if k in ("transfers", "group"):
            t = np.frombuffer(b, dtype=types.TRANSFER_DTYPE)
            post(t, np.ones(len(t), dtype=bool))
    pend = np.frombuffer(reqs[kinds.index("pending")][2], dtype=types.TRANSFER_DTYPE)
    post(pend, np.arange(len(pend)) % 2 == 1)  # the posts, in full
    lk_reply = np.frombuffer(replies[kinds.index("linked")],
                             dtype=types.CREATE_TRANSFERS_RESULT_DTYPE)
    lk = np.frombuffer(reqs[kinds.index("linked")][2], dtype=types.TRANSFER_DTYPE)
    failed = np.zeros(len(lk), dtype=bool)
    failed[lk_reply["index"]] = True
    post(lk, ~failed)
    wrong = np.nonzero((rows["debits_posted_lo"] != want_dr[1:])
                       | (rows["credits_posted_lo"] != want_cr[1:])
                       | (rows["debits_posted_hi"] != 0) | (rows["credits_posted_hi"] != 0)
                       | (rows["debits_pending_lo"] != 0) | (rows["credits_pending_lo"] != 0)
                       | (rows["debits_pending_hi"] != 0) | (rows["credits_pending_hi"] != 0)
                       | (rows["id_lo"] != np.arange(1, N_ACCOUNTS + 1)))[0]
    if len(wrong):
        fail(f"{len(wrong)} accounts hold other balances than the requests give, "
             f"first id {int(rows['id_lo'][wrong[0]])}")
    log(f"  all {N_ACCOUNTS} accounts hold the balances the requests give")
    dpo, cpo = total("debits_posted"), total("credits_posted")
    dp, cp = total("debits_pending"), total("credits_pending")
    expect = sum(
        int(np.frombuffer(b, dtype=types.TRANSFER_DTYPE)["amount_lo"].astype(object).sum())
        for k, _op, b in reqs if k in ("transfers", "group")
    )
    expect += int(pend["amount_lo"][1::2].astype(object).sum())  # posts in full
    expect += int(lk["amount_lo"][~failed].astype(object).sum())
    log(f"  posted debits {dpo} credits {cpo} (expected {expect}); pending {dp} {cp}")
    if not (dpo == cpo == expect and dp == cp == 0):
        fail("debits and credits are not conserved")
    if len(lk_reply) == 0:
        fail("the linked request reported no broken chain")

    # the same two-phase and linked requests on the CPU, plain versions
    cpu = L.DeviceLedger(constants.ConfigProcess(account_slots_log2=15, transfer_slots_log2=16),
                         device="cpu")
    sub = [r for r in reqs if r[0] not in ("transfers", "group")]
    cpu_replies, _ = run_requests(SM.StateMachine(cpu), sub, Op)
    gpu_sub = [rep for (k, _o, _b), rep in zip(reqs, replies) if k != "transfers"]
    if cpu_replies != gpu_sub:
        fail("reply bytes differ from the plain versions on the CPU")
    log(f"  replies of {[r[0] for r in sub]} equal the CPU plain run "
        f"({sum(len(r) for r in gpu_sub)} bytes)")
    total = sum(seconds)
    tps = N_REQUESTS * 8190 / total
    ms = np.array(seconds) * 1e3
    # with 64 samples, the 84th percentile is the highest with 10 beyond it
    log(f"  request latency: median {np.median(ms):.4f} ms, p84 {np.percentile(ms, 84):.4f} ms, "
        f"max {ms.max():.4f} ms ({len(ms)} requests)")
    log(f"  {N_REQUESTS} x 8190 create_transfers in {total:.4f} s: {tps:.0f} transfers/s "
        f"[{card}] (each request committed and drained before the next)")
    g_total = sum(group_seconds)
    g_tps = GROUPS * GROUP_K * 8190 / g_total
    log(f"  group path: {GROUPS} groups of {GROUP_K} x 8190 create_transfers in {g_total:.4f} s: "
        f"{g_tps:.0f} transfers/s, {np.median(group_seconds) * 1e3:.4f} ms median per group "
        f"(each: {', '.join(f'{x * 1e3:.4f}' for x in group_seconds)} ms), "
        f"against {tps:.0f} transfers/s one request at a time [{card}] (commit_group_async, "
        "commit_finish_many and commit_finish; each group drained before the next)")
    log(f"  plan stats: {ledger.hazards.plan_stats}")
    return sm, tps, g_tps, reqs


def phase_snapshot(torch, L, SM, types, constants, dev, sm):
    """The rest of the commit seam on the main path: the fingerprint (K6)
    against its plain version and fp_rows_np over the host rows; a second
    ledger rebuilt by install_snapshot_rows (K9) from the first one's live
    rows must fingerprint and look up the same; one more group committed on
    both must leave them equal."""
    from tigerbeetle_tpu_torch import kernels as K

    Op = types.Operation
    ledger = sm.backend
    fp = ledger.fingerprint()
    plain = [v & ((1 << 64) - 1) for v in L.state_fingerprint_plain(ledger.state).cpu().tolist()]
    if [fp[k] for k in L.FP_KEYS] != plain:
        fail(f"fingerprint {fp} differs from its plain version {plain}")
    acct, _ = live_rows(ledger.state, "acct")
    xfer, ful = live_rows(ledger.state, "xfer")
    host = L.fp_rows_np(acct), L.fp_rows_np(xfer)
    if (fp["accounts_fp"], fp["accounts"]) != host[0] or \
            (fp["transfers_fp"], fp["transfers"]) != host[1]:
        fail("the fingerprint differs from fp_rows_np over the live rows read to the host")
    log(f"  fingerprint {fp}: equal to its plain version and to fp_rows_np on the host")

    second = L.DeviceLedger(constants.ConfigProcess(), device=dev)
    second.reset_state()
    accounts = np.frombuffer(acct.tobytes(), dtype=types.ACCOUNT_DTYPE)
    transfers_np = np.frombuffer(xfer.tobytes(), dtype=types.TRANSFER_DTYPE)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    legs = {}
    t0 = time.perf_counter()
    second.install_snapshot_rows(accounts, transfers_np, ful, ledger.commit_timestamp, legs=legs)
    torch.cuda.synchronize()
    install_s = time.perf_counter() - t0
    n_install = K.LAUNCHES["install_rows"] - launches["install_rows"]
    second.check_fault()
    fp2 = second.fingerprint()
    log(f"  install_snapshot_rows: {len(accounts)} accounts and {len(transfers_np)} transfers "
        f"({int((ful != 0).sum())} posted or voided) in {install_s:.4f} s: upload "
        f"{legs['upload']:.4f} s, install {legs['install']:.4f} s ({n_install} K9 calls), "
        f"host rebuild {legs['rebuild']:.4f} s")
    if n_install != 2:
        fail(f"the restore made {n_install} K9 calls, one a table expected")
    if fp2 != fp:
        fail(f"the installed ledger's fingerprint {fp2} differs from the source's {fp}")
    ids = np.arange(1, N_ACCOUNTS + 1, dtype=np.uint64)
    id_bytes = np.stack([ids, np.zeros_like(ids)], axis=1).tobytes()
    sm2 = SM.StateMachine(second)
    for i in range(0, N_ACCOUNTS, 8190):
        chunk = id_bytes[16 * i:16 * min(i + 8190, N_ACCOUNTS)]
        if sm2.commit(Op.lookup_accounts, 0, chunk) != sm.commit(Op.lookup_accounts, 0, chunk):
            fail("an installed account's lookup differs from the source's")
    log(f"  the installed ledger's fingerprint equals the source's; lookups of all "
        f"{N_ACCOUNTS} accounts equal")

    bodies = benchmark_bodies(types, np.random.default_rng(SEED + 7), GROUP_K, 1_700_000_000)
    batches = prepare_group(sm, Op, bodies)
    second.prepare_timestamp = ledger.prepare_timestamp
    for s in (sm, sm2):
        if any(commit_group(s, Op, batches)):
            fail("a request of the group after the install failed")
    ledger.check_fault()
    second.check_fault()
    fp, fp2 = ledger.fingerprint(), second.fingerprint()
    if fp2 != fp:
        fail(f"after one more group the fingerprints differ: {fp} {fp2}")
    log(f"  one more group of {GROUP_K} x 8190 on both ledgers: fingerprints equal ({fp})")
    del second, sm2
    torch.cuda.empty_cache()
    return bodies


# ----------------------------------------------------------------------
# phase 4: kernels against their plain versions at the main path's shapes
# ----------------------------------------------------------------------


def linked_request(types, rng, ids, n_chain_events):
    """The main path's linked request: chains of three over the first
    `n_chain_events` events, every tenth chain broken by a zero amount."""
    B = len(ids)
    dr, cr = random_pairs(rng, B, N_ACCOUNTS)
    lk = transfers(types, ids, dr, cr, rng.integers(1, 1_000_000, B).astype(np.uint64))
    for c, i in enumerate(range(0, n_chain_events, 3)):
        lk["flags"][i:i + 2] = 1
        if c % 10 == 0:
            lk["amount_lo"][i + 1] = 0
    return lk


def hold_on(torch, errs, name, sk, sp, run_kernel, run_plain, where, plain_ms=None):
    """Run a kernel on `sk` and its plain version on `sp`, two copies of
    one state kept from check to check: their outputs and every leaf must
    be equal. Records errs[name] (and the plain run's time in
    plain_ms[name]); returns the kernel's first output."""
    rk = run_kernel(sk)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rp = run_plain(sp)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    if not isinstance(rk, tuple):
        rk, rp = (rk,), (rp,)
    outs = [max_abs_diff(a, b) for a, b in zip(rk, rp) if a is not None or b is not None]
    err = max(outs + [compare_states(sk, sp)])
    errs[name] = err
    if plain_ms is not None:
        plain_ms[name] = plain_s * 1e3
    what = ""
    if rp[0] is not None and rp[0].dtype == torch.bool:
        what = f" found={int(rp[0].sum())}"
    elif rp[0] is not None and rp[0].dtype == torch.int32:
        c = np.bincount(rp[0].cpu().numpy().astype(np.int64))
        what = f" codes={ {i: int(x) for i, x in enumerate(c) if x} }"
    log(f"  {name}: max_abs_err={err}{what} (plain {plain_s:.1f} s)")
    if err != 0:
        fail(f"{name} differs from its plain version at {where}")
    return rk[0]


def phase_main_shapes(torch, L, types, ledger, dev):
    """Each kernel and its plain version on two copies of the main path's
    state (2^20 / 2^24 slots), on batches of the main path's shapes, in the
    order the main path runs them: lookups of 8190 and 1810 accounts,
    accounts fast (8190) and serial (1810, one linked pair), plain
    transfers, pendings and their posts/voids (8190 each), and the linked
    request's masked wave plus its serial residue. Codes and every state
    leaf must be equal. Returns {check name: max_abs_err}."""
    from tigerbeetle_tpu_torch import kernels as K

    a_log2, t_log2 = ledger.kernels.a_log2, ledger.kernels.t_log2
    sk, sp = clone_state(ledger.state), clone_state(ledger.state)
    rng = np.random.default_rng(SEED + 4)
    errs = {}
    B = 8190

    def check(name, run_kernel, run_plain):
        return hold_on(torch, errs, name, sk, sp, run_kernel, run_plain,
                       "the main path's shape")

    for lo, hi in ((1, B + 1), (B + 1, N_ACCOUNTS + 1)):
        key4 = L.ids_to_batch(list(range(lo, hi)), dev)["key4"]
        check(f"K1 lookup ({hi - lo} accounts)",
              lambda s: K.lookup(key4, s["acct_rows"], a_log2),
              lambda s: L.table_lookup_plain(key4, s["acct_rows"], a_log2))

    ts = 3 * 10**12
    acc = accounts(types, np.arange(20_000_001, 20_000_001 + B + 1810))
    acc["flags"][B + 100:B + 102] = [1, 0]
    for name, arr, kern, plain in (
        ("K2 commit_accounts fast (8190)", acc[:B], K.commit_accounts_fast,
         L.commit_accounts_fast_plain),
        ("K2 commit_accounts serial (1810, one linked pair)", acc[B:],
         K.commit_accounts_serial, L.commit_accounts_serial_plain),
    ):
        rows = L.accounts_to_batch(arr, dev)["rows"]
        n = len(arr)
        ts += n
        check(name, lambda s: kern(s, rows, n, ts, a_log2),
              lambda s: plain(s, rows, n, ts, a_log2))

    def k3(name, arr, pv, mask=None):
        rows = L.transfers_to_batch(arr, dev)["rows"]
        return check(name,
                     lambda s: K.commit_transfers_fast(s, rows, mask, B, ts, a_log2, t_log2, pv),
                     lambda s: L.commit_transfers_fast_plain(s, rows, B, ts, a_log2, t_log2, pv,
                                                             mask))

    def fold_check(name, flat, n_pad, ns, idxs):
        errs[name] = fold_compare(torch, L, K, name, flat, n_pad, ns, [True] * len(ns), idxs,
                                  rng)

    dr, cr = random_pairs(rng, B, N_ACCOUNTS)
    ids = np.arange(7_000_000_000 + B, 7_000_000_000, -1)
    ts += B
    codes = k3("K3 commit_transfers fast (8190 transfers)",
               transfers(types, ids, dr, cr, rng.integers(1, 1_000_000, B).astype(np.uint64)),
               False)
    # the follower's solo fold on a request's packed results (codes, fault)
    fold_check(f"K7 fold (solo, {B} lanes of a K3 request, ring)",
               torch.cat([codes, sk["fault"].reshape(1)]), B, [B], [B % 4096])
    # a group slot's shape: 8192 lanes, 8190 events
    dr, cr = random_pairs(rng, 8192, N_ACCOUNTS)
    ts += B
    slot = L.transfers_to_batch(transfers(types, np.arange(7_050_000_001, 7_050_008_193), dr, cr,
                                          rng.integers(1, 1_000_000, 8192).astype(np.uint64)),
                                dev)["rows"]
    check("K3 commit_transfers fast (8192 lanes, 8190 transfers)",
          lambda s: K.commit_transfers_fast(s, slot, None, B, ts, a_log2, t_log2, False),
          lambda s: L.commit_transfers_fast_plain(s, slot, B, ts, a_log2, t_log2, False))
    pend_ids = np.arange(7_100_000_001, 7_100_000_001 + B)
    dr, cr = random_pairs(rng, B, N_ACCOUNTS)
    ts += B
    k3("K3 commit_transfers fast (8190 pendings)",
       transfers(types, pend_ids, dr, cr, rng.integers(1, 1_000_000, B).astype(np.uint64),
                 flags=2), False)
    ts += B
    k3("K3 commit_transfers fast_pv (8190 posts and voids)",
       transfers(types, np.arange(7_200_000_001, 7_200_000_001 + B), 0, 0, 0, ledger=0,
                 code=0, flags=np.where(np.arange(B) % 2, 4, 8), pending_id=pend_ids), True)

    # the linked request, as DeviceLedger._execute_waves runs it
    lk = linked_request(types, rng, np.arange(7_300_000_001, 7_300_000_001 + B), 600)
    decision, plan = L.HazardTracker().plan(lk)
    if decision != "waves" or plan.residue_n != 600:
        fail(f"the linked request planned as {decision}, not waves with a 600-event residue")
    ts += B
    rows_dev = L.transfers_to_batch(lk, dev)["rows"]
    wave_of = torch.from_numpy(plan.wave_of[:B].astype(np.int64)).to(dev)
    for w in range(plan.n_waves):
        k3(f"K3 commit_transfers fast (linked request, wave {w})", lk, plan.has_pv,
           mask=wave_of == w)
    idx = torch.from_numpy(np.nonzero(plan.wave_of[:B] < 0)[0]).to(dev)
    res_rows = rows_dev[idx].contiguous()
    tsv = L.batch_timestamps(ts, B, B, dev)[idx].contiguous()
    n = len(idx)
    check(f"K4 commit_transfers serial (linked request's residue, {n} events)",
          lambda s: K.commit_transfers_serial(s, res_rows, tsv, n, a_log2, t_log2),
          lambda s: L.commit_transfers_serial_plain(s, res_rows, tsv, n, a_log2, t_log2))
    # the commit seam: a group of 16 requests of 8190, the fingerprint of
    # both tables, one install chunk of 8192 stored rows
    batches = []
    for i in range(GROUP_K):
        dr, cr = random_pairs(rng, B, N_ACCOUNTS)
        first = 7_400_000_001 + B * i
        batches.append(transfers(types, np.arange(first + B, first, -1), dr, cr,
                                 rng.integers(1, 1_000_000, B).astype(np.uint64)))
    g_rows, g_ns = group_rows(torch, L, batches, GROUP_K, dev)
    g_tss = [ts + B * (i + 1) for i in range(GROUP_K)]
    ts += GROUP_K * B
    flat = check(f"K5 group_commit ({GROUP_K} x {B})",
                 lambda s: K.group_commit(s, g_rows, g_ns, g_tss, a_log2, t_log2),
                 lambda s: L.commit_transfers_group_plain(s, g_rows, g_ns, g_tss, a_log2, t_log2))
    n_pad = flat.shape[0] // GROUP_K
    fold_check(f"K7 fold ({GROUP_K} x {n_pad} of a K5 group's results, ring)", flat, n_pad,
               [B] * GROUP_K, list(range(GROUP_K)))
    check("K6 fingerprint (both tables)",
          lambda s: K.fingerprint(s["acct_rows"], s["xfer_rows"], s["commit_ts"]),
          L.state_fingerprint_plain)
    dr, cr = random_pairs(rng, 8192, N_ACCOUNTS)
    arr = transfers(types, np.arange(7_600_000_001, 7_600_000_001 + 8192), dr, cr,
                    rng.integers(1, 1_000_000, 8192).astype(np.uint64))
    arr["timestamp"] = ts + np.arange(1, 8193, dtype=np.uint64)
    i_rows = L.transfers_to_batch(arr, dev)["rows"]
    i_ful = torch.from_numpy(rng.integers(0, 3, 8192).astype(np.int32)).to(dev)
    check("K9 install_rows (8192 rows)",
          lambda s: K.install_rows(s, "xfer", i_rows, i_ful, 8192, t_log2),
          lambda s: L.install_rows_plain(s, "xfer", i_rows, i_ful, 8192, t_log2))
    dr, cr = random_pairs(rng, 3 * 8192 - 77, N_ACCOUNTS)
    arr = transfers(types, np.arange(7_700_000_001, 7_700_000_001 + len(dr)), dr, cr,
                    rng.integers(1, 1_000_000, len(dr)).astype(np.uint64))
    arr["timestamp"] = ts + 8192 + np.arange(1, len(dr) + 1, dtype=np.uint64)
    c_rows = L.transfers_to_batch(arr, dev)["rows"]
    c_ful = torch.from_numpy(rng.integers(0, 3, len(dr)).astype(np.int32)).to(dev)
    check(f"K9 install_rows chunked ({len(dr)} rows in chunks of {INSTALL_CHUNK})",
          lambda s: K.install_rows_chunked(s, "xfer", c_rows, c_ful, t_log2, INSTALL_CHUNK),
          lambda s: L.install_rows_chunked_plain(s, "xfer", c_rows, c_ful, t_log2,
                                                 INSTALL_CHUNK))
    if int(sk["fault"]) != 0:
        fail(f"the main-shape checks faulted: {int(sk['fault'])}")
    del sk, sp
    torch.cuda.empty_cache()
    return errs


# ----------------------------------------------------------------------
# phase 5: a trace of main-path requests
# ----------------------------------------------------------------------


def phase_trace(torch, SM, types, sm, dev, n_requests=16):
    """The busy and idle share of the card over `n_requests` more plain
    create_transfers requests of the main path, from a torch.profiler
    trace (device intervals merged, over the span of the requests), the
    host operators that took the most time in it, and a cProfile of the
    host Python over as many requests again."""
    import cProfile
    import io
    import pstats

    from torch.profiler import ProfilerActivity, profile, record_function

    Op = types.Operation
    rng = np.random.default_rng(SEED + 5)
    next_id = [8_000_000_000]

    def request():
        ids = np.arange(next_id[0] + 8190, next_id[0], -1)
        next_id[0] += 8190
        dr, cr = random_pairs(rng, 8190, N_ACCOUNTS)
        body = transfers(types, ids, dr, cr,
                         rng.integers(1, 1_000_000, 8190).astype(np.uint64)).tobytes()
        sm.prepare(Op.create_transfers, body)
        return body

    def commit(body):
        if sm.commit(Op.create_transfers, sm.prepare_timestamp + 10**12, body) != b"":
            fail("a traced request failed")

    bodies = [request() for _ in range(n_requests)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for body in bodies:
            with record_function("request"):
                commit(body)
        torch.cuda.synchronize()
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "trace")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "main_path.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)
    events = events["traceEvents"] if isinstance(events, dict) else events
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("ph") == "X" and e.get("name") == "request"
             and e.get("cat") == "user_annotation"]
    device = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    if not spans or not device:
        log(f"  trace: {len(spans)} request spans, {len(device)} device events: "
            "busy share not measured")
    else:
        lo, hi = min(a for a, _ in spans), max(b for _, b in spans)
        busy, end = 0.0, lo
        for a, b in device:
            a, b = max(a, end), min(b, hi)
            if b > a:
                busy += b - a
                end = b
        span_ms = (hi - lo) / 1e3
        log(f"  trace of {n_requests} requests: span {span_ms:.4f} ms, device busy "
            f"{busy / 1e3:.4f} ms ({busy / (hi - lo):.4f}), idle {1 - busy / (hi - lo):.4f}; "
            f"{len(device)} device events, {len(device) / n_requests:.1f} per request; "
            f"request {span_ms / n_requests:.4f} ms, device {busy / 1e3 / n_requests:.4f} ms "
            "per request (under the profiler)")
        names = {}
        for e in events:
            if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
                names[e["name"][:60]] = names.get(e["name"][:60], 0.0) + e["dur"]
        for name, us in sorted(names.items(), key=lambda x: -x[1])[:10]:
            log(f"    device {us / 1e3 / n_requests:.4f} ms per request: {name}")
        k3 = sum(1 for e in events if e.get("ph") == "X" and e.get("cat") == "kernel"
                 and "xfer_commit" in e.get("name", ""))
        memsets = sum(1 for e in events if e.get("ph") == "X" and e.get("cat") == "gpu_memset")
        log(f"  K3 kernels in the trace: {k3} for {n_requests} requests; memsets: {memsets}")
        if k3 != n_requests or memsets >= n_requests:
            fail(f"the trace shows {k3} K3 kernels and {memsets} memsets for {n_requests} fast "
                 "requests: want one K3 kernel and no memset a request")
    table = prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=12)
    for line in table.splitlines():
        log("   ", line)

    # one K2 fast call of 8190 new accounts on a copy of the account table
    from tigerbeetle_tpu_torch import kernels as K
    from tigerbeetle_tpu_torch.models import ledger as L

    st = {k: sm.backend.state[k].clone() for k in ACCOUNT_LEAVES}
    rows = L.accounts_to_batch(accounts(types, np.arange(50_000_001, 50_000_001 + 8190)),
                               dev)["rows"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        K.commit_accounts_fast(st, rows, 8190, 10**13, sm.backend.kernels.a_log2)
        torch.cuda.synchronize()
    kernels, memsets = traced_kernels(prof, os.path.join(out_dir, "k2_fast.json"))
    log(f"  a traced K2 fast call (8190 new accounts at 2^20): {kernels}, memsets {memsets}")
    if sum(kernels.values()) != 1 or not all("acct_commit_fast" in k for k in kernels) \
            or memsets:
        fail("a K2 fast call must be one kernel and no memset")
    del st

    bodies = [request() for _ in range(n_requests)]
    torch.cuda.synchronize()
    pr = cProfile.Profile()
    t0 = time.perf_counter()
    pr.enable()
    for body in bodies:
        commit(body)
    torch.cuda.synchronize()
    pr.disable()
    wall = (time.perf_counter() - t0) * 1e3 / n_requests
    buf = io.StringIO()
    pstats.Stats(pr, stream=buf).sort_stats("tottime").print_stats(15)
    log(f"  cProfile of {n_requests} requests: {wall:.4f} ms per request under the profiler")
    for line in buf.getvalue().splitlines():
        if line.strip() and not line.startswith(("   Ordered", "   List")):
            log("   ", line.rstrip())


def traced_kernels(prof, path) -> tuple:
    """({kernel name: count}, memsets) of a torch.profiler run, from its
    chrome trace written to `path`."""
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)
    events = events["traceEvents"] if isinstance(events, dict) else events
    kernels = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "kernel":
            kernels[e["name"]] = kernels.get(e["name"], 0) + 1
    return kernels, sum(1 for e in events if e.get("ph") == "X" and e.get("cat") == "gpu_memset")


# ----------------------------------------------------------------------
# phase 6: times at the main path's shapes, and bounds
# ----------------------------------------------------------------------


def probe_lengths(torch, ht, key4, rows, cap_log2, window):
    """The probes each key needs on this table (int64 [B]): up to the hit
    or the first empty slot."""
    pos = ht.probe_positions(key4, cap_log2, window)
    k4 = rows[pos, :4]
    hit = (k4 == key4.unsqueeze(-2)).all(-1)
    stop = hit | (k4 == 0).all(-1)
    j = torch.arange(window, device=key4.device)
    return torch.where(stop, j, window - 1).amin(-1) + 1


def probe_counts(torch, ht, key4, rows, cap_log2, window):
    """Probes the keys need on this table, summed."""
    return int(probe_lengths(torch, ht, key4, rows, cap_log2, window).sum())


def lookup_bound(lengths, latency_ns):
    """K1's (or K11l's) least time from each key's probe chain (`lengths`,
    probe_lengths or mesh_probe_lengths): the larger of its bytes (each key
    read, a 32-byte key sector a probe past the row it finds, the row read
    and written, two flags written) and its latency (the key, then the
    longest chain's probes: 1 + that many dependent loads at `latency_ns`,
    the pointer chase over the memory level the timed calls read from).
    Returns (ms, "bytes" or "latency", bytes ms, latency ms, longest chain)."""
    B = lengths.shape[0]
    nbytes = B * (16 + 128 + 128 + 2) + (int(lengths.sum()) - B) * 32
    longest = int(lengths.max())
    by_bytes = nbytes / H100_BYTES_PER_S * 1e3
    by_latency = (1 + longest) * latency_ns * 1e-6
    if by_latency > by_bytes:
        return by_latency, "latency", by_bytes, by_latency, longest
    return by_bytes, "bytes", by_bytes, by_latency, longest


def timed(torch, fn, reps, on_card=False):
    """Median and quartiles of `reps` runs of `fn` in ms, by CUDA events.
    With `on_card`, the card is kept busy (torch.cuda._sleep, about half a
    millisecond) while the host enqueues the events and `fn`: the events
    then bracket its launches on the card alone, not the wrapper's host work
    before them."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if on_card:
            torch.cuda._sleep(1 << 20)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return tuple(float(x) for x in np.percentile(times, [50, 25, 75]))


def load_latency_ns(torch, K, dev, nbytes: int, steps: int) -> float:
    """Nanoseconds per dependent load over a random cycle of `nbytes`
    (one thread, the pointer chase of csrc/chase.cu). Each run starts at
    another point of the cycle, so no run finds the lines an earlier one
    pulled into L2 (the buffer itself may be L2-resident when it is small)."""
    n = nbytes // 4
    perm = torch.randperm(n, device=dev)
    nxt = torch.empty(n, dtype=torch.int32, device=dev)
    nxt[perm] = torch.roll(perm, -1).to(torch.int32)
    starts = iter(perm[torch.arange(5, device=dev) * steps].tolist())
    K.chase(nxt, next(starts), steps)
    ms = timed(torch, lambda: K.chase(nxt, next(starts), steps), 4)[0]
    return ms * 1e6 / steps


def shared_latency_ns(torch, K, dev, words: int = 8192, steps=(1 << 14, 1 << 16)) -> float:
    """Nanoseconds per dependent shared-memory load: the chase of
    csrc/chase.cu over a random cycle of `words` words in one block's shared
    memory, the difference of two step counts over their difference (the
    copy into shared memory and the launch cancel)."""
    perm = torch.randperm(words, device=dev)
    nxt = torch.empty(words, dtype=torch.int32, device=dev)
    nxt[perm] = torch.roll(perm, -1).to(torch.int32)
    K.chase_shared(nxt, 0, steps[0])
    ms = [timed(torch, lambda: K.chase_shared(nxt, 0, n), 5)[0] for n in steps]
    return (ms[1] - ms[0]) * 1e6 / (steps[1] - steps[0])


def transfer_bytes(torch, ht, st, rows, a_log2, t_log2, window):
    """The bytes a batch of fresh plain transfers must move: its rows in and
    codes out, one 32-byte sector per probe its ids need in the transfer
    table, its rows written, each distinct account row read and written
    once, and the sectors of account probes past the row they find."""
    keys = torch.cat([rows[:, 4:8], rows[:, 8:12]])
    distinct = torch.unique(keys, dim=0)
    ap = probe_counts(torch, ht, distinct, st["acct_rows"], a_log2, window)
    tp = probe_counts(torch, ht, rows[:, :4].contiguous(), st["xfer_rows"], t_log2, window)
    touched = distinct.shape[0]
    n = rows.shape[0]
    return n * (128 + 4 + 128) + tp * 32 + touched * 2 * 128 + (ap - touched) * 32


def phase_timing(torch, L, ht, types, ledger, dev, latency_ns, l2_ns, smem_ns,
                 sector_ms=None):
    """Each kernel and its plain version at the main path's shapes on the
    main path's state; returns {key: (kernel ms, plain ms, bound ms, bound_by)}
    with medians and quartiles. A bound is bytes over the card's rate. K4
    resolves its lookups ahead of its walk, so its bound is the larger of
    its bytes and one dependent shared-memory round trip an event
    (`smem_ns`): event i may read what event i - 1 wrote. K2 serial's is
    account_walk_bound: only its chain's events and its re-probed ones wait
    for an earlier event (its old bound, a device-memory load an event, and
    the round trip an event are printed beside it). K4 is also
    timed, with no plain run, on an 8190-event serial request (the sharded
    path's serial shape, over pendings K3 commits first)."""
    from tigerbeetle_tpu_torch import kernels as K

    rng = np.random.default_rng(SEED + 2)
    st = ledger.state
    a_log2, t_log2 = ledger.kernels.a_log2, ledger.kernels.t_log2
    out = {}
    B = 8190
    SECTOR = 32

    def bound(nbytes):
        return nbytes / H100_BYTES_PER_S * 1e3, "bytes"

    # K1: lookup of 8190 account ids, bound by its bytes or its longest
    # chain of dependent loads
    key4 = L.ids_to_batch([int(x) for x in rng.integers(1, N_ACCOUNTS + 1, B)], dev)["key4"]
    b = lookup_bound(probe_lengths(torch, ht, key4, st["acct_rows"], a_log2, 32), l2_ns)
    fn = lambda: K.lookup(key4, st["acct_rows"], a_log2)  # noqa: E731
    out["K1"] = (timed(torch, fn, 20),
                 timed(torch, lambda: L.table_lookup_plain(key4, st["acct_rows"], a_log2), 5),
                 *b[:2])
    kc = timed(torch, fn, 20, on_card=True)
    log(f"  K1 ({B} keys): {out['K1'][0][0]:.4f} ms through its wrapper, {kc[0]:.4f} [p25 "
        f"{kc[1]:.4f}, p75 {kc[2]:.4f}] on the card alone; bound {b[0]:.6f} ms ({b[1]}; bytes "
        f"{b[2]:.6f}, 1 + {b[4]} dependent loads {b[3]:.6f})")

    # K2: fresh accounts each run; a fresh id's probe ends at the empty
    # slot its row is written to
    base = [5_000_000]

    def acct_rows(n, linked):
        a = walk_request(types, base[0], n) if linked else accounts(
            types, np.arange(base[0], base[0] + n))
        base[0] += n
        return L.accounts_to_batch(a, dev)["rows"]

    def walk_bound(nbytes, n):
        by_bytes = nbytes / H100_BYTES_PER_S * 1e3
        by_chain = n * smem_ns * 1e-6
        return (by_chain, "latency") if by_chain > by_bytes else (by_bytes, "bytes")

    # the one-cluster floor of K2 fast and K11af: a launch and a cluster
    # barrier for each phase and claim round (4 with no claim, 7 with one
    # contended round after round 0, 10 with all of them)
    floor = {b: timed(torch, lambda: K.cluster_floor(b), 20, on_card=True) for b in (4, 7, 10)}
    log("  the one-cluster floor on the card alone (one launch of 16 x 512 threads): "
        + ", ".join(f"{b} barriers {t[0]:.4f} ms [p25 {t[1]:.4f}, p75 {t[2]:.4f}]"
                    for b, t in floor.items()))
    for key, n, reps, plain_reps, window in (("K2f", B, 10, 3, 32), ("K2s", 1810, 10, 2, 64)):
        serial = key == "K2s"
        batches = [acct_rows(n, serial) for _ in range((1 if serial else 2) * reps + plain_reps)]
        probes = probe_counts(torch, ht, batches[0][:, :4].contiguous(), st["acct_rows"], a_log2,
                              window)
        nbytes = n * (128 + 4 + 128) + probes * SECTOR
        kern = K.commit_accounts_serial if serial else K.commit_accounts_fast
        plain = L.commit_accounts_serial_plain if serial else L.commit_accounts_fast_plain
        it = iter(batches)
        kt = timed(torch, lambda: kern(st, next(it), n, 10**13, a_log2), reps)
        if not serial:
            out[key] = (kt, timed(torch, lambda: plain(st, next(it), n, 10**13, a_log2),
                                  plain_reps), *bound(nbytes))
            kc = timed(torch, lambda: kern(st, next(it), n, 10**13, a_log2), reps, on_card=True)
            log(f"  {key} ({n} new accounts): {kt[0]:.4f} ms through its wrapper, {kc[0]:.4f} "
                f"[p25 {kc[1]:.4f}, p75 {kc[2]:.4f}] on the card alone")
            continue
        # the last timed call's re-probes and the request's chain
        dependent = chain_events(walk_request(types, 1, n)["flags"]) + K.walk_reprobes(
            "commit_accounts_serial")
        pt = timed(torch, lambda: plain(st, next(it), n, 10**13, a_log2), plain_reps)
        out[key] = (kt, pt, *account_walk_bound(nbytes, dependent, smem_ns))
        log(f"  K2s's bound: bytes {nbytes / H100_BYTES_PER_S * 1e3:.6f} ms, {dependent} "
            f"dependent events (chain and re-probed) {dependent * smem_ns * 1e-6:.6f} ms; beside "
            f"it one shared-memory round trip an event {n * smem_ns * 1e-6:.6f} ms and the old "
            f"bound, a device-memory load an event, {n * latency_ns * 1e-6:.6f} ms")

    # K3 on fresh plain transfers; K4 on the linked request's residue: 200
    # chains of three, every tenth broken
    next_id = [6_000_000_000]

    def xfer_rows(n):
        ids = np.arange(next_id[0], next_id[0] + n)
        next_id[0] += n
        if n == B:
            dr, cr = random_pairs(rng, n, N_ACCOUNTS)
            t = transfers(types, ids, dr, cr, rng.integers(1, 1000, n).astype(np.uint64))
        else:
            t = linked_request(types, rng, ids, n)
        return L.transfers_to_batch(t, dev)["rows"]

    batches = [xfer_rows(B) for _ in range(23)]
    nbytes = transfer_bytes(torch, ht, st, batches[0], a_log2, t_log2, 32)
    it = iter(batches)
    kt = timed(torch, lambda: K.commit_transfers_fast(st, next(it), None, B, 10**13, a_log2,
                                                      t_log2, False), 10)
    pt = timed(torch, lambda: L.commit_transfers_fast_plain(st, next(it), B, 10**13, a_log2,
                                                            t_log2, False), 3)
    out["K3"] = (kt, pt, *bound(nbytes))
    kc = timed(torch, lambda: K.commit_transfers_fast(st, next(it), None, B, 10**13, a_log2,
                                                      t_log2, False), 10, on_card=True)
    log(f"  K3 on the card alone: {kc[0]:.4f} ms [p25 {kc[1]:.4f}, p75 {kc[2]:.4f}] (through "
        f"its wrapper {kt[0]:.4f} ms)")

    n = 600
    batches = [xfer_rows(n) for _ in range(12)]
    nbytes = transfer_bytes(torch, ht, st, batches[0], a_log2, t_log2, 64)
    tsv = L.batch_timestamps(10**13, n, n, dev)
    it = iter(batches)
    kt = timed(torch, lambda: K.commit_transfers_serial(st, next(it), tsv, n, a_log2, t_log2),
               10)
    pt = timed(torch, lambda: L.commit_transfers_serial_plain(st, next(it), tsv, n, a_log2,
                                                              t_log2), 2)
    out["K4"] = (kt, pt, *walk_bound(nbytes, n))
    log(f"  K4's old bound, a device-memory load an event (no post/void here): "
        f"{n * latency_ns * 1e-6:.6f} ms; its bytes alone "
        f"{nbytes / H100_BYTES_PER_S * 1e3:.6f} ms; {n} shared-memory round trips "
        f"{n * smem_ns * 1e-6:.6f} ms")
    # K4 on the sharded path's serial request at its size, on this one table
    reqs = []
    for _ in range(10):
        ids = np.arange(next_id[0], next_id[0] + B)
        next_id[0] += B
        dr, cr = random_pairs(rng, B, N_ACCOUNTS)
        pend = transfers(types, ids, dr, cr, rng.integers(1, 1000, B).astype(np.uint64), flags=2)
        K.commit_transfers_fast(st, L.transfers_to_batch(pend, dev)["rows"], None, B, 10**13,
                                a_log2, t_log2, False)
        ids = np.arange(next_id[0], next_id[0] + B)
        next_id[0] += B
        reqs.append(L.transfers_to_batch(serial_request(types, rng, ids, pend)[0], dev)["rows"])
    tsv = L.batch_timestamps(10**13, B, B, dev)
    it = iter(reqs)
    k4_long = timed(torch, lambda: K.commit_transfers_serial(st, next(it), tsv, B, a_log2,
                                                             t_log2), 10)
    log(f"  K4 on a serial request of {B} events on one table (200 linked chains, then "
        f"{B - 600} posts and voids): {k4_long[0]:.4f} ms [p25 {k4_long[1]:.4f}, p75 "
        f"{k4_long[2]:.4f}], bound {B * smem_ns * 1e-6:.6f} ms ({B} shared-memory round trips)")
    del reqs

    # K5: a group of 16 fresh requests of 8190 each run; its bound is the
    # sum of K3's over the slots, each counted on the state before the group
    def fresh_group():
        batches = []
        for _ in range(GROUP_K):
            ids = np.arange(next_id[0], next_id[0] + B)
            next_id[0] += B
            dr, cr = random_pairs(rng, B, N_ACCOUNTS)
            batches.append(transfers(types, ids, dr, cr,
                                     rng.integers(1, 1000, B).astype(np.uint64)))
        return group_rows(torch, L, batches, GROUP_K, dev)

    groups = [fresh_group() for _ in range(14)]
    nbytes = sum(transfer_bytes(torch, ht, st, groups[0][0][i, :B], a_log2, t_log2, 32)
                 for i in range(GROUP_K))
    tss = [10**13] * GROUP_K
    it = iter(groups)
    kt = timed(torch, lambda: K.group_commit(st, *next(it), tss, a_log2, t_log2), 6)
    card_t = timed(torch, lambda: K.group_commit(st, *next(it), tss, a_log2, t_log2), 6,
                   on_card=True)
    pt = timed(torch, lambda: L.commit_transfers_group_plain(st, *next(it), tss, a_log2,
                                                             t_log2), 2)
    out["K5"] = (kt, pt, *bound(nbytes))
    log(f"  K5 on the card alone: {card_t[0]:.4f} ms [p25 {card_t[1]:.4f}, p75 {card_t[2]:.4f}] "
        f"(through its wrapper {kt[0]:.4f}); one device launch a group (the trace of phase 8)")
    del groups

    # K6: every row's key sector decides liveness; a live row's other 96
    # bytes are read too
    fp = K.fingerprint(st["acct_rows"], st["xfer_rows"], st["commit_ts"]).cpu().tolist()
    slots = st["acct_rows"].shape[0] - 1 + st["xfer_rows"].shape[0] - 1
    live = fp[2] + fp[3]
    nbytes = slots * SECTOR + live * 96 + 5 * 8
    fn = lambda: K.fingerprint(st["acct_rows"], st["xfer_rows"], st["commit_ts"])  # noqa: E731
    kt = timed(torch, fn, 20)
    kc = timed(torch, fn, 20, on_card=True)
    pt = timed(torch, lambda: L.state_fingerprint_plain(st), 3)
    out["K6"] = (kt, pt, *bound(nbytes))
    # the card fetches 64 bytes for a sector: a key's half of every row and
    # the other half of a live row, at 3.35 TB/s and at the sector probe's
    # rate for one sector a row (phase 1)
    floor = (slots + live) * 64 / H100_BYTES_PER_S * 1e3
    probe = (slots + live) * sector_ms[1] / (1 << 24) if sector_ms else float("nan")
    log(f"  K6 ({slots} slots, {live} live rows): {kt[0]:.4f} ms [p25 {kt[1]:.4f}, p75 "
        f"{kt[2]:.4f}] through its wrapper, {kc[0]:.4f} [p25 {kc[1]:.4f}, p75 {kc[2]:.4f}] on "
        f"the card alone; bound {out['K6'][2]:.6f} ms (32-byte sectors), 64-byte fetch floor "
        f"{floor:.6f} at 3.35 TB/s and {probe:.6f} at the sector probe's rate; the whole "
        f"tables ({slots * 128} bytes) would take {slots * 128 / H100_BYTES_PER_S * 1e3:.6f} ms")

    # K9: consecutive 8192-row chunks into a fresh table (one chunk a call),
    # then the restore's shape, RESTORE_CHUNKS chunks in one call
    fresh = L.init_state(ledger.process, dev)
    chunks = []
    for _ in range(13):
        ids = np.arange(next_id[0], next_id[0] + 8192)
        next_id[0] += 8192
        dr, cr = random_pairs(rng, 8192, N_ACCOUNTS)
        t = transfers(types, ids, dr, cr, rng.integers(1, 1000, 8192).astype(np.uint64))
        chunks.append((L.transfers_to_batch(t, dev)["rows"],
                       torch.from_numpy(rng.integers(0, 3, 8192).astype(np.int32)).to(dev)))
    probes = probe_counts(torch, ht, chunks[0][0][:, :4].contiguous(), fresh["xfer_rows"],
                          t_log2, 32)
    nbytes = 8192 * 2 * (128 + 4) + probes * SECTOR
    it = iter(chunks)
    kt = timed(torch, lambda: K.install_rows(fresh, "xfer", *next(it), 8192, t_log2), 10)
    pt = timed(torch, lambda: L.install_rows_plain(fresh, "xfer", *next(it), 8192, t_log2), 3)
    b = bound(nbytes)
    log(f"  K9 one chunk of 8192: kernel {kt[0]:.4f} ms [p25 {kt[1]:.4f}, p75 {kt[2]:.4f}], "
        f"plain {pt[0]:.4f} ms, bound {b[0]:.6f} ms ({b[1]})")
    if int(fresh["fault"]):
        fail(f"the timed installs faulted: {int(fresh['fault'])}")
    del chunks
    n_rows = RESTORE_CHUNKS * INSTALL_CHUNK - 100
    ids = np.arange(next_id[0], next_id[0] + n_rows)
    next_id[0] += n_rows
    dr, cr = random_pairs(rng, n_rows, N_ACCOUNTS)
    t = transfers(types, ids, dr, cr, rng.integers(1, 1000, n_rows).astype(np.uint64))
    r_rows = L.transfers_to_batch(t, dev)["rows"]
    r_ful = torch.from_numpy(rng.integers(0, 3, n_rows).astype(np.int32)).to(dev)
    del t

    def timed_restore(fn, reps, on_card=False):
        ts = []
        for _ in range(reps):
            for k in ("xfer_rows", "fulfill", "xfer_count", "xfer_used_slots", "fault"):
                fresh[k].zero_()
            ts.append(timed(torch, lambda: fn(fresh, "xfer", r_rows, r_ful, t_log2,
                                              INSTALL_CHUNK), 1, on_card)[0])
        return tuple(float(x) for x in np.percentile(ts, [50, 25, 75]))

    timed_restore(K.install_rows_chunked, 1)  # warm
    kt = timed_restore(K.install_rows_chunked, 10)
    kc = timed_restore(K.install_rows_chunked, 10, on_card=True)
    if int(fresh["fault"]) or int(fresh["xfer_count"]) != n_rows:
        fail(f"the timed restores faulted ({int(fresh['fault'])}) or placed "
             f"{int(fresh['xfer_count'])} of {n_rows} rows")
    pt = timed_restore(L.install_rows_chunked_plain, 2)
    # each row read and written with its fulfill word, and at least one
    # probe sector and claim word a row
    out["K9"] = (kt, pt, *bound(n_rows * (2 * (128 + 4) + SECTOR + 4)))
    log(f"  K9 a table of {n_rows} rows in {RESTORE_CHUNKS} chunks of {INSTALL_CHUNK} (phase 3's "
        f"restore): kernel {kt[0]:.4f} ms [p25 {kt[1]:.4f}, p75 {kt[2]:.4f}] through its "
        f"wrapper, {kc[0]:.4f} ms on the card alone, plain {pt[0]:.4f} ms, bound "
        f"{out['K9'][2]:.6f} ms; {kt[0] / RESTORE_CHUNKS:.4f} ms a chunk")
    del fresh, r_rows, r_ful
    torch.cuda.empty_cache()

    # K7: the follower's fused fold over a group of 16 requests of 8190
    # (n_pad 8192) with its ring, and its solo fold of one request: each
    # lane's code is read once, the chain read and written, a ring entry
    # written per slot
    from tigerbeetle_tpu_torch.models.dual_ledger import APPLY_RING

    for key, k, n_pad in (("K7", GROUP_K, 8192), ("K7s", 1, B)):
        flat = torch.from_numpy(fold_codes_np(rng, k * n_pad + 1).view(np.int32)).to(dev)
        ns, act, idxs = [B] * k, [True] * k, list(range(k))
        chains = [torch.zeros((), dtype=torch.int64, device=dev) for _ in range(2)]
        rings = [torch.zeros(APPLY_RING + 1, dtype=torch.int64, device=dev) for _ in range(2)]
        fn = lambda: K.fold(chains[0], flat, n_pad, ns, act, rings[0], idxs)  # noqa: E731
        kt = timed(torch, fn, 20)
        kc = timed(torch, fn, 20, on_card=True)
        pt = timed(torch, lambda: L.fold_codes_plain(chains[1], flat, n_pad, ns, act, rings[1],
                                                     idxs), 5)
        out[key] = (kt, pt, *bound(k * B * 4 + k * 8 + 2 * 8))
        log(f"  {key} ({k} x {B} codes with its ring): {kt[0]:.4f} ms [p25 {kt[1]:.4f}, p75 "
            f"{kt[2]:.4f}] through its wrapper, {kc[0]:.4f} [p25 {kc[1]:.4f}, p75 {kc[2]:.4f}] "
            f"on the card alone; bound {out[key][2]:.6f} ms")

    ledger.check_fault()
    host_breakdown(torch, L, types, rng, dev, out["K3"][0][0])
    for k, (kt, pt, b, by) in out.items():
        log(f"  {k}: kernel {kt[0]:.4f} ms [p25 {kt[1]:.4f}, p75 {kt[2]:.4f}], "
            f"plain {pt[0]:.4f} ms [p25 {pt[1]:.4f}, p75 {pt[2]:.4f}], bound {b:.6f} ms ({by})")
    us = [t * 1e3 / (GROUP_K * B) for t in out["K5"][0]]
    log(f"  K5 per transfer: {us[0]:.6f} us [p25 {us[1]:.6f}, p75 {us[2]:.6f}] "
        f"({GROUP_K} x {B} per group)")
    log(f"  K7 is timed on a group of {GROUP_K} x {B} codes (n_pad 8192) with its ring; K7s on "
        f"one request of {B} codes with its ring")
    return out


def host_breakdown(torch, L, types, rng, dev, kernel_ms):
    """Where one 8190-transfer request's time goes outside the kernels:
    the host planner, the 1 MiB upload and the two-word summary read."""
    dr, cr = random_pairs(rng, 8190, N_ACCOUNTS)
    arr = transfers(types, np.arange(9_000_000_000, 9_000_008_190), dr, cr,
                    rng.integers(1, 1000, 8190).astype(np.uint64))

    def host_ms(fn, reps=7):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))

    word = torch.zeros(2, dtype=torch.int32, device=dev)
    plan = host_ms(lambda: L.HazardTracker().plan(arr))
    upload = host_ms(lambda: L.transfers_to_batch(arr, dev))
    read = host_ms(lambda: word.cpu())
    log(f"  one request outside the kernels: plan {plan:.4f} ms, upload {upload:.4f} ms, "
        f"summary read {read:.4f} ms; kernels {kernel_ms:.4f} ms")


# ----------------------------------------------------------------------
# phase 7: the dual-commit follower
# ----------------------------------------------------------------------

DUAL_RUNS = 4  # runs of GROUP_K transfer requests before the restore


def dual_requests(types, rng):
    """The follower's op stream as segments (operation, [arrays], replies
    expected empty); a segment of several transfer requests commits as one
    native group. Returns (the segments before the restore, the two after
    it)."""
    Op = types.Operation
    B = 8190
    acc = accounts(types, np.arange(1, N_ACCOUNTS + 1))
    acc["flags"][B + 100:B + 102] = [1, 0]  # a linked pair: the serial account commit
    before = [(Op.create_accounts, [acc[:B]], True), (Op.create_accounts, [acc[B:]], True)]
    bodies = benchmark_bodies(types, rng, (DUAL_RUNS + 2) * GROUP_K, 2_500_000_000)
    arrs = [np.frombuffer(b, dtype=types.TRANSFER_DTYPE) for b in bodies]
    for r in range(DUAL_RUNS):
        if r:
            # an account request ends the run: the applier commits it alone
            first = N_ACCOUNTS + 1 + 16 * (r - 1)
            before.append((Op.create_accounts, [accounts(types, np.arange(first, first + 16))],
                           True))
        before.append((Op.create_transfers, arrs[r * GROUP_K:(r + 1) * GROUP_K], True))
    pend_ids = np.arange(2_600_000_001, 2_600_000_001 + B)
    dr, cr = random_pairs(rng, B, N_ACCOUNTS)
    pend = transfers(types, pend_ids, dr, cr, rng.integers(1, 1_000_000, B).astype(np.uint64),
                     flags=2)
    res = transfers(types, np.arange(2_700_000_001, 2_700_000_001 + B), 0, 0, 0, ledger=0,
                    code=0, flags=np.where(np.arange(B) % 2, 4, 8), pending_id=pend_ids)
    lk = linked_request(types, rng, np.arange(2_800_000_001, 2_800_000_001 + B), 600)
    before += [(Op.create_transfers, [pend], True), (Op.create_transfers, [res], True),
               (Op.create_transfers, [lk], False)]
    after = [[(Op.create_transfers, arrs[(DUAL_RUNS + r) * GROUP_K:(DUAL_RUNS + r + 1) * GROUP_K],
               True)] for r in range(2)]
    return before, after


def drive_dual(led, Op, segments, op_no: int, follower: bool, lag: list, sampled=False):
    """Commit `segments` through `led` as the replica does: each op is
    prepared and executed by the native engine (a run of 16 transfer
    requests as one native group), its reply built, and then, in op order,
    handed to the follower at commit finalize (apply_commit; a sampled op
    with its trace id and enqueue stamp). `lag` gets the apply lag after
    each op. Returns (the last op number, the time of the first and of the
    last apply_commit)."""
    t_first = t_last = 0.0
    for op, arrs, empty in segments:
        items = []
        for arr in arrs:
            led.prepare(op, len(arr))
            items.append((led.prepare_timestamp, arr))
        if len(items) > 1:
            pendings = led.try_execute_group_async(items)
            if pendings is None:
                fail("the native engine declined a group")
        else:
            pendings = [led.execute_async(op, *items[0])]
        led.drain_many(pendings)
        for (ts, arr), p in zip(items, pendings):
            reply = led.drain_reply(p, op)
            if empty and reply:
                fail(f"op {op_no + 1} ({op.name}) failed: {np.frombuffer(reply, np.uint32)[:8]}")
            op_no += 1
            if follower:
                t_last = time.perf_counter()
                t_first = t_first or t_last
                extra = {"trace": op_no, "lat_ns": time.perf_counter_ns()} if sampled else {}
                led.apply_commit(op_no, op, ts, arr, p.codes, prepare_checksum=op_no, **extra)
                lag.append(led.apply_lag_ops())
    return op_no, t_first, t_last


def dual_trace_share(path, card) -> None:
    """The card's busy share over the applier's trace window: device
    intervals (kernels, copies, memsets) merged over the span of every
    event in the trace."""
    if not os.path.exists(path):
        fail(f"the applier's device trace window wrote no {path}")
    with open(path) as f:
        events = json.load(f)
    events = [e for e in (events["traceEvents"] if isinstance(events, dict) else events)
              if e.get("ph") == "X"]
    device = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    if not device:
        log(f"  applier trace: {len(events)} events, no device events: busy share not measured")
        return
    lo = min(e["ts"] for e in events)
    hi = max(e["ts"] + e["dur"] for e in events)
    busy, end = 0.0, lo
    for a, b in device:
        a = max(a, end)
        if b > a:
            busy += b - a
            end = b
    log(f"  applier trace window: {(hi - lo) / 1e3:.4f} ms, device busy {busy / 1e3:.4f} ms "
        f"({busy / (hi - lo):.4f}), {len(device)} device events [{card}]")


def phase_dual(torch, types, card):
    """The dual-commit follower at the deployment geometry, then the
    corrupted-op check at 2^12 / 2^14. Returns the phase's launches."""
    from tigerbeetle_tpu_torch import kernels as K
    from tigerbeetle_tpu_torch.latency import device_leg_totals
    from tigerbeetle_tpu_torch.metrics import Metrics
    from tigerbeetle_tpu_torch.models.dual_ledger import DualLedger
    from tigerbeetle_tpu_torch.models.native_ledger import NativeLedger
    from tigerbeetle_tpu_torch.tracer import Tracer

    Op = types.Operation
    before, after = dual_requests(types, np.random.default_rng(SEED + 8))
    n_xfer = sum(len(a) for op, arrs, _ in before if op == Op.create_transfers for a in arrs)
    n_ops = sum(len(arrs) for _, arrs, _ in before)

    alone = NativeLedger(20, 24)
    t0 = time.perf_counter()
    drive_dual(alone, Op, before, 0, False, [])
    alone_s = time.perf_counter() - t0
    fp_alone = alone.fingerprint()
    del alone

    t0 = time.perf_counter()
    led = DualLedger(20, 24, follower=True, warm_kernels=True)
    metrics = Metrics()
    led.instrument(metrics, Tracer())
    torch.cuda.synchronize()
    log(f"  DualLedger(20, 24, follower=True, warm_kernels=True): built and warmed in "
        f"{time.perf_counter() - t0:.4f} s")
    torch.cuda.synchronize()
    K.reset_launches()
    lag = []
    t0 = time.perf_counter()
    op_no, t_first, t_last = drive_dual(led, Op, before, 0, True, lag)
    dual_s = time.perf_counter() - t0
    if not led.drain_applier(600):
        fail("the applier did not drain")
    t_drained = time.perf_counter()
    torch.cuda.synchronize()
    t_device = time.perf_counter()
    fp_host = led.fingerprint()
    if fp_host != fp_alone:
        fail(f"the native engine's state differs with the follower running: {fp_host} {fp_alone}")
    led.commitment_probe(op_no, fp_host)
    stats = dict(led.shadow_stats)
    log(f"  {n_ops} ops ({n_xfer} transfers) answered by the native engine in {dual_s:.4f} s with "
        f"the follower running: {n_xfer / dual_s:.0f} transfers/s; alone (NativeLedger(20, 24), "
        f"same requests and groups) {alone_s:.4f} s: {n_xfer / alone_s:.0f} transfers/s; "
        f"ratio {alone_s / dual_s:.4f} [{card}]")
    log(f"  applier: {n_xfer} transfers from the first apply_commit to drain_applier returning in "
        f"{t_drained - t_first:.4f} s: {n_xfer / (t_drained - t_first):.0f} transfers/s; "
        f"to the device done {t_device - t_first:.4f} s; drain after the last op "
        f"{t_drained - t_last:.4f} s; largest apply_lag_ops {max(lag)} [{card}]")
    log(f"  applier work: {stats['groups']} groups, {stats['solo']} solo batches, "
        f"{stats['overlapped']} groups overlapped ({stats['overlapped'] / max(stats['groups'], 1):.4f}); "
        f"stage {stats['stage_s']:.4f} s, idle {stats['idle_s']:.4f} s")

    snap = led.snapshot_bytes()
    t0 = time.perf_counter()
    led.restore_bytes(snap)
    if not led.drain_applier(600):
        fail("the applier did not drain the install")
    torch.cuda.synchronize()
    log(f"  restore: native snapshot of {len(snap)} bytes installed on the card (K9 in the "
        f"applier) in {time.perf_counter() - t0:.4f} s")
    # the applier's device trace window over the first group after the
    # restore; the anatomy samples the second, outside the window (the
    # profiler's own host cost would land in its sub-legs)
    trace_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "trace", "dual")
    led.start_device_trace(trace_dir, window_s=0.0)
    op_no, _, _ = drive_dual(led, Op, after[0], op_no, True, lag)
    if not led.drain_applier(600):
        fail("the applier did not drain the traced group")
    op_no, _, _ = drive_dual(led, Op, after[1], op_no, True, lag, sampled=True)
    report = led.finalize(600)
    torch.cuda.synchronize()
    dual_trace_share(os.path.join(trace_dir, "device_trace.json"), card)
    launches = dict(K.LAUNCHES)
    hl, cm = report.get("hash_log", {}), report.get("commitments", {})
    log(f"  finalize: verified {report['verified']}, hash_log {hl}, commitments {cm}, "
        f"code stream digest {report.get('code_stream_digest')}")
    log(f"  launches in the dual phase: {launches}")
    if report["verified"] is not True:
        fail(f"the follower did not verify: {report}")
    if not (hl.get("ok") and hl.get("ops") == 2 * GROUP_K and cm.get("ok")
            and cm.get("checked") == 1):
        fail(f"hash log or commitments not green: {hl} {cm}")
    for name in ("fold", "group_commit", "commit_transfers_fast", "install_rows", "fingerprint"):
        if not launches[name]:
            fail(f"{name} was not launched in the dual phase: {launches}")
    snap = metrics.snapshot()
    legs = device_leg_totals(snap)
    e2e = snap["histograms"].get("device.apply_e2e_us", {})
    if e2e.get("count") != GROUP_K or legs.get("device_busy", {}).get("count") != GROUP_K:
        fail(f"the applier's anatomy did not sample the {GROUP_K} ops of the last run: {legs}")
    stats = dict(led.shadow_stats)
    log(f"  applier anatomy of the {GROUP_K} sampled ops of the last run, mean us per op: "
        + ", ".join(f"{k} {v['total_us'] / v['count']:.1f}" for k, v in legs.items())
        + f"; e2e {e2e['mean']} us, max {e2e['max']} us; slowest "
        f"{led.device_anatomy.slowest(1)}; the phase uploaded "
        f"{snap['counters']['device.h2d_bytes']} bytes in {stats['groups']} groups and "
        f"{stats['solo']} solo batches [{card}]")
    del led

    bad = DualLedger(12, 14, follower=True)
    bad._test_corrupt_apply_op = 5
    n = np.arange(32)
    segs = [(Op.create_accounts, [accounts(types, np.arange(1, 17))], True)]
    segs += [(Op.create_transfers,
              [transfers(types, 1000 + 32 * g + n, 1 + n % 9, 1 + (n + 1) % 9, 1)], True)
             for g in range(6)]
    drive_dual(bad, Op, segs, 0, True, [])
    report = bad.finalize(600)
    hl = report.get("hash_log", {})
    log(f"  corrupted op 5 at 2^12 / 2^14: verified {report['verified']}, hash_log {hl}")
    if report["verified"] is not False or hl.get("first_divergent_op") != 5:
        fail(f"the corrupted op was not named: {report}")
    return launches


# ----------------------------------------------------------------------
# phase 8: secondary-index queries on the main path's ledger
# ----------------------------------------------------------------------

QUERY_ACCOUNTS = 16


def debit_credit(types, bodies):
    """(ids, effective debit, effective credit) of the create_transfers
    bodies the script sent, in order: a post or void is stored with its
    pending's accounts."""
    arrs = [np.frombuffer(b, dtype=types.TRANSFER_DTYPE) for b in bodies]
    ids = np.concatenate([a["id_lo"] for a in arrs])
    dr = np.concatenate([a["debit_account_id_lo"] for a in arrs])
    cr = np.concatenate([a["credit_account_id_lo"] for a in arrs])
    pid = np.concatenate([a["pending_id_lo"] for a in arrs])
    pv = np.concatenate([(a["flags"] & 12) != 0 for a in arrs])
    if pv.any():
        order = np.argsort(ids)
        at = order[np.searchsorted(ids, pid[pv], sorter=order)]
        dr[pv], cr[pv] = dr[at], cr[at]
    return ids, dr, cr


def expected_query(lookup, ids, side, account):
    """The rows a query for `account` must return: the record's ids with
    that account on `side`, looked up by id, in timestamp order."""
    want = [int(x) for x in ids[side == account]]
    rows = []
    for i in range(0, len(want), 8190):
        rows += lookup(want[i:i + 8190])
    return sorted(rows, key=lambda t: t.timestamp)


def same_rows(a, b) -> bool:
    import dataclasses

    return [dataclasses.asdict(x) for x in a] == [dataclasses.asdict(x) for x in b]


def phase_queries(torch, L, types, ledger, bodies, dev, card, sector_ms):
    """query_transfers / query_accounts on the main path's ledger (2^20 /
    2^24 slots) against the script's own record of what it sent; the
    QUERY_LIMIT and argument errors; K8 bit-identical to its plain version
    on four field shapes of both tables; K8's times beside its bound and
    the sector probe's floor (`sector_ms`, phase 1). Returns (launches,
    {check: max_abs_err}, the K8 timing row)."""
    from tigerbeetle_tpu_torch import kernels as K

    rng = np.random.default_rng(SEED + 9)
    ids, dr, cr = debit_credit(types, bodies)
    chosen = [int(a) for a in rng.choice(np.arange(1, N_ACCOUNTS + 1), QUERY_ACCOUNTS,
                                         replace=False)]
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    results = []
    for a in chosen:
        results.append((a, "debit_account_id", ledger.query_transfers("debit_account_id", a)))
        results.append((a, "credit_account_id", ledger.query_transfers("credit_account_id", a)))
    q_s = time.perf_counter() - t0
    limits = []
    for what, fn in (("accounts", ledger.query_accounts), ("transfers", ledger.query_transfers)):
        try:
            fn("ledger", 2)
        except RuntimeError as e:
            limits.append(f"{what}: {e}")
        else:
            fail(f"query_{what}('ledger', 2) did not raise QUERY_LIMIT")
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    log(f"  {2 * QUERY_ACCOUNTS} transfer queries in {q_s:.4f} s "
        f"({q_s / (2 * QUERY_ACCOUNTS) * 1e3:.4f} ms each, reply read included) [{card}]")
    log(f"  launches on the query path: {launches}")
    if not launches["filter_scan"]:
        fail("the query path did not launch filter_scan")
    n_rows = 0
    for a, field, got in results:
        side = dr if field == "debit_account_id" else cr
        want = expected_query(ledger.lookup_transfers, ids, side, a)
        if not want or not same_rows(got, want):
            fail(f"query_transfers({field!r}, {a}): {len(got)} rows, the record gives {len(want)}")
        n_rows += len(got)
    log(f"  {2 * QUERY_ACCOUNTS} queries equal the record's transfers of {QUERY_ACCOUNTS} "
        f"accounts looked up by id, in timestamp order ({n_rows} rows)")
    log(f"  QUERY_LIMIT raised: {limits}")
    for call, exc in ((lambda: ledger.query_transfers("code", 1 << 16), ValueError),
                      (lambda: ledger.query_accounts("ledger", 1 << 32), ValueError),
                      (lambda: ledger.query_transfers("flags", 1), KeyError)):
        try:
            call()
        except exc:
            pass
        else:
            fail(f"a query with a bad argument did not raise {exc.__name__}")
    log("  out-of-range values raise ValueError, an unindexed field KeyError")

    errs = {}
    st = ledger.state
    a_log2, t_log2 = ledger.kernels.a_log2, ledger.kernels.t_log2
    for table, field, value in (("xfer", "code", 1), ("xfer", "ledger", 2),
                                ("xfer", "user_data_64", 0), ("xfer", "debit_account_id", chosen[0]),
                                ("acct", "code", 1), ("acct", "user_data_128", 0)):
        words = L.ACCOUNT_QUERY_WORDS if table == "acct" else L.TRANSFER_QUERY_WORDS
        spec = words[field]
        log2 = a_log2 if table == "acct" else t_log2
        vw = [(value >> (32 * i)) & 0xFFFFFFFF for i in range(4)]
        rows = st[f"{table}_rows"].clone()
        k_rows, k_total = K.filter_scan(rows, log2, spec, vw)
        torch.cuda.synchronize()
        p_rows, p_total = L.filter_scan_plain(rows, spec, vw)
        err = max(max_abs_diff(k_rows, p_rows), max_abs_diff(k_total, p_total))
        name = f"K8 filter_scan ({table}.{field}, {spec[1]} word{'s' if spec[1] > 1 else ''}" \
               f"{', half-word' if spec[2] else ''}; {int(p_total)} matches)"
        errs[name] = err
        log(f"  {name}: max_abs_err={err}")
        if err:
            fail(f"{name} differs from its plain version")
        del rows

    # timing: the query path's scan of the transfer table (the account id
    # shares the key's sector) and a half-word field in another sector
    SECTOR = 32
    rows = st["xfer_rows"]
    slots = rows.shape[0] - 1
    out = {}
    for field, sectors, mask in (("debit_account_id", 1, 1), ("code", 2, 5)):
        spec = L.TRANSFER_QUERY_WORDS[field]
        vw = [chosen[0] if field == "debit_account_id" else 1, 0, 0, 0]
        kt = timed(torch, lambda: K.filter_scan(rows, t_log2, spec, vw), 20)
        kc = timed(torch, lambda: K.filter_scan(rows, t_log2, spec, vw), 20, on_card=True)
        pt = timed(torch, lambda: L.filter_scan_plain(rows, spec, vw), 3)
        nbytes = slots * sectors * SECTOR + L.QUERY_LIMIT * 128 + 4
        out[field] = (kt, pt, nbytes / H100_BYTES_PER_S * 1e3, "bytes")
        log(f"  K8 ({field}, 2^{t_log2} slots): kernel {kt[0]:.4f} ms [p25 {kt[1]:.4f}, "
            f"p75 {kt[2]:.4f}] through its wrapper, {kc[0]:.4f} ms on the card alone, plain "
            f"{pt[0]:.4f} ms, bound {out[field][2]:.6f} ms ({nbytes} bytes); the sector probe "
            f"reads the same sectors of 2^24 rows in {sector_ms[mask]:.4f} ms [{card}]")
    torch.cuda.empty_cache()
    return launches, errs, out["debit_account_id"]


# ----------------------------------------------------------------------
# K8 and K9 at their edges (testing/scan_cases.py, testing/install_cases.py),
# their device launches from a trace and their times, in a process of its
# own (also run by scan_install_split.py on another checkout)
# ----------------------------------------------------------------------

RESTORE_CHUNKS = 133  # phase 3's restore: about 1.09 M transfer rows in chunks of 8192
INSTALL_CHUNK = 8192


def barriers_invalidate_l1(lib, kernel="group_commit_kernel") -> int:
    """K5's later slots read through L1 what earlier slots wrote from other
    SMs (and K10r's later chunks read what earlier ones wrote); that holds
    because every cluster barrier's wait is followed by an L1 invalidation
    before the next global load. Check it in the SASS of `kernel` in the
    built library (cuobjdump); returns the barriers seen."""
    from tigerbeetle_tpu_torch.kernels import build

    cuobjdump = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    body, inside = [], False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = kernel in line
        elif inside:
            body.append(line)
    if not body:
        fail(f"no {kernel} in the SASS of {lib}")
    waits, pending = 0, False
    for line in body:
        if "UCGABAR_WAIT" in line:
            waits += 1
            pending = True
        elif pending and "CCTL.IVALL" in line:
            pending = False
        elif pending and any(op in line for op in (" LDG", " LD.")):
            fail(f"{kernel}: a load follows a cluster barrier's wait before an L1 "
                 f"invalidation: {line.strip()}")
    if waits == 0:
        fail(f"{kernel}: no cluster barrier found in its SASS")
    return waits


def kernel_resources(lib, needle: str) -> list:
    """[(entry, registers, stack frame bytes, (spill store, spill load
    bytes))] of each kernel whose mangled name holds `needle`, from the
    build's `-Xptxas -v` report beside `lib`."""
    import re

    out, entry = [], None
    for line in (lib.parent / "build.log").read_text().splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            entry = m.group(1) if needle in m.group(1) else None
            frame = None
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if m:
            frame = (int(m.group(1)), (int(m.group(2)), int(m.group(3))))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and frame is not None:
            out.append((entry, int(m.group(1)), *frame))
            entry = None
    if not out:
        fail(f"the build report names no kernel {needle!r}")
    return out


def sector_rates(torch, K, dev, card) -> dict:
    """The card's rate for chosen 32-byte sectors of 2^24 rows of 128 bytes
    (csrc/chase.cu's sector probe, 16 bytes loaded a sector): {mask: ms},
    medians of 10 CUDA-event-timed calls."""
    rows = torch.empty((1 << 24, 32), dtype=torch.int32, device=dev).random_()
    out = {}
    for mask in K.SECTOR_MASKS:
        K.sector_probe(rows, mask)
        t = timed(torch, lambda: K.sector_probe(rows, mask), 10)
        out[mask] = t[0]
        sectors = bin(mask).count("1")
        log(f"  sector probe, sectors {[s for s in range(4) if mask >> s & 1]} of each of 2^24 "
            f"rows of 128 bytes: {t[0]:.4f} ms [p25 {t[1]:.4f}, p75 {t[2]:.4f}], "
            f"{sectors * 32 * (1 << 24) / t[0] / 1e6:.0f} GB/s of those sectors [{card}]")
    log(f"  against one sector a row: two in one 64-byte half x{out[3] / out[1]:.2f}, one in "
        f"each half x{out[5] / out[1]:.2f}, the whole row x{out[15] / out[1]:.2f} [{card}]")
    del rows
    torch.cuda.empty_cache()
    return out


def k8_cases(torch, L, K, dev, errs, log2=24):
    """K8 against its plain version on the tables of testing/scan_cases.py
    at 2^log2 slots, one case a field shape in turn."""
    from tigerbeetle_tpu_torch.testing import scan_cases as SC

    for i, case in enumerate(SC.CASES):
        table, field = SC.FIELDS[i % len(SC.FIELDS)]
        spec = (L.ACCOUNT_QUERY_WORDS if table == "acct" else L.TRANSFER_QUERY_WORDS)[field]
        rng = np.random.default_rng(SEED + 40 + i)
        width = 16 if spec[2] else 32 * spec[1]
        value = int(rng.integers(1, 1 << min(width, 62))) | (1 << (width - 1))
        vw = [(value >> (32 * k)) & 0xFFFFFFFF for k in range(4)]
        rows_np = SC.scan_case(case, log2, spec, vw, rng)
        want = SC.expected_total(rows_np, spec, vw)
        rows = torch.from_numpy(rows_np.view(np.int32)).to(dev)
        del rows_np
        k_rows, k_total = K.filter_scan(rows, log2, spec, vw)
        torch.cuda.synchronize()
        p_rows, p_total = L.filter_scan_plain(rows, spec, vw)
        err = max(max_abs_diff(k_rows, p_rows), max_abs_diff(k_total, p_total))
        name = (f"K8 filter_scan (case {case}, {table}.{field}, 2^{log2} slots; "
                f"{int(p_total)} matches)")
        errs[name] = err
        log(f"  {name}: max_abs_err={err}")
        if err or int(p_total) != want:
            fail(f"{name} differs from its plain version or from the case's {want} matches")
        del rows, k_rows, p_rows
    torch.cuda.empty_cache()


def k9_cases(torch, L, K, constants, dev):
    """K9's one-launch table install against its plain version (chunk by
    chunk) on the restores of testing/install_cases.py: chunks of 64 on the
    test geometry's tables, chunks of 8192 on 2^17 transfer slots."""
    from tigerbeetle_tpu_torch.testing import install_cases as IC

    for chunk, table, log2 in ((64, "xfer", 12), (64, "acct", 10), (INSTALL_CHUNK, "xfer", 17)):
        process = constants.ConfigProcess(account_slots_log2=log2 if table == "acct" else 10,
                                          transfer_slots_log2=log2 if table == "xfer" else 12)
        for i, case in enumerate(IC.CASES):
            c = IC.install_case(case, log2, chunk, table, np.random.default_rng(SEED + 50 + i))
            start = L.init_state(process, dev)
            start[f"{table}_rows"].copy_(torch.from_numpy(c["base"].view(np.int32)))
            rows = torch.from_numpy(c["rows"].view(np.int32)).to(dev)
            ful = None if c["ful"] is None else torch.from_numpy(c["ful"].view(np.int32)).to(dev)
            name = (f"K9 install_rows chunked (case {case}, {len(c['rows'])} {table} rows in "
                    f"chunks of {chunk}, 2^{log2} slots)")
            _, sp = hold(torch, name, start,
                         lambda s: K.install_rows_chunked(s, table, rows, ful, log2, chunk),
                         lambda s: L.install_rows_chunked_plain(s, table, rows, ful, log2, chunk))
            if (int(sp["fault"]) == L.FAULT_INSTALL) != c["fault"]:
                fail(f"{name}: fault word {int(sp['fault'])}, the case expects a fault: "
                     f"{c['fault']}")


def _trace_ranges(path) -> tuple:
    """({annotation: {kernel or memset name: count}}, {annotation: {name:
    summed device us}}) of a chrome trace: each device event under the user
    annotation around the host call that launched it (matched by
    correlation id)."""
    with open(path) as f:
        events = json.load(f)
    events = events["traceEvents"] if isinstance(events, dict) else events
    ranges = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    launch_ts = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "cuda_runtime":
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launch_ts[corr] = e["ts"]
    counts = {name: {} for _a, _b, name in ranges}
    us = {name: {} for _a, _b, name in ranges}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in ("kernel", "gpu_memset"):
            continue
        ts = launch_ts.get(e.get("args", {}).get("correlation"))
        for a, b, name in ranges:
            if ts is not None and a <= ts <= b:
                key = ("memset: " if e["cat"] == "gpu_memset" else "") + e["name"]
                counts[name][key] = counts[name].get(key, 0) + 1
                us[name][key] = us[name].get(key, 0.0) + float(e["dur"])
    return counts, us


def k8_k9_child(reps=20):
    """In a process of its own: K8 on a 2^24 transfer table with about phase
    3's 1.2 M live rows (debit_account_id of one account, about 120
    matches; code 1, all of them) and K9 restoring RESTORE_CHUNKS chunks of
    8192 transfer rows into a fresh 2^24 table, through whatever wrappers
    the checkout on sys.path has (one call a table where it has
    `install_rows_chunked`, else one call a chunk, as its restore does):
    CUDA-event times through the wrapper and on the card alone, the
    wrappers' host time, and the device launches of each call under
    torch.profiler. Prints one JSON line."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from tigerbeetle_tpu_torch import constants
    from tigerbeetle_tpu_torch import kernels as K
    from tigerbeetle_tpu_torch.models import ledger as L

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    log2 = 24
    n = 1 << log2

    def words(*shape):
        return torch.randint(0, 1 << 32, shape, generator=g, device=dev,
                             dtype=torch.int64).to(torch.int32)

    rows = torch.zeros((n + 1, 32), dtype=torch.int32, device=dev)
    u = torch.rand(n, generator=g, device=dev)
    live = (u < 0.072).nonzero().squeeze(1)
    m = live.numel()
    body = words(m, 32)
    body[:, 3] &= 0x7FFFFFFF
    body[:, 4] = torch.randint(1, N_ACCOUNTS + 1, (m,), generator=g, device=dev,
                               dtype=torch.int32)
    body[:, 8] = torch.randint(1, N_ACCOUNTS + 1, (m,), generator=g, device=dev,
                               dtype=torch.int32)
    body[:, 5:8] = 0
    body[:, 9:12] = 0
    body[:, 28] = 2
    body[:, 29] = 1
    rows[live] = body
    rows[((u >= 0.072) & (u < 0.082)).nonzero().squeeze(1), :4] = -1  # tombstones
    del body, u
    queries = {"debit": ((4, 4, False), [17, 0, 0, 0]), "code": ((29, 1, True), [1, 0, 0, 0])}

    n_rows = RESTORE_CHUNKS * INSTALL_CHUNK - 100
    img = words(n_rows, 32)
    img[:, 3] &= 0x7FFFFFFF
    ful = torch.randint(0, 3, (n_rows,), generator=g, device=dev, dtype=torch.int32)
    st = L.init_state(constants.ConfigProcess(account_slots_log2=10, transfer_slots_log2=log2),
                      dev)
    chunked = getattr(K, "install_rows_chunked", None)

    def reset():
        for k in ("xfer_rows", "fulfill", "xfer_count", "xfer_used_slots", "fault"):
            st[k].zero_()

    def restore():
        if chunked is not None:
            chunked(st, "xfer", img, ful, log2, INSTALL_CHUNK)
            return
        for i in range(0, n_rows, INSTALL_CHUNK):
            part = img[i:i + INSTALL_CHUNK]
            K.install_rows(st, "xfer", part, ful[i:i + INSTALL_CHUNK], part.shape[0], log2)

    chunk_at = [0]

    def one_chunk():  # consecutive chunks into the table, as a restore runs
        i = chunk_at[0] % RESTORE_CHUNKS * INSTALL_CHUNK
        chunk_at[0] += 1
        part = img[i:i + INSTALL_CHUNK]
        K.install_rows(st, "xfer", part, ful[i:i + INSTALL_CHUNK], part.shape[0], log2)

    def host_ms(fn, k, before=None):
        """Median host time of fn's call (enqueue only: the card is kept
        busy meanwhile), after `before` each time."""
        ts = []
        for _ in range(k):
            if before is not None:
                before()
            torch.cuda.synchronize()
            torch.cuda._sleep(1 << 26)
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
        return float(np.median(ts))

    def restore_ms(on_card):
        ts = []
        for _ in range(5):
            reset()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            if on_card:
                torch.cuda._sleep(1 << 26)
            start.record()
            restore()
            end.record()
            torch.cuda.synchronize()
            ts.append(start.elapsed_time(end))
        if int(st["fault"]) or int(st["xfer_count"]) != n_rows:
            fail(f"the restore faulted ({int(st['fault'])}) or placed {int(st['xfer_count'])} "
                 f"of {n_rows} rows")
        return float(np.median(ts))

    # warm, then the trace (early in this process)
    for spec, vw in queries.values():
        K.filter_scan(rows, log2, spec, vw)
    reset()
    restore()
    reset()
    torch.cuda.synchronize()
    K.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for name, (spec, vw) in queries.items():
            for k in range(3):
                with record_function(f"k8_{name}_{k}"):
                    K.filter_scan(rows, log2, spec, vw)
        with record_function("k9_restore"):
            restore()
        torch.cuda.synchronize()
    calls = {k: v for k, v in K.LAUNCHES.items() if v}
    out_dir = os.path.join(os.getcwd(), "build", "trace")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "k8_k9.json")
    prof.export_chrome_trace(path)
    trace, split_us = _trace_ranges(path)
    out = {"calls": calls, "chunked": chunked is not None, "restore_rows": n_rows,
           "trace": trace, "split_us": split_us}
    for name, (spec, vw) in queries.items():
        fn = lambda: K.filter_scan(rows, log2, spec, vw)  # noqa: E731
        out[f"k8_{name}_ms"] = timed(torch, fn, reps)[0]
        out[f"k8_{name}_card_ms"] = timed(torch, fn, reps, on_card=True)[0]
        out[f"k8_{name}_host_ms"] = host_ms(fn, reps)
        out[f"k8_{name}_total"] = int(fn()[1])
    out["k9_restore_ms"] = restore_ms(False)
    out["k9_restore_card_ms"] = restore_ms(True)
    reset()
    out["k9_restore_host_ms"] = host_ms(restore, 5, before=reset)
    reset()
    out["k9_chunk_ms"] = timed(torch, one_chunk, reps)[0]
    reset()
    out["k9_chunk_card_ms"] = timed(torch, one_chunk, reps, on_card=True)[0]
    reset()
    out["k9_chunk_host_ms"] = host_ms(one_chunk, reps)
    out["card"] = torch.cuda.get_device_name(0)
    print(json.dumps(out))


def k8_k9_trace(card) -> dict:
    """k8_k9_child in a process of its own (late in this one a profiler
    session recorded no kernels): each K8 call must be one kernel on the
    card and each table install one, with no memset. Returns its JSON."""
    proc = subprocess.run(
        [sys.executable, "-c", "import chip_smoke; chip_smoke.k8_k9_child()"],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True)
    if proc.returncode != 0:
        log(proc.stdout[-3000:], proc.stderr[-3000:])
        fail("the traced K8 and K9 calls failed")
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    for name, kernels in sorted(got["trace"].items()):
        log(f"  trace {name}: {kernels}; device us {got['split_us'][name]}")
    for name in ("debit", "code"):
        log(f"  K8 ({name}, 2^24 slots, {got[f'k8_{name}_total']} matches): "
            f"{got[f'k8_{name}_ms']:.4f} ms through its wrapper, {got[f'k8_{name}_card_ms']:.4f} "
            f"on the card alone, the wrapper's host time {got[f'k8_{name}_host_ms']:.4f} [{card}]")
    log(f"  K9 restore of {got['restore_rows']} rows ({RESTORE_CHUNKS} chunks of "
        f"{INSTALL_CHUNK}) into a fresh 2^24 table: {got['k9_restore_ms']:.4f} ms through the "
        f"wrapper, {got['k9_restore_card_ms']:.4f} on the card alone, host "
        f"{got['k9_restore_host_ms']:.4f}; one chunk {got['k9_chunk_ms']:.4f} / "
        f"{got['k9_chunk_card_ms']:.4f} / host {got['k9_chunk_host_ms']:.4f} [{card}]")
    for name, kernels in got["trace"].items():
        n_k = sum(v for k, v in kernels.items() if not k.startswith("memset"))
        if any(k.startswith("memset") for k in kernels) or n_k != 1:
            fail(f"{name}: {kernels}; one kernel and no memset expected")
    return got


def _trace_device(path) -> dict:
    """{annotation: [(name, start us, duration us), ...]} of a chrome trace:
    each device kernel, memset and memcpy under the user annotation around
    the host call that launched it (matched by correlation id), in start
    order."""
    with open(path) as f:
        events = json.load(f)
    events = events["traceEvents"] if isinstance(events, dict) else events
    ranges = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    launch_ts = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "cuda_runtime":
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launch_ts[corr] = e["ts"]
    out = {name: [] for _a, _b, name in ranges}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in ("kernel", "gpu_memset", "gpu_memcpy"):
            continue
        ts = launch_ts.get(e.get("args", {}).get("correlation"))
        for a, b, name in ranges:
            if ts is not None and a <= ts <= b:
                kind = {"gpu_memset": "memset: ", "gpu_memcpy": "memcpy: "}.get(e["cat"], "")
                out[name].append((kind + e["name"], float(e["ts"]), float(e["dur"])))
    return {name: sorted(v, key=lambda x: x[1]) for name, v in out.items()}


def _device_split(events) -> dict:
    """Counts and summed device us by name, the span from the first start to
    the last end, and the time in it that no event ran (gaps, us)."""
    counts, us = {}, {}
    for name, _t, dur in events:
        counts[name] = counts.get(name, 0) + 1
        us[name] = us.get(name, 0.0) + dur
    span = max(t + d for _n, t, d in events) - events[0][1] if events else 0.0
    busy, end = 0.0, None
    for _n, t, d in events:  # union of the intervals
        if end is None or t >= end:
            busy += d
            end = t + d
        elif t + d > end:
            busy += t + d - end
            end = t + d
    return {"counts": counts, "us": us, "span_us": span, "gap_us": span - busy}


def k5_child(reps=8):
    """In a process of its own: K5 on a DeviceLedger(ConfigProcess())'s state
    with phase 3's 10,000 accounts, groups of 16 fresh requests of 8190
    benchmark transfers, through the `group_commit` wrapper of the checkout
    on sys.path: each group's device kernels under torch.profiler (by name,
    with their device time, the span from the first kernel's start to the
    last one's end and the gaps in it), CUDA-event times through the
    wrapper and on the card alone, and the wrapper's host time. Prints one
    JSON line."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from tigerbeetle_tpu_torch import constants, types
    from tigerbeetle_tpu_torch import kernels as K
    from tigerbeetle_tpu_torch.models import ledger as L

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 30)
    ledger = L.DeviceLedger(constants.ConfigProcess(), device=dev)
    acc = accounts(types, np.arange(1, N_ACCOUNTS + 1))
    for i, chunk in enumerate((acc[:8190], acc[8190:])):
        if any(ledger.execute_dense(types.Operation.create_accounts, 10**12 + i * 10**6, chunk)):
            fail("an account request failed")
    st = ledger.state
    a_log2, t_log2 = ledger.kernels.a_log2, ledger.kernels.t_log2
    B = 8190
    next_id = [10**10]
    ts = [10**13]

    def group():
        """Fresh rows on the card, their counts and timestamps."""
        batches = []
        for _ in range(GROUP_K):
            ids = np.arange(next_id[0], next_id[0] + B)
            next_id[0] += B
            dr, cr = random_pairs(rng, B, N_ACCOUNTS)
            batches.append(transfers(types, ids, dr, cr, rng.integers(1, 1000, B)))
        rows, ns = group_rows(torch, L, batches, GROUP_K, dev)
        tss = [ts[0] + 10**5 * (i + 1) for i in range(GROUP_K)]
        ts[0] += 10**7
        return rows, ns, tss

    def run(g):
        return K.group_commit(st, g[0], g[1], g[2], a_log2, t_log2)

    for _ in range(2):  # warm
        run(group())
    traced = [group() for _ in range(3)]
    torch.cuda.synchronize()
    K.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i, g in enumerate(traced):
            with record_function(f"k5_group_{i}"):
                flat, summary = run(g)
        torch.cuda.synchronize()
    calls = {k: v for k, v in K.LAUNCHES.items() if v}
    if int(summary[-1]) or int(summary[:-1].sum()):
        fail(f"a traced group failed: summary {summary.cpu().tolist()}")
    del traced
    out_dir = os.path.join(os.getcwd(), "build", "trace")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "k5.json")
    prof.export_chrome_trace(path)
    split = {name: _device_split(ev) for name, ev in _trace_device(path).items()}
    out = {"calls": calls, "split": split}

    def timed_groups(on_card):
        times = []
        for _ in range(reps):
            g = group()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            if on_card:
                torch.cuda._sleep(1 << 20)
            start.record()
            run(g)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))

    out["k5_ms"] = timed_groups(False)
    out["k5_card_ms"] = timed_groups(True)
    host = []
    for _ in range(reps):
        g = group()
        torch.cuda.synchronize()
        torch.cuda._sleep(1 << 24)
        t0 = time.perf_counter()
        run(g)
        host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    out["k5_host_ms"] = float(np.median(host))
    if int(st["fault"]):
        fail(f"the timed groups faulted: {int(st['fault'])}")
    out["card"] = torch.cuda.get_device_name(0)
    print(json.dumps(out))


def k5_trace(card) -> dict:
    """k5_child in a process of its own (late in this one a profiler
    session recorded no kernels): each group must be one kernel on the card
    and no memset. Returns its JSON."""
    proc = subprocess.run(
        [sys.executable, "-c", "import chip_smoke; chip_smoke.k5_child()"],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True)
    if proc.returncode != 0:
        log(proc.stdout[-3000:], proc.stderr[-3000:])
        fail("the traced K5 groups failed")
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    for name, sp in sorted(got["split"].items()):
        log(f"  trace {name}: {sp['counts']}; device us {sp['us']}; span {sp['span_us']:.1f} us, "
            f"gaps {sp['gap_us']:.1f} us")
    log(f"  K5 (16 x 8190, phase 3's ledger): {got['k5_ms']:.4f} ms through its wrapper, "
        f"{got['k5_card_ms']:.4f} on the card alone, the wrapper's host time "
        f"{got['k5_host_ms']:.4f} [{card}]")
    for name, sp in got["split"].items():
        if any(not k.startswith("xfer") and not k.startswith("group") for k in sp["counts"]) \
                or sum(sp["counts"].values()) != 1:
            fail(f"{name}: {sp['counts']}; one group_commit kernel and no memset expected")
    return got


# phase 6's live rows (2^20 account / 2^24 transfer slots): the 10,000
# accounts and the 3,786,750 transfers that phases 3-5 leave
DIGEST_LIVE_ACCOUNTS = N_ACCOUNTS
DIGEST_LIVE_SHARE = 0.2257


def digest_state(torch, dev) -> dict:
    """Tables of phase 6's geometry and live rows, made on the card from the
    seed: 2^20 account slots holding 10,000 rows, 2^24 transfer slots about
    22.6% live, a few tombstones in each."""
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 12)
    st = {}
    for table, log2, share in (("acct_rows", 20, None), ("xfer_rows", 24, DIGEST_LIVE_SHARE)):
        n = 1 << log2
        rows = torch.zeros((n + 1, 32), dtype=torch.int32, device=dev)
        if share is None:
            live = torch.randperm(n, generator=g, device=dev)[:DIGEST_LIVE_ACCOUNTS]
        else:
            live = (torch.rand(n, generator=g, device=dev) < share).nonzero().squeeze(1)
        body = torch.randint(-(1 << 31), 1 << 31, (live.numel(), 32), generator=g, device=dev,
                             dtype=torch.int64).to(torch.int32)
        body[:, 0] |= 1
        body[:, 3] &= 0x7FFFFFFF
        rows[live] = body
        tombs = torch.randint(0, n, (1000,), generator=g, device=dev)
        rows[tombs[(rows[tombs, :4] == 0).all(1)], :4] = -1
        st[table] = rows
        del body, live
    st["commit_ts"] = torch.tensor(1_700_000_000_123_456_789, dtype=torch.int64, device=dev)
    return st


def host_ms(torch, fn, reps) -> float:
    """Median host time of fn's call (enqueue only: the card is kept busy
    meanwhile)."""
    ts = []
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(1 << 24)
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    return float(np.median(ts))


def loop_ms(torch, fn, calls=200) -> float:
    """The mean time of `calls` calls back to back, then one wait: the
    host's time a call where it is slower than the card."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / calls


def digest_child(reps=20):
    """In a process of its own: K6 on tables of phase 6's geometry and live
    rows (2^20 account slots with 10,000 live rows, 2^24 transfer slots about
    22.6% live, a few tombstones) and K7 on a group of 16 x 8190 codes
    (n_pad 8192) and on one request of 8190, each with its ring, through
    the `fingerprint` and `fold` wrappers of the checkout on sys.path: each
    call against its plain version once, CUDA-event times through the
    wrapper and on the card alone, the wrapper's host time (one call while
    the card is busy, and the mean of 200 calls back to back, 20 for K6), and under
    torch.profiler the device kernels, memsets and copies of three K6 calls
    and of a K7 call for each k from 1 to 16, with a ring and without.
    Prints one JSON line."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from tigerbeetle_tpu_torch import kernels as K
    from tigerbeetle_tpu_torch.models import ledger as L
    from tigerbeetle_tpu_torch.models.dual_ledger import APPLY_RING

    dev = torch.device("cuda")
    st = digest_state(torch, dev)

    def k6():
        return K.fingerprint(st["acct_rows"], st["xfer_rows"], st["commit_ts"])

    rng = np.random.default_rng(SEED + 12)
    B = 8190
    folds = {}
    for key, k, n_pad in (("k7", GROUP_K, 8192), ("k7s", 1, B)):
        flat = torch.from_numpy(fold_codes_np(rng, k * n_pad + 1).view(np.int32)).to(dev)
        folds[key] = (flat, n_pad, [B] * k, [True] * k, list(range(k)))
    chains = {key: torch.zeros((), dtype=torch.int64, device=dev) for key in folds}
    rings = {key: torch.zeros(APPLY_RING + 1, dtype=torch.int64, device=dev) for key in folds}

    def k7(key):
        flat, n_pad, ns, act, idxs = folds[key]
        K.fold(chains[key], flat, n_pad, ns, act, rings[key], idxs)

    # each against its plain version
    want = L.state_fingerprint_plain(st)
    if not torch.equal(k6(), want):
        fail(f"K6 differs from its plain version: {k6().tolist()} against {want.tolist()}")
    for key, (flat, n_pad, ns, act, idxs) in folds.items():
        ck, rk = torch.full((), 12345, dtype=torch.int64, device=dev), rings[key].clone()
        cp, rp = ck.clone(), rk.clone()
        K.fold(ck, flat, n_pad, ns, act, rk, idxs)
        L.fold_codes_plain(cp, flat, n_pad, ns, act, rp, idxs)
        if not (torch.equal(ck, cp) and torch.equal(rk, rp)):
            fail(f"K7 ({key}) differs from its plain version")

    # the trace: every call after a warm one of its shape
    traced = []
    for k in range(1, GROUP_K + 1):
        flat = torch.from_numpy(fold_codes_np(rng, k * 8192 + 1).view(np.int32)).to(dev)
        ns = [int(x) for x in rng.integers(0, 8193, k)]
        traced.append((k, flat, ns, [bool(x) for x in rng.random(k) < 0.8], list(range(k))))
    chk = torch.zeros((), dtype=torch.int64, device=dev)
    ring = torch.zeros(APPLY_RING + 1, dtype=torch.int64, device=dev)
    k6()
    for k, flat, ns, act, idxs in traced:
        K.fold(chk, flat, 8192, ns, act, ring, idxs)
        K.fold(chk, flat, 8192, ns, act)
    torch.cuda.synchronize()
    K.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(3):
            with record_function(f"k6_{i}"):
                k6()
        for k, flat, ns, act, idxs in traced:
            with record_function(f"k7_{k}_ring"):
                K.fold(chk, flat, 8192, ns, act, ring, idxs)
            with record_function(f"k7_{k}"):
                K.fold(chk, flat, 8192, ns, act)
        torch.cuda.synchronize()
    calls = {k: v for k, v in K.LAUNCHES.items() if v}
    out_dir = os.path.join(os.getcwd(), "build", "trace")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "digest.json")
    prof.export_chrome_trace(path)
    split = {name: _device_split(ev) for name, ev in _trace_device(path).items()}
    out = {"calls": calls, "split": split, "live": [int(want[2]), int(want[3])],
           "slots": [st["acct_rows"].shape[0] - 1, st["xfer_rows"].shape[0] - 1]}

    for key, fn in (("k6", k6), ("k7", lambda: k7("k7")), ("k7s", lambda: k7("k7s"))):
        out[f"{key}_ms"] = timed(torch, fn, reps)
        out[f"{key}_card_ms"] = timed(torch, fn, reps, on_card=True)
        out[f"{key}_host_ms"] = host_ms(torch, fn, reps)
        out[f"{key}_loop_ms"] = loop_ms(torch, fn, 20 if key == "k6" else 200)
    out["card"] = torch.cuda.get_device_name(0)
    print(json.dumps(out))


def digest_trace(card) -> dict:
    """digest_child in a process of its own: each K6 call and each K7 call
    (k from 1 to 16, with a ring and without) must be one kernel on the card,
    with no memset and no copy. Returns its JSON."""
    proc = subprocess.run(
        [sys.executable, "-c", "import chip_smoke; chip_smoke.digest_child()"],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True)
    if proc.returncode != 0:
        log(proc.stdout[-3000:], proc.stderr[-3000:])
        fail("the traced K6 and K7 calls failed")
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    for name, sp in sorted(got["split"].items()):
        log(f"  trace {name}: {sp['counts']}; device us {sp['us']}")
    log(f"  K6 ({got['slots'][0]} / {got['slots'][1]} slots, {got['live'][0]} / {got['live'][1]} "
        f"live): {got['k6_ms'][0]:.4f} ms through its wrapper, {got['k6_card_ms'][0]:.4f} on the "
        f"card alone, the wrapper's host time {got['k6_host_ms']:.4f} (back to back "
        f"{got['k6_loop_ms']:.4f} a call) [{card}]")
    for key, what in (("k7", f"{GROUP_K} x 8190 with its ring"), ("k7s", "one request of 8190")):
        log(f"  K7 ({what}): {got[key + '_ms'][0]:.4f} ms through its wrapper, "
            f"{got[key + '_card_ms'][0]:.4f} on the card alone, the wrapper's host time "
            f"{got[key + '_host_ms']:.4f} (back to back {got[key + '_loop_ms']:.4f} a call) "
            f"[{card}]")
    if len(got["split"]) != 3 + 2 * GROUP_K:
        fail(f"the digest trace holds {len(got['split'])} calls, not {3 + 2 * GROUP_K}")
    for name, sp in got["split"].items():
        if any(k.startswith(("memset", "memcpy")) for k in sp["counts"]) \
                or sum(sp["counts"].values()) != 1:
            fail(f"{name}: {sp['counts']}; one kernel and no memset or copy expected")
    return got


# ----------------------------------------------------------------------
# the lookups (K1, K11l) alone, in a process of their own
# ----------------------------------------------------------------------

# (key, wrapper, shards): K1 on a DeviceLedger, K11l on a ShardedLedger
LOOKUP_KINDS = (("K1", "lookup", 0), ("K11l", "mesh_lookup", 8))
LOOKUP_TRACED = 3  # lookup requests traced for each kind


def lookup_ledger(torch, SM, L, M, types, constants, n_shards, log2, dev):
    """StateMachine over a DeviceLedger (`n_shards` 0) or a ShardedLedger of
    `n_shards` shards, 2^log2 account slots a table holding phase 3's 10,000
    accounts from phase 3's two account requests (the second, with a linked
    pair, on the serial tier); its transfer tables 2^14 slots (a lookup of
    accounts reads none of them)."""
    process = constants.ConfigProcess(account_slots_log2=log2, transfer_slots_log2=14)
    ledger = (M.ShardedLedger(n_shards, process, device=dev) if n_shards
              else L.DeviceLedger(process, device=dev))
    sm = SM.StateMachine(ledger)
    for _kind, op, body in main_path_requests(types, np.random.default_rng(SEED + 1))[:2]:
        sm.prepare(op, body)
        if sm.commit(op, sm.prepare_timestamp + 10**12, body) != b"":
            fail("an account request of the lookup ledger failed")
    return sm, ledger


def lookup_child(reps=20, log2=20):
    """In a process of its own, for K1 and for K11l (8 shards): StateMachine
    over a ledger with 2^log2 account slots a table holding phase 3's 10,000
    accounts (lookup_ledger), and 8190 random ids of them, looked up through
    the wrapper (`lookup`, `mesh_lookup` of the checkout on sys.path): once
    against the plain version (found, rows and resolved), CUDA-event times
    through the wrapper and on the card alone, the wrapper's host time, the
    bound (lookup_bound, at this process's pointer chase over 8 MiB: the
    timed calls repeat the same ids, whose chains sit in L2); then lookup
    requests of those ids through StateMachine.commit, their wall time, and
    under torch.profiler one wrapper call and LOOKUP_TRACED requests, the
    device kernels, memsets and copies of each. Prints one JSON line."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from tigerbeetle_tpu_torch import constants, types
    from tigerbeetle_tpu_torch import kernels as K
    from tigerbeetle_tpu_torch import state_machine as SM
    from tigerbeetle_tpu_torch.models import ledger as L
    from tigerbeetle_tpu_torch.ops import hashtable as ht
    from tigerbeetle_tpu_torch.parallel import mesh as M

    dev = torch.device("cuda")
    Op = types.Operation
    B = 8190
    l2_ns = load_latency_ns(torch, K, dev, 1 << 23, 1 << 15)
    ids = np.random.default_rng(SEED + 15).integers(1, N_ACCOUNTS + 1, B).astype(np.uint64)
    body = np.stack([ids, np.zeros_like(ids)], axis=1).tobytes()
    out = {"card": torch.cuda.get_device_name(0), "l2_ns": l2_ns}
    for key, wrapper, S in LOOKUP_KINDS:
        sm, ledger = lookup_ledger(torch, SM, L, M, types, constants, S, log2, dev)
        rows = ledger.state["acct_rows"]
        key4 = L.ids_to_batch([int(x) for x in ids], dev)["key4"]
        fn = lambda: getattr(K, wrapper)(key4, rows, log2)  # noqa: E731
        got = fn()
        want = (M.lookup_plain(rows, key4, log2) if S else L.table_lookup_plain(key4, rows, log2))
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, want)) or not bool(got[0].all()):
            fail(f"{key} differs from its plain version, or missed an account")
        b = lookup_bound(mesh_probe_lengths(torch, M, ht, key4, rows, log2, 32) if S else
                         probe_lengths(torch, ht, key4, rows, log2, 32), l2_ns)
        reply = sm.commit(Op.lookup_accounts, 0, body)
        if len(reply) != 128 * B:
            fail(f"{key}: a lookup request returned {len(reply) // 128} of {B} accounts")
        req = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if sm.commit(Op.lookup_accounts, 0, body) != reply:
                fail(f"{key}: a lookup request's reply changed")
            req.append((time.perf_counter() - t0) * 1e3)
        out[key] = {
            "ms": timed(torch, fn, reps), "card_ms": timed(torch, fn, reps, on_card=True),
            "host_ms": host_ms(torch, fn, reps), "loop_ms": loop_ms(torch, fn),
            "request_ms": tuple(float(x) for x in np.percentile(req, [50, 25, 75])),
            "bound_ms": b[0], "bound_by": b[1], "bytes_ms": b[2], "latency_ms": b[3],
            "longest": b[4],
        }
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(f"{key}_call"):
                fn()
                torch.cuda.synchronize()
            for i in range(LOOKUP_TRACED):
                with record_function(f"{key}_request_{i}"):
                    sm.commit(Op.lookup_accounts, 0, body)
        out_dir = os.path.join(os.getcwd(), "build", "trace")
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"lookup_{key}.json")
        prof.export_chrome_trace(path)
        out[key]["split"] = {name: _device_split(ev) for name, ev in _trace_device(path).items()}
        del sm, ledger, rows, got, want
        torch.cuda.empty_cache()
    print(json.dumps(out))


def lookup_trace(card) -> dict:
    """lookup_child in a process of its own: each K1 and K11l wrapper call
    must be one kernel with no memset or copy, and each lookup request of
    8190 ids through StateMachine one kernel and one device-to-host copy
    (beside the upload of its keys), with no memset. Returns its JSON."""
    proc = subprocess.run(
        [sys.executable, "-c", "import chip_smoke; chip_smoke.lookup_child()"],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True)
    if proc.returncode != 0:
        log(proc.stdout[-3000:], proc.stderr[-3000:])
        fail("the traced lookups failed")
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    for key, _wrapper, S in LOOKUP_KINDS:
        g = got[key]
        log(f"  {key} (8190 of 10,000 accounts at 2^20 slots{f', {S} shards' if S else ''}): "
            f"{g['ms'][0]:.4f} ms through its wrapper, {g['card_ms'][0]:.4f} [p25 "
            f"{g['card_ms'][1]:.4f}, p75 {g['card_ms'][2]:.4f}] on the card alone, the wrapper's "
            f"host time {g['host_ms']:.4f} (back to back {g['loop_ms']:.4f} a call); a lookup "
            f"request through StateMachine {g['request_ms'][0]:.4f} ms; bound {g['bound_ms']:.6f} "
            f"ms ({g['bound_by']}; bytes {g['bytes_ms']:.6f}, 1 + {g['longest']} dependent loads "
            f"at {got['l2_ns']:.1f} ns {g['latency_ms']:.6f}) [{card}]")
        for name, sp in sorted(g["split"].items()):
            log(f"  trace {name}: {sp['counts']}; device us {sp['us']}")
            kernels = sum(v for k, v in sp["counts"].items() if not k.startswith(("mem",)))
            d2h = sum(v for k, v in sp["counts"].items() if k.startswith("memcpy") and "DtoH" in k)
            memsets = sum(v for k, v in sp["counts"].items() if k.startswith("memset"))
            want_d2h = 0 if name.endswith("_call") else 1
            if kernels != 1 or d2h != want_d2h or memsets:
                fail(f"{name}: {sp['counts']}; one kernel, {want_d2h} device-to-host copy and no "
                     "memset expected")
    return got


# ----------------------------------------------------------------------
# the fast account commits (K2 fast, K11af) alone, in a process of their own
# ----------------------------------------------------------------------

# (key, wrapper, shards): K2 fast on a DeviceLedger, K11af on a ShardedLedger
ACCOUNT_KINDS = (("K2f", "commit_accounts_fast", 0), ("K11af", "mesh_commit_accounts_fast", 8))
ACCOUNT_LEAVES = ("acct_rows", "acct_claim", "acct_used_slots", "acct_count", "commit_ts", "fault")


def accounts_child(reps=10, log2=20):
    """In a process of its own, for K2 fast and for K11af (8 shards):
    StateMachine over a ledger with 2^log2 account slots a table holding
    phase 3's 10,000 accounts (lookup_ledger), and a batch of 8190 new
    accounts committed through the wrapper (`commit_accounts_fast`,
    `mesh_commit_accounts_fast` of the checkout on sys.path), the account
    leaves put back before each call: once against the plain version on a
    copy of the state (codes and every leaf), CUDA-event times through the
    wrapper and on the card alone, the wrapper's host time, the bound (the
    bytes: rows in and out, a code, a sector a probe); then create_accounts
    requests of 8190 new accounts through StateMachine.commit, their wall
    time, and under torch.profiler one wrapper call and one request, the
    device kernels, memsets and copies of each. Prints one JSON line."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from tigerbeetle_tpu_torch import constants, types
    from tigerbeetle_tpu_torch import kernels as K
    from tigerbeetle_tpu_torch import state_machine as SM
    from tigerbeetle_tpu_torch.models import ledger as L
    from tigerbeetle_tpu_torch.ops import hashtable as ht
    from tigerbeetle_tpu_torch.parallel import mesh as M

    dev = torch.device("cuda")
    Op = types.Operation
    B = 8190
    out = {"card": torch.cuda.get_device_name(0)}
    for key, wrapper, S in ACCOUNT_KINDS:
        sm, ledger = lookup_ledger(torch, SM, L, M, types, constants, S, log2, dev)
        st = ledger.state
        kept = {k: st[k].clone() for k in ACCOUNT_LEAVES}

        def reset():
            for k in ACCOUNT_LEAVES:
                st[k].copy_(kept[k])

        arr = accounts(types, np.arange(30_000_001, 30_000_001 + B))
        rows = (torch.from_numpy(M.batch_rows(arr)).to(dev) if S
                else L.accounts_to_batch(arr, dev)["rows"])
        ts = 10**13
        fn = lambda: getattr(K, wrapper)(st, rows, B, ts, log2)  # noqa: E731
        plain = M.commit_accounts_fast_plain if S else L.commit_accounts_fast_plain
        sk, sp = clone_state(st), clone_state(st)
        got = getattr(K, wrapper)(sk, rows, B, ts, log2)
        want = plain(sp, rows, B, ts, log2)
        torch.cuda.synchronize()
        if max_abs_diff(got, want) or compare_states(sk, sp) or int(sp["fault"]) \
                or bool(want.any()):
            fail(f"{key} differs from its plain version, or a new account failed")
        del sk, sp
        probes = (mesh_probe_counts(torch, M, ht, rows[:B, :4].contiguous(), st["acct_rows"],
                                    log2, 32) if S else
                  probe_counts(torch, ht, rows[:, :4].contiguous(), st["acct_rows"], log2, 32))
        nbytes = B * (128 + 4 + 128) + probes * 32

        def reset_timed(on_card):
            times = []
            for _ in range(reps):
                reset()
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                if on_card:
                    torch.cuda._sleep(1 << 20)
                start.record()
                fn()
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end))
            return tuple(float(x) for x in np.percentile(times, [50, 25, 75]))

        host = []
        for _ in range(reps):
            reset()
            torch.cuda.synchronize()
            torch.cuda._sleep(1 << 24)
            t0 = time.perf_counter()
            fn()
            host.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
        out[key] = {"ms": reset_timed(False), "card_ms": reset_timed(True),
                    "host_ms": float(np.median(host)),
                    "bound_ms": nbytes / H100_BYTES_PER_S * 1e3, "bound_by": "bytes"}
        reset()
        next_id = [40_000_001]

        def request():
            body = accounts(types, np.arange(next_id[0], next_id[0] + B)).tobytes()
            next_id[0] += B
            sm.prepare(Op.create_accounts, body)
            return body, sm.prepare_timestamp + 10**12

        req = []
        for _ in range(reps):
            body, ts_req = request()
            before = K.LAUNCHES[wrapper]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if sm.commit(Op.create_accounts, ts_req, body) != b"":
                fail(f"{key}: a create_accounts request failed")
            req.append((time.perf_counter() - t0) * 1e3)
            if K.LAUNCHES[wrapper] != before + 1:
                fail(f"{key}: a create_accounts request of {B} did not take the fast kernel")
        out[key]["request_ms"] = tuple(float(x) for x in np.percentile(req, [50, 25, 75]))
        body, ts_req = request()
        reset()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(f"{key}_call"):
                fn()
                torch.cuda.synchronize()
            with record_function(f"{key}_request"):
                sm.commit(Op.create_accounts, ts_req, body)
                torch.cuda.synchronize()
        out_dir = os.path.join(os.getcwd(), "build", "trace")
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"accounts_{key}.json")
        prof.export_chrome_trace(path)
        out[key]["split"] = {name: _device_split(ev) for name, ev in _trace_device(path).items()}
        ledger.check_fault()
        del sm, ledger, st, kept, rows
        torch.cuda.empty_cache()
    print(json.dumps(out))


# the K10 calls of a cycle whose host time cycle_child takes (t_scan: the
# head and the split; t_gather_d2h: the gather of the cold side; t_rebuild:
# the hot side's gather and the reloads), and its legs: each call's seconds
# and count, and the cold side's copies to the host and the waits on them
CYCLE_CALLS = ("cycle_head", "split_idx", "gather", "reload", "reload_chunks")
CYCLE_LEGS = CYCLE_CALLS + tuple(f"n_{c}" for c in CYCLE_CALLS) + ("copies", "waits")


def cycle_child(cycles=3):
    """In a process of its own: the spill cycle of phase 9's ledger at its
    shape (2^20 transfer slots filled to the load limit with fresh rows, so
    a cycle spills about 393 K rows and keeps about 131 K), through the
    `SpillManager` of the checkout on sys.path, the IO deferred (no worker
    thread). Each cycle's legs are split into the host time in each K10
    call (CYCLE_CALLS: t_scan's head and split, the gathers, t_rebuild's
    reloads), in the cold side's copies' enqueue and in the waits for the
    copies' events; one more cycle under torch.profiler gives the device
    time by kernel and copy, for the whole cycle and for each K10 call, and
    then one K10r call of 8192 rows into the rebuilt table (half of them
    resident), as a batch's reload makes it. Prints one JSON line."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from tigerbeetle_tpu_torch import constants
    from tigerbeetle_tpu_torch import kernels as K
    from tigerbeetle_tpu_torch.io.storage import MemoryStorage, ZoneLayout
    from tigerbeetle_tpu_torch.lsm.grid import BLOCK_SIZE, Grid
    from tigerbeetle_tpu_torch.lsm.groove import Forest
    from tigerbeetle_tpu_torch.models import ledger as L

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 31)
    process = constants.ConfigProcess(account_slots_log2=10, transfer_slots_log2=SPILL_LOG2)
    layout = ZoneLayout(constants.TEST_CLUSTER, grid_size=(GRID_BLOCKS + 64) * BLOCK_SIZE)
    forest = Forest(Grid(MemoryStorage(layout), offset=0, block_count=GRID_BLOCKS),
                    memtable_max=8192)
    ledger = L.DeviceLedger(process, device=dev, forest=forest, spill_io="deferred")
    spill, st = ledger.spill, ledger.state
    n_live = ledger._xfer_limit - 64
    next_id = [1 << 40]

    def fill():
        """A fresh table of n_live rows with new ids and rising timestamps."""
        for k in ("xfer_rows", "fulfill", "xfer_count", "xfer_used_slots"):
            st[k].zero_()
        img = torch.randint(0, 1 << 31, (n_live, 32), generator=g, device=dev,
                            dtype=torch.int64).to(torch.int32)
        def words(x):  # the low and high 32-bit words of int64 values, as int32 bits
            lo = x & 0xFFFFFFFF
            return (torch.where(lo >= 1 << 31, lo - (1 << 32), lo).to(torch.int32),
                    (x >> 32).to(torch.int32))

        ids = torch.arange(next_id[0], next_id[0] + n_live, device=dev, dtype=torch.int64)
        next_id[0] += n_live
        img[:, 0], img[:, 1] = words(ids)
        img[:, 2:4] = 0
        img[:, 30], img[:, 31] = words(ids + (1 << 41))  # rising timestamps
        ful = torch.randint(0, 3, (n_live,), generator=g, device=dev, dtype=torch.int32)
        K.install_rows_chunked(st, "xfer", img, ful, SPILL_LOG2, INSTALL_CHUNK)
        if int(st["fault"]) or int(st["xfer_count"]) != n_live:
            fail(f"the fill faulted ({int(st['fault'])}) or placed {int(st['xfer_count'])}")
        ledger._xfer_used = n_live
        torch.cuda.synchronize()

    def one_chunk():
        """8192 stored rows for one reload into the rebuilt table: 4096 of its
        own (resident, skipped) and 4096 with new ids."""
        half = 4096
        live = torch.nonzero((st["xfer_rows"][:-1, :4] != 0).any(1)).squeeze(1)[:half]
        rows_b = torch.cat([st["xfer_rows"][live], st["xfer_rows"][live]])
        ful_b = torch.cat([st["fulfill"][live], st["fulfill"][live]])
        rows_b[half:, 0] = torch.arange(1, half + 1, device=dev, dtype=torch.int32)
        rows_b[half:, 1:4] = 0x5A5A5A5A
        return rows_b, ful_b, torch.ones(2 * half, dtype=torch.bool, device=dev)

    legs = dict.fromkeys(CYCLE_LEGS, 0.0)
    tracing = [False]

    def timed_call(name, fn):
        """`fn` with its host time added to legs[name] and its calls counted;
        under the profiler, in a range of its own."""
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                if tracing[0]:
                    with record_function(f"k10_{name}"):
                        return fn(*a, **kw)
                return fn(*a, **kw)
            finally:
                legs[name] += time.perf_counter() - t0
                legs[f"n_{name}"] += 1
        return run

    # the K10 entry points the cycle calls (`reload_chunks` where the
    # package has it, the chunk loop's `reload` where it does not)
    kernels = spill.kernels
    for name in CYCLE_CALLS:
        if hasattr(kernels, name):
            setattr(kernels, name, timed_call(name, getattr(kernels, name)))
    copy = torch.Tensor.copy_
    sync = torch.cuda.Event.synchronize

    def timed_copy(self, *a, **kw):
        t0 = time.perf_counter()
        try:
            return copy(self, *a, **kw)
        finally:
            legs["copies"] += time.perf_counter() - t0

    def timed_sync(self):
        t0 = time.perf_counter()
        try:
            return sync(self)
        finally:
            legs["waits"] += time.perf_counter() - t0

    torch.Tensor.copy_ = timed_copy
    torch.cuda.Event.synchronize = timed_sync
    runs = []
    for c in range(cycles + 1):
        fill()
        before = dict(spill.stats)
        for k in legs:
            legs[k] = 0
        K.reset_launches()
        if c < cycles:
            spill.cycle(8190)
        else:
            tracing[0] = True
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                with record_function("cycle"):
                    spill.cycle(8190)
                torch.cuda.synchronize()
                rows_b, ful_b, active = one_chunk()
                with record_function("k10_reload_one"):  # K10r as a batch's reload calls it
                    K.spill_reload(st, rows_b, ful_b, active, SPILL_LOG2)
                torch.cuda.synchronize()
            tracing[0] = False
            if int(st["fault"]):
                fail(f"the traced reload faulted: {int(st['fault'])}")
        torch.cuda.synchronize()
        run = {k: spill.stats[k] - before[k] for k in ("spilled", "t_scan", "t_gather_d2h",
                                                       "t_stage", "t_rebuild")}
        run.update(legs)
        run["launches"] = {k: v for k, v in K.LAUNCHES.items() if v}
        runs.append(run)
    torch.Tensor.copy_ = copy
    torch.cuda.Event.synchronize = sync
    out_dir = os.path.join(os.getcwd(), "build", "trace")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "cycle.json")
    prof.export_chrome_trace(path)
    traced = _trace_device(path)
    split = _device_split(traced["cycle"])
    by_call = {name: _device_split(ev) for name, ev in traced.items() if name != "cycle"}
    print(json.dumps({"runs": runs, "traced": split, "traced_calls": by_call, "n_live": n_live,
                      "card": torch.cuda.get_device_name(0)}))


def spill_rate_child():
    """In a process of its own: phase 9's requests alone (phase_spill up to
    its rate), on the package first on sys.path; prints {"rate": transfers/s}
    as the last line (group_gather_split.py --children spill)."""
    import torch

    from tigerbeetle_tpu_torch import constants, native, types
    from tigerbeetle_tpu_torch import state_machine as SM
    from tigerbeetle_tpu_torch.kernels import build
    from tigerbeetle_tpu_torch.models import ledger as L

    build.build()
    native.build()
    rate = phase_spill(torch, L, SM, types, constants, torch.device("cuda"),
                       torch.cuda.get_device_name(0), None, None, None, rate_only=True)
    print(json.dumps({"rate": rate}))


def cycle_trace(card) -> dict:
    """cycle_child in a process of its own (late in this one a profiler
    session recorded no kernels): in the traced cycle the split (K10s) must
    be at most SPLIT_LAUNCHES kernels and the rebuild's reloads one kernel,
    and the one-chunk reload one kernel, none with a memset. Logs each
    cycle's legs and returns the JSON."""
    proc = subprocess.run(
        [sys.executable, "-c", "import chip_smoke; chip_smoke.cycle_child()"],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True)
    if proc.returncode != 0:
        log(proc.stdout[-3000:], proc.stderr[-3000:])
        fail("the traced spill cycle failed")
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    for r in got["runs"]:
        log(f"  cycle at 2^{SPILL_LOG2} ({r['spilled']} spilled): t_scan "
            f"{r['t_scan'] * 1e3:.4f} ms (head {r['cycle_head'] * 1e3:.4f}, split {r['split_idx'] * 1e3:.4f} in its "
            f"wrapper), t_rebuild {r['t_rebuild'] * 1e3:.4f} ms (gather "
            f"{r['gather'] * 1e3:.4f} over both sides, reloads {r['n_reload_chunks']:.0f} + "
            f"{r['n_reload']:.0f} calls {(r['reload_chunks'] + r['reload']) * 1e3:.4f}); "
            f"launches {r['launches']} [{card}]")
    calls = got["traced_calls"]
    for name in ("k10_split_idx", "k10_reload_chunks", "k10_reload_one"):
        sp = calls.get(name)
        if sp is None:
            fail(f"the traced cycle has no {name} call")
        n_k = sum(v for k, v in sp["counts"].items() if not k.startswith("mem"))
        log(f"  trace {name}: {n_k} kernels {sp['counts']}; device us {sp['us']}; span "
            f"{sp['span_us']:.1f} us, gaps {sp['gap_us']:.1f} us")
        most = SPLIT_LAUNCHES if name == "k10_split_idx" else 1
        if any(k.startswith("mem") for k in sp["counts"]) or not 1 <= n_k <= most:
            fail(f"{name}: {sp['counts']}; at most {most} kernels and no memset expected")
    return got


# ----------------------------------------------------------------------
# phase 9: the bounded-memory ledger (spill, reload, queries over the LSM)
# ----------------------------------------------------------------------

SPILL_LOG2 = 20  # the transfer table of phase 9 (cut from 2^24: see PERF.md section 4)
SPILL_REQUESTS = 128
SPILL_PENDING = 8  # requests 0-7 are pendings; the last 8 post and void them
SPLIT_LAUNCHES = 4  # csrc/spill_split.cu: init, scan, select, partition
GRID_BLOCKS = 16384  # 2 GiB of 128 KiB grid blocks


def spill_requests(types, rng):
    """10,000 accounts, then 128 requests of 8190 transfers: pendings
    first, the benchmark traffic, and last the posts and voids of every
    pending (which have been spilled by then)."""
    B = 8190
    Op = types.Operation
    acc = accounts(types, np.arange(1, N_ACCOUNTS + 1))
    reqs = [(Op.create_accounts, acc[:B].tobytes()), (Op.create_accounts, acc[B:].tobytes())]
    pend_ids = []
    for r in range(SPILL_REQUESTS - SPILL_PENDING):
        first = 5_000_000_000 + r * B
        ids = np.arange(first + B, first, -1)
        dr, cr = random_pairs(rng, B, N_ACCOUNTS)
        amt = rng.integers(1, 1_000_000, B).astype(np.uint64)
        t = transfers(types, ids, dr, cr, amt, flags=2 if r < SPILL_PENDING else 0)
        if r < SPILL_PENDING:
            pend_ids.append(ids)
        reqs.append((Op.create_transfers, t.tobytes()))
    for r in range(SPILL_PENDING):
        ids = np.arange(6_000_000_001 + r * B, 6_000_000_001 + (r + 1) * B)
        t = transfers(types, ids, 0, 0, 0, ledger=0, code=0,
                      flags=np.where(np.arange(B) % 2, 4, 8), pending_id=pend_ids[r])
        reqs.append((Op.create_transfers, t.tobytes()))
    return reqs


def phase_spill(torch, L, SM, types, constants, dev, card, main_state, main_process,
                sector_ms, rate_only=False):
    """The bounded-memory path on cuda: StateMachine over DeviceLedger(2^20 /
    2^20 slots, forest=...) with the default threaded IO, against the
    native engine NativeLedger(20, 24) on the same requests; then K10
    against its plain versions at 2^20 (the first cycle's head, split,
    gather and rebuild on a copy of its table) and at 2^24 (on a copy of
    the main path's state), and K10's timing rows. Returns (launches,
    {check: max_abs_err}, {key: timing row}); with `rate_only`, only the
    requests' transfers/s, once the IO worker is drained and the run's
    cycles, launches and replies are checked (spill_rate_child)."""
    from tigerbeetle_tpu_torch import kernels as K
    from tigerbeetle_tpu_torch.io.storage import MemoryStorage, ZoneLayout
    from tigerbeetle_tpu_torch.lsm.grid import BLOCK_SIZE, Grid
    from tigerbeetle_tpu_torch.lsm.groove import Forest
    from tigerbeetle_tpu_torch.models import spill as S
    from tigerbeetle_tpu_torch.models.native_ledger import NativeLedger

    Op = types.Operation
    rng = np.random.default_rng(SEED + 10)
    reqs = spill_requests(types, rng)
    process = constants.ConfigProcess(account_slots_log2=20, transfer_slots_log2=SPILL_LOG2)
    layout = ZoneLayout(constants.TEST_CLUSTER, grid_size=(GRID_BLOCKS + 64) * BLOCK_SIZE)
    storage = MemoryStorage(layout)
    forest = Forest(Grid(storage, offset=0, block_count=GRID_BLOCKS), memtable_max=8192)
    ledger = L.DeviceLedger(process, device=dev, forest=forest)
    spill = ledger.spill
    log(f"  DeviceLedger(ConfigProcess(20, {SPILL_LOG2}), forest=Forest(Grid(MemoryStorage, "
        f"{GRID_BLOCKS} blocks of {BLOCK_SIZE} bytes = {GRID_BLOCKS * BLOCK_SIZE} bytes), "
        f"memtable_max=8192)) on {dev}, IO {type(spill._io).__name__}; "
        f"table limit {ledger._xfer_limit} rows")
    sm = SM.StateMachine(ledger)

    # the first cycle: the table as it was before it, and after it (clones
    # in stream order, no synchronisation); the host time the wrapper adds
    # is taken off the request's time
    captured = {}
    per_cycle = []
    cycle = spill.cycle
    harness = [0.0]

    def traced_cycle(need):
        t0 = time.perf_counter()
        before = dict(spill.stats)
        if not captured:
            captured["pre"] = {k: v.clone() for k, v in ledger.state.items()}
            captured["need"] = need
        harness[0] += time.perf_counter() - t0
        cycle(need)
        t0 = time.perf_counter()
        if "post" not in captured:
            captured["post"] = {k: v.clone() for k, v in ledger.state.items()}
        per_cycle.append({k: spill.stats[k] - before[k] for k in before})
        harness[0] += time.perf_counter() - t0

    # host legs the spill stats do not split out: the waits for the IO
    # worker, the LSM multi-point reads of reloads, the worker's settles
    legs = {"io_drain": 0.0, "fetch_forest": 0.0, "settle": 0.0}
    hooked = {"io_drain": "io_drain", "_fetch_forest": "fetch_forest",
              "_settle_forest": "settle"}

    def timed_leg(name, fn):
        def run(*a):
            t0 = time.perf_counter()
            try:
                return fn(*a)
            finally:
                legs[name] += time.perf_counter() - t0
        return run

    spill.cycle = traced_cycle
    for attr, leg in hooked.items():
        setattr(spill, attr, timed_leg(leg, getattr(spill, attr)))
    torch.cuda.synchronize()
    K.reset_launches()
    replies, seconds, marked = [], [], []
    t_run = time.perf_counter()
    for i, (op, body) in enumerate(reqs):
        sm.prepare(op, body)
        ts = sm.prepare_timestamp + 10**12
        cycles = spill.stats["cycles"]
        h0 = harness[0]
        t0 = time.perf_counter()
        replies.append(sm.commit(op, ts, body))
        if op == Op.create_transfers:
            seconds.append(time.perf_counter() - t0 - (harness[0] - h0))
            if spill.stats["cycles"] != cycles or i >= len(reqs) - SPILL_PENDING:
                what = "cycle" if spill.stats["cycles"] != cycles else "reloads"
                marked.append(f"{i - 2} ({what}) {seconds[-1] * 1e3:.1f}")
    ledger.check_fault()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t_run
    launches = dict(K.LAUNCHES)
    spill.io_drain()
    spill.cycle = cycle
    for attr in hooked:
        delattr(spill, attr)
    stats = dict(spill.stats)
    n_xfer = SPILL_REQUESTS * 8190
    ms = np.array(seconds) * 1e3
    log(f"  {SPILL_REQUESTS} x 8190 create_transfers through StateMachine in {sum(seconds):.4f} s: "
        f"{n_xfer / sum(seconds):.0f} transfers/s; request latency median {np.median(ms):.4f} ms, "
        f"p84 {np.percentile(ms, 84):.4f} ms, max {ms.max():.4f} ms (each request committed and "
        f"drained before the next; the whole run {run_s:.4f} s) [{card}]")
    log(f"  launches on the spill path: {launches}")
    log(f"  spill.stats: {stats}")
    for i, c in enumerate(per_cycle):
        log(f"  cycle {i + 1}: spilled {c['spilled']}, t_scan {c['t_scan']:.4f} s, t_gather_d2h "
            f"{c['t_gather_d2h']:.4f} s, t_stage {c['t_stage']:.4f} s, t_rebuild "
            f"{c['t_rebuild']:.4f} s (LSM insertion runs on the IO worker) [{card}]")
    log(f"  outside the cycles: reloaded {stats['reloaded']} rows in t_reload "
        f"{stats['t_reload']:.4f} s; IO worker t_lsm_worker {stats['t_lsm_worker']:.4f} s "
        f"over the run")
    log(f"  host legs: waits for the IO worker (io_drain) {legs['io_drain']:.4f} s, LSM "
        f"multi-point reads of reloads {legs['fetch_forest']:.4f} s, the worker's tree settles "
        f"{legs['settle']:.4f} s; requests (number, kind, ms): {'; '.join(marked)}")
    if stats["cycles"] < 2 or stats["reloaded"] < 65_000:
        fail(f"the spill path ran {stats['cycles']} cycles and reloaded {stats['reloaded']} rows "
             "(want at least 2 and 65,000)")
    for k in ("spill_head", "spill_split", "spill_gather", "spill_reload"):
        if not launches[k]:
            fail(f"{k} was not launched on the spill path")
    if launches["spill_gather"] != 2 * stats["cycles"]:  # one gather a side of each cycle
        fail(f"spill_gather launched {launches['spill_gather']} times in {stats['cycles']} "
             "cycles; one for each side of a cycle expected")
    bad = [i for i, r in enumerate(replies) if r != b""]
    if bad:
        fail(f"requests {bad[:8]} failed on the spilling ledger")
    if rate_only:
        return n_xfer / sum(seconds)

    # the native engine on the same requests
    native = NativeLedger(20, 24)
    sm_n = SM.StateMachine(native)
    t0 = time.perf_counter()
    for (op, body), rep in zip(reqs, replies):
        sm_n.prepare(op, body)
        if sm_n.commit(op, sm_n.prepare_timestamp + 10**12, body) != rep:
            fail("a reply differs from the native engine's")
    log(f"  every reply ({len(reqs)} requests) equals NativeLedger(20, 24)'s on the same "
        f"requests (native alone {time.perf_counter() - t0:.4f} s)")
    acct_ids = list(range(1, N_ACCOUNTS + 1))
    for i in range(0, N_ACCOUNTS, 8190):
        chunk = acct_ids[i:i + 8190]
        if ledger.lookup_rows(Op.lookup_accounts, chunk) != \
                native.lookup_rows(Op.lookup_accounts, chunk):
            fail("an account's balances differ from the native engine's")
    log(f"  all {N_ACCOUNTS} accounts equal the native engine's, byte for byte")
    ids, dr, _ = debit_credit(types, [b for op, b in reqs if op == Op.create_transfers])
    spilled = np.array([int(x) in spill.spilled for x in ids])
    pick = np.concatenate([rng.choice(np.nonzero(spilled)[0], 4095, replace=False),
                           rng.choice(np.nonzero(~spilled)[0], 4095, replace=False)])
    look = [int(x) for x in ids[rng.permutation(pick)]]
    t0 = time.perf_counter()
    body = ledger.lookup_rows(Op.lookup_transfers, look)
    look_s = time.perf_counter() - t0
    if body != native.lookup_rows(Op.lookup_transfers, look) or len(body) != 128 * 8190:
        fail("lookup_transfers of spilled and resident ids differs from the native engine's")
    log(f"  lookup_transfers of 8190 ids (4095 spilled, 4095 resident) equals the native "
        f"engine's byte for byte ({look_s:.4f} s)")
    chosen = [int(a) for a in rng.choice(np.arange(1, N_ACCOUNTS + 1), QUERY_ACCOUNTS,
                                         replace=False)]
    n_rows = n_spilled = 0
    t0 = time.perf_counter()
    for a in chosen:
        got = ledger.query_transfers("debit_account_id", a)
        want = expected_query(native.lookup_transfers, ids, dr, a)
        if not want or not same_rows(got, want):
            fail(f"query_transfers('debit_account_id', {a}): {len(got)} rows, "
                 f"the native engine's lookups of the record {len(want)}")
        n_rows += len(got)
        n_spilled += sum(t.id in spill.spilled for t in got)
    log(f"  query_transfers('debit_account_id', a) for {QUERY_ACCOUNTS} accounts equals the "
        f"native engine's lookups of the record ({n_rows} rows, {n_spilled} of them spilled; "
        f"{time.perf_counter() - t0:.4f} s)")
    spill.io_drain()
    spill._io._ex.shutdown()
    del native, sm_n

    errs = {}

    def held(name, k_out, p_out, sk=None, sp=None):
        k_out = k_out if isinstance(k_out, tuple) else (k_out,)
        p_out = p_out if isinstance(p_out, tuple) else (p_out,)
        err = max([max_abs_diff(a, b) for a, b in zip(k_out, p_out)] + [0])
        if sk is not None:
            err = max(err, compare_states({k: v[:-1] if v.dim() else v for k, v in sk.items()},
                                          {k: v[:-1] if v.dim() else v for k, v in sp.items()}))
        errs[name] = err
        log(f"  {name}: max_abs_err={err}")
        if err:
            fail(f"{name} differs from its plain version")

    def bound(nbytes):
        return nbytes / H100_BYTES_PER_S * 1e3, "bytes"

    # K10 at 2^20 on the table before the first cycle
    pre, post = captured["pre"], captured["post"]
    t_log2 = SPILL_LOG2
    head = K.spill_head(pre["xfer_rows"], pre["fault"], t_log2)
    held(f"K10 spill_head (2^{t_log2})", head, S.spill_head_plain(pre["xfer_rows"], pre["fault"]))
    live = int(head[0])
    keep = min(int(live * S.KEEP_FRAC), ledger._xfer_limit - captured["need"])
    n_cold = live - keep
    cold, hot = K.spill_split(pre["xfer_rows"], t_log2, n_cold)
    held(f"K10 spill_split (2^{t_log2}, the first cycle: n_cold {n_cold} of {live})",
         (cold, hot), S.spill_split_plain(pre["xfer_rows"], n_cold))
    n_hot = live - n_cold
    hot_pad = -(-n_hot // S.CHUNK) * S.CHUNK
    for side, idx in (("cold", cold[:n_cold]), ("hot", hot[:hot_pad])):
        held(f"K10 spill_gather (2^{t_log2}, the first cycle's {side} side, {idx.shape[0]} rows)",
             K.spill_gather(pre["xfer_rows"], pre["fulfill"], idx),
             S.spill_gather_plain(pre["xfer_rows"], pre["fulfill"], idx))
    # the gather at the cycle's shapes: its cold side (the kernel table's
    # row) and its hot side, each beside torch.index_select of the rows and
    # of the fulfill words (the whole of `_gather`)
    cycle_gather = {}
    for side, idx in (("cold", cold[:n_cold]), ("hot", hot[:hot_pad])):
        cycle_gather[side] = (
            timed(torch, lambda: K.spill_gather(pre["xfer_rows"], pre["fulfill"], idx), 20),
            timed(torch, lambda: S.spill_gather_plain(pre["xfer_rows"], pre["fulfill"], idx), 5),
            *bound(idx.shape[0] * (4 + 2 * (128 + 4))),
            timed(torch, lambda: (torch.index_select(pre["xfer_rows"], 0, idx),
                                  torch.index_select(pre["fulfill"], 0, idx)), 20))
        kt, pt, b, _by, lib = cycle_gather[side]
        log(f"  K10g at the cycle's {side} side (2^{t_log2}, {idx.shape[0]} rows, one launch): "
            f"kernel {kt[0]:.4f} ms [p25 {kt[1]:.4f}, p75 {kt[2]:.4f}], plain {pt[0]:.4f} ms, "
            f"bound {b:.6f} ms (bytes), torch.index_select of rows and fulfill {lib[0]:.4f} ms "
            f"[{card}]")
    # the rebuild: all its chunks in one launch, and one launch a chunk
    # through the one-chunk entry, each against the plain chunk loop
    rows_h, ful_h = S.spill_gather_plain(pre["xfer_rows"], pre["fulfill"], hot[:hot_pad])
    fresh_k, fresh_p = S.fresh_table(t_log2, dev), S.fresh_table(t_log2, dev)
    pk = K.spill_reload_chunks(fresh_k, rows_h, ful_h, n_hot, t_log2)
    pp = S.spill_reload_chunks_plain(fresh_p, rows_h, ful_h, n_hot, t_log2)
    held(f"K10 spill_reload (2^{t_log2}, the first cycle's rebuild, {hot_pad // S.CHUNK} chunks "
         "in one launch)", pk, pp, fresh_k, fresh_p)
    rebuilt = {k: post[k] for k in fresh_k}
    held("K10 spill_reload (the rebuild equals the ledger's own)", (), (), fresh_k, rebuilt)
    fresh_c = S.fresh_table(t_log2, dev)
    lane = torch.arange(S.CHUNK, device=dev)
    for start in range(0, n_hot, S.CHUNK):
        pk = K.spill_reload(fresh_c, rows_h[start:start + S.CHUNK], ful_h[start:start + S.CHUNK],
                            lane < min(S.CHUNK, n_hot - start), t_log2)
    held(f"K10 spill_reload (2^{t_log2}, the first cycle's rebuild, one launch a chunk)", pk, pp,
         fresh_c, fresh_p)
    # the rebuild's time: one launch into a fresh table (made beforehand)
    tables = [S.fresh_table(t_log2, dev) for _ in range(10)]
    it = iter(tables)
    rebuild_t = timed(torch, lambda: K.spill_reload_chunks(next(it), rows_h, ful_h, n_hot, t_log2),
                      10)
    probes = probe_counts(torch, L.ht, rows_h[:n_hot, :4].contiguous(), post["xfer_rows"], t_log2,
                          32)
    rebuild_b = bound(n_hot * 2 * (128 + 4) + probes * 32)[0]
    log(f"  K10r, the first cycle's rebuild (2^{t_log2}, {n_hot} rows, {hot_pad // S.CHUNK} chunks "
        f"in one launch): {rebuild_t[0]:.4f} ms [p25 {rebuild_t[1]:.4f}, p75 {rebuild_t[2]:.4f}], "
        f"bound {rebuild_b:.6f} ms (bytes) [{card}]")
    del tables, fresh_c, rows_h, ful_h, captured, pre, post, fresh_k, fresh_p
    torch.cuda.empty_cache()
    k10r_cases(torch, S, K, dev, errs)
    k10s_cases(torch, S, K, dev, errs)

    # K10 at 2^24 on a copy of the main path's state
    big = {k: main_state[k].clone() for k in ("xfer_rows", "fulfill", "xfer_claim",
                                              "xfer_used_slots", "fault")}
    b_log2 = main_process.transfer_slots_log2
    head = K.spill_head(big["xfer_rows"], big["fault"], b_log2)
    held(f"K10 spill_head (2^{b_log2})", head, S.spill_head_plain(big["xfer_rows"], big["fault"]))
    live = int(head[0])
    n_cold = live * 3 // 4
    cold, hot = K.spill_split(big["xfer_rows"], b_log2, n_cold)
    held(f"K10 spill_split (2^{b_log2}, n_cold {n_cold} of {live})", (cold, hot),
         S.spill_split_plain(big["xfer_rows"], n_cold))
    held(f"K10 spill_gather (2^{b_log2}, 8192 cold rows)",
         K.spill_gather(big["xfer_rows"], big["fulfill"], cold[:S.CHUNK]),
         S.spill_gather_plain(big["xfer_rows"], big["fulfill"], cold[:S.CHUNK]))
    hot_pad = -(-(live - n_cold) // S.CHUNK) * S.CHUNK
    for side, idx in (("cold", cold[:n_cold]), ("hot", hot[:hot_pad])):
        held(f"K10 spill_gather (2^{b_log2}, a whole {side} side, {idx.shape[0]} rows)",
             K.spill_gather(big["xfer_rows"], big["fulfill"], idx),
             S.spill_gather_plain(big["xfer_rows"], big["fulfill"], idx))

    def new_chunk(i):
        """8192 stored rows: 4096 resident ones (skipped) and 4096 with new
        ids, different for every `i`."""
        pos = (torch.arange(S.CHUNK, device=dev) + i * (S.CHUNK // 2)) % n_cold
        rows_b, ful_b = S.spill_gather_plain(big["xfer_rows"], big["fulfill"], cold[pos])
        half = S.CHUNK // 2
        rows_b[half:, 0] = (torch.arange(half, device=dev) + i * half + 1).to(torch.int32)
        rows_b[half:, 1:4] = 0x5A5A5A5A
        return rows_b, ful_b

    rows_b, ful_b = new_chunk(0)
    all_on = torch.ones(S.CHUNK, dtype=torch.bool, device=dev)
    sk = {k: v.clone() for k, v in big.items()}
    pk = K.spill_reload(sk, rows_b, ful_b, all_on, b_log2)
    pp = S.spill_reload_plain(big, rows_b, ful_b, all_on, b_log2)
    held(f"K10 spill_reload (2^{b_log2}, 8192 rows: 4096 resident, 4096 new)", pk, pp, sk, big)
    del sk
    reload_gates(torch, L, S, types, constants, dev, big, b_log2, new_chunk, errs)

    # timing rows at these shapes
    SECTOR = 32
    slots = 1 << b_log2
    out = {}

    out["K10h"] = (timed(torch, lambda: K.spill_head(big["xfer_rows"], big["fault"], b_log2), 20),
                   timed(torch, lambda: S.spill_head_plain(big["xfer_rows"], big["fault"]), 3),
                   *bound(slots * SECTOR + 8), None)
    size = slots + S.CHUNK
    # the key sector of every slot, the timestamp sector of a live one, both
    # lists written once
    out["K10s"] = (timed(torch, lambda: K.spill_split(big["xfer_rows"], b_log2, n_cold), 10),
                   timed(torch, lambda: S.spill_split_plain(big["xfer_rows"], n_cold), 3),
                   *bound(slots * SECTOR + live * SECTOR + 2 * size * 4), None)
    # at the card's 64-byte fetch (the sector probe, phase 1): the key half
    # of every row, the timestamp half of a live one, the lists, and the
    # live list (slot and timestamp) written once and read three times
    per_row = sector_ms[1] / (1 << 24)
    floor = (slots * per_row + live * (sector_ms[5] - sector_ms[1]) / (1 << 24)
             + bound(2 * size * 4 + live * 12 * 4)[0])
    log(f"  K10s's floor at the card's 64-byte fetch (2^{b_log2}, {live} live): {floor:.6f} ms "
        f"(a key half a row {slots * per_row:.6f}, a timestamp half a live row "
        f"{live * (sector_ms[5] - sector_ms[1]) / (1 << 24):.6f}, the lists and the live list "
        f"{bound(2 * size * 4 + live * 12 * 4)[0]:.6f}) [{card}]")
    out["K10g"] = cycle_gather["cold"]
    idx = cold[:S.CHUNK]  # the old shape: one chunk a launch
    kt = timed(torch, lambda: K.spill_gather(big["xfer_rows"], big["fulfill"], idx), 20)
    lib = timed(torch, lambda: (torch.index_select(big["xfer_rows"], 0, idx),
                                torch.index_select(big["fulfill"], 0, idx)), 20)
    log(f"  K10g at 8192 rows (2^{b_log2}): kernel {kt[0]:.4f} ms [p25 {kt[1]:.4f}, p75 "
        f"{kt[2]:.4f}], bound {bound(S.CHUNK * (4 + 2 * (128 + 4)))[0]:.6f} ms (bytes), "
        f"torch.index_select of rows and fulfill {lib[0]:.4f} ms [{card}]")
    chunks = [new_chunk(i + 1) for i in range(16)]
    probes = probe_counts(torch, L.ht, chunks[0][0][:, :4].contiguous(), big["xfer_rows"],
                          b_log2, 32)
    it = iter(chunks)
    kt = timed(torch, lambda: K.spill_reload(big, *next(it), all_on, b_log2), 10)
    pt = timed(torch, lambda: S.spill_reload_plain(big, *next(it), all_on, b_log2), 3)
    # rows and fulfill words in, the new half written, one key sector per probe
    out["K10r"] = (kt, pt, *bound(S.CHUNK * (128 + 4 + 1) + S.CHUNK // 2 * (128 + 4)
                                  + probes * SECTOR), None)
    if int(big["fault"]):
        fail(f"the timed reloads faulted: {int(big['fault'])}")
    for k, (kt, pt, b, by, lib) in out.items():
        extra = f", torch.index_select of rows and fulfill {lib[0]:.4f} ms" if lib else ""
        log(f"  {k}: kernel {kt[0]:.4f} ms [p25 {kt[1]:.4f}, p75 {kt[2]:.4f}], plain "
            f"{pt[0]:.4f} ms, bound {b:.6f} ms ({by}){extra} [{card}]")
    del big, chunks
    torch.cuda.empty_cache()
    return launches, errs, out

RELOAD_GEOMETRIES = ((14, 256), (18, 8192))  # (cap_log2, chunk) of testing/reload_cases.py
SPLIT_LOG2S = (20, 24)  # the table sizes of testing/split_cases.py on the card


def k10r_cases(torch, S, K, dev, errs):
    """K10r against its plain version on the cases of
    testing/reload_cases.py at 2^14 slots in chunks of 256 and at 2^18 in
    chunks of 8192: each case's chunks in one launch and one launch a chunk
    (the one-chunk entry, its lanes below the chunk's length active), the
    sparse mask through the one-chunk entry alone; every leaf (the dump
    row too: neither writes it) and the probe word equal, and the fault
    bits the case is built for."""
    import zlib

    from tigerbeetle_tpu_torch.testing import reload_cases as RC

    for log2, chunk in RELOAD_GEOMETRIES:
        for case in RC.CASES:
            rng = np.random.default_rng(zlib.crc32(f"{case}.{log2}.{chunk}".encode()))
            c = RC.reload_case(case, log2, chunk, rng)
            rows = torch.from_numpy(c["rows"].view(np.int32)).to(dev)
            ful = torch.from_numpy(c["ful"].view(np.int32)).to(dev)
            n = c["n"]
            start = RC.to_torch(c["table"], dev)
            name = f"K10 spill_reload (case {case}, 2^{log2}, chunks of {chunk}, {n} rows"
            if c["active"] is not None:
                act = torch.from_numpy(c["active"]).to(dev)
                runs = [(f"{name})", lambda s: K.spill_reload(s, rows, ful, act, log2),
                         lambda s: S.spill_reload_plain(s, rows, ful, act, log2))]
            else:
                lane = torch.arange(chunk, device=dev)

                def by_chunk(s):
                    probe = None
                    for i in range(0, n, chunk):
                        probe = K.spill_reload(s, rows[i:i + chunk], ful[i:i + chunk],
                                               lane < min(chunk, n - i), log2)
                    return probe

                runs = [(f"{name}, one launch)",
                         lambda s: K.spill_reload_chunks(s, rows, ful, n, log2, chunk),
                         lambda s: S.spill_reload_chunks_plain(s, rows, ful, n, log2, chunk)),
                        (f"{name}, one launch a chunk)", by_chunk,
                         lambda s: S.spill_reload_chunks_plain(s, rows, ful, n, log2, chunk))]
            for what, run_kernel, run_plain in runs:
                _, sp = hold(torch, what, start, run_kernel, run_plain)
                fault = int(sp["fault"]) & 0xFFFFFFFF
                if (fault & c["fault"]) != c["fault"] or (fault == 0) != (c["fault"] == 0):
                    fail(f"{what}: fault word {fault:#x}, the case is built for {c['fault']:#x}")
                errs[what] = 0  # hold() failed the run on any difference
            del start, rows, ful
    torch.cuda.empty_cache()


def k10s_cases(torch, S, K, dev, errs):
    """K10s against its plain version on the tables of
    testing/split_cases.py at 2^20 and 2^24 slots, each split at every rank
    of split_cases.RANKS: both lists equal."""
    import zlib

    from tigerbeetle_tpu_torch.testing import split_cases as SC

    for log2 in SPLIT_LOG2S:
        for case in SC.CASES:
            rng = np.random.default_rng(zlib.crc32(f"{case}.{log2}".encode()))
            rows = torch.from_numpy(SC.split_case(case, log2, rng).view(np.int32)).to(dev)
            live = int(S.spill_head_plain(rows, torch.zeros((), dtype=torch.int32, device=dev))[0])
            worst = 0
            for rank in SC.RANKS:
                n_cold = SC.n_cold_of(rank, live)
                got = K.spill_split(rows, log2, n_cold)
                want = S.spill_split_plain(rows, n_cold)
                torch.cuda.synchronize()
                err = max(max_abs_diff(a, b) for a, b in zip(got, want))
                if err:
                    for side, a, b in zip(("cold", "hot"), got, want):
                        idx = (a != b).nonzero()[:4].flatten().tolist()
                        log(f"    {side}: {int((a != b).sum())} differ; at {idx}: kernel "
                            f"{a[idx].tolist()}, plain {b[idx].tolist()}")
                    fail(f"K10 spill_split (case {case}, 2^{log2}, n_cold {n_cold} of {live}) "
                         "differs from its plain version")
                worst = max(worst, err)
            name = f"K10 spill_split (case {case}, 2^{log2}, {live} live, n_cold at {SC.RANKS})"
            errs[name] = worst
            log(f"  {name}: max_abs_err={worst}")
            del rows
    torch.cuda.empty_cache()


def reload_gates(torch, L, S, types, constants, dev, big, b_log2, new_chunk, errs):
    """K10 reload's gate against its plain version, on clones: the chunk is
    all or nothing. At 2^24: used_slots just below half the slots
    (FAULT_CAPACITY), and an earlier fault word that must stay as it was;
    at 2^16 (phase 2's geometry): probe windows with no empty slot, so new
    keys neither resolve (FAULT_PROBE) nor find a slot (FAULT_CLAIM). A
    faulted reload writes nothing but the fault word."""
    from tigerbeetle_tpu_torch import kernels as K

    all_on = torch.ones(S.CHUNK, dtype=torch.bool, device=dev)

    def gate(name, start, rows_b, ful_b, log2, want_bits, want_exact):
        n = rows_b.shape[0]
        for entry, run_kernel in (
                ("", lambda s: K.spill_reload(s, rows_b, ful_b, all_on, log2)),
                (", all chunks in one launch",
                 lambda s: K.spill_reload_chunks(s, rows_b, ful_b, n, log2))):
            what = f"K10 spill_reload (gate: {name}{entry})"
            (probe,), sp = hold(torch, what, start, run_kernel,
                                lambda s: S.spill_reload_plain(s, rows_b, ful_b, all_on, log2))
            fault = int(sp["fault"])
            if (fault & want_bits) != want_bits or (want_exact and fault != want_bits):
                fail(f"{what}: fault word {fault:#x}, expected {want_bits:#x}")
            if compare_states({k: v for k, v in sp.items() if k != "fault"},
                              {k: v for k, v in start.items() if k != "fault"}):
                fail(f"{what}: a faulted reload wrote to the table")
            errs[what] = 0  # hold() failed the run on any difference
            log(f"    probe word {int(probe)}; the table is as it was")

    rows_b, ful_b = new_chunk(100)
    full = dict(big)
    full["xfer_used_slots"] = big["xfer_used_slots"].clone().fill_((1 << b_log2) // 2 - 100)
    gate(f"2^{b_log2}, used_slots 100 below half, 4096 new rows", full, rows_b, ful_b, b_log2,
         L.FAULT_CAPACITY, True)
    faulted = dict(big)
    faulted["fault"] = big["fault"].clone().fill_(L.FAULT_INSTALL)
    gate(f"2^{b_log2}, an earlier fault", faulted, rows_b, ful_b, b_log2, L.FAULT_INSTALL, True)

    process = constants.ConfigProcess(account_slots_log2=14, transfer_slots_log2=16)
    t_log2 = process.transfer_slots_log2
    rng = np.random.default_rng(SEED + 11)
    base, _ = seeded_state(L, types, process, rng, dev)
    rows_np, ful_np = live_rows(base, "xfer")
    half = S.CHUNK // 2
    pick = rng.choice(len(rows_np), half, replace=False)
    fresh = rows_np[pick].copy()
    fresh[:, 0] = np.arange(9_000_001, 9_000_001 + half, dtype=np.uint32)  # new ids
    rows_b = torch.from_numpy(np.concatenate([rows_np[pick], fresh]).view(np.int32)).to(dev)
    ful_b = torch.from_numpy(np.concatenate([ful_np[pick], ful_np[pick]]).view(np.int32)).to(dev)
    tbl = ("xfer_rows", "fulfill", "xfer_claim", "xfer_used_slots", "fault")
    start = exhausted(torch, base, rng, tombs=4000)
    gate(f"2^{t_log2}, no empty slot in any window, 4000 tombstones, 4096 resident and 4096 "
         "new rows", {k: start[k] for k in tbl}, rows_b, ful_b, t_log2,
         L.FAULT_PROBE | L.FAULT_CLAIM, True)


# ----------------------------------------------------------------------
# phase 10: the sharded ledger on one card
# ----------------------------------------------------------------------

MESH_SHARDS = 8
MESH_KERNELS = ("mesh_lookup", "mesh_commit_accounts_fast", "mesh_commit_accounts_serial",
                "mesh_commit_transfers_fast", "mesh_commit_transfers_serial")


def owners_of(M, ids):
    ids = np.asarray(ids, dtype=np.uint64)
    return M.owner_of_ids_np(ids, np.zeros_like(ids), MESH_SHARDS)


def on_distinct_shards(M, start, k):
    """The first k ids from `start` on k distinct owner shards."""
    out, seen = [], set()
    i = start
    while len(out) < k:
        s = int(owners_of(M, [i])[0])
        if s not in seen:
            seen.add(s)
            out.append(i)
        i += 1
    return out


def mesh_seeded_state(M, types, process, rng, dev):
    """A small sharded ledger (plain versions on the CPU): accounts on two
    ledgers, transfers, open pendings, and the tombstones of a rolled-back
    chain; returns (its state on `dev`, the last timestamp)."""
    led = M.ShardedLedger(MESH_SHARDS, process, device="cpu")
    Op = types.Operation
    accts = accounts(types, np.arange(1, 3001))
    accts["ledger"][2000:] = 3  # ledger mismatches
    ts = 10_000
    led.execute_dense(Op.create_accounts, ts, accts)
    dr, cr = random_pairs(rng, 4000, 1999)
    ts += 10_000
    led.execute_dense(Op.create_transfers, ts,
                      transfers(types, np.arange(100_001, 104_001), dr, cr,
                                rng.integers(1, 1000, 4000)))
    dr, cr = random_pairs(rng, 3000, 1999)
    ts += 10_000
    led.execute_dense(Op.create_transfers, ts,
                      transfers(types, np.arange(200_001, 203_001), dr, cr,
                                rng.integers(1, 1000, 3000), flags=2))
    ts += 10_000
    led.execute_dense(Op.create_transfers, ts,
                      transfers(types, [300_001, 300_002, 300_003], [1, 2, 3], [4, 5, 6],
                                [5, 5, 0], flags=[1, 1, 0]))
    led.check_fault()
    return {k: v.to(dev) for k, v in led.state.items()}, ts


def mesh_exhausted(torch, state, rng, shard, tombs):
    """A copy of `state` whose shard `shard` has no empty transfer slot
    left: its empty rows get random words, then `tombs` of its rows are
    tombstoned."""
    out = clone_state(state)
    rows = out["xfer_rows"][shard].cpu().numpy()
    empty = np.nonzero((rows[:-1, :4] == 0).all(1))[0]
    rows[empty] = rng.integers(-(1 << 31), 1 << 31, (len(empty), 32)).astype(np.int32)
    rows[rng.choice(len(rows) - 1, tombs, replace=False)] = -1
    out["xfer_rows"][shard].copy_(torch.from_numpy(rows))
    return out


def mesh_serial_batch(M, types, rng, n):
    """serial_transfer_batch (chains, balancing, duplicates, in-batch and
    registered post/void) plus a chain of four over accounts on four
    distinct shards, broken at its third link."""
    t = serial_transfer_batch(types, rng, n)
    acct = on_distinct_shards(M, 1, 4)  # ids of ledger-2 accounts (1..1999)
    j = np.arange(60, 64)
    t["flags"][j] = [1, 1, 1, 0]
    t["debit_account_id_lo"][j] = acct
    t["credit_account_id_lo"][j] = acct[1:] + acct[:1]
    t["amount_lo"][j] = [5, 7, 0, 9]
    return t


def claim_contenders(M, ht, torch, state, t_log2, first):
    """Four fresh transfer ids owned by one shard whose first probe is the
    same free slot of that shard's table."""
    ids = np.arange(first, first + 200_000, dtype=np.int64)
    owner = owners_of(M, ids)
    k4 = torch.from_numpy(np.stack([ids & 0xFFFFFFFF, ids >> 32, 0 * ids, 0 * ids], 1)
                          .astype(np.uint32).view(np.int32))
    base = ht.hash_key4(k4, t_log2).numpy()
    free = (state["xfer_rows"][:, :-1, :4] == 0).all(-1).cpu().numpy()[owner, base]
    key = owner * (1 << t_log2) + base
    order = np.argsort(key[free], kind="stable")
    k_sorted = key[free][order]
    start = np.nonzero(k_sorted[3:] == k_sorted[:-3])[0][0]
    return [int(x) for x in ids[free][order][start:start + 4]]


def mesh_gates(torch, L, M, ht, types, constants, dev):
    """Each K11 kernel against its plain version on the card at 2^12 / 2^14
    slots per shard, on every failure path and fault gate. Returns
    {check name: max_abs_err}."""
    from tigerbeetle_tpu_torch import kernels as K

    process = constants.ConfigProcess(account_slots_log2=12, transfer_slots_log2=14)
    a_log2, t_log2 = 12, 14
    rng = np.random.default_rng(SEED + 11)
    base, ts = mesh_seeded_state(M, types, process, rng, dev)
    errs = {}

    def check(name, run_kernel, run_plain, start=None):
        errs[name] = 0
        return hold(torch, name, base if start is None else start, run_kernel, run_plain)

    def xfer(name, arr, n, serial, start=None, t=None, want_fault=None):
        rows = M.batch_rows(arr)
        kern = K.mesh_commit_transfers_serial if serial else K.mesh_commit_transfers_fast
        plain = M.commit_transfers_serial_plain if serial else M.commit_transfers_fast_plain
        t = ts + 10_000 if t is None else t
        rows = torch.from_numpy(rows).to(dev)
        _, sp = check(name, lambda s: kern(s, rows, n, t, a_log2, t_log2),
                      lambda s: plain(s, rows, n, t, a_log2, t_log2), start)
        if want_fault is not None and int(sp["fault"]) != want_fault:
            fail(f"{name}: fault {int(sp['fault'])}, not {want_fault}")

    def acct(name, arr, n, serial, start=None):
        rows = torch.from_numpy(M.batch_rows(arr)).to(dev)
        kern = K.mesh_commit_accounts_serial if serial else K.mesh_commit_accounts_fast
        plain = M.commit_accounts_serial_plain if serial else M.commit_accounts_fast_plain
        check(name, lambda s: kern(s, rows, n, ts + 10_000, a_log2),
              lambda s: plain(s, rows, n, ts + 10_000, a_log2), start)
        if serial:
            log(f"    re-probed {K.walk_reprobes('mesh_commit_accounts_serial')} of {n} events")

    B = 8190
    ids = np.concatenate([np.arange(1, 6001), np.arange(7_000_000, 7_000_000 + B - 6001), [0]])
    key4 = L.ids_to_batch([int(x) for x in ids], dev)["key4"]
    check("K11 mesh_lookup (accounts: present, missing, zero)",
          lambda s: K.mesh_lookup(key4, s["acct_rows"], a_log2),
          lambda s: M.lookup_plain(s["acct_rows"], key4, a_log2))
    acct("K11 mesh_commit_accounts fast (4096, failures)",
         account_batch(types, rng, 4096, 1_000_000, False), 4096, False)
    acct("K11 mesh_commit_accounts serial (512, chains, duplicates)",
         account_batch(types, rng, 512, 1_100_000, True), 512, True)
    xfer("K11 mesh_commit_transfers fast (8190, failures)",
         fast_transfer_batch(types, rng, B, False), B, False)
    xfer("K11 mesh_commit_transfers serial (256: a chain across four shards broken "
         "mid-chain, post and void across shards)", mesh_serial_batch(M, types, rng, 256),
         256, True)
    group = claim_contenders(M, ht, torch, base, t_log2, 40_000_000)
    arr = transfers(types, group, [1, 3, 5, 7], [2, 4, 6, 8], [1, 2, 3, 4])
    xfer(f"K11 mesh_commit_transfers fast (claim contention: 4 lanes, one slot of shard "
         f"{int(owners_of(M, group[:1])[0])})", arr, 4, False)
    # no lane wants a slot: every event fails its ladder (a missing debit
    # account), so claim round 0 wants nothing and the rounds end there
    arr = fast_transfer_batch(types, rng, B, False)
    arr["debit_account_id_lo"] += 5_000_000
    xfer("K11 mesh_commit_transfers fast (no lane wants a slot: every event fails)", arr, B,
         False, want_fault=0)
    # no free slot in any window of any shard: the ok lanes want none either,
    # and report FAULT_CLAIM beside FAULT_PROBE
    full = base
    for shard in range(MESH_SHARDS):
        full = mesh_exhausted(torch, full, rng, shard, tombs=0)
    xfer("K11 mesh_commit_transfers fast (no free slot on any shard)",
         fast_transfer_batch(types, rng, B, False), B, False, full, want_fault=3)
    # one shard exactly at its load limit, the others below: the gate passes;
    # one slot fewer left on that shard trips it
    dr, cr = random_pairs(rng, B, 1999)
    ids = np.arange(60_000_001, 60_000_001 + B)
    arr = transfers(types, ids, dr, cr, rng.integers(1, 1000, B).astype(np.uint64))
    ins = np.bincount(owners_of(M, ids), minlength=MESH_SHARDS)
    for over in (0, 1):
        full = clone_state(base)
        full["xfer_used_slots"][2] = (1 << t_log2) // 2 - int(ins[2]) + over
        xfer(f"K11 mesh_commit_transfers fast (shard 2 {'one past' if over else 'exactly at'} "
             "its load limit, the others below)", arr, B, False, full,
             want_fault=L.FAULT_CAPACITY if over else 0)

    # the fault gates
    arr = transfers(types, [800_001, 800_002], [1, 1], [2, 2], [0, 0], flags=[2, 0])
    arr["amount_hi"] = 1 << 63  # 2^127 pending + 2^127 posted: dp + dpo overflows
    xfer("K11 mesh_commit_transfers fast (overflow backstop)", arr, 2, False)
    arr = fast_transfer_batch(types, rng, B, False)
    ins = np.bincount(owners_of(M, arr["id_lo"]), minlength=MESH_SHARDS)
    full = clone_state(base)
    full["xfer_used_slots"][0] = (1 << t_log2) // 2 - int(ins[0]) // 2  # owned inserts overflow
    xfer("K11 mesh_commit_transfers fast (capacity gate of shard 0)", arr, B, False, full)
    full = clone_state(base)
    full["xfer_used_slots"][5] = (1 << t_log2) // 2 - 63  # all 64 events charged to each shard
    xfer("K11 mesh_commit_transfers serial (capacity gate: 64 events, room for 63 on shard 5)",
         mesh_serial_batch(M, types, rng, 64), 64, True, full)
    full = clone_state(base)
    full["acct_used_slots"][2] = (1 << a_log2) // 2 - 63
    acct("K11 mesh_commit_accounts serial (capacity gate: 64 events, room for 63 on shard 2)",
         account_batch(types, rng, 64, 1_200_000, True), 64, True, full)
    faulted = clone_state(base)
    faulted["fault"].fill_(1)
    acct("K11 mesh_commit_accounts fast (sticky fault)",
         account_batch(types, rng, 256, 2_000_000, False), 256, False, faulted)
    xfer("K11 mesh_commit_transfers serial (sticky fault)", mesh_serial_batch(M, types, rng, 64),
         64, True, faulted)
    # one shard's windows with no empty slot: its lookups do not resolve;
    # the fast commit faults before writing, the serial scan goes on with
    # FAULT_SERIAL
    full = mesh_exhausted(torch, base, rng, 3, tombs=1000)
    ids = np.concatenate([np.arange(100_001, 104_001), np.arange(8_000_000, 8_000_000 + 4190)])
    key4 = L.ids_to_batch([int(x) for x in ids], dev)["key4"]
    check("K11 mesh_lookup (transfers, shard 3 exhausted)",
          lambda s: K.mesh_lookup(key4, s["xfer_rows"], t_log2),
          lambda s: M.lookup_plain(s["xfer_rows"], key4, t_log2), full)
    xfer("K11 mesh_commit_transfers fast (shard 3 exhausted)",
         fast_transfer_batch(types, rng, B, False), B, False, full)
    xfer("K11 mesh_commit_transfers serial (shard 3 exhausted)",
         mesh_serial_batch(M, types, rng, 128), 128, True, full)
    serial_hazards(torch, M, types, process, rng, dev, errs)
    account_case_kernels(torch, MESH_SHARDS, dev, errs)
    return errs


def serial_hazards(torch, M, types, process, rng, dev, errs):
    """K11ts against its plain version on the lookahead's hazard requests
    (tigerbeetle_tpu_torch/testing/hazards.py) over their accounts: codes
    and every leaf equal."""
    from tigerbeetle_tpu_torch import kernels as K
    from tigerbeetle_tpu_torch.testing import hazards as H

    a_log2, t_log2 = process.account_slots_log2, process.transfer_slots_log2
    led = M.ShardedLedger(MESH_SHARDS, process, device="cpu")
    led.execute_dense(types.Operation.create_accounts, 10_000,
                      types.accounts_to_np(H.hazard_accounts()))
    led.check_fault()
    start = {k: v.to(dev) for k, v in led.state.items()}
    for case in H.CASES:
        arr = types.transfers_to_np(H.hazard_request(case, rng, t_log2, MESH_SHARDS))
        rows = torch.from_numpy(M.batch_rows(arr)).to(dev)
        n, ts = len(arr), 10**12
        sp = clone_state(start)
        rp = M.commit_transfers_serial_plain(sp, rows, n, ts, a_log2, t_log2)
        sk = clone_state(start)
        rk = K.mesh_commit_transfers_serial(sk, rows, n, ts, a_log2, t_log2)
        torch.cuda.synchronize()
        err = max(max_abs_diff(rk, rp), compare_states(sk, sp))
        name = f"K11 mesh_commit_transfers serial (hazard {case}, {n} events)"
        errs[name] = err
        if err != 0:
            fail(f"{name} differs from its plain version")
        codes = np.bincount(rp.cpu().numpy().astype(np.int64) & 0xFF)
        log(f"  {name}: equals the plain version, fault={int(sp['fault'])} "
            f"codes={ {i: int(c) for i, c in enumerate(codes) if c} }")


def mesh_probe_lengths(torch, M, ht, key4, rows, log2, window):
    """The probes each key needs on its owner shard's table (to the hit or
    the first empty slot), shard by shard (int64 [B])."""
    owners = M.owner_of_key4(key4, rows.shape[0])
    return torch.cat([probe_lengths(torch, ht, key4[owners == s].contiguous(), rows[s], log2,
                                    window) for s in range(rows.shape[0])])


def mesh_probe_counts(torch, M, ht, key4, rows, log2, window):
    """Probes the keys need on their owner shards' tables, summed."""
    return int(mesh_probe_lengths(torch, M, ht, key4, rows, log2, window).sum())


def phase_mesh(torch, L, M, SM, ht, types, constants, dev, card, hbm_ns, l2_ns, smem_ns,
               tps_main):
    """The sharded ledger on one card: the fault gates at 2^12 / 2^14, the
    main path at ConfigProcess() per shard against NativeLedger(20, 24),
    each kernel against its plain version on copies of that state, their
    times, and a checkpoint round trip. Returns (launches, {check:
    max_abs_err}, {key: timing row})."""
    from tigerbeetle_tpu_torch import kernels as K
    from tigerbeetle_tpu_torch.models.native_ledger import NativeLedger

    Op = types.Operation
    t0 = time.perf_counter()
    errs = mesh_gates(torch, L, M, ht, types, constants, dev)
    log(f"  fault gates held in {time.perf_counter() - t0:.1f} s")

    process = constants.ConfigProcess()
    reqs = main_path_requests(types, np.random.default_rng(SEED + 1))  # phase 3's requests
    torch.cuda.reset_peak_memory_stats()
    ledger = M.ShardedLedger(MESH_SHARDS, process, device=dev)
    nbytes = sum(v.numel() * v.element_size() for v in ledger.state.values())
    log(f"  ShardedLedger({MESH_SHARDS}, ConfigProcess()) on {dev}: 2^{process.account_slots_log2}"
        f" account and 2^{process.transfer_slots_log2} transfer slots per shard, state "
        f"{nbytes} bytes ({nbytes / 2**30:.2f} GiB)")
    sm = SM.StateMachine(ledger)
    torch.cuda.synchronize()
    K.reset_launches()
    replies, req_seconds = run_requests(sm, reqs, Op)
    seconds = transfer_seconds(reqs, req_seconds)
    ids = np.arange(1, N_ACCOUNTS + 1, dtype=np.uint64)
    id_bytes = np.stack([ids, np.zeros_like(ids)], axis=1).tobytes()
    chunks = [id_bytes[16 * i:16 * min(i + 8190, N_ACCOUNTS)] for i in range(0, N_ACCOUNTS, 8190)]
    looked = [sm.commit(Op.lookup_accounts, 0, c) for c in chunks]
    ledger.check_fault()
    torch.cuda.synchronize()
    launches = {k: K.LAUNCHES[k] for k in MESH_KERNELS}
    log(f"  launches on the sharded path: {launches}")
    missing = [k for k, v in launches.items() if not v]
    if missing:
        fail(f"{missing} were not launched on the sharded path")

    native = NativeLedger(20, 24)
    sm_n = SM.StateMachine(native)
    for (kind, op, body), rep in zip(reqs, replies):
        sm_n.prepare(op, body)
        if sm_n.commit(op, sm_n.prepare_timestamp + 10**12, body) != rep:
            fail(f"a {kind} reply differs from the native engine's")
    for c, got in zip(chunks, looked):
        if sm_n.commit(Op.lookup_accounts, 0, c) != got:
            fail("an account differs from the native engine's")
    if len(b"".join(looked)) != 128 * N_ACCOUNTS:
        fail("a lookup missed accounts")
    lk_reply = replies[[k for k, _o, _b in reqs].index("linked")]
    if not lk_reply:
        fail("the linked request reported no broken chain")
    log(f"  every reply ({len(reqs)} requests) and all {N_ACCOUNTS} accounts equal "
        "NativeLedger(20, 24)'s on the same requests")
    total = sum(seconds)
    tps = N_REQUESTS * 8190 / total
    ms = np.array(seconds) * 1e3
    log(f"  {N_REQUESTS} x 8190 create_transfers in {total:.4f} s: {tps:.0f} transfers/s one "
        f"request at a time (median {np.median(ms):.4f} ms, p84 {np.percentile(ms, 84):.4f} ms), "
        f"against {tps_main:.0f} on DeviceLedger in phase 3 [{card}]")
    log("  the two-phase and linked requests, 8190 events each, through StateMachine (reply "
        "included): " + ", ".join(f"{k} {s * 1e3:.4f} ms" for (k, _o, _b), s in
                                   zip(reqs, req_seconds) if k in ("pending", "resolve", "linked"))
        + " (resolve and linked on the serial tier)")

    mesh_fast_trace(card)
    shape_errs, serial_plain_ms = mesh_main_shapes(torch, L, M, types, ledger, dev)
    errs.update(shape_errs)
    log(f"  peak memory with the ledger and two copies: {torch.cuda.max_memory_allocated()} "
        "bytes")
    times = mesh_timing(torch, L, M, ht, types, ledger, dev, hbm_ns, l2_ns, smem_ns,
                        serial_plain_ms)
    del sm, ledger
    torch.cuda.empty_cache()
    mesh_round_trip(torch, M, types, constants, dev)
    return launches, errs, times


def mesh_fast_trace(card):
    """Fast-tier requests of the sharded path under torch.profiler, in a
    process of its own (late in this one, a profiler session recorded no
    kernel at all; the cause is not found): each request must make one
    K11tf wrapper call and one kernel launch on the card, with no memset.
    Logs the kernel's time on the card from the trace."""
    proc = subprocess.run(
        [sys.executable, "-c", "import chip_smoke; chip_smoke.mesh_fast_trace_child()"],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True)
    if proc.returncode != 0:
        log(proc.stdout[-3000:], proc.stderr[-3000:])
        fail("the traced sharded requests failed")
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    log(f"  {got['requests']} sharded fast requests of 8190 (a fresh ShardedLedger(8, "
        f"ConfigProcess()), phase 3's accounts) under the profiler: wrapper calls "
        f"{got['calls']}, kernels on the card {got['kernels']}, memsets {got['memsets']}; "
        f"K11tf on the card {', '.join(f'{us:.1f}' for us in got['kernel_us'])} us [{card}]")
    if got["calls"] != {"mesh_commit_transfers_fast": got["requests"]} or got["memsets"] \
            or got["kernels"] != {"mesh_xfer_commit(MeshXferFast)": got["requests"]}:
        fail("a sharded fast request must be one K11tf launch and no memset")
    log(f"  its first create_accounts request (8190, the fast tier) under the profiler: wrapper "
        f"calls {got['account_calls']}, kernels on the card {got['account_kernels']}, memsets "
        f"{got['account_memsets']}")
    k11af = sum(v for k, v in got["account_kernels"].items() if "acct_commit_fast" in k)
    if got["account_calls"] != {"mesh_commit_accounts_fast": 1} or got["account_memsets"] \
            or k11af != 1:
        fail("a sharded fast create_accounts request must be one K11af launch and no memset")


def mesh_fast_trace_child(n_requests=4):
    """mesh_fast_trace's process: prints one JSON line."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tigerbeetle_tpu_torch import constants, types
    from tigerbeetle_tpu_torch import kernels as K
    from tigerbeetle_tpu_torch import state_machine as SM
    from tigerbeetle_tpu_torch.parallel import mesh as M

    Op = types.Operation
    sm = SM.StateMachine(M.ShardedLedger(MESH_SHARDS, constants.ConfigProcess(), device="cuda"))

    def commit(op, body, ts=None):
        sm.prepare(op, body)
        if sm.commit(op, sm.prepare_timestamp + 10**12 if ts is None else ts, body) != b"":
            fail("a sharded request failed")

    acc = accounts(types, np.arange(1, N_ACCOUNTS + 1))
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "trace")
    os.makedirs(out_dir, exist_ok=True)
    before = dict(K.LAUNCHES)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        commit(Op.create_accounts, acc[:8190].tobytes())  # the fast tier: K11af
        torch.cuda.synchronize()
    account_calls = {k: v - before[k] for k, v in K.LAUNCHES.items() if v != before[k]}
    account_kernels, account_memsets = traced_kernels(prof, os.path.join(out_dir,
                                                                         "mesh_accounts.json"))
    commit(Op.create_accounts, acc[8190:].tobytes())
    bodies = benchmark_bodies(types, np.random.default_rng(SEED + 15), 2 + n_requests,
                              5_000_000_000)
    for body in bodies[:2]:  # warm
        commit(Op.create_transfers, body)
    tss = []
    for body in bodies[2:]:
        sm.prepare(Op.create_transfers, body)
        tss.append(sm.prepare_timestamp + 10**12)
    torch.cuda.synchronize()
    before = dict(K.LAUNCHES)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for body, ts in zip(bodies[2:], tss):
            if sm.commit(Op.create_transfers, ts, body) != b"":
                fail("a traced sharded request failed")
        torch.cuda.synchronize()
    path = os.path.join(out_dir, "mesh_fast.json")
    kernels, memsets = traced_kernels(prof, path)
    with open(path) as f:
        events = json.load(f)
    events = events["traceEvents"] if isinstance(events, dict) else events
    kernel_us = [float(e["dur"]) for e in events if e.get("ph") == "X" and e.get("cat") == "kernel"]
    print(json.dumps({
        "requests": n_requests,
        "calls": {k: v - before[k] for k, v in K.LAUNCHES.items() if v != before[k]},
        "kernels": kernels, "kernel_us": kernel_us, "memsets": memsets,
        "account_calls": account_calls, "account_kernels": account_kernels,
        "account_memsets": account_memsets,
    }))


def serial_request(types, rng, ids, pend):
    """A request of the sharded path's serial tier at its size: the linked
    request's chains of three over its first 600 events (every tenth
    broken), then posts and voids of the open pendings `pend`. Returns the
    request and the accounts each event moves (a post/void moves its
    pending's)."""
    lk = linked_request(types, rng, ids[:600], 600)
    m = len(ids) - 600
    pv = transfers(types, ids[600:], 0, 0, 0, ledger=0, code=0,
                   flags=np.where(np.arange(m) % 2, 4, 8), pending_id=pend["id_lo"][:m])
    moved = np.concatenate([lk, pend[:m]])
    return np.concatenate([lk, pv]), moved


def mesh_main_shapes(torch, L, M, types, ledger, dev):
    """Each K11 kernel and its plain version on two copies of the sharded
    main path's state, at the path's shapes: lookups of 8190 accounts and
    transfers, fast commits of 8190 accounts, transfers and pendings, the
    serial accounts on the path's 1810-event request (one linked pair) and
    the serial transfers on 8190 events (serial_request over those
    pendings). Returns ({check name: max_abs_err}, {kernel key: the serial
    plain run's ms})."""
    from tigerbeetle_tpu_torch import kernels as K

    a_log2, t_log2 = ledger.kernels.a_log2, ledger.kernels.t_log2
    sk, sp = clone_state(ledger.state), clone_state(ledger.state)
    rng = np.random.default_rng(SEED + 12)
    errs, plain_ms = {}, {}
    B = 8190
    NA = N_ACCOUNTS - B  # the path's second account request

    def check(name, run_kernel, run_plain):
        return hold_on(torch, errs, name, sk, sp, run_kernel, run_plain,
                       "the sharded path's shape", plain_ms)

    def pad(arr):
        return torch.from_numpy(M.batch_rows(arr)).to(dev)

    for table, log2, ids in (("acct_rows", a_log2, rng.integers(1, N_ACCOUNTS + 1, B)),
                             ("xfer_rows", t_log2, 1_000_000_001 + rng.integers(0, 64 * B, B))):
        key4 = L.ids_to_batch([int(x) for x in ids], dev)["key4"]
        check(f"K11 mesh_lookup ({B} {'accounts' if table == 'acct_rows' else 'transfers'})",
              lambda s: K.mesh_lookup(key4, s[table], log2),
              lambda s: M.lookup_plain(s[table], key4, log2))
    ts = 3 * 10**12
    rows = pad(accounts(types, np.arange(20_000_001, 20_000_001 + B)))
    check(f"K11 mesh_commit_accounts fast ({B})",
          lambda s: K.mesh_commit_accounts_fast(s, rows, B, ts, a_log2),
          lambda s: M.commit_accounts_fast_plain(s, rows, B, ts, a_log2))
    a = accounts(types, np.arange(21_000_001, 21_000_001 + NA))
    a["flags"][100:102] = [1, 0]
    rows = pad(a)
    ts += B
    as_name = f"K11 mesh_commit_accounts serial ({NA}, one linked pair)"
    check(as_name, lambda s: K.mesh_commit_accounts_serial(s, rows, NA, ts, a_log2),
          lambda s: M.commit_accounts_serial_plain(s, rows, NA, ts, a_log2))
    for what, first, flags in (("transfers", 7_000_000_000, 0), ("pendings", 7_100_000_000, 2)):
        dr, cr = random_pairs(rng, B, N_ACCOUNTS)
        arr = transfers(types, np.arange(first + B, first, -1), dr, cr,
                        rng.integers(1, 1_000_000, B).astype(np.uint64), flags=flags)
        rows = pad(arr)
        ts += B
        check(f"K11 mesh_commit_transfers fast ({B} {what})",
              lambda s: K.mesh_commit_transfers_fast(s, rows, B, ts, a_log2, t_log2),
              lambda s: M.commit_transfers_fast_plain(s, rows, B, ts, a_log2, t_log2))
    arr, _ = serial_request(types, rng, np.arange(7_300_000_001, 7_300_000_001 + B), arr)
    rows = pad(arr)
    ts += B
    ts_name = (f"K11 mesh_commit_transfers serial ({B}: 200 linked chains, every tenth broken, "
               f"then {B - 600} posts and voids)")
    codes = check(ts_name,
                  lambda s: K.mesh_commit_transfers_serial(s, rows, B, ts, a_log2, t_log2),
                  lambda s: M.commit_transfers_serial_plain(s, rows, B, ts, a_log2, t_log2))
    if int(sk["fault"]) != 0:
        fail(f"the sharded main-shape checks faulted: {int(sk['fault'])}")
    if int((codes[600:B] == 0).sum()) != B - 600:
        fail("a post or void of an open pending did not commit")
    del sk, sp
    torch.cuda.empty_cache()
    return errs, {"K11as": plain_ms[as_name], "K11ts": plain_ms[ts_name]}


def mesh_timing(torch, L, M, ht, types, ledger, dev, latency_ns, l2_ns, smem_ns,
                serial_plain_ms):
    """Each K11 kernel at the sharded path's shapes on its state, beside
    its plain version (for the serial ones, the plain run of
    mesh_main_shapes on the same kind of request, `serial_plain_ms`);
    {key: (kernel ms, plain ms, bound ms, bound_by)}. K11ts resolves its
    lookups ahead of its walk, so its bound is the larger of its bytes and
    one dependent shared-memory round trip an event (`smem_ns`): event i may
    read what event i - 1 wrote. K11as's is account_walk_bound. Their old
    bounds, a device-memory load an event (and for K11ts one more a
    post/void), are printed beside them."""
    from tigerbeetle_tpu_torch import kernels as K

    rng = np.random.default_rng(SEED + 13)
    st = ledger.state
    a_log2, t_log2 = ledger.kernels.a_log2, ledger.kernels.t_log2
    out = {}
    B = 8190
    NA = N_ACCOUNTS - B
    SECTOR = 32

    def bound(nbytes):
        return nbytes / H100_BYTES_PER_S * 1e3, "bytes"

    def walk_bound(nbytes, n):
        by_bytes = nbytes / H100_BYTES_PER_S * 1e3
        by_chain = n * smem_ns * 1e-6
        return (by_chain, "latency") if by_chain > by_bytes else (by_bytes, "bytes")

    def pad(arr):
        return torch.from_numpy(M.batch_rows(arr)).to(dev)

    def once(key):
        ms = serial_plain_ms[key]
        return ms, ms, ms

    key4 = L.ids_to_batch([int(x) for x in rng.integers(1, N_ACCOUNTS + 1, B)], dev)["key4"]
    b = lookup_bound(mesh_probe_lengths(torch, M, ht, key4, st["acct_rows"], a_log2, 32), l2_ns)
    fn = lambda: K.mesh_lookup(key4, st["acct_rows"], a_log2)  # noqa: E731
    out["K11l"] = (timed(torch, fn, 20),
                   timed(torch, lambda: M.lookup_plain(st["acct_rows"], key4, a_log2), 5),
                   *b[:2])
    kc = timed(torch, fn, 20, on_card=True)
    log(f"  K11l ({B} keys): {out['K11l'][0][0]:.4f} ms through its wrapper, {kc[0]:.4f} [p25 "
        f"{kc[1]:.4f}, p75 {kc[2]:.4f}] on the card alone; bound {b[0]:.6f} ms ({b[1]}; bytes "
        f"{b[2]:.6f}, 1 + {b[4]} dependent loads {b[3]:.6f})")

    next_id = [30_000_000]

    def fresh_accounts(n, linked):
        a = walk_request(types, next_id[0], n) if linked else accounts(
            types, np.arange(next_id[0], next_id[0] + n))
        next_id[0] += n
        return pad(a)

    for key, n, serial in (("K11af", B, False), ("K11as", NA, True)):
        batches = [fresh_accounts(n, serial) for _ in range(10 if serial else 23)]
        probes = mesh_probe_counts(torch, M, ht, batches[0][:n, :4].contiguous(),
                                  st["acct_rows"], a_log2, 64 if serial else 32)
        nbytes = n * (128 + 4 + 128) + probes * SECTOR
        kern = K.mesh_commit_accounts_serial if serial else K.mesh_commit_accounts_fast
        it = iter(batches)
        kt = timed(torch, lambda: kern(st, next(it), n, 10**13, a_log2), 10)
        if not serial:
            out[key] = (kt, timed(torch, lambda: M.commit_accounts_fast_plain(
                st, next(it), n, 10**13, a_log2), 3), *bound(nbytes))
            kc = timed(torch, lambda: kern(st, next(it), n, 10**13, a_log2), 10, on_card=True)
            log(f"  {key} ({n} new accounts): {kt[0]:.4f} ms through its wrapper, {kc[0]:.4f} "
                f"[p25 {kc[1]:.4f}, p75 {kc[2]:.4f}] on the card alone")
            continue
        # the last timed call's re-probes and the request's chain
        dependent = chain_events(walk_request(types, 1, n)["flags"]) + K.walk_reprobes(
            "mesh_commit_accounts_serial")
        out[key] = (kt, once(key), *account_walk_bound(nbytes, dependent, smem_ns))
        log(f"  K11as's bound: bytes {nbytes / H100_BYTES_PER_S * 1e3:.6f} ms, {dependent} "
            f"dependent events (chain and re-probed) {dependent * smem_ns * 1e-6:.6f} ms; "
            f"beside it one shared-memory round trip an event {n * smem_ns * 1e-6:.6f} ms and "
            f"the old bound, a device-memory load an event, {n * latency_ns * 1e-6:.6f} ms")

    next_xfer = [8_000_000_000]

    def fresh_transfers(flags=0):
        ids = np.arange(next_xfer[0], next_xfer[0] + B)
        next_xfer[0] += B
        dr, cr = random_pairs(rng, B, N_ACCOUNTS)
        return transfers(types, ids, dr, cr, rng.integers(1, 1000, B).astype(np.uint64),
                         flags=flags)

    def xfer_bytes(arr, moved, window):
        """Rows in, codes and rows out, the probe sectors of the ids, each
        distinct account moved (`moved`) read and written once, and for a
        post/void its pending's row read and fulfill word written."""
        rows = torch.from_numpy(L._to_rows_np(arr)).to(dev)
        mv = torch.from_numpy(L._to_rows_np(moved)).to(dev)
        distinct = torch.unique(torch.cat([mv[:, 4:8], mv[:, 8:12]]), dim=0)
        ap = mesh_probe_counts(torch, M, ht, distinct, st["acct_rows"], a_log2, window)
        tp = mesh_probe_counts(torch, M, ht, rows[:, :4].contiguous(), st["xfer_rows"], t_log2,
                              window)
        pv = torch.from_numpy((arr["flags"] & 12) != 0).to(dev)
        n_pv = int(pv.sum())
        pp = mesh_probe_counts(torch, M, ht, rows[pv, 16:20].contiguous(), st["xfer_rows"],
                               t_log2, window)
        n, touched = len(arr), distinct.shape[0]
        return (n * (128 + 4 + 128) + tp * SECTOR + touched * 2 * 128 + (ap - touched) * SECTOR
                + n_pv * (128 + 4) + (pp - n_pv) * SECTOR), n_pv

    arrs = [fresh_transfers() for _ in range(23)]
    nbytes, _ = xfer_bytes(arrs[0], arrs[0], 32)
    it = iter([pad(a) for a in arrs])
    kt = timed(torch, lambda: K.mesh_commit_transfers_fast(st, next(it), B, 10**13, a_log2,
                                                           t_log2), 10)
    pt = timed(torch, lambda: M.commit_transfers_fast_plain(st, next(it), B, 10**13, a_log2,
                                                            t_log2), 3)
    out["K11tf"] = (kt, pt, *bound(nbytes))
    kc = timed(torch, lambda: K.mesh_commit_transfers_fast(st, next(it), B, 10**13, a_log2,
                                                           t_log2), 10, on_card=True)
    log(f"  K11tf on the card alone: {kc[0]:.4f} ms [p25 {kc[1]:.4f}, p75 {kc[2]:.4f}] "
        f"(through its wrapper {kt[0]:.4f} ms)")

    # K11ts on serial_request, each over pendings the fast kernel commits
    # first (untimed)
    reqs = []
    for _ in range(10):
        pend = fresh_transfers(flags=2)
        K.mesh_commit_transfers_fast(st, pad(pend), B, 10**13, a_log2, t_log2)
        ids = np.arange(next_xfer[0], next_xfer[0] + B)
        next_xfer[0] += B
        reqs.append(serial_request(types, rng, ids, pend))
    nbytes, n_pv = xfer_bytes(*reqs[0], 64)
    it = iter([pad(r) for r, _ in reqs])
    kt = timed(torch, lambda: K.mesh_commit_transfers_serial(st, next(it), B, 10**13, a_log2,
                                                             t_log2), 10)

    out["K11ts"] = (kt, once("K11ts"), *walk_bound(nbytes, B))
    # and on the path's own linked request
    lk_arrs = [linked_request(types, rng, np.arange(9_000_000_000 + i * B,
                                                    9_000_000_000 + (i + 1) * B), 600)
               for i in range(10)]
    lk_bytes, _ = xfer_bytes(lk_arrs[0], lk_arrs[0], 64)
    it = iter([pad(a) for a in lk_arrs])
    full = timed(torch, lambda: K.mesh_commit_transfers_serial(st, next(it), B, 10**13, a_log2,
                                                                t_log2), 10)
    ledger.check_fault()
    for k, (kt, pt, b, by) in out.items():
        log(f"  {k}: kernel {kt[0]:.4f} ms [p25 {kt[1]:.4f}, p75 {kt[2]:.4f}], "
            f"plain {pt[0]:.4f} ms, bound {b:.6f} ms ({by})")
    log(f"  K11ts's old bound, a device-memory load an event and one more a post/void: "
        f"{(B + n_pv) * latency_ns * 1e-6:.6f} ms; its bytes alone "
        f"{nbytes / H100_BYTES_PER_S * 1e3:.6f} ms; {B} shared-memory round trips "
        f"{B * smem_ns * 1e-6:.6f} ms")
    lb, lby = walk_bound(lk_bytes, B)
    log(f"  K11ts on a whole linked request of {B} events: {full[0]:.4f} ms [p25 {full[1]:.4f}, "
        f"p75 {full[2]:.4f}], bound {lb:.6f} ms ({lby}; old bound "
        f"{B * latency_ns * 1e-6:.6f} ms)")
    return out


def mesh_round_trip(torch, M, types, constants, dev):
    """snapshot_bytes -> restore_bytes into a fresh ledger on the card at
    2^12 / 2^14: lookups and one more request answer alike on both."""
    Op = types.Operation
    process = constants.ConfigProcess(account_slots_log2=12, transfer_slots_log2=14)
    rng = np.random.default_rng(SEED + 14)
    a = M.ShardedLedger(MESH_SHARDS, process, device=dev)
    ts = 10_000
    a.execute_dense(Op.create_accounts, ts, accounts(types, np.arange(1, 1001)))
    for r in range(3):
        ts += 4000
        dr, cr = random_pairs(rng, 4000, 1000)
        t = transfers(types, np.arange(1 + 4000 * r, 4001 + 4000 * r), dr, cr,
                      rng.integers(1, 1000, 4000), flags=np.where(rng.random(4000) < 0.2, 2, 0))
        a.execute_dense(Op.create_transfers, ts, t)
    ts += 256
    a.execute_dense(Op.create_transfers, ts, mesh_serial_batch(M, types, rng, 256))
    blob = a.snapshot_bytes()
    b = M.ShardedLedger(MESH_SHARDS, process, device=dev)
    b.restore_bytes(blob)
    if b.snapshot_bytes() != blob:
        fail("a restored sharded ledger snapshots other bytes")
    ids = list(range(1, 1001)) + [5000]
    t_ids = list(range(1, 12_001, 7)) + [10**9]
    dr, cr = random_pairs(rng, 2000, 1000)
    more = transfers(types, np.arange(50_001, 52_001), dr, cr, rng.integers(1, 1000, 2000))
    ts += 2000
    same = (a.lookup_rows(Op.lookup_accounts, ids) == b.lookup_rows(Op.lookup_accounts, ids)
            and a.lookup_rows(Op.lookup_transfers, t_ids) == b.lookup_rows(Op.lookup_transfers,
                                                                          t_ids)
            and a.execute_dense(Op.create_transfers, ts, more)
            == b.execute_dense(Op.create_transfers, ts, more)
            and a.lookup_rows(Op.lookup_accounts, ids) == b.lookup_rows(Op.lookup_accounts, ids)
            and a.snapshot_bytes() == b.snapshot_bytes())
    if not same:
        fail("a restored sharded ledger answers otherwise than the original")
    log(f"  checkpoint round trip at 2^12 / 2^14: a blob of {len(blob)} bytes restores; lookups "
        "and one more request answer alike")


# ----------------------------------------------------------------------
# phase 11: the serial account walk (K2 serial, K11as) on the hazard
# requests of testing/hazards.py, its device launches from a trace, its
# re-probes and its times, in a process of its own (serial_ab.py --kind walk
# runs walk_times on another checkout too)
# ----------------------------------------------------------------------

WALK_KINDS = (("K2s", "commit_accounts_serial", 1), ("K11as", "mesh_commit_accounts_serial",
                                                     MESH_SHARDS))
WALK_SHAPES = (1810, 8190)  # the main path's second account request; a whole batch


def walk_ledger(torch, L, M, types, constants, n_shards, log2, n_filler, dev):
    """A ledger on the card with 2^log2 account slots (a shard), one table
    or `n_shards`, holding testing/hazards.py's accounts and `n_filler`
    more (ledger 2, ids from 1,000,001). Returns (the ledger, its batch
    rows from an ACCOUNT_DTYPE array, its serial account commit, the plain
    version)."""
    from tigerbeetle_tpu_torch import kernels as K
    from tigerbeetle_tpu_torch.testing import hazards as H

    process = constants.ConfigProcess(account_slots_log2=log2, transfer_slots_log2=12)
    if n_shards == 1:
        led = L.DeviceLedger(process, device=dev)
        batch = lambda arr: L.accounts_to_batch(arr, dev)["rows"]  # noqa: E731
        kern, plain = K.commit_accounts_serial, L.commit_accounts_serial_plain
    else:
        led = M.ShardedLedger(n_shards, process, device=dev)
        batch = lambda arr: torch.from_numpy(M.batch_rows(arr)).to(dev)  # noqa: E731
        kern, plain = K.mesh_commit_accounts_serial, M.commit_accounts_serial_plain
    Op = types.Operation
    if any(led.execute_dense(Op.create_accounts, 10**12,
                             types.accounts_to_np(H.hazard_accounts()))):
        fail("the hazard accounts failed")
    filler = accounts(types, np.arange(1_000_001, 1_000_001 + n_filler))
    for i in range(0, n_filler, 8190):
        if any(led.execute_dense(Op.create_accounts, 10**12 + i + 8190, filler[i:i + 8190])):
            fail("a filler account request failed")
    led.check_fault()
    return led, batch, kern, plain


def walk_request(types, first, n):
    """n fresh accounts from id `first`: one linked pair (events 100 and
    101, as the main path's 1810-event request) or, at 8190, a linked pair
    every 50 events."""
    a = accounts(types, np.arange(first, first + n))
    if n == 1810:
        a["flags"][100] = 1
    else:
        a["flags"][0::50] = 1
    return a


def chain_events(flags) -> int:
    """Events in linked chains: each linked event and the one after it."""
    linked = (np.asarray(flags) & 1) != 0
    return int(np.count_nonzero(linked | np.concatenate(([False], linked[:-1]))))


def account_walk_bound(nbytes, dependent, smem_ns):
    """(bound ms, bound_by) of K2 serial and K11as: the larger of their bytes
    (the batch rows, a 32-byte sector a probe, the rows written) and one
    shared-memory round trip for each of the `dependent` events, those that
    must wait for an earlier event of the batch: the events of linked
    chains, and those whose probe window holds a row the batch wrote before
    them (the walk's re-probes, false alarms included, so this errs high).
    Every other event's answer is the table's as it was before the batch,
    decided in parallel: a round trip for every event, the transfer walks'
    bound, is not a floor here."""
    by_bytes = nbytes / H100_BYTES_PER_S * 1e3
    by_chain = dependent * smem_ns * 1e-6
    return (by_chain, "latency") if by_chain > by_bytes else (by_bytes, "bytes")


def walk_times(torch, types, walks, reps=10) -> dict:
    """Each serial account commit of `walks` ({key: (state, batch, kern,
    log2)}) at WALK_SHAPES on fresh ids: CUDA-event medians and quartiles
    (ms) through the wrapper and on the card alone."""
    out = {}
    first = [30_000_001]
    for key, (st, batch, kern, log2) in walks.items():
        for n in WALK_SHAPES:
            rows = []
            for _ in range(2 * reps + 1):
                rows.append(batch(walk_request(types, first[0], n)))
                first[0] += n
            kern(st, rows[-1], n, 10**13, log2)  # warm
            it = iter(rows)
            out[f"{key} {n}"] = timed(torch, lambda: kern(st, next(it), n, 10**13, log2), reps)
            out[f"{key} {n} card"] = timed(torch, lambda: kern(st, next(it), n, 10**13, log2),
                                           reps, on_card=True)
    return out


def account_walk_child(reps=10, sizes=(14, 20)):
    """In a process of its own: K2 serial and K11as against their plain
    versions on every hazard request of testing/hazards.py (ACCOUNT_CASES)
    at 2^14 slots (4096 more accounts a shard: a crowded table) and at the
    path's 2^20 (8 shards for K11as; the last of `sizes` holds N_ACCOUNTS
    more), with each call's re-probes; at WALK_SHAPES on the larger tables
    against the plain version on a host copy; under torch.profiler two calls
    of each at WALK_SHAPES (each at most two kernels, no memset), with the
    re-probes of four more and the bytes and chain events of the first
    (for account_walk_bound); the times of walk_times. Prints one JSON line."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from tigerbeetle_tpu_torch import constants, types
    from tigerbeetle_tpu_torch import kernels as K
    from tigerbeetle_tpu_torch.models import ledger as L
    from tigerbeetle_tpu_torch.ops import hashtable as ht
    from tigerbeetle_tpu_torch.parallel import mesh as M
    from tigerbeetle_tpu_torch.testing import hazards as H

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 40)
    out = {"errs": {}, "cases": [], "trace": {}, "reprobes": {}, "bound_in": {}}
    walks, plains = {}, {}
    for log2 in sizes:
        for key, counter, n_shards in WALK_KINDS:
            n_filler = N_ACCOUNTS if log2 == sizes[-1] else (1 << log2) // 4 * n_shards
            led, batch, kern, plain = walk_ledger(torch, L, M, types, constants, n_shards, log2,
                                                  n_filler, dev)
            label = [name for k, _c, name, _s, _r in KERNELS if k == key][0]
            where = f"2^{log2}" + (f" x {n_shards} shards" if n_shards > 1 else "")
            for case in H.ACCOUNT_CASES:
                hz = H.account_hazard_request(case, rng, log2, n_shards)
                start = clone_state(led.state)
                H.prepare_account_hazard(start["acct_rows"], start["acct_used_slots"], hz, rng)
                rows = batch(types.accounts_to_np(hz.events))
                name = f"{label} (hazard {case}, {where}, {hz.n} of {len(hz.events)} events)"
                _, sp = hold(torch, name, start, lambda s: kern(s, rows, hz.n, 10**13, log2),
                             lambda s: plain(s, rows, hz.n, 10**13, log2))
                want = {"window_full": L.FAULT_SERIAL,
                        "gate_tripped": L.FAULT_CAPACITY}.get(case, 0)
                if int(sp["fault"]) != want:
                    fail(f"{name}: fault {int(sp['fault'])}, not {want}")
                out["errs"][name] = 0
                out["cases"].append([name, K.walk_reprobes(counter)])
                del start, sp
            if log2 == sizes[-1]:
                walks[key] = (led.state, batch, kern, log2)
                plains[key] = (plain, label, where)
            else:
                del led
            torch.cuda.empty_cache()

    # the timed shapes, held against the plain version on a copy of the
    # state on the host (there it takes seconds, on the card a minute)
    first = [25_000_001]
    for key, (st, batch, kern, log2) in walks.items():
        plain, label, where = plains[key]
        counter = [c for k, c, _s in WALK_KINDS if k == key][0]
        for n in WALK_SHAPES:
            rows = batch(walk_request(types, first[0], n))
            first[0] += n
            sp = {k: v.to("cpu", copy=True) for k, v in st.items()}
            rp = plain(sp, rows.cpu(), n, 10**13, log2)
            rk = kern(st, rows, n, 10**13, log2)
            torch.cuda.synchronize()
            err = max(max_abs_diff(rk.cpu(), rp),
                      compare_states({k: v.cpu() for k, v in st.items()}, sp))
            name = (f"{label} ({n} events at {where}, "
                    f"{'one linked pair' if n == 1810 else 'a linked pair every 50'})")
            log(f"  {name}: max_abs_err={err} fault={int(sp['fault'])} (plain on the host)")
            if err != 0:
                fail(f"{name} differs from its plain version")
            out["errs"][name] = err
            out["cases"].append([name, K.walk_reprobes(counter)])
            del sp, rp

    # each call's device launches, and its re-probes
    first = [20_000_001]
    traced = []
    for key, (st, batch, kern, log2) in walks.items():
        for n in WALK_SHAPES:
            for r in range(2):
                traced.append((f"{key}_{n}_{r}", st, batch(walk_request(types, first[0], n)),
                               kern, n, log2))
                first[0] += n
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for name, st, rows, kern, n, log2 in traced:
            with record_function(name):
                kern(st, rows, n, 10**13, log2)
        torch.cuda.synchronize()
    out_dir = os.path.join(os.getcwd(), "build", "trace")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "account_walk.json")
    prof.export_chrome_trace(path)
    out["trace"] = {name: _device_split(ev) for name, ev in _trace_device(path).items()}
    for key, counter, n_shards in WALK_KINDS:
        st, batch, kern, log2 = walks[key]
        for n in WALK_SHAPES:
            counts = []
            for r in range(4):
                req = walk_request(types, first[0], n)
                rows = batch(req)
                first[0] += n
                if r == 0:
                    key4 = rows[:n, :4].contiguous()
                    probes = (probe_counts(torch, ht, key4, st["acct_rows"], log2, 64)
                              if n_shards == 1 else
                              mesh_probe_counts(torch, M, ht, key4, st["acct_rows"], log2, 64))
                    out["bound_in"][f"{key} {n}"] = [n * (128 + 4 + 128) + probes * 32,
                                                     chain_events(req["flags"])]
                kern(st, rows, n, 10**13, log2)
                counts.append(K.walk_reprobes(counter))
            out["reprobes"][f"{key} {n}"] = counts
    out["times"] = walk_times(torch, types, walks, reps)
    for key, (st, *_rest) in walks.items():
        if int(st["fault"]):
            fail(f"{key}'s timed calls faulted: {int(st['fault'])}")
    out["card"] = torch.cuda.get_device_name(0)
    print(json.dumps(out))


def phase_account_walk(card, smem_ns) -> dict:
    """account_walk_child in a process of its own (late in this one a
    profiler session recorded no kernels): every hazard request bit-exact,
    each traced call at most two kernels and no memset; the bounds at
    WALK_SHAPES (account_walk_bound, with the median re-probes). Returns its
    JSON."""
    proc = subprocess.run(
        [sys.executable, "-c", "import chip_smoke; chip_smoke.account_walk_child()"],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True)
    if proc.returncode != 0:
        log(proc.stdout[-3000:], proc.stderr[-3000:])
        fail("the account walk's checks failed")
    lines = proc.stdout.strip().splitlines()
    got = json.loads(lines[-1])
    reprobes = dict(got["cases"])
    for line in lines[:-1]:
        name = line.strip().split(": max_abs_err")[0]
        log(line + (f" reprobes={reprobes[name]}" if name in reprobes else ""))
    for name, sp in sorted(got["trace"].items()):
        log(f"  trace {name}: {sp['counts']}; device us {sp['us']}; span {sp['span_us']:.1f} us")
        kernels = sum(v for k, v in sp["counts"].items() if not k.startswith("mem"))
        if not 1 <= kernels <= 2 or any(k.startswith("mem") for k in sp["counts"]):
            fail(f"{name}: {sp['counts']}; one or two kernels and no memset expected")
    for shape, counts in got["reprobes"].items():
        nbytes, chain = got["bound_in"][shape]
        n = int(shape.split()[-1])
        dependent = chain + int(np.median(counts))
        b, by = account_walk_bound(nbytes, dependent, smem_ns)
        log(f"  {shape} events at 2^20: re-probes a call {counts}; bound {b:.6f} ms ({by}; bytes "
            f"{nbytes / H100_BYTES_PER_S * 1e3:.6f} ms, {chain} chain events and the median "
            f"re-probes {dependent * smem_ns * 1e-6:.6f} ms; one shared-memory round trip an "
            f"event {n * smem_ns * 1e-6:.6f} ms)")
    t = got["times"]
    for key in sorted(k for k in t if not k.endswith("card")):
        ms, card_ms = t[key], t[key + " card"]
        log(f"  {key} events at 2^20: {ms[0]:.4f} ms [p25 {ms[1]:.4f}, p75 {ms[2]:.4f}] through "
            f"its wrapper, {card_ms[0]:.4f} ms on the card alone [{card}]")
    return got


KERNELS = [
    # key, launch counter, name (the prefix of its checks), source, replaces
    ("K1", "lookup", "K1 lookup", "tigerbeetle_tpu_torch/csrc/lookup.cu",
     "tigerbeetle_tpu/ops/hashtable.py:127"),
    ("K2f", "commit_accounts_fast", "K2 commit_accounts fast",
     "tigerbeetle_tpu_torch/csrc/commit_accounts.cu", "tigerbeetle_tpu/models/ledger.py:1284"),
    ("K2s", "commit_accounts_serial", "K2 commit_accounts serial",
     "tigerbeetle_tpu_torch/csrc/commit_accounts.cu", "tigerbeetle_tpu/models/ledger.py:1338"),
    ("K3", "commit_transfers_fast", "K3 commit_transfers fast",
     "tigerbeetle_tpu_torch/csrc/commit_transfers.cu", "tigerbeetle_tpu/models/ledger.py:805"),
    ("K4", "commit_transfers_serial", "K4 commit_transfers serial",
     "tigerbeetle_tpu_torch/csrc/serial_transfers.cu", "tigerbeetle_tpu/models/ledger.py:1004"),
    ("K5", "group_commit", "K5 group_commit",
     "tigerbeetle_tpu_torch/csrc/group_commit.cu", "tigerbeetle_tpu/models/ledger.py:2384"),
    ("K6", "fingerprint", "K6 fingerprint",
     "tigerbeetle_tpu_torch/csrc/fingerprint.cu", "tigerbeetle_tpu/models/ledger.py:325"),
    ("K9", "install_rows", "K9 install_rows",
     "tigerbeetle_tpu_torch/csrc/install.cu", "tigerbeetle_tpu/models/ledger.py:2561"),
    ("K7", "fold", "K7 fold", "tigerbeetle_tpu_torch/csrc/fold.cu",
     "tigerbeetle_tpu/models/ledger.py:365"),
    ("K8", "filter_scan", "K8 filter_scan", "tigerbeetle_tpu_torch/csrc/filter_scan.cu",
     "tigerbeetle_tpu/models/ledger.py:767"),
    ("K10h", "spill_head", "K10 spill_head", "tigerbeetle_tpu_torch/csrc/spill_split.cu",
     "tigerbeetle_tpu/models/spill.py:243"),
    ("K10s", "spill_split", "K10 spill_split", "tigerbeetle_tpu_torch/csrc/spill_split.cu",
     "tigerbeetle_tpu/models/spill.py:252"),
    ("K10g", "spill_gather", "K10 spill_gather", "tigerbeetle_tpu_torch/csrc/spill_reload.cu",
     "tigerbeetle_tpu/models/spill.py:271"),
    ("K10r", "spill_reload", "K10 spill_reload", "tigerbeetle_tpu_torch/csrc/spill_reload.cu",
     "tigerbeetle_tpu/models/spill.py:274"),
    ("K11l", "mesh_lookup", "K11 mesh_lookup", "tigerbeetle_tpu_torch/csrc/mesh_lookup.cu",
     "tigerbeetle_tpu/parallel/mesh.py:844"),
    ("K11af", "mesh_commit_accounts_fast", "K11 mesh_commit_accounts fast",
     "tigerbeetle_tpu_torch/csrc/mesh_commit_accounts.cu", "tigerbeetle_tpu/parallel/mesh.py:340"),
    ("K11as", "mesh_commit_accounts_serial", "K11 mesh_commit_accounts serial",
     "tigerbeetle_tpu_torch/csrc/mesh_commit_accounts.cu", "tigerbeetle_tpu/parallel/mesh.py:723"),
    ("K11tf", "mesh_commit_transfers_fast", "K11 mesh_commit_transfers fast",
     "tigerbeetle_tpu_torch/csrc/mesh_commit_transfers.cu",
     "tigerbeetle_tpu/parallel/mesh.py:224"),
    ("K11ts", "mesh_commit_transfers_serial", "K11 mesh_commit_transfers serial",
     "tigerbeetle_tpu_torch/csrc/mesh_serial_transfers.cu",
     "tigerbeetle_tpu/parallel/mesh.py:431"),
]
# the kernels of the paths of phases 7, 8, 9 and 10 alone
DUAL_KERNELS = ("fold",)
QUERY_KERNELS = ("filter_scan",)
SPILL_KERNELS = ("spill_head", "spill_split", "spill_gather", "spill_reload")


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("CUDA is not available: this script runs on a card")
    repo = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(repo, "tigerbeetle_tpu_torch")):
        fail("tigerbeetle_tpu_torch/ is not beside this script")
    sys.path.insert(0, repo)
    from tigerbeetle_tpu_torch import constants, types
    from tigerbeetle_tpu_torch import state_machine as SM
    from tigerbeetle_tpu_torch.kernels import build
    from tigerbeetle_tpu_torch.models import ledger as L
    from tigerbeetle_tpu_torch.ops import hashtable as ht

    dev = torch.device("cuda")
    t_start = time.perf_counter()

    def stage(title):  # a phase's header, with the seconds since the start
        log(f"== {title} [{time.perf_counter() - t_start:.1f} s]")

    stage("phase 1: environment")
    log(f"  python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    card = smi
    log(f"  card: {card}; host machine: {platform.machine()}")
    t0 = time.perf_counter()
    lib = build.build()
    log(f"  kernels built in {time.perf_counter() - t0:.1f} s: {lib}")
    log(f"  K5's SASS: each of its {barriers_invalidate_l1(lib)} cluster barrier waits is "
        "followed by an L1 invalidation (CCTL.IVALL) before any load")
    log(f"  K10r's SASS: each of its {barriers_invalidate_l1(lib, 'reload_chunks')} cluster "
        "barrier waits is followed by an L1 invalidation (CCTL.IVALL) before any load")
    from tigerbeetle_tpu_torch import native

    t0 = time.perf_counter()
    path = native.build()
    log(f"  native engine built in {time.perf_counter() - t0:.1f} s: {path}")
    for line in (lib.parent / "build.log").read_text().splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            log("   ", line.strip())
    for entry, regs, stack, spills in kernel_resources(lib, "acct_commit_fast"):
        log(f"  K2 fast / K11af kernel {entry}: {regs} registers, {stack} bytes stack frame, "
            f"{spills} bytes spilled (stores, loads)")

    from tigerbeetle_tpu_torch import kernels as K

    hbm_ns = load_latency_ns(torch, K, dev, 1 << 30, 1 << 15)
    l2_ns = load_latency_ns(torch, K, dev, 1 << 23, 1 << 15)
    smem_ns = shared_latency_ns(torch, K, dev)
    log(f"  dependent-load latency: {hbm_ns:.1f} ns over 1 GiB, {l2_ns:.1f} ns over 8 MiB, "
        f"{smem_ns:.2f} ns in shared memory [{card}]")
    sector_ms = sector_rates(torch, K, dev, card)

    stage("phase 2: kernels against their plain versions, fault gates (2^14 / 2^16 slots)")
    phase_kernels(torch, L, types, constants, dev)
    phase_seam_kernels(torch, L, types, constants, dev)
    k5_cases(torch, L, constants, dev)
    k9_cases(torch, L, K, constants, dev)
    phase_fold_kernels(torch, L, dev)
    fp_case_kernels(torch, L, K, dev)
    lookup_case_kernels(torch, L, K, dev)
    phase_ledgers(torch, L, types, constants, dev)

    stage("phase 3: main path, StateMachine over DeviceLedger(ConfigProcess()) on cuda")
    sm, tps, g_tps, reqs = phase_main_path(torch, L, SM, types, constants, dev, card)
    snapshot_bodies = phase_snapshot(torch, L, SM, types, constants, dev, sm)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    log(f"  launches on the main path: {launches}")
    if not all(v for k, v in launches.items()
               if k not in DUAL_KERNELS + QUERY_KERNELS + SPILL_KERNELS + MESH_KERNELS):
        fail(f"a kernel was not launched on the main path: {launches}")
    ledger = sm.backend

    stage("phase 8: queries on phase 3's ledger (2^20 / 2^24 slots; run here, before "
        "phases 5 and 6 commit transfers that the query record does not hold)")
    bodies = [b for _k, op, b in reqs if op == types.Operation.create_transfers]
    query_launches, query_errs, k8_row = phase_queries(
        torch, L, types, ledger, bodies + snapshot_bodies, dev, card, sector_ms)
    k8_cases(torch, L, K, dev, query_errs)
    k8_k9_trace(card)
    k5_trace(card)
    digest_trace(card)
    lookup_trace(card)

    stage("phase 4: kernels against their plain versions at the main path's shapes "
        "(2^20 / 2^24 slots)")
    errs = phase_main_shapes(torch, L, types, ledger, dev)

    stage("phase 5: trace of main-path requests")
    phase_trace(torch, SM, types, sm, dev)

    stage("phase 6: kernel times at the main path's shapes (2^20 / 2^24 slots)")
    times = phase_timing(torch, L, ht, types, ledger, dev, hbm_ns, l2_ns, smem_ns, sector_ms)

    stage("phase 7: the dual-commit follower, DualLedger(20, 24) on cuda")
    dual_launches = phase_dual(torch, types, card)

    stage(f"phase 9: the bounded-memory ledger, DeviceLedger(ConfigProcess(20, {SPILL_LOG2}), "
        "forest=...) on cuda against NativeLedger(20, 24)")
    spill_launches, spill_errs, spill_rows = phase_spill(
        torch, L, SM, types, constants, dev, card, ledger.state, ledger.process, sector_ms)
    cycle_trace(card)

    stage("phase 10: the sharded ledger on one card, ShardedLedger(8, ConfigProcess()) on cuda "
        "against NativeLedger(20, 24)")
    del sm, ledger
    torch.cuda.empty_cache()
    from tigerbeetle_tpu_torch.parallel import mesh as M

    mesh_launches, mesh_errs, mesh_times = phase_mesh(
        torch, L, M, SM, ht, types, constants, dev, card, hbm_ns, l2_ns, smem_ns, tps)

    stage("phase 11: the serial account walk (K2 serial, K11as) on its hazard requests at "
        "2^14 and 2^20, its device launches, re-probes and times, in a process of its own")
    errs.update(phase_account_walk(card, smem_ns)["errs"])

    errs.update(query_errs)
    errs.update(spill_errs)
    errs.update(mesh_errs)
    times.update(mesh_times)
    times["K8"] = k8_row
    library = {}
    for key, (kt, pt, b, by, lib) in spill_rows.items():
        times[key] = (kt, pt, b, by)
        library[key] = lib[0] if lib else None
    path_launches = {c: dual_launches for c in DUAL_KERNELS}
    path_launches.update({c: query_launches for c in QUERY_KERNELS})
    path_launches.update({c: spill_launches for c in SPILL_KERNELS})
    path_launches.update({c: mesh_launches for c in MESH_KERNELS})
    table = []
    for key, counter, name, source, replaces in KERNELS:
        (kt, _, _), (pt, _, _), bound_ms, bound_by = times[key]
        err = max(v for k, v in errs.items() if k.startswith(name))
        n = path_launches.get(counter, launches)[counter]
        table.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": n, "max_abs_err": err, "bit_exact": err == 0,
            "ms": kt, "plain_ms": pt, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library.get(key),
        })
    log(f"  main path: {tps:.0f} transfers/s one request at a time, {g_tps:.0f} transfers/s "
        f"in groups of {GROUP_K}; whole run {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
