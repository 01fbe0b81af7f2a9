"""The port's change stream against the JAX package's, byte for byte.

One replica of each package's `Cluster` over its DeviceLedger (the port's on
the CPU: the kernels' plain versions) takes the same requests: accounts,
some balance-limited and funded, then requests that plan as conflict waves
(pendings posted and voided in the same request, a limited account debited
in a chain until its credits run out, a duplicate id) and one with a linked
chain (a serial residue). A `CdcPump` of each package tails its replica into
a `MemorySink`: the JSONL lines must be equal. Each replica also writes an
AOF; the `cdc` command of each package replays either AOF to the same lines.
"""

import json

import numpy as np

import tigerbeetle_tpu  # noqa: F401  (x64 before any input is built)
from tigerbeetle_tpu import aof as j_aof
from tigerbeetle_tpu import cdc as j_cdc
from tigerbeetle_tpu import cli as j_cli
from tigerbeetle_tpu.testing.cluster import Cluster as JCluster
from tigerbeetle_tpu_torch import aof as t_aof
from tigerbeetle_tpu_torch import cdc as t_cdc
from tigerbeetle_tpu_torch import cli as t_cli
from tigerbeetle_tpu_torch import types
from tigerbeetle_tpu_torch.models import ledger as tledger
from tigerbeetle_tpu_torch.testing.cluster import Cluster as TCluster

Op = types.Operation
N_ACCOUNTS = 40
LIMITED = (3, 4, 5, 6)


def _transfers(ids, dr, cr, amount, flags=0, pending_id=0):
    t = np.zeros(len(ids), dtype=types.TRANSFER_DTYPE)
    t["id_lo"] = ids
    t["debit_account_id_lo"] = dr
    t["credit_account_id_lo"] = cr
    t["amount_lo"] = amount
    t["ledger"] = np.where(np.asarray(pending_id) != 0, 0, 1)
    t["code"] = t["ledger"]
    t["flags"] = flags
    t["pending_id_lo"] = pending_id
    return t


def _requests() -> list:
    rng = np.random.default_rng(18)
    acc = np.zeros(N_ACCOUNTS, dtype=types.ACCOUNT_DTYPE)
    acc["id_lo"] = np.arange(1, N_ACCOUNTS + 1)
    acc["ledger"] = acc["code"] = 1
    acc["flags"][np.array(LIMITED) - 1] = int(types.AccountFlags.debits_must_not_exceed_credits)
    reqs = [(Op.create_accounts, acc)]
    reqs.append((Op.create_transfers, _transfers(np.arange(100, 104), N_ACCOUNTS,
                                                 LIMITED, 50)))
    pend = _transfers(np.arange(200, 216), rng.integers(7, 20, 16), rng.integers(20, 39, 16),
                      rng.integers(1, 100, 16), flags=2)
    pv = _transfers(np.arange(300, 316), 0, 0, 0, flags=np.where(np.arange(16) % 2, 4, 8),
                    pending_id=pend["id_lo"])
    reqs.append((Op.create_transfers, np.concatenate([pend, pv])))
    chain = _transfers(np.arange(400, 412), 3, 8, 10)  # 50 of credit: the 6th fails
    plain = _transfers(np.arange(500, 520), rng.integers(7, 20, 20), rng.integers(20, 39, 20),
                       rng.integers(1, 100, 20))
    dup = _transfers([500], 9, 10, 1)
    reqs.append((Op.create_transfers, np.concatenate([chain, plain, dup])))
    linked = _transfers(np.arange(600, 606), 11, 12, 5, flags=np.array([1, 1, 0, 1, 0, 0]))
    linked["amount_lo"][4] = 0  # breaks the second chain
    reqs.append((Op.create_transfers, np.concatenate([linked, plain[:4].copy()])))
    reqs[-1][1]["id_lo"][6:] = np.arange(700, 704)
    return [(op, arr.tobytes()) for op, arr in reqs]


def _stream(pkg_cluster, cdc, aof_mod, aof_path, backend_kw):
    cl = pkg_cluster(replica_count=1, **backend_kw)
    r = cl.replicas[0]
    r.aof = aof_mod.AOF(aof_path)
    sink = cdc.MemorySink()
    pump = cdc.CdcPump(r, sink, cdc.MemoryCursor())
    pump.attach()
    c = cl.add_client()
    replies, plans = [], []
    for op, body in _requests():
        _h, reply = cl.execute(c, op, body)
        replies.append(reply)
        while pump.pump(budget_ops=8):
            pass
    while pump.pump(budget_ops=8):
        pass
    r.aof.close()
    return sink.lines, replies, r


def test_port_stream_equals_jax_stream_and_replays_across_packages(tmp_path):
    t_lines, t_replies, t_rep = _stream(TCluster, t_cdc, t_aof, str(tmp_path / "t.aof"),
                                        {"device": "cpu"})
    j_lines, j_replies, _ = _stream(JCluster, j_cdc, j_aof, str(tmp_path / "j.aof"), {})
    assert t_replies == j_replies
    assert t_lines == j_lines
    assert len(t_lines) > 80
    assert t_rep.ledger.hazards.plan_stats["waves"] >= 2  # the wave path ran
    # every result of the chain request's records as its request gave it
    assert {json.loads(line)["kind"] for line in t_lines} >= {"transfer"}
    for src in ("t", "j"):
        for name, main in (("t", t_cli.main), ("j", j_cli.main)):
            out = str(tmp_path / f"{src}_by_{name}.jsonl")
            rc = main(["cdc", "--sink", f"jsonl:{out}",
                       "--cursor", str(tmp_path / f"{src}_by_{name}.cursor"),
                       str(tmp_path / f"{src}.aof")])
            assert rc == 0
            assert open(out).read().splitlines() == t_lines, (src, name)


def test_wave_requests_plan_as_waves():
    """The requests above plan as the stream test needs: the same-request
    posts and the limited chain as waves, the linked request with a
    residue."""
    tr = tledger.HazardTracker()
    tr.note_limit_accounts(np.frombuffer(_requests()[0][1], dtype=types.ACCOUNT_DTYPE))
    plans = []
    for op, body in _requests()[1:]:
        arr = np.frombuffer(body, dtype=types.TRANSFER_DTYPE)
        plans.append(tr.plan(arr))
        tr.note_pending(arr)
    assert plans[1][0] == "waves" and plans[1][1].n_waves >= 2 and plans[1][1].has_pv
    assert plans[2][0] == "waves" and plans[2][1].n_waves >= 5
    assert plans[3][0] in ("waves", "serial")
