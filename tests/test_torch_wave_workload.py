"""The port's DeviceLedger and the JAX package's, both `mode="auto"`, on the
same traffic, request by request through StateMachine: the same plans
(decision and wave count), the same reply bytes and the same state
fingerprint. The port's wave path runs K12's CPU route
(`commit_transfers_waves_plain`), the JAX package its `_wave_stepper`.

Traffic: WorkloadGenerator at its default rates (invalid events,
conflicts, chains, two-phase and balancing transfers, 15% limit accounts;
its amounts up to 2^64 and its chains send most requests to the serial
tier), and the payment traffic of a ledger whose accounts are 15% balance
limited (`debits_must_not_exceed_credits`, funded first), in requests of
uniform random accounts with reversed ids: plain transfers; pendings with
their posts and voids in the same request; 20% pendings, half of them
posted or voided in the same request and the rest in the next. These plan
as waves. 2^14 account / 2^16 transfer slots.
"""

import numpy as np
import pytest

import tigerbeetle_tpu  # noqa: F401  (x64 before any input is built)
from tigerbeetle_tpu import state_machine as j_sm
from tigerbeetle_tpu.constants import ConfigProcess as JConfigProcess
from tigerbeetle_tpu.models import ledger as jledger
from tigerbeetle_tpu_torch import state_machine as t_sm
from tigerbeetle_tpu_torch import types
from tigerbeetle_tpu_torch.constants import ConfigProcess
from tigerbeetle_tpu_torch.models import ledger as tledger
from tigerbeetle_tpu_torch.testing.workload import WorkloadGenerator

A_LOG2, T_LOG2 = 14, 16
N_ACCOUNTS = 2000
LIMIT_SHARE = 0.15
B = 2048
Op = types.Operation


def _pair():
    port = t_sm.StateMachine(tledger.DeviceLedger(ConfigProcess(A_LOG2, T_LOG2), mode="auto",
                                                  device="cpu"))
    ref = j_sm.StateMachine(jledger.DeviceLedger(JConfigProcess(A_LOG2, T_LOG2), mode="auto"))
    return port, ref


def _run(port, ref, requests):
    """Each (op, body) through both; returns the port's plans."""
    ts = 10**9
    plans = []
    for i, (op, body) in enumerate(requests):
        ts += len(body) // 128
        hp = port.commit_async(op, ts, body)
        hj = ref.commit_async(op, ts, body)
        plan = port.handle_plan(hp)
        assert plan == ref.handle_plan(hj), i
        assert port.commit_finish(hp) == ref.commit_finish(hj), i
        plans.append(plan)
    assert port.backend.fingerprint() == ref.backend.fingerprint()
    return plans


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


def _payment_requests(kind: str, rng) -> list:
    """Accounts (15% limited), their funding, then `kind`'s transfers."""
    acc = np.zeros(N_ACCOUNTS, dtype=types.ACCOUNT_DTYPE)
    acc["id_lo"] = np.arange(1, N_ACCOUNTS + 1)
    acc["ledger"] = acc["code"] = 1
    limited = rng.random(N_ACCOUNTS) < LIMIT_SHARE
    acc["flags"][limited] = int(types.AccountFlags.debits_must_not_exceed_credits)
    lim = acc["id_lo"][limited]
    reqs = [(Op.create_accounts, acc.tobytes())]
    fund = _transfers(np.arange(10**6, 10**6 + len(lim)), N_ACCOUNTS, lim, 10**6)
    reqs.append((Op.create_transfers, fund.tobytes()))
    next_id = [2 * 10**6]

    def pairs(n):
        dr = rng.integers(1, N_ACCOUNTS, n)
        cr = 1 + (dr - 1 + rng.integers(1, N_ACCOUNTS - 1, n)) % (N_ACCOUNTS - 1)
        return dr, cr

    def ids(n):  # reversed, as the reference benchmark sends them
        first = next_id[0]
        next_id[0] += n
        return np.arange(first + n - 1, first - 1, -1)

    def amounts(n):
        return rng.integers(1, 1000, n)

    if kind == "uniform":
        for _ in range(2):
            dr, cr = pairs(B)
            reqs.append((Op.create_transfers, _transfers(ids(B), dr, cr, amounts(B)).tobytes()))
    elif kind == "same_request_posts":
        h = B // 2
        dr, cr = pairs(h)
        pend = _transfers(ids(h), dr, cr, amounts(h), flags=2)
        pv = _transfers(ids(h), 0, 0, 0, flags=np.where(np.arange(h) % 2, 4, 8),
                        pending_id=pend["id_lo"])
        reqs.append((Op.create_transfers, np.concatenate([pend, pv]).tobytes()))
    else:  # 20% pendings: half resolved in their request, the rest in the next
        carry = np.zeros(0, dtype=np.uint64)
        for _ in range(3):
            n_pend = B // 5
            dr, cr = pairs(B - n_pend // 2 - len(carry))
            t = _transfers(ids(len(dr)), dr, cr, amounts(len(dr)))
            t["flags"][:n_pend] = 2
            pend = t["id_lo"][:n_pend]
            now, later = pend[: n_pend // 2], pend[n_pend // 2:]
            res = np.concatenate([now, carry])
            pv = _transfers(ids(len(res)), 0, 0, 0,
                            flags=np.where(np.arange(len(res)) % 2, 4, 8), pending_id=res)
            body = np.concatenate([t, pv])
            reqs.append((Op.create_transfers, body[rng.permutation(len(body))].tobytes()))
            carry = later
    return reqs


@pytest.mark.parametrize("kind", ["uniform", "same_request_posts", "pendings_20"])
def test_auto_ledgers_agree_on_payment_traffic(kind):
    rng = np.random.default_rng(["uniform", "same_request_posts", "pendings_20"].index(kind))
    plans = _run(*_pair(), _payment_requests(kind, rng))
    waves = [p[1] for p in plans[2:] if p[0] == "waves"]
    assert len(waves) == len(plans) - 2 and max(waves) >= 2, plans


def test_auto_ledgers_agree_on_workload_generator_traffic():
    """WorkloadGenerator at its default rates: two account requests, then
    three transfer requests of 64 events (the serial tier and the waves)."""
    gen = WorkloadGenerator(18)
    reqs = []
    for i in range(5):
        if i < 2:
            op, events = gen.gen_accounts_batch(64)
            reqs.append((op, types.accounts_to_np(events).tobytes()))
        else:
            op, events = gen.gen_transfers_batch(64)
            reqs.append((op, types.transfers_to_np(events).tobytes()))
    _run(*_pair(), reqs)
