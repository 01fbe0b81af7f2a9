"""Groups of k batch slots for the group commit (K5), each aimed at the order
of its slots.

K5 runs the fast commit of slot 0, then slot 1, and so on, in one launch;
slot i must see the state slot i - 1 left, also where another SM of the
cluster wrote it (a read through a stale L1 line would not). Each case makes
a stale read or a wrong slot order change a code, a slot placement or the
fault word:

- `reuse_id`: slot j + 1 repeats events that slot j inserted (code
  `exists`), and reuses slot j's ids with other amounts
  (`exists_with_different_amount`);
- `limit_crossed`: account 1 must not have debits above its credits; slot
  j - 1 credits it 1000, slot j debits it 990, slot j + 1 debits it 20, 10
  and 11 (`exceeds_credits`, ok, `exceeds_credits`);
- `window_fill`: slot j inserts four ids that share a first probe position
  (found with the port's probe functions), slot j + 1 two more: where they
  land depends on the slots slot j took;
- `padding`: padding slots (n = 0) in the middle and at the end;
- `all_fail`: every lane of slot j fails (its debit account does not
  exist), so no lane wants a claim;
- `capacity`: slots 0 and 1 are all valid and fill the table to its load
  limit, so slot 2 trips the capacity gate and every later slot is a no-op;
- `sticky_before`: the fault word is set before the group: every slot is a
  no-op, its codes are still written.

Every other lane carries random traffic between accounts 3-48 (some of it
failing), its count of valid events kept within the table's load limit.
The case's own events sit in the lanes [HOT_BASE, HOT_BASE + 64) of a slot
of 8192 (one block of the cluster validates them, others apply them), else
in the first 64.

`group_case(name, k, n_pad, t_log2, rng)` returns a dict: `accounts` (the
48 accounts, ACCOUNT_DTYPE), `rows` ([k, n_pad, 32] int32: the staged
slots), `ns` (int32 [k]), `tss` (u64 timestamps, a list), `xfer_used` and
`fault` (values to set in the state before the group, or None), `expect`
([(slot, lane, code)] that the case is built to give; code None: any
failure) and `fault_after`
(the fault word the group must end with). `base_state(case, process,
device)` commits the accounts (and sets the words) with the plain versions
on the CPU and moves the state to `device`. The tests hold the plain
version against the JAX package on these cases; `chip_smoke.py` holds the
kernel against its plain version on them.
"""

from __future__ import annotations

import numpy as np

from tigerbeetle_tpu_torch import types
from tigerbeetle_tpu_torch.testing import install_cases

CASES = ("reuse_id", "limit_crossed", "window_fill", "padding", "all_fail", "capacity",
         "sticky_before")
N_ACCOUNTS = 48
HOT = 64  # lanes a case's own events may use
HOT_BASE = 5120  # in slots of 8192 lanes: the lanes block 10 of the cluster validates
T0 = 10**9  # the accounts' timestamp; the slots' come after it
LIMIT_ACCOUNT = 1
CODE = types.CreateTransferResult


def _hot_base(n_pad: int) -> int:
    return HOT_BASE if n_pad >= HOT_BASE + HOT else 0


def _accounts() -> np.ndarray:
    a = np.zeros(N_ACCOUNTS, dtype=types.ACCOUNT_DTYPE)
    a["id_lo"] = np.arange(1, N_ACCOUNTS + 1)
    a["ledger"] = 1
    a["code"] = 1
    a["flags"][LIMIT_ACCOUNT - 1] = types.AccountFlags.debits_must_not_exceed_credits
    return a


def _transfers(ids, dr, cr, amount) -> np.ndarray:
    t = np.zeros(len(ids), dtype=types.TRANSFER_DTYPE)
    ids = np.asarray(ids, dtype=np.uint64)
    t["id_lo"] = ids
    t["debit_account_id_lo"] = dr
    t["credit_account_id_lo"] = cr
    t["amount_lo"] = amount
    t["ledger"] = 1
    t["code"] = 1
    return t


def _filler(rng, n: int, ids, p_valid: float) -> np.ndarray:
    """Random traffic between accounts 3..48; a lane fails with probability
    1 - p_valid (a zero amount, a missing debit account or one account on
    both sides)."""
    dr = rng.integers(3, N_ACCOUNTS + 1, n)
    cr = 3 + (dr - 3 + rng.integers(1, N_ACCOUNTS - 2, n)) % (N_ACCOUNTS - 2)
    t = _transfers(ids, dr, cr, rng.integers(1, 1000, n))
    bad = np.nonzero(rng.random(n) >= p_valid)[0]
    kind = rng.integers(0, 3, len(bad))
    t["amount_lo"][bad[kind == 0]] = 0
    t["debit_account_id_lo"][bad[kind == 1]] = 10**9
    t["credit_account_id_lo"][bad[kind == 2]] = t["debit_account_id_lo"][bad[kind == 2]]
    return t


def group_case(name: str, k: int, n_pad: int, t_log2: int, rng) -> dict:
    """The slots, counts, timestamps and state words of case `name` with k
    slots of n_pad lanes at 2^t_log2 transfer slots."""
    if name not in CASES:
        raise ValueError(f"unknown group case {name!r}")
    if k < 4 or n_pad < HOT:
        raise ValueError(f"group cases need k >= 4 and n_pad >= {HOT}")
    half = (1 << t_log2) // 2
    n = n_pad - 2
    j = 1 if k == 4 else 6  # the slot a case's pair starts at
    ns = np.full(k, n, dtype=np.int32)
    if name == "padding":
        ns[[1, k - 1] if k == 4 else [3, 7, 8, k - 1]] = 0
    # valid filler events over the group stay within a third of the limit
    p_valid = min(1.0, half / 3 / max(1, int(ns.sum())))
    next_id = [1 + int(rng.integers(0, 1 << 20)) * 64]

    def fresh(m):
        ids = np.arange(next_id[0], next_id[0] + m, dtype=np.uint64)
        next_id[0] += m
        return ids

    slots = [_filler(rng, int(ns[s]), fresh(int(ns[s])), p_valid) for s in range(k)]
    base = _hot_base(n_pad)
    hot = base + rng.permutation(min(HOT, n))  # the case's lanes, in random order
    expect = []
    xfer_used = fault = None
    fault_after = 0

    def put(slot, lane, t):
        slots[slot][lane] = t[0]

    if name == "reuse_id":
        other = hot[20:30]
        slots[j]["amount_lo"][hot[:30]] = rng.integers(1, 1000, 30)
        slots[j]["debit_account_id_lo"][hot[:30]] = 3
        slots[j]["credit_account_id_lo"][hot[:30]] = 4
        for a, b in zip(hot[:20], hot[30:50]):
            slots[j + 1][b] = slots[j][a]
            expect.append((j + 1, int(b), int(CODE.exists)))
        for a, b in zip(other, hot[50:60]):
            slots[j + 1][b] = slots[j][a]
            slots[j + 1]["amount_lo"][b] = slots[j]["amount_lo"][a] + 1
            expect.append((j + 1, int(b), int(CODE.exists_with_different_amount)))
    elif name == "limit_crossed":
        put(j - 1, hot[0], _transfers(fresh(1), [3], [LIMIT_ACCOUNT], [1000]))
        put(j, hot[1], _transfers(fresh(1), [LIMIT_ACCOUNT], [4], [990]))
        for lane, amount, code in ((hot[2], 20, CODE.exceeds_credits), (hot[3], 10, CODE.ok),
                                   (hot[4], 11, CODE.exceeds_credits)):
            put(j + 1, lane, _transfers(fresh(1), [LIMIT_ACCOUNT], [5], [amount]))
            expect.append((j + 1, int(lane), int(code)))
        expect += [(j - 1, int(hot[0]), 0), (j, int(hot[1]), 0)]  # no filler lane uses it
    elif name == "window_fill":
        (grp,) = install_cases._groups(t_log2, 6, False, 1, start=1 << 40)
        for lane, id_ in zip(hot[:4], grp[:4]):
            put(j, lane, _transfers([id_], [3], [4], [7]))
            expect.append((j, int(lane), 0))
        for lane, id_ in zip(hot[4:6], grp[4:]):
            put(j + 1, lane, _transfers([id_], [5], [6], [9]))
            expect.append((j + 1, int(lane), 0))
    elif name == "all_fail":
        slots[j]["debit_account_id_lo"] = 10**9
        expect += [(j, int(i), None) for i in range(n)]  # None: any failure
    elif name == "capacity":
        for s in (0, 1):  # all valid: n ok events each
            slots[s] = _filler(rng, n, fresh(n), 1.0)
        slots[2]["amount_lo"][hot[0]] = 5  # at least one ok event in slot 2
        slots[2]["debit_account_id_lo"][hot[0]] = 3
        slots[2]["credit_account_id_lo"][hot[0]] = 4
        xfer_used = half - 2 * n
        if xfer_used < 0:
            raise ValueError(f"two slots of {n} do not fit under 2^{t_log2} slots")
        fault_after = 16  # FAULT_CAPACITY
    elif name == "sticky_before":
        fault = 8  # FAULT_SERIAL, from an earlier batch
        fault_after = fault
    rows = np.zeros((k, n_pad, 32), dtype=np.int32)
    for s in range(k):
        rows[s, :ns[s]] = np.ascontiguousarray(slots[s][:ns[s]]).view(np.int32).reshape(-1, 32)
    tss = [T0 + 10 * N_ACCOUNTS + (s + 1) * 4 * n_pad for s in range(k)]
    return {"accounts": _accounts(), "rows": rows, "ns": ns, "tss": tss, "xfer_used": xfer_used,
            "fault": fault, "expect": expect, "fault_after": fault_after}


def base_state(case: dict, process, device) -> dict:
    """The ledger's state before the group: the case's accounts committed by
    the plain versions on the CPU, the case's words set, on `device`."""
    from tigerbeetle_tpu_torch.models import ledger as L

    led = L.DeviceLedger(process, device="cpu")
    codes = led.execute_dense(types.Operation.create_accounts, T0, case["accounts"])
    if any(codes):
        raise RuntimeError(f"the group case's accounts failed: {codes}")
    st = led.state
    if case["xfer_used"] is not None:
        st["xfer_used_slots"].fill_(case["xfer_used"])
    if case["fault"] is not None:
        st["fault"].fill_(case["fault"])
    return {k: v.to(device) for k, v in st.items()}
