"""The serial account commit's plain versions against the JAX package on the
hazard requests of its plan-and-walk kernels, bit for bit, and a model of
the walk's re-probe rule against those plain versions.

K2 serial (csrc/commit_accounts.cu) and K11as (csrc/mesh_commit_accounts.cu)
run csrc/account_walk.cuh: a plan of every event against the table as it
was before the batch, then one warp that walks the events in order and
resolves an event again only where a row the batch wrote (an insert or a
rollback tombstone, kept in a bitmap) lies in its probe window at or before
`stop`, the last position its answers depend on. The requests of
tigerbeetle_tpu_torch/testing/hazards.py (ACCOUNT_CASES) aim at that rule:
an insert at a later event's stop, live and rolled-back duplicates, a
rollback's tombstone at another id's stop, a window filled by the batch
(FAULT_SERIAL, the last-probe quirk), tombstones before the batch and the
empty and tombstone keys, a chain open at the end, chains across the walk's
groups of 32, a tripped entry gate, events past n. Each goes through:

- the single table: `models/ledger.py` commit_accounts_serial_plain against
  the JAX `LedgerKernels._serial_accounts` (commit_accounts, mode serial);
- the sharded ledger: `parallel/mesh.py` commit_accounts_serial_plain
  against the JAX `ShardedLedgerKernels._commit_accounts_serial` on the
  conftest's 8-device CPU mesh;
- `walk_model` below, the kernels' rule in plain Python (plan on the
  pre-batch table, a bitmap of the batch's writes, re-probe on a set bit at
  a position <= stop), against the plain version on both tables, at the
  kernels' bitmap size and at a 64-bit one that aliases almost every row.

Codes, the fault word, the counters and every table row but the dump row
must be equal (tolerance zero), and each request must show its hazard.
chip_smoke.py holds the kernels against their plain versions on the same
requests on the card.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tigerbeetle_tpu  # noqa: F401  (x64 before any input is built)
from tests.test_torch_ledger import assert_state_equal as assert_single_equal
from tests.test_torch_mesh import assert_state_equal as assert_mesh_equal
from tests.test_torch_mesh import jax_ledger, mesh  # noqa: F401  (the mesh fixture)
from tigerbeetle_tpu.constants import ConfigProcess as JConfigProcess
from tigerbeetle_tpu.models import ledger as jledger
from tigerbeetle_tpu.types import Account as JAccount
from tigerbeetle_tpu.types import Operation
from tigerbeetle_tpu_torch import convert, types
from tigerbeetle_tpu_torch.models import ledger as tledger
from tigerbeetle_tpu_torch.models import validate
from tigerbeetle_tpu_torch.ops import hashtable as ht
from tigerbeetle_tpu_torch.parallel import mesh as tmesh
from tigerbeetle_tpu_torch.testing import hazards as H

S = 8
A_LOG2 = 12
J_PROCESS = JConfigProcess(account_slots_log2=A_LOG2, transfer_slots_log2=12)
SEED = 2025
TS = 10**12
N_PAD = 128  # the longest request holds 100 events
W = ht.WINDOW_SCALAR
FAULT_SERIAL, FAULT_CAPACITY = 8, 16
# the cases whose events the walk model must re-probe (on both tables)
REPROBED = {"shared_window", "dup_live", "dup_after_rollback", "rollback_frees_window",
            "window_full", "tomb_window", "chains_across_groups"}


def _accounts():
    return [JAccount(**dataclasses.asdict(a)) for a in H.hazard_accounts()]


@pytest.fixture(scope="module")
def single_base():
    led = jledger.DeviceLedger(process=J_PROCESS, mode="auto")
    assert led.execute_dense(Operation.create_accounts, 10_000, _accounts()) == [0] * 32
    return {k: np.array(v) for k, v in led.state.items()}


@pytest.fixture(scope="module")
def mesh_base(mesh):  # noqa: F811
    led = jax_ledger(mesh, J_PROCESS)
    assert led.execute_dense(Operation.create_accounts, 10_000, _accounts()) == [0] * 32
    return led, {k: np.array(v) for k, v in led.state.items()}


def _request(base_np, case, n_shards):
    """The case's request (rows padded to N_PAD, uint32) and a copy of
    `base_np` prepared as it assumes."""
    hz = H.account_hazard_request(case, np.random.default_rng(SEED), A_LOG2, n_shards)
    st = {k: v.copy() for k, v in base_np.items()}
    H.prepare_account_hazard(st["acct_rows"], st["acct_used_slots"], hz,
                             np.random.default_rng(SEED + 1))
    return hz, st, jledger._to_rows_np(types.accounts_to_np(hz.events), N_PAD)


def _check_hazard(case, hz, codes, fault):
    """The reference's codes and fault word show the hazard the case aims at."""
    codes = [int(c) for c in codes]
    assert not any(codes[hz.n:])
    want_fault = {"window_full": FAULT_SERIAL, "gate_tripped": FAULT_CAPACITY}.get(case, 0)
    assert int(fault) == want_fault
    want = {
        "shared_window": [17, 21],
        "dup_live": [21, 15, 20, 1, 21],
        "dup_after_rollback": [1, 1, 13, 21],
        "rollback_frees_window": [1, 1, 13, 21],
        "window_full": [1, 1, 13, 21],
        "tomb_window": [6, 7, 16, 1, 21],
        "chain_open_at_end": [1, 1, 2],
        "chains_across_groups": [1] * 25 + [13] + [1] * 21 + [2],
        "gate_tripped": [],
        "pad_past_n": [],
    }[case]
    assert [c for c in codes[:hz.n] if c] == want


def _single_jax(st, rows, n):
    kern = jledger.get_kernels(J_PROCESS)
    js = {k: jnp.asarray(v) for k, v in st.items()}
    js, jr = kern.commit_accounts(js, {"rows": jnp.asarray(rows)}, jnp.int32(n), jnp.uint64(TS),
                                  mode="serial")
    return {k: np.asarray(v) for k, v in js.items()}, np.asarray(jr)


@pytest.mark.parametrize("case", H.ACCOUNT_CASES)
def test_single_table_account_hazard(single_base, case):
    hz, st, rows = _request(single_base, case, 1)
    js, jr = _single_jax(st, rows, hz.n)
    pst = convert.state_from_numpy(st, "cpu")
    pr = tledger.commit_accounts_serial_plain(pst, torch.from_numpy(rows.view(np.int32)), hz.n,
                                              TS, A_LOG2)
    np.testing.assert_array_equal(pr.numpy().view(np.uint32), jr)
    assert_single_equal(js, pst)
    _check_hazard(case, hz, jr, js["fault"])


@pytest.mark.parametrize("case", H.ACCOUNT_CASES)
def test_sharded_account_hazard(mesh_base, case):
    led, base_np = mesh_base
    hz, st, rows = _request(base_np, case, S)
    jstate = {k: jax.device_put(v, led.state[k].sharding) for k, v in st.items()}
    jstate, jr = led.kernels.commit_accounts_serial(jstate, {"rows": jnp.asarray(rows)},
                                                    jnp.int32(hz.n), jnp.uint64(TS))
    pst = convert.state_from_numpy(st, "cpu")
    pr = tmesh.commit_accounts_serial_plain(pst, torch.from_numpy(rows.view(np.int32)), hz.n,
                                            TS, A_LOG2)
    jr = np.asarray(jr)
    np.testing.assert_array_equal(pr.numpy().view(np.uint32), jr)
    assert_mesh_equal(jstate, pst)
    _check_hazard(case, hz, jr, np.asarray(jstate["fault"]))


# ----------------------------------------------------------------------
# the plan/stale rule of csrc/account_walk.cuh, in plain Python
# ----------------------------------------------------------------------


def _decide(keys, key):
    """(first hit of a probeable key, first empty, first free) of a window's
    keys [64, 4], W where there is none (warp_window.cuh win_index)."""
    probeable = not (key == 0).all() and not (key == -1).all()
    hit = (keys == key).all(1) & probeable
    emp = (keys == 0).all(1)
    fre = emp | (keys == -1).all(1)
    return tuple(int(np.argmax(m)) if m.any() else W for m in (hit, emp, fre))


def walk_model(st, rows_b, n, timestamp, a_log2, bits_log2=None):
    """Commit `rows_b` (int32 torch [B, 32]) into the port's state `st` (CPU
    tensors, one table or sharded) as the kernels do: every event planned
    against the table before the batch, then walked in order, its plan
    replaced by a lookup on the table as it stands only where the bitmap of
    the batch's writes (global row mod 2^bits_log2; by default the kernels'
    size) has a bit at one of its window positions 0 .. stop. Returns
    (codes int32 [B], the events re-probed)."""
    T = st["acct_rows"].numpy()
    T = T if T.ndim == 3 else T[None]
    n_shards, R = T.shape[:2]
    used = st["acct_used_slots"].reshape(-1)
    fault0 = int(st["fault"])
    if any(int(u) + n > (1 << a_log2) // 2 for u in used):
        fault0 |= FAULT_CAPACITY
    n = 0 if fault0 else n
    if bits_log2 is None:
        bits_log2 = min(20, max(7, (n_shards * R - 1).bit_length()))
    bmask = (1 << bits_log2) - 1
    key4 = rows_b[:, :4]
    owner = (tmesh.owner_of_key4(key4, n_shards).numpy() if n_shards > 1
             else np.zeros(len(key4), dtype=np.int64))
    pos = ht.probe_positions(key4, a_log2, W).numpy()
    keys = key4.numpy()
    e_all = tledger.unpack_account(rows_b)
    zero = tledger.unpack_account(torch.zeros((1, 32), dtype=torch.int32))

    def code(i, row, found):
        ex = tledger.unpack_account(torch.from_numpy(row[None].copy())) if found else zero
        return int(validate.validate_create_account(torch.zeros(1, dtype=torch.int64),
                                                    tledger._lane(e_all, i), ex,
                                                    torch.tensor([found])))

    def resolve(i):
        sh = int(owner[i])
        h, e, f = _decide(T[sh, pos[i], :4], keys[i])
        found = h < e
        return {"found": found, "resolved": found or e < W,
                "stop": h if found else min(e, W - 1), "free": min(f, W - 1),
                "free_ok": f < W, "code": code(i, T[sh, pos[i, h]] if found else None, found)}

    plan = [resolve(i) for i in range(n)]  # nothing written yet
    bits = set()
    results = np.zeros(len(rows_b), dtype=np.int32)
    undo = [0] * n
    applied = [0] * n_shards
    chain_start, broken, probe_bad = -1, False, False
    cts, ok_n, reprobes = int(st["commit_ts"]), 0, 0
    for i in range(n):
        sh = int(owner[i])
        flags = int(e_all["flags"][i])
        linked = bool(flags & 1)
        if linked and chain_start < 0:
            chain_start = i
        in_chain = chain_start >= 0
        r0 = (2 if in_chain and i == n - 1 and linked else 1 if broken
              else 3 if int(e_all["ts"][i]) != 0 else 0)
        p = plan[i]
        if any((sh * R + int(q)) & bmask in bits for q in pos[i, :p["stop"] + 1]):
            p = resolve(i)
            reprobes += 1
        r = r0 or p["code"]
        ok = r == 0
        probe_bad |= not p["resolved"] or (ok and not p["free_ok"])
        slot = sh * R + int(pos[i, p["free"]])
        undo[i] = slot
        if ok:
            ts = timestamp - n + i + 1
            if p["free_ok"]:
                row = rows_b[i].numpy().copy()
                row[30:32] = np.array([ts], dtype=np.uint64).view(np.int32)
                T[slot // R, slot % R] = row
                bits.add(slot & bmask)
            cts = ts
            ok_n += 1
            applied[sh] += 1
        if r != 0 and in_chain and not broken:
            for k in range(chain_start, i):
                T[undo[k] // R, undo[k] % R] = -1
                bits.add(undo[k] & bmask)
                results[k] = 1
            ok_n -= i - chain_start
            broken = True
        results[i] = r
        if in_chain and (not linked or r == 2):
            chain_start, broken = -1, False
    st["commit_ts"].fill_(cts)
    st["acct_count"] += ok_n
    st["acct_used_slots"] += torch.tensor(applied).reshape(st["acct_used_slots"].shape)
    st["fault"].fill_(fault0 | (FAULT_SERIAL if probe_bad else 0))
    return results, reprobes


def _model_against_plain(st_np, rows, n, plain, bits_log2):
    rows_t = torch.from_numpy(rows.view(np.int32))
    sm = convert.state_from_numpy(st_np, "cpu")
    codes, reprobes = walk_model(sm, rows_t, n, TS, A_LOG2, bits_log2)
    sp = convert.state_from_numpy(st_np, "cpu")
    want = plain(sp, rows_t, n, TS, A_LOG2)
    np.testing.assert_array_equal(codes, want.numpy())
    got, ref = convert.state_to_numpy(sm), convert.state_to_numpy(sp)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    return reprobes


@pytest.mark.parametrize("bits_log2", [None, 6], ids=["kernel_bitmap", "aliased_bitmap"])
@pytest.mark.parametrize("case", H.ACCOUNT_CASES)
def test_walk_model_single_table(single_base, case, bits_log2):
    hz, st, rows = _request(single_base, case, 1)
    reprobes = _model_against_plain(st, rows, hz.n, tledger.commit_accounts_serial_plain,
                                    bits_log2)
    if bits_log2 is None:
        assert (reprobes > 0) == (case in REPROBED)


@pytest.mark.parametrize("bits_log2", [None, 6], ids=["kernel_bitmap", "aliased_bitmap"])
@pytest.mark.parametrize("case", H.ACCOUNT_CASES)
def test_walk_model_sharded(mesh_base, case, bits_log2):
    _, base_np = mesh_base
    hz, st, rows = _request(base_np, case, S)
    reprobes = _model_against_plain(st, rows, hz.n, tmesh.commit_accounts_serial_plain,
                                    bits_log2)
    if bits_log2 is None:
        assert (reprobes > 0) == (case in REPROBED)
