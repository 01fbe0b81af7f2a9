"""The PyTorch port's word layer against the JAX package, bit for bit.

Inputs are made with numpy from fixed seeds and go through the JAX function
and its counterpart in tigerbeetle_tpu_torch (the plain PyTorch versions, on
the CPU). Everything is integer: the tolerance is zero.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tigerbeetle_tpu  # noqa: F401  (turns on x64 before any input is built)
from tigerbeetle_tpu.models import ledger as jledger
from tigerbeetle_tpu.models import validate as jvalidate
from tigerbeetle_tpu.ops import hashtable as jht
from tigerbeetle_tpu.ops import u128 as ju128
from tigerbeetle_tpu_torch.models import ledger as tledger
from tigerbeetle_tpu_torch.models import validate as tvalidate
from tigerbeetle_tpu_torch.ops import hashtable as tht
from tigerbeetle_tpu_torch.ops import u128 as tu128

EDGES = [0, 1, 2, (1 << 32) - 1, 1 << 32, (1 << 63) - 1, 1 << 63, (1 << 64) - 2, (1 << 64) - 1]


def t64(a: np.ndarray):
    """u64 numpy -> the port's int64 tensor with the same bits."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint64).view(np.int64))


def t32(a: np.ndarray):
    """u32 numpy -> the port's int32 tensor with the same bits."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32))


def u64(t) -> np.ndarray:
    return t.numpy().astype(np.int64).view(np.uint64)


def _edge_operands():
    combos = np.array(list(itertools.product(EDGES, repeat=4)), dtype=np.uint64)
    return combos[:, 0], combos[:, 1], combos[:, 2], combos[:, 3]


@pytest.mark.parametrize("name", [
    "add", "sub", "sat_sub", "eq", "lt", "gt", "le", "min_", "sum_overflows",
])
def test_u128_binary_ops_on_edge_words(name):
    a_lo, a_hi, b_lo, b_hi = _edge_operands()
    want = getattr(ju128, name)(*(jnp.asarray(x) for x in (a_lo, a_hi, b_lo, b_hi)))
    got = getattr(tu128, name)(*(t64(x) for x in (a_lo, a_hi, b_lo, b_hi)))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        w = np.asarray(w)
        g = u64(g) if g.dtype == torch.int64 else g.numpy()
        np.testing.assert_array_equal(g, w)


def test_u128_unary_select_and_u64_ops_on_edge_words():
    a_lo, a_hi, b_lo, b_hi = _edge_operands()
    for name in ("is_zero", "is_max"):
        np.testing.assert_array_equal(
            getattr(tu128, name)(t64(a_lo), t64(a_hi)).numpy(),
            np.asarray(getattr(ju128, name)(jnp.asarray(a_lo), jnp.asarray(a_hi))),
        )
    pred = (a_lo & np.uint64(1)) == 1
    want = ju128.select(jnp.asarray(pred), *(jnp.asarray(x) for x in (a_lo, a_hi, b_lo, b_hi)))
    got = tu128.select(torch.from_numpy(pred), *(t64(x) for x in (a_lo, a_hi, b_lo, b_hi)))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(u64(g), np.asarray(w))
    want = ju128.add_u64(jnp.asarray(a_lo), jnp.asarray(a_hi), jnp.asarray(b_lo))
    got = tu128.add_u64(t64(a_lo), t64(a_hi), t64(b_lo))
    for w, g in zip(want, got):
        g = u64(g) if g.dtype == torch.int64 else g.numpy()
        np.testing.assert_array_equal(g, np.asarray(w))
    np.testing.assert_array_equal(
        tu128.sum_overflows_u64(t64(a_lo), t64(b_lo)).numpy(),
        np.asarray(ju128.sum_overflows_u64(jnp.asarray(a_lo), jnp.asarray(b_lo))),
    )


def _keys(rng, n):
    k = rng.integers(0, 1 << 32, (n, 4), dtype=np.uint64).astype(np.uint32)
    k[0] = 0
    k[1] = 0xFFFFFFFF
    k[2] = [1, 0, 0, 0]
    k[3] = [0, 0, 0, 0x80000000]
    return k


@pytest.mark.parametrize("cap_log2", [4, 10, 20, 24])
def test_hash_and_probe_positions(cap_log2):
    key4 = _keys(np.random.default_rng(cap_log2), 512)
    jk, tk = jnp.asarray(key4), t32(key4)
    np.testing.assert_array_equal(
        tht.hash_key4(tk, cap_log2).numpy(), np.asarray(jht.hash_key4(jk, cap_log2))
    )
    np.testing.assert_array_equal(
        tht.probe_step(tk, cap_log2).numpy(), np.asarray(jht.probe_step(jk, cap_log2))
    )
    for window in (jht.WINDOW, jht.WINDOW_SCALAR):
        np.testing.assert_array_equal(
            tht.probe_positions(tk, cap_log2, window).numpy(),
            np.asarray(jht.probe_positions(jk, cap_log2, window)),
        )


def _table(rng, cap_log2, live, tombs):
    """A [2^k + 1, 32] u32 table with `live` random rows and `tombs`
    tombstones, placed at random slots."""
    cap = 1 << cap_log2
    rows = np.zeros((cap + 1, 32), dtype=np.uint32)
    slots = rng.permutation(cap)
    rows[slots[:live]] = rng.integers(1, 1 << 32, (live, 32), dtype=np.uint64).astype(np.uint32)
    rows[slots[live:live + tombs]] = 0xFFFFFFFF
    return rows


def _probe_keys(rng, rows, n):
    """Keys that are present, absent, empty-encoded and tomb-encoded."""
    live = rows[:-1][~(rows[:-1, :4] == 0).all(1) & ~(rows[:-1, :4] == 0xFFFFFFFF).all(1)]
    present = live[rng.integers(0, len(live), n // 2), :4] if len(live) else np.zeros((0, 4))
    absent = _keys(rng, n - len(present))
    return np.concatenate([present, absent]).astype(np.uint32)


@pytest.mark.parametrize("cap_log2,live,tombs", [
    (6, 20, 8),  # ordinary load with tombstones
    (6, 56, 8),  # every slot taken: windows exhaust, nothing resolves
    (5, 20, 12),  # no empty slot, tombstones only: resolves nowhere, frees exist
])
def test_lookup_and_probe_free(cap_log2, live, tombs):
    rng = np.random.default_rng(live * 100 + tombs)
    rows = _table(rng, cap_log2, live, tombs)
    key4 = _probe_keys(rng, rows, 64)
    for window in (jht.WINDOW, jht.WINDOW_SCALAR):
        want = jht.lookup(jnp.asarray(key4), jnp.asarray(rows), cap_log2, window)
        got = tht.lookup(t32(key4), t32(rows), cap_log2, window)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    want = jht.probe_free(jnp.asarray(key4), jnp.asarray(rows), cap_log2)
    got = tht.probe_free(t32(key4), t32(rows), cap_log2)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if live + tombs == 1 << cap_log2:
        assert not np.asarray(want[1]).any() or tombs  # exhaustion reached


@pytest.mark.parametrize("cap_log2,live,tombs,n", [
    (6, 10, 4, 24),  # contention between lanes on shared probe slots
    (5, 20, 4, 24),  # more lanes than free slots: some lanes stay unresolved
    (10, 100, 30, 200),
])
def test_claim_slots(cap_log2, live, tombs, n):
    rng = np.random.default_rng(cap_log2 * 7 + n)
    rows = _table(rng, cap_log2, live, tombs)
    key4 = _keys(rng, n)
    active = rng.random(n) < 0.85
    claim = np.full(rows.shape[0], 0xFFFFFFFF, dtype=np.uint32)
    slot_j, claim_j, res_j = jht.claim_slots(
        jnp.asarray(key4), jnp.asarray(active), jnp.asarray(rows), jnp.asarray(claim), cap_log2
    )
    claim_t = t32(claim).clone()
    slot_t, res_t = tht.claim_slots(
        t32(key4), torch.from_numpy(active), t32(rows), claim_t, cap_log2
    )
    np.testing.assert_array_equal(slot_t.numpy(), np.asarray(slot_j))
    np.testing.assert_array_equal(res_t.numpy(), np.asarray(res_j))
    np.testing.assert_array_equal(claim_t.numpy().view(np.uint32), np.asarray(claim_j))
    np.testing.assert_array_equal(
        tht.occupied_mask(t32(rows)).numpy(), np.asarray(jht.occupied_mask(jnp.asarray(rows)))
    )


# ----------------------------------------------------------------------
# row codecs and validation ladders
# ----------------------------------------------------------------------

_MAX4 = (0xFFFFFFFF,) * 4


def _pick(rng, n, pool, p=None):
    """[n, k] words, each lane one entry of `pool` (tuples of k words)."""
    pool = np.array(pool, dtype=np.uint64).astype(np.uint32)
    return pool[rng.choice(len(pool), n, p=p)]


def _u128_pool(rng, n, small, p):
    """Zero, small values, u64-max, huge and u128-max amounts or balances."""
    out = _pick(rng, n, [(0, 0, 0, 0), (1, 0, 0, 0), (0xFFFFFFFF, 0xFFFFFFFF, 0, 0),
                         (0, 0, 0, 0xFFFFFFFF), _MAX4], p)
    smalls = rng.integers(1, small, n, dtype=np.uint64).astype(np.uint32)
    is_small = rng.random(n) < 0.5
    out[is_small] = 0
    out[is_small, 0] = smalls[is_small]
    return out


def _transfer_rows(rng, n, flags_pool):
    """Transfer wire rows whose fields come from small pools, so equal,
    zero and all-ones fields (and so most ladder codes) are common."""
    r = np.zeros((n, 32), dtype=np.uint32)
    r[:, 0:4] = _pick(rng, n, [(5, 0, 0, 0), (6, 0, 0, 0), (0, 0, 0, 0), _MAX4],
                      [.45, .45, .05, .05])
    acct = [(1, 0, 0, 0), (2, 0, 0, 0), (3, 0, 0, 0), (0, 0, 0, 0), _MAX4]
    r[:, 4:8] = _pick(rng, n, acct, [.3, .3, .3, .05, .05])
    r[:, 8:12] = _pick(rng, n, acct, [.3, .3, .3, .05, .05])
    r[:, 12:16] = _u128_pool(rng, n, 50, [.3, .2, .2, .2, .1])
    r[:, 16:20] = _pick(rng, n, [(0, 0, 0, 0), (5, 0, 0, 0), (9, 0, 0, 0), _MAX4],
                        [.5, .2, .25, .05])
    r[:, 20:24] = _pick(rng, n, [(0, 0, 0, 0), (3, 0, 0, 0)])
    r[:, 24:26] = _pick(rng, n, [(0, 0), (4, 0)])
    r[:, 26] = rng.choice([0, 9], n)
    r[:, 27] = rng.choice([0, 0, 0, 1, 7], n)  # timeout
    r[:, 28] = rng.choice([0, 1, 1, 2], n)  # ledger
    code = rng.choice([0, 1, 1, 2], n)
    r[:, 29] = code | (rng.choice(flags_pool, n) << 16)
    r[:, 30:32] = _pick(rng, n, [(0, 0), (0, 0), (0, 0), (5, 0), (1, 1)])
    return r


def _account_rows(rng, n, flags_pool):
    r = np.zeros((n, 32), dtype=np.uint32)
    r[:, 0:4] = _pick(rng, n, [(1, 0, 0, 0), (2, 0, 0, 0), (0, 0, 0, 0), _MAX4],
                      [.45, .45, .05, .05])
    for w in (4, 8, 12, 16):  # dp, dpo, cp, cpo
        r[:, w:w + 4] = _u128_pool(rng, n, 100, [.4, .1, .2, .2, .1])
    r[:, 20:24] = _pick(rng, n, [(0, 0, 0, 0), (3, 0, 0, 0)])
    r[:, 24:26] = _pick(rng, n, [(0, 0), (4, 0)])
    r[:, 26] = rng.choice([0, 9], n)
    r[:, 27] = rng.choice([0, 0, 0, 1], n)  # reserved
    r[:, 28] = rng.choice([0, 1, 1, 2], n)
    r[:, 29] = rng.choice([0, 1, 1, 2], n) | (rng.choice(flags_pool, n) << 16)
    r[:, 30:32] = _pick(rng, n, [(0, 0), (0, 0), (5, 0)])
    return r


def _mutated(rng, rows, fields):
    """A copy of `rows` with one random field of about half the lanes
    changed (the exists-with-different-* codes)."""
    out = rows.copy()
    for i in np.nonzero(rng.random(len(rows)) < 0.5)[0]:
        lo, hi = fields[rng.integers(len(fields))]
        out[i, lo:hi] ^= 1
    return out


def _both(unpack_name, rows):
    return (getattr(jledger, unpack_name)(jnp.asarray(rows)),
            getattr(tledger, unpack_name)(t32(rows)))


def _check_fields(jf, tf):
    assert jf.keys() == tf.keys()
    for k in jf:
        np.testing.assert_array_equal(u64(tf[k]), np.asarray(jf[k]).astype(np.uint64), err_msg=k)


@pytest.mark.parametrize("seed", [0, 1])
def test_row_codecs(seed):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 1 << 32, (64, 32), dtype=np.uint64).astype(np.uint32)
    for unpack, pack in (("unpack_transfer", "pack_transfer"), ("unpack_account", "pack_account")):
        jf, tf = _both(unpack, rows)
        _check_fields(jf, tf)
        np.testing.assert_array_equal(getattr(tledger, pack)(tf).numpy().view(np.uint32), rows)
    jf, tf = _both("unpack_transfer", rows)
    np.testing.assert_array_equal(
        tledger.key4_from_fields(tf).numpy().view(np.uint32),
        np.asarray(jledger.key4_from_fields(jf)),
    )


TRANSFER_FLAGS = [0, 0, 1, 2, 4, 8, 12, 16, 32, 48, 2 | 16, 64]
ACCOUNT_FLAGS = [0, 0, 1, 2, 4, 6, 8]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_transfer_ladders(seed):
    rng = np.random.default_rng(seed)
    n = 4096
    e_rows = _transfer_rows(rng, n, TRANSFER_FLAGS)
    ex_rows = _mutated(rng, e_rows, [(4, 5), (8, 9), (12, 13), (16, 17), (20, 21), (24, 25),
                                     (26, 27), (27, 28), (29, 30)])
    p_rows = _transfer_rows(rng, n, [0, 2, 2, 2])
    dr_rows = _account_rows(rng, n, ACCOUNT_FLAGS)
    cr_rows = _account_rows(rng, n, ACCOUNT_FLAGS)
    found = [rng.random(n) < 0.8 for _ in range(4)]
    fulfill = rng.choice([0, 0, 1, 2], n).astype(np.uint32)
    ts = rng.choice([0, 1, (1 << 64) - 1 - (7 * 10**9)], n).astype(np.uint64)

    je, te = _both("unpack_transfer", e_rows)
    jex, tex = _both("unpack_transfer", ex_rows)
    jp, tp = _both("unpack_transfer", p_rows)
    jdr, tdr = _both("unpack_account", dr_rows)
    jcr, tcr = _both("unpack_account", cr_rows)
    jp["fulfill"], tp["fulfill"] = jnp.asarray(fulfill), t32(fulfill).to(torch.int64)
    je_a, te_a = {**je, "ts": jnp.asarray(ts)}, {**te, "ts": t64(ts)}
    jfo = [jnp.asarray(f) for f in found]
    tfo = [torch.from_numpy(f) for f in found]

    r0j = jvalidate.transfer_common(je, jnp.where(je["ts"] != 0, jnp.uint32(3), jnp.uint32(0)))
    r0t = tvalidate.transfer_common(te, torch.where(te["ts"] != 0, 3, 0))
    np.testing.assert_array_equal(r0t.numpy(), np.asarray(r0j))
    np.testing.assert_array_equal(
        tvalidate.transfer_exists_code(te, tex).numpy(),
        np.asarray(jvalidate.transfer_exists_code(je, jex)),
    )
    np.testing.assert_array_equal(
        tvalidate.post_void_exists_code(te, tex, tp).numpy(),
        np.asarray(jvalidate.post_void_exists_code(je, jex, jp)),
    )
    want = jvalidate.validate_simple_transfer(r0j, je_a, jdr, jcr, jfo[0], jfo[1], jex, jfo[2])
    got = tvalidate.validate_simple_transfer(r0t, te_a, tdr, tcr, tfo[0], tfo[1], tex, tfo[2])
    codes = np.asarray(want[0])
    assert len(np.unique(codes)) >= 24, np.unique(codes)  # most of the ladder
    np.testing.assert_array_equal(got[0].numpy(), codes)
    for w, g in zip(want[1:], got[1:]):
        np.testing.assert_array_equal(u64(g), np.asarray(w))
    want = jvalidate.validate_post_void(r0j, je_a, jp, jfo[3], jex, jfo[2])
    got = tvalidate.validate_post_void(r0t, te_a, tp, tfo[3], tex, tfo[2])
    codes = np.asarray(want[0])
    assert len(np.unique(codes)) > 15, np.unique(codes)
    np.testing.assert_array_equal(got[0].numpy(), codes)
    for w, g in zip(want[1:], got[1:]):
        np.testing.assert_array_equal(u64(g), np.asarray(w))


@pytest.mark.parametrize("seed", [0, 1])
def test_account_ladders(seed):
    rng = np.random.default_rng(seed)
    n = 4096
    e_rows = _account_rows(rng, n, ACCOUNT_FLAGS)
    e_rows[rng.random(n) < 0.6, 4:20] = 0  # balances mostly zero
    ex_rows = _mutated(rng, e_rows, [(20, 21), (24, 25), (26, 27), (28, 29), (29, 30)])
    je, te = _both("unpack_account", e_rows)
    jex, tex = _both("unpack_account", ex_rows)
    found = rng.random(n) < 0.5
    np.testing.assert_array_equal(
        tvalidate.account_exists_code(te, tex).numpy(),
        np.asarray(jvalidate.account_exists_code(je, jex)),
    )
    want = jvalidate.validate_create_account(
        jnp.zeros(n, dtype=jnp.uint32), je, jex, jnp.asarray(found)
    )
    got = tvalidate.validate_create_account(
        torch.zeros(n, dtype=torch.int64), te, tex, torch.from_numpy(found)
    )
    assert len(np.unique(np.asarray(want))) > 15, np.unique(np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_digit_folds_and_stored_transfer():
    rng = np.random.default_rng(5)
    n = 512
    rows = rng.integers(0, 1 << 32, (n, 32), dtype=np.uint64).astype(np.uint32)
    rows[: n // 2, 4:20] = 0xFFFFFFFF  # carries run off the top: overflow
    acc = rng.integers(0, 1 << 29, (n, 32), dtype=np.uint64).astype(np.uint32)
    for jfold, tfold in ((jledger._fold_digits, tledger._fold_digits),
                         (jledger._fold_digits_signed, tledger._fold_digits_signed)):
        acc_s = acc if jfold is jledger._fold_digits else (
            acc.astype(np.int64) - (1 << 28)).astype(np.int32).view(np.uint32)
        want = jfold(jnp.asarray(rows), jnp.asarray(acc_s))
        got = tfold(t32(rows), t32(acc_s))
        np.testing.assert_array_equal(got[0].numpy().view(np.uint32), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(
        tledger._combined_overflow(t32(rows)).numpy(),
        np.asarray(jledger._combined_overflow(jnp.asarray(rows))),
    )
    je, te = _both("unpack_transfer", _transfer_rows(rng, n, TRANSFER_FLAGS))
    jp, tp = _both("unpack_transfer", _transfer_rows(rng, n, [2]))
    is_pv = rng.random(n) < 0.5
    ts = rng.integers(0, 1 << 62, n, dtype=np.uint64)
    want = jledger.build_stored_transfer(je, jp, jnp.asarray(is_pv), je["amt_lo"], je["amt_hi"],
                                         jnp.asarray(ts))
    got = tledger.build_stored_transfer(te, tp, torch.from_numpy(is_pv), te["amt_lo"],
                                        te["amt_hi"], t64(ts))
    _check_fields(want, got)
    np.testing.assert_array_equal(
        tledger._amount_digits(te["amt_lo"], te["amt_hi"]).numpy(),
        np.asarray(jledger._amount_digits(je["amt_lo"], je["amt_hi"])),
    )
