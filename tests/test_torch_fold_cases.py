"""The reply-code fold (K7) on the cases of
`tigerbeetle_tpu_torch.testing.fold_cases`: the port's plain version,
`fold_codes_plain`, and its wrapper's CPU route, `fold_codes`, against the
JAX package's four forms, bit for bit.

On the card K7 is one launch whose warps are dealt out to the slots and
whose last block chains them (csrc/fold.cu), so the cases vary k (1, 2, 5,
16), n_pad (1, 31, 33, 257, 8192), slot counts of 0 and n_pad, inactive
slots first, last and everywhere, ring indices that collide or go to the
dump slot, codes with the high bit set and a starting chain of 0 or
2^64 - 1. The JAX forms: `fold_reply_codes` (one active slot, no ring),
`_fold_ring_fn` (one active slot, a ring), `_fold_group_fn` and
`_fold_group_ring_fn` (any other case), each compiled once per shape. The
JAX scatter writes repeated ring indices in unspecified order, so a ring
entry that more than one slot writes is held against the JAX package's
numpy fold (`fold_reply_codes_np`) slot by slot, the last slot winning, as
the port defines it. `chip_smoke.py` holds the kernel against the plain
version on the same cases. Tolerance: zero.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tigerbeetle_tpu  # noqa: F401  (x64 before any input is built)
from tigerbeetle_tpu.models import dual_ledger as jdual
from tigerbeetle_tpu.models import ledger as jledger
from tigerbeetle_tpu_torch.models import ledger as tledger
from tigerbeetle_tpu_torch.ops.u128 import to_i64
from tigerbeetle_tpu_torch.testing import fold_cases

U64 = (1 << 64) - 1
_FOLD_SOLO = jax.jit(jledger.fold_reply_codes)


def _case(name):
    return fold_cases.fold_case(name, np.random.default_rng(zlib.crc32(name.encode())))


def _jax_fold(c):
    """(chain, ring or None) from the JAX form the dual ledger uses for the
    case's shape."""
    k, n_pad = len(c["ns"]), c["n_pad"]
    flat = jnp.asarray(c["flat"])
    chk = jnp.uint64(c["chk"])
    solo = k == 1 and c["active"][0]
    if c["idxs"] is None:
        if solo:
            return _FOLD_SOLO(chk, flat[:n_pad], jnp.int32(c["ns"][0])), None
        fn = jdual._fold_group_fn(k, n_pad)
        return fn(chk, flat, jnp.asarray(np.array(c["ns"], dtype=np.int32)),
                  jnp.asarray(np.array(c["active"]))), None
    ring = jnp.asarray(c["ring"])
    if solo:
        return jdual._fold_ring_fn()(chk, ring, jnp.int32(c["idxs"][0]), flat[:n_pad],
                                     jnp.int32(c["ns"][0]))
    fn = jdual._fold_group_ring_fn(k, n_pad)
    return fn(chk, ring, jnp.asarray(c["idxs"]), flat,
              jnp.asarray(np.array(c["ns"], dtype=np.int32)), jnp.asarray(np.array(c["active"])))


def _numpy_fold(c):
    """(chain, ring) by the JAX package's numpy fold, slot by slot, each
    slot's chain value into its ring index in slot order."""
    chain = c["chk"]
    ring = None if c["ring"] is None else c["ring"].copy()
    for j, (n, a) in enumerate(zip(c["ns"], c["active"])):
        if a:
            lanes = c["flat"][j * c["n_pad"]: j * c["n_pad"] + n]
            chain = jledger.fold_reply_codes_np(chain, lanes)
        if ring is not None:
            ring[c["idxs"][j]] = np.uint64(chain)
    return chain, ring


@pytest.mark.parametrize("route", ["plain", "wrapper"])
@pytest.mark.parametrize("name", fold_cases.CASES)
def test_fold_case_matches_jax(name, route):
    c = _case(name)
    fold = tledger.fold_codes_plain if route == "plain" else tledger.fold_codes
    chk = torch.tensor(to_i64(c["chk"]), dtype=torch.int64)
    ring = None if c["ring"] is None else torch.from_numpy(c["ring"].view(np.int64).copy())
    fold(chk, torch.from_numpy(c["flat"].view(np.int32).copy()), c["n_pad"], c["ns"],
         c["active"], ring, c["idxs"])
    want_chk, want_ring = _jax_fold(c)
    np_chk, np_ring = _numpy_fold(c)
    assert int(chk) & U64 == int(np.asarray(want_chk)) == np_chk
    if ring is None:
        return
    got = ring.numpy().view(np.uint64)
    idxs = c["idxs"]
    once = np.ones(len(got), dtype=bool)
    once[[i for i in set(idxs.tolist()) if (idxs == i).sum() > 1]] = False
    np.testing.assert_array_equal(got[once], np.asarray(want_ring)[once])
    np.testing.assert_array_equal(got, np_ring)


def test_fold_cases_cover_each_shape():
    """The cases hold every k, n_pad, slot count and starting chain the
    kernel's layout turns on."""
    cases = [_case(name) for name in fold_cases.CASES]
    assert {len(c["ns"]) for c in cases} >= {1, 2, 5, 16}
    assert {c["n_pad"] for c in cases} >= {1, 31, 33, 257, 8192}
    assert any(0 in c["ns"] for c in cases) and any(c["n_pad"] in c["ns"] for c in cases)
    assert any(a and n == 0 for c in cases for n, a in zip(c["ns"], c["active"]))
    actives = [c["active"] for c in cases if len(c["active"]) > 1]
    assert any(not a[0] for a in actives) and any(not a[-1] and a[0] for a in actives)
    assert any(not a[0] and not a[-1] and any(a) for a in actives)
    rings = [c["idxs"] for c in cases if c["idxs"] is not None]
    assert any((i == fold_cases.APPLY_RING).sum() > 1 for i in rings)
    assert any(len(set(i.tolist()) - {fold_cases.APPLY_RING}) < (i != fold_cases.APPLY_RING).sum()
               for i in rings)
    assert {c["chk"] for c in cases} == {0, U64}
    assert all((c["flat"] >> 31).any() for c in cases if len(c["flat"]) > 8)
