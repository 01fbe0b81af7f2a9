"""The batched lookups, K1 and K11l, on the cases of
`tigerbeetle_tpu_torch.testing.lookup_cases`: the port's plain versions
(`table_lookup_plain`, and `lookup_plain` of parallel/mesh.py) and their
wrappers' CPU routes against the JAX package's lookups, bit for bit: found,
resolved and the row of every lane, found or not.

On the card each key is probed by a group of eight threads that keeps the
row the lookup returns in registers (csrc/group_probe.cuh), so the cases
end chains in every way: a hit at once or after tombstones, an empty slot
after tombstones or at once (their stale words are the answer), a window
with one tombstone or none, the all-zero and all-ones keys, one key in many
lanes, and a table (for the sharded table, one shard of one or of eight)
with no empty slot; at batches of 1, 33 and 8190 keys. The JAX side of K1
is `LedgerKernels._lookup_accounts`; of K11l the sharded
`_lookup_accounts_shard` on the conftest's 8-device CPU mesh (the first
device alone for one shard). Then the host read: `lookup_rows` and
`lookup_accounts` of the port's `DeviceLedger` and `ShardedLedger` on the
CPU equal the JAX ledgers', and an unresolved requested lane raises in
both. `chip_smoke.py` holds the kernels against the plain versions on the
same cases. Tolerance: zero.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec

import tigerbeetle_tpu  # noqa: F401  (x64 before any input is built)
from tigerbeetle_tpu.constants import ConfigProcess as JConfigProcess
from tigerbeetle_tpu.models import ledger as jledger
from tigerbeetle_tpu.parallel import mesh as jmesh
from tigerbeetle_tpu.types import Operation
from tigerbeetle_tpu_torch import kernels as tk
from tigerbeetle_tpu_torch.constants import ConfigProcess
from tigerbeetle_tpu_torch.models import ledger as tledger
from tigerbeetle_tpu_torch.ops import hashtable as tht
from tigerbeetle_tpu_torch.parallel import mesh as tmesh
from tigerbeetle_tpu_torch.testing import lookup_cases as LC

LOG2 = LC.LOG2_CPU
J_PROCESS = JConfigProcess(account_slots_log2=LOG2, transfer_slots_log2=LOG2)
PROCESS = ConfigProcess(account_slots_log2=LOG2, transfer_slots_log2=LOG2)
_SHARDED = {}


def _rng(*parts) -> np.random.Generator:
    return np.random.default_rng(zlib.crc32(".".join(map(str, parts)).encode()))


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32).copy())


def _ids(key4: np.ndarray) -> list[int]:
    return [int(k[0]) | int(k[1]) << 32 | int(k[2]) << 64 | int(k[3]) << 96 for k in key4]


def _sharded(S: int):
    """A JAX sharded kernel object and its mesh for S shards, shared across
    the module's tests (each new object compiles anew)."""
    if S not in _SHARDED:
        mesh = Mesh(np.array(jax.devices()[:S]), ("shard",))
        _SHARDED[S] = (mesh, jmesh.ShardedLedgerKernels(mesh, J_PROCESS))
    return _SHARDED[S]


def _jax_k1(rows: np.ndarray, key4: np.ndarray):
    kern = jledger.get_kernels(J_PROCESS)
    got = kern.lookup_accounts({"acct_rows": jnp.asarray(rows)}, {"key4": jnp.asarray(key4)})
    return [np.asarray(x) for x in got]


def _jax_k11l(rows: np.ndarray, key4: np.ndarray):
    mesh, kern = _sharded(rows.shape[0])
    state = jmesh.init_sharded_state(mesh, J_PROCESS)
    state["acct_rows"] = jax.device_put(rows, NamedSharding(mesh, PartitionSpec("shard")))
    got = kern.lookup_accounts(state, {"key4": jnp.asarray(key4)})
    return [np.asarray(x) for x in got]


def _assert_lanes(got, want) -> None:
    f, r, res = got
    np.testing.assert_array_equal(f.numpy(), want[0])
    np.testing.assert_array_equal(r.numpy().view(np.uint32), want[1])
    np.testing.assert_array_equal(res.numpy(), want[2])


def _assert_crafted(case, rows_flat, found, rows, resolved, zero_missing: bool) -> None:
    """The crafted lanes give what their chains are built to give."""
    c = case["crafted"]
    assert c.any()
    np.testing.assert_array_equal(found[c], case["found"][c])
    np.testing.assert_array_equal(resolved[c], case["resolved"][c])
    want = rows_flat[case["slot"][c]]
    if zero_missing:
        want = np.where(case["found"][c][:, None], want, 0)
    np.testing.assert_array_equal(rows[c], want)


@pytest.mark.parametrize("n", LC.SIZES)
@pytest.mark.parametrize("name", LC.CASES)
def test_k1_case_matches_jax(name, n):
    case = LC.lookup_case(name, LOG2, n, _rng("k1", name, n))
    rows, key4 = case["rows"], case["key4"]
    want = _jax_k1(rows, key4)
    for fn in (tledger.table_lookup_plain, tledger.table_lookup):
        _assert_lanes(fn(_t(key4), _t(rows), LOG2), want)
    _assert_crafted(case, rows, *want, zero_missing=False)
    slot, found, resolved = tht.lookup(_t(key4), _t(rows), LOG2)
    c = case["crafted"]
    np.testing.assert_array_equal(slot.numpy()[c], case["slot"][c])


@pytest.mark.parametrize("S", LC.SHARDS)
@pytest.mark.parametrize("n", LC.SIZES)
@pytest.mark.parametrize("name", LC.CASES)
def test_k11l_case_matches_jax(name, n, S):
    case = LC.lookup_case(name, LOG2, n, _rng("k11l", name, n, S), n_shards=S)
    rows, key4 = case["rows"], case["key4"]
    want = _jax_k11l(rows, key4)
    for fn in (tmesh.lookup_plain, lambda r, k, g: tmesh.lookup(r, k, g)):
        _assert_lanes(fn(_t(rows), _t(key4), LOG2), want)
    _assert_crafted(case, rows.reshape(-1, 32), *want, zero_missing=True)


@pytest.mark.parametrize("n", LC.SIZES)
def test_lookup_buffer_views(n):
    """The kernels' one output buffer as group_store (csrc/group_probe.cuh)
    writes it, B rows, then B found bytes, then B resolved bytes, in whole
    words: `lookup_views` reads back the plain version's answer, as the
    ledgers do from their host copy of it."""
    case = LC.lookup_case("miss_after_tombs", LOG2, n, _rng("buffer", n))
    found, rows, resolved = tledger.table_lookup_plain(_t(case["key4"]), _t(case["rows"]), LOG2)
    packed = np.concatenate([rows.numpy().view(np.uint8).ravel(), found.numpy().view(np.uint8),
                             resolved.numpy().view(np.uint8)])
    nbytes = tk.lookup_bytes(n)
    assert nbytes % 4 == 0 and 0 <= nbytes - packed.size < 4
    buf = torch.zeros(nbytes, dtype=torch.bool)
    buf.view(torch.uint8)[:packed.size] = torch.from_numpy(packed)
    for got, want in zip(tk.lookup_views(buf, n), (found, rows, resolved)):
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_cases_cover_each_ending():
    """At a request's size every case crafts lanes, and together they end
    chains in every way the kernels tell apart."""
    endings = set()
    for name in LC.CASES:
        for S in (0, 8):
            case = LC.lookup_case(name, LOG2, 8190, _rng("cover", name, S), n_shards=S)
            c = case["crafted"]
            assert c.sum() >= 16, (name, S)
            endings |= set(zip(case["found"][c].tolist(), case["resolved"][c].tolist()))
            if name == "exhausted":
                table = case["rows"] if S == 0 else case["rows"][int(case["slot"][c][0]) // (
                    (1 << LOG2) + 1)]
                assert not (table[:-1, :4] == 0).all(1).any()
    assert endings == {(True, True), (False, True), (False, False)}


# ----------------------------------------------------------------------
# the host read: the ledgers' lookups on the CPU
# ----------------------------------------------------------------------


def _ledgers(kind: str, S: int):
    if kind == "device":
        return jledger.DeviceLedger(process=J_PROCESS), tledger.DeviceLedger(PROCESS,
                                                                             device="cpu")
    mesh, kern = _sharded(S)
    jl = jmesh.ShardedLedger(mesh, J_PROCESS)
    jl.kernels = kern
    return jl, tmesh.ShardedLedger(S, PROCESS, device="cpu")


def _fields(accounts) -> list:
    return [(a.id, a.debits_pending, a.debits_posted, a.credits_pending, a.credits_posted,
             a.user_data_128, a.user_data_64, a.user_data_32, a.ledger, a.code, a.flags,
             a.timestamp) for a in accounts]


@pytest.mark.parametrize("kind,S", [("device", 0), ("sharded", 1), ("sharded", 8)])
def test_host_read_matches_jax(kind, S):
    """lookup_rows and lookup_accounts on the resolved cases; an unresolved
    requested lane raises in both ledgers."""
    jl, tl = _ledgers(kind, S)
    for name in ("hit_after_tombs", "miss_after_tombs", "repeated", "special_keys",
                 "exhausted"):
        case = LC.lookup_case(name, LOG2, 33, _rng("host", kind, S, name), n_shards=S)
        rows = case["rows"]
        if kind == "device":
            jl.state["acct_rows"] = jnp.asarray(rows)
        else:
            jl.state["acct_rows"] = jax.device_put(
                rows, NamedSharding(jl.mesh, PartitionSpec("shard")))
        tl.state["acct_rows"] = _t(rows)
        ids = _ids(case["key4"])
        if name == "exhausted":
            bad = _ids(case["key4"][case["crafted"]][:1])
            for led in (jl, tl):
                with pytest.raises(RuntimeError, match="lookup probe-window overflow"):
                    led.lookup_rows(Operation.lookup_accounts, ids)
                with pytest.raises(RuntimeError, match="lookup probe-window overflow"):
                    led.lookup_accounts(bad)
            tables = rows if S else rows[None]
            resolved = tmesh.lookup_plain(_t(tables), _t(case["key4"]), LOG2)[2].numpy()
            ids = [x for x, ok in zip(ids, resolved) if ok]
        body = tl.lookup_rows(Operation.lookup_accounts, ids)
        assert body == jl.lookup_rows(Operation.lookup_accounts, ids)
        assert _fields(tl.lookup_accounts(ids)) == _fields(jl.lookup_accounts(ids))
        if name in ("hit_after_tombs", "repeated"):
            assert body
