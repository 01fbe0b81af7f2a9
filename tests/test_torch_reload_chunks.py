"""The spill cycle's reload (K10r) across its chunks: the port's plain
version of a rebuild's reloads, `spill_reload_chunks_plain`, against the
JAX package's `SpillKernels._reload` called chunk after chunk as
`SpillManager._cycle` calls it, bit for bit.

K10r on the card is one launch of one thread-block cluster for one chunk
or for all the chunks of a rebuild (csrc/spill_reload.cu); the cases of
`tigerbeetle_tpu_torch.testing.reload_cases` aim at what the one launch
must carry from chunk to chunk: one, two and many chunks with a partial
last one, resident ids (skipped), ids repeated within a chunk and across
chunks, a CAPACITY fault in a middle chunk followed by a chunk whose full
windows trip PROBE and CLAIM, shared windows with one tombstone, and an
earlier fault word. Here, on the CPU, the port runs the wrapper's CPU
route (the plain chunk loop) and the JAX package its jitted `_reload` on
each chunk of `chunk` lanes with the lanes below the chunk's length
active, at 2^12 slots in chunks of 64 and at 2^14 in chunks of 256; the
one-chunk entry point also on a random active mask. Every leaf is
compared but the dump row (the JAX function writes the lanes it skips
there; the port never writes it), and the probe word. `chip_smoke.py`
holds the kernel against the plain version on the same cases. Tolerance:
zero.
"""

import types as pytypes
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tigerbeetle_tpu  # noqa: F401  (x64 before any input is built)
from tigerbeetle_tpu.models import spill as jspill
from tigerbeetle_tpu_torch.models import spill as tspill
from tigerbeetle_tpu_torch.testing import reload_cases

GEOMETRIES = [(12, 64), (14, 256)]  # (cap_log2, chunk)
_JAX = {}


def _jax_kernels(cap_log2: int):
    """One JAX SpillKernels a table size: its reload compiles once per
    chunk width."""
    if cap_log2 not in _JAX:
        _JAX[cap_log2] = jspill.SpillKernels(pytypes.SimpleNamespace(transfer_slots_log2=cap_log2))
    return _JAX[cap_log2]


def _jax_reload(cap_log2, table, rows, ful, n, chunk, active=None):
    """The JAX cycle's chunk loop (tigerbeetle_tpu/models/spill.py:905-918):
    each chunk of `chunk` lanes, those below its length active (or the
    given mask for a single chunk). Returns the table and the last probe."""
    k = _jax_kernels(cap_log2)
    st = [jnp.asarray(table[name]) for name in
          ("xfer_rows", "fulfill", "xfer_claim", "xfer_used_slots", "fault")]
    probe = None
    for start in range(0, n, chunk):
        act = np.arange(chunk) < min(chunk, n - start) if active is None else active
        *st, probe = k.reload(*st, jnp.asarray(rows[start:start + chunk]),
                              jnp.asarray(ful[start:start + chunk]), jnp.asarray(act))
    names = ("xfer_rows", "fulfill", "xfer_claim", "xfer_used_slots", "fault")
    return {name: np.asarray(v) for name, v in zip(names, st)}, int(np.asarray(probe))


def _port_table(got) -> dict:
    return {
        "xfer_rows": got["xfer_rows"].numpy().view(np.uint32),
        "fulfill": got["fulfill"].numpy().view(np.uint32),
        "xfer_claim": got["xfer_claim"].numpy().view(np.uint32),
        "xfer_used_slots": np.array(int(got["xfer_used_slots"]), dtype=np.int64).view(np.uint64),
        "fault": np.array(int(got["fault"]), dtype=np.int32).view(np.uint32),
    }


def _assert_same(want: dict, got: dict) -> None:
    for name, w in want.items():
        g = got[name]
        if w.ndim:  # every slot but the dump slot
            w, g = w[:-1], g[:-1]
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("cap_log2,chunk", GEOMETRIES)
@pytest.mark.parametrize("case", [c for c in reload_cases.CASES if c != "sparse_active"])
def test_reload_chunks_match_jax(case, cap_log2, chunk):
    rng = np.random.default_rng(zlib.crc32(f"{case}.{cap_log2}.{chunk}".encode()))
    c = reload_cases.reload_case(case, cap_log2, chunk, rng)
    want, want_probe = _jax_reload(cap_log2, c["table"], c["rows"], c["ful"], c["n"], chunk)

    tbl = reload_cases.to_torch(c["table"], "cpu")
    probe = tspill.spill_reload_chunks(tbl, torch.from_numpy(c["rows"].view(np.int32)),
                                       torch.from_numpy(c["ful"].view(np.int32)), c["n"],
                                       cap_log2, chunk)
    got = _port_table(tbl)
    _assert_same(want, got)
    assert int(probe) & 0xFFFFFFFF == want_probe
    fault = int(got["fault"])
    assert fault & c["fault"] == c["fault"] and (fault == 0) == (c["fault"] == 0)
    if not c["fault"]:  # every row is in the table
        keys = {tuple(r) for r in got["xfer_rows"][:-1, :4].tolist()}
        assert all(tuple(r) in keys for r in c["rows"][:c["n"], :4].tolist())
    else:  # a faulted chunk wrote nothing: the later chunks' rows are absent
        start = {tuple(r) for r in c["table"]["xfer_rows"][:-1, :4].tolist()}
        keys = {tuple(r) for r in got["xfer_rows"][:-1, :4].tolist()}
        late = [tuple(r) for r in c["rows"][c["n"] - 1:c["n"], :4].tolist()]
        assert all(k in start or k not in keys for k in late)


@pytest.mark.parametrize("cap_log2,chunk", GEOMETRIES)
def test_reload_one_chunk_sparse_active_matches_jax(cap_log2, chunk):
    rng = np.random.default_rng(zlib.crc32(f"sparse.{cap_log2}.{chunk}".encode()))
    c = reload_cases.reload_case("sparse_active", cap_log2, chunk, rng)
    want, want_probe = _jax_reload(cap_log2, c["table"], c["rows"], c["ful"], chunk, chunk,
                                   active=c["active"])
    tbl = reload_cases.to_torch(c["table"], "cpu")
    probe = tspill.spill_reload(tbl, torch.from_numpy(c["rows"].view(np.int32)),
                                torch.from_numpy(c["ful"].view(np.int32)),
                                torch.from_numpy(c["active"]), cap_log2)
    _assert_same(want, _port_table(tbl))
    assert int(probe) & 0xFFFFFFFF == want_probe


def test_reload_chunks_of_nothing_leaves_the_table():
    rng = np.random.default_rng(7)
    c = reload_cases.reload_case("one_chunk", 12, 64, rng)
    tbl = reload_cases.to_torch(c["table"], "cpu")
    before = {k: v.clone() for k, v in tbl.items()}
    probe = tspill.spill_reload_chunks(tbl, torch.from_numpy(c["rows"].view(np.int32)),
                                       torch.from_numpy(c["ful"].view(np.int32)), 0, 12, 64)
    for k, v in before.items():
        assert torch.equal(tbl[k], v), k
    assert int(probe) == (int(c["table"]["xfer_used_slots"]) & 0xFFFFFFFF) ^ 0
