"""The spill cycle's gather (K10g) over whole sides: the port's plain
version against the JAX package's `SpillKernels._gather`, bit for bit, and
a spill cycle whose sides are gathered in one call each against the JAX
cycle, which gathers CHUNK windows.

On the card the gather is one launch for any list (csrc/spill_reload.cu):
the cycle calls it once over the cold side, into a kept staging buffer whose
chunks are copied to the host in order, and once over the hot side padded
with the dump slot to whole chunks, whose slices feed the reloads. Here, on
the CPU, the wrapper runs the plain version (the kernel's CPU route) on
index lists of lengths that are not a multiple of CHUNK or of a warp's 16
rows, with the dump slot as padding, repeated slots and an empty list,
through the wrapper's `out` pair too. The cycle test runs the spilling
ledgers of tests/test_torch_spill.py (its seeds and workload) with CHUNK
set to 256 in both packages, so that each side of a cycle spans several
chunks at the test geometry (2^12 transfer slots): the rows each cycle
stages for the LSM forest, in order, every table after every cycle and the
grid's storage bytes must be equal. Tolerance: zero.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tigerbeetle_tpu  # noqa: F401  (x64 before any input is built)
from tigerbeetle_tpu.constants import TEST_CLUSTER as J_TEST_CLUSTER
from tigerbeetle_tpu.constants import TEST_PROCESS as J_TEST_PROCESS
from tigerbeetle_tpu.io.storage import MemoryStorage as JMemoryStorage
from tigerbeetle_tpu.io.storage import ZoneLayout as JZoneLayout
from tigerbeetle_tpu.lsm.grid import Grid as JGrid
from tigerbeetle_tpu.lsm.groove import Forest as JForest
from tigerbeetle_tpu.models import ledger as jledger
from tigerbeetle_tpu.models import spill as jspill
from tigerbeetle_tpu.models.spill import get_spill_kernels
from tigerbeetle_tpu.testing.workload import WorkloadGenerator
from tigerbeetle_tpu_torch import convert
from tigerbeetle_tpu_torch.constants import TEST_CLUSTER, TEST_PROCESS
from tigerbeetle_tpu_torch.io.storage import MemoryStorage, ZoneLayout
from tigerbeetle_tpu_torch.lsm.grid import Grid
from tigerbeetle_tpu_torch.lsm.groove import Forest
from tigerbeetle_tpu_torch.models import ledger as tledger
from tigerbeetle_tpu_torch.models import spill as tspill

T_LOG2 = TEST_PROCESS.transfer_slots_log2
T_DUMP = 1 << T_LOG2
GRID = dict(offset=0, block_count=640, cache_blocks=64)  # as tests/test_spill.py
GRID_SIZE = 96 * 1024 * 1024
KNOBS = dict(ledgers=(1,), invalid_rate=0.03, conflict_rate=0.06, chain_rate=0.02,
             two_phase_rate=0.15, balancing_rate=0.05, limit_account_rate=0.05)
SMALL_CHUNK = 256


# ----------------------------------------------------------------------
# the gather on whole-side index lists
# ----------------------------------------------------------------------


def _side(name: str, rng) -> np.ndarray:
    """An index list of case `name` into a table of T_DUMP slots + dump."""
    live = np.sort(rng.choice(T_DUMP, 3000, replace=False)).astype(np.int32)
    if name == "empty":
        return np.zeros(0, dtype=np.int32)
    if name == "one_dump":
        return np.array([T_DUMP], dtype=np.int32)
    if name == "warp_less_one":  # 15 rows: one short of a warp's 16
        return live[:15]
    if name == "warp_and_one":
        return live[:17]
    if name == "cold_side":  # ascending distinct slots, as the split gives them
        return live[:2047]
    if name == "hot_side_padded":  # the hot side up to whole chunks, dump-padded
        n = 1001
        out = np.full(-(-n // tspill.CHUNK) * tspill.CHUNK, T_DUMP, dtype=np.int32)
        out[:n] = live[-n:]
        return out
    if name == "repeated":
        return rng.choice(live[:40], 5003).astype(np.int32)
    if name == "over_chunk":  # CHUNK + 3 with the dump slot interleaved
        idx = rng.integers(0, T_DUMP + 1, tspill.CHUNK + 3).astype(np.int32)
        idx[::7] = T_DUMP
        return idx
    if name == "all_dump":
        return np.full(64, T_DUMP, dtype=np.int32)
    raise ValueError(name)


SIDES = ("empty", "one_dump", "warp_less_one", "warp_and_one", "cold_side", "hot_side_padded",
         "repeated", "over_chunk", "all_dump")


@pytest.fixture(scope="module")
def random_table():
    """[T_DUMP + 1, 32] u32 rows (the dump row nonzero) and their fulfill
    words: the gather reads whatever is there."""
    rng = np.random.default_rng(323)
    rows = rng.integers(0, 1 << 32, (T_DUMP + 1, 32), dtype=np.uint32)
    ful = rng.integers(0, 3, T_DUMP + 1).astype(np.uint32)
    ful[-1] = 9
    return rows, ful


@pytest.mark.parametrize("name", SIDES)
def test_gather_side_matches_jax(random_table, name):
    rows_np, ful_np = random_table
    idx = _side(name, np.random.default_rng(len(name)))
    rows = torch.from_numpy(rows_np.view(np.int32))
    ful = torch.from_numpy(ful_np.view(np.int32))
    t_idx = torch.from_numpy(idx)
    got_rows, got_ful = tspill.spill_gather_plain(rows, ful, t_idx)
    j_rows, j_ful = get_spill_kernels(J_TEST_PROCESS).gather(
        jnp.asarray(rows_np), jnp.asarray(ful_np), jnp.asarray(idx))
    assert got_rows.shape == (len(idx), 32) and got_ful.shape == (len(idx),)
    np.testing.assert_array_equal(got_rows.numpy().view(np.uint32), np.asarray(j_rows))
    np.testing.assert_array_equal(got_ful.numpy().view(np.uint32), np.asarray(j_ful))
    # the wrapper into the cycle's kind of staging buffer: views of a larger one
    cap = max(1, 1 << (len(idx) - 1).bit_length()) if len(idx) else 1
    buf_rows = torch.full((cap, 32), -1, dtype=torch.int32)
    buf_ful = torch.full((cap,), -1, dtype=torch.int32)
    views = (buf_rows[:len(idx)], buf_ful[:len(idx)])
    out = tspill.spill_gather(rows, ful, t_idx, out=views)
    assert out[0] is views[0] and out[1] is views[1]
    np.testing.assert_array_equal(buf_rows[:len(idx)].numpy().view(np.uint32), np.asarray(j_rows))
    np.testing.assert_array_equal(buf_ful[:len(idx)].numpy().view(np.uint32), np.asarray(j_ful))
    assert (buf_rows[len(idx):] == -1).all() and (buf_ful[len(idx):] == -1).all()


# ----------------------------------------------------------------------
# a spill cycle with one gather a side
# ----------------------------------------------------------------------


class StagedPair:
    """The JAX and the port's spilling DeviceLedger (deferred IO), each
    recording the rows and fulfill words its cycles stage, in order."""

    def __init__(self):
        self.j_storage = JMemoryStorage(JZoneLayout(J_TEST_CLUSTER, grid_size=GRID_SIZE))
        self.t_storage = MemoryStorage(ZoneLayout(TEST_CLUSTER, grid_size=GRID_SIZE))
        self.jax = jledger.DeviceLedger(process=J_TEST_PROCESS, mode="auto",
                                        forest=JForest(JGrid(self.j_storage, **GRID)),
                                        spill_io="deferred")
        self.port = tledger.DeviceLedger(TEST_PROCESS, device="cpu",
                                         forest=Forest(Grid(self.t_storage, **GRID)),
                                         spill_io="deferred")
        self.staged = {"jax": [], "port": []}
        for side, led in (("jax", self.jax), ("port", self.port)):
            self._record(led.spill, self.staged[side])
        self.gathers = []
        gather = self.port.spill.kernels.gather

        def counted(rows, fulfill, idx, out=None):
            self.gathers.append(int(idx.shape[0]))
            return gather(rows, fulfill, idx, out)

        self.port.spill.kernels.gather = counted

    @staticmethod
    def _record(spill, into):
        stage = spill._stage_and_submit

        def recorded(rows, ful, *rest):
            into.append((np.array(rows, dtype=np.uint32), np.array(ful, dtype=np.uint32)))
            return stage(rows, ful, *rest)

        spill._stage_and_submit = recorded

    def tables_equal(self):
        got = convert.state_to_numpy(self.port.state)
        for k, want in self.jax.state.items():
            want = np.asarray(want)
            g = got[k]
            if want.ndim:  # every slot but the dump slot
                want, g = want[:-1], g[:-1]
            np.testing.assert_array_equal(g, want, err_msg=k)
        assert self.port.spill.spilled == self.jax.spill.spilled


@pytest.mark.parametrize("seed,n_batches", [(11, 60), (22, 52)])
def test_cycle_one_gather_a_side(monkeypatch, seed, n_batches):
    monkeypatch.setattr(jspill, "CHUNK", SMALL_CHUNK)
    monkeypatch.setattr(tspill, "CHUNK", SMALL_CHUNK)
    # JAX kernels of their own: the shared ones keep CHUNK as traced
    monkeypatch.setattr(jspill, "_SPILL_KERNELS_CACHE", {})
    pair = StagedPair()
    gen = WorkloadGenerator(seed, **KNOBS)
    ts = 1_000_000_000
    cycles = 0
    for b in range(4 + n_batches):
        op, events = gen.gen_accounts_batch(40) if b < 4 else gen.gen_transfers_batch(72)
        ts += len(events)
        assert pair.port.execute_dense(op, ts, events) == pair.jax.execute_dense(op, ts, events)
        now = pair.port.spill.stats["cycles"]
        assert now == pair.jax.spill.stats["cycles"], b
        if now != cycles:  # the rebuilt table after every cycle
            cycles = now
            pair.tables_equal()
    assert cycles >= 1
    # each cycle gathered its cold side in one call and its hot side in one,
    # and the cold side spanned more than one chunk
    assert len(pair.gathers) == 2 * cycles
    assert max(pair.gathers[0::2]) > SMALL_CHUNK
    assert all(n % SMALL_CHUNK == 0 for n in pair.gathers[1::2])
    # the same rows staged for the LSM forest, chunk by chunk, in order
    assert len(pair.staged["port"]) == len(pair.staged["jax"]) > 2 * cycles
    for (tr, tf), (jr, jf) in zip(pair.staged["port"], pair.staged["jax"]):
        np.testing.assert_array_equal(tr, jr)
        np.testing.assert_array_equal(tf, jf)
    assert dict(pair.port.spill.stats)["spilled"] == dict(pair.jax.spill.stats)["spilled"]
    # the same grid bytes once both forests checkpoint
    assert pair.port.spill.checkpoint_meta() == pair.jax.spill.checkpoint_meta()
    assert pair.t_storage.data == pair.j_storage.data
    # the transfers read back alike, spilled ones included
    jt, tt = pair.jax.extract()[1], pair.port.extract()[1]
    assert [(k, dataclasses.asdict(v)) for k, v in tt.items()] == \
        [(k, dataclasses.asdict(v)) for k, v in jt.items()]
