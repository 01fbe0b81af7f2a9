"""Carry ledger state between the JAX package and this one.

`state_from_numpy` takes a JAX `DeviceLedger.state` as numpy arrays (u32
tables and words, u64 scalars) and returns this package's state dict on a
device: every u32 word becomes an int32 and every u64 an int64 with the same
bits. `state_to_numpy` turns it back. The tests start both implementations
from one state with these and compare every leaf afterwards.
`ring_from_numpy` does the same for the dual follower's u64 digest ring.

`carry_ledger` carries a whole ledger across at a checkpoint, a spilling one
included: the device state, the host's occupancy counters, prepare clock and
planner state, and the spill store (the grid's storage bytes and
`SpillManager.checkpoint_meta()`, restored through the port's own
`SpillManager.restore`). Both ledgers then continue identically.
`carry_sharded` does the same for a sharded ledger (parallel/mesh.py).
"""

from __future__ import annotations

import numpy as np
import torch

_SIGNED = {np.dtype(np.uint32): np.int32, np.dtype(np.uint64): np.int64}
_UNSIGNED = {torch.int32: np.uint32, torch.int64: np.uint64}


def state_from_numpy(d: dict, device) -> dict:
    """{name: numpy u32/u64 array or scalar} -> {name: int32/int64 tensor}."""
    out = {}
    for k, v in d.items():
        a = np.array(v)  # a contiguous copy; keeps 0-d scalars 0-d
        out[k] = torch.from_numpy(a.view(_SIGNED[a.dtype])).to(device)
    return out


def ring_from_numpy(ring: np.ndarray, device):
    """A u64 ring (the JAX follower's device ring) -> an int64 tensor with
    the same bits."""
    return torch.from_numpy(np.array(ring, dtype=np.uint64).view(np.int64)).to(device)


def state_to_numpy(s: dict) -> dict:
    """{name: int32/int64 tensor} -> {name: numpy uint32/uint64 array}."""
    return {
        k: v.detach().cpu().numpy().view(_UNSIGNED[v.dtype]) for k, v in s.items()
    }


def carry_ledger(port, src, state_np: dict, storage_data=None, spill_meta=None) -> None:
    """Carry the ledger `src` into the port's DeviceLedger `port` (same
    geometry; built with a forest over a MemoryStorage of the same layout
    when `src` spills). `state_np` is src's state as numpy arrays; the host
    side (occupancy counters, prepare clock, the hazard tracker's limit
    accounts, pending registry, amount bound and plan stats) is read from
    src's attributes, which are plain Python and numpy values. With a spill
    store, `storage_data` is the bytes of src's MemoryStorage after
    `spill_meta = src.spill.checkpoint_meta()`."""
    port.state = state_from_numpy(state_np, port.device)
    port._acct_used = int(src._acct_used)
    port._xfer_used = int(src._xfer_used)
    _carry_host(port, src)
    if spill_meta is not None:
        storage = port.spill.forest.grid.storage
        if len(storage.data) != len(storage_data):
            raise ValueError(f"storage of {len(storage.data)} bytes, {len(storage_data)} given")
        storage.data[:] = storage_data
        port.spill.restore(spill_meta)


def carry_sharded(port, src, state_np: dict) -> None:
    """Carry the sharded ledger `src` into the port's ShardedLedger `port`
    (same shard count and geometry). `state_np` is src's state as numpy
    arrays; the per-shard occupancy counters, the prepare clock and the
    hazard tracker are read from src's attributes."""
    port.state = state_from_numpy(state_np, port.device)
    port._acct_used = np.array(src._acct_used, dtype=np.int64)
    port._xfer_used = np.array(src._xfer_used, dtype=np.int64)
    _carry_host(port, src)


def _carry_host(port, src) -> None:
    """The prepare clock and the hazard tracker's limit accounts, pending
    registry, amount bound and plan stats."""
    port.prepare_timestamp = int(src.prepare_timestamp)
    h, t = src.hazards, port.hazards
    t.amount_sum = int(h.amount_sum)
    t.limit_account_ids = set(h.limit_account_ids)
    t._limit_lo = np.array(h._limit_lo, dtype=np.uint64)
    t.pending_accounts = dict(h.pending_accounts)
    t.plan_stats = dict(h.plan_stats)
