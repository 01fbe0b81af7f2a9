"""Carry ledger state between the JAX package and this one.

`state_from_numpy` takes a JAX `DeviceLedger.state` as numpy arrays (u32
tables and words, u64 scalars) and returns this package's state dict on a
device: every u32 word becomes an int32 and every u64 an int64 with the same
bits. `state_to_numpy` turns it back. The tests start both implementations
from one state with these and compare every leaf afterwards.
`ring_from_numpy` does the same for the dual follower's u64 digest ring.
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
