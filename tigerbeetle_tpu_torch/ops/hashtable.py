"""Open-addressing tables over 128-byte wire rows: the plain PyTorch probes.

The counterpart of `tigerbeetle_tpu/ops/hashtable.py`. A table is one
`[capacity + 1, 32]` int32 tensor whose rows are the objects' 128-byte wire
images (the u32 words of the JAX tables, bit for bit); the last row is the
dump row that the JAX kernels send masked writes to. The port never writes
it.

Probing is double hashing with a fixed window: probe j of a key visits
`(hash_key4(key) + j * probe_step(key)) & mask`, with an odd step. The
window sizes, the claim rounds and the lowest-lane-wins claim rule decide
which slot each row lands in, so they are kept exactly: slot placement is
part of the state a checkpoint writes.

Key encoding in row words 0..3 (the id): all four words 0 is an empty slot,
all four 0xFFFFFFFF a tombstone (left by a rolled-back linked chain). Probes
skip tombstones; only an empty slot ends a chain. Inserts reuse both.

These functions are the plain versions: vectorized torch, any device. The
CUDA kernels in `csrc/` reproduce them lane for lane (`hash.cuh`).
"""

from __future__ import annotations

import torch

from tigerbeetle_tpu_torch.ops.u128 import srl, to_i64

TOMB_WORD = -1  # 0xFFFFFFFF as an int32 word
CLAIM_FREE = -1  # 0xFFFFFFFF as an int32 word
_U32_FREE = 0xFFFFFFFF

_MIX = to_i64(0x9E3779B97F4A7C15)
_MIX2 = to_i64(0xD1B54A32D192ED03)
_C1 = to_i64(0xBF58476D1CE4E5B9)
_C2 = to_i64(0x94D049BB133111EB)
_STEP_SEED = to_i64(0x6A09E667F3BCC909)

# Batched probes use WINDOW slots; the serial kernels use the longer
# WINDOW_SCALAR prefix of the same probe sequence.
WINDOW = 32
WINDOW_SCALAR = 64


def _fold64(key4):
    k = key4.to(torch.int64) & 0xFFFFFFFF
    lo = k[..., 0] | (k[..., 1] << 32)
    hi = k[..., 2] | (k[..., 3] << 32)
    return lo, hi


def hash_key4(key4, cap_log2: int):
    """splitmix64 finalizer over both id limbs -> base slot in [0, 2^cap_log2)."""
    lo, hi = _fold64(key4)
    x = lo ^ (hi * _MIX)
    x = (x ^ srl(x, 30)) * _C1
    x = (x ^ srl(x, 27)) * _C2
    x = x ^ srl(x, 31)
    return x & ((1 << cap_log2) - 1)


def probe_step(key4, cap_log2: int):
    """Second, independent hash -> odd probe stride (a full cycle mod 2^k)."""
    lo, hi = _fold64(key4)
    x = (lo ^ _STEP_SEED) * _MIX2
    x = x ^ (hi * _MIX2) ^ srl(x, 31)
    x = (x ^ srl(x, 29)) * _C1
    x = x ^ srl(x, 32)
    return (x & ((1 << cap_log2) - 1)) | 1


def probe_positions(key4, cap_log2: int, window: int):
    """[..., window] int64 slots: the first `window` probes of key4's sequence."""
    base = hash_key4(key4, cap_log2)
    step = probe_step(key4, cap_log2)
    j = torch.arange(window, dtype=torch.int64, device=key4.device)
    return (base[..., None] + j * step[..., None]) & ((1 << cap_log2) - 1)


def _is_empty(k4):
    return (k4 == 0).all(dim=-1)


def _is_tomb(k4):
    return (k4 == TOMB_WORD).all(dim=-1)


def occupied_mask(rows):
    """Per-slot liveness of a [N, 32] table: neither empty nor tombstone."""
    k4 = rows[..., :4]
    return ~_is_empty(k4) & ~_is_tomb(k4)


def _first(mask, window: int):
    """Index of the first True along the last axis, `window` if none."""
    j = torch.arange(window, dtype=torch.int64, device=mask.device)
    return torch.where(mask, j, window).amin(dim=-1)


def _take(pos, sel):
    return torch.gather(pos, -1, sel.unsqueeze(-1)).squeeze(-1)


def lookup(key4, rows, cap_log2: int, window: int = WINDOW):
    """Probe for key4 ([..., 4] int32). Returns (slot int64, found, resolved):

    - found: the key is in the table (a hit before the first empty slot);
      `slot` is its row.
    - not found but resolved: an empty slot ended the chain; `slot` is the
      first free (empty or tombstone) probe position, the insert target.
    - not resolved: neither a hit nor an empty slot in the window; `slot` is
      the first free position, else the last probe. The caller must treat
      the batch as failed (fault protocol).

    All-0 and all-1 keys are never found; they resolve like absent keys.
    """
    pos = probe_positions(key4, cap_log2, window)
    return resolve(key4, pos, rows[pos, :4], window)


def resolve(key4, pos, k4, window: int):
    """`lookup`'s answer for key4 [..., 4] from the key words `k4` [..., W,
    4] read at its probe positions `pos` [..., W]. `k4` may have leading
    axes in front of key4's (one table per shard): the answers then have
    them too."""
    key_probeable = ~_is_empty(key4) & ~_is_tomb(key4)
    hit = (k4 == key4.unsqueeze(-2)).all(dim=-1) & key_probeable.unsqueeze(-1)
    empty = _is_empty(k4)
    free = empty | _is_tomb(k4)
    hit_j = _first(hit, window)
    empty_j = _first(empty, window)
    free_j = _first(free, window)
    found = hit_j < empty_j
    resolved = found | (empty_j < window)
    sel = torch.where(found, hit_j, free_j.clamp(max=window - 1))
    return _take(pos.expand(*sel.shape, window), sel), found, resolved


def claim_slots(key4, active, rows, claim, cap_log2: int,
                window: int = WINDOW, rounds: int = 4):
    """Claim one distinct free slot per active lane for batch-unique, absent
    keys. The rows are not written; the caller scatters them after gating.

    Each round every lane still wanting a slot picks its first probe
    position that is free in the table and unclaimed as the claim column
    stood at the start of the round; contention is decided by the scatter-min
    of the lane index (the lowest lane wins). `claim` ([capacity + 1] int32,
    CLAIM_FREE between batches) is updated IN PLACE; every claim is released
    before return. Returns (slots int64 [B], resolved bool [B]); `slots` is
    the dump slot (capacity) for inactive or unresolved lanes."""
    dump = 1 << cap_log2
    B = key4.shape[0]
    dev = key4.device
    lanes = torch.arange(B, dtype=torch.int64, device=dev)
    pos = probe_positions(key4, cap_log2, window)  # [B, W]
    k4 = rows[pos, :4]
    table_free = _is_empty(k4) | _is_tomb(k4)  # static during the claims
    # unsigned copy of the column, so that scatter-min orders FREE last
    clm = claim.to(torch.int64) & 0xFFFFFFFF
    won = torch.zeros(B, dtype=torch.bool, device=dev)
    slot = torch.full((B,), dump, dtype=torch.int64, device=dev)
    for _ in range(rounds):
        clm_w = clm[pos]
        cand_j = _first(table_free & (clm_w == _U32_FREE), window)
        has_cand = cand_j < window
        cand = _take(pos, cand_j.clamp(max=window - 1))
        want = active & ~won & has_cand
        tgt = torch.where(want, cand, dump)
        clm.scatter_reduce_(0, tgt, lanes, "amin")
        newly = want & (clm[cand] == lanes)
        slot = torch.where(newly, cand, slot)
        won = won | newly
    resolved = won | ~active
    clm[slot] = _U32_FREE
    clm[dump] = _U32_FREE
    claim.copy_(clm.to(torch.int32))
    return slot, resolved


def probe_free(key4, rows, cap_log2: int, window: int = WINDOW_SCALAR):
    """First free (empty or tombstone) probe position for a key known to be
    absent (the serial tier's insert target). Returns (slot, ok)."""
    pos = probe_positions(key4, cap_log2, window)
    return resolve_free(pos, rows[pos, :4], window)


def resolve_free(pos, k4, window: int):
    """`probe_free`'s answer from the key words `k4` [..., W, 4] read at the
    probe positions `pos` [..., W] (leading axes as in `resolve`)."""
    free_j = _first(_is_empty(k4) | _is_tomb(k4), window)
    return _take(pos.expand(*free_j.shape, window), free_j.clamp(max=window - 1)), free_j < window
