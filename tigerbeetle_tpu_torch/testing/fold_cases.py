"""Cases for the reply-code fold (K7): the chained digest of k slots of
dense reply codes, with and without the follower's ring.

On the card the fold is one launch whose warps are dealt out to the slots
and whose last block chains them, so its answer must not depend on k, on
n_pad, on which slots are active or on where the ring indices point. Each
case aims at one of those:

- k of 1, 2, 5 and 16, n_pad of 1, 31, 33, 257 and 8192;
- slot counts of 0 and of n_pad, active slots with no lanes (the chain
  still advances by mix(c ^ 0));
- inactive slots first, last and everywhere (padding slots: n = 0);
- ring indices from `_ring_indices` (colliding ops, all but the last of
  them routed to the dump slot APPLY_RING, padding slots too) and raw
  indices that repeat (a later slot with the same index wins);
- codes with the high bit set (zero-extended into the lane hash) in every
  case, some all ones;
- a starting chain of 0 and of 2^64 - 1.

`fold_case(name, rng)` returns a dict: `flat` (uint32 [k * n_pad + 1], the
slots then a fault word, as a group's results lie), `n_pad`, `ns` (ints),
`active` (bools), `idxs` (int32 [k] or None: no ring), `chk` (the starting
chain, a Python int holding u64 bits) and `ring` (uint64 [APPLY_RING + 1]
or None). Made with numpy from the caller's generator; the tests hold the
plain version against the JAX package's four forms on them, and
`chip_smoke.py` holds the kernel against its plain version on them.
"""

from __future__ import annotations

import numpy as np

from tigerbeetle_tpu_torch.models.dual_ledger import APPLY_RING, _ring_indices

U64_MAX = (1 << 64) - 1

# name: (k, n_pad, ns, active, ring, chk). ns and active are lists, or
# "full" (every slot n_pad lanes, all active); ring is None (no ring), a
# list of op numbers for `_ring_indices` (padding slots to the dump slot) or
# ("raw", indices).
_CASES = {
    "solo_one_lane": (1, 1, [1], [True], None, 0),
    "solo_8190_ring": (1, 8192, [8190], [True], [4097], U64_MAX),
    "solo_active_empty": (1, 31, [0], [True], [APPLY_RING - 1], 0),
    "solo_inactive": (1, 33, [0], [False], [7], U64_MAX),
    "pair_full_collide": (2, 31, "full", "full", [12, 12 + APPLY_RING], 0),
    "pair_inactive_first": (2, 33, [0, 20], [False, True], ("raw", [APPLY_RING, 5]), U64_MAX),
    "pair_one_lane_pad": (2, 1, [0, 1], [True, True], None, U64_MAX),
    "five_counts": (5, 257, [257, 0, 1, 256, 100], [True] * 5, None, U64_MAX),
    "five_inactive_last": (5, 257, [257, 3, 0, 0, 0], [True, True, False, False, False],
                           [900, 901], 0),
    "five_inactive_everywhere": (5, 33, [0, 33, 0, 17, 0], [False, True, False, True, False],
                                 ("raw", [APPLY_RING, 3, APPLY_RING, 4, APPLY_RING]), 0),
    "sixteen_full": (16, 8192, [8190] * 16, [True] * 16, list(range(40, 56)), 0),
    "sixteen_padding": (16, 8192, [8190, 1, 0, 8192, 4096, 300, 8190, 7, 8190, 2, 8191]
                        + [0] * 5, [True] * 11 + [False] * 5,
                        [100, 101, 102, 101 + APPLY_RING] + list(range(104, 111)), U64_MAX),
    "sixteen_raw_repeats": (16, 257, "full", "full",
                            ("raw", [3, 9, 3, 9, 0, 0, 0, 17, 3, APPLY_RING - 1, 17, 5, 5, 6,
                                     APPLY_RING, APPLY_RING]), 0),
    "sixteen_inactive_everywhere": (16, 31, [31, 0, 5, 0, 31, 0, 1, 0, 30, 0, 31, 0, 0, 0, 2, 0],
                                    [j % 2 == 0 for j in range(16)],
                                    ("raw", [j if j % 2 == 0 else APPLY_RING for j in range(16)]),
                                    U64_MAX),
    "sixteen_one_lane": (16, 1, [j % 2 for j in range(16)], [True] * 16, None, U64_MAX),
}
CASES = tuple(_CASES)


def codes(rng, n: int) -> np.ndarray:
    """Reply codes, the high bit set in a fifth of the lanes, some all ones."""
    c = rng.integers(0, 60, n).astype(np.uint32)
    c[rng.random(n) < 0.2] |= np.uint32(0x8000_0000)
    c[rng.random(n) < 0.05] = 0xFFFF_FFFF
    return c


def fold_case(name: str, rng) -> dict:
    """The inputs of case `name`."""
    if name not in _CASES:
        raise ValueError(f"unknown fold case {name!r}")
    k, n_pad, ns, active, ring, chk = _CASES[name]
    ns = [n_pad] * k if ns == "full" else list(ns)
    active = [True] * k if active == "full" else list(active)
    assert len(ns) == k and len(active) == k and all(0 <= n <= n_pad for n in ns)
    idxs = ring_vals = None
    if ring is not None:
        if isinstance(ring, tuple):
            idxs = np.asarray(ring[1], dtype=np.int32)
        else:
            idxs = _ring_indices(ring, k)
        assert idxs.shape == (k,)
        ring_vals = rng.integers(0, 1 << 64, APPLY_RING + 1, dtype=np.uint64)
    return {"flat": codes(rng, k * n_pad + 1), "n_pad": n_pad, "ns": ns, "active": active,
            "idxs": idxs, "chk": chk, "ring": ring_vals}
