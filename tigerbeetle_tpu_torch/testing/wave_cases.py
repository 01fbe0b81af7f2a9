"""Batches laid out in W conflict waves for the wave commit (K12), each aimed
at the order of its waves.

K12 runs the fast (or fast_pv) commit of wave 0's lanes, then wave 1's, and
so on, over one uploaded batch in one launch; wave w must see the state wave
w - 1 left, also where another SM of the cluster wrote it. Each case makes a
stale read, a wave run out of order or a code written in the wrong wave
change a code, a table row or the fault word:

- `pend_post_void`: pendings made in wave w and posted or voided in wave
  w + 1, for w = 0 .. W - 2 (fast_pv);
- `limit_chain`: account 1 must not have debits above its credits; wave 0
  credits it, waves 1 .. W - 1 debit it until its credits run out
  (`exceeds_credits` from the middle of the chain on), and one touch more
  than the waves hold lies in no wave (the serial residue's lane: code 0);
- `capacity`: every lane valid, the transfer table filled so that wave 1
  trips the capacity gate: wave 0 applies, every later wave is a no-op, and
  the codes of every wave are still written;
- `sticky_before`: the fault word is set before the call: every wave is a
  no-op;
- `empty_wave`: wave 1 holds no live lane (padding lanes of no wave too);
- `post_void_race`: a pending made in wave 0, posted in wave 1 and voided
  in wave 2 (`pending_transfer_already_posted`; with W = 2 the void lies in
  no wave) (fast_pv);
- `claim_contend`: four lanes of wave 1, far apart in the batch (in
  different blocks of the cluster at 8192 lanes), whose ids share a home
  slot that no other lane's id has: the lowest lane wins it, the others
  take their next probes;
- `one_lane_waves`: W waves of one lane each, the rest in no wave: wave 0
  credits the limit account, each later wave debits it (`exceeds_credits`
  once its credits run out);
- `interleaved`: lane i in wave i mod W, every fifth lane in no wave;
  pendings posted or voided in the next wave from a lower lane (fast_pv);
- `lopsided`: wave 0 holds every lane but one, and the last wave the one: a
  lower lane that posts a pending of wave 0 (fast_pv).

K12 builds each wave's lane list on the card and runs each wave over its
own list, so the last four aim at the lists: lanes of one wave far apart,
waves of one lane, waves that alternate lane by lane, and waves of very
different sizes.

Every other lane carries random traffic between accounts 3-48 (some of it
failing) in a random wave, its count of valid events kept within the
table's load limit. The case's own events sit in the lanes [HOT_BASE,
HOT_BASE + 64) of a batch of 8192 (a block of the cluster other than the
first validates them), else in the first 64.

`wave_case(name, W, n_pad, t_log2, rng)` returns a dict: `accounts` (the 48
accounts, ACCOUNT_DTYPE), `rows` ([n_pad, 32] int32), `n` (the events, n_pad
- 2), `timestamp`, `wave_of` (int32 [n_pad]: each lane's wave, -1 for a lane
of no wave), `pv` (the fast_pv mode), `xfer_used` and `fault` (values to set
in the state before the call, or None), `expect` ([(lane, code)] that the
case is built to give; code None: any failure) and `fault_after` (the fault
word the call must end with). `wave_bytes(wave_of)` gives the uint8 lane
waves the wrappers take (255 for no wave). `base_state` is
`group_cases.base_state`: the accounts committed by the plain versions on
the CPU, the words set, on `device`. The tests hold the plain version against
the JAX package's `_wave_stepper` on these cases; `chip_smoke.py` holds the
kernel against its plain version on them.
"""

from __future__ import annotations

import numpy as np
import torch

from tigerbeetle_tpu_torch.ops import hashtable as ht
from tigerbeetle_tpu_torch.testing.group_cases import (
    CODE,
    HOT,
    LIMIT_ACCOUNT,
    N_ACCOUNTS,
    T0,
    _accounts,
    _filler,
    _hot_base,
    _transfers,
    base_state,
)

CASES = ("pend_post_void", "limit_chain", "capacity", "sticky_before", "empty_wave",
         "post_void_race", "claim_contend", "one_lane_waves", "interleaved", "lopsided")
CONTENDERS = 4  # claim_contend's lanes: within CLAIM_ROUNDS, so every one wins a slot
F_PENDING, F_POST, F_VOID = 2, 4, 8
FAULT_SERIAL, FAULT_CAPACITY = 8, 16

__all__ = ["CASES", "wave_case", "wave_bytes", "wave_codes_ok", "base_state"]


def wave_bytes(wave_of: np.ndarray) -> np.ndarray:
    """Each lane's wave as the wrappers take it: uint8, 255 for no wave."""
    return np.asarray(wave_of).astype(np.uint8)


def _homes(ids, t_log2: int) -> np.ndarray:
    """The home slot (first probe) of each transfer id (< 2^64) at 2^t_log2
    slots."""
    key4 = np.zeros((len(ids), 4), dtype=np.uint32)
    key4[:, 0] = np.asarray(ids, dtype=np.uint64) & np.uint64(0xFFFFFFFF)
    key4[:, 1] = np.asarray(ids, dtype=np.uint64) >> np.uint64(32)
    return ht.hash_key4(torch.from_numpy(key4.view(np.int32)), t_log2).numpy()


def _sharing_home(rng, ids, taken: np.ndarray, t_log2: int) -> np.ndarray:
    """CONTENDERS of `ids` whose home slot is one and the same, a slot that
    no home in `taken` is."""
    homes = _homes(ids, t_log2)
    counts = np.bincount(homes, minlength=1 << t_log2)
    counts[taken] = 0
    home = rng.choice(np.nonzero(counts >= CONTENDERS)[0])
    return np.asarray(ids)[np.nonzero(homes == home)[0][:CONTENDERS]]


def _post_or_void(pend_id, post_id, amount, flags):
    t = _transfers(post_id, [0], [0], [amount // 2 if flags == F_POST else 0])
    t["ledger"] = t["code"] = 0
    t["flags"] = flags
    t["pending_id_lo"] = pend_id
    return t


def wave_case(name: str, W: int, n_pad: int, t_log2: int, rng) -> dict:
    """The batch, its lane waves and the state words of case `name` in W
    waves of n_pad lanes at 2^t_log2 transfer slots."""
    if name not in CASES:
        raise ValueError(f"unknown wave case {name!r}")
    if W < 2 or n_pad < HOT:
        raise ValueError(f"wave cases need W >= 2 and n_pad >= {HOT}")
    half = (1 << t_log2) // 2
    n = n_pad - 2
    next_id = [1 + int(rng.integers(0, 1 << 20)) * 64]

    def fresh(m):
        ids = np.arange(next_id[0], next_id[0] + m, dtype=np.uint64)
        next_id[0] += m
        return ids

    p_valid = 1.0 if name == "capacity" else min(1.0, half / 3 / n)
    batch = _filler(rng, n, fresh(n), p_valid)
    wave_of = np.full(n_pad, -1, dtype=np.int32)
    waves = np.arange(W) if name != "empty_wave" else np.delete(np.arange(W), 1)
    wave_of[:n] = rng.choice(waves, n)
    lane_no = np.arange(n)
    if name == "one_lane_waves":
        wave_of[:n] = -1
    elif name == "interleaved":
        wave_of[:n] = np.where(lane_no % 5 == 4, -1, lane_no % W)
    elif name == "lopsided":
        wave_of[:n] = 0
    base = _hot_base(n_pad)
    hot = base + rng.permutation(min(HOT, n))  # the case's lanes, in random order
    expect = []
    xfer_used = fault = None
    fault_after = 0
    pv = name in ("pend_post_void", "post_void_race", "interleaved", "lopsided")

    def put(lane, t, wave):
        batch[lane] = t[0]
        wave_of[lane] = wave

    if name == "pend_post_void":
        for w in range(W - 1):
            pend, post = fresh(1), fresh(1)
            amount = int(rng.integers(10, 1000))
            put(hot[2 * w], _transfers(pend, [3 + w % 40], [4 + w % 40], [amount]), w)
            batch["flags"][hot[2 * w]] = F_PENDING
            flags = F_POST if w % 2 else F_VOID
            t = _transfers(post, [0], [0], [amount // 2 if flags == F_POST else 0])
            t["ledger"] = t["code"] = 0
            t["flags"] = flags
            t["pending_id_lo"] = pend
            put(hot[2 * w + 1], t, w + 1)
            expect += [(int(hot[2 * w]), 0), (int(hot[2 * w + 1]), 0)]
    elif name == "limit_chain":
        ok_debits = (W - 1) // 2
        put(hot[0], _transfers(fresh(1), [3], [LIMIT_ACCOUNT], [10 * ok_debits + 5]), 0)
        expect.append((int(hot[0]), 0))
        for w in range(1, W + 1):  # the last touch lies in no wave
            put(hot[w], _transfers(fresh(1), [LIMIT_ACCOUNT], [4], [10]), w if w < W else -1)
            if w == W:
                expect.append((int(hot[w]), 0))
            else:
                expect.append((int(hot[w]), int(CODE.ok if w <= ok_debits
                                                else CODE.exceeds_credits)))
    elif name == "capacity":
        wave_of[hot[:2]] = (0, 1)  # each of the first two waves holds a lane
        c0 = int((wave_of == 0).sum())
        c1 = int((wave_of == 1).sum())
        xfer_used = half - c0 - c1 + 1
        if xfer_used < 0 or c1 == 0:
            raise ValueError(f"waves of {c0} and {c1} do not fit under 2^{t_log2} slots")
        fault_after = FAULT_CAPACITY
    elif name == "sticky_before":
        fault = FAULT_SERIAL
        fault_after = fault
    elif name == "claim_contend":
        # a range of fresh ids, from which CONTENDERS share a home slot
        lanes = (np.arange(CONTENDERS) * 2 + 1) * n // (2 * CONTENDERS)
        ids = _sharing_home(rng, fresh(16 << t_log2), _homes(batch["id_lo"], t_log2), t_log2)
        for lane, i in zip(lanes, rng.permutation(ids)):
            put(lane, _transfers([i], [3 + lane % 40], [4 + lane % 40],
                                 [int(rng.integers(1, 1000))]), 1)
            expect.append((int(lane), 0))
    elif name == "one_lane_waves":
        ok_debits = (W - 1) // 2
        put(hot[0], _transfers(fresh(1), [3], [LIMIT_ACCOUNT], [10 * ok_debits + 5]), 0)
        expect.append((int(hot[0]), 0))
        for w in range(1, W):
            put(hot[w], _transfers(fresh(1), [LIMIT_ACCOUNT], [4], [10]), w)
            expect.append((int(hot[w]), int(CODE.ok if w <= ok_debits
                                            else CODE.exceeds_credits)))
    elif name == "interleaved":
        # a pending in wave w, resolved in wave w + 1 from a lower lane
        used = set()
        region = np.arange(base, base + min(HOT, n))
        for w in range(W - 1):
            pends = [x for x in region if wave_of[x] == w and x not in used]
            posts = [x for x in region if wave_of[x] == w + 1 and x not in used]
            if not pends or not posts or min(posts) >= max(pends):
                continue
            p, q = max(pends), min(posts)
            used.update((p, q))
            pend, amount = fresh(1), int(rng.integers(10, 1000))
            put(p, _transfers(pend, [3 + w % 40], [4 + w % 40], [amount]), w)
            batch["flags"][p] = F_PENDING
            put(q, _post_or_void(pend, fresh(1), amount, F_POST if w % 2 else F_VOID), w + 1)
            expect += [(int(p), 0), (int(q), 0)]
    elif name == "lopsided":
        lone = int(hot.min())  # the last wave's lane, below the pending's
        pend_lane = int(hot.max())
        pend, amount = fresh(1), int(rng.integers(10, 1000))
        put(pend_lane, _transfers(pend, [3], [4], [amount]), 0)
        batch["flags"][pend_lane] = F_PENDING
        put(lone, _post_or_void(pend, fresh(1), amount, F_POST), W - 1)
        expect += [(pend_lane, 0), (lone, 0)]
    elif name == "post_void_race":
        pend = fresh(1)
        put(hot[0], _transfers(pend, [3], [4], [100]), 0)
        batch["flags"][hot[0]] = F_PENDING
        for lane, flags, wave, code in (
                (hot[1], F_POST, 1, CODE.ok),
                (hot[2], F_VOID, 2 if W > 2 else -1,
                 CODE.pending_transfer_already_posted if W > 2 else 0)):
            t = _transfers(fresh(1), [0], [0], [0])
            t["ledger"] = t["code"] = 0
            t["flags"] = flags
            t["pending_id_lo"] = pend
            put(lane, t, wave)
            expect.append((int(lane), int(code)))
        expect.append((int(hot[0]), 0))
    rows = np.zeros((n_pad, 32), dtype=np.int32)
    rows[:n] = np.ascontiguousarray(batch).view(np.int32).reshape(-1, 32)
    return {"accounts": _accounts(), "rows": rows, "n": n, "W": W,
            "timestamp": T0 + 10 * N_ACCOUNTS + 4 * n_pad, "wave_of": wave_of, "pv": pv,
            "xfer_used": xfer_used, "fault": fault, "expect": expect,
            "fault_after": fault_after}


def wave_codes_ok(case: dict, codes: np.ndarray) -> list:
    """The case's expectations that `codes` (the call's codes, [n_pad])
    break, as (lane, want, got); lanes of no wave must give 0."""
    bad = [(lane, code, int(codes[lane])) for lane, code in case["expect"]
           if (codes[lane] == 0 if code is None else codes[lane] != code)]
    idle = np.nonzero((case["wave_of"] < 0) & (codes != 0))[0]
    return bad + [(int(i), 0, int(codes[i])) for i in idle]
