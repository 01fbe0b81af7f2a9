"""The sharded ledger on one card: owner-hashed shards behind StateMachine.

The counterpart of `tigerbeetle_tpu/parallel/mesh.py`, which shards the
account and transfer tables of one replica over the chips of a
`jax.sharding.Mesh` and runs every commit step under `shard_map`. Here the
S shards are slices of one allocation on one card: the tables are
`[S, capacity + 1, 32]` int32 tensors (each shard has its own dump row),
the per-shard insert counters `acct_used_slots` / `xfer_used_slots` are
int64 `[S]`, and `commit_ts`, `acct_count`, `xfer_count` and `fault` are
the replicated scalars. The names and the leaf order are the JAX ones, so
that a checkpoint blob restores in either package.

A key's owner shard is a second, independent hash (`owner_of_key4`); within
its owner a key probes that shard's table with the windowed double-hash
probes of the single-table ledger (ops/hashtable.py).

The JAX programs combine shards with a `psum` of owner-masked values:
each shard probes its own table for every lane, keeps what it owns, and
the sum has exactly one contribution per found lane (the owner's); an
unresolved probe counts on the owner only. So the sum equals the owner
shard's own probe. The plain versions here keep that structure, vectorised
over the shard axis (each shard probes all lanes, masks by owner, and a sum
over axis 0 stands for the `psum`; every write is owner-masked), and the
CUDA kernels (csrc/mesh_*.cu, K11) read the owner shard directly. Holding
one against the other on the card shows that the shortcut computes the
same function.

Tiers, chosen on the host as in the JAX package: a transfer batch goes to
the vectorised fast tier unless `HazardTracker.transfers_hazard` finds a
hazard (linked chains, post/void, balancing, duplicate ids, limit accounts,
the amount bound), and then to the exact serial scan; an account batch goes
serial for linked chains and duplicate ids. The fault protocol is the
single-table ledger's: the fast tiers decide PROBE, CLAIM, OVERFLOW and
CAPACITY over all shards before any write (the batch is then a no-op), the
serial tiers set FAULT_SERIAL for an unresolved probe (the state is then
corrupt). The fast tiers charge each shard's capacity with the inserts it
owns; the serial tiers charge all n events against every shard, and a
tripped gate makes the batch a no-op with every code 0.

Like the JAX kernels, the plain versions route masked writes nowhere but
the owner; the JAX kernels send the others to each shard's dump row, which
the port never writes. Checkpoints compare equal but for the dump rows.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from tigerbeetle_tpu_torch import kernels as _k
from tigerbeetle_tpu_torch import types
from tigerbeetle_tpu_torch.constants import ConfigProcess
from tigerbeetle_tpu_torch.models import validate
from tigerbeetle_tpu_torch.models.ledger import (
    FAULT_CAPACITY,
    FAULT_CLAIM,
    FAULT_OVERFLOW,
    FAULT_PROBE,
    FAULT_SERIAL,
    ROW_WORDS,
    HazardTracker,
    HostLedgerBase,
    _amount_digits,
    _check_device,
    _combined_overflow,
    _fault_bits,
    _fold_digits,
    _lane,
    _next_pow2,
    _occupied_rows,
    _set_ts_words,
    _to_rows_np,
    _words,
    applied_insert_mask,
    batch_timestamps,
    build_stored_transfer,
    pack_account,
    pack_transfer,
    raise_on_fault,
    unpack_account,
    unpack_transfer,
)
from tigerbeetle_tpu_torch.models.validate import F_LINKED, F_PENDING, F_POST, F_VOID
from tigerbeetle_tpu_torch.ops import hashtable as ht
from tigerbeetle_tpu_torch.ops import u128
from tigerbeetle_tpu_torch.types import Operation

I32 = torch.int32
I64 = torch.int64

# Owner-hash constants: the device hash (owner_of_key4), its host mirror
# (owner_of_ids_np) and csrc/owner.cuh share them, and so does the JAX
# package (tigerbeetle_tpu/parallel/mesh.py:98-102). Change none alone.
_OWNER_MIX = 0xD6E8FEB86659FD93
_OWNER_XOR = 0xA5A5A5A5A5A5A5A5
_OWNER_MUL2 = 0x94D049BB133111EB
_OWNER_SHIFT1 = 29
_OWNER_SHIFT2 = 32

# The leaves of a checkpoint blob, in order (the JAX `ShardedLedger`'s).
SNAP_SHARDED = (
    "acct_rows", "xfer_rows", "fulfill", "acct_claim", "xfer_claim",
    "bal_acc", "acct_used_slots", "xfer_used_slots",
)
SNAP_REPLICATED = ("commit_ts", "acct_count", "xfer_count", "fault")


def _umod(x, n: int):
    """x mod n for int64 lanes holding u64 bits (torch's `%` is a signed
    floor-mod): the 32-bit halves, each non-negative."""
    hi, lo = u128.srl(x, 32), x & 0xFFFFFFFF
    return ((hi % n) * ((1 << 32) % n) + lo % n) % n


def owner_of_key4(key4, n_shards: int):
    """Owner shard (int64) of each key [..., 4]: a hash independent of the
    slot hash."""
    k = key4.to(I64) & 0xFFFFFFFF
    lo = k[..., 0] | (k[..., 1] << 32)
    hi = k[..., 2] | (k[..., 3] << 32)
    mix = u128.to_i64(_OWNER_MIX)
    x = (lo ^ u128.to_i64(_OWNER_XOR)) * mix
    x = x ^ (hi * mix) ^ u128.srl(x, _OWNER_SHIFT1)
    x = x * u128.to_i64(_OWNER_MUL2)
    x = x ^ u128.srl(x, _OWNER_SHIFT2)
    return _umod(x, n_shards)


def owner_of_ids_np(id_lo: np.ndarray, id_hi: np.ndarray, n_shards: int) -> np.ndarray:
    """Host mirror of owner_of_key4 (for the per-shard occupancy guard)."""
    lo = id_lo.astype(np.uint64)
    hi = id_hi.astype(np.uint64)
    with np.errstate(over="ignore"):
        x = (lo ^ np.uint64(_OWNER_XOR)) * np.uint64(_OWNER_MIX)
        x = x ^ (hi * np.uint64(_OWNER_MIX)) ^ (x >> np.uint64(_OWNER_SHIFT1))
        x = x * np.uint64(_OWNER_MUL2)
        x = x ^ (x >> np.uint64(_OWNER_SHIFT2))
    return (x % np.uint64(n_shards)).astype(np.int64)


def init_sharded_state(n_shards: int, process: ConfigProcess, device) -> dict:
    """The sharded state on `device`: per shard 2^account_slots_log2 and
    2^transfer_slots_log2 slots plus a dump row. u32 words are int32, u64
    scalars int64, with the JAX state's bits."""
    a_rows = (1 << process.account_slots_log2) + 1
    t_rows = (1 << process.transfer_slots_log2) + 1

    def z(*shape, dtype=I32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return {
        "acct_rows": z(n_shards, a_rows, ROW_WORDS),
        "xfer_rows": z(n_shards, t_rows, ROW_WORDS),
        "fulfill": z(n_shards, t_rows),
        "acct_claim": torch.full((n_shards, a_rows), ht.CLAIM_FREE, dtype=I32, device=device),
        "xfer_claim": torch.full((n_shards, t_rows), ht.CLAIM_FREE, dtype=I32, device=device),
        "bal_acc": z(n_shards, a_rows, ROW_WORDS),
        # per-shard ever-applied inserts (the device-side load guard)
        "acct_used_slots": z(n_shards, dtype=I64),
        "xfer_used_slots": z(n_shards, dtype=I64),
        "commit_ts": z(dtype=I64),
        "acct_count": z(dtype=I64),
        "xfer_count": z(dtype=I64),
        "fault": z(dtype=I32),
    }


# ----------------------------------------------------------------------
# the owner-masked probe (the JAX `_find` / `_find1`)
# ----------------------------------------------------------------------


def _shards(rows):
    return torch.arange(rows.shape[0], device=rows.device)[:, None]


def _psum(x):
    """The sum over the shard axis that stands for the JAX `psum`."""
    return x.sum(0, dtype=x.dtype)


def _find(rows, key4, log2: int, window: int = ht.WINDOW, fulfill=None):
    """Every shard probes its table `rows` [S, N, 32] for every key [k, 4]
    and keeps the hits it owns. Returns (slot [S, k], mine [S, k], found
    [k], row [k, 32], resolved [k]) and, with `fulfill`, the found rows'
    fulfill words [k]: `found`, `row`, `resolved` and the words are
    combined over the shards (the JAX psum), `slot` and `mine` per shard."""
    sh = _shards(rows)
    own = owner_of_key4(key4, rows.shape[0])[None, :] == sh
    pos = ht.probe_positions(key4, log2, window)
    slot, found_l, res_l = ht.resolve(key4, pos, rows[:, pos, :4], window)
    mine = own & found_l
    row = _psum(torch.where(mine[..., None], rows[sh, slot], 0))
    out = (slot, mine, mine.any(0), row, ~(own & ~res_l).any(0))
    if fulfill is None:
        return out
    return out + (_psum(torch.where(mine, fulfill[sh, slot], 0)),)


def lookup_plain(rows, key4, log2: int):
    """Plain version of the sharded lookup (`_lookup_accounts_shard` /
    `_lookup_transfers_shard`): (found [k], rows [k, 32], resolved [k]);
    a missing key's row is all zero."""
    _, _, found, row, res = _find(rows, key4, log2)
    return found, row, res


def lookup(rows, key4, log2: int, raw: bool = False):
    """K11 lookup wrapper: the plain version for CPU tensors, the CUDA
    kernel else. Resolve is per lane: only the caller knows which lanes
    were requested. With `raw`, a CUDA table gives the kernel's one output
    buffer (`kernels.lookup_views` reads it) in place of its views."""
    if _check_device(rows):
        return (_k.mesh_lookup_raw if raw else _k.mesh_lookup)(key4, rows, log2)
    return lookup_plain(rows, key4, log2)


def _claim(state, table: str, key4, ins, log2: int):
    """Each shard claims insert slots for the lanes it owns (`ins` [S, B])
    in its own table, as `shard_map` runs `claim_slots`. Returns (slots
    [S, B], any lane unresolved)."""
    rows, claim = state[f"{table}_rows"], state[f"{table}_claim"]
    slots, res = zip(*(ht.claim_slots(key4, ins[s], rows[s], claim[s], log2)
                       for s in range(rows.shape[0])))
    return torch.stack(slots), ~torch.stack(res).all()


def _last_ts(ts_vec, ok):
    """The unsigned max of the timestamps of the ok lanes."""
    return (ts_vec[ok] ^ u128.SIGN).max() ^ u128.SIGN


# ----------------------------------------------------------------------
# fast tiers
# ----------------------------------------------------------------------


def commit_transfers_fast_plain(state, rows_b, n: int, timestamp: int,
                                a_log2: int, t_log2: int):
    """Plain version of the sharded fast transfer commit
    (`_commit_transfers_fast`). Updates `state` in place; returns the result
    codes (int32 [B], 0 for lanes >= n)."""
    acct_rows, xfer_rows = state["acct_rows"], state["xfer_rows"]
    S = acct_rows.shape[0]
    B = rows_b.shape[0]
    dev = rows_b.device
    a_dump = 1 << a_log2
    e = unpack_transfer(rows_b)
    valid = torch.arange(B, dtype=I64, device=dev) < n
    ts_vec = batch_timestamps(timestamp, n, B, dev)
    e_a = {**e, "ts": ts_vec}

    both_k4 = torch.cat([rows_b[:, 4:8], rows_b[:, 8:12]])
    b_slot, b_mine, b_found, b_row, b_res = _find(acct_rows, both_k4, a_log2)
    _, _, ex_found, ex_row, ex_res = _find(xfer_rows, rows_b[:, :4], t_log2)
    dr = unpack_account(b_row[:B])
    cr = unpack_account(b_row[B:])
    ex = unpack_transfer(ex_row)

    r0 = torch.where(e["ts"] != 0, 3, 0)
    r0 = validate.transfer_common(e, r0)
    r, amt_lo, amt_hi = validate.validate_simple_transfer(
        r0, e_a, dr, cr, b_found[:B], b_found[B:], ex, ex_found
    )
    r = torch.where(valid, r, 0)
    ok = valid & (r == 0)
    valid2 = torch.cat([valid, valid])
    probe_bad = (valid2 & ~b_res).any() | (valid & ~ex_res).any()

    # insert slots on the id's owner shard
    ins = ok & (owner_of_key4(rows_b[:, :4], S)[None, :] == _shards(acct_rows))
    ins_slots, claim_bad = _claim(state, "xfer", rows_b[:, :4], ins, t_log2)

    # owned balance deltas: 16-bit digits added into bal_acc, a carry fold
    # of every touched slot; other shards' lanes go to the dump row, which
    # ends zero again
    digits = _amount_digits(amt_lo, amt_hi)
    pending = (e["flags"] & F_PENDING) != 0
    zeros8 = torch.zeros_like(digits)
    pend8 = torch.where(pending[:, None], digits, zeros8)
    post8 = torch.where(pending[:, None], zeros8, digits)
    upd = torch.cat([
        torch.cat([pend8, post8, zeros8, zeros8], dim=-1),
        torch.cat([zeros8, zeros8, pend8, post8], dim=-1),
    ]).to(I32)
    sh = _shards(acct_rows)
    slots_t = torch.where(torch.cat([ok, ok])[None, :] & b_mine, b_slot, a_dump)
    acc = state["bal_acc"]
    flat = (sh * acc.shape[1] + slots_t).reshape(-1)
    acc.view(-1, ROW_WORDS).index_add_(0, flat, upd.repeat(S, 1))
    new_rows_t, over_t = _fold_digits(acct_rows[sh, slots_t], acc[sh, slots_t])
    over_bad = ((over_t | _combined_overflow(new_rows_t)) & (slots_t != a_dump)).any()
    acc[sh, slots_t] = 0

    # per-shard load guard over owned inserts
    ins_n = ins.sum(1)
    cap_bad = u128.ult((1 << t_log2) // 2, state["xfer_used_slots"] + ins_n).any()
    fault = state["fault"] | _fault_bits(
        (probe_bad, FAULT_PROBE), (claim_bad, FAULT_CLAIM),
        (over_bad, FAULT_OVERFLOW), (cap_bad, FAULT_CAPACITY),
    )
    state["fault"].copy_(fault)
    if int(fault) == 0:  # sticky: also no-ops every batch after a fault
        w = slots_t != a_dump
        acct_rows[sh.expand_as(slots_t)[w], slots_t[w]] = new_rows_t[w]
        s_i, lane = ins.nonzero(as_tuple=True)
        w = ins_slots[s_i, lane]
        xfer_rows[s_i, w] = _set_ts_words(rows_b, ts_vec)[lane]
        state["fulfill"][s_i, w] = 0
        state["xfer_used_slots"] += ins_n
        state["xfer_count"] += ok.sum()
        if bool(ok.any()):
            state["commit_ts"].copy_(_last_ts(ts_vec, ok))
    return r.to(I32)


def commit_accounts_fast_plain(state, rows_b, n: int, timestamp: int, a_log2: int):
    """Plain version of the sharded fast account commit
    (`_commit_accounts_fast`). Updates `state` in place; returns the result
    codes (int32 [B])."""
    acct_rows = state["acct_rows"]
    S = acct_rows.shape[0]
    B = rows_b.shape[0]
    dev = rows_b.device
    e = unpack_account(rows_b)
    valid = torch.arange(B, dtype=I64, device=dev) < n
    ts_vec = batch_timestamps(timestamp, n, B, dev)

    _, _, ex_found, ex_row, ex_res = _find(acct_rows, rows_b[:, :4], a_log2)
    ex = unpack_account(ex_row)
    r0 = torch.where(e["ts"] != 0, 3, 0)
    r = validate.validate_create_account(r0, e, ex, ex_found)
    r = torch.where(valid, r, 0)
    ok = valid & (r == 0)

    probe_bad = (valid & ~ex_res).any()
    ins = ok & (owner_of_key4(rows_b[:, :4], S)[None, :] == _shards(acct_rows))
    ins_slots, claim_bad = _claim(state, "acct", rows_b[:, :4], ins, a_log2)
    ins_n = ins.sum(1)
    cap_bad = u128.ult((1 << a_log2) // 2, state["acct_used_slots"] + ins_n).any()
    fault = state["fault"] | _fault_bits(
        (probe_bad, FAULT_PROBE), (claim_bad, FAULT_CLAIM), (cap_bad, FAULT_CAPACITY),
    )
    state["fault"].copy_(fault)
    if int(fault) == 0:
        s_i, lane = ins.nonzero(as_tuple=True)
        acct_rows[s_i, ins_slots[s_i, lane]] = _set_ts_words(rows_b, ts_vec)[lane]
        state["acct_used_slots"] += ins_n
        state["acct_count"] += ok.sum()
        if bool(ok.any()):
            state["commit_ts"].copy_(_last_ts(ts_vec, ok))
    return r.to(I32)


# ----------------------------------------------------------------------
# serial tiers (exact; hazard batches)
# ----------------------------------------------------------------------


def _serial_gate(state, used: str, n: int, log2: int):
    """Entry gates of a serial scan: the sticky fault, and the load guard
    charged for all n events against every shard. Returns (fault0, n)."""
    cap_bad = bool(u128.ult((1 << log2) // 2, state[used] + n).any())
    fault0 = int(state["fault"]) | (FAULT_CAPACITY if cap_bad else 0)
    return fault0, 0 if fault0 else n


def _head_code(in_chain: bool, last: bool, linked: bool, broken: bool, ts) -> int:
    """The first rungs of a serial ladder (linked_event_chain_open,
    linked_event_failed, timestamp_must_be_zero)."""
    if in_chain and last and linked:
        return 2
    if broken:
        return 1
    return 3 if int(ts) != 0 else 0


def _free_on_owner(rows, key4, log2: int, owner: int):
    """`probe_free` of one key on every shard, as each shard runs it; the
    owner's answer (slot, ok) is the one that counts."""
    pos = ht.probe_positions(key4, log2, ht.WINDOW_SCALAR)
    slot, ok = ht.resolve_free(pos, rows[:, pos, :4], ht.WINDOW_SCALAR)
    return int(slot[owner, 0]), bool(ok[owner, 0])


def _where_mine(mine, slot):
    """(shard, slot) of the one shard that owns a found key, else None."""
    s = mine.nonzero()
    return (int(s[0, 0]), int(slot[s[0, 0]])) if len(s) else None


def commit_transfers_serial_plain(state, rows_b, n: int, timestamp: int,
                                  a_log2: int, t_log2: int):
    """Plain version of the sharded serial transfer commit
    (`_commit_transfers_serial`): a Python loop over events, each validated
    against the tables as the events before it left them, every lookup an
    owner-masked probe of all shards. Updates `state` in place; returns the
    result codes (int32 [B])."""
    B = rows_b.shape[0]
    dev = rows_b.device
    acct_rows, xfer_rows = state["acct_rows"], state["xfer_rows"]
    fulfill = state["fulfill"]
    S = acct_rows.shape[0]
    W = ht.WINDOW_SCALAR
    fault0, n = _serial_gate(state, "xfer_used_slots", n, t_log2)
    ts_vec = batch_timestamps(timestamp, n, B, dev)
    owners = owner_of_key4(rows_b[:, :4], S).tolist()
    e_all = unpack_transfer(rows_b)
    results = [0] * B
    undo = [None] * n
    applied = [0] * S
    chain_start = -1
    chain_broken = False
    probe_bad = False
    commit_ts = state["commit_ts"].clone()
    tomb = torch.full((ROW_WORDS,), ht.TOMB_WORD, dtype=I32, device=dev)

    for i in range(n):
        e = _lane(e_all, i)
        row_e = rows_b[i:i + 1]
        flags = int(e["flags"])
        linked = bool(flags & F_LINKED)
        if linked and chain_start < 0:
            chain_start = i
        in_chain = chain_start >= 0
        ts = ts_vec[i:i + 1]
        e_a = {**e, "ts": ts}
        r_head = _head_code(in_chain, i == n - 1, linked, chain_broken, e["ts"])
        r0 = validate.transfer_common(e, torch.full((1,), r_head, dtype=I64, device=dev))

        a_slot, a_mine, a_found, a_rows, a_res = _find(
            acct_rows, torch.cat([row_e[:, 4:8], row_e[:, 8:12]]), a_log2, W)
        t_slot, t_mine, t_found, t_rows, t_res, t_ful = _find(
            xfer_rows, torch.cat([row_e[:, :4], row_e[:, 16:20]]), t_log2, W, fulfill)
        dr, cr = unpack_account(a_rows[0:1]), unpack_account(a_rows[1:2])
        ex, p = unpack_transfer(t_rows[0:1]), unpack_transfer(t_rows[1:2])
        p["fulfill"] = _words(t_ful[1:2])
        # the pending's accounts (post/void path): key 0 from the zero row
        # when the pending is missing, probed all the same
        pa_slot, pa_mine, _, pa_rows, pa_res = _find(
            acct_rows, torch.cat([t_rows[1:2, 4:8], t_rows[1:2, 8:12]]), a_log2, W)
        probe_bad |= not bool(a_res.all() & t_res.all() & pa_res.all())

        is_pv = bool(flags & (F_POST | F_VOID))
        if is_pv:
            r_t, amt_lo, amt_hi = validate.validate_post_void(
                r0, e_a, p, t_found[1:2], ex, t_found[0:1])
        else:
            r_t, amt_lo, amt_hi = validate.validate_simple_transfer(
                r0, e_a, dr, cr, a_found[0:1], a_found[1:2], ex, t_found[0:1])
        r = int(r_t)
        ok = r == 0
        is_post = is_pv and bool(flags & F_POST)
        is_pending = not is_pv and bool(flags & F_PENDING)

        # the insert goes to the id's owner shard only
        own = owners[i]
        free_slot, free_ok = _free_on_owner(xfer_rows, row_e[:, :4], t_log2, own)
        if ok:
            probe_bad |= not free_ok
            if free_ok:
                pv_t = torch.full((1,), is_pv, dtype=torch.bool, device=dev)
                xfer_rows[own, free_slot] = pack_transfer(
                    build_stored_transfer(e, p, pv_t, amt_lo, amt_hi, ts))[0]
                fulfill[own, free_slot] = 0
            p_at = _where_mine(t_mine[:, 1], t_slot[:, 1])
            if is_pv and p_at is not None:  # on the pending's owner shard
                fulfill[p_at] = 1 if is_post else 2

            # balances, on the accounts' owner shards (the pending's
            # accounts for post/void)
            src_slot, src_mine, src_rows = (
                (pa_slot, pa_mine, pa_rows) if is_pv else (a_slot, a_mine, a_rows))
            tdr, tcr = unpack_account(src_rows[0:1]), unpack_account(src_rows[1:2])
            posted = is_post or (not is_pv and not is_pending)
            for t, pend, post in ((tdr, "dp", "dpo"), (tcr, "cp", "cpo")):
                lo, hi = t[pend + "_lo"], t[pend + "_hi"]
                if is_pending:
                    lo, hi, _ = u128.add(lo, hi, amt_lo, amt_hi)
                if is_pv:
                    lo, hi, _ = u128.sub(lo, hi, p["amt_lo"], p["amt_hi"])
                t[pend + "_lo"], t[pend + "_hi"] = lo, hi
                if posted:
                    t[post + "_lo"], t[post + "_hi"], _ = u128.add(
                        t[post + "_lo"], t[post + "_hi"], amt_lo, amt_hi)
            dr_at = _where_mine(src_mine[:, 0], src_slot[:, 0])
            cr_at = _where_mine(src_mine[:, 1], src_slot[:, 1])
            if dr_at is not None:
                acct_rows[dr_at] = pack_account(tdr)[0]
            if cr_at is not None:
                acct_rows[cr_at] = pack_account(tcr)[0]
            commit_ts = ts[0].clone()
            kind = (3 if is_post else 4) if is_pv else (2 if is_pending else 1)
            undo[i] = (kind, dr_at, cr_at, (own, free_slot), p_at,
                       amt_lo, amt_hi, p["amt_lo"], p["amt_hi"])
            applied[own] += 1

        # chain break: roll back [chain_start, i) on every shard it touched
        if r != 0 and in_chain and not chain_broken:
            for k in range(chain_start, i):
                if undo[k] is None:
                    continue
                kd, dr_at, cr_at, t_at, p_at, ua_lo, ua_hi, up_lo, up_hi = undo[k]
                for at, pend, post in ((dr_at, "dp", "dpo"), (cr_at, "cp", "cpo")):
                    if at is None:
                        continue
                    f = unpack_account(acct_rows[at][None])
                    if kd in (3, 4):
                        f[pend + "_lo"], f[pend + "_hi"], _ = u128.add(
                            f[pend + "_lo"], f[pend + "_hi"], up_lo, up_hi)
                    if kd == 2:
                        f[pend + "_lo"], f[pend + "_hi"], _ = u128.sub(
                            f[pend + "_lo"], f[pend + "_hi"], ua_lo, ua_hi)
                    if kd in (1, 3):
                        f[post + "_lo"], f[post + "_hi"], _ = u128.sub(
                            f[post + "_lo"], f[post + "_hi"], ua_lo, ua_hi)
                    acct_rows[at] = pack_account(f)[0]
                xfer_rows[t_at] = tomb
                if kd in (3, 4) and p_at is not None:
                    fulfill[p_at] = 0
            for k in range(chain_start, i):
                results[k] = 1
            chain_broken = True
        results[i] = r
        if in_chain and (not linked or r == 2):
            chain_start = -1
            chain_broken = False

    state["commit_ts"].copy_(commit_ts)
    state["xfer_count"] += sum(1 for i in range(n) if results[i] == 0)
    state["xfer_used_slots"] += torch.tensor(applied, dtype=I64, device=dev)
    state["fault"].fill_(fault0 | (FAULT_SERIAL if probe_bad else 0))
    return torch.tensor(results, dtype=I32, device=dev)


def commit_accounts_serial_plain(state, rows_b, n: int, timestamp: int, a_log2: int):
    """Plain version of the sharded serial account commit
    (`_commit_accounts_serial`): a Python loop over events with linked-chain
    rollback (inserts tombstoned on their owner shard). Updates `state` in
    place; returns the result codes (int32 [B])."""
    B = rows_b.shape[0]
    dev = rows_b.device
    acct_rows = state["acct_rows"]
    S = acct_rows.shape[0]
    fault0, n = _serial_gate(state, "acct_used_slots", n, a_log2)
    ts_vec = batch_timestamps(timestamp, n, B, dev)
    owners = owner_of_key4(rows_b[:, :4], S).tolist()
    e_all = unpack_account(rows_b)
    results = [0] * B
    undo = [None] * n
    applied = [0] * S
    chain_start = -1
    chain_broken = False
    probe_bad = False
    commit_ts = state["commit_ts"].clone()
    tomb = torch.full((ROW_WORDS,), ht.TOMB_WORD, dtype=I32, device=dev)

    for i in range(n):
        e = _lane(e_all, i)
        row_e = rows_b[i:i + 1]
        linked = bool(int(e["flags"]) & validate.A_LINKED)
        if linked and chain_start < 0:
            chain_start = i
        in_chain = chain_start >= 0
        r_head = _head_code(in_chain, i == n - 1, linked, chain_broken, e["ts"])
        _, _, ex_found, ex_row, ex_res = _find(acct_rows, row_e[:, :4], a_log2,
                                               ht.WINDOW_SCALAR)
        r = int(validate.validate_create_account(
            torch.full((1,), r_head, dtype=I64, device=dev), e, unpack_account(ex_row),
            ex_found))
        ok = r == 0
        own = owners[i]
        free_slot, free_ok = _free_on_owner(acct_rows, row_e[:, :4], a_log2, own)
        probe_bad |= not bool(ex_res.all()) or (ok and not free_ok)
        if ok:
            if free_ok:
                acct_rows[own, free_slot] = _set_ts_words(row_e, ts_vec[i:i + 1])[0]
            commit_ts = ts_vec[i].clone()
            undo[i] = (own, free_slot)
            applied[own] += 1
        if r != 0 and in_chain and not chain_broken:
            for k in range(chain_start, i):
                if undo[k] is not None:
                    acct_rows[undo[k]] = tomb
                results[k] = 1
            chain_broken = True
        results[i] = r
        if in_chain and (not linked or r == 2):
            chain_start = -1
            chain_broken = False

    state["commit_ts"].copy_(commit_ts)
    state["acct_count"] += sum(1 for i in range(n) if results[i] == 0)
    state["acct_used_slots"] += torch.tensor(applied, dtype=I64, device=dev)
    state["fault"].fill_(fault0 | (FAULT_SERIAL if probe_bad else 0))
    return torch.tensor(results, dtype=I32, device=dev)


# ----------------------------------------------------------------------
# the wrappers: plain versions for CPU tensors, the CUDA kernels else
# ----------------------------------------------------------------------


def commit_transfers_fast(state, rows_b, n: int, timestamp: int, a_log2: int, t_log2: int):
    if _check_device(rows_b):
        return _k.mesh_commit_transfers_fast(state, rows_b, n, timestamp, a_log2, t_log2)
    return commit_transfers_fast_plain(state, rows_b, n, timestamp, a_log2, t_log2)


def commit_transfers_serial(state, rows_b, n: int, timestamp: int, a_log2: int, t_log2: int):
    if _check_device(rows_b):
        return _k.mesh_commit_transfers_serial(state, rows_b, n, timestamp, a_log2, t_log2)
    return commit_transfers_serial_plain(state, rows_b, n, timestamp, a_log2, t_log2)


def commit_accounts_fast(state, rows_b, n: int, timestamp: int, a_log2: int):
    if _check_device(rows_b):
        return _k.mesh_commit_accounts_fast(state, rows_b, n, timestamp, a_log2)
    return commit_accounts_fast_plain(state, rows_b, n, timestamp, a_log2)


def commit_accounts_serial(state, rows_b, n: int, timestamp: int, a_log2: int):
    if _check_device(rows_b):
        return _k.mesh_commit_accounts_serial(state, rows_b, n, timestamp, a_log2)
    return commit_accounts_serial_plain(state, rows_b, n, timestamp, a_log2)


class ShardedLedgerKernels:
    """The sharded commit and lookup entry points closed over the table
    geometry (the JAX `ShardedLedgerKernels`). The tier ("fast" /
    "serial") is the host's choice per batch."""

    def __init__(self, n_shards: int, process: ConfigProcess):
        self.n_shards = n_shards
        self.process = process
        self.a_log2 = process.account_slots_log2
        self.t_log2 = process.transfer_slots_log2

    def commit_transfers_fast(self, state, ev, n: int, timestamp: int):
        return commit_transfers_fast(state, ev["rows"], n, timestamp, self.a_log2, self.t_log2)

    def commit_transfers_serial(self, state, ev, n: int, timestamp: int):
        return commit_transfers_serial(state, ev["rows"], n, timestamp, self.a_log2,
                                       self.t_log2)

    def commit_accounts_fast(self, state, ev, n: int, timestamp: int):
        return commit_accounts_fast(state, ev["rows"], n, timestamp, self.a_log2)

    def commit_accounts_serial(self, state, ev, n: int, timestamp: int):
        return commit_accounts_serial(state, ev["rows"], n, timestamp, self.a_log2)

    def lookup_accounts(self, state, ids, raw: bool = False):
        return lookup(state["acct_rows"], ids["key4"], self.a_log2, raw)

    def lookup_transfers(self, state, ids, raw: bool = False):
        return lookup(state["xfer_rows"], ids["key4"], self.t_log2, raw)


# ----------------------------------------------------------------------
# the host-facing ledger
# ----------------------------------------------------------------------


def batch_rows(arr: np.ndarray) -> np.ndarray:
    """The wire rows of a batch (ACCOUNT_DTYPE / TRANSFER_DTYPE) as int32
    [n_pad, 32], zero-padded to the next power of two (at least 8), as the
    JAX ledger pads every batch."""
    rows = np.zeros((_next_pow2(len(arr)), ROW_WORDS), dtype=np.int32)
    rows[:len(arr)] = _to_rows_np(arr)
    return rows


class ShardedLedger(HostLedgerBase):
    """Host wrapper over the sharded kernels, a drop-in backend for
    StateMachine (prepare, execute_dense, lookups) like the JAX
    `ShardedLedger`: the host's HazardTracker picks the tier, a per-shard
    occupancy guard raises before dispatch (owner-hash skew fills one shard
    before the others), and the guard's charge is reconciled to the exact
    ever-applied count after each batch.

    `device` defaults to "cuda" and raises if CUDA is not available; pass
    `device="cpu"` to run the plain versions."""

    def __init__(self, n_shards: int, process: ConfigProcess, device=None):
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "ShardedLedger: CUDA is not available "
                    "(pass device='cpu' to run the plain versions)"
                )
            device = "cuda"
        self.device = torch.device(device)
        self.process = process
        self.n_shards = n_shards
        self.kernels = ShardedLedgerKernels(n_shards, process)
        self.state = init_sharded_state(n_shards, process, self.device)
        self.prepare_timestamp = 0
        self.hazards = HazardTracker()
        # per-shard occupancy guard: charged with every submission,
        # reconciled in execute_dense
        self._acct_used = np.zeros(n_shards, dtype=np.int64)
        self._xfer_used = np.zeros(n_shards, dtype=np.int64)
        self._acct_limit = (1 << process.account_slots_log2) // 2
        self._xfer_limit = (1 << process.transfer_slots_log2) // 2

    def _shard_counts(self, arr: np.ndarray) -> np.ndarray:
        owners = owner_of_ids_np(arr["id_lo"], arr["id_hi"], self.n_shards)
        return np.bincount(owners, minlength=self.n_shards)

    def execute_dense(self, operation, timestamp: int, events) -> list[int]:
        n = len(events)
        k = self.kernels
        if operation == Operation.create_transfers:
            arr = events if isinstance(events, np.ndarray) else types.transfers_to_np(events)
            counts = self._shard_counts(arr)
            if ((self._xfer_used + counts) > self._xfer_limit).any():
                raise RuntimeError(
                    "a transfer shard is at its load-factor limit: grow "
                    "ConfigProcess.transfer_slots_log2 (per-shard capacity)"
                )
            serial = self.hazards.transfers_hazard(arr)
            fn = k.commit_transfers_serial if serial else k.commit_transfers_fast
            used = self._xfer_used
        elif operation == Operation.create_accounts:
            arr = events if isinstance(events, np.ndarray) else types.accounts_to_np(events)
            counts = self._shard_counts(arr)
            if ((self._acct_used + counts) > self._acct_limit).any():
                raise RuntimeError(
                    "an account shard is at its load-factor limit: grow "
                    "ConfigProcess.account_slots_log2 (per-shard capacity)"
                )
            serial = self.hazards.accounts_hazard(arr)
            self.hazards.note_limit_accounts(arr)
            fn = k.commit_accounts_serial if serial else k.commit_accounts_fast
            used = self._acct_used
        else:
            raise ValueError(operation)
        used += counts
        batch = {"rows": torch.from_numpy(batch_rows(arr)).to(self.device)}
        results = fn(self.state, batch, n, timestamp)
        dense = results[:n].cpu().numpy().view(np.uint32).tolist()
        self.check_fault()
        # reconcile the estimate to the exact ever-applied count: inserts a
        # chain break rolled back leave tombstones on their owner shard
        not_applied = ~applied_insert_mask(dense, arr["flags"])
        if not_applied.any():
            used -= self._shard_counts(arr[not_applied])
        return dense

    def check_fault(self) -> None:
        raise_on_fault(int(self.state["fault"]), "sharded ledger")

    # -- parity extraction --

    def extract(self):
        """Pull the whole sharded state to host dicts (accounts, transfers,
        posted) for comparison against the oracle."""
        accounts: dict[int, types.Account] = {}
        transfers: dict[int, types.Transfer] = {}
        posted: dict[int, int] = {}
        acct = self.state["acct_rows"].cpu().numpy().view(np.uint32)
        xfer = self.state["xfer_rows"].cpu().numpy().view(np.uint32)
        ful = self.state["fulfill"].cpu().numpy().view(np.uint32)
        for s in range(self.n_shards):
            rows = acct[s][:-1]
            arr = np.frombuffer(rows[_occupied_rows(rows)].tobytes(), dtype=types.ACCOUNT_DTYPE)
            for a in arr:
                x = types.Account.from_np(a)
                accounts[x.id] = x
            rows = xfer[s][:-1]
            occ = _occupied_rows(rows)
            arr = np.frombuffer(rows[occ].tobytes(), dtype=types.TRANSFER_DTYPE)
            for t, f in zip(arr, ful[s][:-1][occ]):
                x = types.Transfer.from_np(t)
                transfers[x.id] = x
                if f:
                    posted[x.timestamp] = int(f)
        return accounts, transfers, posted

    # -- checkpoint / state sync (the replica's blob snapshot seam) --

    def snapshot_bytes(self) -> bytes:
        """The whole sharded state and the host's admission state as one
        blob: a little-endian u32 head length, the head JSON, then every
        leaf's bytes in SNAP_SHARDED + SNAP_REPLICATED order. The JAX
        `ShardedLedger.snapshot_bytes` layout, so either package restores
        the other's blob."""
        self.check_fault()
        parts = [self.state[k].cpu().numpy().tobytes() for k in SNAP_SHARDED + SNAP_REPLICATED]
        h = self.hazards
        head = json.dumps({
            "n_shards": self.n_shards,
            "acct_slots_log2": self.process.account_slots_log2,
            "xfer_slots_log2": self.process.transfer_slots_log2,
            "sizes": [len(p) for p in parts],
            "acct_used": self._acct_used.tolist(),
            "xfer_used": self._xfer_used.tolist(),
            "amount_sum": str(h.amount_sum),
            "limit_account_ids": [str(x) for x in sorted(h.limit_account_ids)],
        }, sort_keys=True).encode()
        return len(head).to_bytes(4, "little") + head + b"".join(parts)

    def restore_bytes(self, raw: bytes) -> None:
        """Replace the state with a `snapshot_bytes` blob of the same
        geometry (whatever its dump rows hold: they are never read)."""
        hn = int.from_bytes(raw[:4], "little")
        head = json.loads(raw[4:4 + hn])
        p = self.process
        if (head["n_shards"], head["acct_slots_log2"], head["xfer_slots_log2"]) != (
                self.n_shards, p.account_slots_log2, p.transfer_slots_log2):
            raise RuntimeError(
                "sharded checkpoint geometry mismatch: snapshot is "
                f"{head['n_shards']} shards @ 2^{head['acct_slots_log2']}/"
                f"2^{head['xfer_slots_log2']}, this ledger is "
                f"{self.n_shards} @ 2^{p.account_slots_log2}/2^{p.transfer_slots_log2}"
            )
        fresh = init_sharded_state(self.n_shards, p, self.device)
        off = 4 + hn
        for name, size in zip(SNAP_SHARDED + SNAP_REPLICATED, head["sizes"]):
            ref = fresh[name]
            if size != ref.numel() * ref.element_size():
                raise RuntimeError(f"sharded checkpoint: leaf {name} has {size} bytes")
            host = np.frombuffer(raw, dtype=np.int32 if ref.dtype == I32 else np.int64,
                                 count=ref.numel(), offset=off)
            ref.copy_(torch.from_numpy(host.reshape(ref.shape).copy()))
            off += size
        self.state = fresh
        self._acct_used = np.array(head["acct_used"], dtype=np.int64)
        self._xfer_used = np.array(head["xfer_used"], dtype=np.int64)
        h = self.hazards
        h.amount_sum = int(head["amount_sum"])
        h.limit_account_ids = {int(x) for x in head["limit_account_ids"]}
        h._limit_lo = np.sort(np.array(
            [int(x) & ((1 << 64) - 1) for x in head["limit_account_ids"]], dtype=np.uint64))
