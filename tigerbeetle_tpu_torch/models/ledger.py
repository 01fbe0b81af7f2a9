"""The device ledger: TigerBeetle's state machine over tables on a CUDA card.

The counterpart of `tigerbeetle_tpu/models/ledger.py`. The account and
transfer stores are open-addressing hash tables whose rows are the 128-byte
wire format (one `[capacity + 1, 32]` int32 tensor per table, see
ops/hashtable.py), and a batch commits in a few kernel launches. The state
is a dict of tensors on one device, and every commit updates it IN PLACE
(the JAX kernels donate their state and return a new one).

Execution tiers, chosen on the host by `HazardTracker.plan` (a copy of the
JAX planner, so both packages plan every batch identically):

- **fast / fast_pv**: all lookups, validation and application run
  data-parallel over the batch (`commit_transfers_fast`): probes and the
  validation ladder per lane, a deterministic slot claim, 16-bit amount
  digits added into the `bal_acc` scratch and folded into the u128
  balances, a fault gate, then the gated row scatters. fast_pv adds
  post/void of pendings already in the table.
- **waves**: a batch with true dependencies runs as a host loop of masked
  fast launches over one uploaded batch, in dependency order; lanes the
  masked kernel cannot express (linked chains, balancing) form a residue
  that the serial kernel commits last, with its events' original
  timestamps.
- **serial**: the exact event-at-a-time commit (`commit_transfers_serial`,
  `commit_accounts_serial`): linked-chain rollback through an undo log and
  tombstones, in-batch post/void, balancing clamps, duplicate ids.
- **group**: up to GROUP_KS[0] quorum-ready fast-tier batches of the
  replica commit as one fused dispatch (`try_execute_group_async`, K5),
  slot after slot, with one summary read for the whole group.

Besides the commit path: the state fingerprint (K6, the digest the replica
folds into its commitment chain), the reply-code fold (K7, the digest the
dual-commit follower chains over every batch's codes, models/dual_ledger.py),
the snapshot row install (K9, the restore path after a checkpoint restore or
a state-sync jump) and the equality filter scan behind the secondary-index
queries (K8, `query_accounts` / `query_transfers`).

With an LSM forest attached (`DeviceLedger(forest=...)`), the transfer
table is bounded: its cold tail spills to the forest and referenced rows
reload before a commit (models/spill.py, K10), and lookups, queries and
`extract` merge the spilled rows back in.

Every kernel has a plain PyTorch version here (`*_plain`); the wrappers run
it for CPU tensors and launch the CUDA kernel (tigerbeetle_tpu_torch.kernels)
for CUDA tensors. The plain versions and the kernels share their semantics
with the JAX package bit for bit: result codes, the sticky `fault` word and
every table row except the dump row, which the JAX kernels fill with
garbage by design and the port never writes.

**Fault protocol** (as in the JAX package): a probe window or the claim
rounds can, with ~2^-32 probability per op at the enforced load factor of
1/2, run out. The fast kernel detects it before writing, turns the commit
into a no-op and sets the sticky `fault` word; every later commit is then a
no-op too. The serial kernels apply as they go, so an unresolved probe there
sets FAULT_SERIAL: the state is corrupt. An install row that finds no free
slot sets FAULT_INSTALL. The host raises on a non-zero word.
"""

from __future__ import annotations

from time import perf_counter_ns

import numpy as np
import torch

from tigerbeetle_tpu_torch import kernels as _k
from tigerbeetle_tpu_torch import types
from tigerbeetle_tpu_torch.constants import DEFAULT_PROCESS, ConfigProcess
from tigerbeetle_tpu_torch.lsm import groove as groove_fields
from tigerbeetle_tpu_torch.metrics import NULL_METRICS
from tigerbeetle_tpu_torch.models import validate
from tigerbeetle_tpu_torch.models.validate import (
    F_BAL_CR,
    F_BAL_DR,
    F_LINKED,
    F_PENDING,
    F_POST,
    F_VOID,
)
from tigerbeetle_tpu_torch.ops import hashtable as ht
from tigerbeetle_tpu_torch.ops import u128
from tigerbeetle_tpu_torch.tracer import NULL_TRACER
from tigerbeetle_tpu_torch.types import Operation

I32 = torch.int32
I64 = torch.int64

# Conflict-wave scheduling (HazardTracker.plan): the deepest dependency
# chain the wave path executes, the planner's propagation sweeps, and its
# hash multipliers.
WAVE_CAP = 24
_WAVE_SWEEPS = 8
_WAVE_GOLDEN = np.uint64(0x9E3779B97F4A7C15)
_WAVE_GOLDEN2 = np.uint64(0xC2B2AE3D27D4EB4F)

ROW_WORDS = 32  # 128-byte wire rows as u32 words

# Flags that force the serial tier in the all-or-nothing hazard check of the
# sharded ledger (`HazardTracker.transfers_hazard`): linked | post | void |
# balancing_debit | balancing_credit. Only no-flag and pending-only events
# are safe on its fast tier.
_SLOW_FLAGS = 0b111101

# Equality-query field specs: name -> (first u32 word, word count, halfword),
# derived from the one declaration of the indexed field layouts
# (lsm/groove.py, the reference's secondary index trees,
# src/state_machine.zig:103-206), so that the device filter scan and the LSM
# index scan agree on every field name.


def _query_words(index_fields) -> dict:
    out = {}
    for name, off, w in index_fields:
        assert off % 4 == 0 and w in (2, 4, 8, 16), (name, off, w)
        out[name] = (off // 4, max(w // 4, 1), w == 2)
    return out


ACCOUNT_QUERY_WORDS = _query_words(groove_fields.ACCOUNT_INDEX_FIELDS)
TRANSFER_QUERY_WORDS = _query_words(groove_fields.TRANSFER_INDEX_FIELDS)
# Query replies are message-bounded like every other reply (reference:
# src/state_machine.zig:59-64: results must fit one message).
QUERY_LIMIT = 8192

# Sticky fault bits (see module docstring "Fault protocol").
FAULT_PROBE = 1  # fast-tier lookup window exhausted (batch was a no-op)
FAULT_CLAIM = 2  # fast-tier claim rounds exhausted (batch was a no-op)
FAULT_OVERFLOW = 4  # device-side overflow backstop tripped (batch was a no-op)
FAULT_SERIAL = 8  # serial-tier probe window exhausted: STATE IS CORRUPT
FAULT_CAPACITY = 16  # device-side load-factor guard tripped (batch no-op)
FAULT_INSTALL = 1 << 30  # snapshot install: a row found no free slot

_FAULT_NAMES = (
    (FAULT_PROBE, "probe-window"),
    (FAULT_CLAIM, "claim-rounds"),
    (FAULT_OVERFLOW, "overflow-backstop"),
    (FAULT_SERIAL, "serial-probe"),
    (FAULT_CAPACITY, "capacity-guard"),
    (FAULT_INSTALL, "install-probe"),
)


def raise_on_fault(fault: int, what: str) -> None:
    """Decode a non-zero fault word into an exception."""
    if not fault:
        return
    bits = [name for bit, name in _FAULT_NAMES if fault & bit]
    corrupt = (
        " (serial tier: device state is CORRUPT)"
        if fault & FAULT_SERIAL
        else " (the faulting batch and everything after were no-ops)"
    )
    raise RuntimeError(
        f"{what} fault {fault:#x} [{', '.join(bits)}]{corrupt}: "
        "grow the table (slots_log2) or lower the load factor"
    )


# ----------------------------------------------------------------------
# wire-row pack/unpack (word offsets = byte offsets / 4 of the extern
# structs, reference: src/tigerbeetle.zig:7-40 Account, :64-89 Transfer).
# Rows are int32 words; fields come out as int64 lanes (u64 fields hold
# their 64 bits, u32/u16 fields their value).
# ----------------------------------------------------------------------


def _words(r):
    return r.to(I64) & 0xFFFFFFFF


def _w64(w, i: int):
    return w[..., i] | (w[..., i + 1] << 32)


def _lohi(x):
    return x & 0xFFFFFFFF, u128.srl(x, 32)


def _stack_words(words):
    """int64 lanes holding u32 values -> int32 words (same bits)."""
    return torch.stack(words, dim=-1).to(I32)


def unpack_transfer(r) -> dict:
    w = _words(r)
    return {
        "id_lo": _w64(w, 0), "id_hi": _w64(w, 2),
        "dr_lo": _w64(w, 4), "dr_hi": _w64(w, 6),
        "cr_lo": _w64(w, 8), "cr_hi": _w64(w, 10),
        "amt_lo": _w64(w, 12), "amt_hi": _w64(w, 14),
        "pid_lo": _w64(w, 16), "pid_hi": _w64(w, 18),
        "ud128_lo": _w64(w, 20), "ud128_hi": _w64(w, 22),
        "ud64": _w64(w, 24),
        "ud32": w[..., 26],
        "timeout": w[..., 27],
        "ledger": w[..., 28],
        "code": w[..., 29] & 0xFFFF,
        "flags": w[..., 29] >> 16,
        "ts": _w64(w, 30),
    }


def pack_transfer(f):
    words = []
    for key in ("id", "dr", "cr", "amt", "pid", "ud128"):
        words += [*_lohi(f[key + "_lo"]), *_lohi(f[key + "_hi"])]
    words += [*_lohi(f["ud64"]), f["ud32"], f["timeout"], f["ledger"],
              (f["code"] & 0xFFFF) | (f["flags"] << 16)]
    words += [*_lohi(f["ts"])]
    return _stack_words(words)


def unpack_account(r) -> dict:
    w = _words(r)
    return {
        "id_lo": _w64(w, 0), "id_hi": _w64(w, 2),
        "dp_lo": _w64(w, 4), "dp_hi": _w64(w, 6),
        "dpo_lo": _w64(w, 8), "dpo_hi": _w64(w, 10),
        "cp_lo": _w64(w, 12), "cp_hi": _w64(w, 14),
        "cpo_lo": _w64(w, 16), "cpo_hi": _w64(w, 18),
        "ud128_lo": _w64(w, 20), "ud128_hi": _w64(w, 22),
        "ud64": _w64(w, 24),
        "ud32": w[..., 26],
        "reserved": w[..., 27],
        "ledger": w[..., 28],
        "code": w[..., 29] & 0xFFFF,
        "flags": w[..., 29] >> 16,
        "ts": _w64(w, 30),
    }


def pack_account(f):
    words = []
    for key in ("id", "dp", "dpo", "cp", "cpo", "ud128"):
        words += [*_lohi(f[key + "_lo"]), *_lohi(f[key + "_hi"])]
    words += [*_lohi(f["ud64"]), f["ud32"], f["reserved"], f["ledger"],
              (f["code"] & 0xFFFF) | (f["flags"] << 16)]
    words += [*_lohi(f["ts"])]
    return _stack_words(words)


def key4_from_fields(f):
    return _stack_words([*_lohi(f["id_lo"]), *_lohi(f["id_hi"])])


# ----------------------------------------------------------------------
# state
# ----------------------------------------------------------------------


def init_state(process: ConfigProcess, device) -> dict:
    """Allocate the ledger on `device`. Tables have capacity+1 rows: the last
    row is the JAX kernels' write dump (never read, never written here).
    `bal_acc` is the balance-digit accumulator (all-zero between commits),
    `fault` the sticky fault word. u32 words are int32 and u64 scalars int64
    tensors holding the same bits as the JAX state's uint32/uint64."""
    a_rows = (1 << process.account_slots_log2) + 1
    t_rows = (1 << process.transfer_slots_log2) + 1

    def z(*shape, dtype=I32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return {
        "acct_rows": z(a_rows, ROW_WORDS),
        "xfer_rows": z(t_rows, ROW_WORDS),
        "fulfill": z(t_rows),
        "acct_claim": torch.full((a_rows,), ht.CLAIM_FREE, dtype=I32, device=device),
        "xfer_claim": torch.full((t_rows,), ht.CLAIM_FREE, dtype=I32, device=device),
        "bal_acc": z(a_rows, ROW_WORDS),
        "commit_ts": z(dtype=I64),
        "acct_count": z(dtype=I64),
        "xfer_count": z(dtype=I64),
        # ever-applied inserts (rolled-back ones INCLUDED: their tombstones
        # still lengthen probe chains): the device-side load-factor guard
        "acct_used_slots": z(dtype=I64),
        "xfer_used_slots": z(dtype=I64),
        "fault": z(dtype=I32),
    }


# ----------------------------------------------------------------------
# host <-> device batch conversion (one upload of the wire bytes)
# ----------------------------------------------------------------------


def _to_rows_np(arr: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(arr).view(np.int32).reshape(len(arr), ROW_WORDS)


def transfers_to_batch(arr: np.ndarray, device) -> dict:
    """Wire-format structured array (types.TRANSFER_DTYPE) -> device batch."""
    return {"rows": torch.from_numpy(_to_rows_np(arr)).to(device)}


def accounts_to_batch(arr: np.ndarray, device) -> dict:
    return {"rows": torch.from_numpy(_to_rows_np(arr)).to(device)}


def ids_to_batch(ids: list[int], device) -> dict:
    k4 = np.zeros((len(ids), 4), dtype=np.uint32)
    for i, x in enumerate(ids):
        lo, hi = types.split_u128(x)
        k4[i] = (lo & 0xFFFFFFFF, lo >> 32, hi & 0xFFFFFFFF, hi >> 32)
    return {"key4": torch.from_numpy(k4.view(np.int32)).to(device)}


# ----------------------------------------------------------------------
# digit helpers
# ----------------------------------------------------------------------


def _amount_digits(amt_lo, amt_hi):
    """u128 -> 8 x 16-bit digits (int64 lanes), little-endian."""
    ds = [(limb >> (16 * j)) & 0xFFFF for limb in (amt_lo, amt_hi) for j in range(4)]
    return torch.stack(ds, dim=-1)


def _fold_digits(row32, acc32):
    """Fold a [.., 32] digit accumulator into a [.., 32] wire row's 4 balance
    fields (words 4..19) with 16-bit carry propagation. acc lanes: dp digits
    0..7, dpo 8..15, cp 16..23, cpo 24..31. Returns (new_row, overflow)."""
    w_in = _words(row32)
    acc = _words(acc32)
    new_words = [w_in[..., i] for i in range(ROW_WORDS)]
    overflow = torch.zeros(row32.shape[:-1], dtype=torch.bool, device=row32.device)
    for field in range(4):  # dp, dpo, cp, cpo at words 4+4f .. 7+4f
        w0 = 4 + 4 * field
        carry = torch.zeros_like(w_in[..., 0])
        for k in range(4):  # 4 words x two 16-bit digits
            w = w_in[..., w0 + k]
            s_lo = (w & 0xFFFF) + acc[..., 8 * field + 2 * k] + carry
            carry = s_lo >> 16
            s_hi = (w >> 16) + acc[..., 8 * field + 2 * k + 1] + carry
            carry = s_hi >> 16
            new_words[w0 + k] = ((s_lo & 0xFFFF) | (s_hi << 16)) & 0xFFFFFFFF
        overflow = overflow | (carry != 0)
    return _stack_words(new_words), overflow


def _fold_digits_signed(row32, acc32):
    """Signed variant of _fold_digits for the post/void fast tier: the
    accumulator words hold mod-2^32 sums of SIGNED 16-bit digits, |sum| <
    2^30, so the int32 word is the exact signed value; the fold runs in
    int64 with arithmetic-shift carries. A nonzero final carry is an
    overflow or an underflow. Returns (new_row, bad)."""
    w_in = _words(row32)
    acc = acc32.to(I64)  # sign-extends: the int32 bitcast
    new_words = [w_in[..., i] for i in range(ROW_WORDS)]
    bad = torch.zeros(row32.shape[:-1], dtype=torch.bool, device=row32.device)
    for field in range(4):
        w0 = 4 + 4 * field
        carry = torch.zeros_like(w_in[..., 0])
        for k in range(4):
            w = w_in[..., w0 + k]
            s_lo = (w & 0xFFFF) + acc[..., 8 * field + 2 * k] + carry
            carry = s_lo >> 16
            s_hi = (w >> 16) + acc[..., 8 * field + 2 * k + 1] + carry
            carry = s_hi >> 16
            new_words[w0 + k] = (s_lo & 0xFFFF) | ((s_hi & 0xFFFF) << 16)
        bad = bad | (carry != 0)
    return _stack_words(new_words), bad


def _combined_overflow(new_rows_t):
    """Per-lane carry of the combined debits_pending+debits_posted and
    credits_pending+credits_posted sums of folded account rows (codes 51/52
    guard these sums, reference: src/state_machine.zig:856-861)."""
    nr = unpack_account(new_rows_t)
    _, _, c_dr = u128.add(nr["dp_lo"], nr["dp_hi"], nr["dpo_lo"], nr["dpo_hi"])
    _, _, c_cr = u128.add(nr["cp_lo"], nr["cp_hi"], nr["cpo_lo"], nr["cpo_hi"])
    return c_dr | c_cr


def build_stored_transfer(e, p, is_pv, amt_lo, amt_hi, ts) -> dict:
    """The row a create_transfers event STORES: post/void events inherit the
    pending's routing fields, default their user data from it, and persist
    the resolved amount (reference: src/state_machine.zig:907-1014)."""

    def dflt128(t_lo, t_hi, q_lo, q_hi):
        z = u128.is_zero(t_lo, t_hi)
        return torch.where(z, q_lo, t_lo), torch.where(z, q_hi, t_hi)

    def pick(key):
        return torch.where(is_pv, p[key], e[key])

    t2_ud128 = dflt128(e["ud128_lo"], e["ud128_hi"], p["ud128_lo"], p["ud128_hi"])
    return {
        "id_lo": e["id_lo"], "id_hi": e["id_hi"],
        "dr_lo": pick("dr_lo"), "dr_hi": pick("dr_hi"),
        "cr_lo": pick("cr_lo"), "cr_hi": pick("cr_hi"),
        "amt_lo": amt_lo, "amt_hi": amt_hi,
        "pid_lo": e["pid_lo"], "pid_hi": e["pid_hi"],
        "ud128_lo": torch.where(is_pv, t2_ud128[0], e["ud128_lo"]),
        "ud128_hi": torch.where(is_pv, t2_ud128[1], e["ud128_hi"]),
        "ud64": torch.where(is_pv & (e["ud64"] == 0), p["ud64"], e["ud64"]),
        "ud32": torch.where(is_pv & (e["ud32"] == 0), p["ud32"], e["ud32"]),
        "timeout": torch.where(is_pv, 0, e["timeout"]),
        "ledger": pick("ledger"),
        "code": pick("code"),
        "flags": e["flags"],
        "ts": ts,
    }


def _set_ts_words(rows, ts):
    t0, t1 = _lohi(ts)
    return torch.cat([rows[:, :30], t0.to(I32)[:, None], t1.to(I32)[:, None]], dim=1)


def _umax(a, b):
    """Unsigned max of int64 lanes."""
    return torch.where(u128.ult(a, b), b, a)


def batch_timestamps(timestamp: int, n: int, B: int, device):
    """Per-event commit timestamps timestamp - n + i + 1 (u64, as int64)."""
    lane = torch.arange(B, dtype=I64, device=device)
    return u128.to_i64(timestamp - n + 1) + lane


def _fault_bits(*pairs):
    """OR of `bit` for every (flag tensor, bit) pair, as an int32 tensor."""
    out = None
    for flag, bit in pairs:
        term = flag.to(I32) * bit
        out = term if out is None else out | term
    return out


def _check_device(t):
    """True for a CUDA tensor (kernel), False for a CPU one (plain)."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


# ----------------------------------------------------------------------
# K1: lookups (reference: src/state_machine.zig:701-736)
# ----------------------------------------------------------------------


def table_lookup_plain(key4, rows, cap_log2: int):
    """Plain version of K1: the W=32 probe plus the 128-byte row gather.
    Returns (found bool [B], rows int32 [B, 32], resolved bool [B])."""
    slot, found, res = ht.lookup(key4, rows, cap_log2)
    return found, rows[slot], res


def table_lookup(key4, rows, cap_log2: int, raw: bool = False):
    """K1 wrapper (`LedgerKernels._lookup_*` in the JAX package). Resolve is
    per lane: only the caller knows which lanes were requested. With `raw`,
    a CUDA table gives the kernel's one output buffer (`kernels.lookup_views`
    reads it) in place of its views."""
    if _check_device(rows):
        return (_k.lookup_raw if raw else _k.lookup)(key4, rows, cap_log2)
    return table_lookup_plain(key4, rows, cap_log2)


# ----------------------------------------------------------------------
# K3: fast / fast_pv transfer commit
# ----------------------------------------------------------------------


def commit_transfers_fast_plain(state, rows_b, n: int, timestamp: int,
                                a_log2: int, t_log2: int, pv_mode: bool,
                                mask=None):
    """Plain version of K3 (`LedgerKernels._commit_transfers`, modes fast and
    fast_pv, with the wave mask). Updates `state` in place; returns the
    result codes (int32 [B], 0 for lanes >= n or outside the mask)."""
    B = rows_b.shape[0]
    dev = rows_b.device
    e = unpack_transfer(rows_b)
    lane = torch.arange(B, dtype=I64, device=dev)
    valid = lane < n
    if mask is not None:  # wave executor: only this wave's lanes are live
        valid = valid & mask
    ts_vec = batch_timestamps(timestamp, n, B, dev)
    e_a = {**e, "ts": ts_vec}

    acct_rows = state["acct_rows"]
    xfer_rows = state["xfer_rows"]
    # dr and cr probe the same table: one 2B-lane lookup
    both_k4 = torch.cat([rows_b[:, 4:8], rows_b[:, 8:12]])
    both_slot, both_found, both_res = ht.lookup(both_k4, acct_rows, a_log2)
    both_rows = acct_rows[both_slot]
    dr_slot, cr_slot = both_slot[:B], both_slot[B:]
    dr_row, cr_row = both_rows[:B], both_rows[B:]
    ex_slot, ex_found, ex_res = ht.lookup(rows_b[:, :4], xfer_rows, t_log2)
    dr = unpack_account(dr_row)
    cr = unpack_account(cr_row)
    ex = unpack_transfer(xfer_rows[ex_slot])

    r0 = torch.where(e["ts"] != 0, 3, 0)
    r0 = validate.transfer_common(e, r0)
    r, amt_lo, amt_hi = validate.validate_simple_transfer(
        r0, e_a, dr, cr, both_found[:B], both_found[B:], ex, ex_found
    )
    valid2 = torch.cat([valid, valid])
    probe_bad = (valid2 & ~both_res).any() | (valid & ~ex_res).any()

    if pv_mode:
        # pending rows + fulfill, then the pendings' accounts
        is_pv = (e["flags"] & (F_POST | F_VOID)) != 0
        p_slot, p_found, p_res = ht.lookup(rows_b[:, 16:20], xfer_rows, t_log2)
        p_rows = xfer_rows[p_slot]
        p = unpack_transfer(p_rows)
        p["fulfill"] = _words(state["fulfill"][p_slot])
        pb_slot, _, pb_res = ht.lookup(
            torch.cat([p_rows[:, 4:8], p_rows[:, 8:12]]), acct_rows, a_log2
        )
        pb_rows = acct_rows[pb_slot]
        r_pv, amt_pv_lo, amt_pv_hi = validate.validate_post_void(
            r0, e_a, p, p_found, ex, ex_found
        )
        r = torch.where(is_pv, r_pv, r)
        amt_lo = torch.where(is_pv, amt_pv_lo, amt_lo)
        amt_hi = torch.where(is_pv, amt_pv_hi, amt_hi)
        pvv = valid & is_pv
        probe_bad = (
            probe_bad | (pvv & ~p_res).any()
            | (torch.cat([pvv, pvv]) & ~pb_res).any()
        )
    else:
        is_pv = torch.zeros(B, dtype=torch.bool, device=dev)

    r = torch.where(valid, r, 0)
    ok = valid & (r == 0)

    # claim insert slots (rows are written below, after gating)
    ins_slots, ins_res = ht.claim_slots(
        rows_b[:, :4], ok, xfer_rows, state["xfer_claim"], t_log2
    )
    claim_bad = (~ins_res).any()

    # balance deltas: 16-bit digits added into bal_acc, then a carry fold of
    # every touched slot. acc lanes: dp 0..7 / dpo 8..15 / cp 16..23 / cpo 24..31
    digits = _amount_digits(amt_lo, amt_hi)
    pending = (e["flags"] & F_PENDING) != 0
    zeros8 = torch.zeros_like(digits)
    if pv_mode:
        # post/void SUBTRACT the pending's amount from the pending balances
        # of the PENDING's accounts; a post adds the resolved amount to the
        # posted balances
        is_post = is_pv & ((e["flags"] & F_POST) != 0)
        neg_p = -_amount_digits(p["amt_lo"], p["amt_hi"])
        simple = ~is_pv
        pend8 = torch.where((simple & pending)[:, None], digits, zeros8) + \
            torch.where(is_pv[:, None], neg_p, zeros8)
        post8 = torch.where((simple & ~pending)[:, None], digits, zeros8) + \
            torch.where(is_post[:, None], digits, zeros8)
        dr_slot = torch.where(is_pv, pb_slot[:B], dr_slot)
        cr_slot = torch.where(is_pv, pb_slot[B:], cr_slot)
        dr_row = torch.where(is_pv[:, None], pb_rows[:B], dr_row)
        cr_row = torch.where(is_pv[:, None], pb_rows[B:], cr_row)
    else:
        pend8 = torch.where(pending[:, None], digits, zeros8)
        post8 = torch.where(pending[:, None], zeros8, digits)
    upd = torch.cat([
        torch.cat([pend8, post8, zeros8, zeros8], dim=-1),  # debit side
        torch.cat([zeros8, zeros8, pend8, post8], dim=-1),  # credit side
    ])
    ok2 = torch.cat([ok, ok])
    slots_t = torch.cat([dr_slot, cr_slot])[ok2]
    acc = state["bal_acc"]
    acc.index_add_(0, slots_t, upd[ok2].to(I32))
    acc_t = acc[slots_t]
    old_rows_t = torch.cat([dr_row, cr_row])[ok2]
    fold = _fold_digits_signed if pv_mode else _fold_digits
    new_rows_t, over_t = fold(old_rows_t, acc_t)
    over_bad = (over_t | _combined_overflow(new_rows_t)).any()
    acc[slots_t] = 0  # restore all-zero

    # device-side load-factor guard, independent of the host's estimate
    ok_n = ok.sum()
    cap_bad = u128.ult((1 << t_log2) // 2, state["xfer_used_slots"] + ok_n)
    fault = state["fault"] | _fault_bits(
        (probe_bad, FAULT_PROBE), (claim_bad, FAULT_CLAIM),
        (over_bad, FAULT_OVERFLOW), (cap_bad, FAULT_CAPACITY),
    )
    state["fault"].copy_(fault)
    if int(fault) == 0:  # sticky: also no-ops every batch after a fault
        if pv_mode:
            ins_rows = pack_transfer(
                build_stored_transfer(e, p, is_pv, amt_lo, amt_hi, ts_vec)
            )
        else:
            ins_rows = _set_ts_words(rows_b, ts_vec)
        # lanes touching one account all write the same folded row
        acct_rows[slots_t] = new_rows_t
        w = ins_slots[ok]
        xfer_rows[w] = ins_rows[ok]
        state["fulfill"][w] = 0
        if pv_mode:
            res = ok & is_pv
            state["fulfill"][p_slot[res]] = torch.where(is_post, 1, 2)[res].to(I32)
        if bool(ok.any()):
            # max, not set: waves run lanes out of order
            last = ts_vec[ok]
            last = (last ^ u128.SIGN).max() ^ u128.SIGN
            state["commit_ts"].copy_(_umax(state["commit_ts"], last))
        state["xfer_count"] += ok_n
        state["xfer_used_slots"] += ok_n
    return r.to(I32)


def commit_transfers_fast(state, rows_b, n: int, timestamp: int,
                          a_log2: int, t_log2: int, pv_mode: bool, mask=None):
    """K3 wrapper: the plain version for CPU tensors, the CUDA kernel else."""
    if _check_device(rows_b):
        return _k.commit_transfers_fast(
            state, rows_b, mask, n, timestamp, a_log2, t_log2, pv_mode
        )
    return commit_transfers_fast_plain(
        state, rows_b, n, timestamp, a_log2, t_log2, pv_mode, mask
    )


# ----------------------------------------------------------------------
# K12: the conflict waves of one batch
# ----------------------------------------------------------------------


def commit_transfers_waves_plain(state, rows_b, wave_of, n_waves: int, n: int,
                                 timestamp: int, a_log2: int, t_log2: int,
                                 pv_mode: bool):
    """Plain version of K12 (`DeviceLedger._wave_stepper`): for w = 0 ..
    n_waves - 1, the masked fast (or fast_pv) commit of the lanes with
    wave_of == w, each wave seeing the state the wave before it left; a
    fault makes every later wave a no-op (K3's sticky gate). Each lane is
    live in one wave and 0 elsewhere, so the codes fold with a max. Updates
    `state` in place; returns int32 codes [B]."""
    results = torch.zeros(rows_b.shape[0], dtype=I32, device=rows_b.device)
    for w in range(n_waves):
        r = commit_transfers_fast_plain(state, rows_b, n, timestamp, a_log2, t_log2,
                                        pv_mode, wave_of == w)
        results = torch.maximum(results, r)
    return results


def commit_transfers_waves(state, rows_b, wave_of, n_waves: int, n: int, timestamp: int,
                           a_log2: int, t_log2: int, pv_mode: bool):
    """K12 wrapper: the plain version for CPU tensors, the CUDA kernel else
    (`wave_of` uint8, 255 for the lanes of no wave)."""
    if _check_device(rows_b):
        return _k.wave_commit(state, rows_b, wave_of, n_waves, n, timestamp,
                              a_log2, t_log2, pv_mode)
    return commit_transfers_waves_plain(state, rows_b, wave_of, n_waves, n, timestamp,
                                        a_log2, t_log2, pv_mode)


# ----------------------------------------------------------------------
# K5: fused group commit of k fast-tier batches
# ----------------------------------------------------------------------

# Group capacities: a run of items pads to the smallest that holds it, with
# zero-count slots (the JAX package's `DeviceLedger.GROUP_KS`).
GROUP_KS = (16, 4)


def commit_transfers_group_plain(state, rows, ns, tss, a_log2: int, t_log2: int):
    """Plain version of K5 (`DeviceLedger._group_stepper`): the fast commit
    of each slot of `rows` [k, n_pad, 32] in order (slot i: lanes < ns[i],
    timestamp tss[i]), each seeing the state the slot before it left; a
    fault makes every later slot a no-op (K3's sticky gate). Updates
    `state` in place; returns (flat int32 [k * n_pad + 1]: the codes, then
    the fault word; summary int32 [k + 1]: each slot's count of non-zero
    codes over lanes < ns[i], then the fault word)."""
    k, n_pad = rows.shape[:2]
    results = torch.stack([
        commit_transfers_fast_plain(state, rows[i], int(ns[i]), int(tss[i]),
                                    a_log2, t_log2, False)
        for i in range(k)
    ])
    lane = torch.arange(n_pad, dtype=I64, device=rows.device)
    n_col = torch.as_tensor(np.asarray(ns, dtype=np.int64), device=rows.device)[:, None]
    counts = ((results != 0) & (lane < n_col)).sum(dim=1).to(I32)
    f = state["fault"].reshape(1)
    return torch.cat([results.reshape(-1), f]), torch.cat([counts, f])


def commit_transfers_group(state, rows, ns, tss, a_log2: int, t_log2: int):
    """K5 wrapper: the plain version for CPU tensors, the CUDA kernel else."""
    if _check_device(rows):
        return _k.group_commit(state, rows, ns, tss, a_log2, t_log2)
    return commit_transfers_group_plain(state, rows, ns, tss, a_log2, t_log2)


# ----------------------------------------------------------------------
# K4: exact serial transfer commit
# ----------------------------------------------------------------------


def _lane(d: dict, i: int) -> dict:
    return {k: v[i:i + 1] for k, v in d.items()}


def commit_transfers_serial_plain(state, rows_b, ts_vec, n: int,
                                  a_log2: int, t_log2: int):
    """Plain version of K4 (`LedgerKernels._serial_transfers_core`): a Python
    loop over events, each validated against the tables as the events
    before it left them. Timestamps are explicit per event (the residue
    keeps its events' original batch timestamps). Updates `state` in place;
    returns the result codes (int32 [B])."""
    B = rows_b.shape[0]
    dev = rows_b.device
    acct_rows, xfer_rows = state["acct_rows"], state["xfer_rows"]
    fulfill = state["fulfill"]
    W = ht.WINDOW_SCALAR
    # entry gates: sticky fault + the load-factor guard, charged for all n
    # events (the scan applies as it goes and cannot un-apply)
    cap_bad = bool(u128.ult((1 << t_log2) // 2, state["xfer_used_slots"] + n))
    fault0 = int(state["fault"]) | (FAULT_CAPACITY if cap_bad else 0)
    if fault0:
        n = 0

    e_all = unpack_transfer(rows_b)
    results = [0] * B
    undo = [None] * n
    chain_start = -1
    chain_broken = False
    probe_bad = False
    commit_ts = state["commit_ts"].reshape(1).clone()
    tomb = torch.full((ROW_WORDS,), ht.TOMB_WORD, dtype=I32, device=dev)

    def look(key4, rows, log2):
        slot, found, res = ht.lookup(key4, rows, log2, window=W)
        return slot, found, bool(res)

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

        if in_chain and i == n - 1 and linked:
            r_head = 2  # linked_event_chain_open
        elif chain_broken:
            r_head = 1  # linked_event_failed
        elif int(e["ts"]) != 0:
            r_head = 3  # timestamp_must_be_zero
        else:
            r_head = 0
        r0 = validate.transfer_common(e, torch.full((1,), r_head, dtype=I64, device=dev))

        dr_slot, dr_found, res1 = look(row_e[:, 4:8], acct_rows, a_log2)
        cr_slot, cr_found, res2 = look(row_e[:, 8:12], acct_rows, a_log2)
        ex_slot, ex_found, res3 = look(row_e[:, :4], xfer_rows, t_log2)
        p_slot, p_found, res4 = look(row_e[:, 16:20], xfer_rows, t_log2)
        dr = unpack_account(acct_rows[dr_slot])
        cr = unpack_account(acct_rows[cr_slot])
        ex = unpack_transfer(xfer_rows[ex_slot])
        p_row = xfer_rows[p_slot]
        p = unpack_transfer(p_row)
        p["fulfill"] = _words(fulfill[p_slot])
        # the pending's accounts (post/void path); garbage when ~p_found
        pdr_slot, _, res5 = look(p_row[:, 4:8], acct_rows, a_log2)
        pcr_slot, _, res6 = look(p_row[:, 8:12], acct_rows, a_log2)
        pdr = unpack_account(acct_rows[pdr_slot])
        pcr = unpack_account(acct_rows[pcr_slot])
        probe_bad |= not (res1 and res2 and res3 and res4 and res5 and res6)

        is_pv = bool(flags & (F_POST | F_VOID))
        if is_pv:
            r_t, amt_lo, amt_hi = validate.validate_post_void(
                r0, e_a, p, p_found, ex, ex_found
            )
        else:
            r_t, amt_lo, amt_hi = validate.validate_simple_transfer(
                r0, e_a, dr, cr, dr_found, cr_found, ex, ex_found
            )
        r = int(r_t)
        ok = r == 0
        is_post = is_pv and bool(flags & F_POST)
        is_pending = not is_pv and bool(flags & F_PENDING)

        free_slot, free_ok = ht.probe_free(row_e[:, :4], xfer_rows, t_log2)
        free_ok = bool(free_ok)
        kind = 0
        if ok:
            probe_bad |= not free_ok
            if free_ok:
                pv_t = torch.full((1,), is_pv, dtype=torch.bool, device=dev)
                xfer_rows[free_slot] = pack_transfer(
                    build_stored_transfer(e, p, pv_t, amt_lo, amt_hi, ts)
                )
                fulfill[free_slot] = 0
            if is_pv:
                fulfill[p_slot] = 1 if is_post else 2

            # balance application (onto the pending's accounts for post/void)
            tgt_dr, tdr = (pdr_slot, pdr) if is_pv else (dr_slot, dr)
            tgt_cr, tcr = (pcr_slot, pcr) if is_pv else (cr_slot, cr)
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
                        t[post + "_lo"], t[post + "_hi"], amt_lo, amt_hi
                    )
            acct_rows[tgt_dr] = pack_account(tdr)
            acct_rows[tgt_cr] = pack_account(tcr)
            # max, not set: earlier waves may have committed later lanes
            commit_ts = _umax(commit_ts, ts)
            kind = (3 if is_post else 4) if is_pv else (2 if is_pending else 1)
            undo[i] = (kind, tgt_dr, tgt_cr, free_slot, p_slot,
                       amt_lo, amt_hi, p["amt_lo"], p["amt_hi"])

        # chain break: roll back [chain_start, i)
        if r != 0 and in_chain and not chain_broken:
            for k in range(chain_start, i):
                if undo[k] is None:
                    continue
                kd, drs, crs, ts_slot, ps, ua_lo, ua_hi, up_lo, up_hi = undo[k]
                fdr = unpack_account(acct_rows[drs])
                fcr = unpack_account(acct_rows[crs])
                for f, pend, post in ((fdr, "dp", "dpo"), (fcr, "cp", "cpo")):
                    if kd in (3, 4):
                        f[pend + "_lo"], f[pend + "_hi"], _ = u128.add(
                            f[pend + "_lo"], f[pend + "_hi"], up_lo, up_hi
                        )
                    if kd == 2:
                        f[pend + "_lo"], f[pend + "_hi"], _ = u128.sub(
                            f[pend + "_lo"], f[pend + "_hi"], ua_lo, ua_hi
                        )
                    if kd in (1, 3):
                        f[post + "_lo"], f[post + "_hi"], _ = u128.sub(
                            f[post + "_lo"], f[post + "_hi"], ua_lo, ua_hi
                        )
                acct_rows[drs] = pack_account(fdr)
                acct_rows[crs] = pack_account(fcr)
                xfer_rows[ts_slot] = tomb
                if kd in (3, 4):
                    fulfill[ps] = 0
            for k in range(chain_start, i):
                results[k] = 1
            chain_broken = True
        results[i] = r
        if in_chain and (not linked or r == 2):
            chain_start = -1
            chain_broken = False

    ok_n = sum(1 for i in range(n) if results[i] == 0)
    applied_n = sum(1 for u in undo if u is not None)
    state["commit_ts"].copy_(commit_ts.reshape(()))
    state["xfer_count"] += ok_n
    state["xfer_used_slots"] += applied_n
    state["fault"].fill_(fault0 | (FAULT_SERIAL if probe_bad else 0))
    return torch.tensor(results, dtype=I32, device=dev)


def commit_transfers_serial(state, rows_b, ts_vec, n: int, a_log2: int, t_log2: int):
    """K4 wrapper: the plain version for CPU tensors, the CUDA kernel else."""
    if _check_device(rows_b):
        return _k.commit_transfers_serial(state, rows_b, ts_vec, n, a_log2, t_log2)
    return commit_transfers_serial_plain(state, rows_b, ts_vec, n, a_log2, t_log2)


# ----------------------------------------------------------------------
# K2: account commit (fast and serial)
# ----------------------------------------------------------------------


def commit_accounts_fast_plain(state, rows_b, n: int, timestamp: int, a_log2: int):
    """Plain version of K2 fast (`LedgerKernels._commit_accounts`). Updates
    `state` in place; returns the result codes (int32 [B])."""
    B = rows_b.shape[0]
    dev = rows_b.device
    e = unpack_account(rows_b)
    valid = torch.arange(B, dtype=I64, device=dev) < n
    ts_vec = batch_timestamps(timestamp, n, B, dev)
    acct_rows = state["acct_rows"]

    ex_slot, ex_found, ex_res = ht.lookup(rows_b[:, :4], acct_rows, a_log2)
    ex = unpack_account(acct_rows[ex_slot])
    r0 = torch.where(e["ts"] != 0, 3, 0)
    r = validate.validate_create_account(r0, e, ex, ex_found)
    r = torch.where(valid, r, 0)
    ok = valid & (r == 0)

    probe_bad = (valid & ~ex_res).any()
    ins_slots, ins_res = ht.claim_slots(
        rows_b[:, :4], ok, acct_rows, state["acct_claim"], a_log2
    )
    claim_bad = (~ins_res).any()
    ok_n = ok.sum()
    cap_bad = u128.ult((1 << a_log2) // 2, state["acct_used_slots"] + ok_n)
    fault = state["fault"] | _fault_bits(
        (probe_bad, FAULT_PROBE), (claim_bad, FAULT_CLAIM),
        (cap_bad, FAULT_CAPACITY),
    )
    state["fault"].copy_(fault)
    if int(fault) == 0:
        acct_rows[ins_slots[ok]] = _set_ts_words(rows_b, ts_vec)[ok]
        if bool(ok.any()):
            last = (ts_vec[ok] ^ u128.SIGN).max() ^ u128.SIGN
            state["commit_ts"].copy_(last)
        state["acct_count"] += ok_n
        state["acct_used_slots"] += ok_n
    return r.to(I32)


def commit_accounts_serial_plain(state, rows_b, n: int, timestamp: int, a_log2: int):
    """Plain version of K2 serial (`LedgerKernels._serial_accounts`): a Python
    loop over events with linked-chain rollback (inserts tombstoned).
    Updates `state` in place; returns the result codes (int32 [B])."""
    B = rows_b.shape[0]
    dev = rows_b.device
    acct_rows = state["acct_rows"]
    cap_bad = bool(u128.ult((1 << a_log2) // 2, state["acct_used_slots"] + n))
    fault0 = int(state["fault"]) | (FAULT_CAPACITY if cap_bad else 0)
    if fault0:
        n = 0
    ts_vec = batch_timestamps(timestamp, n, B, dev)
    e_all = unpack_account(rows_b)
    results = [0] * B
    undo = [None] * n
    chain_start = -1
    chain_broken = False
    probe_bad = False
    commit_ts = state["commit_ts"].reshape(1).clone()
    tomb = torch.full((ROW_WORDS,), ht.TOMB_WORD, dtype=I32, device=dev)

    for i in range(n):
        e = _lane(e_all, i)
        row_e = rows_b[i:i + 1]
        linked = bool(int(e["flags"]) & F_LINKED)
        if linked and chain_start < 0:
            chain_start = i
        in_chain = chain_start >= 0
        if in_chain and i == n - 1 and linked:
            r_head = 2
        elif chain_broken:
            r_head = 1
        elif int(e["ts"]) != 0:
            r_head = 3
        else:
            r_head = 0
        ex_slot, ex_found, ex_res = ht.lookup(
            row_e[:, :4], acct_rows, a_log2, window=ht.WINDOW_SCALAR
        )
        ex = unpack_account(acct_rows[ex_slot])
        r = int(validate.validate_create_account(
            torch.full((1,), r_head, dtype=I64, device=dev), e, ex, ex_found
        ))
        ok = r == 0
        free_slot, free_ok = ht.probe_free(row_e[:, :4], acct_rows, a_log2)
        free_ok = bool(free_ok)
        probe_bad |= (not bool(ex_res)) or (ok and not free_ok)
        if ok:
            if free_ok:
                acct_rows[free_slot] = _set_ts_words(row_e, ts_vec[i:i + 1])
            commit_ts = ts_vec[i:i + 1]
            undo[i] = free_slot
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

    state["commit_ts"].copy_(commit_ts.reshape(()))
    state["acct_count"] += sum(1 for i in range(n) if results[i] == 0)
    state["acct_used_slots"] += sum(1 for u in undo if u is not None)
    state["fault"].fill_(fault0 | (FAULT_SERIAL if probe_bad else 0))
    return torch.tensor(results, dtype=I32, device=dev)


def commit_accounts_fast(state, rows_b, n: int, timestamp: int, a_log2: int):
    """K2 fast wrapper: the plain version for CPU tensors, the CUDA kernel else."""
    if _check_device(rows_b):
        return _k.commit_accounts_fast(state, rows_b, n, timestamp, a_log2)
    return commit_accounts_fast_plain(state, rows_b, n, timestamp, a_log2)


def commit_accounts_serial(state, rows_b, n: int, timestamp: int, a_log2: int):
    """K2 serial wrapper: the plain version for CPU tensors, the CUDA kernel else."""
    if _check_device(rows_b):
        return _k.commit_accounts_serial(state, rows_b, n, timestamp, a_log2)
    return commit_accounts_serial_plain(state, rows_b, n, timestamp, a_log2)


# ----------------------------------------------------------------------
# K6: state fingerprint (the dual-commit and commitment-chain digest)
#
# An order-independent digest over LIVE table rows: the wrapping u64 sum of
# a per-row hash of the 128-byte wire image. The JAX package and its native
# engine (tb_ledger_fingerprint) compute the identical function, so two
# ledgers that applied the same prepares agree iff their row sets are
# bit-identical, whatever their slot layout. Change no constant alone.
# ----------------------------------------------------------------------

_FP_SEED = np.uint64(0x9E3779B97F4A7C15)
_FP_MUL = np.uint64(0xC2B2AE3D27D4EB4F)
_FP_ADD = np.uint64(0x165667B19E3779F9)
_FP_MIX1 = np.uint64(0xFF51AFD7ED558CCD)
_FP_MIX2 = np.uint64(0xC4CEB9FE1A85EC53)

# The order of the words of `state_fingerprint_vec`.
FP_KEYS = ("accounts_fp", "transfers_fp", "accounts", "transfers", "commit_timestamp")


def _fp_mix(x):
    """The murmur3 finalizer on int64 lanes holding u64 bits."""
    x = (x ^ u128.srl(x, 33)) * u128.to_i64(int(_FP_MIX1))
    x = (x ^ u128.srl(x, 33)) * u128.to_i64(int(_FP_MIX2))
    return x ^ u128.srl(x, 33)


def _fp_rows(rows):
    """[S, 32] int32 table -> (u64 hash sum over live rows, live count), as
    0-d int64 tensors. Empty (key words all 0) and tombstone (all
    0xFFFFFFFF) rows are excluded. One column at a time, so a full table
    needs no [S, 32] int64 copy."""
    seed = u128.to_i64(int(_FP_SEED))
    mul = u128.to_i64(int(_FP_MUL))
    add = u128.to_i64(int(_FP_ADD))
    h = torch.full((rows.shape[0],), seed, dtype=I64, device=rows.device)
    for i in range(ROW_WORDS):
        h = h ^ ((rows[:, i].to(I64) & 0xFFFFFFFF) * mul)
        h = ((h << 27) | u128.srl(h, 37)) * seed + add
    h = _fp_mix(h)
    live = ht.occupied_mask(rows)
    return torch.where(live, h, 0).sum(), live.sum()


def state_fingerprint_plain(state):
    """Plain version of K6 (`state_fingerprint` of the JAX package): int64
    [5] in FP_KEYS order. The trailing dump row is excluded."""
    afp, alive = _fp_rows(state["acct_rows"][:-1])
    tfp, tlive = _fp_rows(state["xfer_rows"][:-1])
    return torch.stack([afp, tfp, alive, tlive, state["commit_ts"]])


def state_fingerprint_vec(state):
    """K6 wrapper: the plain version for CPU tensors, the CUDA kernel else."""
    if _check_device(state["acct_rows"]):
        return _k.fingerprint(state["acct_rows"], state["xfer_rows"], state["commit_ts"])
    return state_fingerprint_plain(state)


def state_fingerprint(state) -> dict:
    """The digest as {FP_KEYS: 0-d int64 tensor holding u64 bits}, on the
    state's device (no host read)."""
    return dict(zip(FP_KEYS, state_fingerprint_vec(state).unbind()))


def fp_rows_np(rows: np.ndarray) -> tuple:
    """The numpy twin of _fp_rows over 128-byte wire rows (structured
    ACCOUNT_DTYPE/TRANSFER_DTYPE arrays or raw [n, 32] u32) -> (fp, live)
    as Python ints. The per-row hash depends on the content only and the
    sum commutes, so host row images in any order give the device's digest."""
    if rows.dtype != np.uint32:
        rows = np.ascontiguousarray(rows).view(np.uint32)
    rows = rows.reshape(-1, ROW_WORDS)
    if len(rows) == 0:
        return 0, 0
    with np.errstate(over="ignore"):
        h = np.full(rows.shape[0], _FP_SEED, dtype=np.uint64)
        for i in range(ROW_WORDS):
            h = h ^ (rows[:, i].astype(np.uint64) * _FP_MUL)
            h = ((h << np.uint64(27)) | (h >> np.uint64(37))) * _FP_SEED + _FP_ADD
        h = (h ^ (h >> np.uint64(33))) * _FP_MIX1
        h = (h ^ (h >> np.uint64(33))) * _FP_MIX2
        h = h ^ (h >> np.uint64(33))
        k4 = rows[:, :4]
        live = ~(k4 == 0).all(axis=1) & ~(k4 == 0xFFFFFFFF).all(axis=1)
        return (
            int(np.sum(np.where(live, h, np.uint64(0)), dtype=np.uint64)),
            int(np.sum(live, dtype=np.uint64)),
        )


# ----------------------------------------------------------------------
# K7: the reply-code fold (reference seam: src/testing/hash_log.zig)
#
# A chained digest of the dense reply-code stream: each batch's codes hash
# to one u64 (the wrapping sum over its lanes < n of a per-lane mix), which
# is chained into the running value. The JAX package folds on the device,
# and the native engine's codes fold on the host (fold_reply_codes_np); the
# dual-commit follower compares the two. Change no constant alone.
# ----------------------------------------------------------------------


def _fold_batch_h(flat, n_pad: int, ns):
    """int64 [k]: slot j's wrapping u64 sum over its lanes < ns[j] of
    mix(zext(code) * FP_MUL + lane + 1)."""
    k = len(ns)
    codes = flat[:k * n_pad].reshape(k, n_pad).to(I64) & 0xFFFFFFFF
    lane = torch.arange(n_pad, dtype=I64, device=flat.device)
    m = _fp_mix(codes * u128.to_i64(int(_FP_MUL)) + lane + 1)
    n = torch.as_tensor(np.asarray(ns, dtype=np.int64), device=flat.device)
    return torch.where(lane < n[:, None], m, 0).sum(1)


def fold_codes_plain(chk, flat, n_pad: int, ns, active, ring=None, idxs=None) -> None:
    """Plain version of K7, in place: folds the k = len(ns) slots of `flat`
    (int32, slot j at [j * n_pad, (j + 1) * n_pad), lanes < ns[j]) into the
    chain `chk` (0-d int64 holding u64 bits); an inactive slot leaves the
    chain as it is. With a `ring` (int64), ring[idxs[j]] takes the chain
    value after slot j, in slot order. The JAX forms: `fold_reply_codes`
    (k = 1), `_fold_ring_fn` (k = 1 with a ring), `_fold_group_fn` and
    `_fold_group_ring_fn` (up to 16 slots)."""
    batch_h = _fold_batch_h(flat, n_pad, ns)
    c = chk.clone()
    for j, n in enumerate(ns):
        if active[j]:
            c = _fp_mix(c ^ (batch_h[j] + int(n)))
        if ring is not None:
            ring[int(idxs[j])] = c
    chk.copy_(c)


def fold_codes(chk, flat, n_pad: int, ns, active, ring=None, idxs=None) -> None:
    """K7 wrapper: the plain version for CPU tensors, the CUDA kernel else.
    `ns`, `active` and `idxs` are host sequences."""
    if _check_device(flat):
        return _k.fold(chk, flat, n_pad, ns, active, ring, idxs)
    return fold_codes_plain(chk, flat, n_pad, ns, active, ring, idxs)


def fold_reply_codes_np(chk: int, codes: np.ndarray) -> int:
    """The numpy twin of K7 for one batch (the JAX `fold_reply_codes`) over
    the native engine's dense u32
    codes (exact u64 wraparound): the host side of the comparison."""
    with np.errstate(over="ignore"):
        def mix(x):
            x = (x ^ (x >> np.uint64(33))) * _FP_MIX1
            x = (x ^ (x >> np.uint64(33))) * _FP_MIX2
            return x ^ (x >> np.uint64(33))

        lane = np.arange(len(codes), dtype=np.uint64)
        m = mix(codes.astype(np.uint64) * _FP_MUL + lane + np.uint64(1))
        batch_h = np.sum(m, dtype=np.uint64)
        return int(mix(np.uint64(chk) ^ (batch_h + np.uint64(len(codes)))))


# ----------------------------------------------------------------------
# K9: snapshot row install
# ----------------------------------------------------------------------


def install_rows_plain(state, table: str, rows_b, ful_b, n: int, cap_log2: int):
    """Plain version of K9 (`DeviceLedger._install_fn`): claim a slot for
    each row image of `rows_b` (lanes < n) in the `table` ("acct" or
    "xfer") and write it, with its fulfill word from `ful_b` for transfers.
    Resolved lanes add to the table's count and used slots; an unresolved
    active lane sets FAULT_INSTALL. Not gated on an earlier fault. Updates
    `state` in place."""
    rows = state[f"{table}_rows"]
    active = torch.arange(rows_b.shape[0], dtype=I64, device=rows_b.device) < n
    slots, resolved = ht.claim_slots(
        rows_b[:, :4], active, rows, state[f"{table}_claim"], cap_log2
    )
    ok = active & resolved
    w = slots[ok]
    rows[w] = rows_b[ok]
    if ful_b is not None:
        state["fulfill"][w] = ful_b[ok]
    nn = ok.sum()
    state[f"{table}_count"] += nn
    state[f"{table}_used_slots"] += nn
    state["fault"] |= (active & ~resolved).any().to(I32) * FAULT_INSTALL


def install_rows_chunked_plain(state, table: str, rows, ful, cap_log2: int, chunk: int):
    """Plain version of K9 over a whole table: `install_rows_plain` on the
    chunks of `chunk` rows of `rows` [n, 32] (and `ful` [n], None for
    accounts), in order, as install_snapshot_rows drives `_install_fn`."""
    for i in range(0, rows.shape[0], chunk):
        part = rows[i:i + chunk]
        install_rows_plain(state, table, part, None if ful is None else ful[i:i + chunk],
                           part.shape[0], cap_log2)


def install_rows_chunked(state, table: str, rows, ful, cap_log2: int, chunk: int):
    """K9 wrapper over a whole table: the plain version for CPU tensors, one
    CUDA launch else."""
    if _check_device(rows):
        return _k.install_rows_chunked(state, table, rows, ful, cap_log2, chunk)
    return install_rows_chunked_plain(state, table, rows, ful, cap_log2, chunk)


# ----------------------------------------------------------------------
# K8: the equality filter scan (secondary-index queries over the tables)
# ----------------------------------------------------------------------


def filter_scan_plain(rows, spec, value_words):
    """Plain version of K8 (`LedgerKernels.filter_scan`): the live rows of
    `rows` (the dump row excluded) whose field `spec` = (word0, nwords,
    halfword) equals `value_words` (four u32 ints, low first; a half-word
    field compares the low 16 bits of word0). Returns (int32 [QUERY_LIMIT,
    32]: the first matches in slot order, padded with the dump row; int32
    0-d: the total match count)."""
    word0, nwords, halfword = spec
    dump = rows.shape[0] - 1
    occ = ht.occupied_mask(rows)
    occ[dump] = False
    vw = [int(v) & 0xFFFFFFFF for v in value_words]
    if halfword:
        m = (rows[:, word0].to(I64) & 0xFFFF) == vw[0]
    else:
        m = (rows[:, word0].to(I64) & 0xFFFFFFFF) == vw[0]
        for i in range(1, nwords):
            m = m & ((rows[:, word0 + i].to(I64) & 0xFFFFFFFF) == vw[i])
    mask = occ & m
    total = mask.sum().to(I32)
    hits = torch.nonzero(mask).squeeze(1)[:QUERY_LIMIT]
    idx = torch.full((QUERY_LIMIT,), dump, dtype=I64, device=rows.device)
    idx[:hits.shape[0]] = hits
    return rows[idx], total


def filter_scan(rows, cap_log2: int, spec, value_words):
    """K8 wrapper: the plain version for CPU tensors, the CUDA kernel else."""
    if _check_device(rows):
        return _k.filter_scan(rows, cap_log2, spec, value_words)
    return filter_scan_plain(rows, spec, value_words)


# ----------------------------------------------------------------------
# the kernels behind one table geometry
# ----------------------------------------------------------------------


class LedgerKernels:
    """The commit and lookup entry points closed over the table geometry
    (the counterpart of the JAX `LedgerKernels`). `mode` selects the tier:
    "fast"/"fast_pv" (vectorized; only sound on batches the host proved
    hazard-free) or "serial" (the exact scan)."""

    def __init__(self, process: ConfigProcess = DEFAULT_PROCESS):
        self.process = process
        self.a_log2 = process.account_slots_log2
        self.t_log2 = process.transfer_slots_log2

    def commit_transfers(self, state, ev, n: int, timestamp: int, mode: str = "fast"):
        rows = ev["rows"]
        if mode == "serial":
            ts_vec = batch_timestamps(timestamp, n, rows.shape[0], rows.device)
            return self.commit_transfers_residue(state, {"rows": rows, "ts": ts_vec}, n)
        if mode not in ("fast", "fast_pv"):
            raise ValueError(mode)
        return commit_transfers_fast(
            state, rows, n, timestamp, self.a_log2, self.t_log2,
            mode == "fast_pv", ev.get("mask"),
        )

    def commit_waves(self, state, rows, wave_of, n_waves: int, n: int, timestamp: int,
                     mode: str = "fast"):
        """The n_waves conflict waves of one batch (K12): wave w's lanes are
        those with wave_of == w (uint8, 255 for none)."""
        if mode not in ("fast", "fast_pv"):
            raise ValueError(mode)
        return commit_transfers_waves(
            state, rows, wave_of, n_waves, n, timestamp, self.a_log2, self.t_log2,
            mode == "fast_pv",
        )

    def commit_transfers_residue(self, state, ev, n: int):
        """The serial scan over a compacted residue with explicit per-event
        timestamps (`ev["ts"]`, u64 as int64)."""
        return commit_transfers_serial(
            state, ev["rows"], ev["ts"], n, self.a_log2, self.t_log2
        )

    def commit_accounts(self, state, ev, n: int, timestamp: int, mode: str = "fast"):
        if mode == "serial":
            return commit_accounts_serial(state, ev["rows"], n, timestamp, self.a_log2)
        if mode != "fast":
            raise ValueError(mode)
        return commit_accounts_fast(state, ev["rows"], n, timestamp, self.a_log2)

    @staticmethod
    def merge_results(r_fast, r_res, idx):
        """Residue codes back into their original lanes."""
        return r_fast.index_copy_(0, idx, r_res)

    def lookup_accounts(self, state, ids, raw: bool = False):
        return table_lookup(ids["key4"], state["acct_rows"], self.a_log2, raw)

    def lookup_transfers(self, state, ids, raw: bool = False):
        return table_lookup(ids["key4"], state["xfer_rows"], self.t_log2, raw)

    def filter_scan(self, state, table: str, field: str, value_words):
        """K8 over the "acct" or "xfer" table: (first QUERY_LIMIT matching
        rows in slot order, total match count)."""
        spec = (ACCOUNT_QUERY_WORDS if table == "acct" else TRANSFER_QUERY_WORDS)[field]
        log2 = self.a_log2 if table == "acct" else self.t_log2
        return filter_scan(state[f"{table}_rows"], log2, spec, value_words)


# ----------------------------------------------------------------------
# host-side planner (a copy of the JAX package's, pure numpy)
# ----------------------------------------------------------------------

class WavePlan:
    """Deterministic per-batch conflict-wave layout: `wave_of[i]` is event
    i's wave index (-1 = serial residue). Waves dispatch in index order
    through the masked fast/fast_pv kernel — wave w+1's table lookups see
    wave w's applied state, which is exactly the ordering the conflict
    edges demand — and the compacted residue runs the exact serial scan
    LAST (the entanglement closure proves it shares no ordering key with
    any wave lane, so last is as good as any position). The layout is a
    pure function of the batch bytes plus the tracker's committed-history
    state (no seeds, no wall clock, no unordered iteration), so every
    replica and the simulator plan the same batch identically."""

    __slots__ = ("wave_of", "n_waves", "has_pv", "residue_n")

    def __init__(self, wave_of: np.ndarray, n_waves: int, has_pv: bool):
        self.wave_of = wave_of
        self.n_waves = n_waves
        self.has_pv = has_pv  # any post/void among the wave lanes
        self.residue_n = int((wave_of < 0).sum())


class HazardTracker:
    """Host-side, EXACT fast-tier admission control. Tracks the two facts
    that cannot be read off a batch alone — balance-limit account ids and the
    running amount-sum overflow bound — plus the pending-accounts registry,
    and plans each batch's execution (fast / fast_pv / conflict waves /
    serial; see plan()). A copy of the JAX package's tracker, so that both
    packages plan every batch identically."""

    def __init__(self):
        # Ids of accounts created with balance-limit flags (account flags are
        # immutable after creation, so membership is stable). Kept as sorted
        # u64 limb columns so the hot-path membership test is vectorized.
        self.limit_account_ids: set[int] = set()
        self._limit_lo = np.empty(0, dtype=np.uint64)
        # Running sum of every transfer amount ever submitted. While this
        # exact upper bound on any balance stays < 2^127, no u128 balance sum
        # can overflow, so overflow codes 47-52 can only arise from per-event
        # validation against pre-batch balances — which the vectorized ladder
        # computes exactly.
        self.amount_sum = 0
        # Conservative superset of pending transfers ever submitted:
        # id -> (debit lo-limb, credit lo-limb). The wave planner needs
        # the accounts a post/void will touch (they are the PENDING's
        # accounts, not the event's own) to order them against
        # order-sensitive (limit/balancing) accounts.
        self.pending_accounts: dict[int, tuple[int, int]] = {}
        # Planner decision counters: fast / fast_pv / serial / waves
        # (batches through the wave path) / wave_dispatches (total waves
        # dispatched) / residue_events / chain_len_max (deepest wave count
        # seen), plus split / split_pv, which count every wave batch again
        # (without / with post-void lanes) exactly as the JAX tracker does,
        # so the two trackers' stats compare equal.
        self.plan_stats = {
            "fast": 0, "fast_pv": 0, "serial": 0, "waves": 0,
            "wave_dispatches": 0, "residue_events": 0, "chain_len_max": 0,
            "split": 0, "split_pv": 0,
        }

    @property
    def split_stats(self) -> dict:
        """The JAX tracker's compat view, read by the server's `[stats]`
        line: the same dict as plan_stats."""
        return self.plan_stats

    @staticmethod
    def has_dup_ids(arr: np.ndarray) -> bool:
        # Fast path: sort a 64-bit hash-fold of the u128 ids; if no two
        # hashes collide there are certainly no duplicate ids. Only on a
        # hash collision (~B^2/2^64 per batch) fall back to the exact
        # 16-byte comparison. Exact overall, ~15x cheaper than np.unique
        # over 16-byte voids on the hot path.
        with np.errstate(over="ignore"):
            h = arr["id_lo"] ^ (arr["id_hi"] * np.uint64(0x9E3779B97F4A7C15))
        h.sort()
        if not (h[1:] == h[:-1]).any():
            return False
        ids = np.ascontiguousarray(
            np.stack([arr["id_lo"], arr["id_hi"]], axis=1)
        ).view("V16")
        return len(np.unique(ids)) < len(arr)

    @staticmethod
    def _batch_amount_sum(arr: np.ndarray) -> int:
        """Exact u128 sum of every amount in the batch (u64 column sums
        cannot wrap: 2^13 values < 2^32 per 32-bit half)."""
        lo, hi = arr["amount_lo"], arr["amount_hi"]
        return (
            int(np.sum(lo & np.uint64(0xFFFFFFFF), dtype=np.uint64))
            + (int(np.sum(lo >> np.uint64(32), dtype=np.uint64)) << 32)
            + ((int(np.sum(hi & np.uint64(0xFFFFFFFF), dtype=np.uint64))
                + (int(np.sum(hi >> np.uint64(32), dtype=np.uint64)) << 32)) << 64)
        )

    def transfers_hazard(self, arr: np.ndarray) -> bool:
        """True if the batch needs the serial tier: the all-or-nothing check
        of the sharded ledger (the device ledger plans with plan()). The
        running amount sum bounds any balance the store can hold (posts move
        pending to posted, voids remove, balancing clamps to available <=
        sum), so it counts every batch."""
        self.amount_sum += self._batch_amount_sum(arr)
        if self.amount_sum >= (1 << 127):
            return True  # overflow no longer provably impossible
        if (arr["flags"] & _SLOW_FLAGS).any():
            return True
        if self.has_dup_ids(arr):
            return True
        if self.limit_account_ids and self._touches_limit(arr).any():
            return True
        return False

    def accounts_hazard(self, arr: np.ndarray) -> bool:
        if (arr["flags"] & validate.A_LINKED).any():
            return True
        return self.has_dup_ids(arr)

    # ------------------------------------------------------------------
    # the WAVE decision (middle tier): order a batch's TRUE dependencies
    # into waves and close the serial residue under shared ORDERING KEYS
    # only — plain shared accounts commute and create no edges (the
    # split-era account-disjointness invariant is deliberately relaxed);
    # running waves-then-residue preserves exact semantics (see plan())
    # ------------------------------------------------------------------

    def note_pending(self, arr: np.ndarray) -> None:
        pen = (arr["flags"] & np.uint16(F_PENDING)) != 0
        if pen.any():
            for idl, idh, dl, cl in zip(
                arr["id_lo"][pen], arr["id_hi"][pen],
                arr["debit_account_id_lo"][pen],
                arr["credit_account_id_lo"][pen],
            ):
                self.pending_accounts[int(idl) | (int(idh) << 64)] = (
                    int(dl), int(cl),
                )
        # Bound the registry: a pending referenced by a post/void cannot be
        # meaningfully referenced again (idempotency paths fail without
        # touching balances) — evict it; a later stray reference moves that
        # lane to the residue (or the batch to serial), always sound.
        pv = (arr["flags"] & np.uint16(F_POST | F_VOID)) != 0
        if pv.any():
            for pl, ph in zip(
                arr["pending_id_lo"][pv], arr["pending_id_hi"][pv]
            ):
                self.pending_accounts.pop(int(pl) | (int(ph) << 64), None)

    def plan(self, arr: np.ndarray):
        """Per-batch tier decision, the conflict-wave planner: returns
        ("fast"|"fast_pv"|"serial", None) or ("waves", WavePlan).

        A deterministic (seed-free, sorted — a pure function of the batch
        bytes and this tracker's committed-history state) conflict index
        orders only the TRUE dependencies of a batch:

        - same-id groups (duplicate creates: exists-check order);
        - pending-id references (post/void after its in-batch creator;
          competing resolves of one pending in first-wins order);
        - order-sensitive ACCOUNTS: balance-limit accounts (their
          validation reads the running balance) and the accounts of
          balancing lanes (their clamp reads the running balance), so
          every touch of such an account is ordered. Plain hot accounts
          create NO edges — balance adds commute and non-limit validation
          never reads a balance, which is what lets a one-hot-account
          batch run in ~dependency-chain-length waves instead of a
          whole-batch serial scan.

        Lanes the masked fast/fast_pv kernels cannot express — linked
        chains (rollback), balancing (balance-dependent amount), and
        unresolvable pending references when order-sensitive accounts
        exist — form the serial RESIDUE, closed so it shares no ordering
        key with any wave lane (then running it after the waves preserves
        every cross ordering). Post/voids perform no limit checks
        themselves (reference: src/state_machine.zig:907-1014)."""
        # Exact overflow bound, counted once per batch: the running sum of
        # every amount ever submitted bounds any balance the store can hold
        # (posts move pending to posted, voids remove, balancing clamps to
        # at most the available amount).
        self.amount_sum += self._batch_amount_sum(arr)
        st = self.plan_stats
        if self.amount_sum >= (1 << 127):
            st["serial"] += 1
            return "serial", None

        B = len(arr)
        flags = arr["flags"]
        pv = (flags & np.uint16(F_POST | F_VOID)) != 0
        any_pv = bool(pv.any())
        bal = (flags & np.uint16(F_BAL_DR | F_BAL_CR)) != 0
        linked = (flags & np.uint16(F_LINKED)) != 0
        # whole chain runs: a linked run's terminator is the event AFTER it
        in_chain = linked.copy()
        in_chain[1:] |= linked[:-1]
        residue = in_chain | bal

        with np.errstate(over="ignore"):
            h_id = arr["id_lo"] ^ (arr["id_hi"] * _WAVE_GOLDEN)
        dup = self._dup_groups(h_id)

        # -- fast exits: hazard-free batches pay only what they always paid
        if not residue.any() and not dup.any():
            limit_touch = (
                self._touches_limit(arr)
                if self.limit_account_ids
                else None
            )
            if not any_pv:
                if limit_touch is None or not limit_touch.any():
                    st["fast"] += 1
                    return "fast", None
            else:
                with np.errstate(over="ignore"):
                    hp = arr["pending_id_lo"] ^ (
                        arr["pending_id_hi"] * _WAVE_GOLDEN
                    )
                # distinct pending refs, none created in this batch, no
                # limit-account touches by simple lanes: the whole batch
                # is one fast_pv wave (the kernel reads each pending's
                # truth — row, accounts, fulfill — from the table)
                hpc = hp.copy()
                hpc[~pv] = np.uint64(0) - np.arange(1, B + 1)[~pv].astype(
                    np.uint64
                )
                if (
                    not (self._dup_groups(hpc) & pv).any()
                    and not np.isin(hp[pv], h_id).any()
                    and (limit_touch is None or not (limit_touch & ~pv).any())
                ):
                    st["fast_pv"] += 1
                    return "fast_pv", None

        # -- general path: conflict index over ordering keys --
        with np.errstate(over="ignore"):
            h_pid = arr["pending_id_lo"] ^ (
                arr["pending_id_hi"] * _WAVE_GOLDEN
            )
        pv_idx = np.nonzero(pv)[0]

        # order-sensitive accounts (lo limbs; a collision only ADDS edges)
        sens = [self._limit_lo]
        if bal.any():
            sens.append(arr["debit_account_id_lo"][bal].astype(np.uint64))
            sens.append(arr["credit_account_id_lo"][bal].astype(np.uint64))
        sens_lo = np.unique(np.concatenate(sens))

        # pv lanes mutate their PENDING's accounts, not their own: resolve
        # those targets (registry, else the in-batch creator) so the
        # order-sensitive account edges are complete. Only needed when
        # order-sensitive accounts exist at all — otherwise pv balance
        # effects commute with everything and need no account edges.
        eff_dr = arr["debit_account_id_lo"].astype(np.uint64).copy()
        eff_cr = arr["credit_account_id_lo"].astype(np.uint64).copy()
        if len(pv_idx) and len(sens_lo):
            for i in pv_idx:
                pid = int(arr["pending_id_lo"][i]) | (
                    int(arr["pending_id_hi"][i]) << 64
                )
                if pid in (0, (1 << 128) - 1):
                    eff_dr[i] = 0  # invalid ref: fails with no effect
                    eff_cr[i] = 0
                    continue
                known = self.pending_accounts.get(pid)
                if known is not None:
                    eff_dr[i] = known[0] & ((1 << 64) - 1)
                    eff_cr[i] = known[1] & ((1 << 64) - 1)
                    continue
                cre = np.nonzero(h_id == h_pid[i])[0]
                if len(cre):
                    # in-batch creator(s): take the first's accounts; id-dup
                    # creators that disagree are unresolvable -> residue
                    eff_dr[i] = int(arr["debit_account_id_lo"][cre[0]])
                    eff_cr[i] = int(arr["credit_account_id_lo"][cre[0]])
                    if len(cre) > 1 and (
                        (arr["debit_account_id_lo"][cre] != eff_dr[i]).any()
                        or (arr["credit_account_id_lo"][cre] != eff_cr[i]).any()
                    ):
                        residue[i] = True
                else:
                    # unknown pending (e.g. registry evicted, or created
                    # before a restart): its balance targets cannot be
                    # proven clear of the order-sensitive set
                    eff_dr[i] = 0
                    eff_cr[i] = 0
                    residue[i] = True

        # (lane, key) conflict-edge list. Id keys only for lanes in a
        # duplicate group or referenced by a pv's pending id (a unique,
        # unreferenced id orders nothing).
        dup_or_ref = dup
        if len(pv_idx):
            dup_or_ref = dup | np.isin(h_id, h_pid[pv_idx])
        idk = np.nonzero(dup_or_ref)[0]
        lanes_e = [idk]
        keys_e = [h_id[idk]]
        if len(pv_idx):
            lanes_e.append(pv_idx)
            keys_e.append(h_pid[pv_idx])
        if len(sens_lo):
            with np.errstate(over="ignore"):
                for side in (eff_dr, eff_cr):
                    t_idx = np.nonzero(np.isin(side, sens_lo))[0]
                    if len(t_idx):
                        lanes_e.append(t_idx)
                        keys_e.append(side[t_idx] * _WAVE_GOLDEN2 + np.uint64(1))
        lane_e = np.concatenate(lanes_e)
        key_e = np.concatenate(keys_e)

        # -- residue entanglement closure: a wave lane sharing ANY ordering
        # key with a residue lane joins the residue (it runs LAST; a shared
        # key across that boundary would reorder a true dependency). Plain
        # account collisions never propagate — this closure is what keeps
        # hot accounts on the wave path.
        for _ in range(64):
            if not len(lane_e) or residue.all():
                break
            on_res = residue[lane_e]
            if not on_res.any():
                break
            tainted = np.unique(key_e[on_res])
            move = ~on_res & np.isin(key_e, tainted)
            if not move.any():
                break
            residue[lane_e[move]] = True
        else:
            st["serial"] += 1
            return "serial", None

        wl = ~residue
        if int(wl.sum()) < max(8, B // 8):
            # too little wave work to pay for the extra dispatches
            st["serial"] += 1
            return "serial", None

        # -- wave assignment: longest dependency chain ending at each lane.
        # Within one key group the lanes (in index order) form a chain
        # w'_t = max(w_t, w'_{t-1} + 1) = rank_t + cummax(w_s - rank_s);
        # a sweep applies every group's scan at once and scatter-maxes the
        # results back per lane; sweeps iterate to the multi-key fixpoint.
        wave = np.zeros(B, dtype=np.int64)
        m = wl[lane_e]
        el, ek = lane_e[m], key_e[m]
        if len(el):
            ko = np.lexsort((el, ek))
            el_k, ek_k = el[ko], ek[ko]
            E = len(el_k)
            grp_start = np.ones(E, dtype=bool)
            grp_start[1:] = ek_k[1:] != ek_k[:-1]
            gid = np.cumsum(grp_start) - 1
            pos = np.arange(E, dtype=np.int64)
            rank = pos - pos[grp_start][gid]
            off = gid * np.int64(2 * B + WAVE_CAP + 8)  # isolates groups
            lo_ = np.argsort(el_k, kind="stable")
            el_l = el_k[lo_]
            lane_start = np.ones(E, dtype=bool)
            lane_start[1:] = el_l[1:] != el_l[:-1]
            starts = np.nonzero(lane_start)[0]
            lanes_u = el_l[starts]
            for _ in range(_WAVE_SWEEPS):
                w_k = wave[el_k]
                w2 = rank + np.maximum.accumulate(w_k - rank + off) - off
                red = np.maximum.reduceat(w2[lo_], starts)
                if (red <= wave[lanes_u]).all():
                    break
                wave[lanes_u] = np.maximum(wave[lanes_u], red)
            else:
                st["serial"] += 1  # adversarial entanglement: escape hatch
                return "serial", None
            # depth cap: capped lanes fall to the residue. Sound without
            # re-running the closure — wave numbers are monotone along
            # every key chain, so any lane ordered AFTER a capped lane is
            # itself capped (also residue, in original order), and lanes
            # ordered before run in earlier waves, before the residue.
            over = wl & (wave >= WAVE_CAP)
            if over.any():
                residue |= over
                wl = ~residue
                if int(wl.sum()) < max(8, B // 8):
                    st["serial"] += 1
                    return "serial", None

        n_waves = int(wave[wl].max()) + 1 if wl.any() else 1
        has_res = bool(residue.any())
        if not has_res and n_waves == 1:
            name = "fast_pv" if any_pv else "fast"
            st[name] += 1
            return name, None
        wave_of = np.where(wl, wave, -1).astype(np.int32)
        plan = WavePlan(wave_of, n_waves, bool(pv[wl].any()))
        st["waves"] += 1
        st["wave_dispatches"] += n_waves
        st["residue_events"] += plan.residue_n
        st["chain_len_max"] = max(st["chain_len_max"], n_waves)
        st["split_pv" if plan.has_pv else "split"] += 1
        return "waves", plan

    @staticmethod
    def _dup_groups(h: np.ndarray) -> np.ndarray:
        """Lanes whose hash value occurs more than once (conservative)."""
        B = len(h)
        order = np.argsort(h, kind="stable")
        hs = h[order]
        dup_sorted = np.zeros(B, dtype=bool)
        if B > 1:
            eq = hs[1:] == hs[:-1]
            dup_sorted[1:] |= eq
            dup_sorted[:-1] |= eq
        dup = np.zeros(B, dtype=bool)
        dup[order] = dup_sorted
        return dup

    def _touches_limit(self, arr: np.ndarray) -> np.ndarray:
        lo2 = np.stack([arr["debit_account_id_lo"], arr["credit_account_id_lo"]])
        hi2 = np.stack([arr["debit_account_id_hi"], arr["credit_account_id_hi"]])
        pos = np.searchsorted(self._limit_lo, lo2)
        pos_c = np.minimum(pos, len(self._limit_lo) - 1)
        cand = self._limit_lo[pos_c] == lo2
        out = np.zeros(arr.shape[0], dtype=bool)
        if cand.any():
            for side in range(2):
                for i in np.nonzero(cand[side])[0]:
                    key = int(lo2[side][i]) | (int(hi2[side][i]) << 64)
                    if key in self.limit_account_ids:
                        out[i] = True
        return out

    def note_limit_accounts(self, arr: np.ndarray) -> None:
        limit_bits = validate.A_DR_LIMIT | validate.A_CR_LIMIT
        sel = (arr["flags"] & limit_bits) != 0
        if not sel.any():
            return
        new_lo = []
        for lo, hi in zip(arr["id_lo"][sel], arr["id_hi"][sel]):
            key = int(lo) | (int(hi) << 64)
            if key not in self.limit_account_ids:  # dedup: retries re-submit
                self.limit_account_ids.add(key)
                new_lo.append(lo)
        if new_lo:
            self._limit_lo = np.sort(
                np.concatenate([self._limit_lo, np.array(new_lo, dtype=np.uint64)])
            )



def applied_insert_mask(dense: list[int], flags: np.ndarray) -> np.ndarray:
    """Which events inserted a row at their turn — INCLUDING inserts later
    rolled back by a chain break (rollback tombstones the slot, and
    tombstones still extend probe chains, so they count toward the non-empty
    slot density that the probe-window math bounds; see the load guard).

    Reconstructs the chain outcomes from the dense result codes: code 1
    (linked_event_failed) is only ever assigned by chain relabel/skip, and a
    broken chain reads [1, 1, .., breaker-code, 1, ..] — members strictly
    before the breaker were applied then rolled back."""
    n = len(dense)
    mask = np.zeros(n, dtype=bool)
    i = 0
    while i < n:
        if not (int(flags[i]) & 1):  # standalone event
            mask[i] = dense[i] == 0
            i += 1
            continue
        j = i  # chain: linked run + its first non-linked member (if any)
        while j < n and (int(flags[j]) & 1):
            j += 1
        end = min(j + 1, n)
        chain = dense[i:end]
        breaker = next((k for k, c in enumerate(chain) if c not in (0, 1)), None)
        if breaker is None:
            for k, c in enumerate(chain):
                mask[i + k] = c == 0
        else:
            mask[i : i + breaker] = True  # applied, then rolled back
        i = end
    return mask


# ----------------------------------------------------------------------
# host-facing driver (the oracle-compatible interface StateMachine drives)
# ----------------------------------------------------------------------


def _next_pow2(n: int, floor: int = 8) -> int:
    p = floor
    while p < n:
        p <<= 1
    return p


class PendingGroup:
    """One fused dispatch covering several batches (group commit): the flat
    results [k * n_pad + 1] (last word = fault) and the summary [k + 1]
    (per-slot failure counts, then the fault word), each read to the host
    at most once for the whole group. The all-success drain reads only the
    summary (the reply of an all-ok batch is empty; reference:
    src/tigerbeetle.zig:231-249 sparse results)."""

    __slots__ = ("results", "n_pad", "k", "host", "summary", "host_summary",
                 "prefetched")

    def __init__(self, results, n_pad: int, k: int, summary):
        self.results = results
        self.n_pad = n_pad
        self.k = k
        self.host = None
        self.summary = summary
        self.host_summary = None
        self.prefetched = None  # the summary's copy started at dispatch

    def fetch(self) -> np.ndarray:
        if self.host is None:
            self.host = self.results.cpu().numpy().view(np.uint32)
        return self.host

    def fetch_summary(self) -> np.ndarray:
        if self.host_summary is None:
            self.host_summary = _host_words(self.summary, self.prefetched)
        return self.host_summary


def _copy_at_dispatch(t):
    """Start the copy of the device tensor `t` into pinned host memory now,
    behind the kernels that write it: (host tensor, CUDA event), or None on
    the CPU, where `t` is already on the host."""
    if t.device.type != "cuda":
        return None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def _host_words(t, prefetched) -> np.ndarray:
    """`t`'s words as uint32 on the host: from the copy `_copy_at_dispatch`
    started, once its event has passed, else by a copy now."""
    if prefetched is None:
        return t.cpu().numpy().view(np.uint32)
    host, done = prefetched
    done.synchronize()
    return host.numpy().view(np.uint32)


class PendingBatch:
    """Handle for a dispatched commit whose results are still on the device:
    `results` is [n + 1] int32 (the codes, then the fault word), `summary`
    [2] int32 (count of non-zero codes, fault word). A batch of a group
    commit instead points into its `group` at slot `group_idx`. `plan` is
    the planner's (decision, wave count) for create_transfers dispatched
    alone, else None. `epoch` is the ledger's occupancy epoch at dispatch (a
    spill cycle since then has recounted the occupancy)."""

    __slots__ = ("operation", "n", "results", "flags", "dense", "summary",
                 "failures", "codes_np", "group", "group_idx", "plan", "epoch",
                 "prefetched")

    def __init__(self, operation, n, results, flags, summary=None, group=None,
                 group_idx=0, plan=None, epoch=0):
        self.operation = operation
        self.n = n
        self.results = results
        self.flags = flags  # host u16 [n] (occupancy reconciliation)
        self.epoch = epoch
        self.dense = None  # cached drain() result (drain is idempotent)
        self.summary = summary
        self.failures = None  # failure count once drained
        self.codes_np = None  # dense codes (failure path only)
        self.group = group  # PendingGroup when part of a fused dispatch
        self.group_idx = group_idx  # this batch's slot within the group
        self.plan = plan
        self.prefetched = None  # the summary's copy started at dispatch

    def is_ready(self) -> bool:
        """False while a copy started at dispatch is still in flight: the
        replica's non-blocking flush then leaves this batch for later. A
        batch with no such copy reads as ready (its drain waits)."""
        pre = self.prefetched if self.group is None else self.group.prefetched
        return pre is None or pre[1].query()


def _summarize(results, fault):
    """(codes, fault) -> (packed [n + 1], summary [count, fault]): the count
    of non-zero codes lets an all-success drain read two words."""
    f = fault.reshape(1)
    count = (results != 0).sum().to(I32).reshape(1)
    return torch.cat([results, f]), torch.cat([count, f])


class HostLedgerBase:
    """The host surface the device ledger and the sharded ledger
    (parallel/mesh.py) share, as the JAX package's HostLedgerBase: the
    prepare clock (reference: src/state_machine.zig:336-343), the lookups
    (reference: src/state_machine.zig:701-736) and the commit clock.
    Subclasses provide `state`, `device` and `kernels.lookup_accounts` /
    `kernels.lookup_transfers`, which return (found, rows, resolved), or
    with `raw` on the card the kernel's one output buffer."""

    prepare_timestamp = 0
    _lookup_host = None  # the pinned host buffer a lookup's output comes back into (on the card)

    def prepare(self, operation: Operation, event_count: int) -> None:
        """Advance the prepare timestamp (reference: src/state_machine.zig:336-343)."""
        if operation in (Operation.create_accounts, Operation.create_transfers):
            self.prepare_timestamp += event_count

    def _lookup(self, kernel, ids: list[int]):
        """(found, rows) of `ids` as numpy arrays. On the card the kernel's
        one output buffer comes back in one copy into a pinned host buffer
        kept by the ledger, with one wait. `found` is the caller's own;
        there `rows` is a view of the pinned buffer, good until this
        ledger's next lookup (a ledger serves one caller at a time), so a
        caller copies out what it keeps."""
        batch = ids_to_batch(ids, self.device)
        if self.device.type == "cuda":
            buf = kernel(self.state, batch, raw=True)
            if self._lookup_host is None or self._lookup_host.numel() < buf.numel():
                self._lookup_host = torch.empty(buf.numel(), dtype=buf.dtype, pin_memory=True)
            host = self._lookup_host[:buf.numel()]
            host.copy_(buf, non_blocking=True)
            torch.cuda.current_stream(buf.device).synchronize()
            out = _k.lookup_views(host, len(ids))
        else:
            out = kernel(self.state, batch)
        found, rows, resolved = (t.numpy() for t in out)
        if not resolved.all():
            raise RuntimeError("lookup probe-window overflow: grow the table")
        return found.copy(), rows.view(np.uint32)

    def lookup_rows(self, operation: Operation, ids: list[int]) -> bytes:
        """Found objects' 128-byte wire rows, request order, missing skipped:
        the reply body."""
        kernel = (self.kernels.lookup_accounts if operation == Operation.lookup_accounts
                  else self.kernels.lookup_transfers)
        found, rows = self._lookup(kernel, ids)
        return rows[found].tobytes()

    def lookup_accounts(self, ids: list[int]) -> list[types.Account]:
        found, rows = self._lookup(self.kernels.lookup_accounts, ids)
        arr = np.frombuffer(rows.tobytes(), dtype=types.ACCOUNT_DTYPE)
        return [types.Account.from_np(arr[i]) for i in range(len(ids)) if found[i]]

    def lookup_transfers(self, ids: list[int]) -> list[types.Transfer]:
        body = self.lookup_rows(Operation.lookup_transfers, ids)
        arr = np.frombuffer(body, dtype=types.TRANSFER_DTYPE)
        return [types.Transfer.from_np(arr[i]) for i in range(len(arr))]

    @property
    def commit_timestamp(self) -> int:
        return int(self.state["commit_ts"]) & ((1 << 64) - 1)


class DeviceLedger(HostLedgerBase):
    """Host wrapper: owns the device state and mirrors the oracle's execute()
    API, so it is a drop-in backend for StateMachine and for parity tests.

    `device` defaults to "cuda" and raises if CUDA is not available; pass
    `device="cpu"` to run the plain PyTorch versions of the kernels.

    `mode`:
    - "auto" (production): HazardTracker.plan picks fast / fast_pv / waves /
      serial for each transfer batch, and accounts go serial only for linked
      chains or duplicate ids.
    - "fast" / "fast_pv" / "serial": force one tier (parity testing).

    `forest` (an lsm.groove.Forest) attaches the spill store: the transfer
    table then spills its cold tail to the forest instead of raising at the
    load-factor limit (models/spill.py). `spill_io` picks the store's IO
    executor: "threaded" (a worker thread) or "deferred" (jobs run at the
    caller's pump/drain, for deterministic runs).
    """

    # observability seams (metrics.py, tracer.py); instrument() re-points
    # them at a shared registry, where the group staging fence waits and the
    # uploaded event bytes report
    metrics = NULL_METRICS
    tracer = NULL_TRACER

    def instrument(self, metrics, tracer) -> None:
        self.metrics = metrics
        self.tracer = tracer
        self._c_h2d = metrics.counter("device.h2d_bytes")
        if self.spill is not None:
            self.spill.instrument(metrics, tracer)

    def __init__(self, process: ConfigProcess = DEFAULT_PROCESS,
                 mode: str = "auto", device=None, forest=None,
                 spill_io: str = "threaded"):
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "DeviceLedger: CUDA is not available "
                    "(pass device='cpu' to run the plain versions)"
                )
            device = "cuda"
        self.device = torch.device(device)
        self.process = process
        self.mode = mode
        self.kernels = LedgerKernels(process)
        self.state = init_state(process, self.device)
        self.prepare_timestamp = 0
        # Host-tracked occupancy for the load-factor guard (1/2 max: the
        # probe-window unresolve probability is ~alpha^window).
        self._acct_used = 0
        self._xfer_used = 0
        self._acct_limit = (1 << process.account_slots_log2) // 2
        self._xfer_limit = (1 << process.transfer_slots_log2) // 2
        self.hazards = HazardTracker()
        # (k, n_pad) -> the group commit's two staging buffers
        self._group_staging: dict = {}
        # the group upload's issued time, for the dual follower's device
        # anatomy: written and read by the thread that dispatches
        self.last_h2d_done_ns = 0
        self._c_h2d = self.metrics.counter("device.h2d_bytes")
        self._occupancy_epoch = 0  # bumped by spill cycles (drain reconcile)
        self.spill = None
        if forest is not None:
            from tigerbeetle_tpu_torch.models.spill import SpillManager

            self.spill = SpillManager(self, forest, io=spill_io)
        # Start each batch's summary copy to the host at dispatch, so that a
        # driver serving replies (the replica) drains a landed pinned buffer
        # instead of waiting on a copy it starts at drain. Off by default: a
        # driver that never reads results needs no copies.
        self.prefetch_results = False

    # ------------------------------------------------------------------
    # execution
    # ------------------------------------------------------------------

    def execute(self, operation, timestamp: int, events) -> list[tuple[int, int]]:
        dense = self.execute_dense(operation, timestamp, events)
        return [(i, c) for i, c in enumerate(dense) if c]

    def execute_dense(self, operation, timestamp: int, events) -> list[int]:
        return self.drain(self.execute_async(operation, timestamp, events))

    def execute_async(self, operation, timestamp: int, events) -> PendingBatch:
        """Dispatch a commit without waiting for the device. The caller drains
        the handle later and MUST call check_fault() after the last drain.
        The occupancy guard charges the batch conservatively (+n); drain()
        reconciles it to the exact ever-applied count."""
        n = len(events)
        dev = self.device
        if operation == Operation.create_transfers:
            arr = events if isinstance(events, np.ndarray) else types.transfers_to_np(events)
            if self.spill is not None:
                # spill the cold tail and reload the spilled rows this batch
                # references, so that the kernels' lookups see the whole store
                self.spill.admit(arr, n)
            if self._xfer_used + n > self._xfer_limit:
                raise RuntimeError(
                    f"transfer table at load-factor limit "
                    f"({self._xfer_used}+{n} > {self._xfer_limit}): "
                    "grow ConfigProcess.transfer_slots_log2"
                )
            if self.mode == "auto":
                decision, wave_plan = self.hazards.plan(arr)
            else:  # forced tier (parity tests)
                decision, wave_plan = self.mode, None
            self.hazards.note_pending(arr)
            plan_info = (decision, wave_plan.n_waves if wave_plan is not None else 1)
            if n == 0:
                results = torch.zeros(0, dtype=I32, device=dev)
            elif decision == "waves":
                results = self._execute_waves(arr, n, timestamp, wave_plan)
            else:
                results = self.kernels.commit_transfers(
                    self.state, transfers_to_batch(arr, dev), n, timestamp,
                    mode=decision,
                )
            self._xfer_used += n
        elif operation == Operation.create_accounts:
            if self._acct_used + n > self._acct_limit:
                raise RuntimeError(
                    f"account table at load-factor limit "
                    f"({self._acct_used}+{n} > {self._acct_limit}): "
                    "grow ConfigProcess.account_slots_log2"
                )
            arr = events if isinstance(events, np.ndarray) else types.accounts_to_np(events)
            mode = self.mode
            if mode == "auto":
                mode = "serial" if self.hazards.accounts_hazard(arr) else "fast"
            self.hazards.note_limit_accounts(arr)
            if n == 0:
                results = torch.zeros(0, dtype=I32, device=dev)
            else:
                results = self.kernels.commit_accounts(
                    self.state, accounts_to_batch(arr, dev), n, timestamp, mode=mode
                )
            plan_info = None
            self._acct_used += n
        else:
            raise ValueError(operation)
        self._c_h2d.add(arr.nbytes)
        packed, summary = _summarize(results, self.state["fault"])
        pending = PendingBatch(operation, n, packed, arr["flags"].copy(), summary,
                               plan=plan_info, epoch=self._occupancy_epoch)
        if self.prefetch_results:
            pending.prefetched = _copy_at_dispatch(summary)
        return pending

    def _execute_waves(self, arr, n: int, timestamp: int, plan):
        """Conflict-scheduled wave execution (the HazardTracker.plan layout):
        the batch and each lane's wave upload once, then the waves run in
        dependency order (wave w+1's lookups see wave w's rows): one masked
        fast/fast_pv commit (K3) for one wave, one launch of all of them
        (K12) for more. The serial residue, if any, runs last, compacted,
        with its events' original timestamps; its codes go back to their
        lanes."""
        dev = self.device
        W = plan.n_waves
        mode = "fast_pv" if plan.has_pv else "fast"
        rows_dev = transfers_to_batch(arr, dev)["rows"]
        wl = plan.wave_of[:n] >= 0
        m = self.metrics
        m.counter("waves.batches").add()
        m.histogram("waves.per_batch").observe(W)
        g = m.gauge("waves.chain_len_max")
        g.set(max(g.value, W))
        m.gauge("waves.occupancy").set(round(float(wl.sum()) / max(1, W * n), 4))
        if W == 1:
            results = self.kernels.commit_transfers(
                self.state, {"rows": rows_dev, "mask": torch.from_numpy(wl).to(dev)}, n,
                timestamp, mode=mode,
            )
        else:
            # the residue's -1 becomes 255: a lane of no wave
            wave_of = torch.from_numpy(plan.wave_of[:n].astype(np.uint8)).to(dev)
            results = self.kernels.commit_waves(
                self.state, rows_dev, wave_of, W, n, timestamp, mode=mode,
            )
        if plan.residue_n:
            m.counter("waves.residue_events").add(plan.residue_n)
            idx = np.nonzero(plan.wave_of[:n] < 0)[0]
            idx_dev = torch.from_numpy(idx.astype(np.int64)).to(dev)
            ts_res = batch_timestamps(timestamp, n, n, dev)[idx_dev]
            r_res = self.kernels.commit_transfers_residue(
                self.state, {"rows": rows_dev[idx_dev], "ts": ts_res}, len(idx)
            )
            results = self.kernels.merge_results(results, r_res, idx_dev)
        return results

    # ------------------------------------------------------------------
    # group commit (the replica's fused dispatch of quorum-ready prepares)
    # ------------------------------------------------------------------

    def _group_staging_slot(self, k: int, n_pad: int) -> dict:
        """One of two alternating host staging buffers per (k, n_pad), so
        that group N + 1 is packed while group N's upload may still be in
        flight. Pinned when the ledger is on a card (the upload is then
        asynchronous; `fence` is the CUDA event recorded after it). `used`
        holds each slot's row count, so only stale tails are zeroed."""
        entry = self._group_staging.setdefault((k, n_pad), {"i": 0, "slots": [None, None]})
        i = entry["i"]
        entry["i"] = 1 - i
        slot = entry["slots"][i]
        if slot is None:
            rows = torch.zeros((k, n_pad, ROW_WORDS), dtype=I32,
                               pin_memory=self.device.type == "cuda")
            slot = entry["slots"][i] = {
                "rows": rows, "np": rows.numpy(),
                "used": np.zeros(k, dtype=np.int64), "fence": None,
            }
        return slot

    def try_execute_group_async(self, items) -> list[PendingBatch] | None:
        """Commit `items` = [(timestamp, transfers ndarray), ...] as one
        fused group (K5), or return None when fusion does not apply: forced
        mode, a spill store (its reloads change the state between batches),
        fewer than 2 items, the load limit would be crossed, or a
        batch not proven fast-tier (the planner's amount bound and stats
        are then rolled back, since the caller plans each batch again).
        A failed build or launch raises."""
        if self.mode != "auto" or self.spill is not None or len(items) < 2:
            return None
        if len(items) > GROUP_KS[0]:
            # the caller zips the pendings with its items: never truncate
            raise ValueError(f"{len(items)} items > group capacity {GROUP_KS[0]}")
        total = sum(len(arr) for _, arr in items)
        if self._xfer_used + total > self._xfer_limit:
            return None  # the per-batch path raises the descriptive guard
        sum_before = self.hazards.amount_sum
        stats_before = dict(self.hazards.plan_stats)
        decisions = [self.hazards.plan(arr) for _, arr in items]
        if any(d != "fast" for d, _plan in decisions):
            self.hazards.amount_sum = sum_before
            self.hazards.plan_stats = stats_before
            return None
        k = next(g for g in reversed(GROUP_KS) if g >= len(items))
        n_pad = _next_pow2(max(len(arr) for _, arr in items))
        slot = self._group_staging_slot(k, n_pad)
        if slot["fence"] is not None:
            # the upload of the group that last used this buffer must have
            # landed before the buffer is written again
            with self.tracer.span("ledger.staging_wait"), \
                    self.metrics.histogram("ledger.staging_wait_us").time():
                slot["fence"].synchronize()
            slot["fence"] = None
        rows, used = slot["np"], slot["used"]
        ns = np.zeros(k, dtype=np.int32)  # padding slots: n = 0, no-ops
        tss = [0] * k
        for i, (ts, arr) in enumerate(items):
            na = len(arr)
            rows[i, :na] = _to_rows_np(arr)
            if used[i] > na:
                rows[i, na:used[i]] = 0  # zero only the stale tail
            used[i] = na
            ns[i] = na
            tss[i] = ts
        for i in range(len(items), k):
            if used[i]:
                rows[i, :used[i]] = 0
                used[i] = 0
        dev_rows = slot["rows"].to(self.device, non_blocking=True)
        if self.device.type == "cuda":
            slot["fence"] = torch.cuda.Event()
            slot["fence"].record()
        self.last_h2d_done_ns = perf_counter_ns()
        self._c_h2d.add(slot["rows"].nbytes)
        flat, summary = commit_transfers_group(
            self.state, dev_rows, ns, tss, self.kernels.a_log2, self.kernels.t_log2
        )
        for _ts, arr in items:
            self.hazards.note_pending(arr)
        self._xfer_used += total
        group = PendingGroup(flat, n_pad, k, summary)
        if self.prefetch_results:
            group.prefetched = _copy_at_dispatch(summary)
        return [
            PendingBatch(Operation.create_transfers, len(arr), flat, arr["flags"].copy(),
                         group=group, group_idx=i, epoch=self._occupancy_epoch)
            for i, (_ts, arr) in enumerate(items)
        ]

    # ------------------------------------------------------------------
    # state fingerprint (commitment chain, dual-commit verification)
    # ------------------------------------------------------------------

    def fingerprint_lazy(self) -> dict:
        """state_fingerprint as 0-d device tensors (u64 bits in int64): a
        launch, no host read."""
        return state_fingerprint(self.state)

    def fingerprint(self) -> dict:
        """The state fingerprint as Python ints (u64), with one host read."""
        words = state_fingerprint_vec(self.state).cpu().tolist()
        return {k: v & ((1 << 64) - 1) for k, v in zip(FP_KEYS, words)}

    # ------------------------------------------------------------------
    # snapshot row install (the restore path of a checkpoint or state sync)
    # ------------------------------------------------------------------

    INSTALL_CHUNK = 8192  # rows per install chunk: part of the slot layout

    def reset_state(self) -> None:
        """Drop every table back to fresh, the install's precondition: an
        install onto applied rows would give a present key a second slot
        and count the occupancy twice."""
        self.state = init_state(self.process, self.device)
        self._acct_used = 0
        self._xfer_used = 0
        self.hazards = HazardTracker()

    def install_snapshot_rows(self, accounts: np.ndarray, transfers: np.ndarray,
                              fulfill: np.ndarray, commit_timestamp: int,
                              legs: dict | None = None) -> None:
        """Rebuild the tables from 128-byte wire row images (ACCOUNT_DTYPE /
        TRANSFER_DTYPE arrays; `fulfill` is the transfers' posted/voided
        column, 0 = unresolved) on a fresh state. Each table's rows upload
        once and install in INSTALL_CHUNK chunks in one call, accounts first
        (K9); a row that finds no slot sets FAULT_INSTALL, seen by the next
        check_fault. Then the commit clock, the host occupancy and the hazard
        tracker's limit accounts, pending registry and amount bound are
        rebuilt. With a `legs` dict, the device is waited for after the
        uploads and after the installs, and the seconds of each leg go into
        it ("upload", "install", "rebuild")."""
        if len(fulfill) != len(transfers):
            raise ValueError(f"{len(fulfill)} fulfill words for {len(transfers)} transfers")
        dev = self.device
        sync = torch.cuda.synchronize if legs is not None and dev.type == "cuda" else None
        t0 = perf_counter_ns()
        ful_all = torch.from_numpy(
            np.ascontiguousarray(fulfill, dtype=np.uint32).view(np.int32)
        ).to(dev)
        work = [(table, torch.tensor(_to_rows_np(arr), device=dev), ful, log2)  # one upload
                for table, arr, ful, log2 in (("acct", accounts, None, self.kernels.a_log2),
                                              ("xfer", transfers, ful_all, self.kernels.t_log2))
                if len(arr)]
        if sync is not None:
            sync()
        t1 = perf_counter_ns()
        for table, rows, ful, log2 in work:
            install_rows_chunked(self.state, table, rows, ful, log2, self.INSTALL_CHUNK)
        if sync is not None:
            sync()
        t2 = perf_counter_ns()
        self.state["commit_ts"].fill_(u128.to_i64(commit_timestamp))
        self._acct_used += len(accounts)
        self._xfer_used += len(transfers)
        self.hazards.note_limit_accounts(accounts)
        if len(transfers):
            # a superset of the live pendings (an extra entry only sends a
            # later post/void batch to a slower tier)
            pen = (transfers["flags"] & np.uint16(F_PENDING)) != 0
            for idl, idh, dl, cl in zip(
                transfers["id_lo"][pen], transfers["id_hi"][pen],
                transfers["debit_account_id_lo"][pen],
                transfers["credit_account_id_lo"][pen],
            ):
                self.hazards.pending_accounts[int(idl) | (int(idh) << 64)] = (int(dl), int(cl))
        # the amount bound ("no balance can exceed it"): the sum of every
        # restored balance bounds each of them
        if len(accounts):
            for col in ("debits_posted", "credits_posted", "debits_pending", "credits_pending"):
                lo, hi = accounts[col + "_lo"], accounts[col + "_hi"]
                self.hazards.amount_sum += (
                    int(np.sum(lo & np.uint64(0xFFFFFFFF), dtype=np.uint64))
                    + (int(np.sum(lo >> np.uint64(32), dtype=np.uint64)) << 32)
                    + ((int(np.sum(hi & np.uint64(0xFFFFFFFF), dtype=np.uint64))
                        + (int(np.sum(hi >> np.uint64(32), dtype=np.uint64)) << 32)) << 64)
                )
        if legs is not None:
            legs.update(upload=(t1 - t0) / 1e9, install=(t2 - t1) / 1e9,
                        rebuild=(perf_counter_ns() - t2) / 1e9)

    # ------------------------------------------------------------------
    # results
    # ------------------------------------------------------------------

    def check_fault(self) -> None:
        """Raise if the device hit the fault protocol. Waits for the device."""
        raise_on_fault(int(self.state["fault"]), "device ledger")

    def drain(self, pending: PendingBatch) -> list[int]:
        """Materialize a pending batch's dense result codes and reconcile the
        occupancy charge to the exact ever-applied insert count (rolled-back
        inserts leave tombstones, which still occupy probe slots). An
        all-success batch reads only the summary words. Idempotent."""
        if pending.dense is not None:
            return pending.dense
        if pending.group is not None:
            g = pending.group
            s = g.fetch_summary()  # [k counts..., fault]
            if int(s[pending.group_idx]) == 0:
                return self._drain_all_ok(pending, int(s[-1]))
            arr = g.fetch()  # one read for the whole group (cached)
            off = pending.group_idx * g.n_pad
            return self._drain_from_host(pending, arr[off:off + pending.n], int(arr[-1]))
        s = _host_words(pending.summary, pending.prefetched)  # [count, fault]
        if int(s[0]) == 0:
            return self._drain_all_ok(pending, int(s[1]))
        arr = pending.results.cpu().numpy().view(np.uint32)
        return self._drain_from_host(pending, arr[:pending.n], int(arr[-1]))

    def _drain_all_ok(self, pending: PendingBatch, fault: int) -> list[int]:
        raise_on_fault(fault, "device ledger")
        pending.failures = 0
        pending.dense = [0] * pending.n
        return pending.dense

    def _drain_from_host(self, pending: PendingBatch, codes: np.ndarray,
                         fault: int) -> list[int]:
        raise_on_fault(fault, "device ledger")
        pending.codes_np = codes.copy()
        pending.failures = int(np.count_nonzero(pending.codes_np))
        dense = pending.codes_np.tolist()
        applied = int(applied_insert_mask(dense, pending.flags).sum())
        if pending.operation == Operation.create_transfers:
            # a spill cycle after dispatch recounted the occupancy exactly:
            # this batch is in that count already
            if pending.epoch == self._occupancy_epoch:
                self._xfer_used += applied - pending.n
        else:
            self._acct_used += applied - pending.n
        # cache only after the fault check and reconcile: a drain retried
        # after a fault exception must re-raise, not return unsound codes
        pending.dense = dense
        return dense

    def drain_many(self, pendings) -> None:
        """Materialize a window of pending batches (a group's batches share
        one summary read, or one results read when any of them failed)."""
        for p in pendings:
            if p is not None:
                self.drain(p)

    def drain_reply(self, pending: PendingBatch, operation) -> bytes:
        """The reply body (sparse non-ok result structs, reference:
        src/tigerbeetle.zig:231-249); empty for an all-success batch."""
        self.drain(pending)
        if not pending.failures:
            return b""
        from tigerbeetle_tpu_torch.state_machine import encode_sparse_results

        return encode_sparse_results(pending.codes_np, operation)

    # ------------------------------------------------------------------
    # lookups (reference: src/state_machine.zig:701-736)
    # ------------------------------------------------------------------

    def lookup_rows(self, operation: Operation, ids: list[int]) -> bytes:
        """The reply body; transfers found in neither the table nor the
        spill store are the missing ones."""
        if operation == Operation.lookup_transfers and self.spill is not None:
            found, rows = self._lookup(self.kernels.lookup_transfers, ids)
            return self.spill.merge_lookup_rows(ids, found, rows)
        return super().lookup_rows(operation, ids)

    # ------------------------------------------------------------------
    # secondary-index equality queries (K8 over the tables, plus the LSM
    # index trees over the spilled tail)
    # ------------------------------------------------------------------

    def _query_scan(self, table: str, field: str, value: int) -> np.ndarray:
        words = ACCOUNT_QUERY_WORDS if table == "acct" else TRANSFER_QUERY_WORDS
        _, nwords, halfword = words[field]  # KeyError: not an indexed field
        width_bits = 16 if halfword else nwords * 32
        if not 0 <= value < (1 << width_bits):
            raise ValueError(f"{field} value out of range: {value}")
        vw = [(value >> (32 * i)) & 0xFFFFFFFF for i in range(4)]
        rows_d, total_d = self.kernels.filter_scan(self.state, table, field, vw)
        total = int(total_d)
        if total > QUERY_LIMIT:
            raise RuntimeError(f"query matches {total} rows > QUERY_LIMIT {QUERY_LIMIT}")
        return rows_d[:total].cpu().numpy().view(np.uint32)

    def query_accounts(self, field: str, value: int) -> list[types.Account]:
        """Accounts whose `field` equals `value`, ascending timestamp (the
        analog of a reference index-tree range query; accounts never spill,
        so the device scan is the whole store)."""
        rows = self._query_scan("acct", field, value)
        arr = np.frombuffer(rows.tobytes(), dtype=types.ACCOUNT_DTYPE)
        out = [types.Account.from_np(arr[i]) for i in range(len(arr))]
        return sorted(out, key=lambda a: a.timestamp)

    def query_transfers(self, field: str, value: int) -> list[types.Transfer]:
        """Transfers whose `field` equals `value`, ascending timestamp: the
        device filter scan over the table merged with the LSM index trees
        over the spilled tail (lsm/groove.py query)."""
        rows = self._query_scan("xfer", field, value)
        arr = np.frombuffer(rows.tobytes(), dtype=types.TRANSFER_DTYPE)
        by_ts = {
            int(arr[i]["timestamp"]): types.Transfer.from_np(arr[i])
            for i in range(len(arr))
        }
        if self.spill is not None and self.spill.spilled:
            self.spill.io_drain()  # queued inserts must land before scans
            g = self.spill.forest.transfers
            for ts in g.query(field, value):
                if ts in by_ts:
                    continue  # the table wins (stale LSM rows of reloaded ids)
                row = g.get_by_timestamp(ts)
                t = types.Transfer.from_np(np.frombuffer(row, dtype=types.TRANSFER_DTYPE)[0])
                if t.id in self.spill.spilled:
                    by_ts[ts] = t
            if len(by_ts) > QUERY_LIMIT:
                raise RuntimeError(f"query matches {len(by_ts)} rows > QUERY_LIMIT")
        return [by_ts[ts] for ts in sorted(by_ts)]

    # -- parity extraction --

    def extract(self):
        """Pull the full state to host dicts (accounts, transfers, posted) for
        comparison against the oracle, spilled transfers included."""
        acct_rows = self.state["acct_rows"][:-1].cpu().numpy().view(np.uint32)
        xfer_rows = self.state["xfer_rows"][:-1].cpu().numpy().view(np.uint32)
        fulfill = self.state["fulfill"][:-1].cpu().numpy().view(np.uint32)
        accounts: dict[int, types.Account] = {}
        transfers: dict[int, types.Transfer] = {}
        posted: dict[int, int] = {}
        occ = _occupied_rows(acct_rows)
        arr = np.frombuffer(acct_rows[occ].tobytes(), dtype=types.ACCOUNT_DTYPE)
        for i in range(len(arr)):
            a = types.Account.from_np(arr[i])
            accounts[a.id] = a
        occ = _occupied_rows(xfer_rows)
        arr = np.frombuffer(xfer_rows[occ].tobytes(), dtype=types.TRANSFER_DTYPE)
        ful = fulfill[occ]
        for i in range(len(arr)):
            t = types.Transfer.from_np(arr[i])
            transfers[t.id] = t
            if ful[i]:
                posted[t.timestamp] = int(ful[i])
        if self.spill is not None:
            self.spill.extract_into(transfers, posted)
        return accounts, transfers, posted


def _occupied_rows(rows: np.ndarray) -> np.ndarray:
    k4 = rows[:, :4]
    return ~(k4 == 0).all(axis=1) & ~(k4 == 0xFFFFFFFF).all(axis=1)
