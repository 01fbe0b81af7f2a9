"""ctypes bindings of the CUDA kernels in `tigerbeetle_tpu_torch/csrc/`.

The library is built by kernels/build.py at the first launch, never at
import. Each launcher checks its tensors (device, dtype, shape, contiguity),
allocates the outputs and the scratch buffer with torch, launches on
PyTorch's current stream without synchronising, raises if the launch
returned a CUDA error, and counts its launches in `LAUNCHES` (a plain
integer per kernel, so that a run can show its main path went through the
kernels).

Kernels (JAX counterparts in tigerbeetle_tpu/models/ledger.py):
    lookup                  K1  LedgerKernels._lookup_accounts/_transfers
    commit_accounts_fast    K2  LedgerKernels._commit_accounts (fast)
    commit_accounts_serial  K2  LedgerKernels._serial_accounts
    commit_transfers_fast   K3  LedgerKernels._commit_transfers (fast, fast_pv)
    commit_transfers_serial K4  LedgerKernels._serial_transfers_core
    group_commit            K5  DeviceLedger._group_stepper
    fingerprint             K6  state_fingerprint
    install_rows            K9  DeviceLedger._install_fn
    fold                    K7  fold_reply_codes and the fused folds of
                                models/dual_ledger.py

`chase` is no kernel of the ledger: a pointer chase that measures the
card's dependent-load latency for the serial kernels' bounds.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

_P = ctypes.c_void_p
_I = ctypes.c_int
_U64 = ctypes.c_uint64
_I64 = ctypes.c_longlong

LAUNCHES = {
    "lookup": 0,
    "commit_accounts_fast": 0,
    "commit_accounts_serial": 0,
    "commit_transfers_fast": 0,
    "commit_transfers_serial": 0,
    "group_commit": 0,
    "fingerprint": 0,
    "install_rows": 0,
    "fold": 0,
}

_SIGNATURES = {
    "tb_lookup": [_P, _I, _P, _I, _P, _P, _P, _P, _P],
    "tb_commit_accounts_fast": [_P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _U64, _P, _P, _P],
    "tb_commit_accounts_serial": [_P, _I, _P, _P, _P, _P, _P, _I, _I, _U64, _P, _P, _P],
    "tb_commit_transfers_fast": [_P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                 _I, _I, _U64, _I, _P, _P, _P],
    "tb_commit_transfers_serial": [_P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                   _P, _P, _P],
    "tb_group_commit": [_P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P,
                        _P, _P, _P, _P],
    "tb_fingerprint": [_P, _I64, _P, _I64, _P, _P, _P],
    "tb_install_rows": [_P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P],
    "tb_fold": [_P, _I, _I, _P, _P, _P, _P, _P, _I, _P, _P],
    "tb_chase": [_P, ctypes.c_uint32, _I, _P, _P],
}
_SCRATCH = (
    "tb_commit_accounts_fast_scratch",
    "tb_commit_accounts_serial_scratch",
    "tb_commit_transfers_fast_scratch",
    "tb_commit_transfers_serial_scratch",
    "tb_install_rows_scratch",
)

_lib = None


def library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _lib
    if _lib is None:
        from tigerbeetle_tpu_torch.kernels import build

        lib = ctypes.CDLL(str(build.build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        for name in _SCRATCH:
            fn = getattr(lib, name)
            fn.argtypes = [_I]
            fn.restype = ctypes.c_size_t
        lib.tb_error_string.argtypes = [_I]
        lib.tb_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _launch(name: str, counter: str, *args) -> None:
    lib = library()
    err = getattr(lib, name)(*args)
    if err != 0:
        msg = lib.tb_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
    LAUNCHES[counter] += 1


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _ptr(t) -> int:
    return t.data_ptr()


def _need(t, dtype, ndim: int, name: str) -> None:
    if not t.is_cuda or t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(
            f"{name}: want a contiguous {ndim}-d {dtype} CUDA tensor, got "
            f"{tuple(t.shape)} {t.dtype} on {t.device}"
        )


def _check_rows(t, name: str, cap_log2: int) -> None:
    _need(t, torch.int32, 2, name)
    if t.shape != ((1 << cap_log2) + 1, 32):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != capacity {1 << cap_log2} + 1 rows")


def _check_batch(rows_b, n: int) -> int:
    _need(rows_b, torch.int32, 2, "batch")
    B = rows_b.shape[0]
    if rows_b.shape[1] != 32 or not 0 <= n <= B:
        raise ValueError(f"batch: shape {tuple(rows_b.shape)}, n={n}")
    return B


def _scalars(state, *names) -> list[int]:
    out = []
    for name in names:
        t = state[name]
        dtype = torch.int32 if name == "fault" else torch.int64
        _need(t, dtype, 0, name)
        out.append(_ptr(t))
    return out


def _scratch(name: str, B: int, device):
    nbytes = getattr(library(), name)(B)
    return torch.empty(nbytes, dtype=torch.uint8, device=device)


def _u64(x: int) -> int:
    return x & ((1 << 64) - 1)


def lookup(key4, rows, cap_log2: int):
    """K1: probe `key4` [B, 4] in `rows`; returns (found, rows [B, 32], resolved)."""
    _need(key4, torch.int32, 2, "key4")
    _check_rows(rows, "rows", cap_log2)
    B = key4.shape[0]
    dev = rows.device
    slot = torch.empty(B, dtype=torch.int64, device=dev)
    found = torch.empty(B, dtype=torch.bool, device=dev)
    resolved = torch.empty(B, dtype=torch.bool, device=dev)
    out = torch.empty((B, 32), dtype=torch.int32, device=dev)
    _launch("tb_lookup", "lookup", _ptr(key4), B, _ptr(rows), cap_log2,
            _ptr(slot), _ptr(found), _ptr(resolved), _ptr(out), _stream())
    return found, out, resolved


def commit_accounts_fast(state, rows_b, n: int, timestamp: int, a_log2: int):
    """K2 fast: commit `rows_b` into `state` in place; returns int32 codes."""
    B = _check_batch(rows_b, n)
    _check_rows(state["acct_rows"], "acct_rows", a_log2)
    _need(state["acct_claim"], torch.int32, 1, "acct_claim")
    results = torch.empty(B, dtype=torch.int32, device=rows_b.device)
    scratch = _scratch("tb_commit_accounts_fast_scratch", B, rows_b.device)
    _launch("tb_commit_accounts_fast", "commit_accounts_fast",
            _ptr(state["acct_rows"]), _ptr(state["acct_claim"]), a_log2,
            *_scalars(state, "commit_ts", "acct_count", "acct_used_slots", "fault"),
            _ptr(rows_b), B, n, _u64(timestamp), _ptr(results), _ptr(scratch), _stream())
    return results


def commit_accounts_serial(state, rows_b, n: int, timestamp: int, a_log2: int):
    """K2 serial: commit `rows_b` into `state` in place; returns int32 codes."""
    B = _check_batch(rows_b, n)
    _check_rows(state["acct_rows"], "acct_rows", a_log2)
    results = torch.empty(B, dtype=torch.int32, device=rows_b.device)
    scratch = _scratch("tb_commit_accounts_serial_scratch", B, rows_b.device)
    _launch("tb_commit_accounts_serial", "commit_accounts_serial",
            _ptr(state["acct_rows"]), a_log2,
            *_scalars(state, "commit_ts", "acct_count", "acct_used_slots", "fault"),
            _ptr(rows_b), B, n, _u64(timestamp), _ptr(results), _ptr(scratch), _stream())
    return results


def _check_fast_state(state, a_log2: int, t_log2: int) -> None:
    _check_rows(state["acct_rows"], "acct_rows", a_log2)
    _check_rows(state["xfer_rows"], "xfer_rows", t_log2)
    _check_rows(state["bal_acc"], "bal_acc", a_log2)
    for name in ("fulfill", "xfer_claim"):
        _need(state[name], torch.int32, 1, name)


def commit_transfers_fast(state, rows_b, mask, n: int, timestamp: int,
                          a_log2: int, t_log2: int, pv_mode: bool):
    """K3: commit `rows_b` (lanes < n, and in `mask` if given) into `state`
    in place; returns int32 codes."""
    B = _check_batch(rows_b, n)
    _check_fast_state(state, a_log2, t_log2)
    if mask is not None:
        _need(mask, torch.bool, 1, "mask")
        if mask.shape[0] != B:
            raise ValueError(f"mask: {mask.shape[0]} lanes for a batch of {B}")
    results = torch.empty(B, dtype=torch.int32, device=rows_b.device)
    scratch = _scratch("tb_commit_transfers_fast_scratch", B, rows_b.device)
    _launch("tb_commit_transfers_fast", "commit_transfers_fast",
            _ptr(state["acct_rows"]), a_log2, _ptr(state["xfer_rows"]), t_log2,
            _ptr(state["fulfill"]), _ptr(state["xfer_claim"]), _ptr(state["bal_acc"]),
            *_scalars(state, "commit_ts", "xfer_count", "xfer_used_slots", "fault"),
            _ptr(rows_b), None if mask is None else _ptr(mask), B, n, _u64(timestamp),
            int(pv_mode), _ptr(results), _ptr(scratch), _stream())
    return results


def commit_transfers_serial(state, rows_b, ts_vec, n: int, a_log2: int, t_log2: int):
    """K4: commit `rows_b` event by event with explicit timestamps `ts_vec`
    (u64 as int64) into `state` in place; returns int32 codes."""
    B = _check_batch(rows_b, n)
    _check_rows(state["acct_rows"], "acct_rows", a_log2)
    _check_rows(state["xfer_rows"], "xfer_rows", t_log2)
    _need(state["fulfill"], torch.int32, 1, "fulfill")
    _need(ts_vec, torch.int64, 1, "ts")
    if ts_vec.shape[0] != B:
        raise ValueError(f"ts: {ts_vec.shape[0]} timestamps for a batch of {B}")
    results = torch.empty(B, dtype=torch.int32, device=rows_b.device)
    scratch = _scratch("tb_commit_transfers_serial_scratch", B, rows_b.device)
    _launch("tb_commit_transfers_serial", "commit_transfers_serial",
            _ptr(state["acct_rows"]), a_log2, _ptr(state["xfer_rows"]), t_log2,
            _ptr(state["fulfill"]),
            *_scalars(state, "commit_ts", "xfer_count", "xfer_used_slots", "fault"),
            _ptr(rows_b), _ptr(ts_vec), B, n, _ptr(results), _ptr(scratch), _stream())
    return results


GROUP_K_MAX = 16  # csrc/group_commit.cu GROUP_K_MAX


def group_commit(state, rows, ns, tss, a_log2: int, t_log2: int):
    """K5: commit k staged batches `rows` [k, n_pad, 32] (slot i: lanes
    < ns[i], timestamp tss[i]) into `state` in place, in slot order, through
    K3's fast tier. Returns (flat int32 [k * n_pad + 1]: the codes of each
    slot then the fault word, summary int32 [k + 1]: each slot's count of
    non-zero codes then the fault word)."""
    _need(rows, torch.int32, 3, "group rows")
    k, n_pad, words = rows.shape
    ns = np.ascontiguousarray(ns, dtype=np.int32)
    tss = np.array([_u64(int(t)) for t in tss], dtype=np.uint64)
    if words != 32 or not 1 <= k <= GROUP_K_MAX or ns.shape != (k,) or tss.shape != (k,) \
            or ((ns < 0) | (ns > n_pad)).any():
        raise ValueError(f"group: rows {tuple(rows.shape)}, ns {ns.tolist()}, {len(tss)} timestamps")
    _check_fast_state(state, a_log2, t_log2)
    dev = rows.device
    flat = torch.empty(k * n_pad + 1, dtype=torch.int32, device=dev)
    summary = torch.empty(k + 1, dtype=torch.int32, device=dev)
    scratch = _scratch("tb_commit_transfers_fast_scratch", n_pad, dev)
    # ns and tss are read on the host during the call
    _launch("tb_group_commit", "group_commit",
            _ptr(state["acct_rows"]), a_log2, _ptr(state["xfer_rows"]), t_log2,
            _ptr(state["fulfill"]), _ptr(state["xfer_claim"]), _ptr(state["bal_acc"]),
            *_scalars(state, "commit_ts", "xfer_count", "xfer_used_slots", "fault"),
            _ptr(rows), k, n_pad, ns.ctypes.data, tss.ctypes.data, _ptr(flat), _ptr(summary),
            _ptr(scratch), _stream())
    return flat, summary


def fingerprint(acct_rows, xfer_rows, commit_ts):
    """K6: int64 [5] = accounts_fp, transfers_fp, live accounts, live
    transfers (u64 bits), commit_ts; the tables' last (dump) rows excluded."""
    for t, name in ((acct_rows, "acct_rows"), (xfer_rows, "xfer_rows")):
        _need(t, torch.int32, 2, name)
        if t.shape[1] != 32 or t.shape[0] < 1:
            raise ValueError(f"{name}: shape {tuple(t.shape)}")
    _need(commit_ts, torch.int64, 0, "commit_ts")
    out = torch.empty(5, dtype=torch.int64, device=acct_rows.device)
    _launch("tb_fingerprint", "fingerprint", _ptr(acct_rows), acct_rows.shape[0] - 1,
            _ptr(xfer_rows), xfer_rows.shape[0] - 1, _ptr(commit_ts), _ptr(out), _stream())
    return out


def install_rows(state, table: str, rows_b, ful_b, n: int, cap_log2: int):
    """K9: install the row images `rows_b` [B, 32] (lanes < n) into the
    `table` ("acct" or "xfer") of `state` in place, with their fulfill words
    `ful_b` [B] for transfers (None for accounts)."""
    if table not in ("acct", "xfer") or (ful_b is None) != (table == "acct"):
        raise ValueError(f"install: table {table!r} with fulfill {ful_b is not None}")
    B = _check_batch(rows_b, n)
    if B == 0:
        raise ValueError("install: empty chunk")
    rows = state[f"{table}_rows"]
    _check_rows(rows, f"{table}_rows", cap_log2)
    _need(state[f"{table}_claim"], torch.int32, 1, f"{table}_claim")
    fulfill = None
    if ful_b is not None:
        _need(ful_b, torch.int32, 1, "fulfill chunk")
        _need(state["fulfill"], torch.int32, 1, "fulfill")
        if ful_b.shape[0] != B:
            raise ValueError(f"install: {ful_b.shape[0]} fulfill words for {B} rows")
        fulfill = state["fulfill"]
    scratch = _scratch("tb_install_rows_scratch", B, rows_b.device)
    _launch("tb_install_rows", "install_rows",
            _ptr(rows), _ptr(state[f"{table}_claim"]), cap_log2,
            None if fulfill is None else _ptr(fulfill),
            *_scalars(state, f"{table}_count", f"{table}_used_slots", "fault"),
            _ptr(rows_b), None if ful_b is None else _ptr(ful_b), B, n, _ptr(scratch), _stream())


FOLD_K_MAX = 16  # csrc/fold.cu FOLD_K_MAX
_fold_tls = threading.local()


def _fold_scratch(device):
    """K7's zeroed u64 scratch words, one buffer per thread, device and
    stream: the kernel leaves them zeroed, and a thread's launches on one
    stream run in order, so no two folds share words in flight."""
    bufs = _fold_tls.__dict__.setdefault("bufs", {})
    key = (device, _stream())
    buf = bufs.get(key)
    if buf is None:
        buf = bufs[key] = torch.zeros(FOLD_K_MAX, dtype=torch.int64, device=device)
    return buf


def fold(chk, flat, n_pad: int, ns, active, ring=None, idxs=None) -> None:
    """K7: fold k slots of `flat` (int32, slot j at [j * n_pad, (j + 1) *
    n_pad), lanes < ns[j]) into the chain `chk` (0-d int64, u64 bits) in
    place; a slot advances the chain where `active[j]`. With a `ring` (1-d
    int64), ring[idxs[j]] takes the chain value after slot j, in slot
    order. `ns`, `active` and `idxs` are host sequences of length k."""
    ns = np.ascontiguousarray(ns, dtype=np.int32)
    k = ns.shape[0]
    act = np.ascontiguousarray(active, dtype=np.uint8)
    _need(flat, torch.int32, 1, "flat")
    _need(chk, torch.int64, 0, "chk")
    if not 1 <= k <= FOLD_K_MAX or act.shape != (k,) or flat.shape[0] < k * n_pad \
            or ((ns < 0) | (ns > n_pad)).any():
        raise ValueError(f"fold: flat {tuple(flat.shape)}, n_pad {n_pad}, ns {ns.tolist()}, "
                         f"active {act.tolist()}")
    ring_len = 0
    idx = None
    if ring is not None:
        _need(ring, torch.int64, 1, "ring")
        ring_len = ring.shape[0]
        idx = np.ascontiguousarray(idxs, dtype=np.int32)
        if idx.shape != (k,) or ((idx < 0) | (idx >= ring_len)).any():
            raise ValueError(f"fold: ring indices {idx.tolist()} for a ring of {ring_len}")
    # ns, active and idxs are read on the host during the call
    _launch("tb_fold", "fold", _ptr(flat), n_pad, k, ns.ctypes.data, act.ctypes.data,
            None if idx is None else idx.ctypes.data, _ptr(chk),
            None if ring is None else _ptr(ring), ring_len, _ptr(_fold_scratch(flat.device)),
            _stream())


def chase(nxt, start: int, steps: int):
    """Follow `nxt` (int32 indices) from `start` for `steps` dependent loads
    in one thread; returns the last index as a 1-element tensor. Not counted
    in LAUNCHES: it measures the card, it is not a kernel of the ledger."""
    _need(nxt, torch.int32, 1, "next")
    out = torch.empty(1, dtype=torch.int32, device=nxt.device)
    lib = library()
    err = lib.tb_chase(_ptr(nxt), start, steps, _ptr(out), _stream())
    if err != 0:
        raise RuntimeError(f"tb_chase: CUDA error {err} ({lib.tb_error_string(err).decode()})")
    return out
