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
    install_rows            K9  DeviceLedger._install_fn (one chunk, or
                                a table chunk by chunk: install_rows_chunked)
    fold                    K7  fold_reply_codes and the fused folds of
                                models/dual_ledger.py
    filter_scan             K8  LedgerKernels.filter_scan
    spill_head              K10 SpillKernels._cycle_head (models/spill.py)
    spill_split             K10 SpillKernels._split_idx
    spill_gather            K10 SpillKernels._gather
    spill_reload            K10 SpillKernels._reload (one chunk, or the
                                rebuild's chunks in order: spill_reload_chunks)

The sharded ledger's kernels (K11; JAX counterparts in
tigerbeetle_tpu/parallel/mesh.py `ShardedLedgerKernels`):
    mesh_lookup                   _lookup_accounts_shard/_transfers_shard
    mesh_commit_accounts_fast     _commit_accounts_fast
    mesh_commit_accounts_serial   _commit_accounts_serial
    mesh_commit_transfers_fast    _commit_transfers_fast
    mesh_commit_transfers_serial  _commit_transfers_serial

`walk_reprobes` reads how many events the last serial account commit (K2
serial, K11as) resolved again on the table as it stood.

`chase` and `chase_shared` are no kernels of the ledger: pointer chases
that measure the card's dependent-load latency, from device memory and from
shared memory, for the serial kernels' bounds; nor is `sector_probe`, which
measures the rate at which the card reads chosen sectors of 128-byte rows,
for the scans' bounds, nor `cluster_floor`, one cluster launch that only
passes barriers, the yardstick of the one-cluster commits.
"""

from __future__ import annotations

import ctypes
import struct
import threading

import numpy as np
import torch

_P = ctypes.c_void_p
_I = ctypes.c_int
_U64 = ctypes.c_uint64
_I64 = ctypes.c_longlong
_U32 = ctypes.c_uint32

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
    "filter_scan": 0,
    "spill_head": 0,
    "spill_split": 0,
    "spill_gather": 0,
    "spill_reload": 0,
    "mesh_lookup": 0,
    "mesh_commit_accounts_fast": 0,
    "mesh_commit_accounts_serial": 0,
    "mesh_commit_transfers_fast": 0,
    "mesh_commit_transfers_serial": 0,
}

_SIGNATURES = {
    "tb_lookup": [_P, _I, _P, _I, _P, _P],
    "tb_commit_accounts_fast": [_P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _U64, _P, _P, _P],
    "tb_commit_accounts_serial": [_P, _I, _P, _P, _P, _P, _P, _I, _I, _U64, _P, _P, _P],
    "tb_commit_transfers_fast": [_P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                 _I, _I, _U64, _I, _P, _P, _P],
    "tb_commit_transfers_serial": [_P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                   _P, _P, _P],
    "tb_group_commit": [_P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P,
                        _P, _P, _P, _P],
    "tb_fingerprint": [_P, _I64, _P, _I64, _P, _P, _P, _P],
    "tb_install_rows": [_P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I64, _P, _P],
    "tb_fold": [_P, _I64, _I, _I, ctypes.c_char_p, _P, _P, _I, _P, _P],
    "tb_filter_scan": [_P, _I, _I, _I, _I, _U32, _U32, _U32, _U32, _P, _P, _P, _U32, _P],
    "tb_spill_head": [_P, _I, _P, _P, _P],
    "tb_spill_split": [_P, _I, _I64, _P, _P, _P, _P],
    "tb_spill_gather": [_P, _P, _P, _I64, _P, _P, _P],
    "tb_spill_reload": [_P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _P, _P, _P],
    "tb_spill_reload_chunks": [_P, _P, _P, _I, _P, _P, _P, _P, _I64, _I, _P, _P, _P],
    "tb_chase": [_P, ctypes.c_uint32, _I, _P, _P],
    "tb_mesh_lookup": [_P, _I, _P, _I, _I, _P, _P],
    "tb_mesh_commit_accounts_fast": [_P, _P, _I, _I, _P, _P, _P, _P, _P, _I, _I, _U64, _P, _P,
                                     _P],
    "tb_mesh_commit_accounts_serial": [_P, _I, _I, _P, _P, _P, _P, _P, _I, _I, _U64, _P, _P, _P],
    "tb_mesh_commit_transfers_fast": [_P, _I, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                      _I, _U64, _P, _P, _P],
    "tb_mesh_commit_transfers_serial": [_P, _I, _P, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I,
                                        _U64, _P, _P, _P],
    "tb_chase_shared": [_P, _I, ctypes.c_uint32, _I, _P, _P],
    "tb_sector_probe": [_P, _I64, _U32, _P, _P],
    "tb_cluster_floor": [_I, _P],
}
_SCRATCH = (
    "tb_commit_accounts_fast_scratch",
    "tb_commit_accounts_serial_scratch",
    "tb_commit_transfers_fast_scratch",
    "tb_commit_transfers_serial_scratch",
    "tb_install_rows_scratch",
    "tb_filter_scan_state_bytes",
    "tb_spill_split_scratch",
    "tb_spill_reload_scratch",
    "tb_mesh_commit_accounts_fast_scratch",
    "tb_mesh_commit_accounts_serial_scratch",
    "tb_mesh_commit_transfers_fast_scratch",
    "tb_mesh_commit_transfers_serial_scratch",
)

# the kernels whose scratch is kept zeroed between calls, with the C
# function that gives its size
_KEPT = {"fingerprint": "tb_fingerprint_scratch_bytes", "fold": "tb_fold_scratch_bytes"}

_lib = None
# the last scratch buffer of each serial account walk, whose header holds its
# re-probe count (walk_reprobes)
_WALK_SCRATCH: dict = {}


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
        for name in _KEPT.values():
            fn = getattr(lib, name)
            fn.argtypes = []
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
    """PyTorch's current stream on the current device, as a raw handle (what
    `torch.cuda.current_stream().cuda_stream` gives, without the Stream
    object)."""
    return torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())


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


LOOKUP_ROW_BYTES = 128  # a key's row in a lookup's buffer; with its two flags a key takes 130 bytes


def lookup_bytes(B: int) -> int:
    """The bytes of a lookup's buffer for B keys, whole int32 words."""
    return B * (LOOKUP_ROW_BYTES + 2) + (-B * (LOOKUP_ROW_BYTES + 2)) % 4


def lookup_views(buf, B: int):
    """(found bool [B], rows int32 [B, 32], resolved bool [B]): views of a
    lookup's one buffer `buf` (bool [lookup_bytes(B)], on the card or a host
    copy of it). csrc/group_probe.cuh
    `group_store` writes it so: B rows, then B found bytes, then B resolved
    bytes. Four view operations: each costs the host about as much as an
    allocation."""
    rows_end = B * LOOKUP_ROW_BYTES
    return (buf[rows_end:rows_end + B],
            buf.view(torch.int32).as_strided((B, 32), (32, 1)),
            buf[rows_end + B:rows_end + 2 * B])


def _lookup_out(key4, rows):
    _need(key4, torch.int32, 2, "key4")
    if key4.shape[1] != 4:
        raise ValueError(f"key4: shape {tuple(key4.shape)}, want [B, 4]")
    B = key4.shape[0]
    return B, torch.empty(lookup_bytes(B), dtype=torch.bool, device=rows.device)


def lookup_raw(key4, rows, cap_log2: int):
    """K1: probe `key4` [B, 4] in `rows`; returns the kernel's one output
    buffer (bool [lookup_bytes(B)], read by `lookup_views`)."""
    _check_rows(rows, "rows", cap_log2)
    B, out = _lookup_out(key4, rows)
    _launch("tb_lookup", "lookup", _ptr(key4), B, _ptr(rows), cap_log2, _ptr(out), _stream())
    return out


def lookup(key4, rows, cap_log2: int):
    """K1 as (found, rows [B, 32], resolved), views of `lookup_raw`'s buffer."""
    return lookup_views(lookup_raw(key4, rows, cap_log2), key4.shape[0])


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
    _WALK_SCRATCH["commit_accounts_serial"] = scratch
    _launch("tb_commit_accounts_serial", "commit_accounts_serial",
            _ptr(state["acct_rows"]), a_log2,
            *_scalars(state, "commit_ts", "acct_count", "acct_used_slots", "fault"),
            _ptr(rows_b), B, n, _u64(timestamp), _ptr(results), _ptr(scratch), _stream())
    return results


def walk_reprobes(counter: str) -> int:
    """The events that the last call of the serial account walk `counter`
    (`commit_accounts_serial`, `mesh_commit_accounts_serial`) resolved again
    because the batch had written into their probe windows. Read from that
    call's scratch header: it waits for the call to finish."""
    return int(_WALK_SCRATCH[counter][:8].view(torch.int64)[0])


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
    (u64 as int64) into `state` in place (one block: a walker warp and the
    prefetch warps of its lookahead ring); returns int32 codes."""
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
    < ns[i], timestamp tss[i]) into `state` in place, in slot order, with
    K3's fast-tier phases, in one launch of one cluster. Returns (flat int32 [k * n_pad + 1]: the codes of each
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


_kept_tls = threading.local()


def _kept(kernel: str, device):
    """The scratch buffer of `kernel` (a key of _KEPT) for one device and
    stream: zeroed once; each call's last block leaves it zero again, and a
    thread's launches on one stream run in order, so no two calls share it
    in flight."""
    bufs = _kept_tls.__dict__.setdefault("bufs", {})
    key = (kernel, device, _stream())
    buf = bufs.get(key)
    if buf is None:
        nbytes = getattr(library(), _KEPT[kernel])()
        buf = bufs[key] = torch.zeros(nbytes, dtype=torch.uint8, device=device)
    return buf


def fingerprint(acct_rows, xfer_rows, commit_ts):
    """K6: int64 [5] = accounts_fp, transfers_fp, live accounts, live
    transfers (u64 bits), commit_ts; the tables' last (dump) rows excluded.
    One launch over both tables."""
    for t, name in ((acct_rows, "acct_rows"), (xfer_rows, "xfer_rows")):
        _need(t, torch.int32, 2, name)
        if t.shape[1] != 32 or t.shape[0] < 1:
            raise ValueError(f"{name}: shape {tuple(t.shape)}")
    _need(commit_ts, torch.int64, 0, "commit_ts")
    dev = acct_rows.device
    out = torch.empty(5, dtype=torch.int64, device=dev)
    _launch("tb_fingerprint", "fingerprint", _ptr(acct_rows), acct_rows.shape[0] - 1,
            _ptr(xfer_rows), xfer_rows.shape[0] - 1, _ptr(commit_ts), _ptr(out),
            _ptr(_kept("fingerprint", dev)), _stream())
    return out


def _install(state, table: str, rows_b, ful_b, chunk: int, n: int, cap_log2: int) -> None:
    if table not in ("acct", "xfer") or (ful_b is None) != (table == "acct"):
        raise ValueError(f"install: table {table!r} with fulfill {ful_b is not None}")
    if not 1 <= chunk < 1 << 31:
        raise ValueError(f"install: chunk {chunk}")
    rows = state[f"{table}_rows"]
    _check_rows(rows, f"{table}_rows", cap_log2)
    _need(state[f"{table}_claim"], torch.int32, 1, f"{table}_claim")
    fulfill = None
    if ful_b is not None:
        _need(ful_b, torch.int32, 1, "fulfill rows")
        _need(state["fulfill"], torch.int32, 1, "fulfill")
        if ful_b.shape[0] != rows_b.shape[0]:
            raise ValueError(f"install: {ful_b.shape[0]} fulfill words for {rows_b.shape[0]} rows")
        fulfill = state["fulfill"]
    scratch = _scratch("tb_install_rows_scratch", chunk, rows_b.device)
    _launch("tb_install_rows", "install_rows",
            _ptr(rows), _ptr(state[f"{table}_claim"]), cap_log2,
            None if fulfill is None else _ptr(fulfill),
            *_scalars(state, f"{table}_count", f"{table}_used_slots", "fault"),
            _ptr(rows_b), None if ful_b is None else _ptr(ful_b), chunk, n, _ptr(scratch),
            _stream())


def install_rows(state, table: str, rows_b, ful_b, n: int, cap_log2: int):
    """K9, one chunk: install the row images `rows_b` [B, 32] (lanes < n)
    into the `table` ("acct" or "xfer") of `state` in place, with their
    fulfill words `ful_b` [B] for transfers (None for accounts)."""
    B = _check_batch(rows_b, n)
    if B == 0:
        raise ValueError("install: empty chunk")
    _install(state, table, rows_b, ful_b, B, n, cap_log2)


def install_rows_chunked(state, table: str, rows, ful, cap_log2: int, chunk: int):
    """K9, a whole table in one launch: the row images `rows` [n, 32] (and
    fulfill words `ful` [n] for transfers, None for accounts) installed in
    chunks of `chunk` rows in order, each chunk as `install_rows` installs
    it."""
    n = _check_batch(rows, 0)  # its row count
    _install(state, table, rows, ful, chunk, n, cap_log2)


_FOLD_BAD_ARGUMENT = -1  # csrc/fold.cu FOLD_BAD_ARGUMENT


def fold(chk, flat, n_pad: int, ns, active, ring=None, idxs=None) -> None:
    """K7: fold k slots of `flat` (int32, slot j at [j * n_pad, (j + 1) *
    n_pad), lanes < ns[j]) into the chain `chk` (0-d int64, u64 bits) in
    place; a slot advances the chain where `active[j]`. With a `ring` (1-d
    int64), ring[idxs[j]] takes the chain value after slot j, in slot
    order. `ns`, `active` and `idxs` are host sequences of length k. One
    launch. Raises ValueError, launching nothing, where 1 <= k <= 16, 0 <=
    ns[j] <= n_pad or 0 <= idxs[j] < len(ring) fails (checked in C)."""
    _need(flat, torch.int32, 1, "flat")
    _need(chk, torch.int64, 0, "chk")
    k = len(ns)
    if ring is not None:
        _need(ring, torch.int64, 1, "ring")
    if len(active) != k or (ring is not None and len(idxs) != k):
        raise ValueError(f"fold: {k} slots, {len(active)} active flags, ring indices "
                         f"{None if idxs is None else list(idxs)}")
    mask = sum(1 << j for j, a in enumerate(active) if a)
    slots = [*ns, mask] if ring is None else [*ns, mask, *idxs]
    lib = library()
    # the slot counts, the active mask and the ring indices, read on the
    # host during the call
    err = lib.tb_fold(_ptr(flat), flat.shape[0], n_pad, k, struct.pack(f"{len(slots)}q", *slots),
                      _ptr(chk), None if ring is None else _ptr(ring),
                      0 if ring is None else ring.shape[0], _ptr(_kept("fold", flat.device)),
                      _stream())
    if err == _FOLD_BAD_ARGUMENT:
        raise ValueError(f"fold: flat {tuple(flat.shape)}, n_pad {n_pad}, ns {list(ns)}, ring "
                         f"indices {None if idxs is None else list(idxs)} for a ring of "
                         f"{0 if ring is None else ring.shape[0]}")
    if err != 0:
        raise RuntimeError(f"tb_fold: CUDA error {err} ({lib.tb_error_string(err).decode()})")
    LAUNCHES["fold"] += 1


QUERY_LIMIT = 8192  # csrc/filter_scan.cu QUERY_LIMIT
SPILL_CHUNK = 8192  # csrc/spill_split.cu SPILL_CHUNK


FILTER_TILE = 2048  # csrc/filter_scan.cu FS_TILE: slots a tile of the scan
_EPOCH_MAX = (1 << 30) - 1  # csrc/lookback.cuh LB_EPOCH_MASK
_scan_tls = threading.local()


class _ScanState:
    """K8's state buffer for one device and stream: the tile counters and
    status words, zeroed once and kept; each call takes the next epoch, so
    no call clears it. A thread's launches on one stream run in order, so no
    two scans share it in flight."""

    def __init__(self, nbytes: int, device):
        self.buf = torch.zeros(nbytes, dtype=torch.uint8, device=device)
        self.epoch = 0

    def next_epoch(self) -> int:
        if self.epoch == _EPOCH_MAX:  # every status word back to no epoch
            self.buf.zero_()
            self.epoch = 0
        self.epoch += 1
        return self.epoch


def _scan_state(cap_log2: int, device) -> _ScanState:
    states = _scan_tls.__dict__.setdefault("states", {})
    key = (device, _stream())
    nbytes = library().tb_filter_scan_state_bytes(cap_log2)
    st = states.get(key)
    if st is None or st.buf.shape[0] < nbytes:
        st = states[key] = _ScanState(nbytes, device)
    return st


def filter_scan(rows, cap_log2: int, spec, value_words):
    """K8: the live rows of `rows` whose field `spec` = (word0, nwords,
    halfword) equals `value_words` (four u32 ints, low first). Returns
    (int32 [QUERY_LIMIT, 32]: the first matches in slot order, then the dump
    row; int32 0-d: the total match count). One launch."""
    _check_rows(rows, "rows", cap_log2)
    word0, nwords, halfword = spec
    vw = [int(v) & 0xFFFFFFFF for v in value_words]
    if len(vw) != 4 or nwords not in (1, 2, 4) or not 0 <= word0 <= 32 - nwords \
            or word0 % nwords or (halfword and nwords != 1):
        raise ValueError(f"filter_scan: field {spec}, value words {vw}")
    dev = rows.device
    out = torch.empty((QUERY_LIMIT, 32), dtype=torch.int32, device=dev)
    total = torch.empty((), dtype=torch.int32, device=dev)
    st = _scan_state(cap_log2, dev)
    _launch("tb_filter_scan", "filter_scan", _ptr(rows), cap_log2, word0, nwords, int(halfword),
            *vw, _ptr(out), _ptr(total), _ptr(st.buf), st.next_epoch(), _stream())
    return out, total


def spill_head(rows, fault, cap_log2: int):
    """K10 cycle head: int32 [2] = [live transfers (the dump row excluded),
    the fault word]."""
    _check_rows(rows, "rows", cap_log2)
    _need(fault, torch.int32, 0, "fault")
    out = torch.zeros(2, dtype=torch.int32, device=rows.device)
    _launch("tb_spill_head", "spill_head", _ptr(rows), cap_log2, _ptr(fault), _ptr(out),
            _stream())
    return out


def spill_split(rows, cap_log2: int, n_cold: int):
    """K10 split: (cold, hot) int32 [(1 << cap_log2) + SPILL_CHUNK] each,
    the live slots below / at or above the n_cold-th smallest masked
    timestamp, in slot order, padded with the dump slot."""
    _check_rows(rows, "rows", cap_log2)
    if not 0 <= n_cold <= 1 << cap_log2:
        raise ValueError(f"spill_split: n_cold {n_cold} for {1 << cap_log2} slots")
    dev = rows.device
    size = (1 << cap_log2) + SPILL_CHUNK
    cold = torch.empty(size, dtype=torch.int32, device=dev)
    hot = torch.empty(size, dtype=torch.int32, device=dev)
    scratch = _scratch("tb_spill_split_scratch", cap_log2, dev)
    _launch("tb_spill_split", "spill_split", _ptr(rows), cap_log2, n_cold, _ptr(cold), _ptr(hot),
            _ptr(scratch), _stream())
    return cold, hot


def spill_gather(rows, fulfill, idx, out=None):
    """K10 gather: (rows [B, 32], fulfill [B]) at the slots `idx` (int32
    [B], each at most the dump slot), in one launch for any B. `out`, if
    given, is a pair of tensors to write instead: [B, 32] and [B] int32
    (views of a kept staging buffer)."""
    _need(rows, torch.int32, 2, "rows")
    _need(fulfill, torch.int32, 1, "fulfill")
    _need(idx, torch.int32, 1, "idx")
    if rows.shape[1] != 32 or fulfill.shape[0] != rows.shape[0]:
        raise ValueError(f"spill_gather: rows {tuple(rows.shape)}, fulfill {tuple(fulfill.shape)}")
    B = idx.shape[0]
    if out is None:
        out = (torch.empty((B, 32), dtype=torch.int32, device=rows.device),
               torch.empty(B, dtype=torch.int32, device=rows.device))
    out_rows, out_ful = out
    if B == 0:
        return out_rows, out_ful  # nothing to launch
    _need(out_rows, torch.int32, 2, "out rows")
    _need(out_ful, torch.int32, 1, "out fulfill")
    if out_rows.shape != (B, 32) or out_ful.shape != (B,):
        raise ValueError(f"spill_gather: out {tuple(out_rows.shape)}, {tuple(out_ful.shape)} "
                         f"for {B} slots")
    _launch("tb_spill_gather", "spill_gather", _ptr(rows), _ptr(fulfill), _ptr(idx), B,
            _ptr(out_rows), _ptr(out_ful), _stream())
    return out_rows, out_ful


def _check_reload_table(tbl, cap_log2: int) -> list[int]:
    _check_rows(tbl["xfer_rows"], "xfer_rows", cap_log2)
    for name in ("fulfill", "xfer_claim"):
        _need(tbl[name], torch.int32, 1, name)
    return _scalars(tbl, "xfer_used_slots", "fault")


def spill_reload(tbl, rows_b, ful_b, active, cap_log2: int):
    """K10 reload: the stored rows `rows_b` [B, 32] with their fulfill words
    `ful_b` [B], lanes where `active` (bool [B]), into the transfer table of
    `tbl` (a dict with xfer_rows, fulfill, xfer_claim, xfer_used_slots and
    fault) in place, all or nothing, in one launch of one cluster. Returns
    the probe word (int32 0-d)."""
    B = _check_batch(rows_b, rows_b.shape[0])
    used, fault = _check_reload_table(tbl, cap_log2)
    _need(ful_b, torch.int32, 1, "ful_b")
    _need(active, torch.bool, 1, "active")
    if B == 0 or ful_b.shape[0] != B or active.shape[0] != B:
        raise ValueError(f"spill_reload: rows {tuple(rows_b.shape)}, fulfill {tuple(ful_b.shape)}, "
                         f"active {tuple(active.shape)}")
    probe = torch.empty((), dtype=torch.int32, device=rows_b.device)
    scratch = _scratch("tb_spill_reload_scratch", B, rows_b.device)
    _launch("tb_spill_reload", "spill_reload", _ptr(tbl["xfer_rows"]), _ptr(tbl["fulfill"]),
            _ptr(tbl["xfer_claim"]), cap_log2, used, fault, _ptr(rows_b), _ptr(ful_b),
            _ptr(active), B, _ptr(probe), _ptr(scratch), _stream())
    return probe


def spill_reload_chunks(tbl, rows_b, ful_b, n: int, cap_log2: int, chunk: int = SPILL_CHUNK):
    """K10 reload of the rebuild's whole hot side in one launch: the first
    `n` stored rows of `rows_b` [>= n, 32] (fulfill words `ful_b`) in chunks
    of `chunk` rows, in order, each chunk as one `spill_reload` call on its
    slice with the lanes below its length active. Counted as a
    `spill_reload` launch. Returns the probe word after the last chunk
    (int32 0-d)."""
    _check_batch(rows_b, n)
    used, fault = _check_reload_table(tbl, cap_log2)
    _need(ful_b, torch.int32, 1, "ful_b")
    if ful_b.shape[0] < n or not 1 <= chunk < 1 << 31:
        raise ValueError(f"spill_reload_chunks: rows {tuple(rows_b.shape)}, fulfill "
                         f"{tuple(ful_b.shape)}, n {n}, chunk {chunk}")
    probe = torch.empty((), dtype=torch.int32, device=rows_b.device)
    scratch = _scratch("tb_spill_reload_scratch", chunk, rows_b.device)
    _launch("tb_spill_reload_chunks", "spill_reload", _ptr(tbl["xfer_rows"]), _ptr(tbl["fulfill"]),
            _ptr(tbl["xfer_claim"]), cap_log2, used, fault, _ptr(rows_b), _ptr(ful_b), n, chunk,
            _ptr(probe), _ptr(scratch), _stream())
    return probe


MESH_SHARDS_MAX = 64  # csrc/owner.cuh MESH_SHARDS_MAX


def _mesh_table(t, name: str, cap_log2: int, width: int = 32) -> int:
    """Check a sharded table [S, (1 << cap_log2) + 1(, 32)]; returns S."""
    _need(t, torch.int32, 3 if width else 2, name)
    S = t.shape[0]
    want = (S, (1 << cap_log2) + 1) + ((width,) if width else ())
    if tuple(t.shape) != want or not 1 <= S <= MESH_SHARDS_MAX:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, want {want} with 1 <= S <= "
                         f"{MESH_SHARDS_MAX}")
    return S


def _mesh_scalars(state, used: str, count: str, S: int) -> list[int]:
    _need(state[used], torch.int64, 1, used)
    if state[used].shape[0] != S:
        raise ValueError(f"{used}: {state[used].shape[0]} counters for {S} shards")
    commit_ts, n, fault = _scalars(state, "commit_ts", count, "fault")
    return [commit_ts, n, _ptr(state[used]), fault]


def mesh_lookup_raw(key4, rows, cap_log2: int):
    """K11 lookup: probe `key4` [B, 4] on each key's owner shard of the
    sharded table `rows` [S, capacity + 1, 32]; returns the kernel's one
    output buffer (bool [lookup_bytes(B)], read by `lookup_views`; a row is
    all zero where its key is not found)."""
    S = _mesh_table(rows, "rows", cap_log2)
    B, out = _lookup_out(key4, rows)
    _launch("tb_mesh_lookup", "mesh_lookup", _ptr(key4), B, _ptr(rows), cap_log2, S, _ptr(out),
            _stream())
    return out


def mesh_lookup(key4, rows, cap_log2: int):
    """K11 lookup as (found, rows [B, 32], resolved), views of
    `mesh_lookup_raw`'s buffer."""
    return lookup_views(mesh_lookup_raw(key4, rows, cap_log2), key4.shape[0])


def mesh_commit_accounts_fast(state, rows_b, n: int, timestamp: int, a_log2: int):
    """K11 fast account commit of `rows_b` into the sharded `state` in
    place; returns int32 codes."""
    B = _check_batch(rows_b, n)
    S = _mesh_table(state["acct_rows"], "acct_rows", a_log2)
    _mesh_table(state["acct_claim"], "acct_claim", a_log2, 0)
    results = torch.empty(B, dtype=torch.int32, device=rows_b.device)
    scratch = _scratch("tb_mesh_commit_accounts_fast_scratch", B, rows_b.device)
    _launch("tb_mesh_commit_accounts_fast", "mesh_commit_accounts_fast",
            _ptr(state["acct_rows"]), _ptr(state["acct_claim"]), a_log2, S,
            *_mesh_scalars(state, "acct_used_slots", "acct_count", S),
            _ptr(rows_b), B, n, _u64(timestamp), _ptr(results), _ptr(scratch), _stream())
    return results


def mesh_commit_accounts_serial(state, rows_b, n: int, timestamp: int, a_log2: int):
    """K11 serial account commit of `rows_b` into the sharded `state` in
    place; returns int32 codes."""
    B = _check_batch(rows_b, n)
    S = _mesh_table(state["acct_rows"], "acct_rows", a_log2)
    results = torch.empty(B, dtype=torch.int32, device=rows_b.device)
    scratch = _scratch("tb_mesh_commit_accounts_serial_scratch", B, rows_b.device)
    _WALK_SCRATCH["mesh_commit_accounts_serial"] = scratch
    _launch("tb_mesh_commit_accounts_serial", "mesh_commit_accounts_serial",
            _ptr(state["acct_rows"]), a_log2, S,
            *_mesh_scalars(state, "acct_used_slots", "acct_count", S),
            _ptr(rows_b), B, n, _u64(timestamp), _ptr(results), _ptr(scratch), _stream())
    return results


def mesh_commit_transfers_fast(state, rows_b, n: int, timestamp: int, a_log2: int,
                               t_log2: int):
    """K11 fast transfer commit of `rows_b` into the sharded `state` in
    place (one launch of one thread-block cluster); returns int32 codes."""
    B = _check_batch(rows_b, n)
    S = _mesh_table(state["acct_rows"], "acct_rows", a_log2)
    if _mesh_table(state["xfer_rows"], "xfer_rows", t_log2) != S \
            or _mesh_table(state["bal_acc"], "bal_acc", a_log2) != S \
            or _mesh_table(state["fulfill"], "fulfill", t_log2, 0) != S \
            or _mesh_table(state["xfer_claim"], "xfer_claim", t_log2, 0) != S:
        raise ValueError("sharded state: tables of different shard counts")
    results = torch.empty(B, dtype=torch.int32, device=rows_b.device)
    scratch = _scratch("tb_mesh_commit_transfers_fast_scratch", B, rows_b.device)
    _launch("tb_mesh_commit_transfers_fast", "mesh_commit_transfers_fast",
            _ptr(state["acct_rows"]), a_log2, _ptr(state["xfer_rows"]), t_log2, S,
            _ptr(state["fulfill"]), _ptr(state["xfer_claim"]), _ptr(state["bal_acc"]),
            *_mesh_scalars(state, "xfer_used_slots", "xfer_count", S),
            _ptr(rows_b), B, n, _u64(timestamp), _ptr(results), _ptr(scratch), _stream())
    return results


def mesh_commit_transfers_serial(state, rows_b, n: int, timestamp: int, a_log2: int,
                                 t_log2: int):
    """K11 serial transfer commit of `rows_b` into the sharded `state` in
    place, event by event (one block: a walker warp and the prefetch warps
    of its lookahead ring); returns int32 codes."""
    B = _check_batch(rows_b, n)
    S = _mesh_table(state["acct_rows"], "acct_rows", a_log2)
    if _mesh_table(state["xfer_rows"], "xfer_rows", t_log2) != S \
            or _mesh_table(state["fulfill"], "fulfill", t_log2, 0) != S:
        raise ValueError("sharded state: tables of different shard counts")
    results = torch.empty(B, dtype=torch.int32, device=rows_b.device)
    scratch = _scratch("tb_mesh_commit_transfers_serial_scratch", B, rows_b.device)
    _launch("tb_mesh_commit_transfers_serial", "mesh_commit_transfers_serial",
            _ptr(state["acct_rows"]), a_log2, _ptr(state["xfer_rows"]), t_log2, S,
            _ptr(state["fulfill"]),
            *_mesh_scalars(state, "xfer_used_slots", "xfer_count", S),
            _ptr(rows_b), B, n, _u64(timestamp), _ptr(results), _ptr(scratch), _stream())
    return results


def _chase_launch(name: str, *args) -> None:
    lib = library()
    err = getattr(lib, name)(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} ({lib.tb_error_string(err).decode()})")


def chase(nxt, start: int, steps: int):
    """Follow `nxt` (int32 indices) from `start` for `steps` dependent loads
    in one thread; returns the last index as a 1-element tensor. Not counted
    in LAUNCHES: it measures the card, it is not a kernel of the ledger."""
    _need(nxt, torch.int32, 1, "next")
    out = torch.empty(1, dtype=torch.int32, device=nxt.device)
    _chase_launch("tb_chase", _ptr(nxt), start, steps, _ptr(out), _stream())
    return out


CHASE_SHARED_WORDS = 8192  # csrc/chase.cu CHASE_SHARED_WORDS
SECTOR_MASKS = (1, 3, 5, 15)  # csrc/chase.cu tb_sector_probe


def chase_shared(nxt, start: int, steps: int):
    """The same chase through shared memory: `nxt` (at most
    CHASE_SHARED_WORDS words) is copied into one block's shared memory
    first. Not counted in LAUNCHES."""
    _need(nxt, torch.int32, 1, "next")
    if not 1 <= nxt.shape[0] <= CHASE_SHARED_WORDS:
        raise ValueError(f"next: {nxt.shape[0]} words, at most {CHASE_SHARED_WORDS}")
    out = torch.empty(1, dtype=torch.int32, device=nxt.device)
    _chase_launch("tb_chase_shared", _ptr(nxt), nxt.shape[0], start, steps, _ptr(out),
                  _stream())
    return out


def sector_probe(rows, mask: int) -> None:
    """Read the 32-byte sectors `mask` (bits 0-3: 1, 3, 5 or 15) of every
    128-byte row of `rows` (int32 [n, 32]), 16 bytes a sector; returns
    nothing worth reading (time it). Not counted in LAUNCHES."""
    _need(rows, torch.int32, 2, "rows")
    if rows.shape[1] != 32 or mask not in SECTOR_MASKS:
        raise ValueError(f"sector_probe: rows {tuple(rows.shape)}, mask {mask}")
    out = torch.empty(1, dtype=torch.int32, device=rows.device)
    _chase_launch("tb_sector_probe", _ptr(rows), rows.shape[0], mask, _ptr(out), _stream())


def cluster_floor(barriers: int) -> None:
    """One launch of one 16-block cluster of 512 threads that passes
    `barriers` cluster barriers and does nothing else (time it). Not counted
    in LAUNCHES."""
    _chase_launch("tb_cluster_floor", barriers, _stream())
