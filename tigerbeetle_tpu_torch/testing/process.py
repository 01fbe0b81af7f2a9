"""Spawn and stop server processes of the port's CLI (`python -m
tigerbeetle_tpu_torch format|start`), for tests and `chip_smoke.py`.

A server is spawned in a session of its own (its pgid is its pid), with
stderr merged into stdout; `spawn` reads lines until the one that says
"listening" and fails with everything the process printed if it exits
first. `terminate` sends SIGTERM and returns the `[stats]` line's JSON;
`kill_group` is the SIGKILL sweep that every spawner runs in a `finally`.
`request_stream` and `run_stream` give the requests and the reply views
that the server-parity tests compare.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np

from tigerbeetle_tpu_torch import types
from tigerbeetle_tpu_torch.state_machine import decode_results
from tigerbeetle_tpu_torch.types import AccountFlags, Operation, TransferFlags

REPO_ROOT = Path(__file__).resolve().parents[2]
MODULE = "tigerbeetle_tpu_torch"


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env(extra: dict | None) -> dict:
    env = dict(os.environ, PYTHONPATH=str(REPO_ROOT), TB_PARENT_WATCHDOG="1")
    env.update(extra or {})
    return env


def format_file(path: str, *, replica: int = 0, replica_count: int = 1,
                grid_mb: int = 8, module: str = MODULE, env: dict | None = None) -> str:
    out = subprocess.run(
        [sys.executable, "-m", module, "format", "--cluster", "0",
         "--replica", str(replica), "--replica-count", str(replica_count),
         "--grid-mb", str(grid_mb), path],
        cwd=REPO_ROOT, env=_env(env), capture_output=True, text=True, timeout=600,
    )
    if out.returncode != 0:
        raise RuntimeError(f"format failed: {out.stdout}{out.stderr}")
    return out.stdout


def _popen(path: str, addresses: str, replica: int, args: tuple, module: str,
           env: dict | None):
    cmd = [sys.executable, "-m", module, "start", "--addresses", addresses,
           "--replica", str(replica), *args, path]
    return subprocess.Popen(
        cmd, cwd=REPO_ROOT, env=_env(env), start_new_session=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )


def _listening(proc) -> str:
    proc.boot_lines = []
    while True:
        line = proc.stdout.readline()
        if "listening" in line:
            break
        if not line:  # the server exited before it listened
            kill_group(proc)
            raise RuntimeError("server failed to start:\n" + "".join(proc.boot_lines))
        proc.boot_lines.append(line)
    proc.out_lines = []
    proc.reader = threading.Thread(
        target=lambda: proc.out_lines.extend(iter(proc.stdout.readline, "")), daemon=True)
    proc.reader.start()
    return line


def spawn(path: str, addresses: str, *, replica: int = 0, args: tuple = (),
          module: str = MODULE, env: dict | None = None):
    """Start a replica; return (process, the "listening" line). The lines
    printed before it are kept as `process.boot_lines` (the port's server
    prints none); a thread reads the lines after it into
    `process.out_lines`, so that a long run never fills the pipe."""
    proc = _popen(path, addresses, replica, args, module, env)
    return proc, _listening(proc)


def spawn_cluster(paths: list, addresses: str, *, args: tuple = (), module: str = MODULE,
                  env: dict | None = None, replica_args=None) -> list:
    """Start replica i on paths[i], all at once, from this thread (a server
    with the parent-death watchdog dies with the thread that started it),
    with `args` and then `replica_args[i]` if given; return their processes
    once each has printed "listening"."""
    procs = [_popen(p, addresses, i, (*args, *(replica_args[i] if replica_args else ())),
                    module, env) for i, p in enumerate(paths)]
    try:
        for proc in procs:
            _listening(proc)
    except RuntimeError:
        for proc in procs:
            kill_group(proc)
        raise
    return procs


def kill_group(proc) -> None:
    """SIGKILL the server's whole process group and reap it. Idempotent."""
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError, OSError):
        pass
    try:
        proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        pass


def terminate(proc, timeout: float = 300) -> tuple[dict, str]:
    """SIGTERM the server; return its `[stats]` JSON and its whole output
    after the "listening" line."""
    proc.send_signal(signal.SIGTERM)
    try:
        proc.wait(timeout=timeout)
        proc.reader.join(timeout=30)
    finally:
        kill_group(proc)
    out = "".join(proc.out_lines)
    for line in proc.out_lines:
        if line.startswith("[stats] "):
            return json.loads(line[len("[stats] "):]), out
    raise RuntimeError(f"no [stats] line at SIGTERM: {out[-4000:]}")


def _accounts(rows) -> np.ndarray:
    """rows: (id, ledger, code, flags)."""
    a = np.zeros(len(rows), dtype=types.ACCOUNT_DTYPE)
    for i, (id_, ledger, code, flags) in enumerate(rows):
        a[i]["id_lo"], a[i]["ledger"], a[i]["code"], a[i]["flags"] = id_, ledger, code, flags
    return a


def _transfers(rows) -> np.ndarray:
    """rows: (id, debit, credit, amount, pending_id, flags); ledger and
    code 1 where the transfer is not a post or a void."""
    x = np.zeros(len(rows), dtype=types.TRANSFER_DTYPE)
    for i, (id_, dr, cr, amount, pending_id, flags) in enumerate(rows):
        x[i]["id_lo"], x[i]["debit_account_id_lo"], x[i]["credit_account_id_lo"] = id_, dr, cr
        x[i]["amount_lo"], x[i]["pending_id_lo"], x[i]["flags"] = amount, pending_id, flags
        if not pending_id:
            x[i]["ledger"], x[i]["code"] = 1, 1
    return x


def _ids(ids) -> np.ndarray:
    out = np.zeros(len(ids), dtype=[("lo", "<u8"), ("hi", "<u8")])
    out["lo"] = ids
    return out


def request_stream(base: int = 0) -> list:
    """A request stream over accounts base+1..base+8 and transfers from
    base+10: the cases of the JAX package's process test (a pending and its
    post, the same account on both sides), failing account creates, more
    pendings with posts and voids (one of an already posted pending), a
    linked chain that holds and one that breaks, a limit account's
    overdraft, and lookups of accounts and transfers, a missing id each.
    Each entry is (operation, numpy rows)."""
    b = base
    lnk, pnd = int(TransferFlags.linked), int(TransferFlags.pending)
    post, void = int(TransferFlags.post_pending_transfer), int(TransferFlags.void_pending_transfer)
    limit = int(AccountFlags.debits_must_not_exceed_credits)
    return [
        (Operation.create_accounts, _accounts(
            [(b + i, 1, 1, 0) for i in range(1, 7)] + [(b + 7, 1, 1, limit)]
            + [(b + 1, 1, 1, 0), (b + 8, 0, 1, 0)])),
        (Operation.create_transfers, _transfers([
            (b + 10, b + 1, b + 2, 100, 0, 0), (b + 11, b + 1, b + 3, 50, 0, pnd),
            (b + 12, 0, 0, 0, b + 11, post), (b + 13, b + 1, b + 1, 5, 0, 0)])),
        (Operation.create_transfers, _transfers(
            [(b + 20 + i, b + 1 + i % 3, b + 4, 10 + i, 0, pnd) for i in range(4)])),
        (Operation.create_transfers, _transfers([
            (b + 30, 0, 0, 0, b + 20, post), (b + 31, 0, 0, 0, b + 21, void),
            (b + 32, 0, 0, 7, b + 22, post), (b + 33, 0, 0, 0, b + 20, void),
            (b + 34, 0, 0, 0, b + 999, post)])),
        (Operation.create_transfers, _transfers([
            (b + 40, b + 2, b + 5, 3, 0, lnk), (b + 41, b + 5, b + 6, 3, 0, lnk),
            (b + 42, b + 6, b + 2, 3, 0, 0),
            (b + 43, b + 3, b + 5, 1, 0, lnk), (b + 44, b + 5, b + 5, 1, 0, 0),
            (b + 45, b + 3, b + 6, 2, 0, 0),
            (b + 50, b + 7, b + 1, 5, 0, 0), (b + 51, b + 2, b + 7, 9, 0, 0),
            (b + 52, b + 7, b + 1, 9, 0, 0), (b + 10, b + 1, b + 2, 100, 0, 0)])),
        (Operation.lookup_accounts, _ids([b + i for i in range(1, 9)] + [b + 404])),
        (Operation.lookup_transfers, _ids(
            [b + i for i in (10, 11, 12, 20, 21, 30, 31, 32, 40, 43, 45, 51, 52)] + [b + 404])),
    ]


def reply_view(operation, reply: bytes, timestamps: bool = False):
    """A reply as the server-parity tests compare it: the (index, code)
    pairs of a create, the rows of a lookup with their timestamps zeroed
    (each server stamps from its own clock) unless `timestamps`."""
    if operation in (Operation.create_accounts, Operation.create_transfers):
        return decode_results(reply, operation)
    dtype = types.ACCOUNT_DTYPE if operation == Operation.lookup_accounts else types.TRANSFER_DTYPE
    rows = np.frombuffer(reply, dtype=dtype).copy()
    if not timestamps:
        rows["timestamp"] = 0
    return rows.tobytes()


def run_stream(client, stream, timestamps: bool = False) -> list:
    """Send each request of `stream` through a client_ffi.NativeClient (of
    either package); return the reply views."""
    return [reply_view(op, client._request(op, rows.tobytes()), timestamps)
            for op, rows in stream]
