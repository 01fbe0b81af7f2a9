"""ctypes binding of the repo's native C++ ledger engine (`native/ledger.cc`).

The counterpart of `tigerbeetle_tpu/native.py`, cut to the ledger engine:
the dual-commit follower answers every request with it. The engine is the
repo's C++ runtime (the same code behind the C ABI clients), so the port
builds its library from `native/ledger.cc` and copies nothing.

The library is built at first use with g++ and the flags of
`native/Makefile`, into `build/tb_native/<hash of the source and flags>/`
at the root of the checkout: a fresh checkout builds once, an edited source
builds anew, and a build never writes into `native/`. A build writes a
temporary name and renames it into place, so concurrent builds are safe.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[1]
SOURCE = REPO_ROOT / "native" / "ledger.cc"
BUILD_ROOT = REPO_ROOT / "build" / "tb_native"
LIB_NAME = "libtb_native.so"
CXXFLAGS = ["-O3", "-Wall", "-fPIC", "-maes", "-std=c++17", "-shared"]

_P = ctypes.c_void_p
_SIGNATURES = {
    # name: (argtypes, restype)
    "tb_ledger_new": ([ctypes.c_int, ctypes.c_int], _P),
    "tb_ledger_free": ([_P], None),
    "tb_ledger_execute": ([_P, ctypes.c_uint8, ctypes.c_char_p, ctypes.c_uint32,
                           ctypes.c_uint64, _P], ctypes.c_int64),
    "tb_ledger_execute_group": ([_P, ctypes.c_uint8, _P, _P, _P, ctypes.c_uint32, _P, _P],
                                ctypes.c_int64),
    "tb_ledger_fingerprint": ([_P, _P], None),
    "tb_ledger_lookup": ([_P, ctypes.c_uint8, ctypes.c_char_p, ctypes.c_uint32, _P],
                         ctypes.c_uint64),
    "tb_ledger_counts": ([_P, _P], None),
    "tb_ledger_snapshot_size": ([_P], ctypes.c_uint64),
    "tb_ledger_snapshot": ([_P, _P], None),
    "tb_ledger_restore": ([_P, ctypes.c_char_p, ctypes.c_uint64], ctypes.c_int),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXXFLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def build() -> Path:
    """Build the engine's library if this source hash has none yet; return
    its path."""
    lib = library_path()
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=LIB_NAME + ".", dir=lib.parent)
    os.close(fd)
    try:
        out = subprocess.run(
            ["g++", *CXXFLAGS, "-o", tmp, str(SOURCE)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if out.returncode != 0:
            raise RuntimeError(f"building {SOURCE.name} failed:\n{out.stdout}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


def lib() -> ctypes.CDLL:
    """The loaded engine library (built at the first call)."""
    global _lib
    with _lock:
        if _lib is None:
            loaded = ctypes.CDLL(str(build()))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(loaded, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = loaded
    return _lib
