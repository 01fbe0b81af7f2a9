"""ctypes binding of the repo's native C++ runtime: the ledger engine
(`native/ledger.cc`), the AEGIS-128L checksum (`native/aegis.cc`), the
durable sector IO (`native/storage.cc`) and the C client
(`native/tb_client.cc`, bound by `client_ffi.py`).

The counterpart of `tigerbeetle_tpu/native.py`. The dual-commit follower
answers every request with the engine; the grid under the spill store's LSM
forest checksums every block with `checksum` (lsm/grid.py), and
`FileStorage` writes through the sector IO (io/storage.py). These are the
repo's C++ sources (the same code behind the C ABI clients), so the port
builds its library from them and copies nothing.

The library is built at first use with g++ and the flags of
`native/Makefile`, into `build/tb_native/<hash of the sources and flags>/`
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
NATIVE_DIR = REPO_ROOT / "native"
SOURCES = [NATIVE_DIR / name
           for name in ("aegis.cc", "storage.cc", "tb_client.cc", "ledger.cc")]
HEADERS = [NATIVE_DIR / "tb_client.h"]
BUILD_ROOT = REPO_ROOT / "build" / "tb_native"
LIB_NAME = "libtb_native.so"
CXXFLAGS = ["-O3", "-Wall", "-fPIC", "-maes", "-std=c++17", "-shared", "-pthread"]

_P = ctypes.c_void_p
_SIGNATURES = {
    # name: (argtypes, restype)
    "tb_checksum": ([ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p], None),
    "tb_storage_open": ([ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int], ctypes.c_int),
    "tb_storage_close": ([ctypes.c_int], ctypes.c_int),
    "tb_storage_write": ([ctypes.c_int, ctypes.c_uint64, ctypes.c_char_p, ctypes.c_uint64],
                         ctypes.c_int),
    "tb_storage_read": ([ctypes.c_int, ctypes.c_uint64, ctypes.c_char_p, ctypes.c_uint64],
                        ctypes.c_int),
    "tb_storage_sync": ([ctypes.c_int], ctypes.c_int),
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
    for src in SOURCES + HEADERS:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def build() -> Path:
    """Build the library if this source hash has none yet; return its path."""
    lib = library_path()
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=LIB_NAME + ".", dir=lib.parent)
    os.close(fd)
    try:
        out = subprocess.run(
            ["g++", *CXXFLAGS, f"-I{NATIVE_DIR}", "-o", tmp, *map(str, SOURCES)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if out.returncode != 0:
            raise RuntimeError(f"building {[p.name for p in SOURCES]} failed:\n{out.stdout}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


def lib() -> ctypes.CDLL:
    """The loaded library (built at the first call)."""
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


def checksum(data: bytes) -> int:
    """AEGIS-128L MAC checksum -> u128 (reference: src/vsr/checksum.zig:53);
    every grid block is guarded by it."""
    out = ctypes.create_string_buffer(16)
    lib().tb_checksum(bytes(data), len(data), out)
    return int.from_bytes(out.raw, "little")


CHECKSUM_BODY_EMPTY = 0x49F174618255402DE6E7E3C40D60CC83
"""checksum(b"") — pinned by the reference (src/vsr.zig:238)."""
