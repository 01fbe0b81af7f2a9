"""Build the CUDA kernels of `tigerbeetle_tpu_torch/csrc/` into one shared
library with a plain C interface (loaded with ctypes by kernels/__init__.py).

Every `csrc/*.cu` compiles with its own `nvcc -c`, all started together,
then one `nvcc -shared` links them. The output goes to
`build/tb_torch_kernels/<hash>/` at the root of the checkout, keyed on a
hash of the sources and flags, so a fresh checkout builds once at first use
and an edited source builds anew. Needs `nvcc` (on PATH or under
/usr/local/cuda/bin) and an sm_90a card to run what it builds.

    python -m tigerbeetle_tpu_torch.kernels.build   # build and print the path
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = CSRC.parents[1] / "build" / "tb_torch_kernels"
LIB_NAME = "libtb_torch_kernels.so"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


def _sources() -> list[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")
    return nvcc


def library_path() -> Path:
    return BUILD_ROOT / source_hash() / LIB_NAME


def build() -> Path:
    """Build the library if this source hash has none yet; return its path.
    The compiler's resource report (`-Xptxas -v`) is kept in build.log."""
    lib = library_path()
    if lib.exists():
        return lib
    nvcc = find_nvcc()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="build-", dir=BUILD_ROOT))
    units = [p for p in _sources() if p.suffix == ".cu"]
    procs = []
    for src in units:
        obj = tmp / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    log = []
    failed = []
    for src, _obj, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {src.name} (exit {proc.returncode})\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    (tmp / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp / LIB_NAME),
         *[str(o) for _s, o, _p in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    try:
        os.rename(tmp, lib.parent)
    except OSError:  # another process finished the same build first
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


if __name__ == "__main__":
    path = build()
    print(path)
    sys.stdout.write((path.parent / "build.log").read_text()
                     if (path.parent / "build.log").exists() else "")
