"""A/B of the port's group commit across kernel libraries and checkouts.

Drives the group path of chip_smoke.py's phase 3 -- StateMachine over
DeviceLedger(ConfigProcess()) on cuda, its 10,000 accounts, then groups of
16 requests of 8190 benchmark transfers through commit_group_async ->
commit_finish_many -> commit_finish, each group drained before the next --
with one variant per child process, the variants alternating round by
round (A B C, C B A, A B C, ...), and prints each group's wall time.

Variants:
    change       this checkout, its kernel library (every csrc/*.cu)
    change-base  this checkout, a library linked from the same objects
                 without the query and spill kernels' sources (BASE_LESS)
    parent       a second checkout (--parent DIR), its own library
    interleave   one process, this checkout, the two libraries above taking
                 turns group by group (A B B A ...)

    python3 group_ab.py [--parent DIR] [--rounds 3] [--groups 24] [--out FILE]

Needs one card. Writes every group time to --out (JSON); the last line of
its output is the summary, also JSON.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
BASE_LESS = ("filter_scan.cu", "spill_split.cu", "spill_reload.cu")
WARM_GROUPS = 2


def _smoke():
    """chip_smoke.py of this checkout, for the requests and the group
    commit of phase 3."""
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bind(K, path: str) -> ctypes.CDLL:
    """Load a kernel library with the bindings of `K` (kernels/__init__.py)
    for the entry points it has."""
    lib = ctypes.CDLL(path)
    for name, argtypes in K._SIGNATURES.items():
        if hasattr(lib, name):
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
    for name in K._SCRATCH:
        if hasattr(lib, name):
            getattr(lib, name).argtypes = [ctypes.c_int]
            getattr(lib, name).restype = ctypes.c_size_t
    lib.tb_error_string.argtypes = [ctypes.c_int]
    lib.tb_error_string.restype = ctypes.c_char_p
    return lib


def child(root: str, libs: list[str], groups: int) -> dict:
    """One process: a fresh ledger, the accounts, WARM_GROUPS groups, then
    `groups` timed ones. With two libraries, group i runs on
    libs[(i + i // 2) % 2] (A B B A ...)."""
    import torch

    sys.path.insert(0, root)
    from tigerbeetle_tpu_torch import constants, types
    from tigerbeetle_tpu_torch import kernels as K
    from tigerbeetle_tpu_torch import state_machine as SM
    from tigerbeetle_tpu_torch.models import ledger as L

    C = _smoke()
    bound = [_bind(K, p) for p in libs] if libs else [K.library()]
    K._lib = bound[0]
    Op = types.Operation
    rng = np.random.default_rng(C.SEED + 1)
    total = WARM_GROUPS + groups
    bodies = C.benchmark_bodies(types, rng, total * C.GROUP_K, 1_500_000_000)
    sm = SM.StateMachine(L.DeviceLedger(constants.ConfigProcess(), device="cuda"))
    acc = C.accounts(types, np.arange(1, C.N_ACCOUNTS + 1))
    t0 = 10**12
    for chunk in (acc[:8190], acc[8190:]):
        sm.prepare(Op.create_accounts, chunk.tobytes())
        if sm.commit(Op.create_accounts, sm.prepare_timestamp + t0, chunk.tobytes()):
            raise RuntimeError("an account request failed")
    torch.cuda.synchronize()
    ms, which = [], []
    for g in range(total):
        i = max(g - WARM_GROUPS, 0)
        side = (i + i // 2) % 2 if len(bound) == 2 else 0
        K._lib = bound[side]
        batches = C.prepare_group(sm, Op, bodies[g * C.GROUP_K:(g + 1) * C.GROUP_K])
        start = time.perf_counter()
        replies = C.commit_group(sm, Op, batches)
        took = time.perf_counter() - start
        if any(replies):
            raise RuntimeError(f"a request of group {g} failed")
        if g >= WARM_GROUPS:
            ms.append(took * 1e3)
            which.append(side)
    sm.backend.check_fault()
    return {"group_ms": ms, "lib": which}


def build_libs(parent: str | None) -> dict:
    """The kernel library of this checkout, the same objects linked without
    BASE_LESS, and the parent checkout's library (built there)."""
    sys.path.insert(0, str(HERE))
    from tigerbeetle_tpu_torch.kernels import build

    full = build.build()
    base = full.parent / "base" / build.LIB_NAME
    if not base.exists():
        base.parent.mkdir(exist_ok=True)
        objs = sorted(str(o) for o in full.parent.glob("*.o")
                      if o.stem + ".cu" not in BASE_LESS)
        subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS[:2], "-shared", "-o", str(base),
                        *objs], check=True)
    out = {"change": str(full), "change-base": str(base)}
    if parent:
        path = subprocess.run([sys.executable, "-m", "tigerbeetle_tpu_torch.kernels.build"],
                              cwd=parent, check=True, capture_output=True, text=True)
        out["parent"] = path.stdout.splitlines()[0]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="root of a second checkout to compare with")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--groups", type=int, default=24)
    ap.add_argument("--out", default=str(HERE / "chiprun_out" / "group_ab.json"))
    ap.add_argument("--child", nargs=2, metavar=("ROOT", "LIBS"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        root, libs = args.child
        print(json.dumps(child(root, [p for p in libs.split(",") if p], args.groups)))
        return 0

    import torch

    if not torch.cuda.is_available():
        print("CUDA is not available: this script runs on a card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    C = _smoke()
    libs = build_libs(args.parent)
    variants = {"change": (str(HERE), libs["change"]),
                "change-base": (str(HERE), libs["change-base"])}
    if args.parent:
        variants["parent"] = (os.path.abspath(args.parent), "")
    names = list(variants)
    runs = []
    for r in range(args.rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            root, lib = variants[name]
            runs.append((name, root, lib))
    runs.insert(len(runs) // 2, ("interleave", str(HERE),
                                 f"{libs['change']},{libs['change-base']}"))
    results = []
    for name, root, lib in runs:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, str(HERE / "group_ab.py"), "--groups",
                               str(args.groups), "--child", root, lib],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr, file=sys.stderr)
            raise RuntimeError(f"the {name} child failed")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        ms = res["group_ms"]
        res["variant"] = name
        results.append(res)
        if name == "interleave":
            for side, label in ((0, "change"), (1, "change-base")):
                sel = [m for m, s in zip(ms, res["lib"]) if s == side]
                print(f"  interleave, {label} library: median {np.median(sel):.4f} ms per group "
                      f"over {len(sel)} groups, min {min(sel):.4f}, max {max(sel):.4f}")
        else:
            print(f"  {name}: median {np.median(ms):.4f} ms per group over {len(ms)} groups, "
                  f"min {min(ms):.4f}, max {max(ms):.4f} ({time.perf_counter() - t0:.1f} s "
                  "with the process's start)")
        sys.stdout.flush()
    summary = {}
    for name in names:
        ms = [m for r in results if r["variant"] == name for m in r["group_ms"]]
        per_run = [float(np.median(r["group_ms"])) for r in results if r["variant"] == name]
        summary[name] = {"median_ms": float(np.median(ms)), "run_medians_ms": per_run,
                         "transfers_per_s": C.GROUP_K * 8190 / (np.median(ms) / 1e3)}
    inter = next(r for r in results if r["variant"] == "interleave")
    for side, label in ((0, "change"), (1, "change-base")):
        sel = [m for m, s in zip(inter["group_ms"], inter["lib"]) if s == side]
        summary[f"interleave-{label}"] = {"median_ms": float(np.median(sel))}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"card": card, "runs": results, "summary": summary}))
    print(card)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
