#!/usr/bin/env python3
"""K8 (the query scan) and K9 (the snapshot install) of two checkouts on one
card, in alternating processes.

Each process runs `chip_smoke.k8_k9_child` (of this checkout) against the
`tigerbeetle_tpu_torch` package of one checkout: K8 on a 2^24 transfer
table with about 1.2 M live rows, by debit_account_id (about 120 matches)
and by code (all of them); K9 restoring 133 chunks of 8192 transfer rows
into a fresh 2^24 table, one wrapper call a table where the checkout has
`install_rows_chunked`, else one a chunk. It prints each call's device
kernels from a torch.profiler trace (by name, with their summed device
time), the times through the wrapper and on the card alone (CUDA events)
and the wrappers' host time. The order is parent, this checkout, this
checkout, parent, repeated `--rounds` times.

    python3 scan_install_split.py --parent DIR [--rounds 1]

DIR is a `git archive` of another commit in a git-ignored directory (such
as `build/parent`). Needs one card and nvcc; each checkout builds its own
kernels into its own `build/`. Prints the card, one line per process and,
last, a JSON summary of the medians.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
CHILD = (
    "import sys, importlib.util as u; sys.path.insert(0, {repo!r}); "
    "s = u.spec_from_file_location('chip_smoke', {smoke!r}); m = u.module_from_spec(s); "
    "s.loader.exec_module(m); m.k8_k9_child()"
)
KEYS = ("k8_debit_ms", "k8_debit_card_ms", "k8_debit_host_ms", "k8_code_ms", "k8_code_card_ms",
        "k8_code_host_ms", "k9_restore_ms", "k9_restore_card_ms", "k9_restore_host_ms",
        "k9_chunk_ms", "k9_chunk_card_ms", "k9_chunk_host_ms")


def run(label: str, repo: Path) -> dict:
    code = CHILD.format(repo=str(repo), smoke=str(HERE / "chip_smoke.py"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(repo), capture_output=True,
                          text=True)
    if proc.returncode != 0:
        print(proc.stdout[-3000:], proc.stderr[-3000:], flush=True)
        raise SystemExit(f"{label}: the measuring process failed")
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    launches = {name: sum(v for k, v in kernels.items() if not k.startswith("memset"))
                for name, kernels in got["trace"].items()}
    print(f"{label}: " + ", ".join(f"{k} {got[k]:.4f}" for k in KEYS), flush=True)
    print(f"{label}: device launches a call {launches}", flush=True)
    for name in ("k8_debit_0", "k8_code_0", "k9_restore"):
        split = got["split_us"].get(name, {})
        print(f"{label}: {name} device us by kernel "
              + ", ".join(f"{k} x{got['trace'][name][k]} {v:.1f}" for k, v in split.items()),
              flush=True)
    got["launches"] = launches
    return got


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    runs = {"parent": [], "change": []}
    for _ in range(args.rounds):
        for label, repo in (("parent", args.parent.resolve()), ("change", HERE),
                            ("change", HERE), ("parent", args.parent.resolve())):
            runs[label].append(run(label, repo))
    summary = {"card": card}
    for label, got in runs.items():
        summary[label] = {k: float(np.median([g[k] for g in got])) for k in KEYS}
        summary[label]["launches"] = got[0]["launches"]
        summary[label]["split_us"] = got[0]["split_us"]
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
