#!/usr/bin/env python3
"""K5 (the group commit), K10 in the spill cycle, the digests K6 and K7, the
lookups K1 and K11l and the fast account commits K2 fast and K11af, for two
checkouts on one card, in alternating processes.

Each round runs, for the `tigerbeetle_tpu_torch` package of one checkout,
two processes of `chip_smoke.py` (of this checkout):

- `k5_child`: groups of 16 requests of 8190 benchmark transfers on a
  DeviceLedger(ConfigProcess())'s state with 10,000 accounts, through the
  `group_commit` wrapper: each traced group's device kernels by name with
  their device time, the span from the first kernel's start to the last
  one's end and the gaps in it, the times through the wrapper and on the
  card alone (CUDA events) and the wrapper's host time;
- `cycle_child`: the spill cycle at phase 9's shape (2^20 transfer slots
  filled to the load limit: about 393 K rows spilled, 131 K kept), each
  cycle's legs (t_scan, t_gather_d2h, t_stage, t_rebuild) beside the host
  time in the K10 calls within them (t_scan: the head and the split,
  K10h and K10s; t_gather_d2h: the cold side's gather, K10g, its copies'
  enqueue and the waits for them; t_rebuild: the hot side's gather and the
  reloads, K10r, one call a chunk or one call for all), and one cycle's
  device time by kernel and copy from a trace, for the whole cycle and for
  each K10 call;
- `digest_child` (only when named in `--children`): K6 on tables of phase
  6's geometry and live rows and K7 on a group of 16 x 8190 codes and on
  one request of 8190, each with its ring, through the `fingerprint` and
  `fold` wrappers: the times through the wrapper and on the card alone
  (CUDA events), the wrapper's host time, and the device kernels, memsets
  and copies of traced calls (three K6, and a K7 for each k from 1 to 16
  with a ring and without);
- `lookup_child` (only when named in `--children`): K1 on a DeviceLedger
  and K11l on a ShardedLedger of 8 shards, 2^20 account slots a table
  holding phase 3's 10,000 accounts, 8190 of their ids: the times through
  the `lookup` and `mesh_lookup` wrappers and on the card alone (CUDA
  events), the wrapper's host time, the bound, the wall time of a lookup
  request of those ids through StateMachine, and the device kernels,
  memsets and copies of a traced wrapper call and of traced requests;
- `accounts_child` (only when named in `--children`): K2 fast on a
  DeviceLedger and K11af on a ShardedLedger of 8 shards, 2^20 account slots
  a table holding phase 3's 10,000 accounts, a batch of 8190 new accounts
  (the account leaves put back before each call): the times through the
  `commit_accounts_fast` and `mesh_commit_accounts_fast` wrappers and on
  the card alone (CUDA events), the wrapper's host time, the bound, the
  wall time of a create_accounts request of 8190 through StateMachine, and
  the device kernels, memsets and copies of a traced wrapper call and of a
  traced request;
- `spill_rate_child` (only when named in `--children`): phase 9's 128
  requests through StateMachine over the spilling ledger, its rate in
  transfers/s. Phase 9 is mostly host work, so the spread of this rate
  over one checkout's runs is what a phase-9 reading is held against.

The order is parent, this checkout, this checkout, parent, repeated
`--rounds` times; `--children cycle` runs the spill cycle alone.

    python3 group_gather_split.py --parent DIR [--rounds 1] \
        [--children k5,cycle,spill,digest,lookup,accounts]

DIR is a `git archive` of another commit in a git-ignored directory (such
as `build/parent`). Needs one card and nvcc; each checkout builds its own
kernels into its own `build/`. Prints the card, the lines of each process
and, last, a JSON summary of the medians.
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
    "s.loader.exec_module(m); m.{fn}()"
)
K5_KEYS = ("k5_ms", "k5_card_ms", "k5_host_ms")
# each cycle's legs and, after each, the K10 calls' host time within it
LEGS = ("t_scan", "cycle_head", "split_idx", "t_gather_d2h", "gather", "copies", "waits",
        "t_stage", "t_rebuild", "reload", "reload_chunks")
CALLS = ("cycle_head", "split_idx", "gather", "reload", "reload_chunks")
DIGEST_KEYS = tuple(f"{k}_{t}" for k in ("k6", "k7", "k7s")
                    for t in ("ms", "card_ms", "host_ms", "loop_ms"))
LOOKUP_KINDS = ("K1", "K11l")
LOOKUP_KEYS = ("ms", "card_ms", "host_ms", "loop_ms", "request_ms", "bound_ms")
ACCOUNT_KINDS = ("K2f", "K11af")
ACCOUNT_KEYS = ("ms", "card_ms", "host_ms", "request_ms", "bound_ms")
CHILDREN = ("k5", "cycle", "spill", "digest", "lookup", "accounts")


def child(label: str, repo: Path, fn: str) -> dict:
    code = CHILD.format(repo=str(repo), smoke=str(HERE / "chip_smoke.py"), fn=fn)
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(repo), capture_output=True,
                          text=True)
    if proc.returncode != 0:
        print(proc.stdout[-3000:], proc.stderr[-3000:], flush=True)
        raise SystemExit(f"{label}: {fn} failed")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def run(label: str, repo: Path, children) -> dict:
    out = {}
    if "k5" in children:
        k5 = out["k5"] = child(label, repo, "k5_child")
        print(f"{label}: K5 " + ", ".join(f"{k} {k5[k]:.4f}" for k in K5_KEYS), flush=True)
        for name, sp in sorted(k5["split"].items()):
            print(f"{label}: {name} {sp['counts']} device us "
                  + ", ".join(f"{k} {v:.1f}" for k, v in sp["us"].items())
                  + f"; span {sp['span_us']:.1f}, gaps {sp['gap_us']:.1f}", flush=True)
    if "cycle" in children:
        cyc = out["cycle"] = child(label, repo, "cycle_child")
        for i, r in enumerate(cyc["runs"]):
            print(f"{label}: cycle {i} spilled {r['spilled']}, calls "
                  + ", ".join(f"{c} {r['n_' + c]}" for c in CALLS) + "; "
                  + ", ".join(f"{k} {r[k] * 1e3:.3f} ms" for k in LEGS), flush=True)
        t = cyc["traced"]
        print(f"{label}: traced cycle {t['counts']} device us "
              + ", ".join(f"{k} {v:.1f}" for k, v in t["us"].items()), flush=True)
        for name, sp in sorted(cyc["traced_calls"].items()):
            print(f"{label}: traced {name} {sp['counts']} device us "
                  + ", ".join(f"{k} {v:.1f}" for k, v in sp["us"].items())
                  + f"; span {sp['span_us']:.1f}, gaps {sp['gap_us']:.1f}", flush=True)
    if "digest" in children:
        dg = out["digest"] = child(label, repo, "digest_child")
        # the event times are (median, p25, p75); the host time a median
        print(f"{label}: digests, live {dg['live']}: "
              + ", ".join(f"{k} {np.ravel(dg[k])[0]:.4f}" for k in DIGEST_KEYS), flush=True)
        for name, sp in sorted(dg["split"].items()):
            print(f"{label}: traced {name} {sp['counts']} device us "
                  + ", ".join(f"{k} {v:.1f}" for k, v in sp["us"].items()), flush=True)
    if "lookup" in children:
        lk = out["lookup"] = child(label, repo, "lookup_child")
        for kind in LOOKUP_KINDS:
            print(f"{label}: {kind} " + ", ".join(f"{k} {np.ravel(lk[kind][k])[0]:.4f}"
                                                  for k in LOOKUP_KEYS)
                  + f" ({lk[kind]['bound_by']}, longest chain {lk[kind]['longest']})", flush=True)
            for name, sp in sorted(lk[kind]["split"].items()):
                print(f"{label}: traced {name} {sp['counts']} device us "
                      + ", ".join(f"{k} {v:.1f}" for k, v in sp["us"].items()), flush=True)
    if "accounts" in children:
        ac = out["accounts"] = child(label, repo, "accounts_child")
        for kind in ACCOUNT_KINDS:
            print(f"{label}: {kind} " + ", ".join(f"{k} {np.ravel(ac[kind][k])[0]:.4f}"
                                                  for k in ACCOUNT_KEYS), flush=True)
            for name, sp in sorted(ac[kind]["split"].items()):
                print(f"{label}: traced {name} {sp['counts']} device us "
                      + ", ".join(f"{k} {v:.1f}" for k, v in sp["us"].items()), flush=True)
    if "spill" in children:
        out["spill"] = child(label, repo, "spill_rate_child")
        print(f"{label}: phase 9 {out['spill']['rate']:.0f} transfers/s", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--children", default="k5,cycle",
                    help=f"which children to run, of {', '.join(CHILDREN)} (comma-separated)")
    args = ap.parse_args()
    children = set(args.children.split(","))
    if not children or children - set(CHILDREN):
        ap.error(f"--children: {args.children!r}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    runs = {"parent": [], "change": []}
    for _ in range(args.rounds):
        for label, repo in (("parent", args.parent.resolve()), ("change", HERE),
                            ("change", HERE), ("parent", args.parent.resolve())):
            runs[label].append(run(label, repo, children))
    summary = {"card": card}
    for label, got in runs.items():
        summary[label] = s = {}
        if "k5" in children:
            s.update({k: float(np.median([g["k5"][k] for g in got])) for k in K5_KEYS})
            s["k5_trace"] = got[0]["k5"]["split"]
        if "cycle" in children:
            untraced = [r for g in got for r in g["cycle"]["runs"][:-1]]
            s["cycle_ms"] = {k: float(np.median([r[k] for r in untraced])) * 1e3 for k in LEGS}
            s["cycle_calls"] = {c: untraced[0]["n_" + c] for c in CALLS}
            s["cycle_trace"] = got[0]["cycle"]["traced"]
            s["cycle_trace_calls"] = got[0]["cycle"]["traced_calls"]
        if "spill" in children:
            s["spill_rates"] = [g["spill"]["rate"] for g in got]
        if "digest" in children:
            s["digest"] = {k: [float(np.ravel(g["digest"][k])[0]) for g in got]
                           for k in DIGEST_KEYS}
            s["digest_trace"] = {name: sp["counts"]
                                 for name, sp in got[0]["digest"]["split"].items()}
        if "lookup" in children:
            s["lookup"] = {kind: {k: [float(np.ravel(g["lookup"][kind][k])[0]) for g in got]
                                  for k in LOOKUP_KEYS} for kind in LOOKUP_KINDS}
            s["lookup_trace"] = {kind: {name: sp["counts"] for name, sp in
                                        got[0]["lookup"][kind]["split"].items()}
                                 for kind in LOOKUP_KINDS}
        if "accounts" in children:
            s["accounts"] = {kind: {k: [float(np.ravel(g["accounts"][kind][k])[0]) for g in got]
                                    for k in ACCOUNT_KEYS} for kind in ACCOUNT_KINDS}
            s["accounts_trace"] = {kind: {name: sp["counts"] for name, sp in
                                          got[0]["accounts"][kind]["split"].items()}
                                   for kind in ACCOUNT_KINDS}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
