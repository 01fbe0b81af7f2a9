"""A/B of the serial-tier requests across checkouts.

Drives the StateMachine path of chip_smoke.py's phase 10 -- StateMachine
over ShardedLedger(8, ConfigProcess()) on cuda, its 10,000 accounts -- then
rounds of four create_transfers requests of 8190 events, as phase 10's
main path sends them: benchmark transfers and pendings (both on the fast
tier, K11tf), posts and voids of all of those pendings, and a linked
request (chains of three over its first 600 events, every tenth broken);
the last two commit on the serial tier (K11ts). Each round also sends
StateMachine over DeviceLedger(ConfigProcess()) (phase 3's ledger, the
same accounts) a benchmark request (K3, `device_transfers`) and a linked
request, whose planner runs it as waves of K3 and a 600-event residue
through K4 (`device_linked`). Each checkout runs in a
process of its own, the two taking turns (parent, change, change, parent,
...), and each request's wall time through StateMachine.commit, reply
included, is kept; the first round of a process is not.

With `--kind walk` a process instead times the serial account commit alone
(K2 serial, K11as: chip_smoke.walk_times, CUDA-event medians and quartiles
of 10 calls through the wrapper and on the card alone) at phase 11's shapes
(WALK_SHAPES: 1810 events with one linked pair, 8190 with a linked pair
every 50) on fresh ids, on one table and on 8 shards of 2^20 account slots
holding the main path's 10,000 accounts.

    python3 serial_ab.py [--parent DIR] [--kind requests|walk|sass] [--runs 4] [--rounds 4]
                         [--out FILE]

With `--kind sass` (needs nvcc, no card) it runs nothing: it compiles the
serial transfer walks (K4 `serial_transfers.cu`, K11ts
`mesh_serial_transfers.cu`) of both checkouts with the package's nvcc flags
and says, for each, whether their SASS is the same instruction for
instruction (addresses and encodings left out).

Needs one card. Writes every time to --out (JSON); the last line of its
output is the summary, also JSON.
"""

from __future__ import annotations

import argparse
import difflib
import importlib.util
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
KINDS = ("transfers", "pending", "resolve", "linked", "device_transfers", "device_linked")
SASS_SOURCES = ("serial_transfers.cu", "mesh_serial_transfers.cu")


def _smoke():
    """chip_smoke.py of this checkout, for its requests and constants."""
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def child(root: str, rounds: int) -> dict:
    """One process on the checkout at `root`: a fresh sharded ledger and a
    fresh device ledger, the accounts on each, one round untimed, then
    `rounds` timed ones."""
    import torch

    sys.path.insert(0, root)
    from tigerbeetle_tpu_torch import constants, types
    from tigerbeetle_tpu_torch import state_machine as SM
    from tigerbeetle_tpu_torch.models import ledger as L
    from tigerbeetle_tpu_torch.parallel import mesh as M

    C = _smoke()
    Op = types.Operation
    B = 8190
    rng = np.random.default_rng(C.SEED + 1)
    sm = SM.StateMachine(M.ShardedLedger(C.MESH_SHARDS, constants.ConfigProcess(), device="cuda"))
    dsm = SM.StateMachine(L.DeviceLedger(constants.ConfigProcess(), device="cuda"))

    def commit(body, machine=sm, op=Op.create_transfers):
        machine.prepare(op, body)
        start = time.perf_counter()
        reply = machine.commit(op, machine.prepare_timestamp + 10**12, body)
        return reply, time.perf_counter() - start

    acc = C.accounts(types, np.arange(1, C.N_ACCOUNTS + 1))
    for machine in (sm, dsm):
        for chunk in (acc[:B], acc[B:]):
            if commit(chunk.tobytes(), machine, Op.create_accounts)[0]:
                raise RuntimeError("an account request failed")
    torch.cuda.synchronize()
    ms = {k: [] for k in KINDS}
    for r in range(rounds + 1):
        pend_ids = np.arange(2_000_000_001 + r * B, 2_000_000_001 + (r + 1) * B)
        dr, cr = C.random_pairs(rng, B, C.N_ACCOUNTS)
        pend = C.transfers(types, pend_ids, dr, cr,
                           rng.integers(1, 1_000_000, B).astype(np.uint64), flags=2)
        res = C.transfers(types, np.arange(3_000_000_001 + r * B, 3_000_000_001 + (r + 1) * B),
                          0, 0, 0, ledger=0, code=0, flags=np.where(np.arange(B) % 2, 4, 8),
                          pending_id=pend_ids)
        lk = C.linked_request(types, rng, np.arange(4_000_000_001 + r * B,
                                                    4_000_000_001 + (r + 1) * B), 600)
        bench = C.benchmark_bodies(types, rng, 1, 1_000_000_000 + (r + 1) * B)[0]
        dbench = C.benchmark_bodies(types, rng, 1, 6_000_000_000 + (r + 1) * B)[0]
        dlk = C.linked_request(types, rng, np.arange(5_000_000_001 + r * B,
                                                     5_000_000_001 + (r + 1) * B), 600)
        for kind, body in zip(KINDS, (bench, pend.tobytes(), res.tobytes(), lk.tobytes(),
                                      dbench, dlk.tobytes())):
            reply, took = commit(body, dsm if kind.startswith("device") else sm)
            if bool(reply) != kind.endswith("linked"):  # only the broken chains fail
                raise RuntimeError(f"round {r}: an unexpected {kind} reply")
            if r > 0:
                ms[kind].append(took * 1e3)
    for machine in (sm, dsm):
        machine.backend.check_fault()
    return ms


def walk_child(root: str) -> dict:
    """One process on the checkout at `root`: the serial account commit of
    both ledgers at WALK_SHAPES, {shape: [median, p25, p75] ms}."""
    import torch

    sys.path.insert(0, root)
    from tigerbeetle_tpu_torch import constants, types
    from tigerbeetle_tpu_torch.models import ledger as L
    from tigerbeetle_tpu_torch.parallel import mesh as M

    C = _smoke()
    walks = {}
    for key, _counter, n_shards in C.WALK_KINDS:
        led, batch, kern, _plain = C.walk_ledger(torch, L, M, types, constants, n_shards, 20,
                                                 C.N_ACCOUNTS, torch.device("cuda"))
        walks[key] = (led.state, batch, kern, 20)
    return {k: list(v) for k, v in C.walk_times(torch, types, walks).items()}


def sass_of(root: Path, src: str, out_dir: Path) -> list[str]:
    """The SASS of csrc/`src` of the checkout at `root`, compiled as the
    package builds it: each function's name and instructions, one a line,
    with no addresses or encodings."""
    sys.path.insert(0, str(HERE))
    from tigerbeetle_tpu_torch.kernels import build

    nvcc = build.find_nvcc()
    obj = out_dir / f"{root.name}_{src}.o"
    subprocess.run([nvcc, *build.NVCC_FLAGS, "-c",
                    str(root / "tigerbeetle_tpu_torch" / "csrc" / src), "-o", str(obj)],
                   check=True, capture_output=True)
    dump = subprocess.run([str(Path(nvcc).parent / "cuobjdump"), "-sass", str(obj)], check=True,
                          capture_output=True, text=True).stdout
    lines = []
    for line in dump.splitlines():
        text = re.sub(r"/\*.*?\*/", "", line).strip()
        if text and ("Function :" in line or line.lstrip().startswith("/*")):
            lines.append(text)
    return lines


def sass_diff(parent: Path) -> dict:
    out_dir = HERE / "build" / "sass_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    got = {}
    for src in SASS_SOURCES:
        a, b = sass_of(parent, src, out_dir), sass_of(HERE, src, out_dir)
        diff = [x for x in difflib.unified_diff(a, b, lineterm="", n=0)
                if x[:1] in "+-" and x[:3] not in ("+++", "---")]
        got[src] = {"parent_lines": len(a), "change_lines": len(b), "differing": len(diff)}
        print(f"  {src}: parent {len(a)} SASS lines, change {len(b)}; "
              + ("identical" if not diff else f"{len(diff)} differ, first: {diff[:6]}"))
    return got


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="root of a second checkout to compare with")
    ap.add_argument("--kind", choices=("requests", "walk", "sass"), default="requests")
    ap.add_argument("--runs", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--out", help="default: chiprun_out/serial_ab[_walk].json")
    ap.add_argument("--child", metavar="ROOT", help=argparse.SUPPRESS)
    args = ap.parse_args()
    walk = args.kind == "walk"
    if args.kind == "sass":
        if not args.parent:
            ap.error("--kind sass compares with --parent")
        print(json.dumps(sass_diff(Path(args.parent).resolve())))
        return 0
    if args.child:
        print(json.dumps(walk_child(args.child) if walk else child(args.child, args.rounds)))
        return 0
    out = Path(args.out or HERE / "chiprun_out" / f"serial_ab{'_walk' if walk else ''}.json")

    import torch

    if not torch.cuda.is_available():
        print("CUDA is not available: this script runs on a card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    roots = {"change": str(HERE)}
    if args.parent:
        roots["parent"] = str(Path(args.parent).resolve())
    names = ["parent", "change"] if args.parent else ["change"]
    results = []
    for r in range(args.runs):
        name = names[(r + r // 2) % len(names)]
        proc = subprocess.run([sys.executable, str(HERE / "serial_ab.py"), "--kind", args.kind,
                               "--rounds", str(args.rounds), "--child", roots[name]],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr, file=sys.stderr)
            raise RuntimeError(f"the {name} child (run {r}) failed")
        ms = json.loads(proc.stdout.strip().splitlines()[-1])
        results.append({"variant": name, "ms": ms})
        if walk:
            print(f"  run {r}, {name}: " + ", ".join(
                f"{k} {v[0]:.4f} ms [p25 {v[1]:.4f}, p75 {v[2]:.4f}]" for k, v in ms.items()))
        else:
            print(f"  run {r}, {name}: " + ", ".join(
                f"{k} median {np.median(ms[k]):.4f} ms [{min(ms[k]):.4f}, {max(ms[k]):.4f}]"
                for k in KINDS))
        sys.stdout.flush()
    keys = list(results[0]["ms"])
    # a walk run's value is its median; a request run's, the median of its requests
    run_ms = (lambda v: v[0]) if walk else (lambda v: float(np.median(v)))
    summary = {name: {k: {"median_ms": float(np.median(
        [m for x in results if x["variant"] == name
         for m in ([x["ms"][k][0]] if walk else x["ms"][k])])),
        "run_medians_ms": [run_ms(x["ms"][k]) for x in results if x["variant"] == name]}
        for k in keys} for name in names}
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card, "runs": results, "summary": summary}))
    for k in keys:
        print(f"  {k}: " + "; ".join(
            f"{name} {', '.join(f'{v:.4f}' for v in summary[name][k]['run_medians_ms'])} ms"
            for name in names) + f" [{card}]")
    print(card)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
