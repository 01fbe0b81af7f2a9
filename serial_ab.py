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

    python3 serial_ab.py [--parent DIR] [--runs 4] [--rounds 4] [--out FILE]

Needs one card. Writes every request time to --out (JSON); the last line of
its output is the summary, also JSON.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
KINDS = ("transfers", "pending", "resolve", "linked", "device_transfers", "device_linked")


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="root of a second checkout to compare with")
    ap.add_argument("--runs", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--out", default=str(HERE / "chiprun_out" / "serial_ab.json"))
    ap.add_argument("--child", metavar="ROOT", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.child, args.rounds)))
        return 0

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
        proc = subprocess.run([sys.executable, str(HERE / "serial_ab.py"), "--rounds",
                               str(args.rounds), "--child", roots[name]],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr, file=sys.stderr)
            raise RuntimeError(f"the {name} child (run {r}) failed")
        ms = json.loads(proc.stdout.strip().splitlines()[-1])
        results.append({"variant": name, "ms": ms})
        print(f"  run {r}, {name}: " + ", ".join(
            f"{k} median {np.median(ms[k]):.4f} ms [{min(ms[k]):.4f}, {max(ms[k]):.4f}]"
            for k in KINDS))
        sys.stdout.flush()
    summary = {name: {k: {"median_ms": float(np.median(
        [m for x in results if x["variant"] == name for m in x["ms"][k]])),
        "run_medians_ms": [float(np.median(x["ms"][k])) for x in results
                           if x["variant"] == name]} for k in KINDS} for name in names}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"card": card, "runs": results, "summary": summary}))
    print(card)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
