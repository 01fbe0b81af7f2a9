"""The port's VOPR fleet runner (reference: src/vopr.zig and
src/simulator.zig:66-152; the counterpart of `scripts/vopr.py`).

Runs a range of simulator seeds, each with its seed-drawn topology (1-6
replicas, 0-2 standbys, 1-8 clients) and fault mix (partitions, torn
writes, WAL, client-reply and superblock faults together; a
`--device-fraction` slice of seeds runs each replica's DeviceLedger with a
forest and grid faults). The seed alone reproduces topology, workload and
fault schedule.

    python -m tigerbeetle_tpu_torch.testing.vopr [--seeds N] [--start S]
        [--ticks T] [--device-fraction F] [--fixed] [--json PATH]
        [--trace PREFIX] [--hash-log PREFIX] [--device cpu|cuda]

`--device` (default cuda) is where the device slice's ledgers live; with
cuda the runner refuses to start where CUDA is missing. A `--verify-fraction`
slice of seeds runs with the intensive verification tier
(`constants.VERIFY`). The CDC, ingress and federation slices of
`scripts/vopr.py` need queues A6 and A7 of ROADMAP.md: their fractions
default to 0 here and a nonzero value is refused.

The runner stops at the first failing seed: it prints the seed, its
topology, the error and the line that replays it, and exits 1.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from tigerbeetle_tpu_torch import constants
from tigerbeetle_tpu_torch.testing.simulator import (
    describe_options,
    random_options,
    run_simulation,
)

VERIFY_FRACTION_DEFAULT = 0.25

# slices of scripts/vopr.py that need modules the port does not have yet
_UNPORTED_SLICES = {
    "cdc_fraction": "A6 (CDC)",
    "ingress_fraction": "A6 (ingress)",
    "federation_fraction": "A7 (federation)",
}


def seed_options(seed: int, device_fraction: float, fixed: bool,
                 verify_fraction: float = VERIFY_FRACTION_DEFAULT,
                 ) -> tuple[dict, str, bool]:
    """(Simulator kwargs, topology line, VERIFY on) for one seed: the draws
    of `scripts/vopr.py` for the slices the port runs."""
    if fixed:
        return {}, "fixed r3+s0 c2 oracle", False
    opts = random_options(seed, device_fraction=device_fraction)
    verify = (seed * 2654435761 % 100) < verify_fraction * 100
    return opts, describe_options(opts) + (" VERIFY" if verify else ""), verify


def run_seed(seed: int, ticks: int, device_fraction: float, fixed: bool,
             verify_fraction: float = VERIFY_FRACTION_DEFAULT,
             trace_path: str | None = None,
             hash_log: tuple[str, str] | None = None,
             device=None) -> tuple[dict, str]:
    """(stats, topology line) of one seed's run. A failing check raises."""
    opts, desc, verify = seed_options(seed, device_fraction, fixed, verify_fraction)
    kw = {"ticks": ticks, **opts}
    if opts.get("backend_factory", "x") is None:
        kw["device"] = device
    if hash_log is not None:
        kw["hash_log"] = hash_log
        desc += f" HASHLOG[{hash_log[0]}]"
    if trace_path is not None:
        kw["trace_path"] = trace_path
    prev, constants.VERIFY = constants.VERIFY, verify or constants.VERIFY
    try:
        return run_simulation(seed, **kw), desc
    finally:
        constants.VERIFY = prev


def replay_line(args, seed: int) -> str:
    """The command that runs `seed` again with this fleet's mode flags
    (the topology draw depends on them, not on the seed alone)."""
    extra = ""
    if args.device_fraction:
        extra += f" --device-fraction {args.device_fraction}"
    if args.verify_fraction != VERIFY_FRACTION_DEFAULT:
        extra += f" --verify-fraction {args.verify_fraction}"
    if args.fixed:
        extra += " --fixed"
    return ("python -m tigerbeetle_tpu_torch.testing.vopr "
            f"--start {seed} --seeds 1 --ticks {args.ticks} --device {args.device}{extra}")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m tigerbeetle_tpu_torch.testing.vopr")
    ap.add_argument("--seeds", type=int, default=20)
    ap.add_argument("--start", type=int, default=1)
    ap.add_argument("--ticks", type=int, default=1000)
    ap.add_argument("--device-fraction", type=float, default=0.0,
                    help="fraction of seeds on the DeviceLedger backend with a "
                         "forest and grid faults")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda",
                    help="where the device slice's ledgers live (default cuda)")
    ap.add_argument("--verify-fraction", type=float, default=VERIFY_FRACTION_DEFAULT,
                    help="fraction of seeds run with constants.VERIFY")
    for flag, queue in _UNPORTED_SLICES.items():
        ap.add_argument("--" + flag.replace("_", "-"), type=float, default=0.0,
                        help=f"needs queue {queue}; only 0 is taken")
    ap.add_argument("--fixed", action="store_true",
                    help="the fixed 3-replica / 2-client topology")
    ap.add_argument("--json", default=None,
                    help="append one JSON record per seed")
    ap.add_argument("--trace", default=None, metavar="PREFIX",
                    help="dump each seed's stitched tick-stamped trace to "
                         "PREFIX.<seed>.json")
    ap.add_argument("--hash-log", default=None, metavar="PREFIX",
                    help="per-seed hash log at PREFIX.<seed>.jsonl: recorded "
                         "when absent, checked when present")
    args = ap.parse_args(argv)
    for flag, queue in _UNPORTED_SLICES.items():
        if getattr(args, flag):
            ap.error(f"--{flag.replace('_', '-')} needs queue {queue} of "
                     "ROADMAP.md, which the port does not have yet")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("CUDA is not available: pass --device cpu to run the device "
                  "slice's plain versions", file=sys.stderr)
            return 2
    sink = open(args.json, "a") if args.json else None
    t0 = time.time()
    try:
        for seed in range(args.start, args.start + args.seeds):
            hash_log = None
            if args.hash_log:
                path = f"{args.hash_log}.{seed}.jsonl"
                hash_log = ("check" if os.path.exists(path) else "record", path)
            trace = f"{args.trace}.{seed}.json" if args.trace else None
            desc = seed_options(seed, args.device_fraction, args.fixed,
                                args.verify_fraction)[1]
            try:
                stats, desc = run_seed(seed, args.ticks, args.device_fraction,
                                       args.fixed, args.verify_fraction,
                                       trace_path=trace, hash_log=hash_log,
                                       device=args.device)
            except Exception as e:  # report the seed, then stop the fleet
                print(f"seed {seed:6d} FAIL [{desc}]: {type(e).__name__}: {e}")
                print(f"replay with: {replay_line(args, seed)}")
                if sink:
                    sink.write(json.dumps(_record(args, seed, desc, trace,
                                                  error=f"{type(e).__name__}: {e}")) + "\n")
                raise
            print(f"seed {seed:6d} ok [{desc}]: "
                  f"committed={stats['committed_ops']:5d} "
                  f"replies={stats['replies']:5d} crashes={stats['crashes']} "
                  f"wal_faults={stats['wal_faults']} torn={stats['torn_writes']} "
                  f"grid={stats['grid_faults']} view={stats['view']}", flush=True)
            if sink:
                sink.write(json.dumps(_record(args, seed, desc, trace, stats=stats)) + "\n")
                sink.flush()
    except Exception:  # noqa: BLE001 — the failure was reported above
        import traceback

        traceback.print_exc()
        return 1
    finally:
        if sink:
            sink.close()
    print(f"\n{args.seeds}/{args.seeds} passed in {time.time() - t0:.0f}s")
    return 0


def _record(args, seed, desc, trace, stats=None, error=None) -> dict:
    rec = {"seed": seed, "ticks": args.ticks, "topology": desc,
           "device_fraction": args.device_fraction,
           "verify_fraction": args.verify_fraction, "device": args.device,
           "fixed": args.fixed, "ok": error is None}
    if trace:
        rec["trace"] = trace
    rec["error" if error else "stats"] = error or stats
    return rec


if __name__ == "__main__":
    raise SystemExit(main())
