"""A/B of the wave commit (K12) and the spill cycle's head and split (K10)
across checkouts, on the card alone.

Loads the kernel library of this checkout and that of a parent checkout
(built there, as group_ab.py builds it) into one process and sends the same
inputs through each, the two taking turns (parent, change, change, parent,
...), each call timed by CUDA events with the card kept busy while the host
enqueues it (chip_smoke.timed's `on_card`), and holds the two libraries'
results against each other bit for bit.

    python3 kernel_ab.py --parent DIR [--kind waves|spill|both] [--reps 10] [--out FILE]

- waves: K12 through `kernels.wave_commit`, the parent's library bound in
  its place, at phase 15's shapes: StateMachine over
  DeviceLedger(ConfigProcess()) with its 10,000 accounts, 15% limited and
  funded, then fresh requests of 8190 events of kinds (b) between the
  accounts that are not limited (two waves), (a) uniform and (d) 341
  limited accounts x 24 debits (24 waves), planned as the ledger plans
  them. Each library commits every request into a copy of the state of its
  own; the codes of each request and both copies at the end must be equal.
- spill: K10 at 2^24 transfer slots, 3,658,560 of them live (phase 9's
  copy of the main path's state), a fifth of a percent tombstones, rising
  timestamps, split at n_cold = 3/4 of the live count: the parent's head
  (`tb_spill_head`, a table pass) and split (`tb_spill_split`, a second
  table pass, then the select and the partition) against this checkout's
  head (`tb_spill_scan`, the one table pass) and the split over it
  (`tb_spill_split_rest`). Each is timed alone (the change's split after an
  untimed head) and as the pair a cycle runs; the head's words and both
  lists must be equal.

Needs one card. Writes every time to --out (JSON); the last line of its
output is the summary, also JSON.
"""

from __future__ import annotations

import argparse
import copy
import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
WAVE_KINDS = (("b2", 2), ("a", None), ("d", 24))
SPILL_LOG2 = 24
SPILL_LIVE = 3_658_560


def _smoke():
    """chip_smoke.py of this checkout, for phase 15's traffic and the timer."""
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def parent_library(K, parent: str) -> ctypes.CDLL:
    """The parent checkout's kernel library, built there and bound with this
    checkout's signatures for the entry points both have; its K3 scratch
    size stands for the K12 scratch size it did not name yet."""
    path = subprocess.run([sys.executable, "-m", "tigerbeetle_tpu_torch.kernels.build"],
                          cwd=parent, check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(path.stdout.splitlines()[0])
    for name, argtypes in K._SIGNATURES.items():
        if hasattr(lib, name):
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
    for name in (*K._SCRATCH, "tb_commit_transfers_fast_scratch"):
        if hasattr(lib, name):
            getattr(lib, name).argtypes = [ctypes.c_int]
            getattr(lib, name).restype = ctypes.c_size_t
    if not hasattr(lib, "tb_wave_commit_scratch"):
        lib.tb_wave_commit_scratch = lib.tb_commit_transfers_fast_scratch
    P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, argtypes in (("tb_spill_head", [P, I, P, P, P]),
                           ("tb_spill_split", [P, I, I64, P, P, P, P])):
        if hasattr(lib, name):  # the head and the split before they shared a pass
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
    lib.tb_error_string.argtypes = [I]
    lib.tb_error_string.restype = ctypes.c_char_p
    return lib


def card_ms(torch, fn) -> float:
    """One call of `fn` on the card alone, in ms (CUDA events; the card
    kept busy while the host enqueues)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1 << 20)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def turns(reps: int, sides):
    """(rep, side) with the sides in turn, forwards then backwards: parent,
    change, change, parent, ..."""
    sides = list(sides)
    for r in range(reps):
        yield from ((r, side) for side in (sides if r % 2 == 0 else sides[::-1]))


def waves_ab(torch, C, K, libs, reps: int) -> dict:
    from tigerbeetle_tpu_torch import constants, types
    from tigerbeetle_tpu_torch import state_machine as SM
    from tigerbeetle_tpu_torch.models import ledger as L

    dev = torch.device("cuda")
    Op = types.Operation
    rng = np.random.default_rng(C.SEED + 15)
    acc, limited, fund = C.wave_accounts(types, rng)
    traffic = C.WaveTraffic(types, rng, limited, 9_000_000_001)
    ledger = L.DeviceLedger(constants.ConfigProcess(), device=dev)
    sm = SM.StateMachine(ledger)
    ts = 10**12
    for i in range(0, C.N_ACCOUNTS, 8190):
        ts += 8190
        if sm.commit(Op.create_accounts, ts, acc[i:i + 8190].tobytes()):
            raise RuntimeError("an account failed")
    if sm.commit(Op.create_transfers, ts + 10**6, fund.tobytes()):
        raise RuntimeError("a funding transfer failed")
    torch.cuda.synchronize()
    a_log2, t_log2 = ledger.kernels.a_log2, ledger.kernels.t_log2
    make = {"a": traffic.uniform, "b2": lambda: traffic.same_request_posts(traffic.free),
            "d": lambda: traffic.limit_chains(341, 24)}
    out = {}
    for kind, want_w in WAVE_KINDS:
        tracker = copy.deepcopy(ledger.hazards)
        reqs = []
        for _ in range(reps):
            arr = make[kind]()
            decision, plan = tracker.plan(arr)
            if decision != "waves" or plan.residue_n or (want_w and plan.n_waves != want_w):
                raise RuntimeError(f"({kind}) planned {decision}, {plan.n_waves} waves")
            reqs.append((L.transfers_to_batch(arr, dev)["rows"],
                         torch.from_numpy(plan.wave_of[:len(arr)].astype(np.uint8)).to(dev),
                         plan.n_waves, plan.has_pv))
        states = {side: C.clone_state(ledger.state) for side in libs}
        codes = {side: [] for side in libs}
        ms = {side: [] for side in libs}
        for r, side in turns(reps, libs):
            rows, wave_of, W, pv = reqs[r]
            K._lib = libs[side]
            got = []
            ms[side].append(card_ms(torch, lambda: got.append(K.wave_commit(
                states[side], rows, wave_of, W, rows.shape[0], 10**14 + r * 10**5, a_log2,
                t_log2, pv))))
            codes[side].append(got[0])
        first = next(iter(libs))
        for side in libs:
            err = C.compare_states(states[first], states[side])
            err = max([err] + [C.max_abs_diff(a, b) for a, b in zip(codes[first], codes[side])])
            if err or int(states[side]["fault"]):
                raise RuntimeError(f"K12 ({kind}): {side} differs from {first} by {err}, fault "
                                   f"{int(states[side]['fault'])}")
        out[kind] = {"waves": reqs[0][2], "events": int(reqs[0][0].shape[0]),
                     **{side: ms[side] for side in libs}}
        print(f"  K12 ({kind}, W {reqs[0][2]}, {reqs[0][0].shape[0]} events): "
              + "; ".join(f"{side} median {np.median(ms[side]):.4f} ms [{min(ms[side]):.4f}, "
                          f"{max(ms[side]):.4f}]" for side in libs)
              + "; codes and state equal", flush=True)
        del states
        torch.cuda.empty_cache()
    return out


def spill_table(torch, rng):
    """[2^24 + 1, 32] int32 on the card: SPILL_LIVE live rows at random
    slots (random ids, rising timestamps in words 30-31), a fifth of a
    percent of the slots tombstones, the rest empty."""
    slots = 1 << SPILL_LOG2
    pick = rng.permutation(slots)
    live, tomb = np.sort(pick[:SPILL_LIVE]), pick[SPILL_LIVE:SPILL_LIVE + slots // 500]
    rows = np.zeros((slots + 1, 32), dtype=np.uint32)
    rows[live, 0] = rng.integers(1, 1 << 32, SPILL_LIVE, dtype=np.uint64).astype(np.uint32)
    rows[live, 1] = np.arange(SPILL_LIVE, dtype=np.uint32)
    stamps = (1 << 40) + np.cumsum(rng.integers(1, 50, SPILL_LIVE, dtype=np.uint64))
    rows[live, 30] = (stamps & 0xFFFFFFFF).astype(np.uint32)
    rows[live, 31] = (stamps >> 32).astype(np.uint32)
    rows[tomb, :4] = 0xFFFFFFFF
    return torch.from_numpy(rows.view(np.int32)).to("cuda")


def spill_ab(torch, C, K, libs, reps: int) -> dict:
    dev = torch.device("cuda")
    rows = spill_table(torch, np.random.default_rng(C.SEED + 19))
    fault = torch.zeros((), dtype=torch.int32, device=dev)
    n_cold = SPILL_LIVE * 3 // 4
    size = (1 << SPILL_LOG2) + K.SPILL_CHUNK
    parent = libs["parent"]

    def check(err, what):
        if err:
            raise RuntimeError(f"parent {what}: CUDA error {err}")

    def parent_head():
        out = torch.zeros(2, dtype=torch.int32, device=dev)
        check(parent.tb_spill_head(rows.data_ptr(), SPILL_LOG2, fault.data_ptr(), out.data_ptr(),
                                   K._stream()), "head")
        return out

    p_scratch = torch.empty(parent.tb_spill_split_scratch(SPILL_LOG2), dtype=torch.uint8,
                            device=dev)

    def parent_split():
        cold = torch.empty(size, dtype=torch.int32, device=dev)
        hot = torch.empty(size, dtype=torch.int32, device=dev)
        check(parent.tb_spill_split(rows.data_ptr(), SPILL_LOG2, n_cold, cold.data_ptr(),
                                    hot.data_ptr(), p_scratch.data_ptr(), K._stream()), "split")
        return cold, hot

    def change_head():
        K._lib = libs["change"]
        return K.spill_scan(rows, fault, SPILL_LOG2)

    def change_split(head):
        return K.spill_split_rest(head[1], SPILL_LOG2, n_cold)

    calls = {"parent": {"head": parent_head, "split": lambda _: parent_split(),
                        "pair": lambda: (parent_head(), parent_split())},
             "change": {"head": change_head, "split": change_split,
                        "pair": lambda: change_split(change_head())}}
    ms = {side: {leg: [] for leg in ("head", "split", "pair")} for side in libs}
    for r, side in turns(reps, libs):
        c = calls[side]
        ms[side]["head"].append(card_ms(torch, c["head"]))
        head = change_head() if side == "change" else None  # untimed: the split's pass
        ms[side]["split"].append(card_ms(torch, lambda: c["split"](head)))
        ms[side]["pair"].append(card_ms(torch, c["pair"]))
    p_head, (p_cold, p_hot) = parent_head(), parent_split()
    c_head = change_head()
    c_cold, c_hot = change_split(c_head)
    err = max(C.max_abs_diff(p_head, c_head[0]), C.max_abs_diff(p_cold, c_cold),
              C.max_abs_diff(p_hot, c_hot))
    if err or int(c_head[0][0]) != SPILL_LIVE:
        raise RuntimeError(f"K10: the libraries differ by {err}; live {int(c_head[0][0])}")
    for leg in ("head", "split", "pair"):
        print(f"  K10 {leg} (2^{SPILL_LOG2}, {SPILL_LIVE} live, n_cold {n_cold}): "
              + "; ".join(f"{side} median {np.median(ms[side][leg]):.4f} ms "
                          f"[{min(ms[side][leg]):.4f}, {max(ms[side][leg]):.4f}]"
                          for side in libs), flush=True)
    print("  K10: head words and both lists equal", flush=True)
    return ms


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, help="root of the checkout to compare with")
    ap.add_argument("--kind", choices=("waves", "spill", "both"), default="both")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default=str(HERE / "chiprun_out" / "kernel_ab.json"))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("CUDA is not available: this script runs on a card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    sys.path.insert(0, str(HERE))
    from tigerbeetle_tpu_torch import kernels as K

    C = _smoke()
    libs = {"parent": parent_library(K, str(Path(args.parent).resolve())), "change": K.library()}
    result = {"card": card}
    if args.kind in ("waves", "both"):
        result["waves"] = waves_ab(torch, C, K, libs, args.reps)
    if args.kind in ("spill", "both"):
        result["spill"] = spill_ab(torch, C, K, libs, args.reps)
    K._lib = libs["change"]
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result))
    summary = {"card": card}
    for kind, r in result.get("waves", {}).items():
        summary[f"K12 {kind} W{r['waves']}"] = {s: float(np.median(r[s])) for s in libs}
    for leg in ("head", "split", "pair"):
        if "spill" in result:
            summary[f"K10 {leg}"] = {s: float(np.median(result["spill"][s][leg])) for s in libs}
    print(card)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
