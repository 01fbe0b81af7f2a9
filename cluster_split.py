"""Phase split of the one-cluster fast transfer commits on one card.

K3 (`csrc/commit_transfers.cu`) and K11tf (`csrc/mesh_commit_transfers.cu`)
each run validate, the claim rounds, the fold, the gate and the apply in
one launch, with a cluster barrier between phases. This script compiles a
copy of each source in which block 0's first thread stamps `%globaltimer`
and `clock64()` after each barrier (plus a closing barrier), into
`build/cluster_split/` of this checkout, and times each phase on 20
requests of 8190 benchmark transfers (after 5 untimed):

- K3 on DeviceLedger(ConfigProcess()), 10,000 accounts;
- K11tf on ShardedLedger(S, ConfigProcess()) for S = 8 (19 GiB of tables)
  and S = 1 (the same per-shard tables, an eighth of the span), so a phase
  that the tables' span slows shows it.

    python3 cluster_split.py

Needs one card and nvcc. Prints the card, one line per kernel (medians in
us) and, last, a JSON summary.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
OUT = HERE / "build" / "cluster_split"
PHASES = ("validate", "claims", "fold", "gate", "apply")
STAMP = r'''
__device__ unsigned long long g_split_clk[8], g_split_gt[8];
__device__ __forceinline__ void split_stamp(int k) {
  unsigned long long g;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g));
  g_split_gt[k] = g;
  g_split_clk[k] = clock64();
}
extern "C" int tb_split_read(unsigned long long* clk, unsigned long long* gt) {
  cudaMemcpyFromSymbol(clk, g_split_clk, sizeof(g_split_clk));
  cudaMemcpyFromSymbol(gt, g_split_gt, sizeof(g_split_gt));
  return (int)cudaGetLastError();
}
'''
# stamp k after the barrier that ends phase k - 1 (0: the zeroed headers)
MARKS = (
    ("  cluster.sync();\n\n  // (a) validate", "  cluster.sync();\n  if (t == 0) split_stamp(0);\n\n  // (a) validate"),
    ("atomicOr(want, 1u);\n  cluster.sync();", "atomicOr(want, 1u);\n  cluster.sync();\n  if (t == 0) split_stamp(1);"),
    ("  // settle and release", "  if (t == 0) split_stamp(2);\n  // settle and release"),
    ("if (warp_lead && bad) atomicOr(&hdr_own.bad, bad);\n  cluster.sync();",
     "if (warp_lead && bad) atomicOr(&hdr_own.bad, bad);\n  cluster.sync();\n  if (t == 0) split_stamp(3);"),
    ("  cluster.sync();\n\n  // (e) apply", "  cluster.sync();\n  if (t == 0) split_stamp(4);\n\n  // (e) apply"),
)


def instrumented(src: str, nvcc: str) -> ctypes.CDLL:
    """Compile a stamped copy of csrc/`src` alone into a shared library."""
    csrc = HERE / "tigerbeetle_tpu_torch" / "csrc"
    s = (csrc / src).read_text()
    s = s.replace("namespace cg = cooperative_groups;",
                  "namespace cg = cooperative_groups;\n" + STAMP, 1)
    for a, b in MARKS:
        if s.count(a) != 1:
            raise RuntimeError(f"{src}: the phase mark {a!r} is not found once")
        s = s.replace(a, b)
    kernel_end = s.rindex("\n}\n", 0, s.index("static void ", s.index("__global__")))
    s = s[:kernel_end] + "\n  cluster.sync();\n  if (t == 0) split_stamp(5);" + s[kernel_end:]
    OUT.mkdir(parents=True, exist_ok=True)
    path = OUT / src
    path.write_text(s)
    so = path.with_suffix(".so")
    r = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                        "-Xcompiler", "-fPIC", "-shared", "-I", str(csrc), "-o", str(so),
                        str(path)], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed for the stamped {src}:\n{r.stdout}{r.stderr}")
    return ctypes.CDLL(str(so))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("CUDA is not available: this script runs on a card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    from tigerbeetle_tpu_torch import constants, types
    from tigerbeetle_tpu_torch import kernels as K
    from tigerbeetle_tpu_torch import state_machine as SM
    from tigerbeetle_tpu_torch.kernels import build
    from tigerbeetle_tpu_torch.models import ledger as L
    from tigerbeetle_tpu_torch.parallel import mesh as M

    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    C = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(C)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    nvcc = build.find_nvcc()
    B = 8190
    rng = np.random.default_rng(C.SEED + 20)
    next_id = [10_000_000_000]

    def batch():
        dr, cr = C.random_pairs(rng, B, C.N_ACCOUNTS)
        ids = np.arange(next_id[0], next_id[0] + B)
        next_id[0] += B
        return C.transfers(types, ids, dr, cr, rng.integers(1, 1000, B).astype(np.uint64))

    def with_accounts(ledger):
        sm = SM.StateMachine(ledger)
        acc = C.accounts(types, np.arange(1, C.N_ACCOUNTS + 1))
        for chunk in (acc[:B], acc[B:]):
            sm.prepare(types.Operation.create_accounts, chunk.tobytes())
            if sm.commit(types.Operation.create_accounts, sm.prepare_timestamp + 10**12,
                         chunk.tobytes()):
                raise RuntimeError("an account request failed")
        return ledger.state

    def split(lib, launch, rows):
        """Median us of each phase (by clock64 at the SM clock the stamps
        give), the median total by globaltimer, and the SM clock in GHz."""
        clk, gt = [], []
        for r in rows:
            launch(r)
            torch.cuda.synchronize()
            c = (ctypes.c_ulonglong * 8)()
            g = (ctypes.c_ulonglong * 8)()
            if lib.tb_split_read(c, g) != 0:
                raise RuntimeError("reading the stamps failed")
            clk.append(list(c)[:6])
            gt.append(list(g)[:6])
        clk, gt = np.array(clk, dtype=np.float64), np.array(gt, dtype=np.float64)
        ghz = float(np.median((clk[:, 5] - clk[:, 0]) / (gt[:, 5] - gt[:, 0])))
        us = np.median(np.diff(clk, axis=1), axis=0) / ghz / 1e3
        return [float(x) for x in us], float(np.median(gt[:, 5] - gt[:, 0]) / 1e3), ghz

    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    k11 = instrumented("mesh_commit_transfers.cu", nvcc)
    k11.tb_mesh_commit_transfers_fast.argtypes = K._SIGNATURES["tb_mesh_commit_transfers_fast"]
    k11.tb_mesh_commit_transfers_fast_scratch.argtypes = [ctypes.c_int]
    k11.tb_mesh_commit_transfers_fast_scratch.restype = ctypes.c_size_t
    for S in (8, 1):
        st = with_accounts(M.ShardedLedger(S, constants.ConfigProcess(), device="cuda"))
        rows = [torch.from_numpy(M.batch_rows(batch())).cuda() for _ in range(25)]
        n_pad = rows[0].shape[0]
        scratch = torch.empty(k11.tb_mesh_commit_transfers_fast_scratch(n_pad),
                              dtype=torch.uint8, device="cuda")
        res = torch.empty(n_pad, dtype=torch.int32, device="cuda")

        def launch(r, st=st, S=S, scratch=scratch, res=res, n_pad=n_pad):
            err = k11.tb_mesh_commit_transfers_fast(
                st["acct_rows"].data_ptr(), 20, st["xfer_rows"].data_ptr(), 24, S,
                st["fulfill"].data_ptr(), st["xfer_claim"].data_ptr(), st["bal_acc"].data_ptr(),
                st["commit_ts"].data_ptr(), st["xfer_count"].data_ptr(),
                st["xfer_used_slots"].data_ptr(), st["fault"].data_ptr(), r.data_ptr(), n_pad, B,
                10**13, res.data_ptr(), scratch.data_ptr(), stream)
            if err != 0:
                raise RuntimeError(f"the stamped K11tf failed: CUDA error {err}")

        split(k11, launch, rows[:5])
        out[f"K11tf, {S} shard{'s' if S > 1 else ''}"] = split(k11, launch, rows[5:])
        if int(st["fault"]) != 0:
            raise RuntimeError(f"the stamped K11tf faulted: {int(st['fault'])}")
        del st, rows
        torch.cuda.empty_cache()

    k3 = instrumented("commit_transfers.cu", nvcc)
    k3.tb_commit_transfers_fast.argtypes = K._SIGNATURES["tb_commit_transfers_fast"]
    k3.tb_commit_transfers_fast_scratch.argtypes = [ctypes.c_int]
    k3.tb_commit_transfers_fast_scratch.restype = ctypes.c_size_t
    st = with_accounts(L.DeviceLedger(constants.ConfigProcess(), device="cuda"))
    rows = [L.transfers_to_batch(batch(), "cuda")["rows"] for _ in range(25)]
    scratch = torch.empty(k3.tb_commit_transfers_fast_scratch(B), dtype=torch.uint8, device="cuda")
    res = torch.empty(B, dtype=torch.int32, device="cuda")

    def launch3(r):
        err = k3.tb_commit_transfers_fast(
            st["acct_rows"].data_ptr(), 20, st["xfer_rows"].data_ptr(), 24,
            st["fulfill"].data_ptr(), st["xfer_claim"].data_ptr(), st["bal_acc"].data_ptr(),
            st["commit_ts"].data_ptr(), st["xfer_count"].data_ptr(),
            st["xfer_used_slots"].data_ptr(), st["fault"].data_ptr(), r.data_ptr(), None, B, B,
            10**13, 0, res.data_ptr(), scratch.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"the stamped K3 failed: CUDA error {err}")

    split(k3, launch3, rows[:5])
    out["K3"] = split(k3, launch3, rows[5:])
    if int(st["fault"]) != 0:
        raise RuntimeError(f"the stamped K3 faulted: {int(st['fault'])}")
    for name, (us, total, ghz) in out.items():
        print(f"{name}: {total:.2f} us by globaltimer (SM at {ghz:.3f} GHz); " +
              ", ".join(f"{p} {x:.2f}" for p, x in zip(PHASES, us)) + f" us [{card}]")
    print(json.dumps({name: {"total_us": total, "phases_us": dict(zip(PHASES, us)), "sm_ghz": ghz}
                      for name, (us, total, ghz) in out.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
