"""Phase split of the one-cluster fast transfer commits on one card.

K3 (`csrc/commit_transfers.cu`) and K11tf (`csrc/mesh_commit_transfers.cu`)
each run validate, the claim rounds (with their settle and release), the
fold, the gate and the apply in one launch, with a cluster barrier between
phases; K5 (`csrc/group_commit.cu`) runs K3's phases (`xfer_commit_slot`
of `csrc/xfer_commit.cuh`) once per slot in one launch. This script
compiles a copy of each source (and of the shared header) in which block
0's first thread stamps `%globaltimer` and `clock64()` after each barrier
(plus a closing barrier), into `build/cluster_split/` of this checkout, and
times each phase:

- K3 on DeviceLedger(ConfigProcess()), 10,000 accounts, on 20 requests of
  8190 benchmark transfers (after 5 untimed);
- K5 on the same ledger, on 6 groups of 16 such requests (after 3 untimed),
  each slot's phases, beside a copy that prefetches the next slot's rows
  into L2 while a slot folds and applies (the groups take turns);
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
import subprocess
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
CSRC = HERE / "tigerbeetle_tpu_torch" / "csrc"
OUT = HERE / "build" / "cluster_split"
PHASES = ("validate", "claims", "fold", "gate", "apply")
SPLIT_MAX = 128
STAMP = r'''
#define SPLIT_MAX 128
__device__ unsigned long long g_split_clk[SPLIT_MAX], g_split_gt[SPLIT_MAX];
__device__ int g_split_n;
// one thread stamps, in order: the stamp count runs on across a launch
__device__ __forceinline__ void split_stamp() {
  unsigned long long g;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g));
  int k = g_split_n;
  if (k < SPLIT_MAX) {
    g_split_gt[k] = g;
    g_split_clk[k] = clock64();
  }
  g_split_n = k + 1;
}
extern "C" int tb_split_read(unsigned long long* clk, unsigned long long* gt, int* n) {
  cudaMemcpyFromSymbol(n, g_split_n, sizeof(int));
  cudaMemcpyFromSymbol(clk, g_split_clk, sizeof(g_split_clk));
  cudaMemcpyFromSymbol(gt, g_split_gt, sizeof(g_split_gt));
  int zero = 0;
  cudaMemcpyToSymbol(g_split_n, &zero, sizeof(int));
  return (int)cudaGetLastError();
}
'''
STAMP_T0 = "if (t == 0) split_stamp();"
# a stamp after the barrier that ends each phase (the first: the zeroed
# headers); K11tf's kernel and the shared body of K3 and K5
MARKS = {
    "mesh_commit_transfers.cu": (
        ("  cluster.sync();\n\n  // (a) validate",
         "  cluster.sync();\n  " + STAMP_T0 + "\n\n  // (a) validate"),
        ("atomicOr(want, 1u);\n  cluster.sync();",
         "atomicOr(want, 1u);\n  cluster.sync();\n  " + STAMP_T0),
        ("  // (c) fold", "  " + STAMP_T0 + "\n  // (c) fold"),
        ("if (warp_lead && bad) atomicOr(&hdr_own.bad, bad);\n  cluster.sync();",
         "if (warp_lead && bad) atomicOr(&hdr_own.bad, bad);\n  cluster.sync();\n  " + STAMP_T0),
        ("  cluster.sync();\n\n  // (e) apply",
         "  cluster.sync();\n  " + STAMP_T0 + "\n\n  // (e) apply"),
    ),
    "xfer_commit.cuh": (
        ("  cluster.sync();\n\n  // (a) validate",
         "  cluster.sync();\n  " + STAMP_T0 + "\n\n  // (a) validate"),
        ("atomicOr(want, 1u);\n  cluster.sync();",
         "atomicOr(want, 1u);\n  cluster.sync();\n  " + STAMP_T0),
        ("  // (c) fold", "  " + STAMP_T0 + "\n  // (c) fold"),
        ("if (warp_lead && bad) atomicOr(&sh.hdr.bad, bad);\n  cluster.sync();",
         "if (warp_lead && bad) atomicOr(&sh.hdr.bad, bad);\n  cluster.sync();\n  " + STAMP_T0),
        ("  cluster.sync();\n\n  // (e) apply",
         "  cluster.sync();\n  " + STAMP_T0 + "\n\n  // (e) apply"),
    ),
}
# the closing stamp of the kernels over the shared body
CLOSE = "\n  cluster.sync();\n  if (cluster.thread_rank() == 0) split_stamp();\n"
# K5 with the next slot's batch rows prefetched into L2 while a slot folds
# and applies (a TMA bulk prefetch, 4 KiB a warp): a timing copy, the
# design K5 measured and left out
PREFETCH = (
    ("xfer_commit.cuh", "  int32_t* fails;",
     "  const uint32_t* next_rows;\n  int next_n;\n  int32_t* fails;"),
    ("xfer_commit.cuh", "  " + STAMP_T0 + "\n  // (c) fold",
     "  " + STAMP_T0 + "\n  if (b.next_rows != nullptr && warp_lead) {\n"
     "    const uint32_t total = (uint32_t)b.next_n * ROW_WORDS * 4u;\n"
     "    for (uint32_t off = (uint32_t)(t >> 5) * 4096u; off < total;\n"
     "         off += (uint32_t)(stride >> 5) * 4096u) {\n"
     "      asm volatile(\"cp.async.bulk.prefetch.L2.global [%0], %1;\" ::\"l\"(\n"
     "          reinterpret_cast<const char*>(b.next_rows) + off), \"r\"(min(4096u, total - off))\n"
     "          : \"memory\");\n    }\n  }\n  // (c) fold"),
    ("group_commit.cu", "      b.fails = g.summary + s;",
     "      b.fails = g.summary + s;\n      const bool more = s + 1 < GROUP_K_MAX && s + 1 < g.k;\n"
     "      b.next_rows = more ? b.batch + slot_words : nullptr;\n"
     "      b.next_n = more ? g.n[(s + 1) % GROUP_K_MAX] : 0;"),
)
# more copies of K5 to time beside it: (name, [(file, old, new), ...])
K5_EXTRA = [("K5 with the next slot's rows prefetched (timing copy)", PREFETCH)]


def _marked(text: str, name: str, marks) -> str:
    for a, b in marks:
        if text.count(a) != 1:
            raise RuntimeError(f"{name}: the phase mark {a!r} is not found once")
        text = text.replace(a, b)
    return text


def _compile(path: Path, nvcc: str) -> ctypes.CDLL:
    """Build; the compiler's resource report goes beside the library."""
    so = path.with_suffix(".so")
    r = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                        "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-shared", "-I", str(CSRC), "-o",
                        str(so), str(path)], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed for the stamped {path.name}:\n{r.stdout}{r.stderr}")
    so.with_suffix(".ptxas.log").write_text(r.stdout + r.stderr)
    return ctypes.CDLL(str(so))


def instrumented(src: str, nvcc: str, variant: str = "", extra=()) -> ctypes.CDLL:
    """Compile a stamped copy of csrc/`src` alone into a shared library; a
    source over the shared body gets a stamped copy of xfer_commit.cuh
    beside it (a quoted include finds it there first). `extra` holds more
    (file, old, new) replacements for a timing copy."""
    out = OUT / (variant or src.split(".")[0])
    out.mkdir(parents=True, exist_ok=True)
    s = (CSRC / src).read_text()
    if src == "mesh_commit_transfers.cu":
        s = s.replace("namespace cg = cooperative_groups;",
                      "namespace cg = cooperative_groups;\n" + STAMP, 1)
        s = _marked(s, src, MARKS[src])
        kernel_end = s.rindex("\n}\n", 0, s.index("static void ", s.index("__global__")))
        s = s[:kernel_end] + "\n  cluster.sync();\n  if (t == 0) split_stamp();" + s[kernel_end:]
    else:
        h = (CSRC / "xfer_commit.cuh").read_text()
        h = h.replace('#include "cluster.cuh"\n', '#include "cluster.cuh"\n' + STAMP, 1)
        h = _marked(h, "xfer_commit.cuh", MARKS["xfer_commit.cuh"])
        h = _marked(h, "xfer_commit.cuh", [(a, b) for f, a, b in extra if f == "xfer_commit.cuh"])
        (out / "xfer_commit.cuh").write_text(h)
        body_end = {"commit_transfers.cu": "xfer_commit_slot<false>(cluster, p.st, p.b, sh);\n",
                    "group_commit.cu": "    xfer_commit_slot<true>(cluster, g.st, slots[s], sh);"
                                       "\n  }\n"}[src]
        if s.count(body_end) != 1:
            raise RuntimeError(f"{src}: the kernel's end {body_end!r} is not found once")
        s = s.replace(body_end, body_end + CLOSE)
        s = _marked(s, src, [(a, b) for f, a, b in extra if f == src])
    path = out / src
    path.write_text(s)
    return _compile(path, nvcc)


def read_stamps(lib):
    """(clock64, globaltimer) arrays of the last launch's stamps."""
    c = (ctypes.c_ulonglong * SPLIT_MAX)()
    g = (ctypes.c_ulonglong * SPLIT_MAX)()
    n = ctypes.c_int(0)
    if lib.tb_split_read(c, g, ctypes.byref(n)) != 0:
        raise RuntimeError("reading the stamps failed")
    return (np.array(list(c)[:n.value], dtype=np.float64),
            np.array(list(g)[:n.value], dtype=np.float64))


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

    def split(lib, launch, rows, slots=1):
        """Median us of each phase (by clock64 at the SM clock the stamps
        give) over the launches and slots, the median total by globaltimer,
        the SM clock in GHz and each launch's phases ([launch][slot][phase],
        us)."""
        clk, gt = [], []
        for r in rows:
            launch(r)
            torch.cuda.synchronize()
            c, g = read_stamps(lib)
            if len(c) != 5 * slots + 1:
                raise RuntimeError(f"{len(c)} stamps, {5 * slots + 1} expected")
            clk.append(c)
            gt.append(g)
        clk, gt = np.array(clk), np.array(gt)
        ghz = float(np.median((clk[:, -1] - clk[:, 0]) / (gt[:, -1] - gt[:, 0])))
        per = np.diff(clk, axis=1).reshape(len(rows), slots, 5) / ghz / 1e3
        us = np.median(per.reshape(-1, 5), axis=0)
        return ([float(x) for x in us], float(np.median(gt[:, -1] - gt[:, 0]) / 1e3), ghz,
                per.tolist())

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
        out[f"K11tf, {S} shard{'s' if S > 1 else ''}"] = split(k11, launch, rows[5:])[:3]
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
    out["K3"] = split(k3, launch3, rows[5:])[:3]
    if int(st["fault"]) != 0:
        raise RuntimeError(f"the stamped K3 faulted: {int(st['fault'])}")
    del rows

    # K5 on the same ledger: groups of 16 fresh requests, with and without
    # the next slot's prefetch, taking turns
    k = C.GROUP_K
    k5 = {"K5": instrumented("group_commit.cu", nvcc, "k5"),
          **{name: instrumented("group_commit.cu", nvcc, f"k5_extra{i}", extra=patches)
             for i, (name, patches) in enumerate(K5_EXTRA)}}
    for lib in k5.values():
        lib.tb_group_commit.argtypes = K._SIGNATURES["tb_group_commit"]
    n_pad = 8192
    flat = torch.empty(k * n_pad + 1, dtype=torch.int32, device="cuda")
    summary = torch.empty(k + 1, dtype=torch.int32, device="cuda")
    scratch = torch.empty(k3.tb_commit_transfers_fast_scratch(n_pad), dtype=torch.uint8,
                          device="cuda")
    ns = np.full(k, B, dtype=np.int32)
    ts = [10**14]

    def launch5(lib):
        def run(g):
            tss = np.array([ts[0] + 10**5 * (i + 1) for i in range(k)], dtype=np.uint64)
            ts[0] += 10**7
            err = lib.tb_group_commit(
                st["acct_rows"].data_ptr(), 20, st["xfer_rows"].data_ptr(), 24,
                st["fulfill"].data_ptr(), st["xfer_claim"].data_ptr(), st["bal_acc"].data_ptr(),
                st["commit_ts"].data_ptr(), st["xfer_count"].data_ptr(),
                st["xfer_used_slots"].data_ptr(), st["fault"].data_ptr(), g.data_ptr(), k,
                n_pad, ns.ctypes.data, tss.ctypes.data, flat.data_ptr(), summary.data_ptr(),
                scratch.data_ptr(), stream)
            if err != 0:
                raise RuntimeError(f"the stamped K5 failed: CUDA error {err}")
        return run

    def group():
        return C.group_rows(torch, L, [batch() for _ in range(k)], k, "cuda")[0]

    for lib in k5.values():
        split(lib, launch5(lib), [group() for _ in range(3)], k)
    per = {name: [] for name in k5}
    for i in range(6):
        for name in (list(k5) if i % 2 == 0 else list(k5)[::-1]):
            got = split(k5[name], launch5(k5[name]), [group()], k)
            per[name].append(got)
    if int(st["fault"]) != 0 or int(summary[-1]) != 0:
        raise RuntimeError(f"the stamped K5 faulted: {int(st['fault'])}")
    slots_out = {}
    for name, runs in per.items():
        slot_us = np.array([r[3][0] for r in runs])  # [group][slot][phase]
        ghz = float(np.median([r[2] for r in runs]))
        total = float(np.median([r[1] for r in runs]))
        out[name] = ([float(x) for x in np.median(slot_us.reshape(-1, 5), axis=0)], total, ghz)
        slots_out[name] = {
            "slot0_us": [float(x) for x in np.median(slot_us[:, 0], axis=0)],
            "later_slots_us": [float(x) for x in np.median(slot_us[:, 1:].reshape(-1, 5),
                                                           axis=0)],
            "slot_total_us": [float(x) for x in np.median(slot_us.sum(axis=2), axis=0)],
        }
    for name, (us, total, ghz) in out.items():
        what = f" per slot of {k}" if name in k5 else ""
        print(f"{name}: {total:.2f} us by globaltimer (SM at {ghz:.3f} GHz); " +
              ", ".join(f"{p} {x:.2f}" for p, x in zip(PHASES, us)) + f" us{what} [{card}]")
    for name, sl in slots_out.items():
        print(f"{name}: slot 0 " + ", ".join(f"{p} {x:.2f}" for p, x in zip(PHASES, sl["slot0_us"]))
              + "; slots 1-15 " + ", ".join(f"{p} {x:.2f}" for p, x in
                                            zip(PHASES, sl["later_slots_us"])) + " us")
    summary_json = {name: {"total_us": total, "phases_us": dict(zip(PHASES, us)), "sm_ghz": ghz}
                    for name, (us, total, ghz) in out.items()}
    for name, sl in slots_out.items():
        summary_json[name].update(sl)
    print(json.dumps(summary_json))
    return 0


if __name__ == "__main__":
    sys.exit(main())
