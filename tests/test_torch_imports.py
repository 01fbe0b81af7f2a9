"""The PyTorch port stands alone: neither tigerbeetle_tpu_torch nor
chip_smoke.py nor the A/B and split scripts beside it imports jax or
anything of tigerbeetle_tpu, and its ledgers default to the card."""

import ast
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "tigerbeetle_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "group_ab.py", REPO / "serial_ab.py",
    REPO / "group_gather_split.py", REPO / "cluster_split.py", REPO / "scan_install_split.py"]


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_import(path):
    for mod in _imported_modules(path):
        root = mod.split(".")[0]
        assert root not in ("jax", "jaxlib", "tigerbeetle_tpu"), f"{path.name} imports {mod}"


def test_import_loads_no_jax():
    code = (
        "import sys\n"
        "import tigerbeetle_tpu_torch, tigerbeetle_tpu_torch.state_machine\n"
        "import tigerbeetle_tpu_torch.models.ledger, tigerbeetle_tpu_torch.convert\n"
        "import tigerbeetle_tpu_torch.kernels.build, tigerbeetle_tpu_torch.native\n"
        "import tigerbeetle_tpu_torch.models.dual_ledger\n"
        "import tigerbeetle_tpu_torch.models.native_ledger\n"
        "import tigerbeetle_tpu_torch.metrics, tigerbeetle_tpu_torch.tracer\n"
        "import tigerbeetle_tpu_torch.latency, tigerbeetle_tpu_torch.testing.hash_log\n"
        "import tigerbeetle_tpu_torch.federation.commitment\n"
        "import tigerbeetle_tpu_torch.models.spill, tigerbeetle_tpu_torch.stdx\n"
        "import tigerbeetle_tpu_torch.io.storage, tigerbeetle_tpu_torch.vsr.free_set\n"
        "import tigerbeetle_tpu_torch.lsm.cache, tigerbeetle_tpu_torch.lsm.grid\n"
        "import tigerbeetle_tpu_torch.lsm.tree, tigerbeetle_tpu_torch.lsm.manifest_log\n"
        "import tigerbeetle_tpu_torch.lsm.groove, tigerbeetle_tpu_torch.parallel.mesh\n"
        "import tigerbeetle_tpu_torch.io.time, tigerbeetle_tpu_torch.io.network\n"
        "import tigerbeetle_tpu_torch.vsr.header, tigerbeetle_tpu_torch.vsr.superblock\n"
        "import tigerbeetle_tpu_torch.vsr.journal, tigerbeetle_tpu_torch.vsr.clock\n"
        "import tigerbeetle_tpu_torch.vsr.client_replies, tigerbeetle_tpu_torch.vsr.client\n"
        "import tigerbeetle_tpu_torch.vsr.durable, tigerbeetle_tpu_torch.constants\n"
        "import tigerbeetle_tpu_torch.testing.cluster_cases\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'tigerbeetle_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("module", ["tigerbeetle_tpu_torch.vsr.replica",
                                    "tigerbeetle_tpu_torch.testing.cluster",
                                    "tigerbeetle_tpu_torch.tracer",
                                    "tigerbeetle_tpu_torch.testing.hash_log",
                                    "tigerbeetle_tpu_torch.models.oracle",
                                    "tigerbeetle_tpu_torch.testing.workload",
                                    "tigerbeetle_tpu_torch.testing.packet_simulator",
                                    "tigerbeetle_tpu_torch.testing.state_checker",
                                    "tigerbeetle_tpu_torch.testing.simulator",
                                    "tigerbeetle_tpu_torch.testing.sim_cases",
                                    "tigerbeetle_tpu_torch.testing.fuzz",
                                    "tigerbeetle_tpu_torch.testing.vopr"])
def test_replica_and_cluster_load_no_jax(module):
    code = (
        f"import sys, {module}\n"
        "roots = ('jax', 'jaxlib', 'tigerbeetle_tpu')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in roots]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_cluster_and_durable_ledger_default_to_cuda():
    """A replica built with no device or backend builds its ledger on the
    card: without CUDA the cluster and the durable ledger raise, with no
    fallback to the CPU."""
    import torch

    from tigerbeetle_tpu_torch.constants import TEST_CLUSTER, TEST_PROCESS
    from tigerbeetle_tpu_torch.io.storage import MemoryStorage, ZoneLayout
    from tigerbeetle_tpu_torch.testing.cluster import Cluster
    from tigerbeetle_tpu_torch.vsr.durable import DurableLedger, format_data_file

    storage = MemoryStorage(ZoneLayout(TEST_CLUSTER, grid_size=8 * 1024 * 1024))
    format_data_file(storage, TEST_CLUSTER)
    if torch.cuda.is_available():
        assert Cluster(replica_count=1).replicas[0].ledger.device.type == "cuda"
        assert DurableLedger(storage, TEST_CLUSTER, TEST_PROCESS).ledger.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Cluster(replica_count=1)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            DurableLedger(storage, TEST_CLUSTER, TEST_PROCESS)
    assert Cluster(replica_count=1, device="cpu").replicas[0].ledger.device.type == "cpu"


def test_simulator_and_vopr_runner_default_to_cuda():
    """The simulator's device slice (backend_factory=None) and the VOPR
    runner build their ledgers on the card: without CUDA the simulator
    raises and the runner refuses to start, with no fallback to the CPU;
    the oracle backend touches no device."""
    import torch

    from tigerbeetle_tpu_torch.testing import vopr
    from tigerbeetle_tpu_torch.testing.simulator import Simulator

    assert vopr.parse_args([]).device == "cuda"
    if torch.cuda.is_available():
        sim = Simulator(1, ticks=5, backend_factory=None, replica_count=1, n_clients=1)
        assert sim.replicas[0].ledger.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Simulator(1, ticks=5, backend_factory=None, replica_count=1, n_clients=1)
        out = subprocess.run(
            [sys.executable, "-m", "tigerbeetle_tpu_torch.testing.vopr", "--seeds", "1"],
            cwd=REPO, capture_output=True, text=True, timeout=120)
        assert out.returncode == 2 and "CUDA is not available" in out.stderr
        assert "seed" not in out.stdout
    sim = Simulator(1, ticks=5, backend_factory=None, replica_count=1, n_clients=1, device="cpu")
    assert sim.replicas[0].ledger.device.type == "cpu"
    assert not hasattr(Simulator(1, ticks=5).replicas[0].ledger, "device")


def test_device_ledger_defaults_to_cuda():
    import torch

    from tigerbeetle_tpu_torch.constants import TEST_PROCESS
    from tigerbeetle_tpu_torch.models.ledger import DeviceLedger

    if torch.cuda.is_available():
        assert DeviceLedger(TEST_PROCESS).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            DeviceLedger(TEST_PROCESS)


def test_spilling_ledger_defaults_to_cuda():
    import torch

    from tigerbeetle_tpu_torch.constants import TEST_CLUSTER, TEST_PROCESS
    from tigerbeetle_tpu_torch.io.storage import MemoryStorage, ZoneLayout
    from tigerbeetle_tpu_torch.lsm.grid import Grid
    from tigerbeetle_tpu_torch.lsm.groove import Forest
    from tigerbeetle_tpu_torch.models.ledger import DeviceLedger

    storage = MemoryStorage(ZoneLayout(TEST_CLUSTER, grid_size=16 * 1024 * 1024))
    forest = Forest(Grid(storage, offset=0, block_count=64, cache_blocks=16))
    if torch.cuda.is_available():
        assert DeviceLedger(TEST_PROCESS, forest=forest).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            DeviceLedger(TEST_PROCESS, forest=forest)


def test_sharded_ledger_defaults_to_cuda():
    import torch

    from tigerbeetle_tpu_torch.constants import ConfigProcess
    from tigerbeetle_tpu_torch.parallel.mesh import ShardedLedger

    small = ConfigProcess(account_slots_log2=4, transfer_slots_log2=6)
    if torch.cuda.is_available():
        assert ShardedLedger(2, small).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ShardedLedger(2, small)


def test_native_checksum_of_empty_body():
    """The port's own build of native/aegis.cc gives the reference's pinned
    checksum of an empty body (src/vsr.zig:238)."""
    import shutil

    if shutil.which("g++") is None:
        pytest.skip("g++ is missing: the native library is built with it at first use")
    from tigerbeetle_tpu_torch import native

    assert native.checksum(b"") == native.CHECKSUM_BODY_EMPTY
    assert native.library_path().parent.parent == REPO / "build" / "tb_native"


def test_dual_ledger_defaults_to_cuda():
    import torch

    from tigerbeetle_tpu_torch.models.dual_ledger import DualLedger

    if torch.cuda.is_available():
        led = DualLedger(12, 14, follower=True)
        assert led.device.device.type == "cuda"
        assert led.finalize()["verified"] is True
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            DualLedger(12, 14, follower=True)


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Alone in a directory, chip_smoke.py exits non-zero and prints no result."""
    import shutil

    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
