"""Shared by the port's simulator tests: run one seed through the JAX
`Simulator` and the port's, and compare everything a run leaves."""

import hashlib

from tigerbeetle_tpu.constants import ConfigProcess as JConfigProcess
from tigerbeetle_tpu.testing import simulator as JS
from tigerbeetle_tpu.testing.packet_simulator import PacketSimulatorOptions as JOptions
from tigerbeetle_tpu_torch.constants import ConfigProcess
from tigerbeetle_tpu_torch.testing import cluster_cases
from tigerbeetle_tpu_torch.testing import simulator as PS
from tigerbeetle_tpu_torch.testing.packet_simulator import PacketSimulatorOptions


def case_kwargs(make_kwargs):
    """(JAX kwargs, port kwargs) of a `sim_cases` kwargs function."""
    return make_kwargs(JOptions, JConfigProcess), make_kwargs(PacketSimulatorOptions, ConfigProcess)


def _storage(sim, masked: bool):
    if masked:  # device checkpoints: the dump rows masked
        return [cluster_cases.storage_record(s, sim.process_config) for s in sim.storages]
    return [hashlib.sha256(s.data).hexdigest() for s in sim.storages]


def run_both(seed: int, jax_kw: dict, port_kw: dict, masked: bool = False) -> dict:
    """Both simulators on one seed: equal run() dicts, every replica's
    history, commit_min, view and status, and every storage (whole, or
    with the device checkpoints' dump rows masked). Returns the stats."""
    js = JS.Simulator(seed, **jax_kw)
    jr = js.run()
    ps = PS.Simulator(seed, **port_kw)
    pr = ps.run()
    assert pr == jr
    assert ps.histories == js.histories
    assert [(r.commit_min, r.view, r.status, r.op) for r in ps.replicas] == \
        [(r.commit_min, r.view, r.status, r.op) for r in js.replicas]
    assert _storage(ps, masked) == _storage(js, masked)
    return pr
