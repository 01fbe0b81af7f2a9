"""The port's recording tracer (`tigerbeetle_tpu_torch/tracer.py`) against
the JAX package's: the same spans give the same events and the same dump
bytes (the ring's overwrite included), the stitched flows are the same,
and the port's simulator dumps the JAX simulator's trace byte for byte.
Exact: everything compared is bytes or integers."""

import hashlib
import json

import pytest

from tigerbeetle_tpu import tracer as J
from tigerbeetle_tpu.testing.simulator import Simulator as JSimulator
from tigerbeetle_tpu_torch import tracer as P
from tigerbeetle_tpu_torch.testing.simulator import Simulator


def _drive(mod, capacity, pid=0):
    """The same span calls on a tracer of `mod`, on a tick clock: nested
    spans, trace ids single and listed, annotations, a span left open."""
    clock = [0]
    tr = mod.SimTracer(clock=lambda: clock[0], capacity=capacity, pid=pid)
    for i in range(12):
        clock[0] += 1
        with tr.span("commit", op=i, trace=(i % 5) + 1):
            clock[0] += 2
            tok = tr.start("journal.write", slot=i % 3)
            tr.annotate(tok, traces=[(i % 5) + 1, (i % 7) + 1, 0], bytes=128 * i)
            clock[0] += 1
            tr.stop(tok)
    tr.start("left.open", trace=3)
    tr.annotate(999, ignored=True)  # a stopped or unknown token: no effect
    return tr


@pytest.mark.parametrize("capacity", [4, 16, 1000])
def test_sim_tracer_events_and_dump_equal_jax(tmp_path, capacity):
    j, p = _drive(J, capacity), _drive(P, capacity)
    assert p.events_ordered() == j.events_ordered()
    j.dump(str(tmp_path / "j.json"))
    p.dump(str(tmp_path / "p.json"))
    assert (tmp_path / "p.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    if capacity == 4:  # the ring kept the newest four complete spans
        kept = p.events_ordered()[:4]
        assert [e["name"] for e in kept] == ["journal.write", "commit"] * 2
        assert [e["args"]["op"] for e in kept if e["name"] == "commit"] == [10, 11]


def test_json_tracer_wall_clock_feeds_span_histograms():
    from tigerbeetle_tpu_torch.metrics import Metrics

    m = Metrics()
    tr = P.JsonTracer(capacity=8, metrics=m)
    with tr.span("work"):
        pass
    assert tr.events[0]["name"] == "work" and tr.events[0]["ph"] == "X"
    assert m.histogram("span.work").count == 1


def test_flow_events_stitch_and_dump_equal_jax(tmp_path):
    lists_j = [_drive(J, 64, pid=0).events_ordered(), _drive(J, 7, pid=0).events_ordered()]
    lists_p = [_drive(P, 64, pid=0).events_ordered(), _drive(P, 7, pid=0).events_ordered()]
    assert P.flow_events(lists_p[0]) == J.flow_events(lists_j[0])
    labels = ["replica 0", "replica 1"]
    assert P.stitch(lists_p, labels) == J.stitch(lists_j, labels)
    assert P.stitch(lists_p) == J.stitch(lists_j)  # default labels
    nj = J.dump_stitched(str(tmp_path / "j.json"), lists_j, labels)
    np_ = P.dump_stitched(str(tmp_path / "p.json"), lists_p, labels)
    assert nj == np_
    assert (tmp_path / "p.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    flows = [e for e in P.stitch(lists_p) if e["ph"] in ("s", "t", "f")]
    assert flows and all(e["cat"] == "op" for e in flows)


def test_null_tracer_takes_annotate_and_dump(tmp_path):
    P.NULL_TRACER.annotate(P.NULL_TRACER.start("x"), a=1)
    P.NULL_TRACER.dump(str(tmp_path / "none.json"))
    assert not (tmp_path / "none.json").exists()
    assert P.NULL_TRACER.span("x") is P._NULL_SPAN


def _histories_digest(sim) -> str:
    out = [sorted((op, rec[0]) for op, rec in h.items()) for h in sim.histories]
    return hashlib.sha256(repr(out).encode()).hexdigest()


def test_sim_stitched_trace_equals_jax_and_is_pure(tmp_path):
    """Simulator(4242, ticks=300) with the oracle backend: the port's
    stitched dump is the JAX simulator's byte for byte, and the traced
    run's history equals an untraced run's."""
    pj, pp = str(tmp_path / "j.json"), str(tmp_path / "p.json")
    sj = JSimulator(4242, ticks=300, trace_path=pj)
    rj = sj.run()
    sp = Simulator(4242, ticks=300, trace_path=pp)
    rp = sp.run()
    assert rp == rj
    raw = open(pp, "rb").read()
    assert raw == open(pj, "rb").read()
    events = json.loads(raw)["traceEvents"]
    assert len({e["pid"] for e in events if e["ph"] in ("X", "B")}) >= 2
    assert any(e["ph"] == "s" for e in events)
    plain = Simulator(4242, ticks=300)
    assert plain.run() == rp
    assert _histories_digest(plain) == _histories_digest(sp)


def test_sim_stitched_trace_multi_pid(tmp_path):
    path = str(tmp_path / "sim.json")
    Simulator(31337, ticks=300, trace_path=path).run()
    events = json.load(open(path))["traceEvents"]
    assert len({e["pid"] for e in events if e["ph"] in ("X", "B")}) >= 2
    starts = {e["id"] for e in events if e["ph"] == "s"}
    ends = {e["id"] for e in events if e["ph"] == "f"}
    assert starts and starts == ends
