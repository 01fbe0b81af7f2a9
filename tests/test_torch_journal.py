"""The port's journal against the JAX package's, bit for bit: the three
rows of the recovery decision matrix (`tests/test_journal_matrix.py`:
a misdirected write, a wrap-stale prepare, a torn header row) give the
same classification and the same WAL bytes in both packages, and so does a
run of writes that wraps the ring, torn and recovered."""

import importlib
import types as pytypes

import numpy as np
import pytest

PACKAGES = ("tigerbeetle_tpu", "tigerbeetle_tpu_torch")


def _pkg(name: str):
    ns = pytypes.SimpleNamespace()
    for m in ("constants", "types", "io.storage", "vsr.header", "vsr.journal"):
        setattr(ns, m.split(".")[-1], importlib.import_module(f"{name}.{m}"))
    return ns


@pytest.fixture(scope="module")
def both():
    return [_pkg(p) for p in PACKAGES]


def _prepare(p, op: int, parent: int = 0, n: int = 1):
    body = p.types.accounts_to_np(
        [p.types.Account(id=1000 + op * 16 + i, ledger=1, code=1) for i in range(n)]
    ).tobytes()
    h = p.header.Header(
        command=int(p.header.Command.prepare),
        operation=int(p.types.Operation.create_accounts),
        op=op, parent=parent, timestamp=1 << 30 | op,
    )
    h.set_checksum_body(body)
    h.set_checksum()
    return h, body


def _journal(p):
    layout = p.storage.ZoneLayout(p.constants.TEST_CLUSTER, grid_size=8 * 1024 * 1024)
    storage = p.storage.MemoryStorage(layout, seed=11)
    return storage, p.journal.Journal(storage, p.constants.TEST_CLUSTER)


def _misdirected(p):
    storage, j = _journal(p)
    for op in range(1, 6):
        j.write_prepare(*_prepare(p, op))
    msg_max = p.constants.TEST_CLUSTER.message_size_max
    Z = p.storage.Zone
    raw3 = storage.read(Z.wal_prepares, j.slot_for_op(3) * msg_max, msg_max)
    storage.write(Z.wal_prepares, j.slot_for_op(4) * msg_max, raw3)
    return storage


def _wrap_stale(p):
    storage, j = _journal(p)
    slots = p.constants.TEST_CLUSTER.journal_slot_count
    msg_max = p.constants.TEST_CLUSTER.message_size_max
    Z = p.storage.Zone
    j.write_prepare(*_prepare(p, 7))
    old_raw = storage.read(Z.wal_prepares, j.slot_for_op(7) * msg_max, msg_max)
    j.write_prepare(*_prepare(p, 7 + slots))
    storage.write(Z.wal_prepares, j.slot_for_op(7) * msg_max, old_raw)
    return storage


def _torn_header(p):
    storage, j = _journal(p)
    j.write_prepare(*_prepare(p, 2))
    storage.fault(p.storage.Zone.wal_headers, j.slot_for_op(2) * 128, 64)
    return storage


def _wrap_run(p):
    """Writes over two and a half passes of the ring, with chained parents
    and bodies of varied size, a torn sector and a crash of the last
    write."""
    storage, j = _journal(p)
    slots = p.constants.TEST_CLUSTER.journal_slot_count
    parent = 0
    for op in range(1, 2 * slots + slots // 2 + 1):
        h, body = _prepare(p, op, parent, n=1 + op % 5)
        j.write_prepare(h, body)
        parent = h.checksum
    storage.fault(p.storage.Zone.wal_prepares,
                  j.slot_for_op(2 * slots + 3) * p.constants.TEST_CLUSTER.message_size_max + 64, 16)
    h, body = _prepare(p, 2 * slots + slots // 2 + 1, parent, n=3)
    j.write_prepare(h, body)
    storage.crash()
    return storage


SCENARIOS = {"misdirected": _misdirected, "wrap_stale": _wrap_stale,
             "torn_header": _torn_header, "wrap_run": _wrap_run}


def _recover(p, storage):
    j = p.journal.Journal(storage, p.constants.TEST_CLUSTER)
    out = j.recover()
    headers = {op: h.to_bytes() for op, h in sorted(out.items())}
    prepares = {op: (lambda r: None if r is None else (r[0].to_bytes(), r[1]))(j.read_prepare(op))
                for op in sorted(out)}
    return {
        "stats": dict(j.recover_stats),
        "faulty": {int(k): int(v) for k, v in (j.faulty.items() if isinstance(j.faulty, dict)
                                               else enumerate(j.faulty)) if v},
        "headers": headers, "prepares": prepares,
        "mirror": [None if (h := j.get_header(op)) is None else h.to_bytes()
                   for op in range(1, 3 * p.constants.TEST_CLUSTER.journal_slot_count)],
    }


def _wal_bytes(p, storage):
    Z = p.storage.Zone
    return (storage.read(Z.wal_headers, 0, storage.layout.sizes[Z.wal_headers]),
            storage.read(Z.wal_prepares, 0, storage.layout.sizes[Z.wal_prepares]))


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_journal_recovery_and_wal_bytes(both, name):
    j, t = both
    sj, st = SCENARIOS[name](j), SCENARIOS[name](t)
    assert _wal_bytes(j, sj) == _wal_bytes(t, st)
    rj, rt = _recover(j, sj), _recover(t, st)
    assert rj == rt
    # the matrix's own expectations hold in the port
    slots = t.constants.TEST_CLUSTER.journal_slot_count
    if name == "misdirected":
        assert rt["stats"]["misdirected"] == 1 and 4 not in rt["headers"] and 3 in rt["headers"]
    elif name == "wrap_stale":
        assert rt["stats"]["wrap_stale"] == 1
        assert 7 not in rt["headers"] and 7 + slots not in rt["headers"]
    elif name == "torn_header":
        assert 2 in rt["headers"] and rt["stats"]["torn_header"] >= 1
    else:
        assert len(rt["headers"]) > slots // 2


def test_each_package_recovers_the_others_wal(both):
    """A WAL written by one package recovers alike in the other."""
    j, t = both
    sj, st = _wrap_run(j), _wrap_run(t)
    # swap the WAL zones across packages, then recover each
    hj, pj = _wal_bytes(j, sj)
    ht, pt = _wal_bytes(t, st)
    Zj, Zt = j.storage.Zone, t.storage.Zone
    sj.write(Zj.wal_headers, 0, ht)
    sj.write(Zj.wal_prepares, 0, pt)
    st.write(Zt.wal_headers, 0, hj)
    st.write(Zt.wal_prepares, 0, pj)
    assert _recover(j, sj) == _recover(t, st)
    assert np.frombuffer(hj, np.uint8).any()
