"""The port's VSR wire and storage pieces against the JAX package's, bit for
bit on the same seeded inputs: headers of every command, the superblock's
write and read sequence, the client-reply zone, the cluster clock's
synchronised window and the in-process network's delivery order."""

import dataclasses
import importlib
import types as pytypes

import numpy as np
import pytest

PACKAGES = ("tigerbeetle_tpu", "tigerbeetle_tpu_torch")
MODULES = ("constants", "io.storage", "io.time", "io.network", "vsr.header",
           "vsr.superblock", "vsr.client_replies", "vsr.clock", "vsr.durable")


def _pkg(name: str):
    ns = pytypes.SimpleNamespace()
    for m in MODULES:
        setattr(ns, m.split(".")[-1], importlib.import_module(f"{name}.{m}"))
    return ns


@pytest.fixture(scope="module")
def both():
    return [_pkg(p) for p in PACKAGES]


def _storage(p, grid_size=8 * 1024 * 1024):
    layout = p.storage.ZoneLayout(p.constants.TEST_CLUSTER, grid_size=grid_size)
    return p.storage.MemoryStorage(layout)


def _random_header(p, rng, command: int):
    big = lambda: int(rng.integers(0, 1 << 63)) << 65 | int(rng.integers(0, 1 << 63))  # noqa: E731
    return p.header.Header(
        parent=big(), client=big(), context=big(),
        request=int(rng.integers(0, 1 << 32)), cluster=int(rng.integers(0, 1 << 32)),
        epoch=int(rng.integers(0, 1 << 32)), view=int(rng.integers(0, 1 << 32)),
        op=int(rng.integers(0, 1 << 63)), commit=int(rng.integers(0, 1 << 63)),
        timestamp=int(rng.integers(0, 1 << 63)), replica=int(rng.integers(0, 256)),
        command=command, operation=int(rng.integers(0, 256)),
    )


def test_command_values_equal(both):
    j, t = both
    assert {c.name: int(c) for c in j.header.Command} == {c.name: int(c) for c in t.header.Command}
    assert j.header.HEADER_DTYPE == t.header.HEADER_DTYPE


def test_header_bytes_and_checksums_every_command(both):
    j, t = both
    for command in j.header.Command:
        rng_j, rng_t = (np.random.default_rng(int(command)) for _ in range(2))
        hj, ht = _random_header(j, rng_j, int(command)), _random_header(t, rng_t, int(command))
        body = np.random.default_rng(100 + int(command)).bytes(int(command) * 37)
        for h in (hj, ht):
            h.set_checksum_body(body)
            h.set_checksum()
        assert hj.to_bytes() == ht.to_bytes(), command.name
        assert ht.valid_checksum() and ht.valid_checksum_body(body)
        # each package reads the other's bytes back to the same fields
        assert dataclasses.asdict(t.header.Header.from_bytes(hj.to_bytes())) == \
            dataclasses.asdict(hj)
        assert dataclasses.asdict(j.header.Header.from_bytes(ht.to_bytes())) == \
            dataclasses.asdict(ht)
        assert hj.trace() == ht.trace()


def _superblock_sequence(p, storage):
    """Format, then three checkpoints with blobs and meta, a view persist,
    and a torn copy; returns every state opened along the way."""
    cluster = p.constants.TEST_CLUSTER
    p.durable.format_data_file(storage, cluster, cluster_id=7, replica=2)
    opened = []
    sb = p.superblock.SuperBlock(storage)
    opened.append(dataclasses.asdict(sb.open()))
    for seq in range(3):
        st = sb.state
        blobs = [p.superblock.BlobRef(f"blob{i}", 4096 * (i + seq), 100 + i, 12345 + i * seq)
                 for i in range(3)]
        sb.checkpoint(dataclasses.replace(
            st, sequence=st.sequence + 1, commit_min=10 * (seq + 1),
            commit_min_checksum=(seq + 1) << 100, commit_max=10 * (seq + 1) + 3,
            prepare_timestamp=(seq + 1) * 10**9, area=1 - st.area, blobs=blobs,
            meta=dict(st.meta, counters={"commit_ts": seq}, note=f"seq {seq}"),
        ))
        opened.append(dataclasses.asdict(p.superblock.SuperBlock(storage).open()))
    p.durable.persist_view(sb, view=5, log_view=4)
    opened.append(dataclasses.asdict(p.superblock.SuperBlock(storage).open()))
    # tear one copy: the quorum still opens the same state
    storage.fault(p.storage.Zone.superblock, 0, 64)
    opened.append(dataclasses.asdict(p.superblock.SuperBlock(storage).open()))
    return opened


def test_superblock_sequence_bytes(both):
    (j, t), stores = both, [_storage(p) for p in both]
    outs = [_superblock_sequence(p, s) for p, s in zip(both, stores)]
    assert outs[0] == outs[1]
    zj, zt = j.storage.Zone.superblock, t.storage.Zone.superblock
    size = stores[0].layout.sizes[zj]
    assert stores[0].read(zj, 0, size) == stores[1].read(zt, 0, size)
    # each package opens the other's superblock (every copy decoded alike)
    for p, other, z in ((j, stores[1], zt), (t, stores[0], zj)):
        for c in range(p.storage.ZoneLayout.SUPERBLOCK_COPIES):
            raw = other.read(z, c * p.storage.ZoneLayout.SUPERBLOCK_COPY_SIZE,
                             p.storage.ZoneLayout.SUPERBLOCK_COPY_SIZE)
            st, verdict = p.superblock.SuperBlock.decode_copy(raw)
            assert verdict == ("bad magic" if c == 0 else "valid")
            if st is not None:
                assert dataclasses.asdict(st) == outs[0][-1]


def test_config_fingerprint_equal(both):
    j, t = both
    for kw in ({}, {"journal_slot_count": 64, "lsm_batch_multiple": 4},
               {"clients_max": 7, "client_reply_slots": 3}):
        assert j.constants.ConfigCluster(**kw).fingerprint() == \
            t.constants.ConfigCluster(**kw).fingerprint()
    assert dataclasses.asdict(j.constants.ConfigProcess()) == \
        dataclasses.asdict(t.constants.ConfigProcess())


def _reply_run(p, storage, n=40):
    cr = p.client_replies.ClientReplies(storage, p.constants.TEST_CLUSTER)
    rng = np.random.default_rng(5)
    written = {}
    for i in range(n):
        slot = int(rng.integers(0, cr.slot_count))
        body = rng.bytes(int(rng.integers(0, 4096)) // 8 * 8)
        h = p.header.Header(command=int(p.header.Command.reply), client=1000 + slot,
                            request=i, op=i + 1, timestamp=10**12 + i,
                            operation=int(rng.integers(128, 132)))
        h.set_checksum_body(body)
        h.set_checksum()
        cr.write(slot, h.to_bytes() + body)
        written[slot] = (h.checksum, h.to_bytes() + body)
    # a torn slot reads as absent
    torn = next(iter(written))
    storage.fault(p.storage.Zone.client_replies, torn * cr.slot_size + 200, 8)
    reads = [(s, cr.read(s, c)) for s, (c, _w) in sorted(written.items())]
    assert dict(reads)[torn] is None or len(written[torn][1]) <= 200
    assert all(r == written[s][1] for s, r in reads if s != torn)
    return reads


def test_client_reply_zone_bytes(both):
    (j, t), stores = both, [_storage(p) for p in both]
    reads = [_reply_run(p, s) for p, s in zip(both, stores)]
    assert reads[0] == reads[1]
    zj, zt = j.storage.Zone.client_replies, t.storage.Zone.client_replies
    size = stores[0].layout.sizes[zj]
    assert stores[0].read(zj, 0, size) == stores[1].read(zt, 0, size)


def _clock_run(p, seed):
    rng = np.random.default_rng(seed)
    time = p.time.DeterministicTime(offset_ns=int(rng.integers(-10**6, 10**6)))
    clock = p.clock.Clock(0, 5, time, sample_age_max_ns=400_000_000)
    out = []
    for step in range(120):
        time.tick()
        peer = int(rng.integers(1, 5))
        m0 = time.monotonic() - int(rng.integers(0, 5_000_000))
        m2 = time.monotonic() + int(rng.integers(-1000, 5_000_000))
        t1 = time.realtime() + int(rng.integers(-20_000_000, 20_000_000))
        clock.learn(peer, m0, t1, m2)
        out.append((clock.realtime(), clock.realtime_synchronized(),
                    dataclasses.astuple(clock._window()) if clock._window() else None))
    intervals = [tuple(sorted(rng.integers(-100, 100, size=2).tolist())) for _ in range(9)]
    out.append([(q, dataclasses.astuple(w) if (w := p.clock.marzullo(intervals, q)) else None)
                for q in range(1, 10)])
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_clock_synchronised_window(both, seed):
    j, t = both
    a, b = _clock_run(j, seed), _clock_run(t, seed)
    assert a == b
    assert any(x[1] is not None for x in a[:-1]) and any(x[1] is None for x in a[:-1])


def _network_run(p, seed):
    rng = np.random.default_rng(seed)
    net = p.network.InProcessNetwork()
    log = []
    for addr in range(5):
        def handler(src, data, addr=addr):
            log.append((src, addr, data))
            if data[0] % 3 == 0 and len(log) < 400:  # some deliveries answer
                net.send(addr, src, bytes([(data[0] + 1) % 256]) + data[1:4])
        net.attach(addr, handler)
    net.filters.append(lambda src, dst, data: not (src == 1 and dst == 3))
    net.filters.append(lambda src, dst, data: data[0] % 7 != 5)
    link = p.network.LinkControl(net)
    link.hold(src=2, dst=0)
    for _ in range(200):
        src, dst = (int(x) for x in rng.integers(0, 6, size=2))  # 5: no handler
        net.send(src, dst, rng.bytes(int(rng.integers(1, 16))))
    n = net.run()
    released = link.release(duplicate=2)
    n2 = net.run()
    return log, n, released, n2, net.delivered, net.dropped


@pytest.mark.parametrize("seed", [3, 4])
def test_network_delivery_order(both, seed):
    j, t = both
    a, b = _network_run(j, seed), _network_run(t, seed)
    assert a == b
    assert a[2] > 0 and a[5] > 0
