"""The multiplexed ingress-session driver against a live port server: the
port's copy of `run_ingress_sessions` of `tigerbeetle_tpu/benchmark.py`
(with its `_MuxSession` and body helpers), spawning `python -m
tigerbeetle_tpu_torch start --backend native --ingress`. The tests run it
as the JAX package's tests run its own; it reports the structural contract
(sessions sustained, sheds typed and counted, conservation over the wire),
not a figure of this port's speed.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

from tigerbeetle_tpu_torch.testing.process import REPO_ROOT, free_port, kill_group
from tigerbeetle_tpu_torch.types import ACCOUNT_DTYPE, TRANSFER_DTYPE, Operation

BATCH = 8190  # (1 MiB - 128 B) / 128 B


def _accounts_body(start_id: int, count: int) -> bytes:
    arr = np.zeros(count, dtype=ACCOUNT_DTYPE)
    arr["id_lo"] = np.arange(start_id, start_id + count, dtype=np.uint64)
    arr["ledger"] = 1
    arr["code"] = 1
    return arr.tobytes()


def _transfers_body(rng, start_id: int, count: int, n_accounts: int,
                    flags: int = 0) -> bytes:
    arr = np.zeros(count, dtype=TRANSFER_DTYPE)
    # id_order=reversed (reference: src/benchmark.zig:66-73 default)
    arr["id_lo"] = np.arange(
        start_id + count - 1, start_id - 1, -1, dtype=np.uint64
    )
    dr = rng.integers(1, n_accounts + 1, size=count, dtype=np.uint64)
    off = rng.integers(1, n_accounts, size=count, dtype=np.uint64)
    arr["debit_account_id_lo"] = dr
    arr["credit_account_id_lo"] = (dr - 1 + off) % n_accounts + 1
    arr["amount_lo"] = 1
    arr["ledger"] = 1
    arr["code"] = 1
    arr["flags"] = flags
    return arr.tobytes()


class _MuxSession:
    """One logical session multiplexed over a shared (demux) bus
    connection, driven by the client RUNTIME: busy sheds back off on the
    decorrelated ladder, losses retransmit on the timeout ladder — the
    driver only advances the ticker and harvests replies."""

    __slots__ = ("client", "ticker", "sent_at", "events")

    def __init__(self, client_id: int, bus):
        from tigerbeetle_tpu_torch.vsr.client import Client, WallTicker

        # 5ms ticks: busy retries land at 10-320ms (decorrelated), the
        # loss ladder starts at 200ms (40 ticks) and caps at 4x
        self.client = Client(
            client_id, bus, replica_count=1,
            request_timeout_ticks=40, max_backoff_exponent=2,
            ping_ticks=0,  # 10k idle sessions must not ping-storm
        )
        self.ticker = WallTicker(self.client, tick_s=0.005)
        self.sent_at = 0.0
        self.events = 0  # events this session has in flight

    def poll(self, now: float) -> bool:
        """Drive one in-flight request: True once its reply landed.
        Retry cadence lives in the Client's runtime config now
        (request_timeout_ticks), not here."""
        c = self.client
        if c.done:
            return True
        if c.in_flight is None:
            return False
        self.ticker.advance(now)
        return c.done


def run_ingress_sessions(
    n_sessions: int = 10_000,
    conns: int = 16,
    n_accounts: int = 512,
    baseline_sessions: int = 10,
    driver_batches: int = 30,
    batch: int = 512,
    bg_window: int = 32,
    sat_window: int = 256,
    sat_batches: int = 120,
    reg_window: int = 512,
    reply_slots: int = 64,
    device: str = "cpu",
    tmpdir: str | None = None,
    log=None,
) -> dict:
    """The ingress_sessions bench segment: `n_sessions` LOGICAL sessions
    multiplexed over `conns` TCP connections against one gateway-fronted
    replica (native backend — ingress is a host-path measurement; `device`
    is the server's --device, which the native backend does not use).

    Phases:
    A. baseline: `baseline_sessions` sessions drive `driver_batches`
       batches each; per-batch latency p99 is the 10-session reference.
    B. live: ALL `n_sessions` sessions register (the connect storm —
       every register is a consensus op through admission), then the
       same driver workload runs while a rotating background window
       keeps distant sessions active. p99 here vs A is the acceptance
       ratio (<= 2x with 10k live sessions).
    C. saturation: `sat_window` sessions keep full batches in flight
       concurrently — far past the pipeline cap, so the regulator sheds
       (typed busy replies, client backoff-retry). Event throughput here
       vs B shows shedding protects the pipeline instead of collapsing
       it.

    Conservation is verified over the wire at the end (every acked
    transfer moved amount=1)."""
    import json as _json
    from collections import deque

    from tigerbeetle_tpu_torch.io.message_bus import TCPMessageBus
    from tigerbeetle_tpu_torch.types import Operation

    log = log or (lambda *_: None)
    own_tmp = tmpdir is None
    if own_tmp:
        tmp = tempfile.TemporaryDirectory(prefix="tb_ingress_")
        tmpdir = tmp.name
    path = os.path.join(tmpdir, "ingress.tigerbeetle")
    port = free_port()
    clients_max = n_sessions + 64
    slots_log2 = 14
    total_est = (
        (baseline_sessions + bg_window) * driver_batches * batch * 4
        + sat_batches * batch + n_sessions
    )
    while total_est > (1 << slots_log2) // 2:
        slots_log2 += 1

    env = dict(os.environ, PYTHONPATH=str(REPO_ROOT), TB_PARENT_WATCHDOG="1")
    session_args = (
        "--clients-max", str(clients_max),
        "--client-reply-slots", str(reply_slots),
    )
    fmt = subprocess.run(
        [sys.executable, "-m", "tigerbeetle_tpu_torch", "format",
         "--cluster", "0", "--replica", "0", "--replica-count", "1",
         *session_args, path],
        cwd=REPO_ROOT, env=env, capture_output=True, text=True, timeout=120,
    )
    assert fmt.returncode == 0, fmt.stderr
    proc = subprocess.Popen(
        [sys.executable, "-m", "tigerbeetle_tpu_torch", "start",
         "--addresses", f"127.0.0.1:{port}",
         "--account-slots-log2", str(max(14, (n_accounts * 2 + 2).bit_length())),
         "--transfer-slots-log2", str(slots_log2),
         "--backend", "native", "--device", device, "--ingress", *session_args, path],
        cwd=REPO_ROOT, env=env, start_new_session=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    buses: list[TCPMessageBus] = []
    try:
        while True:
            line = proc.stdout.readline()
            if "listening" in line:
                break
            if not line:
                raise RuntimeError("ingress server died before listening")
            log(line.rstrip())
        log(f"server up on :{port} ({n_sessions} sessions over {conns} conns)")
        server_stats: dict = {}

        def _drain_stdout():
            for out in proc.stdout:
                line = out.rstrip()
                if line.startswith("[stats] "):
                    try:
                        server_stats.update(_json.loads(line[8:]))
                    except ValueError:
                        pass
                log("[server]", line)

        drain_thread = threading.Thread(target=_drain_stdout, daemon=True)
        drain_thread.start()

        # demux buses: one TCP connection each, N sessions' Clients per
        # bus dispatching by the reply frame's client id
        buses = [
            TCPMessageBus(
                [("127.0.0.1", port)], 0xC0DE0000 + b, demux=True
            )
            for b in range(conns)
        ]

        def pump_all() -> None:
            for b in buses:
                b.pump(timeout=0.0)

        rng = np.random.default_rng(7)
        next_id = [1_000_000]

        def transfer_body(count: int) -> bytes:
            body = _transfers_body(rng, next_id[0], count, n_accounts)
            next_id[0] += count
            return body

        def register_all(sessions, deadline_s: float) -> float:
            """Bounded-window registration storm; returns wall seconds."""
            t0 = time.monotonic()
            pending = deque(sessions)
            active: list[_MuxSession] = []
            while pending or active:
                now = time.monotonic()
                if now - t0 > deadline_s:
                    raise TimeoutError(
                        f"registration stalled: {len(pending)} pending "
                        f"{len(active)} active"
                    )
                while pending and len(active) < reg_window:
                    s = pending.popleft()
                    s.client.register()
                    s.sent_at = now
                    active.append(s)
                pump_all()
                still = []
                for s in active:
                    if s.poll(now):
                        s.client.take_reply()
                        assert s.client.session != 0
                    else:
                        still.append(s)
                active = still
            return time.monotonic() - t0

        def run_phase(drivers, bodies, deadline_s: float,
                      background=None, lat_ms=None) -> tuple[int, float]:
            """Each driver keeps one body from the shared deque in
            flight (busy -> backoff resend). `background` (sessions,
            window): a rotating window of single-transfer requests over
            the whole live set. Returns (events acked, wall seconds)."""
            t0 = time.monotonic()
            events = 0

            def take_ok_reply(s, prefix):
                _h, body = s.client.take_reply()
                if body != b"":
                    from tigerbeetle_tpu_torch.state_machine import decode_results

                    raise AssertionError(
                        f"{prefix}: "
                        f"{decode_results(body, Operation.create_transfers)[:4]} "
                        f"(reply client={_h.client:#x} req={_h.request} "
                        f"operation={_h.operation} op={_h.op} "
                        f"events={s.events})"
                    )

            inflight: dict[int, _MuxSession] = {}
            bg_inflight: list[_MuxSession] = []
            bg_iter = None
            if background is not None:
                bg_sessions, bg_cap = background

                def bg_cycle():
                    while True:
                        yield from bg_sessions

                bg_iter = bg_cycle()
            idle = [s for s in drivers]
            while bodies or inflight or bg_inflight:
                now = time.monotonic()
                if now - t0 > deadline_s:
                    raise TimeoutError(
                        f"ingress phase stalled: {len(bodies)} bodies "
                        f"{len(inflight)} inflight"
                    )
                while bodies and idle:
                    s = idle.pop()
                    body = bodies.popleft()
                    s.events = len(body) // 128
                    s.client.request(Operation.create_transfers, body)
                    s.sent_at = now
                    inflight[s.client.client_id] = s
                if bg_iter is not None and bodies:
                    scanned = 0  # bounded: never spin hunting an idle session
                    while len(bg_inflight) < bg_cap and scanned < 4 * bg_cap:
                        s = next(bg_iter)
                        scanned += 1
                        if (
                            s.client.in_flight is not None
                            or s.client.session == 0
                        ):
                            continue
                        s.events = 1
                        s.client.request(
                            Operation.create_transfers, transfer_body(1)
                        )
                        s.sent_at = now
                        bg_inflight.append(s)
                pump_all()
                for cid in list(inflight):
                    s = inflight[cid]
                    if s.poll(now):
                        take_ok_reply(s, "transfer failed")
                        events += s.events
                        if lat_ms is not None:
                            lat_ms.append((time.monotonic() - s.sent_at) * 1e3)
                        del inflight[cid]
                        idle.append(s)
                still_bg = []
                for s in bg_inflight:
                    if s.poll(now):
                        take_ok_reply(s, "bg transfer failed")
                        events += s.events
                    else:
                        still_bg.append(s)
                bg_inflight = still_bg
            return events, time.monotonic() - t0

        # -- build sessions: drivers first, then the long tail --
        all_sessions = [
            _MuxSession(0xB0000000 + i, buses[i % conns])
            for i in range(n_sessions)
        ]
        drivers = all_sessions[:baseline_sessions]

        # -- phase A: 10-session baseline --
        reg_s0 = register_all(drivers, deadline_s=120.0)
        s0 = drivers[0]
        next_acct = 1
        while next_acct <= n_accounts:
            k = min(BATCH, n_accounts - next_acct + 1)
            s0.client.request(
                Operation.create_accounts, _accounts_body(next_acct, k)
            )
            s0.sent_at = time.monotonic()
            t_acct = time.monotonic()
            while not s0.poll(time.monotonic()):
                pump_all()
                if time.monotonic() - t_acct > 120:
                    raise TimeoutError("account create stalled")
            _h, body = s0.client.take_reply()
            assert body == b"", "account create failed"
            next_acct += k
        warm = deque(transfer_body(batch) for _ in range(4))
        run_phase(drivers, warm, deadline_s=300.0)  # warm engine caches
        lat_a: list[float] = []
        bodies = deque(
            transfer_body(batch)
            for _ in range(baseline_sessions * driver_batches)
        )
        ev_a, wall_a = run_phase(
            drivers, bodies, deadline_s=600.0, lat_ms=lat_a
        )
        p99_a = float(np.percentile(lat_a, 99))
        log(f"baseline: {ev_a} events in {wall_a:.2f}s p99={p99_a:.2f}ms")

        # -- phase B: the full session population goes live --
        reg_s = register_all(
            all_sessions[baseline_sessions:],
            deadline_s=max(300.0, n_sessions / 20),
        )
        log(f"{n_sessions} sessions registered in {reg_s0 + reg_s:.1f}s")
        lat_b: list[float] = []
        bodies = deque(
            transfer_body(batch)
            for _ in range(baseline_sessions * driver_batches)
        )
        ev_b, wall_b = run_phase(
            drivers, bodies, deadline_s=600.0,
            background=(all_sessions[baseline_sessions:], bg_window),
            lat_ms=lat_b,
        )
        p99_b = float(np.percentile(lat_b, 99))
        tps_b = ev_b / wall_b if wall_b else 0.0
        log(f"live: {ev_b} events in {wall_b:.2f}s p99={p99_b:.2f}ms")

        # -- phase C: deliberate saturation (shed expected) --
        busy_before = sum(s.client.busy_replies for s in all_sessions)
        sat = all_sessions[:sat_window]
        bodies = deque(transfer_body(batch) for _ in range(sat_batches))
        ev_c, wall_c = run_phase(sat, bodies, deadline_s=600.0)
        tps_c = ev_c / wall_c if wall_c else 0.0
        busy_replies = (
            sum(s.client.busy_replies for s in all_sessions) - busy_before
        )
        log(f"saturated: {ev_c} events in {wall_c:.2f}s "
            f"busy_replies={busy_replies}")

        # -- conservation over the wire --
        from tigerbeetle_tpu_torch.state_machine import decode_accounts, encode_ids

        total = ev_a + ev_b + ev_c + batch * 4  # + warmup
        s0 = drivers[0]
        dpo = cpo = found = 0
        for i in range(0, n_accounts, 8000):
            ids = list(range(1 + i, 1 + min(i + 8000, n_accounts)))
            s0.client.request(Operation.lookup_accounts, encode_ids(ids))
            s0.sent_at = time.monotonic()
            t0 = time.monotonic()
            while not s0.poll(time.monotonic()):
                pump_all()
                if time.monotonic() - t0 > 120:
                    raise TimeoutError("conservation lookup stalled")
            _h, body = s0.client.take_reply()
            arr = decode_accounts(body)
            found += len(arr)
            dpo += int(arr["debits_posted_lo"].sum())
            cpo += int(arr["credits_posted_lo"].sum())
        assert found == n_accounts, (found, n_accounts)
        assert dpo == cpo == total, (dpo, cpo, total)
        log(f"conservation verified: {total} transfers")

        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            pass
        drain_thread.join(timeout=5)
        out = {
            "sessions": n_sessions,
            "conns": conns,
            "register_s": round(reg_s0 + reg_s, 2),
            "baseline_sessions": baseline_sessions,
            "p99_baseline_ms": round(p99_a, 2),
            "p99_live_ms": round(p99_b, 2),
            "p99_ratio": round(p99_b / p99_a, 3) if p99_a else None,
            "tps_live": round(tps_b, 1),
            "tps_saturated": round(tps_c, 1),
            "tps_saturated_ratio": (
                round(tps_c / tps_b, 3) if tps_b else None
            ),
            "busy_replies": busy_replies,
            "n_transfers": total,
        }
        m = server_stats.get("metrics", {})
        if m:
            c = m.get("counters", {})
            out["ingress_shed"] = c.get("ingress.shed", 0)
            out["ingress_admitted"] = c.get("ingress.admitted", 0)
            out["ingress_retransmits"] = c.get("ingress.retransmits", 0)
            out["ingress_sessions_gauge"] = m.get("gauges", {}).get(
                "ingress.sessions"
            )
        return out
    finally:
        for b in buses:
            try:
                b.sel.close()
            except Exception:
                pass
        if proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        kill_group(proc)
        if own_tmp:
            tmp.cleanup()
