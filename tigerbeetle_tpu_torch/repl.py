"""Interactive client REPL (reference: src/tigerbeetle/repl.zig).

Statement grammar (the reference's):

  create_accounts  id=1 code=10 ledger=700, id=2 code=10 ledger=700;
  create_transfers id=1 debit_account_id=1 credit_account_id=2 amount=10
                   ledger=700 code=10 flags=linked|pending;
  lookup_accounts  id=1, id=2;
  lookup_transfers id=1;

Objects are comma-separated; a statement ends with `;`. Flag names join
with `|`. Drives the native session Client over the TCP message bus.

The port's copy of `tigerbeetle_tpu/repl.py`, the same code over the port's
`vsr/client.py` and TCP bus.
"""

from __future__ import annotations

import dataclasses
import random
import time

from tigerbeetle_tpu_torch import types
from tigerbeetle_tpu_torch.io.message_bus import TCPMessageBus
from tigerbeetle_tpu_torch.state_machine import decode_results, encode_ids
from tigerbeetle_tpu_torch.types import (
    Account,
    AccountFlags,
    CreateAccountResult,
    CreateTransferResult,
    Operation,
    Transfer,
    TransferFlags,
)
from tigerbeetle_tpu_torch.vsr.client import Client, WallTicker

_ACCOUNT_FIELDS = {f.name for f in dataclasses.fields(Account)}
_TRANSFER_FIELDS = {f.name for f in dataclasses.fields(Transfer)}


def _parse_flags(value: str, enum) -> int:
    out = 0
    for name in value.split("|"):
        out |= int(enum[name.strip()])
    return out


def parse_statement(text: str):
    """-> (Operation, events) where events is list[Account|Transfer|int]."""
    text = text.strip().rstrip(";").strip()
    if not text:
        return None, []
    op_name, _, rest = text.partition(" ")
    op = Operation[op_name]
    events = []
    for obj in rest.split(","):
        obj = obj.strip()
        if not obj:
            continue
        kv = {}
        for pair in obj.split():
            key, _, value = pair.partition("=")
            kv[key] = value
        if op == Operation.create_accounts:
            flags = kv.pop("flags", None)
            a = Account(**{k: int(v, 0) for k, v in kv.items()
                           if k in _ACCOUNT_FIELDS})
            if flags:
                a.flags = _parse_flags(flags, AccountFlags)
            events.append(a)
        elif op == Operation.create_transfers:
            flags = kv.pop("flags", None)
            t = Transfer(**{k: int(v, 0) for k, v in kv.items()
                            if k in _TRANSFER_FIELDS})
            if flags:
                t.flags = _parse_flags(flags, TransferFlags)
            events.append(t)
        else:
            events.append(int(kv["id"], 0))
    return op, events


class Repl:
    def __init__(self, addresses, cluster_id: int = 0,
                 client_id: int | None = None):
        self.addresses = addresses
        self.client_id = client_id or random.getrandbits(120) | (1 << 120)
        self.bus = TCPMessageBus(addresses, self.client_id, listen=False)
        # 20ms ticks -> first retry at ~600ms, re-targeted round-robin
        # across the cluster on the runtime's own ladder (an eviction or
        # deadline surfaces as the typed error from take_reply)
        self.client = Client(self.client_id, self.bus, len(addresses),
                             cluster_id, request_timeout_ticks=30,
                             max_backoff_exponent=2)
        self.ticker = WallTicker(self.client, tick_s=0.02)

    # -- request/response over the bus --

    def _await_reply(self, timeout: float = 10.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            self.bus.pump(timeout=0.02)
            self.ticker.advance(time.monotonic())
            if self.client.done:
                return self.client.take_reply()
        raise TimeoutError("no reply from cluster")

    def connect(self) -> None:
        self.client.register()
        self._await_reply()
        assert self.client.session != 0

    def execute(self, op: Operation, events) -> str:
        if op == Operation.create_accounts:
            body = types.accounts_to_np(events).tobytes()
        elif op == Operation.create_transfers:
            body = types.transfers_to_np(events).tobytes()
        else:
            body = encode_ids(events)
        self.client.request(op, body)
        _header, reply = self._await_reply()
        return self._render(op, events, reply)

    @staticmethod
    def _render(op: Operation, events, reply: bytes) -> str:
        import numpy as np

        if op in (Operation.create_accounts, Operation.create_transfers):
            sparse = decode_results(reply, op)
            if not sparse:
                return "ok"
            enum = (
                CreateAccountResult
                if op == Operation.create_accounts
                else CreateTransferResult
            )
            return "\n".join(f"[{i}] {enum(c).name}" for i, c in sparse)
        dtype = (
            types.ACCOUNT_DTYPE
            if op == Operation.lookup_accounts
            else types.TRANSFER_DTYPE
        )
        rows = np.frombuffer(reply, dtype=dtype)
        cls = types.Account if op == Operation.lookup_accounts else types.Transfer
        if not len(rows):
            return "(not found)"
        return "\n".join(str(cls.from_np(rows[i])) for i in range(len(rows)))

    # -- the loop --

    def run(self, stream, echo: bool = False) -> int:
        self.connect()
        print(f"connected (session {self.client.session}); "
              "statements end with ';', ctrl-d exits", flush=True)
        buf = ""
        for line in stream:
            if echo:
                print(f"> {line.rstrip()}")
            buf += line
            while ";" in buf:
                stmt, _, buf = buf.partition(";")
                try:
                    op, events = parse_statement(stmt + ";")
                    if op is None:
                        continue
                    print(self.execute(op, events), flush=True)
                except Exception as e:  # noqa: BLE001 — REPL reports, not dies
                    print(f"error: {e}", flush=True)
        return 0
