"""Python binding over the native C-ABI client (native/tb_client.cc).

The pattern the reference uses for all language bindings — one native
client library, typed wrappers per language (reference: src/clients/go,
java, dotnet, node over src/clients/c/tb_client.zig). This is the Python
instance: ctypes over tb_client.h, exposing typed Account/Transfer calls.

The port's copy of `tigerbeetle_tpu/client_ffi.py`, over the port's build of
the same library (`native.py`, which compiles `native/tb_client.cc` too).
"""

from __future__ import annotations

import ctypes
import os

from tigerbeetle_tpu_torch import native, types
from tigerbeetle_tpu_torch.state_machine import decode_results, encode_ids
from tigerbeetle_tpu_torch.types import Operation

MESSAGE_BODY_MAX = (1 << 20) - 128


class _TBClientHandle(ctypes.Structure):
    pass


def _lib():
    l = native.lib()  # builds/loads libtb_native.so (shared with checksum/io)
    if not hasattr(l, "_tb_client_bound"):
        l.tb_client_init.argtypes = [
            ctypes.POINTER(ctypes.POINTER(_TBClientHandle)),
            ctypes.c_char_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_char_p,
        ]
        l.tb_client_init.restype = ctypes.c_int
        l.tb_client_request.argtypes = [
            ctypes.POINTER(_TBClientHandle), ctypes.c_uint8, ctypes.c_char_p,
            ctypes.c_uint64, ctypes.c_char_p, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint64),
        ]
        l.tb_client_request.restype = ctypes.c_int
        l.tb_client_deinit.argtypes = [ctypes.POINTER(_TBClientHandle)]
        l.tb_client_deinit.restype = None
        l._tb_client_bound = True
    return l


class _TBPacket(ctypes.Structure):
    pass


_TBPacket._fields_ = [
    ("next", ctypes.POINTER(_TBPacket)),
    ("user_data", ctypes.c_void_p),
    ("operation", ctypes.c_uint8),
    ("status", ctypes.c_int32),
    ("data_size", ctypes.c_uint32),
    ("data", ctypes.c_void_p),
]

_COMPLETION_T = ctypes.CFUNCTYPE(
    None, ctypes.c_void_p, ctypes.POINTER(_TBPacket),
    ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint64,
)


class _TBAsyncHandle(ctypes.Structure):
    pass


def _bind_async(l):
    if not hasattr(l, "_tb_async_bound"):
        l.tb_client_async_init.argtypes = [
            ctypes.POINTER(ctypes.POINTER(_TBAsyncHandle)),
            ctypes.c_char_p, ctypes.c_uint32, ctypes.c_char_p,
            ctypes.c_uint32, _COMPLETION_T, ctypes.c_void_p,
        ]
        l.tb_client_async_init.restype = ctypes.c_int
        l.tb_client_async_submit.argtypes = [
            ctypes.POINTER(_TBAsyncHandle), ctypes.POINTER(_TBPacket)
        ]
        l.tb_client_async_submit.restype = ctypes.c_int
        l.tb_client_async_deinit.argtypes = [ctypes.POINTER(_TBAsyncHandle)]
        l.tb_client_async_deinit.restype = None
        l._tb_async_bound = True
    return l


class AsyncNativeClient:
    """The async packet interface (reference: src/clients/c/tb_client/
    packet.zig completion model): submit() enqueues a request body and
    returns immediately; a pool of native session threads drives N requests
    in flight; each packet's reply bytes land in its Future.

    One process, many in-flight batches — the durable benchmark drives the
    full BASELINE protocol through this from a single client process."""

    def __init__(self, addresses: str, cluster: int = 0, sessions: int = 8,
                 client_id_base: bytes | None = None):
        from concurrent.futures import Future

        self._lib = _bind_async(_lib())
        self._handle = ctypes.POINTER(_TBAsyncHandle)()
        self._pending: dict[int, tuple] = {}  # packet addr -> (Future, keep)
        self._futures = Future  # for submit()

        def _on_complete(_ctx, pkt_ptr, reply_ptr, reply_len):
            pkt = pkt_ptr.contents
            key = ctypes.addressof(pkt)
            fut, _keep = self._pending.pop(key)
            if pkt.status != 0:
                fut.set_exception(
                    OSError(-pkt.status, os.strerror(-pkt.status))
                )
            else:
                fut.set_result(
                    ctypes.string_at(reply_ptr, reply_len) if reply_len else b""
                )

        self._cb = _COMPLETION_T(_on_complete)  # keep the thunk alive
        # sessions perturb byte 0 of the base id by +i: leave headroom
        cid = client_id_base or (b"\x01" + os.urandom(14) + b"\x01")
        rc = self._lib.tb_client_async_init(
            ctypes.byref(self._handle), addresses.encode(), cluster, cid,
            sessions, self._cb, None,
        )
        if rc != 0:
            raise OSError(-rc, os.strerror(-rc), addresses)

    def submit(self, operation: Operation, body: bytes):
        """Enqueue one request; returns a Future resolving to the reply
        body bytes (raises OSError on packet failure)."""
        fut = self._futures()
        pkt = _TBPacket()
        buf = ctypes.create_string_buffer(body, len(body))
        pkt.user_data = None
        pkt.operation = int(operation)
        pkt.data_size = len(body)
        pkt.data = ctypes.cast(buf, ctypes.c_void_p)
        # keep packet + body alive until completion (C owns no memory)
        self._pending[ctypes.addressof(pkt)] = (fut, (pkt, buf))
        rc = self._lib.tb_client_async_submit(self._handle, ctypes.byref(pkt))
        if rc != 0:
            self._pending.pop(ctypes.addressof(pkt))
            raise OSError(-rc, os.strerror(-rc), operation.name)
        return fut

    def close(self) -> None:
        if self._handle:
            self._lib.tb_client_async_deinit(self._handle)  # drains first
            self._handle = ctypes.POINTER(_TBAsyncHandle)()


class NativeClient:
    """A registered session against a running cluster, via the native lib."""

    def __init__(self, host: str, port: int = 0, cluster: int = 0,
                 client_id: bytes | None = None):
        """host: one "host" (with port arg) or a full address list
        "host:port[,host:port...]" — the client rotates across replicas."""
        self._lib = _lib()
        self._handle = ctypes.POINTER(_TBClientHandle)()
        cid = client_id or os.urandom(15) + b"\x01"  # nonzero u128
        addresses = host if ":" in host else f"{host}:{port}"
        rc = self._lib.tb_client_init(
            ctypes.byref(self._handle), addresses.encode(), 0, cluster, cid
        )
        if rc != 0:
            raise OSError(-rc, os.strerror(-rc), addresses)
        # reply buffer reused across requests (single in-flight by design)
        self._reply_buf = ctypes.create_string_buffer(MESSAGE_BODY_MAX)

    def _request(self, operation: Operation, body: bytes) -> bytes:
        out = self._reply_buf
        out_len = ctypes.c_uint64(0)
        rc = self._lib.tb_client_request(
            self._handle, int(operation), body, len(body), out,
            MESSAGE_BODY_MAX, ctypes.byref(out_len),
        )
        if rc != 0:
            raise OSError(-rc, os.strerror(-rc), operation.name)
        return out.raw[: out_len.value]

    # -- typed API (the binding surface) --

    def create_accounts(self, accounts: list[types.Account]):
        reply = self._request(
            Operation.create_accounts, types.accounts_to_np(accounts).tobytes()
        )
        return decode_results(reply, Operation.create_accounts)

    def create_transfers(self, transfers: list[types.Transfer]):
        reply = self._request(
            Operation.create_transfers,
            types.transfers_to_np(transfers).tobytes(),
        )
        return decode_results(reply, Operation.create_transfers)

    def lookup_accounts(self, ids: list[int]) -> list[types.Account]:
        import numpy as np

        reply = self._request(Operation.lookup_accounts, encode_ids(ids))
        rows = np.frombuffer(reply, dtype=types.ACCOUNT_DTYPE)
        return [types.Account.from_np(rows[i]) for i in range(len(rows))]

    def lookup_transfers(self, ids: list[int]) -> list[types.Transfer]:
        import numpy as np

        reply = self._request(Operation.lookup_transfers, encode_ids(ids))
        rows = np.frombuffer(reply, dtype=types.TRANSFER_DTYPE)
        return [types.Transfer.from_np(rows[i]) for i in range(len(rows))]

    def close(self) -> None:
        if self._handle:
            self._lib.tb_client_deinit(self._handle)
            self._handle = ctypes.POINTER(_TBClientHandle)()
