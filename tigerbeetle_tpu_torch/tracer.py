"""Span tracer seam (the counterpart of `tigerbeetle_tpu/tracer.py`, cut to
the no-op backend the port's dual-commit follower and device ledger use).

`Tracer` is the `none` backend: span() returns a shared singleton context
manager, so hot paths stay instrumented at the cost of one call. A
recording backend (a subclass with its own span()) re-binds through
`DualLedger.instrument` / `DeviceLedger.instrument`.
"""

from __future__ import annotations


class Tracer:
    """No-op base (the `none` backend)."""

    enabled = False

    def span(self, name: str, **args):
        return _NULL_SPAN


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


_NULL_SPAN = _NullSpan()
NULL_TRACER = Tracer()
