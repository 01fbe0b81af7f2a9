"""The hash-log divergence error (the counterpart of
`tigerbeetle_tpu/testing/hash_log.py`, cut to what the dual-commit
follower raises; reference: src/testing/hash_log.zig).

Two runs that should be identical are compared op by op, and the check
fails AT the first divergent op rather than at the end state.
"""

from __future__ import annotations


class HashLogDivergence(AssertionError):
    def __init__(self, op: int, kind: str, want: int, got: int):
        super().__init__(
            f"hash_log: first divergence at op {op} ({kind}): "
            f"recorded {want:#x}, this run {got:#x}"
        )
        self.op = op
        self.kind = kind
