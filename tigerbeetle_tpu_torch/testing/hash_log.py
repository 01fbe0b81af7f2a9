"""hash_log: record/check divergence debugging between two runs
(reference: src/testing/hash_log.zig:1-5, armed by -Dhash-log-mode in
src/config.zig:195-199).

When two runs that SHOULD be identical (same seed, same inputs — e.g. a
single-chip vs sharded-mesh replica, or the same seed before/after a
kernel change) disagree, the state checkers only say the END states
differ. The hash log pinpoints the FIRST divergent commit: record mode
streams one hash per committed op — covering the prepare (op, checksum:
the consensus stream) AND the reply body checksum (the result codes: a
kernel nondeterminism with an identical log still diverges here) — and
check mode replays against the recording, failing with the exact op.

The counterpart of `tigerbeetle_tpu/testing/hash_log.py`: the same saved
lines and the same digest, so a recording made by either package checks
in the other.
"""

from __future__ import annotations

import json

from tigerbeetle_tpu_torch import native


def parse_hash_log_spec(spec: str) -> tuple[str, str]:
    """CLI surface parser (``start --hash-log``, ``vopr.py --hash-log``):
    ``record:<path>`` | ``check:<path>`` | bare ``<path>`` (records) ->
    (mode, path). The reference arms the same pair via -Dhash-log-mode
    (src/config.zig:195-199)."""
    mode, sep, path = spec.partition(":")
    if sep and mode in ("record", "check"):
        return mode, path
    return "record", spec


class HashLogDivergence(AssertionError):
    def __init__(self, op: int, kind: str, want: int, got: int):
        super().__init__(
            f"hash_log: first divergence at op {op} ({kind}): "
            f"recorded {want:#x}, this run {got:#x}"
        )
        self.op = op
        self.kind = kind


class HashLog:
    """mode="record": stream hashes into memory (save() persists).
    mode="check": every hash is compared as it happens — the run fails AT
    the first divergent op, not at the end."""

    def __init__(self, mode: str = "record", path: str | None = None):
        assert mode in ("record", "check")
        self.mode = mode
        self.path = path
        # op -> (prepare_checksum, reply_body_checksum | None)
        self.entries: dict[int, list] = {}
        # ops THIS RUN actually streamed/verified (check mode preloads
        # `entries` from the recording, so len(entries) says nothing
        # about replay coverage — a truncated replay must not read as
        # fully checked)
        self._seen: set[int] = set()
        if mode == "check":
            assert path is not None, "check mode needs a recording"
            with open(path) as f:
                for line in f:
                    rec = json.loads(line)
                    self.entries[int(rec["op"])] = [
                        int(rec["prepare"], 16),
                        int(rec["reply"], 16) if rec["reply"] else None,
                    ]

    @property
    def ops_seen(self) -> int:
        """Distinct ops this run recorded (record mode) or replayed
        against the recording (check mode) — the coverage number a
        surface should report, NOT len(entries)."""
        return len(self._seen)

    # -- wiring --

    def attach(self, replica) -> None:
        """Chain onto the replica's observation hooks (composes with an
        already-installed hook, e.g. the simulator's history recorder)."""
        prev_commit = replica.commit_hook
        prev_reply = replica.reply_hook

        def on_commit(header, body):
            if prev_commit is not None:
                prev_commit(header, body)
            self.note_prepare(header.op, header.checksum)

        def on_reply(header, reply_checksum):
            if prev_reply is not None:
                prev_reply(header, reply_checksum)
            self.note_reply(header.op, reply_checksum)

        replica.commit_hook = on_commit
        replica.reply_hook = on_reply

    # -- the stream --

    def note_prepare(self, op: int, checksum: int) -> None:
        self._seen.add(op)
        if self.mode == "record":
            self.entries.setdefault(op, [None, None])[0] = checksum
            return
        want = self.entries.get(op)
        if want is None:
            raise HashLogDivergence(op, "prepare-beyond-recording", 0, checksum)
        if want[0] is not None and want[0] != checksum:
            raise HashLogDivergence(op, "prepare", want[0], checksum)

    def note_reply(self, op: int, reply_checksum: int) -> None:
        if self.mode == "record":
            self.entries.setdefault(op, [None, None])[1] = reply_checksum
            return
        want = self.entries.get(op)
        if want is not None and want[1] is not None and want[1] != reply_checksum:
            raise HashLogDivergence(op, "reply", want[1], reply_checksum)

    # -- persistence --

    def save(self, path: str | None = None) -> str:
        path = path or self.path
        assert path is not None
        with open(path, "w") as f:
            for op in sorted(self.entries):
                pre, rep = self.entries[op]
                f.write(json.dumps({
                    "op": op,
                    "prepare": f"{pre:#x}" if pre is not None else "",
                    "reply": f"{rep:#x}" if rep is not None else "",
                }) + "\n")
        return path

    def digest(self) -> int:
        """One checksum over the whole stream (quick whole-run compare)."""
        acc = b"".join(
            op.to_bytes(8, "little")
            + (pre or 0).to_bytes(16, "little")
            + (rep or 0).to_bytes(16, "little")
            for op, (pre, rep) in sorted(self.entries.items())
        )
        return native.checksum(acc)
