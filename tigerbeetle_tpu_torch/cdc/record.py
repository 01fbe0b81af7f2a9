"""Change-record encoder: committed prepare + reply buffer -> records.

One record per event of a committed `create_accounts` / `create_transfers`
prepare (lookups and registers change nothing and encode to no records —
their ops still advance the stream cursor, keeping op coverage contiguous).
The inputs are exactly what the replica already holds at commit finalize:
the prepare body (the event rows) and the reply body (the sparse non-ok
result structs) — result codes come from the buffer that was materialized
for the client reply anyway, so the encoder adds no device->host transfer.

Balance deltas are attached where they are derivable from the row alone:

- plain transfers (no two-phase/balancing flags): debit.debits_posted and
  credit.credits_posted each move by `amount` — exact, `resolved: true`;
- pending transfers: the pending columns move by `amount` — exact;
- post/void/balancing: the moved amount resolves against the PENDING
  transfer's state at execution time (reference:
  src/state_machine.zig:907-1014), which only the execution engine sees —
  the record carries the event verbatim with `resolved: false` and no
  deltas, and a consumer that needs those balances materializes them from
  its own pending store (it has every pending transfer earlier in the
  stream).

Records serialize as canonical JSON lines (sorted keys, fixed separators):
the same committed history always produces byte-identical stream dumps,
which is what the simulator's same-seed determinism check diffs.
"""

from __future__ import annotations

import json

import numpy as np

from tigerbeetle_tpu_torch.types import (
    ACCOUNT_DTYPE,
    CREATE_TRANSFERS_RESULT_DTYPE,
    TRANSFER_DTYPE,
    Operation,
    TransferFlags,
    join_u128,
)

# Transfer flags whose amount/accounts resolve against prior state at
# execution time (two-phase second legs + balancing caps).
_INDIRECT_FLAGS = int(
    TransferFlags.post_pending_transfer
    | TransferFlags.void_pending_transfer
    | TransferFlags.balancing_debit
    | TransferFlags.balancing_credit
)

_CREATE_OPS = (int(Operation.create_accounts), int(Operation.create_transfers))


def _result_codes(n: int, reply_body: bytes | None) -> np.ndarray | None:
    """Sparse non-ok reply structs -> dense per-event u32 codes.
    None means the reply buffer is unavailable (results unknown)."""
    if reply_body is None:
        return None
    codes = np.zeros(n, dtype=np.uint32)
    if reply_body:
        sparse = np.frombuffer(reply_body, dtype=CREATE_TRANSFERS_RESULT_DTYPE)
        codes[sparse["index"]] = sparse["result"]
    return codes


def encode_batch(header, body: bytes, reply_body: bytes | None) -> list[dict]:
    """Change records for one committed prepare. `header` is the prepare's
    VSR header; `reply_body` the reply wire body (sparse result structs)
    or None when unknown (records then carry `result: null`)."""
    operation = int(header.operation)
    if operation not in _CREATE_OPS:
        return []
    rows = np.frombuffer(
        body,
        dtype=(
            ACCOUNT_DTYPE
            if operation == int(Operation.create_accounts)
            else TRANSFER_DTYPE
        ),
    )
    n = len(rows)
    codes = _result_codes(n, reply_body)
    # per-event timestamp rule: the kernel assigns ts - n + i + 1
    ts0 = int(header.timestamp) - n + 1
    out: list[dict] = []
    if operation == int(Operation.create_accounts):
        for i in range(n):
            r = rows[i]
            code = None if codes is None else int(codes[i])
            rec = {
                "kind": "account",
                "op": int(header.op),
                "ix": i,
                "ts": ts0 + i,
                "result": code,
                "id": join_u128(r["id_lo"], r["id_hi"]),
                "ledger": int(r["ledger"]),
                "code": int(r["code"]),
                "flags": int(r["flags"]),
                "user_data_128": join_u128(
                    r["user_data_128_lo"], r["user_data_128_hi"]
                ),
                "user_data_64": int(r["user_data_64"]),
                "user_data_32": int(r["user_data_32"]),
                "resolved": code is not None,
            }
            # event balance fields: zero on every VALID create, but the
            # validation family (debits_posted_must_be_zero & friends)
            # rejects on them — a stream replayer can only reproduce
            # those result codes if the record carries the fields
            for field in (
                "debits_pending", "debits_posted",
                "credits_pending", "credits_posted",
            ):
                rec[field] = join_u128(r[field + "_lo"], r[field + "_hi"])
            rec["reserved"] = int(r["reserved"])
            out.append(rec)
        return out
    for i in range(n):
        r = rows[i]
        code = None if codes is None else int(codes[i])
        flags = int(r["flags"])
        amount = join_u128(r["amount_lo"], r["amount_hi"])
        debit = join_u128(r["debit_account_id_lo"], r["debit_account_id_hi"])
        credit = join_u128(r["credit_account_id_lo"], r["credit_account_id_hi"])
        rec = {
            "kind": "transfer",
            "op": int(header.op),
            "ix": i,
            "ts": ts0 + i,
            "result": code,
            "id": join_u128(r["id_lo"], r["id_hi"]),
            "debit_account_id": debit,
            "credit_account_id": credit,
            "amount": amount,
            "pending_id": join_u128(r["pending_id_lo"], r["pending_id_hi"]),
            "timeout": int(r["timeout"]),
            "ledger": int(r["ledger"]),
            "code": int(r["code"]),
            "flags": flags,
            "user_data_128": join_u128(
                r["user_data_128_lo"], r["user_data_128_hi"]
            ),
            "user_data_64": int(r["user_data_64"]),
            "user_data_32": int(r["user_data_32"]),
        }
        if code is None:
            rec["resolved"] = False
        elif code != 0:
            rec["resolved"] = True  # failed: exactly zero effect
        elif flags & _INDIRECT_FLAGS:
            rec["resolved"] = False  # amount resolves against pending state
        else:
            rec["resolved"] = True
            if flags & int(TransferFlags.pending):
                rec["deltas"] = [
                    [debit, "debits_pending", amount],
                    [credit, "credits_pending", amount],
                ]
            else:
                rec["deltas"] = [
                    [debit, "debits_posted", amount],
                    [credit, "credits_posted", amount],
                ]
        out.append(rec)
    return out


def _u128s(rows: np.ndarray, name: str) -> list[int]:
    """Column `name` (its _lo/_hi halves) as Python ints."""
    lo = rows[name + "_lo"].tolist()
    hi = rows[name + "_hi"]
    if not hi.any():
        return lo
    return [(h << 64) | v for v, h in zip(lo, hi.tolist())]


def encode_lines(header, body: bytes, reply_body: bytes | None) -> list[str]:
    """`[record_line(r) for r in encode_batch(header, body, reply_body)]`,
    byte for byte, built from whole columns: a server's event loop encodes
    every committed op, and the per-record dicts and `json.dumps` took a
    host tenth of a second or more for 8190 events, longer than the
    loop may stall under the replica's view-change timeouts. The keys
    are written in sorted order, as `record_line` sorts them."""
    operation = int(header.operation)
    if operation not in _CREATE_OPS:
        return []
    accounts = operation == int(Operation.create_accounts)
    rows = np.frombuffer(body, dtype=ACCOUNT_DTYPE if accounts else TRANSFER_DTYPE)
    n = len(rows)
    codes = _result_codes(n, reply_body)
    op = int(header.op)
    ts0 = int(header.timestamp) - n + 1
    if codes is None:
        results, resolved = ["null"] * n, ["false"] * n
    else:
        code_list = codes.tolist()
        results = [str(c) for c in code_list]
    ids = _u128s(rows, "id")
    ud128 = _u128s(rows, "user_data_128")
    ud64 = rows["user_data_64"].tolist()
    ud32 = rows["user_data_32"].tolist()
    ledger = rows["ledger"].tolist()
    code = rows["code"].tolist()
    flags = rows["flags"].tolist()
    if accounts:
        if codes is not None:
            resolved = ["true"] * n
        dp, dq = _u128s(rows, "debits_pending"), _u128s(rows, "debits_posted")
        cp, cq = _u128s(rows, "credits_pending"), _u128s(rows, "credits_posted")
        reserved = rows["reserved"].tolist()
        return [
            f'{{"code":{code[i]},"credits_pending":{cp[i]},"credits_posted":{cq[i]},'
            f'"debits_pending":{dp[i]},"debits_posted":{dq[i]},"flags":{flags[i]},'
            f'"id":{ids[i]},"ix":{i},"kind":"account","ledger":{ledger[i]},"op":{op},'
            f'"reserved":{reserved[i]},"resolved":{resolved[i]},"result":{results[i]},'
            f'"ts":{ts0 + i},"user_data_128":{ud128[i]},"user_data_32":{ud32[i]},'
            f'"user_data_64":{ud64[i]}}}'
            for i in range(n)
        ]
    amount = _u128s(rows, "amount")
    debit = _u128s(rows, "debit_account_id")
    credit = _u128s(rows, "credit_account_id")
    pending_id = _u128s(rows, "pending_id")
    timeout = rows["timeout"].tolist()
    pending = int(TransferFlags.pending)
    # "deltas" sorts between "debit_account_id" and "flags"
    deltas = [""] * n
    if codes is not None:
        resolved = ["true"] * n
        for i in range(n):
            if code_list[i] != 0:
                continue  # failed: exactly zero effect
            if flags[i] & _INDIRECT_FLAGS:
                resolved[i] = "false"  # resolves against pending state
                continue
            side = "pending" if flags[i] & pending else "posted"
            deltas[i] = (
                f'"deltas":[[{debit[i]},"debits_{side}",{amount[i]}],'
                f'[{credit[i]},"credits_{side}",{amount[i]}]],'
            )
    return [
        f'{{"amount":{amount[i]},"code":{code[i]},"credit_account_id":{credit[i]},'
        f'"debit_account_id":{debit[i]},{deltas[i]}"flags":{flags[i]},"id":{ids[i]},'
        f'"ix":{i},"kind":"transfer","ledger":{ledger[i]},"op":{op},'
        f'"pending_id":{pending_id[i]},"resolved":{resolved[i]},"result":{results[i]},'
        f'"timeout":{timeout[i]},"ts":{ts0 + i},"user_data_128":{ud128[i]},'
        f'"user_data_32":{ud32[i]},"user_data_64":{ud64[i]}}}'
        for i in range(n)
    ]


def commitment_record(op: int, commitment: int, prev: int) -> dict:
    """Checkpoint state-commitment record (federation/commitment.py):
    the chained digest of the ledger's state fingerprint at boundary
    `op`. A consumer replaying the stream through its own state machine
    recomputes the chain and rejects a tampered stream/state naming this
    exact checkpoint. Defined here (not in federation/) so the encoder
    module owns every stream record kind without importing upward."""
    return {
        "kind": "commitment",
        "op": op,
        "commitment": commitment,
        "prev": prev,
    }


def gap_record(from_op: int, to_op: int) -> dict:
    """Declared hole in the stream: ops this replica never executed
    (state-sync install jumped over them) or whose bytes are no longer
    reachable (WAL ring wrapped, no AOF). Explicit so a consumer can halt
    or re-point rather than silently missing history."""
    return {"kind": "gap", "from": from_op, "to": to_op}


def record_line(rec: dict) -> str:
    """Canonical JSON line (sorted keys, fixed separators): the same
    record always encodes to the same bytes."""
    return json.dumps(rec, sort_keys=True, separators=(",", ":"))
