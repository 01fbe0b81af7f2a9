"""ManifestLog: incremental manifest persistence as grid block chains.

The reference's ManifestLog (reference: src/lsm/manifest_log.zig, 904 LoC;
superblock trailer records the block addresses,
src/vsr/superblock_manifest.zig): instead of serializing every tree's full
table list at each checkpoint, trees append TableInfo churn events
(insert/remove at a level) as they flush and compact; a checkpoint writes
only the NEW events since the last checkpoint as appended blocks. When
accumulated churn exceeds a multiple of the live table count, the chain is
compacted: rewritten as a snapshot of the live set and the old blocks
released (staged until the following checkpoint, lsm/grid.py).

Event wire form (JSON within a checksummed grid block):
    {"t": tree_id, "l": level, "op": "i"|"r", "info": TableInfo.to_json()}
Tree ids follow the reference's assignment (1-24,
reference: src/state_machine.zig:67-100).

The port's copy of `tigerbeetle_tpu/lsm/manifest_log.py`, the same code with its imports
pointed at this package (the port imports nothing of the JAX package), so
that the port writes the same grid bytes.
"""

from __future__ import annotations

import json

from tigerbeetle_tpu_torch.lsm.grid import BLOCK_PAYLOAD_MAX, Grid
from tigerbeetle_tpu_torch.lsm.tree import TableInfo

COMPACT_CHURN_FACTOR = 4  # compact when events > max(64, factor * live)


class ManifestLog:
    def __init__(self, grid: Grid):
        self.grid = grid
        self.buffer: list[dict] = []  # events since the last checkpoint
        self.blocks: list[int] = []  # chain block addresses, oldest first
        self.event_count = 0  # events across the persisted chain

    # -- appends (called by trees as they mutate their table sets) --

    def append(self, tree_id: int, level: int, op: str, info: TableInfo) -> None:
        assert op in ("i", "r")
        self.buffer.append(
            {"t": tree_id, "l": level, "op": op, "info": info.to_json()}
        )

    # -- checkpoint --

    def checkpoint(self, live_tables: list[tuple[int, int, TableInfo]]) -> dict:
        """Persist buffered events; compact the chain first when churn
        dwarfs the live set (`live_tables`: every (tree_id, level, info)
        currently live). Returns the meta dict for the superblock. Must run
        BEFORE the grid free set is encoded (this creates/releases blocks).
        """
        total = self.event_count + len(self.buffer)
        if total > max(64, COMPACT_CHURN_FACTOR * len(live_tables)):
            for address in self.blocks:
                self.grid.release(address)
            self.blocks = []
            self.event_count = 0
            self.buffer = [
                {"t": t, "l": lv, "op": "i", "info": info.to_json()}
                for t, lv, info in live_tables
            ]
        if self.buffer:
            for chunk in _pack_chunks(self.buffer):
                self.blocks.append(self.grid.create_block(chunk))
            self.event_count += len(self.buffer)
            self.buffer = []
        return {"blocks": list(self.blocks), "events": self.event_count}

    # -- restore --

    def restore(self, meta: dict) -> dict[int, dict[int, list[TableInfo]]]:
        """Replay the chain chronologically; returns
        tree_id -> level -> [TableInfo] with level 0 NEWEST-FIRST (flush
        order) and deeper levels sorted by key range."""
        self.blocks = list(meta["blocks"])
        self.event_count = int(meta["events"])
        self.buffer = []
        levels: dict[int, dict[int, list[TableInfo]]] = {}
        for address in self.blocks:
            for ev in json.loads(self.grid.read_block(address)):
                per_tree = levels.setdefault(ev["t"], {})
                lvl = per_tree.setdefault(ev["l"], [])
                if ev["op"] == "i":
                    lvl.append(TableInfo.from_json(ev["info"]))
                else:
                    addr = ev["info"]["index_address"]
                    for i, info in enumerate(lvl):
                        if info.index_address == addr:
                            del lvl[i]
                            break
                    else:
                        raise RuntimeError(
                            f"manifest log: remove of unknown table {addr}"
                        )
        for per_tree in levels.values():
            for lv, infos in per_tree.items():
                if lv == 0:
                    infos.reverse()  # chronological -> newest-first
                else:
                    infos.sort(key=lambda x: x.key_min)
        return levels


def _pack_chunks(events: list[dict]) -> list[bytes]:
    """JSON-encode events into block-sized payloads."""
    out: list[bytes] = []
    batch: list[dict] = []
    size = 2
    for ev in events:
        enc = len(json.dumps(ev)) + 1
        if batch and size + enc > BLOCK_PAYLOAD_MAX:
            out.append(json.dumps(batch).encode())
            batch, size = [], 2
        batch.append(ev)
        size += enc
    if batch:
        out.append(json.dumps(batch).encode())
    return out
