"""Device-index sync: project the durable embedding store onto the device.

The port's copy of ``panoptikon_tpu/jobs/index_sync.py``, held to it unit for unit
by ``tests/test_torch_host_copies.py``: host code only, with imports of the
port.

The SQLite ``embeddings`` table is the source of truth; the VectorIndex is
a rebuildable projection (the reference's "the data is the checkpoint"
stance applied to device memory). ``sync_space`` is incremental — it
resumes from the highest data_id already on device, so startup re-sync and
post-extraction top-up are the same code path.
"""

from __future__ import annotations

from panoptikon_tpu_torch.db import store
from panoptikon_tpu_torch.db.connection import Database
from panoptikon_tpu_torch.index.vector_index import VectorIndex

SYNC_BATCH = 50_000


def sync_space(db: Database, index: VectorIndex, setter: str) -> int:
    """Bring one embedding space up to date; returns rows added."""
    try:
        snap = index.snapshot(setter)
        after = int(snap.row_ids[: snap.size].max(initial=0)) if snap.size else 0
    except KeyError:
        after = 0
    conn = db.reader()
    added = 0
    while True:
        data_ids, item_ids, vectors, weights = store.load_embedding_space(
            conn, setter, after_data_id=after, limit=SYNC_BATCH
        )
        if len(data_ids) == 0:
            break
        index.add(setter, item_ids, data_ids, vectors, weights)
        added += len(data_ids)
        after = int(data_ids.max())
    return added


def sync_all(db: Database, index: VectorIndex) -> dict[str, int]:
    """Startup sync: every embedding-bearing setter."""
    conn = db.reader()
    setters = [
        r[0]
        for r in conn.execute(
            """SELECT DISTINCT s.name FROM setters s
               JOIN item_data d ON d.setter_id = s.id
               JOIN embeddings e ON e.id = d.id"""
        ).fetchall()
    ]
    return {s: sync_space(db, index, s) for s in setters}
