"""Bulk-ingest session: suspend derived structures around slab inserts.

Per-row trigger maintenance dominates initial corpus loads: every ``files``
/ ``extracted_text`` insert pays an FTS5 tokenize+merge plus a change-log
append, and every secondary index pays an incremental b-tree insert.
The JAX package measured 48 s with triggers live against 15 s of raw
inserts, a 3 s FTS rebuild and the index re-create, on a 200k-row slab on
its TPU host (not the port's measurement). The reference pays the same
cost shape in its initial scan (extraction.rs batches inserts inside one
transaction for the same reason); for a from-empty bulk load the optimal
schedule is drop → insert → rebuild.

``bulk_ingest`` captures the DDL of all triggers and named (non-constraint)
indexes on the target tables, drops them, yields the connection for raw
slab inserts, then re-creates the indexes (a sorted bulk build, far cheaper
than incremental maintenance), issues the FTS5 external-content ``rebuild``
command for every FTS table whose ``content=`` target was touched, and
re-creates the triggers. Because SQLite DDL is transactional, an exception
inside the block rolls the drops back together with the data — the schema
can never be left bare.

Soundness with live readers: the suspended change-log triggers mean cached
base snapshots (pql/executor.py ``_refresh_base``) would silently miss the
bulk rows, so on success the session appends one NULL ``item_id`` row to
``base_change_log`` — the global-change marker every snapshot responds to
with a full rebuild.

The port's copy of ``panoptikon_tpu/db/bulk.py``, held to it by
``tests/test_torch_host_copies.py``.
"""

from __future__ import annotations

from contextlib import contextmanager

# Tables whose derived structures are worth suspending for a corpus load.
BULK_TABLES = ("items", "files", "item_data", "extracted_text", "tags_items")


@contextmanager
def bulk_ingest(conn, tables: tuple[str, ...] = BULK_TABLES):
    """Run slab inserts on ``conn`` with triggers/indexes suspended.

    MUST run inside the single-writer transaction (db/writer.py): the DDL
    and the inserts commit or roll back atomically. Yields ``conn``.
    """
    # Python's sqlite3 legacy autocommit opens its implicit transaction only
    # around DML — the DROPs below would otherwise run autocommitted and
    # survive a mid-bulk rollback, leaving the schema bare. Open the unit's
    # transaction explicitly so DDL + inserts are one atomic unit (the
    # writer's ``with conn:`` commit/rollback then covers everything).
    if not conn.in_transaction:
        conn.execute("BEGIN")
    qmarks = ",".join("?" * len(tables))
    triggers = conn.execute(
        f"SELECT name, sql FROM sqlite_master WHERE type='trigger'"
        f" AND tbl_name IN ({qmarks})",
        tables,
    ).fetchall()
    # sql IS NOT NULL filters out UNIQUE/PK auto-indexes, which cannot be
    # dropped (and whose enforcement must stay live through the bulk).
    indexes = conn.execute(
        f"SELECT name, sql FROM sqlite_master WHERE type='index'"
        f" AND sql IS NOT NULL AND tbl_name IN ({qmarks})",
        tables,
    ).fetchall()
    # External-content FTS5 tables over a target table rebuild from content.
    fts_tables = [
        name
        for name, sql in conn.execute(
            "SELECT name, sql FROM sqlite_master WHERE type='table'"
            " AND sql LIKE '%USING fts5%'"
        ).fetchall()
        if any(f"content='{t}'" in (sql or "") for t in tables)
    ]
    for name, _ in triggers:
        conn.execute(f'DROP TRIGGER "{name}"')
    for name, _ in indexes:
        conn.execute(f'DROP INDEX "{name}"')
    yield conn
    for _, sql in indexes:
        conn.execute(sql)
    for name in fts_tables:
        conn.execute(f'INSERT INTO "{name}"("{name}") VALUES (\'rebuild\')')
    for _, sql in triggers:
        conn.execute(sql)
    try:
        conn.execute("INSERT INTO base_change_log(item_id) VALUES (NULL)")
    except Exception:
        pass  # DB family without a change log (user_data): nothing to mark
