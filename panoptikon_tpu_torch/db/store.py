"""Typed query layer over the index/storage/user_data schemas (the L1 DB
access modules — reference ``panoptikon/src/db/*.rs``, reduced to the
operations the TPU rebuild's jobs/API actually drive).

Write functions take the writer connection (run them via
``IndexWriter.call``); read functions take any reader connection. Times are
ISO-8601 TEXT like the reference.
"""

from __future__ import annotations

import datetime as _dt
import json
import sqlite3
from typing import Any, Iterable, Optional

import numpy as np


def now_iso() -> str:
    return _dt.datetime.now(_dt.timezone.utc).isoformat()


# ---------------------------------------------------------------------------
# Items / files / folders
# ---------------------------------------------------------------------------


def upsert_item(
    conn: sqlite3.Connection,
    sha256: str,
    md5: str,
    mime_type: str,
    *,
    size: int | None = None,
    width: int | None = None,
    height: int | None = None,
    duration: float | None = None,
    audio_tracks: int | None = None,
    video_tracks: int | None = None,
    subtitle_tracks: int | None = None,
    blurhash: str | None = None,
) -> int:
    row = conn.execute("SELECT id FROM items WHERE sha256 = ?", (sha256,)).fetchone()
    if row:
        conn.execute(
            """UPDATE items SET md5=?, type=?, size=?, width=?, height=?,
               duration=?, audio_tracks=?, video_tracks=?, subtitle_tracks=?,
               blurhash=COALESCE(?, blurhash) WHERE id=?""",
            (md5, mime_type, size, width, height, duration, audio_tracks,
             video_tracks, subtitle_tracks, blurhash, row[0]),
        )
        return int(row[0])
    cur = conn.execute(
        """INSERT INTO items (sha256, md5, type, size, width, height, duration,
           audio_tracks, video_tracks, subtitle_tracks, blurhash, time_added)
           VALUES (?,?,?,?,?,?,?,?,?,?,?,?)""",
        (sha256, md5, mime_type, size, width, height, duration, audio_tracks,
         video_tracks, subtitle_tracks, blurhash, now_iso()),
    )
    return int(cur.lastrowid)


def upsert_file(
    conn: sqlite3.Connection,
    item_id: int,
    sha256: str,
    path: str,
    last_modified: str,
    scan_id: int | None = None,
) -> int:
    filename = path.rsplit("/", 1)[-1]
    row = conn.execute(
        """INSERT INTO files (sha256, item_id, path, filename, last_modified,
           scan_id, available) VALUES (?,?,?,?,?,?,1)
           ON CONFLICT(path) DO UPDATE SET sha256=excluded.sha256,
             item_id=excluded.item_id, filename=excluded.filename,
             last_modified=excluded.last_modified, scan_id=excluded.scan_id,
             available=1
           RETURNING id""",
        (sha256, item_id, path, filename, last_modified, scan_id),
    ).fetchone()
    return int(row[0])


def mark_files_unavailable(conn: sqlite3.Connection, paths: Iterable[str]) -> int:
    n = 0
    for path in paths:
        n += conn.execute(
            "UPDATE files SET available = 0 WHERE path = ?", (path,)
        ).rowcount
    return n


def delete_orphan_items(conn: sqlite3.Connection) -> int:
    """Items with no available files left (reference: file scan cleanup)."""
    return conn.execute(
        """DELETE FROM items WHERE id NOT IN
           (SELECT DISTINCT item_id FROM files WHERE available = 1)"""
    ).rowcount


def item_by_sha256(conn: sqlite3.Connection, sha256: str) -> Optional[sqlite3.Row]:
    conn.row_factory = sqlite3.Row
    return conn.execute("SELECT * FROM items WHERE sha256 = ?", (sha256,)).fetchone()


def add_folder(conn: sqlite3.Connection, path: str, included: bool = True) -> int:
    row = conn.execute(
        """INSERT INTO folders (path, included, time_added) VALUES (?,?,?)
           ON CONFLICT(path) DO UPDATE SET included=excluded.included
           RETURNING id""",
        (path, int(included), now_iso()),
    ).fetchone()
    return int(row[0])


def list_folders(conn: sqlite3.Connection, included: bool | None = None):
    if included is None:
        rows = conn.execute("SELECT path, included FROM folders").fetchall()
    else:
        rows = conn.execute(
            "SELECT path, included FROM folders WHERE included = ?", (int(included),)
        ).fetchall()
    return [(r[0], bool(r[1])) for r in rows]


# ---------------------------------------------------------------------------
# Setters / jobs / logs
# ---------------------------------------------------------------------------


def upsert_setter(conn: sqlite3.Connection, name: str) -> int:
    # DO NOTHING leaves cursor.lastrowid stale, so re-select explicitly.
    conn.execute(
        "INSERT INTO setters (name) VALUES (?) ON CONFLICT(name) DO NOTHING", (name,)
    )
    return int(conn.execute("SELECT id FROM setters WHERE name=?", (name,)).fetchone()[0])


def setter_id(conn: sqlite3.Connection, name: str) -> Optional[int]:
    row = conn.execute("SELECT id FROM setters WHERE name=?", (name,)).fetchone()
    return int(row[0]) if row else None


def create_data_job(conn: sqlite3.Connection) -> int:
    return int(conn.execute("INSERT INTO data_jobs DEFAULT VALUES").lastrowid)


def complete_data_job(conn: sqlite3.Connection, job_id: int) -> None:
    conn.execute("UPDATE data_jobs SET completed = 1 WHERE id = ?", (job_id,))


def remove_incomplete_jobs(conn: sqlite3.Connection) -> int:
    """Mark phantom in-progress work left behind by a killed process
    (extraction_write.rs:61 remove_incomplete_jobs): data_jobs/data_log
    rows stuck at completed=0 become -1 so job history shows them as
    incomplete rather than forever-running, and dangling file_scans rows
    get an end time. Partial outputs are KEPT — the keyset-cursor re-run's
    NOT-processed predicate finds the remainder ('the data is the
    checkpoint'), so nothing needs deleting."""
    marked = conn.execute(
        "UPDATE data_jobs SET completed = -1 WHERE completed = 0"
    ).rowcount
    conn.execute("UPDATE data_log SET completed = -1 WHERE completed = 0")
    conn.execute(
        "UPDATE file_scans SET end_time = ? WHERE end_time IS NULL",
        (now_iso(),),
    )
    return marked


def add_data_log(
    conn: sqlite3.Connection,
    job_id: int,
    *,
    log_type: str,
    setter: str,
    batch_size: int,
    threshold: float | None = None,
    total_remaining: int = 0,
) -> int:
    now = now_iso()
    return int(
        conn.execute(
            """INSERT INTO data_log (job_id, start_time, end_time, type, setter,
               threshold, batch_size, total_remaining)
               VALUES (?,?,?,?,?,?,?,?)""",
            (job_id, now, now, log_type, setter, threshold, batch_size, total_remaining),
        ).lastrowid
    )


def finish_data_log(
    conn: sqlite3.Connection,
    log_id: int,
    *,
    image_files: int = 0,
    video_files: int = 0,
    other_files: int = 0,
    total_segments: int = 0,
    errors: int = 0,
    data_load_time: float = 0.0,
    inference_time: float = 0.0,
) -> None:
    conn.execute(
        """UPDATE data_log SET end_time=?, image_files=?, video_files=?,
           other_files=?, total_segments=?, errors=?, data_load_time=?,
           inference_time=?, completed=1 WHERE id=?""",
        (now_iso(), image_files, video_files, other_files, total_segments,
         errors, data_load_time, inference_time, log_id),
    )


def start_file_scan(conn: sqlite3.Connection, path: str) -> int:
    return int(
        conn.execute(
            "INSERT INTO file_scans (start_time, path) VALUES (?,?)",
            (now_iso(), path),
        ).lastrowid
    )


def finish_file_scan(conn: sqlite3.Connection, scan_id: int, **counters: Any) -> None:
    allowed = {
        "total_available", "new_items", "unchanged_files", "new_files",
        "modified_files", "marked_unavailable", "errors", "false_changes",
        "metadata_time", "hashing_time", "thumbgen_time", "blurhash_time",
    }
    sets, values = ["end_time=?"], [now_iso()]
    for key, value in counters.items():
        if key not in allowed:
            raise ValueError(f"unknown scan counter {key}")
        sets.append(f"{key}=?")
        values.append(value)
    values.append(scan_id)
    conn.execute(f"UPDATE file_scans SET {', '.join(sets)} WHERE id=?", values)


# ---------------------------------------------------------------------------
# Extraction outputs: item_data + text / embeddings / tags
# ---------------------------------------------------------------------------


def insert_item_data(
    conn: sqlite3.Connection,
    item_id: int,
    setter_id_: int,
    data_type: str,
    *,
    idx: int = 0,
    job_id: int | None = None,
    source_id: int | None = None,
    is_placeholder: bool = False,
) -> int:
    is_origin = 1 if source_id is None else None
    return int(
        conn.execute(
            """INSERT INTO item_data (item_id, job_id, setter_id, data_type, idx,
               source_id, is_origin, is_placeholder) VALUES (?,?,?,?,?,?,?,?)""",
            (item_id, job_id, setter_id_, data_type, idx, source_id, is_origin,
             1 if is_placeholder else None),
        ).lastrowid
    )


def insert_extracted_text(
    conn: sqlite3.Connection,
    data_id: int,
    text: str,
    *,
    language: str | None = None,
    language_confidence: float | None = None,
    confidence: float | None = None,
) -> None:
    conn.execute(
        """INSERT INTO extracted_text (id, language, language_confidence,
           confidence, text, text_length) VALUES (?,?,?,?,?,?)""",
        (data_id, language, language_confidence, confidence, text, len(text)),
    )


def insert_embedding(conn: sqlite3.Connection, data_id: int, vector: np.ndarray) -> None:
    blob = np.ascontiguousarray(vector, dtype="<f4").tobytes()
    conn.execute("INSERT INTO embeddings (id, embedding) VALUES (?,?)", (data_id, blob))


def upsert_tag(conn: sqlite3.Connection, namespace: str, name: str) -> int:
    conn.execute(
        """INSERT INTO tags (namespace, name) VALUES (?,?)
           ON CONFLICT(namespace, name) DO NOTHING""",
        (namespace, name),
    )
    return int(
        conn.execute(
            "SELECT id FROM tags WHERE namespace=? AND name=?", (namespace, name)
        ).fetchone()[0]
    )


def tag_item(
    conn: sqlite3.Connection,
    item_data_id: int,
    item_id: int,
    tag_id: int,
    confidence: float = 1.0,
) -> None:
    conn.execute(
        """INSERT INTO tags_items (item_data_id, tag_id, item_id, confidence)
           VALUES (?,?,?,?)
           ON CONFLICT(item_data_id, tag_id) DO UPDATE SET
             confidence=excluded.confidence""",
        (item_data_id, tag_id, item_id, confidence),
    )


def recount_tags(conn: sqlite3.Connection) -> None:
    """The deferred tag recount owed after batch jobs
    (job-boundary scheduling)."""
    conn.execute(
        """UPDATE tags SET item_count = COALESCE((
             SELECT COUNT(DISTINCT ti.item_id) FROM tags_items ti
             WHERE ti.tag_id = tags.id), 0)"""
    )


def delete_setter_data(conn: sqlite3.Connection, setter_name: str) -> int:
    """Remove every output of one setter (reference JobDataDeletion)."""
    sid = setter_id(conn, setter_name)
    if sid is None:
        return 0
    return conn.execute("DELETE FROM item_data WHERE setter_id = ?", (sid,)).rowcount


# ---------------------------------------------------------------------------
# Work queries (ProcessedBy / HasUnprocessed / FailedFor building blocks)
# ---------------------------------------------------------------------------


def unprocessed_items(
    conn: sqlite3.Connection,
    setter_name: str,
    *,
    mime_prefixes: Iterable[str] = (),
    after_item_id: int = 0,
    limit: int = 1024,
) -> list[tuple[int, str, str, int]]:
    """Keyset-chunked work query: items NOT processed by the setter and not
    ledgered as failed for it (extraction.rs work query built as PQL:
    NOT ProcessedBy AND mime AND NOT FailedFor). Returns
    (item_id, sha256, type, size) — size feeds the loader byte budget."""
    mime_sql, params = "", []
    prefixes = list(mime_prefixes)
    if prefixes:
        mime_sql = " AND (" + " OR ".join("i.type LIKE ?" for _ in prefixes) + ")"
        params.extend(p + "%" for p in prefixes)
    sql = f"""
        SELECT i.id, i.sha256, i.type, i.size FROM items i
        WHERE i.id > ?
          AND EXISTS (SELECT 1 FROM files f WHERE f.item_id = i.id AND f.available = 1)
          AND NOT EXISTS (
            SELECT 1 FROM item_data d JOIN setters s ON s.id = d.setter_id
            WHERE d.item_id = i.id AND s.name = ?)
          AND NOT EXISTS (
            SELECT 1 FROM extraction_errors e
            WHERE e.item_id = i.id AND e.setter_name = ? AND e.error_class = 'input')
          {mime_sql}
        ORDER BY i.id LIMIT ?
    """
    rows = conn.execute(
        sql, (after_item_id, setter_name, setter_name, *params, limit)
    ).fetchall()
    return [(int(r[0]), r[1], r[2], int(r[3] or 0)) for r in rows]


def count_unprocessed(
    conn: sqlite3.Connection, setter_name: str, mime_prefixes: Iterable[str] = ()
) -> int:
    mime_sql, params = "", []
    prefixes = list(mime_prefixes)
    if prefixes:
        mime_sql = " AND (" + " OR ".join("i.type LIKE ?" for _ in prefixes) + ")"
        params.extend(p + "%" for p in prefixes)
    sql = f"""
        SELECT COUNT(*) FROM items i
        WHERE EXISTS (SELECT 1 FROM files f WHERE f.item_id = i.id AND f.available = 1)
          AND NOT EXISTS (
            SELECT 1 FROM item_data d JOIN setters s ON s.id = d.setter_id
            WHERE d.item_id = i.id AND s.name = ?)
          AND NOT EXISTS (
            SELECT 1 FROM extraction_errors e
            WHERE e.item_id = i.id AND e.setter_name = ? AND e.error_class = 'input')
          {mime_sql}
    """
    return int(conn.execute(sql, (setter_name, setter_name, *params)).fetchone()[0])


# ---------------------------------------------------------------------------
# Failure ledgers (docs/failed-media-retry-design.md semantics)
# ---------------------------------------------------------------------------


def record_extraction_error(
    conn: sqlite3.Connection,
    item_id: int,
    setter_name: str,
    *,
    stage: str,
    error_class: str,  # 'input' persists; 'transient' is advisory only
    message: str | None = None,
    blocker: str | None = None,
) -> None:
    now = now_iso()
    conn.execute(
        """INSERT INTO extraction_errors (item_id, setter_name, stage,
           error_class, message, blocker, attempts, first_seen, last_seen)
           VALUES (?,?,?,?,?,?,1,?,?)
           ON CONFLICT(item_id, setter_name) DO UPDATE SET
             stage=excluded.stage, error_class=excluded.error_class,
             message=excluded.message, blocker=excluded.blocker,
             attempts=attempts+1, last_seen=excluded.last_seen""",
        (item_id, setter_name, stage, error_class, message, blocker, now, now),
    )


def heal_blocked_errors(conn: sqlite3.Connection, blocker: str) -> int:
    """Blocked errors heal when the missing dependency appears
    (files.rs:719 ``heal_blocked_scan_errors``)."""
    n = conn.execute(
        "DELETE FROM extraction_errors WHERE blocker = ?", (blocker,)
    ).rowcount
    n += conn.execute("DELETE FROM scan_errors WHERE blocker = ?", (blocker,)).rowcount
    return n


def record_scan_error(
    conn: sqlite3.Connection,
    path: str,
    *,
    stage: str,
    error_class: str,
    message: str | None = None,
    blocker: str | None = None,
) -> None:
    now = now_iso()
    conn.execute(
        """INSERT INTO scan_errors (path, stage, error_class, message, blocker,
           attempts, first_seen, last_seen) VALUES (?,?,?,?,?,1,?,?)
           ON CONFLICT(path, stage) DO UPDATE SET
             error_class=excluded.error_class, message=excluded.message,
             blocker=excluded.blocker, attempts=attempts+1,
             last_seen=excluded.last_seen""",
        (path, stage, error_class, message, blocker, now, now),
    )


# ---------------------------------------------------------------------------
# System config / maintenance state (per-DB config stored in the DB)
# ---------------------------------------------------------------------------


def get_config(conn: sqlite3.Connection, key: str, default: Any = None) -> Any:
    row = conn.execute("SELECT value FROM system_config WHERE key=?", (key,)).fetchone()
    return json.loads(row[0]) if row else default


def set_config(conn: sqlite3.Connection, key: str, value: Any) -> None:
    conn.execute(
        """INSERT INTO system_config (key, value) VALUES (?,?)
           ON CONFLICT(key) DO UPDATE SET value=excluded.value""",
        (key, json.dumps(value)),
    )


def get_maintenance(conn: sqlite3.Connection, key: str, default: Any = None) -> Any:
    row = conn.execute(
        "SELECT value FROM maintenance_state WHERE key=?", (key,)
    ).fetchone()
    return json.loads(row[0]) if row else default


def set_maintenance(conn: sqlite3.Connection, key: str, value: Any) -> None:
    conn.execute(
        """INSERT INTO maintenance_state (key, value) VALUES (?,?)
           ON CONFLICT(key) DO UPDATE SET value=excluded.value""",
        (key, json.dumps(value)),
    )


# ---------------------------------------------------------------------------
# Embedding space loads (feeding the device index)
# ---------------------------------------------------------------------------


def load_embedding_space(
    conn: sqlite3.Connection,
    setter_name: str,
    *,
    after_data_id: int = 0,
    limit: int = 100_000,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Stream one setter's embeddings in ascending data-id order:
    (data_ids, item_ids, vectors, weights). Weights are the source-text
    confidence products used by weighted aggregation (exact.rs:37-52);
    1.0 where no source text exists."""
    rows = conn.execute(
        """SELECT d.id, d.item_id, e.embedding,
                  COALESCE(st.confidence, 1.0) * COALESCE(st.language_confidence, 1.0)
           FROM item_data d
           JOIN setters s ON s.id = d.setter_id
           JOIN embeddings e ON e.id = d.id
           LEFT JOIN extracted_text st ON st.id = d.source_id
           WHERE s.name = ? AND d.id > ? AND d.is_placeholder IS NULL
           ORDER BY d.id LIMIT ?""",
        (setter_name, after_data_id, limit),
    ).fetchall()
    if not rows:
        empty = np.empty(0, dtype=np.int64)
        return empty, empty, np.empty((0, 0), np.float32), np.empty(0, np.float32)
    data_ids = np.array([r[0] for r in rows], dtype=np.int64)
    item_ids = np.array([r[1] for r in rows], dtype=np.int64)
    vectors = np.stack([np.frombuffer(r[2], dtype="<f4") for r in rows]).astype(
        np.float32
    )
    weights = np.array([r[3] for r in rows], dtype=np.float32)
    return data_ids, item_ids, vectors, weights
