"""SQLite schema + migrations for the three database families.

The host database remains the durable source of truth ("the data is the
checkpoint" — reference jobs/vector_quants.rs:1-9); the device-resident
index (``panoptikon_tpu_torch.index``) is a rebuildable projection of it. Same
logical model as the reference's migrations (``panoptikon/migrations/``):

- ``index``    — items, files, folders, provenance (item_data), extracted
  text (+ trigram FTS5), embeddings (LE f32 blobs), tags, scan/extraction
  logs, error ledgers, quant profile/coverage state, per-DB system config.
- ``storage``  — thumbnails / frames BLOBs, visual attempt ledger.
- ``user_data``— bookmarks, pinboards with append-only version history.

Deliberate divergence from the reference: there is no ``embedding_quants``
codes table. The reference stores int8 codes in SQLite because its SQL
engine scans them; here the device index holds the codes, and a reconcile
re-quantizes from the durable f32 vectors in one device pass (cheaper than
maintaining a second 1.5 GiB on-disk copy — cf. docs/vector-int8-quant.md's
storage-amplification findings). The profile/coverage *state machine* is
kept bit-for-bit (pending/building/ready, artifact freeze, revisions).

Migrations are ordered (version, sql) pairs per family; ``migrate`` applies
the missing suffix inside one transaction per step.
"""

from __future__ import annotations

import sqlite3

INDEX_MIGRATIONS: list[tuple[int, str]] = [
    (
        1,
        """
        CREATE TABLE items (
            id INTEGER PRIMARY KEY,
            sha256 TEXT UNIQUE NOT NULL,
            md5 TEXT NOT NULL,
            type TEXT NOT NULL,
            size INTEGER,
            width INTEGER,
            height INTEGER,
            duration REAL,
            audio_tracks INTEGER,
            video_tracks INTEGER,
            subtitle_tracks INTEGER,
            blurhash TEXT,
            time_added TEXT NOT NULL
        );
        CREATE INDEX items_md5 ON items(md5);
        CREATE INDEX items_type ON items(type);
        CREATE INDEX items_size ON items(size);

        CREATE TABLE files (
            id INTEGER PRIMARY KEY,
            sha256 TEXT NOT NULL,
            item_id INTEGER NOT NULL REFERENCES items(id),
            path TEXT UNIQUE NOT NULL,
            filename TEXT NOT NULL,
            last_modified TEXT NOT NULL,
            scan_id INTEGER,
            available INTEGER NOT NULL DEFAULT 1
        );
        CREATE INDEX files_item_id ON files(item_id);
        CREATE INDEX files_sha256 ON files(sha256);
        CREATE INDEX files_last_modified ON files(last_modified);
        CREATE INDEX files_available ON files(available);

        CREATE VIRTUAL TABLE files_path_fts USING fts5(
            path, filename,
            content='files', content_rowid='id',
            tokenize='trigram case_sensitive 0'
        );
        CREATE TRIGGER files_fts_ai AFTER INSERT ON files BEGIN
            INSERT INTO files_path_fts(rowid, path, filename)
            VALUES (new.id, new.path, new.filename);
        END;
        CREATE TRIGGER files_fts_ad AFTER DELETE ON files BEGIN
            INSERT INTO files_path_fts(files_path_fts, rowid, path, filename)
            VALUES ('delete', old.id, old.path, old.filename);
        END;
        CREATE TRIGGER files_fts_au AFTER UPDATE ON files BEGIN
            INSERT INTO files_path_fts(files_path_fts, rowid, path, filename)
            VALUES ('delete', old.id, old.path, old.filename);
            INSERT INTO files_path_fts(rowid, path, filename)
            VALUES (new.id, new.path, new.filename);
        END;

        CREATE TABLE folders (
            id INTEGER PRIMARY KEY,
            path TEXT UNIQUE NOT NULL,
            included INTEGER NOT NULL,
            time_added TEXT NOT NULL
        );

        CREATE TABLE setters (
            id INTEGER PRIMARY KEY,
            name TEXT UNIQUE NOT NULL
        );

        CREATE TABLE data_jobs (
            id INTEGER PRIMARY KEY,
            completed INTEGER NOT NULL DEFAULT 0
        );

        CREATE TABLE data_log (
            id INTEGER PRIMARY KEY,
            job_id INTEGER REFERENCES data_jobs(id) ON DELETE SET NULL,
            start_time TEXT NOT NULL,
            end_time TEXT NOT NULL,
            type TEXT NOT NULL,
            setter TEXT NOT NULL,
            threshold REAL,
            batch_size INTEGER NOT NULL,
            image_files INTEGER NOT NULL DEFAULT 0,
            video_files INTEGER NOT NULL DEFAULT 0,
            other_files INTEGER NOT NULL DEFAULT 0,
            total_segments INTEGER NOT NULL DEFAULT 0,
            errors INTEGER NOT NULL DEFAULT 0,
            total_remaining INTEGER NOT NULL DEFAULT 0,
            data_load_time REAL DEFAULT 0,
            inference_time REAL DEFAULT 0,
            completed INTEGER NOT NULL DEFAULT 0
        );
        CREATE INDEX data_log_setter ON data_log(setter);
        CREATE INDEX data_log_job ON data_log(job_id);

        CREATE TABLE file_scans (
            id INTEGER PRIMARY KEY,
            start_time TEXT NOT NULL,
            end_time TEXT,
            path TEXT NOT NULL,
            total_available INTEGER NOT NULL DEFAULT 0,
            new_items INTEGER NOT NULL DEFAULT 0,
            unchanged_files INTEGER NOT NULL DEFAULT 0,
            new_files INTEGER NOT NULL DEFAULT 0,
            modified_files INTEGER NOT NULL DEFAULT 0,
            marked_unavailable INTEGER NOT NULL DEFAULT 0,
            errors INTEGER NOT NULL DEFAULT 0,
            false_changes INTEGER NOT NULL DEFAULT 0,
            metadata_time REAL DEFAULT 0,
            hashing_time REAL DEFAULT 0,
            thumbgen_time REAL DEFAULT 0,
            blurhash_time REAL DEFAULT 0
        );

        CREATE TABLE item_data (
            id INTEGER PRIMARY KEY,
            item_id INTEGER NOT NULL REFERENCES items(id) ON DELETE CASCADE,
            job_id INTEGER REFERENCES data_jobs(id) ON DELETE CASCADE,
            setter_id INTEGER NOT NULL REFERENCES setters(id) ON DELETE CASCADE,
            data_type TEXT NOT NULL,
            idx INTEGER NOT NULL,
            source_id INTEGER REFERENCES item_data(id) ON DELETE CASCADE,
            is_origin INTEGER,
            is_placeholder INTEGER,
            UNIQUE(item_id, setter_id, data_type, idx, is_origin),
            UNIQUE(item_id, setter_id, data_type, idx, source_id),
            CHECK ((is_origin = 1 AND source_id IS NULL)
                OR (is_origin IS NULL AND source_id IS NOT NULL))
        );
        CREATE INDEX item_data_item ON item_data(item_id);
        CREATE INDEX item_data_setter_type ON item_data(setter_id, data_type);
        CREATE INDEX item_data_source ON item_data(source_id);

        CREATE TABLE extracted_text (
            id INTEGER PRIMARY KEY REFERENCES item_data(id) ON DELETE CASCADE,
            language TEXT,
            language_confidence REAL,
            confidence REAL,
            text TEXT NOT NULL,
            text_length INTEGER
        );
        CREATE INDEX extracted_text_conf ON extracted_text(confidence);
        CREATE INDEX extracted_text_lang ON extracted_text(language);

        CREATE VIRTUAL TABLE extracted_text_fts USING fts5(
            text,
            content='extracted_text', content_rowid='id',
            tokenize='trigram case_sensitive 0'
        );
        CREATE TRIGGER ext_text_fts_ai AFTER INSERT ON extracted_text BEGIN
            INSERT INTO extracted_text_fts(rowid, text) VALUES (new.id, new.text);
        END;
        CREATE TRIGGER ext_text_fts_ad AFTER DELETE ON extracted_text BEGIN
            INSERT INTO extracted_text_fts(extracted_text_fts, rowid, text)
            VALUES ('delete', old.id, old.text);
        END;
        CREATE TRIGGER ext_text_fts_au AFTER UPDATE ON extracted_text BEGIN
            INSERT INTO extracted_text_fts(extracted_text_fts, rowid, text)
            VALUES ('delete', old.id, old.text);
            INSERT INTO extracted_text_fts(rowid, text) VALUES (new.id, new.text);
        END;

        CREATE TABLE embeddings (
            id INTEGER PRIMARY KEY REFERENCES item_data(id) ON DELETE CASCADE,
            embedding BLOB NOT NULL
        );

        CREATE TABLE tags (
            id INTEGER PRIMARY KEY,
            namespace TEXT NOT NULL,
            name TEXT NOT NULL,
            item_count INTEGER NOT NULL DEFAULT 0,
            UNIQUE(namespace, name)
        );
        CREATE TABLE tags_items (
            item_data_id INTEGER NOT NULL REFERENCES item_data(id) ON DELETE CASCADE,
            tag_id INTEGER NOT NULL REFERENCES tags(id) ON DELETE CASCADE,
            item_id INTEGER NOT NULL REFERENCES items(id) ON DELETE CASCADE,
            confidence REAL DEFAULT 1.0,
            UNIQUE(item_data_id, tag_id)
        );
        CREATE INDEX tags_items_tag ON tags_items(tag_id);
        CREATE INDEX tags_items_item ON tags_items(item_id);

        CREATE TABLE vector_quant_profiles (
            id INTEGER PRIMARY KEY,
            name TEXT UNIQUE NOT NULL,
            quantizer TEXT NOT NULL,
            options TEXT,
            state TEXT NOT NULL,
            is_default INTEGER NOT NULL DEFAULT 0
        );
        CREATE TABLE vector_quant_coverage (
            profile_id INTEGER NOT NULL
                REFERENCES vector_quant_profiles(id) ON DELETE CASCADE,
            setter_id INTEGER NOT NULL
                REFERENCES setters(id) ON DELETE CASCADE,
            needs_artifact INTEGER NOT NULL DEFAULT 1,
            artifact BLOB,
            artifact_rev INTEGER NOT NULL DEFAULT 0,
            n_at_artifact INTEGER,
            dim INTEGER,
            metric TEXT,
            state TEXT NOT NULL DEFAULT 'pending',
            PRIMARY KEY (profile_id, setter_id)
        );

        CREATE TABLE extraction_errors (
            id INTEGER PRIMARY KEY,
            item_id INTEGER NOT NULL REFERENCES items(id) ON DELETE CASCADE,
            setter_name TEXT NOT NULL,
            stage TEXT NOT NULL,
            error_class TEXT NOT NULL,     -- 'input' | 'transient'
            message TEXT,
            blocker TEXT,                  -- missing host dependency, if any
            attempts INTEGER NOT NULL DEFAULT 1,
            first_seen TEXT NOT NULL,
            last_seen TEXT NOT NULL,
            UNIQUE(item_id, setter_name)
        );
        CREATE INDEX extraction_errors_setter ON extraction_errors(setter_name);

        CREATE TABLE scan_errors (
            id INTEGER PRIMARY KEY,
            path TEXT NOT NULL,
            stage TEXT NOT NULL,
            error_class TEXT NOT NULL,
            message TEXT,
            blocker TEXT,
            attempts INTEGER NOT NULL DEFAULT 1,
            first_seen TEXT NOT NULL,
            last_seen TEXT NOT NULL,
            UNIQUE(path, stage)
        );

        CREATE TABLE system_config (
            key TEXT PRIMARY KEY,
            value TEXT NOT NULL
        );

        CREATE TABLE maintenance_state (
            key TEXT PRIMARY KEY,
            value TEXT NOT NULL
        );
        """,
    ),
    (
        2,
        # Base-snapshot change log: every write that can alter a PQL base
        # row logs the affected item id; the executor applies these as an
        # incremental delta (tombstone + refetch) instead of
        # re-materializing the whole base per epoch (the reference's caches
        # invalidate but its query path never re-scans the world —
        # search_cache.rs epoch discipline). item_id NULL = global change
        # (e.g. setter rename reflected in joined columns) → full rebuild.
        #
        # Item-level granularity deliberately over-approximates: FK
        # cascades (item_data/extracted_text under a deleted item) may not
        # fire row triggers, but the item-level rows logged here cover
        # everything beneath them.
        """
        CREATE TABLE base_change_log (
            seq INTEGER PRIMARY KEY AUTOINCREMENT,
            item_id INTEGER
        );
        CREATE TRIGGER bcl_files_ai AFTER INSERT ON files BEGIN
            INSERT INTO base_change_log(item_id) VALUES (new.item_id);
        END;
        CREATE TRIGGER bcl_files_au AFTER UPDATE ON files BEGIN
            INSERT INTO base_change_log(item_id) VALUES (new.item_id);
            INSERT INTO base_change_log(item_id)
            SELECT old.item_id WHERE old.item_id != new.item_id;
        END;
        CREATE TRIGGER bcl_files_ad AFTER DELETE ON files BEGIN
            INSERT INTO base_change_log(item_id) VALUES (old.item_id);
        END;
        CREATE TRIGGER bcl_items_au AFTER UPDATE ON items BEGIN
            INSERT INTO base_change_log(item_id) VALUES (new.id);
        END;
        CREATE TRIGGER bcl_items_ad AFTER DELETE ON items BEGIN
            INSERT INTO base_change_log(item_id) VALUES (old.id);
        END;
        CREATE TRIGGER bcl_item_data_ai AFTER INSERT ON item_data BEGIN
            INSERT INTO base_change_log(item_id) VALUES (new.item_id);
        END;
        CREATE TRIGGER bcl_item_data_au AFTER UPDATE ON item_data BEGIN
            INSERT INTO base_change_log(item_id) VALUES (new.item_id);
        END;
        CREATE TRIGGER bcl_item_data_ad AFTER DELETE ON item_data BEGIN
            INSERT INTO base_change_log(item_id) VALUES (old.item_id);
        END;
        CREATE TRIGGER bcl_text_ai AFTER INSERT ON extracted_text BEGIN
            INSERT INTO base_change_log(item_id)
            SELECT item_id FROM item_data WHERE id = new.id;
        END;
        CREATE TRIGGER bcl_text_au AFTER UPDATE ON extracted_text BEGIN
            INSERT INTO base_change_log(item_id)
            SELECT item_id FROM item_data WHERE id = new.id;
        END;
        CREATE TRIGGER bcl_text_ad AFTER DELETE ON extracted_text BEGIN
            INSERT INTO base_change_log(item_id)
            SELECT item_id FROM item_data WHERE id = old.id;
        END;
        CREATE TRIGGER bcl_setters_au AFTER UPDATE ON setters BEGIN
            INSERT INTO base_change_log(item_id) VALUES (NULL);
        END;
        """,
    ),
]

STORAGE_MIGRATIONS: list[tuple[int, str]] = [
    (
        1,
        """
        CREATE TABLE thumbnails (
            id INTEGER PRIMARY KEY,
            item_sha256 TEXT NOT NULL,
            idx INTEGER NOT NULL,
            item_mime_type TEXT NOT NULL,
            width INTEGER NOT NULL,
            height INTEGER NOT NULL,
            version INTEGER NOT NULL,
            thumbnail BLOB NOT NULL,
            UNIQUE(item_sha256, idx)
        );
        CREATE TABLE frames (
            id INTEGER PRIMARY KEY,
            item_sha256 TEXT NOT NULL,
            idx INTEGER NOT NULL,
            item_mime_type TEXT NOT NULL,
            width INTEGER NOT NULL,
            height INTEGER NOT NULL,
            version INTEGER NOT NULL,
            frame BLOB NOT NULL,
            UNIQUE(item_sha256, idx)
        );
        CREATE TABLE visual_attempts (
            id INTEGER PRIMARY KEY,
            item_sha256 TEXT NOT NULL,
            kind TEXT NOT NULL,            -- 'thumbnail' | 'frames'
            version INTEGER NOT NULL,
            outcome TEXT NOT NULL,         -- 'ok' | 'failed' | 'blocked'
            message TEXT,
            time TEXT NOT NULL,
            UNIQUE(item_sha256, kind)
        );
        """,
    ),
]

USER_DATA_MIGRATIONS: list[tuple[int, str]] = [
    (
        1,
        """
        CREATE TABLE bookmarks (
            user TEXT NOT NULL,
            namespace TEXT NOT NULL,
            sha256 TEXT NOT NULL,
            time_added TEXT NOT NULL,
            metadata TEXT,
            PRIMARY KEY (user, namespace, sha256)
        );
        CREATE INDEX bookmarks_sha ON bookmarks(sha256);
        CREATE INDEX bookmarks_ns ON bookmarks(namespace);

        CREATE TABLE pinboards (
            id INTEGER PRIMARY KEY,
            user TEXT NOT NULL,
            name TEXT,
            head_version_id INTEGER,
            time_added TEXT NOT NULL,
            time_updated TEXT NOT NULL
        );
        CREATE TABLE pinboard_versions (
            id INTEGER PRIMARY KEY,
            pinboard_id INTEGER NOT NULL REFERENCES pinboards(id),
            layout TEXT NOT NULL CHECK (json_valid(layout)),
            name_at_save TEXT,
            preview BLOB,
            preview_w INTEGER,
            preview_h INTEGER,
            screenful_h INTEGER,
            time_added TEXT NOT NULL
        );
        CREATE INDEX pinboard_versions_board ON pinboard_versions(pinboard_id, id);
        CREATE TABLE pinboard_version_items (
            version_id INTEGER NOT NULL REFERENCES pinboard_versions(id),
            sha256 TEXT NOT NULL,
            PRIMARY KEY (version_id, sha256)
        ) WITHOUT ROWID;
        """,
    ),
]

FAMILIES = {
    "index": INDEX_MIGRATIONS,
    "storage": STORAGE_MIGRATIONS,
    "user_data": USER_DATA_MIGRATIONS,
}


def migrate(conn: sqlite3.Connection, family: str) -> int:
    """Apply this family's missing migrations; returns the final version."""
    migrations = FAMILIES[family]
    conn.execute(
        "CREATE TABLE IF NOT EXISTS schema_version (version INTEGER NOT NULL)"
    )
    row = conn.execute("SELECT MAX(version) FROM schema_version").fetchone()
    current = row[0] or 0
    for version, sql in migrations:
        if version <= current:
            continue
        with conn:
            conn.executescript(sql)
            conn.execute("INSERT INTO schema_version(version) VALUES (?)", (version,))
        current = version
    return current
