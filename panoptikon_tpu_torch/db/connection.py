"""Database handles: one named database = index + storage + user_data files.

Mirrors the reference's connection discipline (db/connection.rs): readers
get read-only connections with the user_data/storage files ATTACHed; ALL
index-DB writes flow through the single writer (``db.writer``). The
``pk_mix`` scalar function is registered on every connection, like the
reference's auto-extension registration (db/sql_functions.rs:1-13), so
seeded random ordering works in any SQL context.
"""

from __future__ import annotations

import os
import sqlite3
import threading
from pathlib import Path

from panoptikon_tpu_torch.db import schema
from panoptikon_tpu_torch.utils.splitmix import pk_mix


def _configure(conn: sqlite3.Connection) -> None:
    conn.execute("PRAGMA journal_mode=WAL")
    conn.execute("PRAGMA synchronous=NORMAL")
    conn.execute("PRAGMA foreign_keys=ON")
    # Deterministic UDF: usable in indexes/generated columns too.
    conn.create_function("pk_mix", 2, pk_mix, deterministic=True)


class Database:
    """Paths + connection factory for one named database."""

    def __init__(self, root: str | os.PathLike, name: str = "default"):
        self.name = name
        self.dir = Path(root) / name
        self.dir.mkdir(parents=True, exist_ok=True)
        self.index_path = self.dir / "index.db"
        self.storage_path = self.dir / "storage.db"
        self.user_data_path = self.dir / "user_data.db"
        self._local = threading.local()
        self.migrate()

    def migrate(self) -> None:
        for path, family in [
            (self.index_path, "index"),
            (self.storage_path, "storage"),
            (self.user_data_path, "user_data"),
        ]:
            conn = sqlite3.connect(path)
            try:
                _configure(conn)
                schema.migrate(conn, family)
            finally:
                conn.close()

    # -- connections --------------------------------------------------------

    def write_connection(self) -> sqlite3.Connection:
        """A read-write index connection (the writer thread's; do not use
        directly — go through ``db.writer``)."""
        conn = sqlite3.connect(self.index_path, timeout=30.0)
        _configure(conn)
        conn.execute(
            "ATTACH DATABASE ? AS storage", (str(self.storage_path),)
        )
        conn.execute(
            "ATTACH DATABASE ? AS user_data", (str(self.user_data_path),)
        )
        return conn

    def read_connection(self, user_data: bool = True) -> sqlite3.Connection:
        """A reader over index (+ storage, + optionally user_data)."""
        conn = sqlite3.connect(
            f"file:{self.index_path}?mode=ro", uri=True, timeout=30.0
        )
        _configure(conn)
        conn.execute(
            "ATTACH DATABASE ? AS storage",
            (f"file:{self.storage_path}?mode=ro",),
        )
        if user_data:
            conn.execute(
                "ATTACH DATABASE ? AS user_data",
                (f"file:{self.user_data_path}?mode=ro",),
            )
        return conn

    def user_data_write_connection(self) -> sqlite3.Connection:
        """user_data writes (bookmarks/pinboards) bypass the index writer —
        they live in their own file with their own epoch."""
        conn = sqlite3.connect(self.user_data_path, timeout=30.0)
        _configure(conn)
        return conn

    def reader(self, user_data: bool = True) -> sqlite3.Connection:
        """Thread-cached read connection (cheap repeated access)."""
        key = f"reader_{user_data}"
        conn = getattr(self._local, key, None)
        if conn is None:
            conn = self.read_connection(user_data=user_data)
            setattr(self._local, key, conn)
        return conn


class DatabaseRegistry:
    """All named databases under one data root (reference: multiple index
    DBs selected per request by policy/DB pinning)."""

    def __init__(self, root: str | os.PathLike):
        self.root = Path(root)
        self._dbs: dict[str, Database] = {}
        self._lock = threading.Lock()

    def get(self, name: str = "default") -> Database:
        with self._lock:
            db = self._dbs.get(name)
            if db is None:
                db = Database(self.root, name)
                self._dbs[name] = db
            return db

    def names(self) -> list[str]:
        found = {p.name for p in self.root.iterdir() if (p / "index.db").exists()} \
            if self.root.exists() else set()
        with self._lock:
            found |= set(self._dbs.keys())
        return sorted(found)
