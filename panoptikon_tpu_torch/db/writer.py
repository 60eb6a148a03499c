"""The single-writer actor: all index-DB writes for one database flow
through one thread.

This is the structural race-exclusion the reference builds around SQLite
(db/index_writer.rs): exactly one writer connection per index DB, writes
serialized through a queue, one epoch bump per committed unit, and idle
spin-down so unused databases hold no connection. Readers never contend;
cache validity is the epoch (``db.epochs``), bumped only on commit.

Usage::

    writer = IndexWriter(database)
    item_id = writer.call(lambda conn: store.upsert_item(conn, ...))

``call`` blocks for the result (the reference's actor ``call``); ``cast``
fires and forgets. Exceptions propagate to the caller; the unit's
transaction is rolled back and the epoch is NOT bumped.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import Future
from typing import Callable, Optional, TypeVar

from panoptikon_tpu_torch.db.connection import Database
from panoptikon_tpu_torch.db.epochs import EPOCHS

T = TypeVar("T")

IDLE_TIMEOUT_S = 60.0


class IndexWriter:
    def __init__(self, db: Database, idle_timeout: float = IDLE_TIMEOUT_S):
        self.db = db
        self.idle_timeout = idle_timeout
        self._queue: "queue.Queue[Optional[tuple[Callable, Future]]]" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._closed = False

    def call(self, unit: Callable[["sqlite3.Connection"], T]) -> T:  # noqa: F821
        """Run one write unit on the writer thread; block for its result."""
        return self.submit(unit).result()

    def cast(self, unit: Callable) -> Future:
        """Fire-and-forget write unit."""
        return self.submit(unit)

    def submit(self, unit: Callable) -> Future:
        if self._closed:
            raise RuntimeError("writer is closed")
        fut: Future = Future()
        self._queue.put((unit, fut))
        self._ensure_thread()
        return fut

    def close(self) -> None:
        """Flush pending units and stop the thread (graceful shutdown)."""
        with self._lock:
            self._closed = True
            thread = self._thread
        if thread is not None:
            self._queue.put(None)
            thread.join()

    # -- internals ----------------------------------------------------------

    def _ensure_thread(self) -> None:
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._run, name=f"index-writer-{self.db.name}", daemon=True
                )
                self._thread.start()

    def _run(self) -> None:
        conn = self.db.write_connection()
        try:
            while True:
                try:
                    entry = self._queue.get(timeout=self.idle_timeout)
                except queue.Empty:
                    # Idle spin-down: release the connection; a later submit
                    # restarts the thread (index_writer.rs idle-timeout).
                    with self._lock:
                        if self._queue.empty():
                            self._thread = None
                            return
                    continue
                if entry is None:
                    return
                unit, fut = entry
                try:
                    with conn:  # one transaction per unit
                        result = unit(conn)
                except BaseException as exc:  # propagate to caller
                    fut.set_exception(exc)
                else:
                    EPOCHS.bump_index(self.db.name)
                    fut.set_result(result)
        finally:
            conn.close()


class WriterRegistry:
    """One IndexWriter per named database."""

    def __init__(self) -> None:
        self._writers: dict[str, IndexWriter] = {}
        self._lock = threading.Lock()

    def get(self, db: Database) -> IndexWriter:
        with self._lock:
            w = self._writers.get(db.name)
            if w is None:
                w = IndexWriter(db)
                self._writers[db.name] = w
            return w

    def close_all(self) -> None:
        with self._lock:
            writers = list(self._writers.values())
            self._writers.clear()
        for w in writers:
            w.close()
