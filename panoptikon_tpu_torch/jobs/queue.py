"""Serialized job queue: one batch job per database at a time.

The port's copy of ``panoptikon_tpu/jobs/queue.py``, held to it unit for unit
by ``tests/test_torch_host_copies.py``: host code only, with imports of the
port.

The reference's queue/runner actor pair (jobs/queue.rs:353-413) reduced to
its semantics: jobs on one database run strictly one at a time (this
serialization is the mutex the reconcile job relies on); duplicate pending
jobs dedupe; cancellation is cooperative (jobs poll ``JobHandle.cancelled``);
boundary maintenance owed by data-changing jobs (ANALYZE, tag recount, WAL
checkpoint) is synthesized as a job at the BACK of the queue so one
maintenance pass serves a whole burst of batch jobs
(docs/job-boundary-scheduling-design.md).
"""

from __future__ import annotations

import enum
import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Callable, Optional


class JobType(str, enum.Enum):
    DATA_EXTRACTION = "data_extraction"
    DATA_DELETION = "data_deletion"
    FOLDER_RESCAN = "folder_rescan"
    FOLDER_UPDATE = "folder_update"
    JOB_DATA_DELETION = "job_data_deletion"
    VECTOR_QUANT_RECONCILE = "vector_quant_reconcile"
    DB_MAINTENANCE = "db_maintenance"


@dataclass
class ChangeSummary:
    """Owed-maintenance accounting (queue.rs:48-58)."""

    wrote_data: bool = False
    tags_dirty: bool = False
    needs_analyze: bool = False

    def merge(self, other: "ChangeSummary") -> None:
        self.wrote_data |= other.wrote_data
        self.tags_dirty |= other.tags_dirty
        self.needs_analyze |= other.needs_analyze

    @property
    def any(self) -> bool:
        return self.wrote_data or self.tags_dirty or self.needs_analyze

    def to_dict(self) -> dict:
        return {"wrote_data": self.wrote_data, "tags_dirty": self.tags_dirty,
                "needs_analyze": self.needs_analyze}

    @classmethod
    def from_dict(cls, d: dict) -> "ChangeSummary":
        return cls(bool(d.get("wrote_data")), bool(d.get("tags_dirty")),
                   bool(d.get("needs_analyze")))


@dataclass
class JobHandle:
    job_id: int
    job_type: JobType
    db_name: str
    params: dict = field(default_factory=dict)
    state: str = "pending"  # pending | running | completed | failed | cancelled
    error: Optional[str] = None
    enqueued_at: float = field(default_factory=time.time)
    started_at: Optional[float] = None
    finished_at: Optional[float] = None
    _cancel: threading.Event = field(default_factory=threading.Event)
    result: Any = None

    @property
    def cancelled(self) -> bool:
        return self._cancel.is_set()

    def cancel(self) -> None:
        self._cancel.set()

    def dedupe_key(self) -> tuple:
        return (self.db_name, self.job_type, tuple(sorted(
            (k, str(v)) for k, v in self.params.items()
        )))


JobRunner = Callable[[JobHandle], Optional[ChangeSummary]]


class JobQueue:
    """One runner thread per database; jobs execute strictly serially."""

    def __init__(self, runners: dict[JobType, JobRunner], persist_owed=None):
        """``persist_owed(db_name, summary_dict | None)`` makes owed
        maintenance DURABLE (the reference's maintenance_state marker,
        job-boundary doc:5-9): called with the merged summary whenever owed
        work accrues, and with None once the maintenance job that repays it
        completes. A killed process re-seeds from storage via seed_owed."""
        self.runners = runners
        self._persist_owed = persist_owed
        self._lock = threading.Lock()
        self._queues: dict[str, list[JobHandle]] = {}
        self._history: dict[str, list[JobHandle]] = {}
        self._running: dict[str, Optional[JobHandle]] = {}
        self._threads: dict[str, threading.Thread] = {}
        self._wake: dict[str, threading.Event] = {}
        self._owed: dict[str, ChangeSummary] = {}
        # Earliest time a FAILED maintenance job may resynthesize per DB.
        self._maint_retry_at: dict[str, float] = {}
        self._next_id = 1
        self._shutdown = False

    def enqueue(self, db_name: str, job_type: JobType, params: dict | None = None) -> JobHandle:
        with self._lock:
            if self._shutdown:
                raise RuntimeError("queue is shut down")
            handle = JobHandle(
                job_id=self._next_id,
                job_type=job_type,
                db_name=db_name,
                params=params or {},
            )
            queue = self._queues.setdefault(db_name, [])
            # Dedupe identical pending jobs (queue.rs batch dedup).
            for pending in queue:
                if pending.dedupe_key() == handle.dedupe_key():
                    return pending
            self._next_id += 1
            queue.append(handle)
            self._ensure_thread(db_name)
            self._wake[db_name].set()
            return handle

    def cancel(self, db_name: str, job_id: int) -> bool:
        with self._lock:
            for handle in self._queues.get(db_name, []):
                if handle.job_id == job_id:
                    handle.state = "cancelled"
                    handle._cancel.set()
                    self._queues[db_name].remove(handle)
                    self._history.setdefault(db_name, []).append(handle)
                    return True
            running = self._running.get(db_name)
            if running is not None and running.job_id == job_id:
                running.cancel()
                return True
        return False

    def status(self, db_name: str) -> dict:
        with self._lock:
            running = self._running.get(db_name)
            return {
                "running": _job_view(running) if running else None,
                "pending": [_job_view(h) for h in self._queues.get(db_name, [])],
                "history": [_job_view(h) for h in self._history.get(db_name, [])[-50:]],
            }

    def wait_idle(self, db_name: str, timeout: float = 60.0) -> bool:
        deadline = time.time() + timeout
        while time.time() < deadline:
            with self._lock:
                if not self._queues.get(db_name) and self._running.get(db_name) is None:
                    return True
            time.sleep(0.01)
        return False

    def shutdown(self) -> None:
        with self._lock:
            self._shutdown = True
            for handle in list(self._running.values()):
                if handle:
                    handle.cancel()
            for event in self._wake.values():
                event.set()
        for thread in list(self._threads.values()):
            thread.join(timeout=30)

    def seed_owed(self, db_name: str, summary: ChangeSummary) -> None:
        """Re-arm owed maintenance recovered from durable storage (called
        at DB open after a restart)."""
        if not summary.any:
            return
        self._ensure_thread(db_name)
        with self._lock:
            self._owed.setdefault(db_name, ChangeSummary()).merge(summary)
            self._wake[db_name].set()

    def _persist(self, db_name: str, snapshot) -> None:
        if self._persist_owed is None:
            return
        try:
            self._persist_owed(db_name, snapshot)
        except Exception:  # pragma: no cover — persistence is best-effort
            pass

    # -- internals ----------------------------------------------------------

    def _ensure_thread(self, db_name: str) -> None:
        if db_name not in self._threads or not self._threads[db_name].is_alive():
            self._wake.setdefault(db_name, threading.Event())
            thread = threading.Thread(
                target=self._run_loop, args=(db_name,), name=f"jobs-{db_name}",
                daemon=True,
            )
            self._threads[db_name] = thread
            thread.start()

    def _run_loop(self, db_name: str) -> None:
        while True:
            handle: Optional[JobHandle] = None
            with self._lock:
                if self._shutdown:
                    return
                queue = self._queues.setdefault(db_name, [])
                if not queue:
                    # Owed maintenance at the back of an emptied queue.
                    retry_at = self._maint_retry_at.get(db_name, 0.0)
                    owed = (
                        self._owed.pop(db_name, None)
                        if time.time() >= retry_at else None
                    )
                    if owed is not None and owed.any and JobType.DB_MAINTENANCE in self.runners:
                        queue.append(
                            JobHandle(
                                job_id=self._next_id,
                                job_type=JobType.DB_MAINTENANCE,
                                db_name=db_name,
                                params={"summary": owed},
                            )
                        )
                        self._next_id += 1
                    else:
                        self._wake[db_name].clear()
                if queue:
                    handle = queue.pop(0)
                    handle.state = "running"
                    handle.started_at = time.time()
                    self._running[db_name] = handle
            if handle is None:
                self._wake[db_name].wait(timeout=5.0)
                continue
            runner = self.runners.get(handle.job_type)
            try:
                if handle.cancelled:
                    handle.state = "cancelled"
                elif runner is None:
                    raise RuntimeError(f"no runner for {handle.job_type}")
                else:
                    summary = runner(handle)
                    handle.state = "cancelled" if handle.cancelled else "completed"
                    if summary is not None and summary.any:
                        with self._lock:
                            merged = self._owed.setdefault(db_name, ChangeSummary())
                            merged.merge(summary)
                            snapshot = merged.to_dict()
                        self._persist(db_name, snapshot)
                    if (
                        handle.job_type is JobType.DB_MAINTENANCE
                        and handle.state == "completed"
                    ):
                        # Owed work repaid — clear the durable marker.
                        self._persist(db_name, None)
            except Exception as exc:
                handle.state = "failed"
                handle.error = f"{exc}\n{traceback.format_exc(limit=5)}"
                if handle.job_type is JobType.DB_MAINTENANCE:
                    # The owed summary was popped to synthesize this job —
                    # a failure (transient SQLITE_BUSY, disk full) must
                    # re-merge it so the debt retries in-process, matching
                    # the durable marker that still records it on disk.
                    owed = handle.params.get("summary")
                    if owed is not None and owed.any:
                        with self._lock:
                            merged = self._owed.setdefault(
                                db_name, ChangeSummary()
                            )
                            merged.merge(owed)
                            # Back off before resynthesizing, or a
                            # persistent failure (disk full) spins.
                            self._maint_retry_at[db_name] = time.time() + 60.0
            finally:
                handle.finished_at = time.time()
                with self._lock:
                    self._running[db_name] = None
                    self._history.setdefault(db_name, []).append(handle)


def _job_view(handle: JobHandle) -> dict:
    return {
        "job_id": handle.job_id,
        "type": handle.job_type.value,
        "state": handle.state,
        "error": handle.error.splitlines()[0] if handle.error else None,
        "params": {k: v for k, v in handle.params.items() if k != "summary"},
        "enqueued_at": handle.enqueued_at,
        "started_at": handle.started_at,
        "finished_at": handle.finished_at,
    }
