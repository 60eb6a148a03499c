"""Continuous scanning: per-folder change polling with settle delays.

The port's copy of ``panoptikon_tpu/jobs/continuous.py``, held to it unit for unit by
``tests/test_torch_host_copies.py``.

The reference pairs a filesystem-notify watcher with a settle-delay poller
and a debounced full resync (jobs/continuous_scan.rs + dir_poller.rs:
poller settle delay 2s→60s backoff, 300s resync interval, deletion
threshold guard). This environment has no inotify binding baked in, so the
poller IS the watcher here; the contract is the same:

- a lightweight snapshot (path → (mtime, size)) diffed per tick;
- a change starts a settle window — rescans fire only after the tree has
  been quiet for the settle delay (uploads finish before hashing starts);
- the poll interval backs off 2s → 60s while quiet, snaps back on change;
- the snapshot seeds from the DB on start (dir_poller seed_snapshot), so
  a restart doesn't re-trigger a full change storm;
- a deletion-threshold guard skips auto-unavailable marking when more
  than the configured fraction of known files vanish at once (likely an
  unmounted share, not a deletion).
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

from panoptikon_tpu_torch.db import store
from panoptikon_tpu_torch.db.connection import Database
from panoptikon_tpu_torch.jobs.queue import JobQueue, JobType
from panoptikon_tpu_torch.jobs.scan import JUNK_DIRS

MIN_POLL_S = 2.0
MAX_POLL_S = 60.0
SETTLE_S = 2.0
DELETION_THRESHOLD = 0.5
# Guard-tripping snapshots identical across this many consecutive polls
# are accepted as a real deletion (vs a transient unmount).
GUARD_ACCEPT_POLLS = 5


def take_snapshot(roots: list[str]) -> dict[str, tuple[float, int]]:
    snap: dict[str, tuple[float, int]] = {}
    for root in roots:
        if not Path(root).is_dir():
            continue
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = [
                d for d in dirnames if d not in JUNK_DIRS and not d.startswith(".")
            ]
            for name in filenames:
                if name.startswith("."):
                    continue
                path = os.path.join(dirpath, name)
                try:
                    st = os.stat(path)
                    snap[path] = (st.st_mtime, st.st_size)
                except OSError:
                    continue
    return snap


def seed_snapshot(db: Database) -> dict[str, tuple[float, int]]:
    """Seed from the DB so a restart sees no phantom changes. A DB-known
    file that fails os.stat (deleted while the process was down) seeds a
    sentinel entry so the FIRST poll sees it as vanished — silently
    dropping it would hide the deletion forever."""
    snap = {}
    conn = db.reader()
    for path, in conn.execute(
        "SELECT path FROM files WHERE available = 1"
    ).fetchall():
        try:
            st = os.stat(path)
            snap[path] = (st.st_mtime, st.st_size)
        except OSError:
            snap[path] = (-1.0, -1)
    return snap


@dataclass
class FolderSupervisor:
    db: Database
    queue: JobQueue
    deletion_threshold: float = DELETION_THRESHOLD
    _thread: Optional[threading.Thread] = None
    _stop: threading.Event = field(default_factory=threading.Event)
    last_change_at: Optional[float] = None
    rescans_triggered: int = 0
    deletion_guard_trips: int = 0

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, name=f"continuous-{self.db.name}", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)

    def _roots(self) -> list[str]:
        return [p for p, inc in store.list_folders(self.db.reader(), included=True)]

    def check_once(
        self, prev: dict[str, tuple[float, int]]
    ) -> tuple[dict[str, tuple[float, int]], bool, bool]:
        """One poll: returns (new_snapshot, changed, deletion_guard_hit)."""
        roots = self._roots()
        snap = take_snapshot(roots)
        if snap == prev:
            return snap, False, False
        vanished = len(set(prev) - set(snap))
        guard = bool(prev) and vanished / max(len(prev), 1) > self.deletion_threshold
        return snap, True, guard

    def _loop(self) -> None:
        prev = seed_snapshot(self.db)
        interval = MIN_POLL_S
        pending_since: Optional[float] = None
        guard_snap: Optional[dict] = None
        guard_stable = 0
        while not self._stop.wait(interval):
            snap, changed, guard = self.check_once(prev)
            if guard:
                # Mass-vanish: do not auto-mark; likely an unmounted share.
                # But a GENUINE bulk deletion must not wedge the poller
                # forever: accept the smaller tree once it stays identical
                # across several backoff polls, then rescan normally.
                self.deletion_guard_trips += 1
                if guard_snap is not None and snap == guard_snap:
                    guard_stable += 1
                else:
                    guard_snap, guard_stable = snap, 1
                if guard_stable >= GUARD_ACCEPT_POLLS:
                    prev = snap
                    guard_snap, guard_stable = None, 0
                    self.last_change_at = time.time()
                    pending_since = time.time()
                    interval = MIN_POLL_S
                    continue
                interval = min(interval * 2, MAX_POLL_S)
                continue
            guard_snap, guard_stable = None, 0
            if changed:
                self.last_change_at = time.time()
                pending_since = time.time()
                prev = snap
                interval = MIN_POLL_S
                continue
            if pending_since is not None and time.time() - pending_since >= SETTLE_S:
                # Tree quiet for the settle window → rescan.
                self.queue.enqueue(self.db.name, JobType.FOLDER_RESCAN)
                self.rescans_triggered += 1
                pending_since = None
            if pending_since is None:
                interval = min(interval * 2, MAX_POLL_S)


class ContinuousManager:
    """One supervisor per database with continuous scanning enabled in its
    per-DB config (``continuous_scan: {enabled: true}``)."""

    def __init__(self, queue: JobQueue):
        self.queue = queue
        self._supervisors: dict[str, FolderSupervisor] = {}

    def ensure(self, db: Database) -> Optional[FolderSupervisor]:
        cfg = store.get_config(db.reader(), "continuous_scan", {}) or {}
        enabled = bool(cfg.get("enabled", False))
        sup = self._supervisors.get(db.name)
        if enabled and sup is None:
            sup = FolderSupervisor(
                db, self.queue,
                deletion_threshold=float(
                    cfg.get("deletion_threshold", DELETION_THRESHOLD)
                ),
            )
            sup.start()
            self._supervisors[db.name] = sup
        elif not enabled and sup is not None:
            sup.stop()
            del self._supervisors[db.name]
        return self._supervisors.get(db.name)

    def status(self) -> dict:
        return {
            name: {
                "last_change_at": sup.last_change_at,
                "rescans_triggered": sup.rescans_triggered,
                "deletion_guard_trips": sup.deletion_guard_trips,
            }
            for name, sup in self._supervisors.items()
        }

    def stop_all(self) -> None:
        for sup in self._supervisors.values():
            sup.stop()
        self._supervisors.clear()
