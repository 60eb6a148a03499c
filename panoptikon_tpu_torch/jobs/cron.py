"""Cron scheduler: minute-tick over every database's configured jobs.

The port's copy of ``panoptikon_tpu/jobs/cron.py``, held to it unit for unit by
``tests/test_torch_host_copies.py``.

Reference semantics (jobs/cron.rs:1-14): schedules live in per-DB system
config (``cron_jobs``: list of {schedule, job, params}); the scheduler
ticks once a minute, runs jobs whose schedule matches the CURRENT minute,
and deliberately does NOT catch up runs missed while the process was down.

Schedule syntax: 5-field cron (minute hour dom month dow) with ``*``,
``*/n``, single values and comma lists — the subset the reference's croner
usage exercises.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

from panoptikon_tpu_torch.db import store
from panoptikon_tpu_torch.db.connection import Database
from panoptikon_tpu_torch.jobs.queue import JobQueue, JobType


def _field_matches(spec: str, value: int) -> bool:
    if spec == "*":
        return True
    for part in spec.split(","):
        if part.startswith("*/"):
            try:
                step = int(part[2:])
            except ValueError:
                return False
            if step > 0 and value % step == 0:
                return True
        elif "-" in part:
            try:
                lo, hi = part.split("-", 1)
                if int(lo) <= value <= int(hi):
                    return True
            except ValueError:
                return False
        else:
            try:
                if int(part) == value:
                    return True
            except ValueError:
                return False
    return False


def cron_matches(schedule: str, when: time.struct_time) -> bool:
    fields = schedule.split()
    if len(fields) != 5:
        return False
    minute, hour, dom, month, dow = fields
    # Standard cron day-of-week: Sunday = 0 (and 7); struct_time's
    # tm_wday is Monday = 0 — translate, or every weekly schedule fires
    # one day late and '* * * * 7' never matches.
    cron_dow = (when.tm_wday + 1) % 7
    return (
        _field_matches(minute, when.tm_min)
        and _field_matches(hour, when.tm_hour)
        and _field_matches(dom, when.tm_mday)
        and _field_matches(month, when.tm_mon)
        and (_field_matches(dow, cron_dow)
             or (cron_dow == 0 and _field_matches(dow, 7)))
    )


def schedule_valid(schedule: str) -> bool:
    """Structural parse check: 5 fields, each '*'/list/range/step of ints
    (the reference validates via croner; api/jobs.rs:1132)."""
    fields = schedule.split()
    if len(fields) != 5:
        return False
    for f in fields:
        for part in f.split(","):
            if part == "*":
                continue
            body = part[2:] if part.startswith("*/") else part
            pieces = body.split("-", 1) if "-" in body else [body]
            try:
                for p in pieces:
                    int(p)
            except ValueError:
                return False
    return True


def next_match(
    schedule: str, after: Optional[float] = None, horizon_days: int = 8
) -> Optional[str]:
    """Next minute the schedule fires after ``after`` (local, ISO string),
    scanned minute-by-minute up to ``horizon_days`` out — covers every
    weekly pattern; monthly patterns beyond the horizon report None rather
    than paying a year-long scan (api/jobs.rs CronScheduleResponse
    next_run)."""
    if not schedule_valid(schedule):
        return None
    t = (after if after is not None else time.time()) // 60 * 60 + 60
    for _ in range(horizon_days * 24 * 60):
        when = time.localtime(t)
        if cron_matches(schedule, when):
            return time.strftime("%Y-%m-%dT%H:%M:%S", when)
        t += 60
    return None


@dataclass
class CronEntry:
    schedule: str
    job: str
    params: dict


class CronScheduler:
    def __init__(
        self,
        databases: Callable[[], list[Database]],
        queue: JobQueue,
        tick_seconds: float = 60.0,
    ):
        self.databases = databases
        self.queue = queue
        self.tick_seconds = tick_seconds
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_minute: Optional[int] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, name="cron", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)

    def tick(self, now: Optional[float] = None) -> list[tuple[str, str]]:
        """One scheduler tick; returns (db, job) pairs enqueued. Exposed for
        tests and for the no-catch-up contract: only the current minute is
        consulted."""
        when = time.localtime(now if now is not None else time.time())
        minute_key = when.tm_min + 60 * when.tm_hour
        if self._last_minute == minute_key:
            return []
        self._last_minute = minute_key
        fired = []
        for db in self.databases():
            for entry in self.entries(db):
                if cron_matches(entry.schedule, when):
                    try:
                        job_type = JobType(entry.job)
                    except ValueError:
                        continue
                    self.queue.enqueue(db.name, job_type, entry.params)
                    fired.append((db.name, entry.job))
        return fired

    @staticmethod
    def entries(db: Database) -> list[CronEntry]:
        raw = store.get_config(db.reader(), "cron_jobs", []) or []
        out = []
        for item in raw:
            if not isinstance(item, dict):
                continue
            schedule = item.get("schedule")
            job = item.get("job")
            if isinstance(schedule, str) and isinstance(job, str):
                out.append(
                    CronEntry(schedule=schedule, job=job, params=item.get("params") or {})
                )
        return out

    def _loop(self) -> None:
        # Align each wait to the NEXT minute boundary: a fixed 60 s wait
        # plus tick work drifts past boundaries and silently skips the
        # minute in between (its jobs then never fire — the no-catch-up
        # contract covers downtime, not a running scheduler).
        while True:
            now = time.time()
            delay = self.tick_seconds - (now % self.tick_seconds) + 0.05
            if self._stop.wait(delay):
                return
            try:
                self.tick()
            except Exception:
                logging.getLogger("panoptikon_tpu_torch.cron").exception(
                    "cron tick failed"
                )
