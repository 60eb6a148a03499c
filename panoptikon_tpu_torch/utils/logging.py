"""Logging + phase timing.

- ``init_logging`` mirrors the reference's precedence (logging.rs:1-41):
  ``PANOPTIKON_LOG`` env overrides the config level; console always, file
  when configured.
- ``PhaseTimer`` is the reference's pipelined-job instrument
  (jobs/timing.rs:4-18): per-phase *work* is the sum of span durations,
  *busy* is the union of open spans, so ``work / busy`` is the phase's
  average parallelism. Extraction logs persist these into data_log.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import defaultdict
from typing import Optional

_LEVELS = {
    "trace": logging.DEBUG,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "warning": logging.WARNING,
    "error": logging.ERROR,
}


def init_logging(level: str = "info", file: Optional[str] = None) -> None:
    level = os.environ.get("PANOPTIKON_LOG", level)
    root = logging.getLogger("panoptikon_tpu_torch")
    root.setLevel(_LEVELS.get(level.lower(), logging.INFO))
    fmt = logging.Formatter(
        "%(asctime)s %(levelname)-7s %(name)s: %(message)s"
    )
    if not root.handlers:
        console = logging.StreamHandler()
        console.setFormatter(fmt)
        root.addHandler(console)
    if file:
        fh = logging.FileHandler(file)
        fh.setFormatter(fmt)
        root.addHandler(fh)


class PhaseTimer:
    """Tracks concurrent spans per phase: work = Σ durations, busy = union.

    ``with timer.span("inference"): ...`` from any thread; ``report()``
    yields {phase: {work, busy, parallelism}}.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._work: dict[str, float] = defaultdict(float)
        self._busy: dict[str, float] = defaultdict(float)
        self._open: dict[str, int] = defaultdict(int)
        self._busy_since: dict[str, float] = {}

    def span(self, phase: str) -> "_Span":
        return _Span(self, phase)

    def _enter(self, phase: str) -> float:
        now = time.perf_counter()
        with self._lock:
            if self._open[phase] == 0:
                self._busy_since[phase] = now
            self._open[phase] += 1
        return now

    def _exit(self, phase: str, started: float) -> None:
        now = time.perf_counter()
        with self._lock:
            self._work[phase] += now - started
            self._open[phase] -= 1
            if self._open[phase] == 0:
                self._busy[phase] += now - self._busy_since.pop(phase)

    def report(self) -> dict[str, dict[str, float]]:
        with self._lock:
            return {
                phase: {
                    "work": round(self._work[phase], 6),
                    "busy": round(self._busy[phase], 6),
                    "parallelism": round(
                        self._work[phase] / self._busy[phase], 3
                    )
                    if self._busy[phase]
                    else 0.0,
                }
                for phase in self._work
            }


class _Span:
    def __init__(self, timer: PhaseTimer, phase: str):
        self.timer = timer
        self.phase = phase

    def __enter__(self):
        self.started = self.timer._enter(self.phase)
        return self

    def __exit__(self, *exc):
        self.timer._exit(self.phase, self.started)
        return False
