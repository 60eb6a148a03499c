"""Supervised subprocesses with bounded crash restarts.

The port's copy of ``panoptikon_tpu/jobs/supervisor.py``, held to it unit for unit by
``tests/test_torch_host_copies.py``.

The generic half of the reference's UI supervision (src/ui.rs supervised
``next start``) and the desktop supervisor's restart policy
(docs/architecture.md Desktop section: bounded 1/2/4 s crash backoff):
run a command, restart on unexpected exit with exponential backoff, give
up after the bound, and always tear the child down with the parent (no
orphaned trees — the process_tree.rs discipline, via process groups).
"""

from __future__ import annotations

import os
import signal
import subprocess
import threading
import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

BACKOFFS = (1.0, 2.0, 4.0)


@dataclass
class Supervised:
    argv: Sequence[str]
    cwd: Optional[str] = None
    env: Optional[dict] = None
    name: str = "child"
    restarts: int = 0
    gave_up: bool = False
    _proc: Optional[subprocess.Popen] = None
    _stop: threading.Event = field(default_factory=threading.Event)
    _thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, name=f"supervise-{self.name}", daemon=True
        )
        self._thread.start()

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        proc = self._proc
        if proc is not None and proc.poll() is None:
            # Kill the whole process group: children (node, browsers) die
            # with the supervised process.
            try:
                os.killpg(proc.pid, signal.SIGTERM)
            except (ProcessLookupError, PermissionError):
                proc.terminate()
            try:
                proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                try:
                    os.killpg(proc.pid, signal.SIGKILL)
                except (ProcessLookupError, PermissionError):
                    proc.kill()
        if self._thread is not None:
            self._thread.join(timeout=timeout)

    @property
    def running(self) -> bool:
        return self._proc is not None and self._proc.poll() is None

    def _spawn(self) -> subprocess.Popen:
        env = dict(os.environ)
        if self.env:
            env.update(self.env)
        return subprocess.Popen(
            list(self.argv),
            cwd=self.cwd,
            env=env,
            start_new_session=True,  # own process group for clean teardown
        )

    def _loop(self) -> None:
        backoff_idx = 0
        while not self._stop.is_set():
            try:
                self._proc = self._spawn()
            except OSError:
                self.gave_up = True
                return
            started = time.monotonic()
            while self._proc.poll() is None:
                if self._stop.wait(timeout=0.2):
                    return
            if self._stop.is_set():
                return
            # Unexpected exit. A long healthy run resets the backoff ladder.
            if time.monotonic() - started > 30.0:
                backoff_idx = 0
            if backoff_idx >= len(BACKOFFS):
                self.gave_up = True
                return
            self.restarts += 1
            if self._stop.wait(timeout=BACKOFFS[backoff_idx]):
                return
            backoff_idx += 1
