"""Root lock: one serving process per data root (reference RootLock,
main.rs:163-171 — ``runtime/server.lock``).

The port's copy of ``panoptikon_tpu/utils/rootlock.py``, held to it unit for unit by
``tests/test_torch_host_copies.py``.

Two servers over one root would defeat every single-writer guarantee the
engine is built on (writer actor per DB, epoch counters, startup
incomplete-job cleanup). An ``flock`` on ``<root>/server.lock`` makes the
second process fail fast with a clear message instead of corrupting state.

The lock is advisory and dies with the process — a kill -9 never leaves a
stale lock. Re-acquiring within one process is allowed (tests spin several
AppStates over one root sequentially; the cross-PROCESS race is the thing
being excluded).
"""

from __future__ import annotations

import os
import threading
from pathlib import Path

_HELD: dict[str, int] = {}  # canonical root -> open fd (this process)
_LOCK = threading.Lock()


class RootLockError(RuntimeError):
    pass


def acquire(root: str | os.PathLike) -> None:
    """Take the exclusive per-root lock, or raise RootLockError naming the
    holder's PID. Idempotent within one process."""
    root_path = Path(root)
    root_path.mkdir(parents=True, exist_ok=True)
    key = str(root_path.resolve())
    with _LOCK:
        if key in _HELD:
            return
        fd = os.open(str(root_path / "server.lock"), os.O_RDWR | os.O_CREAT, 0o644)
        try:
            import fcntl

            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            holder = b""
            try:
                holder = os.pread(fd, 32, 0).strip()
            except OSError:
                pass
            os.close(fd)
            raise RootLockError(
                f"data root {key} is already served by another process"
                + (f" (pid {holder.decode(errors='replace')})" if holder else "")
            ) from None
        except ImportError:  # pragma: no cover — non-POSIX fallback
            pass
        os.ftruncate(fd, 0)
        os.pwrite(fd, str(os.getpid()).encode(), 0)
        _HELD[key] = fd


def release(root: str | os.PathLike) -> None:
    key = str(Path(root).resolve())
    with _LOCK:
        fd = _HELD.pop(key, None)
        if fd is not None:
            os.close(fd)  # closing drops the flock
