"""Desktop mode: tray-less local-app lifecycle around the server.

The port's copy of ``panoptikon_tpu/desktop.py``, held to it unit for unit by
``tests/test_torch_host_copies.py``. It inherits the reference's restart fault (ROADMAP §C, ``desktop.py:116``).

The reference ships a ~9.8k-LoC Tauri v2 desktop app whose load-bearing
core is a process supervisor + lifecycle manager around the same server
this package runs (/root/reference/panoptikon-desktop/src-tauri/src/
supervisor.rs, lifecycle.rs, main.rs): spawn the server, wait for health,
open the UI, restart on crash with backoff, shut the child down cleanly on
exit, and surface update availability. Everything else the app does rides
HTTP endpoints this server already serves (setup wizard, update ribbon,
two-phase relay pairing, host-open integration).

``panoptikon-tpu desktop`` reproduces that core natively: a supervisor
loop with exponential backoff, health-gated browser launch onto ``/ui``,
an optional startup update check against the self-update manifest, and
signal-clean child teardown. No tray icon — the terminal is the tray.
"""

from __future__ import annotations

import signal
import subprocess
import sys
import time
import urllib.request
from dataclasses import dataclass, field
from typing import Callable, Optional

# Restart backoff (supervisor.rs uses the same doubling-with-cap shape).
BACKOFF_INITIAL_S = 1.0
BACKOFF_MAX_S = 30.0
# A child that stayed healthy this long resets the backoff ladder.
STABLE_RESET_S = 60.0


def backoff_schedule(
    initial: float = BACKOFF_INITIAL_S, cap: float = BACKOFF_MAX_S
):
    """Doubling, capped restart delays: 1, 2, 4, ... cap, cap, ..."""
    delay = initial
    while True:
        yield min(delay, cap)
        delay = min(delay * 2, cap)


@dataclass
class DesktopSupervisor:
    """Spawn + babysit one server child; restart on crash, stop on signal.

    All effects are injectable so the lifecycle is unit-testable without
    real servers/browsers: ``spawn`` returns a Popen-like object,
    ``probe`` returns True when /api/health answers, ``open_ui`` fires
    once after the FIRST healthy probe.
    """

    spawn: Callable[[], "subprocess.Popen"]
    probe: Callable[[], bool]
    open_ui: Callable[[], None] = lambda: None
    log: Callable[[str], None] = lambda m: print(m, file=sys.stderr)
    health_timeout_s: float = 120.0
    poll_interval_s: float = 0.5
    sleep: Callable[[float], None] = time.sleep
    clock: Callable[[], float] = time.monotonic
    max_restarts: Optional[int] = None  # None = forever
    restarts: int = field(default=0, init=False)
    _stopping: bool = field(default=False, init=False)
    _child: Optional["subprocess.Popen"] = field(default=None, init=False)
    _ui_opened: bool = field(default=False, init=False)

    def request_stop(self) -> None:
        self._stopping = True

    def _wait_healthy(self) -> bool:
        deadline = self.clock() + self.health_timeout_s
        while self.clock() < deadline and not self._stopping:
            if self._child is not None and self._child.poll() is not None:
                return False  # died during startup
            if self.probe():
                return True
            self.sleep(self.poll_interval_s)
        return False

    def _terminate_child(self) -> None:
        child = self._child
        if child is None or child.poll() is not None:
            return
        # lifecycle.rs: SIGTERM → grace window → SIGKILL.
        child.terminate()
        try:
            child.wait(timeout=15)
        except subprocess.TimeoutExpired:
            child.kill()
            child.wait(timeout=5)

    def run(self) -> int:
        """Supervise until stopped. Returns 0 on clean stop, 1 when the
        child could never reach health / restart budget exhausted."""
        backoff = backoff_schedule()
        try:
            while not self._stopping:
                started = self.clock()
                self._child = self.spawn()
                if self._wait_healthy():
                    if not self._ui_opened:
                        self._ui_opened = True
                        try:
                            self.open_ui()
                        except Exception as exc:  # browser is best-effort
                            self.log(f"[desktop] UI open failed: {exc}")
                    self.log("[desktop] server healthy")
                    # Block until the child exits (or we are stopped).
                    while not self._stopping:
                        if self._child.poll() is not None:
                            break
                        self.sleep(self.poll_interval_s)
                elif not self._stopping:
                    self.log("[desktop] server failed to reach health")
                if self._stopping:
                    break
                rc = self._child.poll()
                self.log(f"[desktop] server exited rc={rc}")
                if self.clock() - started >= STABLE_RESET_S:
                    backoff = backoff_schedule()
                self.restarts += 1
                if (
                    self.max_restarts is not None
                    and self.restarts > self.max_restarts
                ):
                    self.log("[desktop] restart budget exhausted")
                    return 1
                delay = next(backoff)
                self.log(f"[desktop] restarting in {delay:.0f}s")
                self.sleep(delay)
            return 0
        finally:
            self._terminate_child()


def _http_ok(url: str, timeout: float = 2.0) -> bool:
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return 200 <= resp.status < 300
    except Exception:
        return False


def check_update_ribbon(manifest_url: Optional[str], log) -> None:
    """Startup update check — the desktop app's update ribbon
    (main.rs update flow), surfaced as a log line; applying stays an
    explicit ``panoptikon-tpu self-update --apply``."""
    if not manifest_url:
        return
    try:
        import panoptikon_tpu_torch
        from panoptikon_tpu_torch.utils.version import fetch_manifest, newer_than

        manifest = fetch_manifest(manifest_url)
        latest = str(manifest.get("version", ""))
        if latest and newer_than(latest, panoptikon_tpu_torch.__version__):
            log(
                f"[desktop] update available: {latest} — run "
                f"`panoptikon-tpu self-update --apply`"
            )
    except Exception as exc:
        log(f"[desktop] update check failed: {exc}")


def run_desktop(args) -> int:
    """CLI entry: supervise `python -m panoptikon_tpu_torch.api.server` and open
    the built-in UI once healthy."""
    import webbrowser

    host = args.host or "127.0.0.1"
    port = args.port or 6342
    base = f"http://{host}:{port}"

    cmd = [sys.executable, "-m", "panoptikon_tpu_torch.api.server"]
    if args.config:
        cmd += ["--config", args.config]
    if args.port:
        cmd += ["--port", str(port)]
    if args.host:
        cmd += ["--host", host]
    if getattr(args, "data_root", None):
        cmd += ["--data-root", args.data_root]
    if getattr(args, "registry_dir", None):
        cmd += ["--registry-dir", args.registry_dir]

    def log(msg: str) -> None:
        print(msg, file=sys.stderr)

    check_update_ribbon(getattr(args, "manifest", None), log)

    sup = DesktopSupervisor(
        spawn=lambda: subprocess.Popen(cmd),
        probe=lambda: _http_ok(f"{base}/health"),
        open_ui=(
            (lambda: None)
            if getattr(args, "no_browser", False)
            else (lambda: webbrowser.open(f"{base}/ui"))
        ),
        log=log,
        max_restarts=getattr(args, "max_restarts", None),
    )

    def _stop(signum, frame):
        log("[desktop] shutting down")
        sup.request_stop()

    signal.signal(signal.SIGINT, _stop)
    signal.signal(signal.SIGTERM, _stop)
    log(f"[desktop] supervising {' '.join(cmd)} → {base}/ui")
    return sup.run()
