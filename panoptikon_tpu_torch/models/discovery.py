"""User custom-impl discovery: ``impl_dirs`` → ``IMPL_CLASS`` classes.

The reference lets users drop ``InferenceModel`` subclasses into
directories named by the registry's ``impl_dirs`` and selects them by the
module-level ``IMPL_CLASS`` attribute
(the reference's python/inferio_worker/discovery.py, registry
``impl_dirs`` — inferio/registry.rs:1-64). Here the same contract holds
in-process: registry TOML files may declare a top-level
``impl_dirs = ["./custom", …]`` (relative paths resolve against the TOML
file's folder); each ``*.py`` inside is imported lazily AT MODEL LOAD —
an unknown class errors at load, never at import of the package — and a
module exposing ``IMPL_CLASS`` (a string) plus a class of that name (or
``IMPL_CLASS`` bound directly to the class) registers it.

Discovered classes must satisfy the ``InferenceModel`` protocol
(models/base.py): ``name()``, ``load``, ``predict``, ``unload``.

The port's copy of ``panoptikon_tpu/models/discovery.py``, held to it by
``tests/test_torch_host_copies.py``; user modules register under
``panoptikon_tpu_torch._user_impls``.
"""

from __future__ import annotations

import importlib.util
import sys
import threading
from pathlib import Path

_LOCK = threading.Lock()
# dir → (mtime signature, {impl name → class})
_CACHE: dict[str, tuple[tuple, dict]] = {}


def _signature(folder: Path) -> tuple:
    # (name, mtime, size) — mtime alone misses backup-restored files whose
    # preserved mtimes are older, and sub-granularity rewrites (the same
    # reload discipline as Registry.load's change signature).
    try:
        return tuple(
            sorted(
                (p.name, p.stat().st_mtime, p.stat().st_size)
                for p in folder.glob("*.py")
            )
        )
    except OSError:
        return ()


def _scan_dir(folder: Path) -> dict:
    """Import every module in the folder; collect IMPL_CLASS exports.
    A module that fails to import is skipped with its error recorded so a
    lookup of ITS class can surface the cause (reference discovery logs
    and continues)."""
    found: dict = {}
    for path in sorted(folder.glob("*.py")):
        mod_name = f"panoptikon_tpu_torch._user_impls.{folder.name}.{path.stem}"
        try:
            spec = importlib.util.spec_from_file_location(mod_name, path)
            if spec is None or spec.loader is None:
                continue
            module = importlib.util.module_from_spec(spec)
            sys.modules[mod_name] = module
            spec.loader.exec_module(module)
        except Exception as exc:  # noqa: BLE001 — record, don't break load
            found.setdefault("__errors__", []).append(f"{path}: {exc}")
            continue
        marker = getattr(module, "IMPL_CLASS", None)
        if marker is None:
            continue
        if isinstance(marker, str):
            cls = getattr(module, marker, None)
            impl_name = marker
        else:
            cls = marker
            impl_name = getattr(cls, "__name__", None)
        if cls is None or impl_name is None:
            found.setdefault("__errors__", []).append(
                f"{path}: IMPL_CLASS names no class in the module"
            )
            continue
        # The class registers under BOTH its declared name() (the registry
        # key space used by built-ins) and the class name.
        keys = {impl_name}
        try:
            keys.add(cls.name())
        except Exception:  # noqa: BLE001 — name() may need instance state
            pass
        for key in keys:
            found[key] = cls
    return found


def discover(impl_dirs) -> dict:
    """Scan the given directories; returns {impl name → class} with an
    optional ``__errors__`` list. mtime-cached per directory (the
    reference's registry reload discipline)."""
    merged: dict = {}
    for folder in impl_dirs or []:
        folder = Path(folder)
        if not folder.is_dir():
            continue
        sig = _signature(folder)
        key = str(folder.resolve())
        with _LOCK:
            cached = _CACHE.get(key)
            if cached is not None and cached[0] == sig:
                scan = cached[1]
            else:
                scan = _scan_dir(folder)
                _CACHE[key] = (sig, scan)
        for k, v in scan.items():
            if k == "__errors__":
                merged.setdefault("__errors__", []).extend(v)
            else:
                merged[k] = v
    return merged


def find(impl_dirs, impl_class: str):
    """Resolve one impl class, or raise LookupError naming any scan errors
    (so a broken user module explains itself at model load)."""
    scan = discover(impl_dirs)
    cls = scan.get(impl_class)
    if cls is not None:
        return cls
    errors = scan.get("__errors__") or []
    detail = f" (impl dir errors: {'; '.join(errors)})" if errors else ""
    raise LookupError(
        f"impl_class {impl_class!r} not found in impl_dirs{detail}"
    )
