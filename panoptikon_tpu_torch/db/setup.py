"""Desktop setup-wizard validation helpers (reference db/setup.rs:82-200).

The port's copy of ``panoptikon_tpu/db/setup.py``, held to it unit for unit by
``tests/test_torch_host_copies.py``.

Pure functions over the filesystem and an optional index connection; no
config is changed and no work starts — the API handlers
(/api/desktop/setup-*) stage and preview, /api/desktop/setup/complete
commits.
"""

from __future__ import annotations

import os
import sqlite3
from pathlib import Path
from typing import Optional


def normalize_folder_list(folders) -> list[str]:
    """Absolute, separator-normalized, deduplicated, order-preserving;
    blank entries dropped (system_config.rs normalize_folder_list)."""
    out: list[str] = []
    seen = set()
    for raw in folders or []:
        s = str(raw).strip()
        if not s:
            continue
        p = os.path.normpath(os.path.abspath(s))
        if p not in seen:
            seen.add(p)
            out.append(p)
    return out


def _inspect_directory(path: str) -> tuple[Optional[str], bool]:
    """(error, empty) for one staged path (setup.rs inspect_directory)."""
    p = Path(path)
    try:
        st = p.stat()
    except OSError as exc:
        return f"Cannot access this path: {exc}", False
    if not p.is_dir():
        return "This path is not a directory.", False
    try:
        empty = next(iter(p.iterdir()), None) is None
    except OSError as exc:
        return f"Cannot read this directory: {exc}", False
    return None, empty


def has_indexed_files_under(conn: sqlite3.Connection, folder: str) -> bool:
    # Separator-safe boundary: /data/photos must not claim files under
    # /data/photos2 (the same prefix bug class commit d8e1c7f fixed in
    # the scan path).
    prefix = folder.rstrip(os.sep) + os.sep
    row = conn.execute(
        "SELECT EXISTS (SELECT 1 FROM files "
        "WHERE path = ?1 OR substr(path, 1, length(?2)) = ?2)",
        (folder, prefix),
    ).fetchone()
    return bool(row and row[0])


def validate_folders(
    conn: Optional[sqlite3.Connection],
    included_folders,
    excluded_folders,
) -> dict:
    """Normalize + validate staged wizard folders (setup.rs:82-140).

    An EMPTY included folder is safe only when the target index has no
    file rows beneath it — that distinguishes a legitimate new watch
    target from a drive/share that is momentarily unmounted (deleting its
    rows on the next scan would be data loss). Excluded folders must sit
    inside an included one."""
    included = normalize_folder_list(included_folders)
    excluded = normalize_folder_list(excluded_folders)
    errors: list[dict] = []
    for path in included + excluded:
        error, empty = _inspect_directory(path)
        if error is not None:
            errors.append({"path": path, "error": error})
            continue
        if (
            empty
            and path in included
            and conn is not None
            and has_indexed_files_under(conn, path)
        ):
            errors.append(
                {
                    "path": path,
                    "error": (
                        "This directory is empty, but the database still "
                        "contains indexed files beneath it. It was not "
                        "accepted to protect those entries in case the "
                        "drive or share is temporarily unavailable."
                    ),
                }
            )
    inc_paths = [Path(p) for p in included]
    for path in excluded:
        p = Path(path)
        if not any(p.is_relative_to(root) for root in inc_paths):
            errors.append(
                {
                    "path": path,
                    "error": (
                        "Excluded directories must be inside an included "
                        "directory."
                    ),
                }
            )
    return {
        "included_folders": included,
        "excluded_folders": excluded,
        "errors": errors,
    }


def validate_continuous_folders(
    conn: Optional[sqlite3.Connection],
    included_folders,
    excluded_folders,
    continuous_folders,
) -> dict:
    """Continuous-scan whitelist vs the staged full-scan roots
    (setup.rs:146-178). Empty whitelist = all included roots, valid."""
    included = normalize_folder_list(included_folders)
    excluded = normalize_folder_list(excluded_folders)
    validation = validate_folders(conn, continuous_folders, [])
    inc_paths = [Path(p) for p in included]
    exc_paths = [Path(p) for p in excluded]
    for folder in validation["included_folders"]:
        p = Path(folder)
        if not any(p.is_relative_to(root) for root in inc_paths):
            validation["errors"].append(
                {
                    "path": folder,
                    "error": (
                        "Continuously watched directories must be inside "
                        "a full-scan included directory."
                    ),
                }
            )
        elif any(p.is_relative_to(root) for root in exc_paths):
            validation["errors"].append(
                {
                    "path": folder,
                    "error": (
                        "Continuously watched directories cannot be "
                        "inside an excluded directory."
                    ),
                }
            )
    return validation


def is_ready_for_desktop(conn: sqlite3.Connection) -> bool:
    """Ready once ≥1 currently-included folder has reached the filescan
    pipeline — file_scans rows appear when scanning STARTS, so queued or
    failed-before-start jobs don't false-positive (setup.rs:184-200)."""
    # file_scans.path records the scan's ";"-joined included-folder list
    # (store.start_file_scan) — match a folder ANYWHERE in that list, not
    # string-equal, or readiness never flips once 2+ folders are included.
    row = conn.execute(
        """SELECT EXISTS (
               SELECT 1 FROM folders f
               INNER JOIN file_scans s
                 ON instr(';' || s.path || ';', ';' || f.path || ';') > 0
               WHERE f.included = 1
           )"""
    ).fetchone()
    return bool(row and row[0])
