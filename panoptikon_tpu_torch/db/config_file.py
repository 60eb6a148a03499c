"""Per-DB human-editable config mirror.

The port's copy of ``panoptikon_tpu/db/config_file.py``, held to it unit for unit by
``tests/test_torch_host_copies.py``.

The reference persists per-DB system config as a TOML file edited through
its lossless editor so user comments and key order survive programmatic
writes (db/system_config.rs ``save`` → panoptikon_config::TomlDocument
``patch_serialized``). Here the durable source of truth is the
``system_config`` TABLE; this module mirrors the USER-VISIBLE flat keys to
``<db_dir>/config.toml`` through :mod:`panoptikon_tpu_torch.utils.toml_edit` on
every programmatic write, and imports hand edits back into the table at DB
open (hand edits win at boot — the reference's load-before-serve order).
"""

from __future__ import annotations

import tomllib
from pathlib import Path

from panoptikon_tpu_torch.db import store
from panoptikon_tpu_torch.utils.toml_edit import TomlDocument

# system_config keys mirrored to the file: flat scalar-valued tables only
# (the shapes the lossless editor patches in place).
MIRRORED_KEYS = ("continuous_scan",)


def config_path(db) -> Path:
    return Path(db.index_path).parent / "config.toml"


def write_key(db, key: str, value: dict) -> None:
    """Patch one mirrored key's section into the file, preserving the
    user's comments/order (only the value portions of changed lines are
    rewritten; removed keys are cleared by setting absent ones untouched —
    callers send full sections)."""
    if key not in MIRRORED_KEYS:
        return
    path = config_path(db)
    doc = TomlDocument.load(path)
    for k, v in (value or {}).items():
        doc.set(f"{key}.{k}", v)
    doc.commit(path)


def import_file(db, writer) -> list[str]:
    """At DB open: any mirrored section present in the file replaces the
    table's value when they differ (the user edited the file by hand).
    Returns the keys imported."""
    path = config_path(db)
    if not path.exists():
        return []
    try:
        data = tomllib.loads(path.read_text())
    except Exception:
        return []  # malformed hand edit: the table stays authoritative
    imported = []
    for key in MIRRORED_KEYS:
        if key not in data:
            continue
        file_value = data[key]
        table_value = store.get_config(db.reader(), key, None)
        if file_value != table_value:
            writer.call(lambda c, k=key, v=file_value: store.set_config(c, k, v))
            imported.append(key)
    return imported
