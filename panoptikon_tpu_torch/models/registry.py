"""Model registry: TOML files → resolved inference ids.

Same configuration surface and semantics as the reference registry
(``panoptikon/src/inferio/registry.rs`` header, itself a port of the legacy
``inferio/config.py``):

- ``*.toml`` scanned in alphabetical order, built-in folder first, then the
  user folder; a missing folder is skipped.
- Any error in any file (bad TOML, duplicate id) fails the WHOLE load.
- ``allow_override`` is per-file: a later file may redefine an id only when
  that later file sets it; group config/metadata always merge (later file
  wins per key).
- Group config merges under id config eagerly AT THE POINT the id is
  defined — group config added later does not retroactively apply.
- ``metadata()`` returns, per group, group metadata + id→metadata in
  insertion order (order is semantic: the UI renders it).
- Reload is mtime-triggered; an empty registry never caches.

Divergence: ``impl_class`` names in-process model classes
(``models.impls``), not worker subprocess entry points.

The port's copy of ``panoptikon_tpu/models/registry.py``, held to it by
``tests/test_torch_host_copies.py``; only :func:`packaged_builtin_dir`
differs, which finds the port's own copy of the built-in TOML.
"""

from __future__ import annotations

import tomllib
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any


def packaged_builtin_dir() -> Path | None:
    """The registry TOML bundled inside the package
    (panoptikon_tpu_torch/resources/config/inference)."""
    try:
        from panoptikon_tpu_torch import resources as _res

        p = _res.config_dir() / "inference"
        return p if p.is_dir() else None
    except Exception:
        return None


class RegistryError(ValueError):
    pass


@dataclass
class ResolvedId:
    group: str
    inference_id: str
    config: dict[str, Any]  # merged: group config under id config
    metadata: dict[str, Any]  # id-level only

    @property
    def impl_class(self) -> str:
        impl = self.config.get("impl_class")
        if not isinstance(impl, str) or not impl:
            raise RegistryError(
                f"{self.group}/{self.inference_id}: missing impl_class"
            )
        return impl

    def spawn_kwargs(self) -> dict[str, Any]:
        """Constructor kwargs = merged config minus orchestrator directives
        (registry.rs: impl_class/ray_config/replicas/devices stripped)."""
        return {
            k: v
            for k, v in self.config.items()
            if k not in ("impl_class", "ray_config", "replicas", "devices")
        }


@dataclass
class GroupEntry:
    metadata: dict[str, Any] = field(default_factory=dict)
    config: dict[str, Any] = field(default_factory=dict)
    ids: dict[str, ResolvedId] = field(default_factory=dict)


def _deep_merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


class Registry:
    def __init__(self, builtin_dir: str | Path | None, user_dir: str | Path | None = None):
        if builtin_dir is None:
            # Embedded resources (reference resources.rs bundles its
            # defaults in the binary): the built-in registry TOML ships
            # inside the package, so an unconfigured server still has its
            # model catalog.
            builtin_dir = packaged_builtin_dir()
        self.builtin_dir = Path(builtin_dir) if builtin_dir else None
        self.user_dir = Path(user_dir) if user_dir else None
        self._groups: dict[str, GroupEntry] = {}
        self._signature: tuple = ()
        self._loaded = False

    # -- loading ------------------------------------------------------------

    def _files(self) -> list[Path]:
        files: list[Path] = []
        for folder in (self.builtin_dir, self.user_dir):
            if folder is None or not folder.is_dir():
                continue
            files.extend(sorted(folder.glob("*.toml")))
        return files

    def load(self, force: bool = False) -> None:
        files = self._files()
        # Reload on ANY change signature delta — a strictly-increasing
        # max(mtime) misses deletions and backup-restored files whose
        # preserved mtimes are older than the high-water mark.
        signature = tuple(
            (str(f), f.stat().st_mtime, f.stat().st_size) for f in files
        )
        if self._loaded and not force and self._groups and signature == self._signature:
            return
        groups: dict[str, GroupEntry] = {}
        defined_ids: set[str] = set()
        impl_dirs: list[Path] = []
        for path in files:
            try:
                doc = tomllib.loads(path.read_text())
            except tomllib.TOMLDecodeError as exc:
                raise RegistryError(f"{path}: invalid TOML: {exc}") from exc
            allow_override = bool(doc.get("allow_override", False))
            # User custom-impl directories (reference registry `impl_dirs`,
            # inferio/registry.rs:1-64): relative paths resolve against the
            # declaring TOML's folder.
            for d in doc.get("impl_dirs") or []:
                p = Path(d)
                if not p.is_absolute():
                    p = path.parent / p
                if p not in impl_dirs:
                    impl_dirs.append(p)
            for group_name, group_doc in (doc.get("group") or {}).items():
                if not isinstance(group_doc, dict):
                    raise RegistryError(f"{path}: group.{group_name} must be a table")
                entry = groups.setdefault(group_name, GroupEntry())
                # Group config/metadata merge across files, later wins.
                entry.config = _deep_merge(entry.config, group_doc.get("config") or {})
                entry.metadata = _deep_merge(entry.metadata, group_doc.get("metadata") or {})
                for inf_id, id_doc in (group_doc.get("inference_ids") or {}).items():
                    full = f"{group_name}/{inf_id}"
                    if full in defined_ids and not allow_override:
                        raise RegistryError(
                            f"{path}: duplicate inference id {full} "
                            "(later file must set allow_override = true)"
                        )
                    defined_ids.add(full)
                    id_config = (id_doc or {}).get("config") or {}
                    # Eager merge at definition point.
                    merged = _deep_merge(entry.config, id_config)
                    entry.ids[inf_id] = ResolvedId(
                        group=group_name,
                        inference_id=inf_id,
                        config=merged,
                        metadata=(id_doc or {}).get("metadata") or {},
                    )
        self._groups = groups
        self._impl_dirs = impl_dirs
        self._signature = signature
        self._loaded = True

    def impl_dirs(self) -> list[Path]:
        """Custom-impl directories declared across registry files."""
        self.load()
        return list(getattr(self, "_impl_dirs", []) or [])

    # -- queries ------------------------------------------------------------

    def resolve(self, group: str, inference_id: str) -> ResolvedId:
        self.load()
        entry = self._groups.get(group)
        if entry is None or inference_id not in entry.ids:
            raise RegistryError(f"unknown inference id {group}/{inference_id}")
        return entry.ids[inference_id]

    def metadata(self) -> dict[str, Any]:
        """The /metadata shape: per group, group_metadata + id metadata,
        insertion-ordered; impl_class/config never leak."""
        self.load()
        return {
            name: {
                "group_metadata": entry.metadata,
                "inference_ids": {
                    inf_id: rid.metadata for inf_id, rid in entry.ids.items()
                },
            }
            for name, entry in self._groups.items()
        }

    def groups(self) -> list[str]:
        self.load()
        return list(self._groups.keys())

    def ids_in_group(self, group: str) -> list[str]:
        self.load()
        entry = self._groups.get(group)
        return list(entry.ids.keys()) if entry else []

    def all_ids(self) -> list[str]:
        self.load()
        return [
            f"{g}/{i}" for g, entry in self._groups.items() for i in entry.ids
        ]

    def group_metadata(self, group: str) -> dict[str, Any]:
        self.load()
        entry = self._groups.get(group)
        return entry.metadata if entry else {}
