"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
The configuration is the JSON file its entry names. The traffic mix is
``traffic/<traffic>.json``; its ``kind`` names the code that drives it,
``kinds/<kind>.py``. The limits of the comparison that decides ``correct``
are ``limits/<cell>.json``, and each metric is read by ``metrics/<name>.py``.
Each is looked up first in the extra data directories a caller names (the
tests keep cells of their own there), then beside this file. Adding a cell,
a configuration or a metric is adding files and entries: nothing here names
one.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


@dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: dict
    end_to_end: tuple  # the BENCHMARK.json entries of this cell's end-to-end metrics
    per_layer: tuple  # and of its per-layer metrics


def _applies(metric: dict, cell: str, e2e_names: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    # A per-layer metric without ``workloads`` is read wherever the
    # end-to-end metric it moves is reported.
    return "moves" not in metric or metric["moves"] in e2e_names


class Spec:
    def __init__(self, doc: dict, root: Path = ROOT, data_dirs=()):
        self.doc = doc
        self.root = Path(root)
        self.dirs = [Path(d) for d in data_dirs] + [BENCH_DIR]
        self._modules: dict[Path, ModuleType] = {}

    @classmethod
    def load(cls, path: Path | None = None, data_dirs=()) -> "Spec":
        path = Path(path) if path is not None else ROOT / "BENCHMARK.json"
        return cls(json.loads(path.read_text()), path.parent, data_dirs)

    def find(self, sub: str, name: str, suffix: str) -> Path:
        for d in self.dirs:
            path = d / sub / f"{name}{suffix}"
            if path.is_file():
                return path
        raise FileNotFoundError(f"no {sub}/{name}{suffix} in {[str(d) for d in self.dirs]}")

    def module(self, sub: str, name: str) -> ModuleType:
        """``<sub>/<name>.py`` as a module (names may hold dots, so it is
        loaded from its path, once)."""
        path = self.find(sub, name, ".py")
        if path not in self._modules:
            mod_name = f"benchmark._{sub}_" + "".join(c if c.isalnum() else "_" for c in name)
            spec = importlib.util.spec_from_file_location(mod_name, path)
            module = importlib.util.module_from_spec(spec)
            sys.modules[mod_name] = module
            spec.loader.exec_module(module)
            self._modules[path] = module
        return self._modules[path]

    def cell_names(self) -> list:
        return [w["name"] for w in self.doc["workloads"]]

    def cell(self, name: str) -> Cell:
        entries = {w["name"]: w for w in self.doc["workloads"]}
        if name not in entries:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(entries)}")
        w = entries[name]
        config_entry = {c["name"]: c for c in self.doc["configs"]}[w["config"]]
        config = json.loads((self.root / config_entry["file"]).read_text())
        traffic = json.loads(self.find("traffic", w["traffic"], ".json").read_text())
        limits = json.loads(self.find("limits", name, ".json").read_text())
        e2e = tuple(m for m in self.doc["end_to_end"] if _applies(m, name, set()))
        e2e_names = {m["name"] for m in e2e}
        per_layer = tuple(m for m in self.doc["per_layer"] if _applies(m, name, e2e_names))
        return Cell(name=name, chips=int(w["chips"]), config_name=w["config"], config=config,
                    traffic_name=w["traffic"], traffic=traffic, limits=limits, end_to_end=e2e,
                    per_layer=per_layer)

    def kind(self, cell: Cell) -> ModuleType:
        return self.module("kinds", cell.traffic["kind"])

    def reader(self, metric: dict) -> ModuleType:
        return self.module("metrics", metric["name"])
