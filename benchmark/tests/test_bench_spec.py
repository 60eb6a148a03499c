"""BENCHMARK.json against the benchmark's contract, and every cell, configuration
and metric found by name from its files."""

import json
import re
import time
from pathlib import Path

import pytest
import torch

from benchmark import harness
from benchmark.spec import BENCH_DIR, ROOT, Spec

DATA = Path(__file__).resolve().parent / "data"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
DOC = json.loads((ROOT / "BENCHMARK.json").read_text())
SPEC = Spec.load()


def one_line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert list(DOC) == ["command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"]
    assert 1 <= len(DOC["command"]) <= 32 and all(one_line(w) for w in DOC["command"])
    assert all(re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) for p in DOC["paths"])
    assert isinstance(DOC["run_seconds"], int) and 1 <= DOC["run_seconds"] <= 51
    for word in DOC["command"][1:]:
        assert not word.startswith("/") and ".." not in word
        if "/" in word:
            assert any(word.startswith(p + "/") for p in DOC["paths"])
    assert len(json.dumps(DOC)) <= 64 * 1024


def test_a_full_check_fits_its_time_with_24_cells():
    assert (2 + 14 * 24) * (DOC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_entries_have_the_contract_keys_and_names():
    names = []
    for c in DOC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert one_line(c["source"]) and one_line(c["why"]) and len(c["reduced"]) <= 16
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")
        names.append(c["name"])
    for w in DOC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and one_line(w["why"]) and NAME.match(w["traffic"])
        names.append(w["name"])
    for m in DOC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        names.append(m["name"])
    for m in DOC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert one_line(m["layer"])
        names.append(m["name"])
    for m in DOC["end_to_end"] + DOC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert all(NAME.match(n) for n in names) and len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in DOC["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert {w["config"] for w in DOC["workloads"]} == {c["name"] for c in DOC["configs"]}


@pytest.mark.parametrize("cell", [w["name"] for w in DOC["workloads"]])
def test_each_cell_is_found_by_name_and_reports_what_it_moves(cell):
    c = SPEC.cell(cell)
    kind = SPEC.kind(c)
    for fn in ("setup", "warm", "step", "release", "check", "control", "work"):
        assert callable(getattr(kind, fn))
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e
    for m in c.end_to_end + c.per_layer:
        assert callable(SPEC.reader(m).read)
    assert all(isinstance(v, (int, float)) for v in c.limits.values())


def test_a_layer_has_one_name():
    by_metric_family = {}
    for m in DOC["per_layer"]:
        by_metric_family.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(layers) == 1 for layers in by_metric_family.values())


@pytest.mark.parametrize("config", [c["name"] for c in DOC["configs"]])
def test_configuration_widths_are_the_ports(config):
    from benchmark.kinds import image_build

    entry = {c["name"]: c for c in DOC["configs"]}[config]
    image_build.port_config(json.loads((ROOT / entry["file"]).read_text()))


def test_every_metric_and_kind_file_is_used():
    used = {m["name"] for m in DOC["end_to_end"] + DOC["per_layer"]}
    assert {p.stem for p in (BENCH_DIR / "metrics").glob("*.py")} == used
    kinds = {SPEC.cell(w["name"]).traffic["kind"] for w in DOC["workloads"]}
    assert {p.stem for p in (BENCH_DIR / "kinds").glob("*.py")} - {"__init__"} == kinds


def test_a_cell_defined_only_in_test_data_runs():
    """A cell, a configuration, a traffic mix and a metric that exist only
    in the test data run through the unchanged harness."""
    spec = Spec.load(DATA / "BENCHMARK.json", data_dirs=[DATA])
    out = harness.run(spec, "tiny-similar", 2**31 + 11, 0.3, True, torch.device("cpu"),
                      time.perf_counter())
    metrics = harness.read_metrics(spec, out, True)
    assert out.correct and out.attempted > 0 and out.failed == 0
    assert metrics["steps_per_s"]["value"] > 0 and metrics["steps_per_s"]["unit"] == "steps/s"
