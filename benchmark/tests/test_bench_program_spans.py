"""The readers of the program's own spans and counters
(``panoptikon_tpu_torch/tracing.py``): each reads its value from a traced
run at a test size, and returns None where the program recorded nothing or
has no such module (a program from before the module), and 0 where it
recorded 0."""

import sys
import time
from types import SimpleNamespace
from pathlib import Path

import pytest
import torch

from benchmark import harness
from benchmark.spec import Spec

DATA = Path(__file__).resolve().parent / "data"
SPEC = Spec.load(DATA / "BENCHMARK.json", data_dirs=[DATA])
MAIN = Spec.load()
CPU = torch.device("cpu")
# metric -> the test cell whose traced run it reads
CELLS = {"id_table_ms": "tiny-similar-b2", "id_table_rows_per_query": "tiny-similar-b2",
         "predict_host_ms": "tiny-build", "upload_bytes_per_image": "tiny-build"}


def _read(metric, reading):
    return MAIN.reader({"name": metric}).read(reading)


def _run(cell, traced):
    from panoptikon_tpu_torch import tracing

    tracing.reset()
    return harness.run(SPEC, cell, 2**31 + 17, 0.2, traced, CPU, time.perf_counter())


@pytest.mark.parametrize("metric", list(CELLS))
def test_reads_a_traced_run(metric):
    cell = CELLS[metric]
    out = _run(cell, traced=True)
    value = _read(metric, out.reading)
    assert value is not None and value > 0
    c = SPEC.cell(cell)
    if metric == "id_table_rows_per_query":
        # The whole table is turned into an array on every batch.
        assert value == c.config["space"]["rows"] / c.traffic["queries_per_batch"]
    if metric == "upload_bytes_per_image":
        size = c.config["vision_cfg"]["image_size"]
        assert value == size * size * 3 * 4
    if metric == "id_table_ms":
        assert value <= _read("item_ids_ms", out.reading)


@pytest.mark.parametrize("metric", list(CELLS))
def test_none_where_the_program_recorded_nothing(metric, monkeypatch):
    out = _run(CELLS[metric], traced=False)  # no profiler, so no span records
    assert _read(metric, out.reading) is None
    import panoptikon_tpu_torch

    monkeypatch.delattr(panoptikon_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "panoptikon_tpu_torch.tracing", None)
    assert _read(metric, out.reading) is None


@pytest.mark.parametrize("metric", list(CELLS))
def test_a_recorded_zero_reads_zero(metric, monkeypatch):
    from panoptikon_tpu_torch import tracing

    names = ("vector_index.id_table", "vector_index.id_table_rows",
             "impls.clip_predict.stack", "impls.clip_predict.serialize",
             "impls.clip_upload_bytes")
    monkeypatch.setattr(tracing, "totals", lambda: dict.fromkeys(names, 0.0))
    monkeypatch.setattr(tracing, "counters", lambda: dict.fromkeys(names, 0))
    reading = SimpleNamespace(steps=2, work={"queries": 8, "images": 4})
    assert _read(metric, reading) == 0.0
