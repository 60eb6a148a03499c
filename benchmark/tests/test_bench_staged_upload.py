"""The reader of ``staged_upload_bytes_per_image``: the program's
``impls.clip_staged_upload_bytes`` counter over a traced run's images. None
where the program recorded nothing (a CPU device stages no upload, and a
program from before the counter records none) or has no tracing module, and
the counter over the images where it is there."""

import sys
import time
from pathlib import Path
from types import SimpleNamespace

import torch

from benchmark import harness
from benchmark.spec import Spec

DATA = Path(__file__).resolve().parent / "data"
SPEC = Spec.load(DATA / "BENCHMARK.json", data_dirs=[DATA])
MAIN = Spec.load()
METRIC = "staged_upload_bytes_per_image"
CELL = "tiny-build"


def _read(reading):
    return MAIN.reader({"name": METRIC}).read(reading)


def _run(traced):
    from panoptikon_tpu_torch import tracing

    tracing.reset()
    return harness.run(SPEC, CELL, 2**31 + 29, 0.2, traced, torch.device("cpu"),
                       time.perf_counter())


def test_none_where_the_program_recorded_nothing(monkeypatch):
    from panoptikon_tpu_torch import tracing

    reading = _run(traced=True).reading  # on the CPU: uploads counted, none staged
    assert "impls.clip_upload_bytes" in tracing.counters()
    assert _read(reading) is None
    import panoptikon_tpu_torch

    monkeypatch.delattr(panoptikon_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "panoptikon_tpu_torch.tracing", None)
    assert _read(reading) is None


def test_reads_the_counter_over_the_images(monkeypatch):
    from panoptikon_tpu_torch import tracing

    staged = 8 * 224 * 224 * 3 * 4
    monkeypatch.setattr(tracing, "counters",
                        lambda: {"impls.clip_upload_bytes": staged,
                                 "impls.clip_staged_upload_bytes": staged})
    assert _read(SimpleNamespace(steps=2, work={"images": 8})) == 224 * 224 * 3 * 4
    monkeypatch.setattr(tracing, "counters", lambda: {"impls.clip_staged_upload_bytes": 0})
    assert _read(SimpleNamespace(steps=2, work={"images": 4})) == 0.0
