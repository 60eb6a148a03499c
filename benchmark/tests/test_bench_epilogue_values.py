"""The reader of ``fused_epilogue_values_per_image``: the program's
``clip.int8_epilogue_values`` counter over a traced run's images, at a test
size. It reads every GEMM output value of every static-int8 block, None
where the program recorded nothing or has no tracing module (a program from
before the counter reads the same None), and 0 where it recorded 0."""

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
METRIC = "fused_epilogue_values_per_image"
CELL = "tiny-build"


def _read(reading):
    return MAIN.reader({"name": METRIC}).read(reading)


def _run(traced):
    from panoptikon_tpu_torch import tracing

    tracing.reset()
    return harness.run(SPEC, CELL, 2**31 + 23, 0.2, traced, torch.device("cpu"),
                       time.perf_counter())


def test_reads_every_epilogue_of_every_block():
    config = SPEC.cell(CELL).config
    v = config["vision_cfg"]
    tokens = (v["image_size"] // v["patch_size"]) ** 2 + 1
    mlp = config["assumed"]["mlp_ratio"]
    want = tokens * (3 + 1 + mlp + 1) * v["width"] * v["layers"]  # qkv, out, fc, proj
    assert _read(_run(traced=True).reading) == want


def test_none_where_the_program_recorded_nothing(monkeypatch):
    reading = _run(traced=False).reading  # no profiler, so no counts
    assert _read(reading) is None
    import panoptikon_tpu_torch

    monkeypatch.delattr(panoptikon_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "panoptikon_tpu_torch.tracing", None)
    assert _read(reading) is None


def test_a_recorded_zero_reads_zero(monkeypatch):
    from panoptikon_tpu_torch import tracing

    monkeypatch.setattr(tracing, "counters", lambda: {"clip.int8_epilogue_values": 0})
    assert _read(SimpleNamespace(steps=2, work={"images": 4})) == 0.0
