"""A run end to end on the CPU at a test size, past the look for a chip: its
last line, and ``correct`` false when the timed path is broken underneath."""

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from benchmark import harness, run
from benchmark.spec import ROOT, Spec

DATA = Path(__file__).resolve().parent / "data"
SPEC = Spec.load(DATA / "BENCHMARK.json", data_dirs=[DATA])
CPU = torch.device("cpu")


def _run(cell, traced=False, seed=2**31 + 3, seconds=0.3):
    return harness.run(SPEC, cell, seed, seconds, traced, CPU, time.perf_counter())


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("cell", ["tiny-similar", "tiny-similar-b2", "tiny-build"])
def test_the_last_line(cell, traced):
    out = _run(cell, traced)
    metrics = harness.read_metrics(SPEC, out, traced)
    device = {"platform": "gpu", "kind": "test", "count": 1, "memory_peak_bytes": 0}
    if traced:
        device.update(busy_s=out.reading.slice.busy_s, window_s=out.reading.slice.wall_s)
    line = json.loads(json.dumps(run.result_line(out, metrics, device, traced)))
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line) == keys + (["breakdown"] if traced else []) + ["checks"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    want = SPEC.cell(cell).per_layer if traced else SPEC.cell(cell).end_to_end
    assert set(line["metrics"]) <= {m["name"] for m in want}
    if not traced:
        assert set(line["metrics"]) == {m["name"] for m in want}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    if traced:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_no_result_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "b32-similar-q256",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def _half_batch_search(monkeypatch):
    from panoptikon_tpu_torch.index.device_index import DeviceIndex

    real = DeviceIndex.search

    def search(self, q, k, *, oversample=8):
        dist, rows, valid = real(self, q[: q.shape[0] // 2], k, oversample=oversample)
        return dist, rows, valid  # half of the batch's answers never come

    monkeypatch.setattr(DeviceIndex, "search", search)


def _altered_search(monkeypatch):
    from panoptikon_tpu_torch.index.device_index import DeviceIndex

    real = DeviceIndex.item_ids

    def item_ids(self, rows, valid):
        ids = real(self, rows, valid).copy()
        ids[3, 0] += 7  # one answer's best item names another item
        return ids

    monkeypatch.setattr(DeviceIndex, "item_ids", item_ids)


def _half_batch_build(monkeypatch):
    from panoptikon_tpu_torch.models.impls import ClipImpl

    real = ClipImpl.predict
    monkeypatch.setattr(ClipImpl, "predict",
                        lambda self, inputs: real(self, inputs[: len(inputs) // 2]))


def _altered_build(monkeypatch):
    from panoptikon_tpu_torch.models.impls import ClipImpl
    from panoptikon_tpu_torch.utils import npy

    real = ClipImpl.predict

    def predict(self, inputs):
        out = real(self, inputs)
        vec = npy.parse_npy(out[5]).copy()
        vec[::2] *= -1  # one image's embedding altered where it is produced
        out[5] = npy.serialize_npy(vec)
        return out

    monkeypatch.setattr(ClipImpl, "predict", predict)


def _unchanged_index(monkeypatch):
    from panoptikon_tpu_torch.index import VectorIndex

    real = VectorIndex.add

    def add(self, space, item_ids, row_ids, vectors, weights=None):
        if not self.space_names():
            real(self, space, item_ids, row_ids, vectors, weights)  # the first batch only

    monkeypatch.setattr(VectorIndex, "add", add)


@pytest.mark.parametrize("cell,fault", [
    ("tiny-similar", _half_batch_search), ("tiny-similar", _altered_search),
    ("tiny-similar-b2", _half_batch_search), ("tiny-similar-b2", _altered_search),
    ("tiny-build", _half_batch_build), ("tiny-build", _altered_build),
    ("tiny-build", _unchanged_index),
])
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    assert not _run(cell).correct


@pytest.mark.parametrize("cell", ["tiny-similar", "tiny-similar-b2", "tiny-build"])
def test_the_control_is_not_correct(cell):
    """The control, the reference one precision below the configuration's,
    fails the cell's limit where the program passes it, on three seeds."""
    for seed in (1, 2**31 + 5, 2**32 + 9):
        out = _run(cell, seed=seed, seconds=0.1)
        assert out.correct
        limits = out.reading.cell.limits
        control = dict(SPEC.kind(out.reading.cell).control(out.state))
        assert any(value > limits[name] for name, value in control.items())
