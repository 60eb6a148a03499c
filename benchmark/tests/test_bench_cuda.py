"""On the card: a cell's run, and the control at the cell's own size. Marked
``cuda``; they skip without a card. Run there with
``python -m pytest -m cuda benchmark/tests/test_bench_cuda.py``."""

import json
import subprocess
import sys

import pytest
import torch

from benchmark.spec import ROOT, Spec

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.parametrize("cell", Spec.load().cell_names())
def test_a_run_on_the_card_is_correct(card, cell):
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                           str(2**31 + 17), "--seconds", "2", "--trace", "0"], cwd=ROOT,
                          capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])["correct"]


@pytest.mark.parametrize("cell", Spec.load().cell_names())
def test_the_control_fails_at_the_cells_size(card, cell):
    """Three seeds: every program reading under the cell's limit, and on
    each seed a control reading over it."""
    proc = subprocess.run([sys.executable, "benchmark/control.py", "--workload", cell, "--seeds",
                           "11,12,13", "--seconds", "2"], cwd=ROOT, capture_output=True,
                          text=True, timeout=1800)
    assert proc.returncode == 0, proc.stderr[-4000:]
    limits = Spec.load().cell(cell).limits
    for line in proc.stdout.strip().splitlines()[:-1]:
        seed = json.loads(line)
        assert all(seed["program"][n] <= limits[n] for n in seed["program"])
        assert any(v > limits[n] for n, v in seed["control"].items())
