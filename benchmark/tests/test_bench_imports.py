"""Nothing the benchmark runs imports JAX or the JAX package, and the plain
references import nothing of the program (top-level names compared whole)."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark.run import FORBIDDEN, forbidden_modules
from benchmark.spec import BENCH_DIR, ROOT

SOURCES = sorted(p for p in BENCH_DIR.rglob("*.py") if "tests" not in p.parts)


def _top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_names_are_compared_whole():
    assert forbidden_modules(["panoptikon_tpu_torch", "panoptikon_tpu_torch.ops", "jaxtyping",
                              "flaxen", "torch"]) == []
    assert forbidden_modules(["panoptikon_tpu.ops", "jax.numpy", "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib", "panoptikon_tpu"]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not _top_level_imports(path) & set(FORBIDDEN)


@pytest.mark.parametrize("path", sorted((BENCH_DIR / "references").glob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    assert _top_level_imports(path) <= {"__future__", "contextlib", "math", "numpy", "torch",
                                        "benchmark"}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module.startswith("benchmark"):
            assert node.module.startswith("benchmark.references")


RUN_A_CELL = """
import sys, time
sys.path.insert(0, {root!r})
import torch
from benchmark import harness
from benchmark.run import forbidden_modules
from benchmark.spec import Spec
spec = Spec.load({data!r} + "/BENCHMARK.json", data_dirs=[{data!r}])
for cell in ("tiny-similar", "tiny-build"):
    out = harness.run(spec, cell, 1, 0.2, False, torch.device("cpu"), time.perf_counter())
    assert out.correct
print(forbidden_modules())
"""


def test_a_run_loads_no_jax():
    data = str(Path(__file__).resolve().parent / "data")
    proc = subprocess.run([sys.executable, "-c", RUN_A_CELL.format(root=str(ROOT), data=data)],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"


REFERENCES_ALONE = """
import sys
sys.path.insert(0, {root!r})
import torch
from benchmark.references import clip_vit, exact_topk
exact_topk.cosine_sims(torch.ones(4, 8), torch.ones(2, 8))
print(sorted({{m.split(".")[0] for m in sys.modules}} & {{"panoptikon_tpu_torch", "jax",
                                                          "panoptikon_tpu"}}))
"""


def test_references_load_nothing_of_the_program():
    proc = subprocess.run([sys.executable, "-c", REFERENCES_ALONE.format(root=str(ROOT))],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"
