"""The port imports no JAX, no ``aiohttp`` and no ``multidict`` (the card
machine has none of them) and nothing of the JAX package, and never falls
back from CUDA to the CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from panoptikon_tpu_torch.device import device

REPO = Path(__file__).resolve().parent.parent

_IMPORT_ALL = """
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any import of jax now raises ImportError
sys.modules["panoptikon_tpu"] = None  # and so does any import of the JAX package
sys.modules["aiohttp"] = None  # and of aiohttp: the port serves on its own transport
sys.modules["multidict"] = None  # and of multidict: its headers are the transport's
import panoptikon_tpu_torch
names = [m.name for m in pkgutil.walk_packages(panoptikon_tpu_torch.__path__, "panoptikon_tpu_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib")))
assert not [m for m in leaked if sys.modules[m] is not None], leaked
# the registry finds the port's own built-in TOML, not the JAX package's
from panoptikon_tpu_torch.models.registry import Registry
assert "textembed/mpnet-base" in Registry(None).all_ids()
reference = sorted(m for m in sys.modules if m.startswith("panoptikon_tpu."))
assert sys.modules["panoptikon_tpu"] is None and not reference, reference
print(" ".join(names))
"""


def test_every_port_module_imports_without_jax():
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    # every module of the port was imported, the serving embed's and the
    # host copies included
    assert len(names) >= 27
    for name in ("ops.ln_quant", "ops.vit_attention", "ops.int8_scan", "models.clip",
                 "models.impls", "models.convert", "index.vector_index",
                 "models.base", "models.batching", "utils.npy", "ops.fusion", "pql.executor",
                 "pql.fused", "pql.model", "pql.preprocess", "db.store", "db.writer",
                 "utils.splitmix", "models.text_embed", "models.weights", "models.registry",
                 "models.discovery", "models.manager", "db.bulk", "resources", "native",
                 "jobs.queue", "jobs.index_sync", "jobs.reconcile", "jobs.extraction",
                 "jobs.input_handlers", "jobs.outro", "jobs.media", "jobs.scan",
                 "models.whisper", "models.audio", "models.ocr", "api.web", "api.server",
                 "api.policy", "api.policy_token", "api.relay", "api.search_cache", "config",
                 "db.config_file", "db.setup", "pql.build", "jobs.cron", "jobs.continuous",
                 "jobs.supervisor", "jobs.prewarm", "models.pool", "models.http_backend",
                 "client", "cli", "desktop", "utils.env_template", "utils.rootlock",
                 "utils.schema_gen", "utils.version", "utils.toml_edit", "index.sharded",
                 "parallel.mesh", "parallel.multihost", "parallel.train", "api.proxy",
                 "api.web_client", "aclient"):
        assert f"panoptikon_tpu_torch.{name}" in names


def _imported_modules(tree):
    modules = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            modules.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom):
            modules.add("." * node.level + (node.module or ""))
    return modules


def test_no_port_source_imports_the_jax_package():
    # Statically, lazy imports inside functions included: every source of the
    # port imports only the port, the standard library and third parties
    # other than JAX.
    sources = sorted((REPO / "panoptikon_tpu_torch").rglob("*.py"))
    assert len(sources) >= 27
    assert {"models/text_embed.py", "models/weights.py", "models/registry.py",
            "models/discovery.py", "models/manager.py", "db/bulk.py", "resources/__init__.py",
            "models/whisper.py", "models/audio.py", "models/ocr.py", "index/sharded.py",
            "parallel/mesh.py", "parallel/multihost.py"} <= {
        str(p.relative_to(REPO / "panoptikon_tpu_torch")) for p in sources}
    for path in sources:
        modules = _imported_modules(ast.parse(path.read_text()))
        top = {m.split(".")[0] for m in modules}
        assert not top & {"jax", "jaxlib", "panoptikon_tpu", "aiohttp", "multidict"}, (
            path, sorted(modules))
        assert not any(m.startswith(".") for m in modules), (path, "relative import")


def test_chip_smoke_imports_only_the_port():
    # chip_smoke.py drives the port: no import of jax, aiohttp, multidict or
    # the JAX package, not even of its jax-free modules (the port has its own
    # copies).
    modules = _imported_modules(ast.parse((REPO / "chip_smoke.py").read_text()))
    top = {m.split(".")[0] for m in modules}
    assert "panoptikon_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "panoptikon_tpu", "aiohttp", "multidict"}, sorted(modules)


def test_cuda_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        device("cuda")
    with pytest.raises(RuntimeError):
        device("cuda:0")
    assert device("cpu") == torch.device("cpu")


def test_params_from_jax_defaults_to_the_card(monkeypatch):
    # Weights carried over from the JAX package land on the card unless the
    # caller names the CPU; without CUDA the default raises rather than
    # running the tower on the CPU through the kernels' plain versions.
    from panoptikon_tpu_torch.models import convert

    tree = {"w": np.ones((2, 3), np.float32), "blocks": [{"b": np.zeros(3, np.float32)}]}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.params_from_jax(tree)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.params_from_jax(tree, dtype=torch.bfloat16)
    out = convert.params_from_jax(tree, device="cpu")
    assert out["w"].device.type == "cpu" and out["blocks"][0]["b"].device.type == "cpu"


def test_missing_cuda_ordinal_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert device("cuda") == torch.device("cuda", 0)
    with pytest.raises(RuntimeError):
        device("cuda:1")
