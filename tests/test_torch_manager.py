"""The port's model manager (``models/manager.py``, a copy of the JAX
package's held to it by ``test_torch_host_copies.py``) driven through the
port's registry, ``IMPL_INDEX`` and fixture impls: LRU eviction, TTL
renewal and expiry, pinning, the dispatch window merging concurrent
predicts, the per-request fallback after a merged failure, the batch split
on a CUDA out-of-memory error (``torch.OutOfMemoryError``), prewarm, an
``impl_class`` the port lacks, and the built-in registry's text models."""

import threading
import time

import numpy as np
import pytest
import torch

from panoptikon_tpu_torch.models import registry as registry_mod
from panoptikon_tpu_torch.models.base import PredictionInput
from panoptikon_tpu_torch.models.impls import IMPL_INDEX, LoadCountImpl, npy
from panoptikon_tpu_torch.models.manager import ModelLoadError, ModelManager, _is_oom
from panoptikon_tpu_torch.models.registry import Registry

FIXTURES = """
[group.fixtures]
config.impl_class = "echo_impl"

[group.fixtures.metadata]
default_batch_size = 8

[group.fixtures.inference_ids.echo]
[group.fixtures.inference_ids.slots]
config.impl_class = "errorslot_impl"
[group.fixtures.inference_ids.slow]
config.impl_class = "slow_impl"
config.delay = 0.3
[group.fixtures.inference_ids.batchsize]
config.impl_class = "batchsize_impl"
[group.fixtures.inference_ids.failbatch]
config.impl_class = "failbatch_impl"
[group.fixtures.inference_ids.loadcount]
config.impl_class = "loadcount_impl"
[group.fixtures.inference_ids.cuda_oom]
config.impl_class = "cuda_oom_impl"
[group.fixtures.inference_ids.unknown]
config.impl_class = "no_such_impl"
"""


class CudaOomImpl:
    """Raises what PyTorch's CUDA allocator raises for batches above
    ``oom_above``: a ``torch.OutOfMemoryError``."""

    def __init__(self, oom_above: int = 2, **_):
        self.oom_above = oom_above
        self.calls = []

    @classmethod
    def name(cls):
        return "cuda_oom_impl"

    def load(self):
        pass

    def unload(self):
        pass

    def predict(self, inputs):
        self.calls.append(len(inputs))
        if len(inputs) > self.oom_above:
            raise torch.OutOfMemoryError(
                "CUDA out of memory. Tried to allocate 20.00 GiB. GPU 0 has a total capacity "
                "of 79.19 GiB of which 1.00 GiB is free.")
        return [{"n": len(inputs)} for _ in inputs]


@pytest.fixture
def manager(tmp_path):
    (tmp_path / "00.toml").write_text(FIXTURES)
    m = ModelManager(Registry(tmp_path), {**IMPL_INDEX, "cuda_oom_impl": CudaOomImpl})
    yield m
    m.shutdown()


def _queued(manager, model, n):
    """Callers enqueue while the test holds the model lock; returns the
    entry once ``n`` requests wait."""
    entry = manager._models[model]
    for _ in range(400):
        with entry.qlock:
            if len(entry.queue) == n:
                return entry
        time.sleep(0.005)
    raise AssertionError(f"{n} requests never queued")


def _concurrent(manager, model, n, max_batch):
    manager.load_model(model)
    entry = manager._models[model]
    results = [None] * n
    entry.lock.acquire()
    threads = [threading.Thread(target=lambda i=i: results.__setitem__(
        i, manager.predict(model, [PredictionInput(data=i)], max_batch=max_batch)))
        for i in range(n)]
    for t in threads:
        t.start()
    _queued(manager, model, n)
    entry.lock.release()
    for t in threads:
        t.join(timeout=10)
    return results


def test_lru_evicts_the_oldest_and_renewal_moves_to_mru(manager):
    for model in ("fixtures/echo", "fixtures/slots", "fixtures/echo", "fixtures/batchsize"):
        manager.load_model(model, cache_key="k", lru_size=2)
    loaded = manager.loaded_models()
    assert "fixtures/slots" not in loaded
    assert "fixtures/echo" in loaded and "fixtures/batchsize" in loaded


def test_ttl_renews_on_load_and_expires_on_sweep(manager):
    manager.load_model("fixtures/echo", cache_key="k", ttl_seconds=0.05)
    first = manager.cache_expirations("k")["fixtures/echo"]
    manager.load_model("fixtures/echo", cache_key="k", ttl_seconds=30.0)
    assert manager.cache_expirations("k")["fixtures/echo"] > first + 20
    assert manager.sweep() == []
    manager.load_model("fixtures/echo", cache_key="k", ttl_seconds=0.0)
    time.sleep(0.01)
    assert manager.sweep() == ["fixtures/echo"]
    assert "fixtures/echo" not in manager.loaded_models()


def test_a_pinned_model_outlives_its_ttl(manager):
    manager.load_model("fixtures/slow", cache_key="k", ttl_seconds=0.0)
    out = []
    t = threading.Thread(target=lambda: out.append(manager.predict(
        "fixtures/slow", [PredictionInput(data={})], cache_key="k", ttl_seconds=0.0)))
    t.start()
    for _ in range(200):
        if manager._models["fixtures/slow"].predict_pins:
            break
        time.sleep(0.005)
    assert manager.sweep() == []  # pinned: skipped
    t.join(timeout=10)
    assert out == [[{"ok": True}]]
    time.sleep(0.01)
    assert manager.sweep() == ["fixtures/slow"]


def test_concurrent_predicts_merge_into_one_window(manager):
    results = _concurrent(manager, "fixtures/batchsize", 6, max_batch=8)
    assert {r[0]["observed_batch"] for r in results} == {6}


def test_window_respects_the_cap(manager):
    results = _concurrent(manager, "fixtures/batchsize", 6, max_batch=3)
    observed = [r[0]["observed_batch"] for r in results]
    assert max(observed) <= 3 and sum(observed) >= 6


def test_merged_failure_falls_back_per_request(manager):
    assert _concurrent(manager, "fixtures/failbatch", 4, max_batch=8) == [[{"ok": True}]] * 4


def test_cuda_out_of_memory_halves_the_batch(manager):
    exc = torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 MiB")
    assert _is_oom(exc) and not _is_oom(RuntimeError("shape mismatch"))
    out = manager.predict("fixtures/cuda_oom", [PredictionInput(data={}) for _ in range(8)])
    assert len(out) == 8 and all(o["n"] <= 2 for o in out)
    model = manager._models["fixtures/cuda_oom"].model
    assert model.calls[:3] == [8, 4, 2] and max(c for c in model.calls[1:]) <= 4
    model.oom_above = 0
    with pytest.raises(torch.OutOfMemoryError):
        manager.predict("fixtures/cuda_oom", [PredictionInput(data={})])


def test_prewarm_calls_prepare_once(manager):
    LoadCountImpl.reset_counters()
    manager.load_model("fixtures/loadcount", prewarm=True)
    manager.load_model("fixtures/loadcount", prewarm=True)
    manager.predict("fixtures/loadcount", [PredictionInput(data={})])
    assert (LoadCountImpl.loads, LoadCountImpl.prepares) == (1, 1)


def test_an_impl_the_port_lacks_raises_at_load(manager):
    # The port has every impl_class of the reference's, so the fixture names
    # one that neither package has: it raises at load, as the reference's
    # manager does.
    with pytest.raises(ModelLoadError, match="unknown impl_class 'no_such_impl'"):
        manager.load_model("fixtures/unknown")
    with pytest.raises(ModelLoadError, match="deliberately broken"):
        ModelManager(manager.registry, {"echo_impl": IMPL_INDEX["broken_impl"]}).load_model(
            "fixtures/echo")
    assert "fixtures/unknown" not in manager.loaded_models()


def test_builtin_registry_serves_the_text_models(monkeypatch):
    # The port's copy of the built-in registry resolves textembed/* to
    # TextEmbedImpl; the manager loads minilm-l6 (with the registry's
    # combine_threshold and batch size) and embeds through it. The impl
    # runs on the card by default, so the test asks for the CPU.
    registry = Registry(None)
    assert registry.builtin_dir == registry_mod.packaged_builtin_dir()
    rid = registry.resolve("textembed", "minilm-l6")
    assert IMPL_INDEX[rid.impl_class].__name__ == "TextEmbedImpl"
    assert rid.spawn_kwargs() == {"combine_threshold": 4, "model_arch": "minilm-l6"}
    monkeypatch.setattr(rid, "config", {**rid.config, "device": "cpu"})
    manager = ModelManager(registry, IMPL_INDEX)
    try:
        out = manager.predict("textembed/minilm-l6",
                              [PredictionInput(data={"text": "a red car", "task": "s2s"})])
        assert manager._models["textembed/minilm-l6"].default_batch == 64
    finally:
        manager.shutdown()
    emb = npy.parse_npy(out[0])
    assert emb.shape == (1, 384) and np.isfinite(emb).all()
