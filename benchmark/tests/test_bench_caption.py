"""The caption_build and text_search kinds at a test size on the CPU, through
``harness.run``: their last lines, ``correct`` false when the timed path is
broken underneath, the controls, and ``moe_counts`` against hand-worked
counts."""

import json
import time
from pathlib import Path

import pytest
import torch

from benchmark import harness, moe_counts, run
from benchmark.spec import Spec

DATA = Path(__file__).resolve().parent / "data"
SPEC = Spec.load(DATA / "BENCHMARK.caption.json", data_dirs=[DATA])
CPU = torch.device("cpu")
CELLS = ["tiny-caption", "tiny-text"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The test size's ops are far smaller than a thread pool's start-up."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _run(cell, traced=False, seed=2**31 + 3, seconds=0.3):
    return harness.run(SPEC, cell, seed, seconds, traced, CPU, time.perf_counter())


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_the_last_line(cell, traced):
    out = _run(cell, traced)
    metrics = harness.read_metrics(SPEC, out, traced)
    device = {"platform": "gpu", "kind": "test", "count": 1, "memory_peak_bytes": 0}
    if traced:
        device.update(busy_s=out.reading.slice.busy_s, window_s=out.reading.slice.wall_s)
    line = json.loads(json.dumps(run.result_line(out, metrics, device, traced)))
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    want = SPEC.cell(cell).per_layer if traced else SPEC.cell(cell).end_to_end
    assert set(line["metrics"]) <= {m["name"] for m in want}
    if not traced:
        assert set(line["metrics"]) == {m["name"] for m in want}
    elif cell == "tiny-caption":
        # The program's spans and counters are read (the device's idle share
        # needs the card).
        assert {"decode_step_ms", "decode_roofline_pct", "prefill_mfu_pct"} <= set(line["metrics"])
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]


def _half_the_captions(monkeypatch):
    from panoptikon_tpu_torch.models.impls import KimiVlImpl

    real = KimiVlImpl.predict_keeping

    def predict_keeping(self, inputs, keep=()):
        out, kept = real(self, inputs, keep)
        return out[: len(out) // 2], kept  # half of the batch's captions never come

    monkeypatch.setattr(KimiVlImpl, "predict_keeping", predict_keeping)


def _one_logit_row(monkeypatch):
    from panoptikon_tpu_torch.models import kimi_vl

    real = kimi_vl.generate

    def generate(*a, **kw):
        out = real(*a, **kw)
        if "logits" in out:
            logits = out["logits"].clone()
            logits[0, 2] = logits[0, 2].flip(0)  # one position's logits altered
            out["logits"] = logits
        return out

    monkeypatch.setattr(kimi_vl, "generate", generate)


def _stale_cache(monkeypatch):
    from panoptikon_tpu_torch.models import kimi_vl

    real = kimi_vl._decode_attention

    def decode_attention(h, layer, cfg, cache, pos, *rest):
        # The step attends as before but its latent row never reaches the
        # batch's cache: later steps read what the row held before.
        return real(h, layer, cfg, cache.clone(), pos, *rest)

    monkeypatch.setattr(kimi_vl, "_decode_attention", decode_attention)


def _one_query_vector(monkeypatch):
    from panoptikon_tpu_torch.models.impls import ClipImpl
    from panoptikon_tpu_torch.utils import npy

    real = ClipImpl.predict

    def predict(self, inputs):
        out = real(self, inputs)
        vec = npy.parse_npy(out[3]).copy()
        vec[::2] *= -1  # one query's embedding altered where it is produced
        out[3] = npy.serialize_npy(vec)
        return out

    monkeypatch.setattr(ClipImpl, "predict", predict)


@pytest.mark.parametrize("cell,fault", [
    ("tiny-caption", _half_the_captions), ("tiny-caption", _one_logit_row),
    ("tiny-caption", _stale_cache), ("tiny-text", _one_query_vector),
])
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    assert not _run(cell).correct


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    """The control, the reference one precision below the configuration's,
    fails the cell's limit where the program passes it, on three seeds."""
    for seed in (1, 2**31 + 5, 2**32 + 9):
        out = _run(cell, seed=seed, seconds=0.1)
        assert out.correct
        limits = out.reading.cell.limits
        control = dict(SPEC.kind(out.reading.cell).control(out.state))
        assert any(value > limits[name] for name, value in control.items())


KIMI = json.loads((Path(__file__).resolve().parents[1] / "configs" / "kimi-vl-a3b.json")
                  .read_text())
TRAFFIC = json.loads((Path(__file__).resolve().parents[1] / "traffic" / "caption-b64.json")
                     .read_text())


def test_the_configuration_is_the_ports():
    """Every width and depth of the configuration file is the port's
    Kimi-VL-A3B-Instruct, and the file holds the catalog's keys at its top
    level."""
    from benchmark.kinds import caption_build

    cfg = caption_build.port_config(KIMI)
    assert (cfg.hidden, cfg.layers, cfg.experts, cfg.vocab) == (2048, 27, 64, 163840)
    assert KIMI["reduced"] == [] and KIMI["q_lora_rank"] is None
    assert KIMI["port"] == {"arch": "Kimi-VL-A3B-Instruct", "inference_id": "vlm/kimi-vl-a3b"}


def test_moe_counts_by_hand():
    # MoonViT at 448 px: 1,024 patches of 588 values, 27 blocks of width
    # 1,152 and MLP 4,304, 256 merged tokens of 4,608 into 2,048.
    n, w, m = 1024, 1152, 4304
    block = 2 * n * (4 * w * w + 2 * w * m) + 4 * n * n * w
    want = 2 * n * 588 * w + 27 * block + 2 * 256 * 4608 * (4608 + 2048)
    assert moe_counts.vision_ops(KIMI) == want
    assert moe_counts.prompt_length(KIMI, TRAFFIC) == 6 + 256 + 16
    # A token's MLA projections: 2048·16·192 + 2048·576 + 512·16·256 + 16·128·2048.
    proj = 2 * (2048 * 3072 + 2048 * 576 + 512 * 4096 + 2048 * 2048)
    # Its feed-forward: one dense SwiGLU of 11,264, then 26 expert layers of
    # a 64-wide router and 6 routed + 2 shared experts of 1,408.
    ffn = 6 * 2048 * 11264 + 26 * (2 * 2048 * 64 + 6 * 2048 * 1408 * 8)
    assert moe_counts.ffn_ops(KIMI) == ffn
    attn = 2 * 16 * (192 + 128) * (278 + 1) / 2
    head = 2 * 64 * 2048 * 163840
    assert moe_counts.prefill_ops(KIMI, TRAFFIC) == pytest.approx(
        64 * 278 * (27 * (proj + attn) + ffn) + head)
    # The weights a decode step reads: 15.96B parameters but the 0.34B
    # embedding table, bf16, the routers f32.
    layer = 2048 * 3072 + 2048 * 576 + 512 + 512 * 4096 + 2048 * 2048 + 2 * 2048
    bf16 = 27 * layer + 3 * 2048 * 11264 + 26 * 3 * 2048 * 1408 * 66 + 2048 + 2048 * 163840
    assert moe_counts.lm_weight_bytes(KIMI) == 2 * bf16 + 4 * 26 * (2048 * 64 + 64)
    assert 31.2e9 < moe_counts.lm_weight_bytes(KIMI) < 31.3e9
    # The latent cache: 576 bf16 values a position, a layer, a row.
    assert moe_counts.cache_bytes_read(KIMI, TRAFFIC, 300) == 2 * 27 * 64 * 300 * 576
    # A decode step is bound by its bytes (0.35 TFLOP against 31 GB).
    ctx = 279
    bound = moe_counts.decode_step_bound(KIMI, TRAFFIC, ctx)
    moved = moe_counts.lm_weight_bytes(KIMI) + moe_counts.cache_bytes_read(KIMI, TRAFFIC, ctx)
    assert bound == pytest.approx(moved / 3.35e12) and 9.3e-3 < bound < 9.6e-3
    assert moe_counts.decode_bound(KIMI, TRAFFIC, 2) == pytest.approx(
        bound + moe_counts.decode_step_bound(KIMI, TRAFFIC, ctx + 1))
