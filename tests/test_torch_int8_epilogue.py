"""The fused epilogue of the static-int8 CLIP block's int8 GEMMs
(``ops/int8_epilogue.py``) on the CPU, where the wrapper runs its plain form.

The plain form is held bit for bit to the chain of passes it replaced (the
block's old ``_linear_prequant``, residual add, GELU and ``_linear``'s
static quantize), at ragged widths and at widths that ``int_mm`` pads, and
the new ``_block_int8_static`` to the old composition of the block on the
tiny configuration, image tower and causal text tower. The kernel itself is
held to the plain form on the card (``test_torch_cuda_kernels.py``)."""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from panoptikon_tpu_torch import tracing
from panoptikon_tpu_torch.models import clip
from panoptikon_tpu_torch.ops import int8_epilogue, ln_quant, vit_attention
from panoptikon_tpu_torch.ops.codec import quantize_static, static_step

CFG = clip.CONFIGS["test-tiny"]
INT8 = dataclasses.replace(CFG, matmul_precision="int8")
VARIANTS = ["bf16", "residual", "gelu_quant"]
# (m, k, n): int_mm pads m, k and n / n alone (a strided output) / nothing
SHAPES = [(3, 20, 13), (40, 64, 100), (70, 64, 192)]


def _old_linear_prequant(xq, act_scale, w, b):
    """The block's int8 linear before the fused epilogue."""
    y = clip._int8_matmul(xq, w["q"]).to(torch.float32) * static_step(act_scale, xq.device) * w["s"]
    if b is not None:
        y = y + b.to(torch.float32)
    return y.to(torch.bfloat16)


def _old_block(x, p, heads, causal, scales):
    """``_block_int8_static`` before the fused epilogue: the residual adds,
    GELU and proj through ``_linear``'s int8 branch as separate passes."""
    aq = ln_quant.ln_quant(x, p["ln_1"], scales[0])
    qkv = _old_linear_prequant(aq, scales[0], p["attn"]["qkv_w"], p["attn"]["qkv_b"])
    att_q = vit_attention.mha_qkv(qkv, heads=heads, causal=causal, out_scale=scales[1])
    x = x + _old_linear_prequant(att_q, scales[1], p["attn"]["out_w"], p["attn"]["out_b"])
    hq = ln_quant.ln_quant(x, p["ln_2"], scales[2])
    h = _old_linear_prequant(hq, scales[2], p["mlp"]["fc_w"], p["mlp"]["fc_b"])
    h = F.gelu(h, approximate="tanh")
    h = clip._linear(h, p["mlp"]["proj_w"], p["mlp"]["proj_b"], "int8", scales[3])
    return x + h


def _operands(m, k, n, seed, bias_dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    xq = torch.randint(-127, 128, (m, k), generator=gen, dtype=torch.int8)
    w = clip._quantize_weight(torch.randn((k, n), generator=gen) * k**-0.5)
    b = (torch.randn(n, generator=gen) * 0.1).to(bias_dtype)
    x = torch.randn((m, n), generator=gen).to(torch.bfloat16)
    return xq, w, b, x


@pytest.mark.parametrize("shape", SHAPES, ids=["padded", "strided", "aligned"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_plain_form_equals_the_chain_it_replaces(variant, shape):
    m, k, n = shape
    xq, w, b, x = _operands(m, k, n, seed=m + n)
    s, s3 = torch.tensor(37.5), torch.tensor(2.25)  # absmax of the input, of the hidden
    acc = clip._int_mm(xq, w["q"])
    if n % 8:
        assert acc.stride(0) > n  # a padded output cut back to [:m, :n]
    old = _old_linear_prequant(xq, s, w, b)
    if variant == "bf16":
        got = int8_epilogue.int8_epilogue(acc, static_step(s, "cpu"), w["s"], b)
    elif variant == "residual":
        got = int8_epilogue.int8_epilogue(acc, static_step(s, "cpu"), w["s"], b, residual=x)
        old = x + old
    else:
        got = int8_epilogue.int8_epilogue(acc, static_step(s, "cpu"), w["s"], b,
                                          out_step=static_step(s3, "cpu"))
        old = quantize_static(F.gelu(old, approximate="tanh").to(torch.float32), s3)
        assert 0 < (old.abs() == 127).sum() < old.numel()  # some codes clip, not all
    assert got.dtype == old.dtype and got.shape == old.shape
    assert torch.equal(got, old)


@pytest.mark.parametrize("variant", VARIANTS)
def test_plain_form_takes_a_bf16_bias_or_none(variant):
    xq, w, b, x = _operands(9, 24, 16, seed=4, bias_dtype=torch.bfloat16)
    s = torch.tensor(20.0)
    step = static_step(s, "cpu")
    extra = {"bf16": {}, "residual": {"residual": x}, "gelu_quant": {"out_step": step}}[variant]
    acc = clip._int_mm(xq, w["q"])
    for bias in (b, None):
        y = _old_linear_prequant(xq, s, w, bias)
        want = {"bf16": y, "residual": x + y,
                "gelu_quant": quantize_static(F.gelu(y, approximate="tanh").float(), s)}[variant]
        assert torch.equal(int8_epilogue.int8_epilogue(acc, step, w["s"], bias, **extra), want)


def test_wrapper_refuses_what_it_cannot_take():
    xq, w, b, x = _operands(5, 16, 8, seed=1)
    acc, step = clip._int_mm(xq, w["q"]), static_step(torch.tensor(3.0), "cpu")
    with pytest.raises(ValueError, match="not both"):
        int8_epilogue.int8_epilogue(acc, step, w["s"], b, residual=x, out_step=step)
    with pytest.raises(ValueError, match="must hold"):
        int8_epilogue.int8_epilogue(acc, step, w["s"][:, :4], b)
    with pytest.raises(ValueError, match="unsupported device"):
        int8_epilogue.int8_epilogue(acc.to("meta"), step.to("meta"), w["s"].to("meta"),
                                    b.to("meta"))


@pytest.fixture(scope="module")
def tiny():
    gen = torch.Generator().manual_seed(11)
    params = clip.quantize_block_weights(clip.init_params(CFG, gen))
    rng = np.random.default_rng(11)
    images = torch.from_numpy(rng.normal(size=(4, CFG.image_size, CFG.image_size, 3))
                              .astype(np.float32))
    ids = torch.from_numpy(rng.integers(1, CFG.text_vocab - 1, size=(4, CFG.text_ctx)))
    ids[:, -3] = CFG.text_vocab - 1  # the EOT token at the argmax
    return {"params": params, "images": images, "ids": ids,
            "visual": clip.calibrate_image_scales(params, INT8, images),
            "text": clip.calibrate_text_scales(params, INT8, ids)}


@pytest.mark.parametrize("tower", ["visual", "text"])
def test_static_block_equals_the_old_composition(tiny, tower):
    heads, causal = ((CFG.vision_heads, False) if tower == "visual"
                     else (CFG.text_heads, True))
    for layer, blk in enumerate(tiny["params"][tower]["blocks"]):
        width = blk["attn"]["out_w"]["q"].shape[0]
        gen = torch.Generator().manual_seed(layer)
        x = (torch.randn((3, 9, width), generator=gen) * 2).to(torch.bfloat16)
        scales = tiny[tower][layer]
        got = clip._block_int8_static(x, blk, heads, causal, scales)
        want = _old_block(x, blk, heads, causal, scales)
        assert got.dtype == torch.bfloat16 and got.shape == x.shape
        assert torch.equal(got, want)


@pytest.fixture
def fresh_counters():
    tracing.reset()
    yield
    tracing.reset()


def test_epilogue_values_are_counted_under_the_profiler(tiny, fresh_counters):
    images = tiny["images"][:2]
    tokens = CFG.grid * CFG.grid + 1
    clip.embed_images_scaled(tiny["params"], INT8, images, tiny["visual"])
    assert tracing.counters() == {}  # the profiler is off: nothing recorded
    with profile(activities=[ProfilerActivity.CPU]):
        clip.embed_images_scaled(tiny["params"], INT8, images, tiny["visual"])
    width = CFG.vision_width
    per_layer = (3 + 1 + CFG.mlp_ratio + 1) * width  # qkv, out, fc, proj
    assert tracing.counters() == {
        "clip.int8_epilogue_values": 2 * tokens * per_layer * CFG.vision_layers}
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        clip.embed_texts_scaled(tiny["params"], INT8, tiny["ids"][:3], tiny["text"])
    per_layer = (3 + 1 + CFG.mlp_ratio + 1) * CFG.text_width
    assert tracing.counters() == {
        "clip.int8_epilogue_values": 3 * CFG.text_ctx * per_layer * CFG.text_layers}
