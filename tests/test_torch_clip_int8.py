"""The port's static-int8 CLIP path (models/clip.py) against
panoptikon_tpu/models/clip.py at test-tiny, on the same parameters (a JAX
tree carried over by models.convert) and seeded inputs.

What must be exact is exact: the int8 weight codes and scales, the int8 GEMM
and its epilogue. What rounds differently (sum order, bf16 cast points) is
held to the repo's embedding gates: cosine ≥ 0.999 per image row; for the
32-wide tiny text tower min ≥ 0.998 and mean ≥ 0.999
(tests/test_int8_fidelity.py). Off the TPU the JAX block takes its split
route (XLA attention), so the port is also held against the JAX fused route,
built here from the JAX package's own functions."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panoptikon_tpu.models import clip as ref
from panoptikon_tpu.ops import ln_quant as ref_lnq
from panoptikon_tpu.ops import vit_attention as ref_attn
from panoptikon_tpu_torch.models import clip, convert
from panoptikon_tpu_torch.ops import ln_quant, vit_attention

from test_torch_clip import _cos, tokens

CFG = clip.CONFIGS["test-tiny"]
INT8 = dataclasses.replace(CFG, matmul_precision="int8")


def _t(tree):
    return convert.params_from_jax(jax.tree.map(np.asarray, tree), device="cpu")


@pytest.fixture(scope="module")
def tiny():
    jparams = ref.init_params(jax.random.key(5), ref.CONFIGS["test-tiny"])
    jq = ref.quantize_block_weights(jparams)
    rng = np.random.default_rng(5)
    images = rng.normal(size=(6, CFG.image_size, CFG.image_size, 3)).astype(np.float32)
    ids = tokens(rng, 6, CFG.text_ctx, CFG.text_vocab)
    js = ref.calibrate_image_scales(jq, INT8, images)
    jt = ref.calibrate_text_scales(jq, INT8, ids)
    return {"jparams": jparams, "jq": jq, "tq": _t(jq), "images": images, "ids": ids,
            "js": js, "jt": jt, "ts": torch.from_numpy(np.array(js)),
            "tt": torch.from_numpy(np.array(jt))}


def _image_gate(got, want):
    assert got.shape == want.shape
    assert _cos(got, want).min() >= 0.999, _cos(got, want).min()


def _text_gate(got, want):
    cos = _cos(got, want)
    assert cos.min() >= 0.998 and cos.mean() >= 0.999, (cos.min(), cos.mean())


def test_convert_keeps_quantized_leaves(tiny):
    # A bf16 carry-over must not round the int8 codes' per-channel scales.
    tree = convert.params_from_jax(jax.tree.map(np.asarray, tiny["jq"]), device="cpu",
                                   dtype=torch.bfloat16)
    qkv = tree["visual"]["blocks"][0]["attn"]["qkv_w"]
    want = tiny["jq"]["visual"]["blocks"][0]["attn"]["qkv_w"]
    assert qkv["q"].dtype == torch.int8 and qkv["s"].dtype == torch.float32
    np.testing.assert_array_equal(qkv["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(qkv["s"].numpy(), np.asarray(want["s"]))
    assert tree["visual"]["blocks"][0]["attn"]["qkv_b"].dtype == torch.bfloat16
    assert tree["text"]["blocks"][1]["mlp"]["proj_w"]["s"].dtype == torch.float32


def test_quantize_block_weights_matches_reference(tiny):
    got = clip.quantize_block_weights(_t(tiny["jparams"]))
    want = jax.tree.map(np.asarray, tiny["jq"])
    got_leaves, want_leaves = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        np.testing.assert_array_equal(g.numpy(), w)
    codes = got["visual"]["blocks"][0]["mlp"]["fc_w"]["q"]
    assert codes.t().is_contiguous()  # column-major, as _int_mm takes it


@pytest.mark.parametrize("m,k,n", [(3, 20, 13), (16, 64, 8), (40, 64, 192)])
def test_int_mm_shape_rule(m, k, n):
    rng = np.random.default_rng(m)
    a = rng.integers(-127, 128, size=(m, k), dtype=np.int8)
    b = rng.integers(-127, 128, size=(k, n), dtype=np.int8)
    got = clip._int_mm(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32 and tuple(got.shape) == (m, n)
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ b.astype(np.int64))


def test_linear_prequant_matches_reference(tiny):
    rng = np.random.default_rng(6)
    w = tiny["jq"]["visual"]["blocks"][1]["attn"]["qkv_w"]
    xq = rng.integers(-127, 128, size=(3, 5, w["q"].shape[0]), dtype=np.int8)
    b = rng.normal(size=w["q"].shape[1]).astype(np.float32)
    want = np.asarray(ref._linear_prequant(jnp.asarray(xq), jnp.float32(3.7), w, jnp.asarray(b)),
                      np.float32)
    got = clip._linear_prequant(torch.from_numpy(xq), torch.tensor(3.7), _t(w), torch.from_numpy(b))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.to(torch.float32).numpy(), want)


@pytest.mark.parametrize("branch", ["bf16_prequant", "int8_dynamic", "int8_static"])
def test_linear_branches_match_reference(tiny, branch):
    rng = np.random.default_rng(7)
    jw = tiny["jparams"]["visual"]["blocks"][0]["mlp"]["fc_w"]
    x = rng.normal(size=(2, 5, jw.shape[0])).astype(np.float32)
    b = rng.normal(size=jw.shape[1]).astype(np.float32)
    if branch == "bf16_prequant":
        w, precision, s = tiny["jq"]["visual"]["blocks"][0]["mlp"]["fc_w"], "bf16", None
    else:
        w, precision = jw, "int8"
        s = np.float32(4.0) if branch == "int8_static" else None
    jx, tx = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    jcol, tcol = [], []
    want = ref._linear(jx, w, jnp.asarray(b), precision, None if s is None else jnp.asarray(s), jcol)
    got = clip._linear(tx, _t(w), torch.from_numpy(b), precision,
                       None if s is None else torch.tensor(s), tcol)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.to(torch.float32).numpy(), np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)
    assert float(tcol[0]) == float(jcol[0])  # the calibration collector


@pytest.mark.parametrize("tower", ["image", "text"])
def test_calibration_matches_reference(tiny, tower):
    tq = tiny["tq"]
    if tower == "image":
        got = clip.calibrate_image_scales(tq, INT8, torch.from_numpy(tiny["images"]))
        want, layers = np.asarray(tiny["js"]), CFG.vision_layers
    else:
        got = clip.calibrate_text_scales(tq, INT8, torch.from_numpy(tiny["ids"]))
        want, layers = np.asarray(tiny["jt"]), CFG.text_layers
    assert tuple(got.shape) == (layers, 4) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-2)


def test_static_image_embed_matches_reference(tiny):
    images = tiny["images"]
    want = np.asarray(ref.embed_images_scaled_jit(tiny["jq"], INT8, images, tiny["js"]))
    got = clip.embed_images_scaled(tiny["tq"], INT8, torch.from_numpy(images), tiny["ts"]).numpy()
    _image_gate(got, want)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)
    raw_want = np.asarray(ref.embed_images_raw_scaled_jit(tiny["jq"], INT8, images, tiny["js"]))
    raw = clip.embed_images_raw_scaled(tiny["tq"], INT8, torch.from_numpy(images), tiny["ts"])
    _image_gate(raw.numpy(), raw_want)
    np.testing.assert_allclose(raw.numpy() / np.linalg.norm(raw.numpy(), axis=-1, keepdims=True),
                               got, atol=1e-5)


def test_static_text_embed_matches_reference(tiny):
    ids = tiny["ids"]
    want = np.asarray(ref.embed_texts_scaled_jit(tiny["jq"], INT8, ids, tiny["jt"]))
    got = clip.embed_texts_scaled(tiny["tq"], INT8, torch.from_numpy(ids), tiny["tt"]).numpy()
    _text_gate(got, want)


def _jax_fused_block(x, p, heads, causal, scales):
    """The JAX package's fused (TPU) route of _block_int8_static, from its own
    functions, with Pallas in interpret mode."""
    aq = ref_lnq._ln_quant_ref(x, p["ln_1"]["scale"], p["ln_1"]["bias"], scales[0])
    qkv = ref._linear_prequant(aq, scales[0], p["attn"]["qkv_w"], p["attn"]["qkv_b"])
    att_q = ref_attn.mha_qkv(qkv, heads=heads, causal=causal, out_scale=scales[1], interpret=True)
    x = x + ref._linear_prequant(att_q, scales[1], p["attn"]["out_w"], p["attn"]["out_b"])
    hq = ref_lnq._ln_quant_ref(x, p["ln_2"]["scale"], p["ln_2"]["bias"], scales[2])
    h = ref._linear_prequant(hq, scales[2], p["mlp"]["fc_w"], p["mlp"]["fc_b"])
    h = jax.nn.gelu(h, approximate=True)
    return x + ref._linear(h, p["mlp"]["proj_w"], p["mlp"]["proj_b"], "int8", scales[3])


def test_static_embed_matches_jax_fused_route(tiny, monkeypatch):
    monkeypatch.setattr(ref, "_block_int8_static", _jax_fused_block)
    jq, images, ids = tiny["jq"], tiny["images"], tiny["ids"]
    want_img = np.asarray(ref.encode_image(jq, INT8, jnp.asarray(images), act_scales=tiny["js"]))
    want_txt = np.asarray(ref.encode_text(jq, INT8, jnp.asarray(ids), act_scales=tiny["jt"]))
    got_img = clip.embed_images_scaled(tiny["tq"], INT8, torch.from_numpy(images), tiny["ts"])
    got_txt = clip.embed_texts_scaled(tiny["tq"], INT8, torch.from_numpy(ids), tiny["tt"])
    _image_gate(got_img.numpy(), want_img)
    _text_gate(got_txt.numpy(), want_txt)


def test_static_path_runs_the_fused_block_and_kernels(tiny, monkeypatch):
    calls = {"block": 0, "mha_qkv": 0, "ln_quant_2d": 0, "mha": 0}

    def spy(module, name, key):
        orig = getattr(module, name)

        def wrapped(*args, **kwargs):
            calls[key] += 1
            return orig(*args, **kwargs)

        monkeypatch.setattr(module, name, wrapped)

    spy(clip, "_block_int8_static", "block")
    spy(vit_attention, "mha_qkv", "mha_qkv")
    spy(vit_attention, "mha", "mha")
    spy(ln_quant, "ln_quant_2d", "ln_quant_2d")
    clip.embed_images_scaled(tiny["tq"], INT8, torch.from_numpy(tiny["images"][:2]), tiny["ts"])
    clip.embed_texts_scaled(tiny["tq"], INT8, torch.from_numpy(tiny["ids"][:2]), tiny["tt"])
    layers = CFG.vision_layers + CFG.text_layers
    assert calls == {"block": layers, "mha_qkv": layers, "ln_quant_2d": 2 * layers, "mha": 0}
    # Calibration is the bf16 pass: the split route through mha.
    clip.calibrate_image_scales(tiny["tq"], INT8, torch.from_numpy(tiny["images"][:2]))
    assert calls["mha"] == CFG.vision_layers and calls["mha_qkv"] == layers


@pytest.mark.parametrize("tower", ["visual", "text"])
def test_static_block_matches_jax_fused_block(tiny, tower):
    # One block on its own, image (not causal) and text (causal): what the
    # block adds to its input, held against the JAX fused route's.
    heads, causal, key = ((CFG.vision_heads, False, "js") if tower == "visual"
                          else (CFG.text_heads, True, "jt"))
    scales = np.array(tiny[key])[1]
    width = tiny["jq"][tower]["blocks"][1]["attn"]["out_w"]["q"].shape[0]
    x = np.random.default_rng(9).normal(size=(3, 9, width)).astype(np.float32)
    jx, tx = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    want = _jax_fused_block(jx, tiny["jq"][tower]["blocks"][1], heads, causal, jnp.asarray(scales))
    got = clip._block_int8_static(tx, tiny["tq"][tower]["blocks"][1], heads, causal,
                                  torch.from_numpy(scales))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == x.shape
    delta_want = np.asarray(want, np.float32) - np.asarray(jx, np.float32)
    delta_got = (got - tx).to(torch.float32).numpy()
    cos = _cos(delta_got.reshape(-1, width), delta_want.reshape(-1, width))
    assert cos.min() >= 0.999, cos.min()
