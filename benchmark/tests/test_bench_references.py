"""The plain references against brute force at small sizes, the port against
the reference at a test size, and the controls."""

import json
import math
from pathlib import Path

import numpy as np
import torch

from benchmark import inputs
from benchmark.references import clip_vit, exact_topk

DATA = Path(__file__).resolve().parent / "data"
TINY = json.loads((DATA / "configs" / "tiny-clip.json").read_text())


def test_cosine_sims_by_brute_force():
    rng = np.random.default_rng(0)
    rows, queries = rng.standard_normal((50, 16)), rng.standard_normal((7, 16))
    want = np.array([[float(np.dot(q, r) / (np.linalg.norm(q) * np.linalg.norm(r))) for r in rows]
                     for q in queries])
    got = exact_topk.cosine_sims(torch.tensor(rows, dtype=torch.float32),
                                 torch.tensor(queries, dtype=torch.float32))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    low = exact_topk.cosine_sims(torch.tensor(rows, dtype=torch.float32),
                                 torch.tensor(queries, dtype=torch.float32), dtype=torch.bfloat16)
    assert 1e-4 < float(np.abs(low.numpy() - want).max()) < 3e-2


def _layernorm(x, scale, bias):
    mean = x.mean()
    var = ((x - mean) ** 2).mean()
    return (x - mean) / math.sqrt(var + 1e-5) * scale + bias


def _gelu(x):
    return 0.5 * x * (1 + np.tanh(math.sqrt(2 / math.pi) * (x + 0.044715 * x ** 3)))


def _brute_vit(p, config, image):
    """One image, token by token and head by head, in f64."""
    v = config["vision_cfg"]
    ps, g, w = v["patch_size"], v["image_size"] // v["patch_size"], v["width"]
    heads = w // config["assumed"]["vision_head_width"]
    d = w // heads
    tokens = [p["class_emb"]]
    for gy in range(g):
        for gx in range(g):
            patch = image[gy * ps:(gy + 1) * ps, gx * ps:(gx + 1) * ps, :].reshape(-1)
            tokens.append(patch @ p["patch_w"])
    x = [_layernorm(t + p["pos_emb"][i], p["ln_pre"]["scale"], p["ln_pre"]["bias"])
         for i, t in enumerate(tokens)]
    for blk in p["blocks"]:
        a = blk["attn"]
        h = [_layernorm(t, blk["ln_1"]["scale"], blk["ln_1"]["bias"]) for t in x]
        qkv = [t @ a["qkv_w"] + a["qkv_b"] for t in h]
        att = []
        for i in range(len(x)):
            out = np.zeros(w)
            for hd in range(heads):
                sl = slice(hd * d, (hd + 1) * d)
                q = qkv[i][:w][sl]
                logits = np.array([q @ qkv[j][w:2 * w][sl] / math.sqrt(d) for j in range(len(x))])
                e = np.exp(logits - logits.max())
                out[sl] = sum(e[j] / e.sum() * qkv[j][2 * w:][sl] for j in range(len(x)))
            att.append(out @ a["out_w"] + a["out_b"])
        x = [t + o for t, o in zip(x, att)]
        m = blk["mlp"]
        x = [t + _gelu(_layernorm(t, blk["ln_2"]["scale"], blk["ln_2"]["bias"]) @ m["fc_w"]
                       + m["fc_b"]) @ m["proj_w"] + m["proj_b"] for t in x]
    f = _layernorm(x[0], p["ln_post"]["scale"], p["ln_post"]["bias"]) @ p["proj"]
    return f / np.linalg.norm(f)


def _f64(tree):
    if isinstance(tree, dict):
        return {k: _f64(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_f64(v) for v in tree]
    return tree.double().numpy()


def test_clip_vit_by_brute_force():
    params = inputs.vit_params(TINY, 3, torch.device("cpu"))
    images = inputs.pixel_batches(TINY, 3, 1, 2, torch.device("cpu"))[0]
    got = clip_vit.embed_images(params, TINY, torch.from_numpy(images)).numpy()
    ref = _f64(params)
    for i in range(2):
        np.testing.assert_allclose(got[i], _brute_vit(ref, TINY, images[i].astype(np.float64)),
                                   atol=2e-5)


def test_the_port_computes_the_references_function():
    """The weight layout both sides read: the port's bf16 tower at the test
    size against the f32 reference, on the same weights."""
    from panoptikon_tpu_torch.models import clip

    params = inputs.vit_params(TINY, 5, torch.device("cpu"))
    images = torch.from_numpy(inputs.pixel_batches(TINY, 5, 1, 8, torch.device("cpu"))[0])
    port = clip.embed_images({"visual": params}, clip.CONFIGS["test-tiny"], images).numpy()
    ref = clip_vit.embed_images(params, TINY, images).numpy()
    assert float((port * ref).sum(1).min()) > 0.999


def test_the_int4_control_is_coarser_than_int8():
    params = inputs.vit_params(TINY, 7, torch.device("cpu"))
    images = torch.from_numpy(inputs.pixel_batches(TINY, 7, 1, 8, torch.device("cpu"))[0])
    ref = clip_vit.embed_images(params, TINY, images)
    gap = {bits: float(1 - (clip_vit.embed_images(params, TINY, images, linear_bits=bits)
                            * ref).sum(1).min()) for bits in (8, 4)}
    assert gap[4] > 10 * gap[8] > 0


def test_inputs_repeat_by_seed():
    a = inputs.vit_params(TINY, 2**31 + 99, torch.device("cpu"))
    b = inputs.vit_params(TINY, 2**31 + 99, torch.device("cpu"))
    c = inputs.vit_params(TINY, 2**31 + 98, torch.device("cpu"))
    assert torch.equal(a["patch_w"], b["patch_w"]) and not torch.equal(a["patch_w"], c["patch_w"])
    assert inputs.sub_seed(2**33 + 1, 1) != inputs.sub_seed(2**33 + 2, 1)
    ids = inputs.item_ids(np.arange(5), 4)
    assert (np.diff(ids) == 7).all() and ids[0] >= 1000
