"""The port's CLIP towers against panoptikon_tpu/models/clip.py on the same
parameters (carried over by models.convert) and inputs: cosine ≥ 0.999 per
row, the floor of test_int8_fidelity.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panoptikon_tpu.models import clip as ref
from panoptikon_tpu_torch.models import clip, convert


def _cos(a, b):
    return np.sum(a * b, axis=-1) / np.maximum(
        np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1), 1e-30)


def tokens(rng, b, ctx, vocab):
    """Random ids, EOT (the largest id) at a random position, zeros after."""
    ids = rng.integers(1, vocab - 1, size=(b, ctx))
    eot = rng.integers(1, ctx, size=b)
    for i, e in enumerate(eot):
        ids[i, e] = vocab - 1
        ids[i, e + 1:] = 0
    return ids.astype(np.int32)


@pytest.fixture(scope="module")
def tiny():
    cfg = clip.CONFIGS["test-tiny"]
    jparams = ref.init_params(jax.random.key(0), ref.CONFIGS["test-tiny"])
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return cfg, jparams, tparams


def test_configs_equal_reference():
    assert clip.CONFIGS.keys() == ref.CONFIGS.keys()
    for name, cfg in clip.CONFIGS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref.CONFIGS[name]), name
        assert cfg.grid == ref.CONFIGS[name].grid


def test_init_params_shapes_match_reference():
    cfg = clip.CONFIGS["test-tiny"]
    jshapes = jax.tree.map(lambda a: tuple(a.shape), ref.init_params(jax.random.key(1), cfg))
    gen = torch.Generator().manual_seed(1)
    tparams = clip.init_params(cfg, gen)
    assert jax.tree.map(lambda t: tuple(t.shape), tparams) == jshapes
    bf = clip.init_params(cfg, torch.Generator().manual_seed(1), dtype=torch.bfloat16)
    assert bf["visual"]["blocks"][0]["attn"]["qkv_w"].dtype == torch.bfloat16


def test_convert_keeps_layout(tiny):
    _, jparams, tparams = tiny
    w = np.asarray(jparams["visual"]["blocks"][1]["attn"]["qkv_w"])
    np.testing.assert_array_equal(tparams["visual"]["blocks"][1]["attn"]["qkv_w"].numpy(), w)


def test_encode_image_matches_reference(tiny):
    cfg, jparams, tparams = tiny
    rng = np.random.default_rng(0)
    images = rng.normal(size=(6, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    want = np.asarray(ref.encode_image(jparams, ref.CONFIGS["test-tiny"], jnp.asarray(images)))
    got = clip.embed_images(tparams, cfg, torch.from_numpy(images)).numpy()
    assert got.shape == want.shape == (6, cfg.embed_dim)
    assert _cos(got, want).min() >= 0.999
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)


def test_encode_text_matches_reference(tiny):
    cfg, jparams, tparams = tiny
    ids = tokens(np.random.default_rng(1), 6, cfg.text_ctx, cfg.text_vocab)
    want = np.asarray(ref.encode_text(jparams, ref.CONFIGS["test-tiny"], jnp.asarray(ids)))
    got = clip.embed_texts(tparams, cfg, torch.from_numpy(ids)).numpy()
    assert got.shape == want.shape == (6, cfg.embed_dim)
    assert _cos(got, want).min() >= 0.999
