"""The port's text encoder (``models/text_embed.py``) against the JAX
package's on the CPU, on seeded inputs over one parameter tree.

``encode`` is held to ``panoptikon_tpu.models.text_embed.encode_jit``, which
takes its additive-bias attention on the CPU, at ``test-tiny`` and at a
narrow ``mpnet``-shaped config (head dim 64), with ragged masks: min cosine
≥ 0.999 per row and max abs error ≤ 2e-2 × max |ref|. The two frameworks
round bf16 matmuls and softmax probabilities at different points, which the
tolerance covers. The host chunking contract is held equal on a hypothesis
sweep, and kernel B3's plain version with a key mask against the Pallas
kernel in interpret mode at the text encoders' head dims (32 and 64) up to
their full context (512). The CUDA kernel at the registry's shapes is held
to the plain version in ``test_torch_cuda_kernels.py``."""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from panoptikon_tpu.models import text_embed as ref
from panoptikon_tpu.ops import vit_attention as ref_attn
from panoptikon_tpu_torch.models import convert, text_embed
from panoptikon_tpu_torch.ops import vit_attention

NARROW_MPNET = ref.TextEncoderConfig(vocab=512, ctx=64, width=128, layers=2, heads=2,
                                     embed_dim=128)
CASES = {"test-tiny": ref.CONFIGS["test-tiny"], "narrow-mpnet": NARROW_MPNET}


def _cosines(a, b):
    return np.sum(a * b, axis=1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


def _inputs(cfg, b, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.vocab, size=(b, cfg.ctx)).astype(np.int32)
    lengths = rng.integers(1, cfg.ctx + 1, size=b)
    lengths[0], lengths[-1] = cfg.ctx, 1
    mask = (np.arange(cfg.ctx)[None, :] < lengths[:, None]).astype(np.int32)
    return ids, mask


def _ref_tree(cfg, seed):
    return jax.tree.map(np.asarray, ref.init_params(jax.random.key(seed), cfg))


def test_configs_match_the_reference():
    assert text_embed.CONFIGS.keys() == ref.CONFIGS.keys()
    for name, cfg in ref.CONFIGS.items():
        assert dataclasses.asdict(text_embed.CONFIGS[name]) == dataclasses.asdict(cfg)


@pytest.mark.parametrize("name", list(CASES))
def test_encode_matches_the_reference(name):
    cfg = CASES[name]
    tree = _ref_tree(cfg, 3)
    ids, mask = _inputs(cfg, 6, 4)
    want = np.asarray(ref.encode_jit(tree, cfg, ids, mask))
    port_cfg = text_embed.TextEncoderConfig(**dataclasses.asdict(cfg))
    params = convert.params_from_jax(tree, device="cpu")
    got = text_embed.encode(params, port_cfg, torch.from_numpy(ids), torch.from_numpy(mask))
    assert got.dtype == torch.float32 and tuple(got.shape) == (6, cfg.embed_dim)
    got = got.numpy()
    assert np.isfinite(got).all()
    assert _cosines(got, want).min() >= 0.999
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()
    # Casting the block linears to bf16 once gives what encode casts per call.
    again = text_embed.encode(text_embed.bf16_linears(params), port_cfg, torch.from_numpy(ids),
                              torch.from_numpy(mask))
    assert torch.equal(again, torch.from_numpy(got))
    # normalize=True gives unit rows of the same direction.
    unit = text_embed.encode(params, port_cfg, torch.from_numpy(ids), torch.from_numpy(mask),
                             normalize=True).numpy()
    np.testing.assert_allclose(np.linalg.norm(unit, axis=1), 1.0, rtol=1e-5)


def test_init_params_has_the_reference_shapes():
    cfg = NARROW_MPNET
    want = _ref_tree(dataclasses.replace(cfg, embed_dim=64), 0)
    got = text_embed.init_params(text_embed.TextEncoderConfig(**dataclasses.asdict(
        dataclasses.replace(cfg, embed_dim=64))), torch.Generator().manual_seed(0))
    shapes = jax.tree.map(lambda a: tuple(a.shape), want)
    assert jax.tree.map(lambda t: tuple(t.shape), got,
                        is_leaf=lambda x: isinstance(x, torch.Tensor)) == shapes
    assert all(t.dtype == torch.float32 for t in jax.tree.leaves(
        got, is_leaf=lambda x: isinstance(x, torch.Tensor)))


@settings(max_examples=60, deadline=None, database=None)
@given(st.lists(st.integers(0, 1000), max_size=300), st.integers(1, 64))
def test_split_tokens_matches_the_reference(tokens, max_tokens):
    assert text_embed.split_tokens(tokens, max_tokens) == ref.split_tokens(tokens, max_tokens)


@settings(max_examples=30, deadline=None, database=None)
@given(st.integers(1, 9), st.integers(1, 8), st.sampled_from([-1, 1, 2, 4, 8]), st.integers(0, 99))
def test_combine_chunks_matches_the_reference(n, d, threshold, seed):
    arr = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    got, want = text_embed.combine_chunks(arr, threshold), ref.combine_chunks(arr, threshold)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("n,d", [(128, 32), (77, 64), (512, 64), (512, 32)])
def test_key_masked_plain_attention_matches_the_pallas_kernel(n, d):
    # B3's plain version with a ragged key mask (one row fully masked) at the
    # text encoders' head dims, bf16 as the encoder runs it.
    rng = np.random.default_rng(n + d)
    b, h = 2, 2
    q, k, v = (rng.normal(size=(b, n, h, d)).astype(np.float32) for _ in range(3))
    lengths = np.array([rng.integers(1, n), 0])
    mask = np.arange(n)[None, :] < lengths[:, None]
    bf = [jnp.asarray(a.astype(ml_dtypes.bfloat16)) for a in (q, k, v)]
    want = ref_attn.mha(*bf, key_mask=jnp.asarray(mask), interpret=True)
    got = vit_attention.mha_plain(*(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
                                  key_mask=torch.from_numpy(mask))
    got = got.to(torch.float32).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=2e-2, atol=2e-2)


def test_encoder_attention_reads_the_fused_projection_in_place():
    # The encoder hands mha the three parts of the fused qkv as views: they
    # share one row stride (3·H·D), which the tensor-core kernel takes as
    # its row stride; the plain version gives the same as on copies.
    b, n, h, d = 2, 40, 2, 64
    qkv = torch.randn((b, n, 3 * h * d), generator=torch.Generator().manual_seed(5)).to(torch.bfloat16)
    q, k, v = (t.view(b, n, h, d) for t in qkv.split(h * d, dim=-1))
    assert not q.is_contiguous()
    assert vit_attention.row_stride(q, k, v) == 3 * h * d
    assert vit_attention.row_stride(*(t.contiguous() for t in (q, k, v))) == h * d
    assert vit_attention.row_stride(q, k.contiguous(), v) is None
    assert vit_attention.row_stride(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)) is None
    mask = torch.arange(n)[None, :] < torch.tensor([[n], [7]])
    got = vit_attention.mha(q, k, v, key_mask=mask)
    want = vit_attention.mha_plain(*(t.contiguous() for t in (q, k, v)), key_mask=mask)
    assert torch.equal(got, want)


def test_params_from_jax_carries_the_text_tree(monkeypatch):
    # The text encoder's tree (a blocks list of nested attn / mlp / ln_*
    # dicts) goes over leaf for leaf with its values; the default device is
    # the card, which raises without CUDA.
    tree = _ref_tree(ref.CONFIGS["test-tiny"], 1)
    out = convert.params_from_jax(tree, device="cpu")
    leaves = jax.tree.leaves(tree)
    got = jax.tree.leaves(out, is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert len(got) == len(leaves) == 5 + 2 * 12
    assert all(np.array_equal(g.numpy(), w) and g.dtype == torch.float32 for g, w in zip(got, leaves))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.params_from_jax(tree)
