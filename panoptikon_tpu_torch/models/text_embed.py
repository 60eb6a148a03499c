"""Sentence-transformer-class text encoder on tensors — the port of
``models/text_embed.py``.

A bidirectional BERT-shaped encoder (learned positions, post-LN blocks,
tanh GELU) with masked mean pooling, plus the chunking contract the index
layer depends on (:func:`split_tokens`, :func:`combine_chunks`, copied from
the JAX package and held to it by ``tests/test_torch_host_copies.py``).

Parameters are the JAX package's tree with its keys and layouts (linear
weights (in, out), applied as ``x @ w``), so
``models.convert.params_from_jax`` carries a JAX tree over unchanged and
``models.weights.load_text_encoder_checkpoint`` maps a BERT state dict onto
it. The rounding follows the reference point for point: the embeddings sum
and their LayerNorm in f32, then bf16; every linear bf16 @ bf16 with the
bias added in bf16; the residual add in bf16 ahead of an f32 LayerNorm
(population variance, eps 1e-12); pooling in f32.

Attention is ``ops.vit_attention.mha`` with the key-padding mask (kernel B3
on the card, on its tensor-core route at both registry widths: D 32 for
``minilm-l6``, D 64 for ``mpnet-base``; its plain version on the CPU, whose
−1e9 mask is the reference's additive bias). q, k and v are the three
parts of the fused qkv projection, passed as views: the kernel reads them
in place with their shared row stride, so no split copies are made.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from panoptikon_tpu_torch.ops import vit_attention

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TextEncoderConfig:
    vocab: int = 30522
    ctx: int = 512
    width: int = 384
    layers: int = 6
    heads: int = 12
    mlp_ratio: int = 4
    embed_dim: int = 384  # == width unless a projection head exists
    type_vocab: int = 2


# Re-declared from the JAX package (which imports jax); a test holds the two
# equal field by field.
CONFIGS = {
    "minilm-l6": TextEncoderConfig(),
    "mpnet-base": TextEncoderConfig(width=768, layers=12, heads=12, embed_dim=768),
    "test-tiny": TextEncoderConfig(vocab=128, ctx=32, width=32, layers=2, heads=2, embed_dim=32),
}


def init_params(cfg: TextEncoderConfig, gen: torch.Generator) -> Params:
    """Random f32 parameters with the JAX package's shapes and scales, drawn
    from ``gen`` on ``gen.device``. The values differ from ``jax.random``'s;
    tests that compare the two packages convert one JAX tree instead."""
    dev = gen.device
    w, m = cfg.width, cfg.mlp_ratio * cfg.width

    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=dev) * std

    def ln():
        return {"scale": torch.ones(w, device=dev), "bias": torch.zeros(w, device=dev)}

    def block():
        return {
            "attn": {
                "qkv_w": normal((w, 3 * w), w**-0.5),
                "qkv_b": torch.zeros(3 * w, device=dev),
                "out_w": normal((w, w), w**-0.5),
                "out_b": torch.zeros(w, device=dev),
            },
            "ln_attn": ln(),
            "mlp": {
                "fc_w": normal((w, m), w**-0.5),
                "fc_b": torch.zeros(m, device=dev),
                "proj_w": normal((m, w), m**-0.5),
                "proj_b": torch.zeros(w, device=dev),
            },
            "ln_mlp": ln(),
        }

    params: Params = {
        "token_emb": normal((cfg.vocab, w), 0.02),
        "pos_emb": normal((cfg.ctx, w), 0.02),
        "type_emb": torch.zeros((cfg.type_vocab, w), device=dev),
        "ln_emb": ln(),
        "blocks": [block() for _ in range(cfg.layers)],
    }
    if cfg.embed_dim != w:
        params["proj"] = normal((w, cfg.embed_dim), w**-0.5)
    return params


def bf16_linears(params: Params) -> Params:
    """The tree with every block linear (weights and biases) cast to bf16
    once, as :func:`encode` casts them on each call; LayerNorms, embedding
    tables and the projection stay f32. Other leaves are shared."""
    def cast(d):
        return {k: v.to(torch.bfloat16) for k, v in d.items()}

    out = dict(params)
    out["blocks"] = [dict(blk, attn=cast(blk["attn"]), mlp=cast(blk["mlp"]))
                     for blk in params["blocks"]]
    return out


def _layernorm(x, p):
    x32 = x.to(torch.float32)
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, correction=0)
    y = (x32 - mean) * torch.rsqrt(var + 1e-12)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


def _linear(x, w, b):
    return x @ w.to(x.dtype) + b.to(x.dtype)


def encode(params: Params, cfg: TextEncoderConfig, token_ids, attention_mask,
           normalize: bool = False):
    """token_ids, attention_mask: (B, N) integer tensors on the parameters'
    device, N ≤ ``cfg.ctx`` → (B, embed_dim) f32 by masked mean pooling (the
    sentence-transformers pooling head)."""
    b, n = token_ids.shape
    x = params["token_emb"][token_ids.long()]
    x = x + params["pos_emb"][None, :n]
    x = x + params["type_emb"][0][None, None]
    x = _layernorm(x, params["ln_emb"]).to(torch.bfloat16)
    mask = attention_mask != 0
    w, heads = cfg.width, cfg.heads
    for blk in params["blocks"]:
        qkv = _linear(x, blk["attn"]["qkv_w"], blk["attn"]["qkv_b"])
        q, k, v = (t.view(b, n, heads, w // heads) for t in qkv.split(w, dim=-1))
        attn = vit_attention.mha(q, k, v, key_mask=mask).reshape(b, n, w)
        attn = _linear(attn, blk["attn"]["out_w"], blk["attn"]["out_b"])
        x = _layernorm(x + attn, blk["ln_attn"]).to(torch.bfloat16)
        h = _linear(x, blk["mlp"]["fc_w"], blk["mlp"]["fc_b"])
        h = F.gelu(h, approximate="tanh")
        h = _linear(h, blk["mlp"]["proj_w"], blk["mlp"]["proj_b"])
        x = _layernorm(x + h, blk["ln_mlp"]).to(torch.bfloat16)
    x = x.to(torch.float32)
    m = mask.to(torch.float32)[:, :, None]
    pooled = (x * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1e-9)
    if "proj" in params:
        pooled = pooled @ params["proj"]
    if normalize:
        pooled = pooled / torch.clamp(torch.linalg.norm(pooled, dim=-1, keepdim=True), min=1e-8)
    return pooled


# ---------------------------------------------------------------------------
# Chunking contract (host side)
# ---------------------------------------------------------------------------


def split_tokens(tokens: Sequence[int], max_tokens: int) -> list[list[int]]:
    """Max-token chunks with a rebalanced tail: a final chunk shorter than
    ``max_tokens // 3`` borrows its missing tokens from the previous chunk
    (sentence_transformers.py:155-180)."""
    tokens = list(tokens)
    chunks = [tokens[i : i + max_tokens] for i in range(0, len(tokens), max_tokens)]
    if not chunks:
        return [[]]
    min_chunk = max_tokens // 3
    if len(chunks) > 1 and len(chunks[-1]) < min_chunk:
        needed = min_chunk - len(chunks[-1])
        chunks[-1] = chunks[-2][-needed:] + chunks[-1]
        chunks[-2] = chunks[-2][:-needed]
    return chunks


def combine_chunks(chunk_embeddings: np.ndarray, combine_threshold: int) -> np.ndarray:
    """Append the mean "combined" embedding once the chunk count reaches the
    threshold (−1 disables). chunk_embeddings: (n_chunks, D) → (n, D) or
    (n+1, D)."""
    arr = np.asarray(chunk_embeddings)
    if combine_threshold != -1 and arr.shape[0] >= combine_threshold:
        arr = np.concatenate([arr, arr.mean(axis=0, keepdims=True)], axis=0)
    return arr
