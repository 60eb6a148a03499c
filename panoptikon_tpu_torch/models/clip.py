"""CLIP image and text towers on tensors — the port of ``models/clip.py``'s
bf16 path.

Parameters are a plain dict tree with the JAX package's keys and layouts:
linear weights are (in, out) and applied as ``x @ w``; the patch embedding
is the stride-p convolution written as a reshape of NHWC images to
(B, g·g, p·p·3) patches and one matmul. ``models.convert.params_from_jax``
carries a JAX parameter tree over unchanged, so both packages compute the
same function.

Precision follows the reference: activations and matmuls in bf16 (f32
accumulation), layer-norm statistics in f32 with the population variance,
tanh-approximated GELU, attention through ``ops.vit_attention.attention``
(the Hopper kernel on the card). The public functions keep the JAX layout:
images (B, H, W, 3), token ids (B, ctx) with the EOT token at the argmax.

The static-int8 block path and its calibration are not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from panoptikon_tpu_torch.ops import vit_attention

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ClipConfig:
    image_size: int = 224
    patch_size: int = 32
    vision_width: int = 768
    vision_layers: int = 12
    vision_heads: int = 12
    text_vocab: int = 49408
    text_ctx: int = 77
    text_width: int = 512
    text_layers: int = 12
    text_heads: int = 8
    embed_dim: int = 512
    mlp_ratio: int = 4
    # Only "bf16" runs in the port; the field is kept so that configurations
    # compare equal with the JAX package's.
    matmul_precision: str = "bf16"

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size


# Re-declared from the JAX package (which imports jax); a test holds the two
# equal field by field.
CONFIGS = {
    "ViT-B-32": ClipConfig(),
    "ViT-B-16": ClipConfig(patch_size=16),
    "ViT-L-14": ClipConfig(
        patch_size=14, vision_width=1024, vision_layers=24, vision_heads=16,
        text_width=768, text_layers=12, text_heads=12, embed_dim=768,
    ),
    "ViT-H-14": ClipConfig(
        patch_size=14, vision_width=1280, vision_layers=32, vision_heads=16,
        text_width=1024, text_layers=24, text_heads=16, embed_dim=1024,
    ),
    "ViT-H-14-378": ClipConfig(
        image_size=378, patch_size=14, vision_width=1280, vision_layers=32,
        vision_heads=16, text_width=1024, text_layers=24, text_heads=16,
        embed_dim=1024,
    ),
    "test-tiny": ClipConfig(
        image_size=32, patch_size=16, vision_width=64, vision_layers=2,
        vision_heads=2, text_vocab=512, text_ctx=16, text_width=64,
        text_layers=2, text_heads=2, embed_dim=32,
    ),
}


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------


def _normal(gen: torch.Generator, shape, std: float, dtype) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, device=gen.device) * std).to(dtype)


def _ln(width: int, dtype, device) -> Params:
    return {
        "scale": torch.ones(width, dtype=dtype, device=device),
        "bias": torch.zeros(width, dtype=dtype, device=device),
    }


def _init_block(gen, width: int, mlp: int, dtype) -> Params:
    dev = gen.device
    s_attn = width**-0.5
    s_mlp = (2 * width) ** -0.5
    return {
        "ln_1": _ln(width, dtype, dev),
        "attn": {
            "qkv_w": _normal(gen, (width, 3 * width), s_attn, dtype),
            "qkv_b": torch.zeros(3 * width, dtype=dtype, device=dev),
            "out_w": _normal(gen, (width, width), s_attn, dtype),
            "out_b": torch.zeros(width, dtype=dtype, device=dev),
        },
        "ln_2": _ln(width, dtype, dev),
        "mlp": {
            "fc_w": _normal(gen, (width, mlp), s_attn, dtype),
            "fc_b": torch.zeros(mlp, dtype=dtype, device=dev),
            "proj_w": _normal(gen, (mlp, width), s_mlp, dtype),
            "proj_b": torch.zeros(width, dtype=dtype, device=dev),
        },
    }


def init_params(cfg: ClipConfig, gen: torch.Generator, dtype=torch.float32) -> Params:
    """Random parameters with the JAX package's shapes and scales, drawn from
    ``gen`` on ``gen.device``. The values differ from ``jax.random``'s; tests
    that compare the two packages convert one JAX tree instead."""
    dev = gen.device
    patch_dim = cfg.patch_size * cfg.patch_size * 3
    n_patches = cfg.grid * cfg.grid
    vw, tw = cfg.vision_width, cfg.text_width
    return {
        "visual": {
            "patch_w": _normal(gen, (patch_dim, vw), patch_dim**-0.5, dtype),
            "class_emb": _normal(gen, (vw,), 0.02, dtype),
            "pos_emb": _normal(gen, (n_patches + 1, vw), 0.02, dtype),
            "ln_pre": _ln(vw, dtype, dev),
            "blocks": [_init_block(gen, vw, cfg.mlp_ratio * vw, dtype) for _ in range(cfg.vision_layers)],
            "ln_post": _ln(vw, dtype, dev),
            "proj": _normal(gen, (vw, cfg.embed_dim), vw**-0.5, dtype),
        },
        "text": {
            "token_emb": _normal(gen, (cfg.text_vocab, tw), 0.02, dtype),
            "pos_emb": _normal(gen, (cfg.text_ctx, tw), 0.01, dtype),
            "blocks": [_init_block(gen, tw, cfg.mlp_ratio * tw, dtype) for _ in range(cfg.text_layers)],
            "ln_final": _ln(tw, dtype, dev),
            "proj": _normal(gen, (tw, cfg.embed_dim), tw**-0.5, dtype),
        },
        "logit_scale": torch.tensor(math.log(1 / 0.07), dtype=torch.float32, device=dev),
    }


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _layernorm(x, p):
    # f32 statistics whatever the activation dtype; population variance.
    x32 = x.to(torch.float32)
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, correction=0)
    y = (x32 - mean) * torch.rsqrt(var + 1e-5)
    return (y * p["scale"].to(torch.float32) + p["bias"].to(torch.float32)).to(x.dtype)


def _linear(x, w, b):
    y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(x.dtype)
    return y


def _attention(x, p, heads: int, causal: bool):
    b, n, w = x.shape
    qkv = _linear(x, p["qkv_w"], p["qkv_b"])
    # The kernel reads contiguous (B, N, H, D) operands, so each split is
    # one copy (XLA materializes the same three splits in the JAX package).
    q, k, v = (t.reshape(b, n, heads, w // heads).contiguous() for t in qkv.split(w, dim=-1))
    out = vit_attention.attention(q, k, v, causal=causal)
    return _linear(out.reshape(b, n, w), p["out_w"], p["out_b"])


def _block(x, p, heads: int, causal: bool):
    x = x + _attention(_layernorm(x, p["ln_1"]), p["attn"], heads, causal)
    h = _linear(_layernorm(x, p["ln_2"]), p["mlp"]["fc_w"], p["mlp"]["fc_b"])
    h = F.gelu(h, approximate="tanh")
    return x + _linear(h, p["mlp"]["proj_w"], p["mlp"]["proj_b"])


def _normalize(feats):
    return feats / torch.clamp(torch.linalg.norm(feats, dim=-1, keepdim=True), min=1e-8)


def encode_image(params: Params, cfg: ClipConfig, images, normalize: bool = True):
    """images (B, H, W, 3), already mean/std normalized -> (B, embed_dim) f32."""
    v = params["visual"]
    b = images.shape[0]
    p, g = cfg.patch_size, cfg.grid
    x = images.to(torch.bfloat16)
    # (B, g, p, g, p, 3) -> (B, g·g, p·p·3): the stride-p conv as one matmul.
    x = x.reshape(b, g, p, g, p, 3).permute(0, 1, 3, 2, 4, 5).reshape(b, g * g, p * p * 3)
    x = x @ v["patch_w"].to(x.dtype)
    if "patch_b" in v:
        x = x + v["patch_b"].to(x.dtype)
    cls = v["class_emb"].to(x.dtype).expand(b, 1, cfg.vision_width)
    x = torch.cat([cls, x], dim=1) + v["pos_emb"].to(x.dtype)[None]
    x = _layernorm(x, v["ln_pre"])
    for blk in v["blocks"]:
        x = _block(x, blk, cfg.vision_heads, causal=False)
    x = _layernorm(x[:, 0], v["ln_post"])
    feats = (x @ v["proj"].to(x.dtype)).to(torch.float32)
    return _normalize(feats) if normalize else feats


def encode_text(params: Params, cfg: ClipConfig, token_ids, normalize: bool = True):
    """token_ids (B, ctx) int, EOT at the argmax position -> (B, embed_dim) f32."""
    t = params["text"]
    x = t["token_emb"][token_ids].to(torch.bfloat16)
    x = x + t["pos_emb"].to(x.dtype)[None]
    for blk in t["blocks"]:
        x = _block(x, blk, cfg.text_heads, causal=True)
    x = _layernorm(x, t["ln_final"])
    # torch.argmax, like jnp.argmax, returns the first maximal position.
    eot = torch.argmax(token_ids, dim=-1)
    x = x[torch.arange(x.shape[0], device=x.device), eot]
    feats = (x @ t["proj"].to(x.dtype)).to(torch.float32)
    return _normalize(feats) if normalize else feats


@torch.inference_mode()
def embed_images(params: Params, cfg: ClipConfig, images):
    """L2-normalized image embeddings (the retrieval embed)."""
    return encode_image(params, cfg, images)


@torch.inference_mode()
def embed_texts(params: Params, cfg: ClipConfig, token_ids):
    """L2-normalized text embeddings (the query embed)."""
    return encode_text(params, cfg, token_ids)
