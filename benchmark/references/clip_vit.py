"""Plain CLIP ViT image tower in f32: the reference of the image-embed cells.

OpenCLIP's VisionTransformer (pre-LayerNorm blocks, a class token, learned
positions, ``ln_pre``, ``ln_post`` on the class token, a projection), on the
weight layout of ``benchmark/inputs.py``, in plain PyTorch with TF32 off and
no kernel of the program. One departure from OpenCLIP, as the configuration
file states: GELU is the tanh approximation, which the port and its JAX
reference compute (OpenCLIP's ``nn.GELU`` takes erf). LayerNorm eps 1e-5 and
the population variance, attention scaled by 1/√head_width.

``linear_bits=4`` is the control: every block linear (qkv, out, fc, proj) on
operands rounded to 4-bit integer grids, weights per output channel and
activations per token (absmax / 7), the rest in f32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.references.exact_topk import no_tf32


def _layernorm(x, p, eps: float):
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    return (x - mean) / torch.sqrt(var + eps) * p["scale"] + p["bias"]


def _fake_quant(x, dim: int, bits: int):
    top = 2 ** (bits - 1) - 1
    s = torch.clamp(x.abs().amax(dim=dim, keepdim=True) / top, min=1e-12)
    return torch.clamp(torch.round(x / s), -top, top) * s


def _linear(x, w, b, bits):
    if bits is not None:
        x, w = _fake_quant(x, -1, bits), _fake_quant(w, 0, bits)
    return x @ w + b


def _attention(x, p, heads: int, bits):
    b, n, width = x.shape
    d = width // heads
    qkv = _linear(x, p["qkv_w"], p["qkv_b"], bits)
    q, k, v = (t.reshape(b, n, heads, d).transpose(1, 2) for t in qkv.split(width, dim=-1))
    logits = (q @ k.transpose(-1, -2)) / math.sqrt(d)
    out = torch.softmax(logits, dim=-1) @ v
    return _linear(out.transpose(1, 2).reshape(b, n, width), p["out_w"], p["out_b"], bits)


@torch.inference_mode()
def embed_images(params: dict, config: dict, images: torch.Tensor, *, block: int = 32,
                 linear_bits: int | None = None) -> torch.Tensor:
    """(B, S, S, 3) f32 images -> (B, embed_dim) f32 unit embeddings, ``block``
    images at a time."""
    v = config["vision_cfg"]
    p, g = v["patch_size"], v["image_size"] // v["patch_size"]
    heads = v["width"] // config["assumed"]["vision_head_width"]
    eps = config["assumed"]["ln_eps"]
    out = []
    with no_tf32():
        for lo in range(0, images.shape[0], block):
            x = images[lo:lo + block].to(torch.float32)
            b = x.shape[0]
            x = x.reshape(b, g, p, g, p, 3).permute(0, 1, 3, 2, 4, 5).reshape(b, g * g, p * p * 3)
            x = x @ params["patch_w"]
            cls = params["class_emb"].expand(b, 1, -1)
            x = torch.cat([cls, x], dim=1) + params["pos_emb"][None]
            x = _layernorm(x, params["ln_pre"], eps)
            for blk in params["blocks"]:
                x = x + _attention(_layernorm(x, blk["ln_1"], eps), blk["attn"], heads,
                                   linear_bits)
                h = _linear(_layernorm(x, blk["ln_2"], eps), blk["mlp"]["fc_w"],
                            blk["mlp"]["fc_b"], linear_bits)
                h = F.gelu(h, approximate="tanh")
                x = x + _linear(h, blk["mlp"]["proj_w"], blk["mlp"]["proj_b"], linear_bits)
            feats = _layernorm(x[:, 0], params["ln_post"], eps) @ params["proj"]
            out.append(feats / torch.clamp(torch.linalg.norm(feats, dim=-1, keepdim=True),
                                           min=1e-8))
    return torch.cat(out)
