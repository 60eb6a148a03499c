"""Plain CLIP text tower in f32: the reference of the text-search cell.

OpenCLIP's text transformer on the weight layout the text-search kind draws
(``token_emb`` (V, W), ``pos_emb`` (ctx, W), pre-LayerNorm blocks with q, k
and v the column thirds of ``qkv_w``, ``ln_final``, ``proj`` (W, E)), in
plain PyTorch with TF32 off and nothing of the program: causal attention
over all ``ctx`` positions, scaled by 1/√head_width; the row's features
taken at its largest id (the end-of-text id in OpenCLIP's vocabulary: the
first largest, as ``torch.argmax`` and ``jnp.argmax`` take it); a unit
embedding out. GELU is the tanh approximation, as the configuration file
states.

``linear_fp8=True`` is the control: every block linear and the projection
on operands rounded to float8 e4m3 with a per-tensor absmax scale, the rest
in f32 (one precision below the tower's bf16).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.references.clip_vit import _layernorm
from benchmark.references.exact_topk import no_tf32
from benchmark.references.kimi_vl import _fp8


def _linear(x, w, b, fp8):
    w = w.to(torch.float32)
    if fp8:
        x, w = _fp8(x), _fp8(w)
    y = x @ w
    return y if b is None else y + b.to(torch.float32)


@torch.inference_mode()
def embed_texts(params: dict, config: dict, ids: torch.Tensor, *, block: int = 64,
                linear_fp8: bool = False) -> torch.Tensor:
    """(B, ctx) ids -> (B, embed_dim) f32 unit embeddings, ``block`` rows a time."""
    t = config["text_cfg"]
    w, heads = t["width"], t["heads"]
    d = w // heads
    eps = config["assumed"]["ln_eps"]
    p = params
    out = []
    with no_tf32():
        for lo in range(0, ids.shape[0], block):
            tok = ids[lo:lo + block]
            b, n = tok.shape
            x = p["token_emb"][tok].float() + p["pos_emb"].float()[None, :n]
            causal = torch.ones(n, n, dtype=torch.bool, device=x.device).tril()
            for blk in p["blocks"]:
                a = blk["attn"]
                qkv = _linear(_layernorm(x, blk["ln_1"], eps), a["qkv_w"], a["qkv_b"], linear_fp8)
                q, k, v = (z.reshape(b, n, heads, d).transpose(1, 2) for z in qkv.split(w, dim=-1))
                logits = (q @ k.transpose(-1, -2)) / math.sqrt(d)
                att = torch.softmax(logits.masked_fill(~causal, float("-inf")), dim=-1)
                o = (att @ v).transpose(1, 2).reshape(b, n, w)
                x = x + _linear(o, a["out_w"], a["out_b"], linear_fp8)
                m = blk["mlp"]
                h = _linear(_layernorm(x, blk["ln_2"], eps), m["fc_w"], m["fc_b"], linear_fp8)
                x = x + _linear(F.gelu(h, approximate="tanh"), m["proj_w"], m["proj_b"], linear_fp8)
            x = _layernorm(x, p["ln_final"], eps)
            x = x[torch.arange(b, device=x.device), torch.argmax(tok, dim=-1)]
            feats = _linear(x, p["proj"], None, linear_fp8)
            out.append(feats / torch.clamp(torch.linalg.norm(feats, dim=-1, keepdim=True),
                                           min=1e-8))
    return torch.cat(out)
