"""CLIP image and text towers on tensors — the port of ``models/clip.py``.

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

``matmul_precision="int8"`` runs the block linears in int8 (int8 × int8 →
int32 GEMMs through ``torch._int_mm``, per-output-channel weight scales):

- with calibrated activation scales (``act_scales``, (L, 4) per-tensor
  absmax from :func:`calibrate_image_scales` / :func:`calibrate_text_scales`)
  and weights quantized once (:func:`quantize_block_weights`), each block is
  :func:`_block_int8_static`, the serving embed: LayerNorm fused with the
  int8 quantize (``ops.ln_quant``, kernel B5), prequantized GEMMs, and
  attention over the unsplit qkv with int8 out (``ops.vit_attention.mha_qkv``,
  kernel B4);
- without scales, each linear quantizes its activations per token.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from panoptikon_tpu_torch.ops import ln_quant, vit_attention
from panoptikon_tpu_torch.ops.codec import quantize_static, static_step
from panoptikon_tpu_torch.ops.exact import int_mm as _int_mm

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
    # "bf16" runs every matmul in bf16; "int8" runs the block linears
    # (qkv/out/fc/proj) as int8 GEMMs: per-output-channel weight scales
    # and, with calibrated ``act_scales``, static per-tensor activation
    # scales (the serving embed), else per-token dynamic ones. Attention
    # and layernorms stay bf16/f32.
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


def _int8_matmul(xq, wq):
    """(…, K) int8 activations × (K, N) int8 weights -> (…, N) int32."""
    y = _int_mm(xq.reshape(-1, xq.shape[-1]), wq)
    return y.reshape(*xq.shape[:-1], wq.shape[1])


def _quantize_weight(w):
    """(in, out) weight -> ``{"q": int8 codes, "s": (1, out) f32 scales}``:
    per-output-channel scales ``max(absmax / 127, 1e-12)``, codes rounded
    half to even and stored column-major for :func:`_int_mm`."""
    w32 = w.to(torch.float32)
    sw = torch.clamp(w32.abs().amax(dim=0, keepdim=True) / 127.0, min=1e-12)
    return {"q": torch.round(w32 / sw).to(torch.int8).t().contiguous().t(), "s": sw}


def _linear(x, w, b, precision: str = "bf16", act_scale=None, collector=None):
    """Block linear: a bf16 matmul, or an int8 GEMM.

    - bf16 (``precision != "int8"``): over a prequantized ``{"q", "s"}``
      weight it runs on the dequantized values, ``(q·s)`` cast to x's dtype,
      which is what the int8 forward sees (the calibration pass).
    - int8 dynamic (``act_scale`` None): per-token absmax/127 activation
      scales.
    - int8 static: the calibrated per-tensor ``act_scale``.

    Both int8 forms use per-output-channel weight scales and the epilogue
    ``(y·sx)·sw + b`` in f32, cast to x's dtype. ``collector`` (a list)
    records the input's absmax for calibration.
    """
    if collector is not None:
        collector.append(x.to(torch.float32).abs().amax())
    prequant = isinstance(w, dict)
    if precision != "int8":
        wm = (w["q"].to(torch.float32) * w["s"]).to(x.dtype) if prequant else w.to(x.dtype)
        y = x @ wm
        if b is not None:
            y = y + b.to(x.dtype)
        return y
    x32 = x.to(torch.float32)
    if act_scale is not None:
        sx = static_step(act_scale, x.device)
        xq = quantize_static(x32, act_scale)
    else:
        sx = torch.clamp(x32.abs().amax(dim=-1, keepdim=True) / 127.0, min=1e-12)
        xq = torch.round(x32 / sx).to(torch.int8)
    wq = w if prequant else _quantize_weight(w)
    y = _int8_matmul(xq, wq["q"]).to(torch.float32) * sx * wq["s"]
    if b is not None:
        y = y + b.to(torch.float32)
    return y.to(x.dtype)


def quantize_block_weights(params: Params) -> Params:
    """Quantize every block linear (qkv/out/fc/proj) once to int8 codes and
    f32 per-output-channel scales, ``{"q", "s"}``, matching the int8 path's
    on-the-fly quantization bit for bit. Other leaves are shared, not
    copied."""
    out = dict(params)
    for tower in ("visual", "text"):
        if tower not in params:
            continue
        tw = dict(params[tower])
        blocks = []
        for blk in tw["blocks"]:
            attn, mlp = blk["attn"], blk["mlp"]
            blocks.append({
                "ln_1": blk["ln_1"],
                "ln_2": blk["ln_2"],
                "attn": dict(attn, qkv_w=_quantize_weight(attn["qkv_w"]),
                             out_w=_quantize_weight(attn["out_w"])),
                "mlp": dict(mlp, fc_w=_quantize_weight(mlp["fc_w"]),
                            proj_w=_quantize_weight(mlp["proj_w"])),
            })
        tw["blocks"] = blocks
        out[tower] = tw
    return out


def _attention(x, p, heads: int, causal: bool, precision: str = "bf16", scales=None,
               collector=None):
    b, n, w = x.shape
    qkv = _linear(x, p["qkv_w"], p["qkv_b"], precision,
                  scales[0] if scales is not None else None, collector)
    # The kernel reads contiguous (B, N, H, D) operands, so each split is
    # one copy (XLA materializes the same three splits in the JAX package).
    q, k, v = (t.reshape(b, n, heads, w // heads).contiguous() for t in qkv.split(w, dim=-1))
    out = vit_attention.attention(q, k, v, causal=causal)
    return _linear(out.reshape(b, n, w), p["out_w"], p["out_b"], precision,
                   scales[1] if scales is not None else None, collector)


def _linear_prequant(xq, act_scale, w, b):
    """int8 GEMM of an already quantized activation (the output of
    ``ln_quant`` or ``mha_qkv``): ``(xq·wq)·sx·sw + b`` in f32, bf16 out.
    ``w`` is a prequantized ``{"q", "s"}`` weight."""
    y = _int8_matmul(xq, w["q"]).to(torch.float32) * static_step(act_scale, xq.device) * w["s"]
    if b is not None:
        y = y + b.to(torch.float32)
    return y.to(torch.bfloat16)


def _block_int8_static(x, p, heads: int, causal: bool, scales):
    """The serving embed block: fused LN→quantize (kernel B5) feeding
    prequantized int8 GEMMs, and attention read from the unsplit qkv with
    int8 out (kernel B4). Same math as the generic path modulo quantizing
    from the f32 LN output instead of its bf16 round trip.

    The JAX block also has a split route (``mha``, then a static-int8
    linear) for shapes whose q/k/v blocks overflow the TPU's VMEM. The CUDA
    kernel streams keys through shared memory, so only its head-dim limit
    (``vit_attention.qkv_fused_fits``) applies, and ``mha`` shares that
    limit: the route has no counterpart here."""
    aq = ln_quant.ln_quant(x, p["ln_1"], scales[0])
    qkv = _linear_prequant(aq, scales[0], p["attn"]["qkv_w"], p["attn"]["qkv_b"])
    att_q = vit_attention.mha_qkv(qkv, heads=heads, causal=causal, out_scale=scales[1])
    x = x + _linear_prequant(att_q, scales[1], p["attn"]["out_w"], p["attn"]["out_b"])
    hq = ln_quant.ln_quant(x, p["ln_2"], scales[2])
    h = _linear_prequant(hq, scales[2], p["mlp"]["fc_w"], p["mlp"]["fc_b"])
    h = F.gelu(h, approximate="tanh")
    h = _linear(h, p["mlp"]["proj_w"], p["mlp"]["proj_b"], "int8", scales[3])
    return x + h


def _block(x, p, heads: int, causal: bool, precision: str = "bf16", scales=None,
           collector=None):
    if (precision == "int8" and scales is not None and collector is None
            and isinstance(p["attn"]["qkv_w"], dict)):
        return _block_int8_static(x, p, heads, causal, scales)
    x = x + _attention(_layernorm(x, p["ln_1"]), p["attn"], heads, causal, precision, scales,
                       collector)
    h = _linear(_layernorm(x, p["ln_2"]), p["mlp"]["fc_w"], p["mlp"]["fc_b"], precision,
                scales[2] if scales is not None else None, collector)
    h = F.gelu(h, approximate="tanh")
    return x + _linear(h, p["mlp"]["proj_w"], p["mlp"]["proj_b"], precision,
                       scales[3] if scales is not None else None, collector)


def _normalize(feats):
    return feats / torch.clamp(torch.linalg.norm(feats, dim=-1, keepdim=True), min=1e-8)


def _visual_trunk(params: Params, cfg: ClipConfig, images, act_scales=None, collector=None):
    """The patch embedding, positions, ``ln_pre`` and every block: (B, 1 +
    grid², vision_width) in bf16."""
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
    for i, blk in enumerate(v["blocks"]):
        x = _block(x, blk, cfg.vision_heads, causal=False, precision=cfg.matmul_precision,
                   scales=act_scales[i] if act_scales is not None else None,
                   collector=collector)
    return x


def encode_image(params: Params, cfg: ClipConfig, images, normalize: bool = True,
                 act_scales=None, _collector=None):
    """images (B, H, W, 3), already mean/std normalized -> (B, embed_dim) f32.

    ``act_scales`` — (vision_layers, 4) calibrated per-tensor activation
    absmax (:func:`calibrate_image_scales`); with ``cfg.matmul_precision ==
    "int8"`` and prequantized weights it selects the static-int8 block."""
    v = params["visual"]
    x = _visual_trunk(params, cfg, images, act_scales, _collector)
    x = _layernorm(x[:, 0], v["ln_post"])
    feats = (x @ v["proj"].to(x.dtype)).to(torch.float32)
    return _normalize(feats) if normalize else feats


@torch.inference_mode()
def encode_image_tokens(params: Params, cfg: ClipConfig, images):
    """Every trunk token (B, 1 + grid², vision_width) f32, with no
    ``ln_post`` or ``proj``: the captioner's cross-attention memory."""
    return _visual_trunk(params, cfg, images).to(torch.float32)


def encode_text(params: Params, cfg: ClipConfig, token_ids, normalize: bool = True,
                act_scales=None, _collector=None):
    """token_ids (B, ctx) int, EOT at the argmax position -> (B, embed_dim) f32.
    ``act_scales`` — (text_layers, 4), as in :func:`encode_image`."""
    t = params["text"]
    x = t["token_emb"][token_ids].to(torch.bfloat16)
    x = x + t["pos_emb"].to(x.dtype)[None]
    for i, blk in enumerate(t["blocks"]):
        x = _block(x, blk, cfg.text_heads, causal=True, precision=cfg.matmul_precision,
                   scales=act_scales[i] if act_scales is not None else None,
                   collector=_collector)
    x = _layernorm(x, t["ln_final"])
    # torch.argmax, like jnp.argmax, returns the first maximal position.
    eot = torch.argmax(token_ids, dim=-1)
    x = x[torch.arange(x.shape[0], device=x.device), eot]
    feats = (x @ t["proj"].to(x.dtype)).to(torch.float32)
    return _normalize(feats) if normalize else feats


@torch.inference_mode()
def calibrate_image_scales(params: Params, cfg: ClipConfig, images):
    """One bf16 pass -> (vision_layers, 4) per-tensor activation absmax (the
    qkv/out/fc/proj inputs of each block), f32 on the images' device:
    standard PTQ calibration, whose quality follows the batch's coverage."""
    collector: list = []
    bf16_cfg = dataclasses.replace(cfg, matmul_precision="bf16")
    encode_image(params, bf16_cfg, images, _collector=collector)
    return torch.stack(collector).reshape(cfg.vision_layers, 4)


@torch.inference_mode()
def calibrate_text_scales(params: Params, cfg: ClipConfig, token_ids):
    """One bf16 pass -> (text_layers, 4) per-tensor activation absmax for the
    static-int8 text path (same PTQ recipe as the image tower)."""
    collector: list = []
    bf16_cfg = dataclasses.replace(cfg, matmul_precision="bf16")
    encode_text(params, bf16_cfg, token_ids, _collector=collector)
    return torch.stack(collector).reshape(cfg.text_layers, 4)


@torch.inference_mode()
def embed_images(params: Params, cfg: ClipConfig, images):
    """L2-normalized image embeddings (the retrieval embed)."""
    return encode_image(params, cfg, images)


@torch.inference_mode()
def embed_images_scaled(params: Params, cfg: ClipConfig, images, act_scales):
    """Static-scale int8 image embed (calibrated ``act_scales``)."""
    return encode_image(params, cfg, images, act_scales=act_scales)


@torch.inference_mode()
def embed_images_raw(params: Params, cfg: ClipConfig, images):
    """Unnormalized pooled features (classifier heads, the taggers, apply to
    the raw trunk output, not the retrieval embedding)."""
    return encode_image(params, cfg, images, normalize=False)


@torch.inference_mode()
def embed_images_raw_scaled(params: Params, cfg: ClipConfig, images, act_scales):
    """Unnormalized pooled features on the static-int8 path (classifier
    heads apply to the raw trunk output)."""
    return encode_image(params, cfg, images, normalize=False, act_scales=act_scales)


@torch.inference_mode()
def embed_texts(params: Params, cfg: ClipConfig, token_ids):
    """L2-normalized text embeddings (the query embed)."""
    return encode_text(params, cfg, token_ids)


@torch.inference_mode()
def embed_texts_scaled(params: Params, cfg: ClipConfig, token_ids, act_scales):
    """Static-scale int8 text embed (calibrated ``act_scales``)."""
    return encode_text(params, cfg, token_ids, act_scales=act_scales)
