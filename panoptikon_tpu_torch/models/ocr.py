"""OCR on tensors — the port of ``models/ocr.py``.

Host-side line segmentation, then one of two recognizers over fixed-height
line strips:

- the host units, copied from the JAX package text for text and held to it
  by ``tests/test_torch_host_copies.py``: ``DEFAULT_CHARSET``,
  ``OcrConfig``, ``CONFIGS``, ``AttnOcrConfig``, ``ATTN_CONFIGS``, the
  projection-profile segmentation (:func:`segment_lines`), the strip
  preparation (:func:`prepare_strip`) and the two decodes to text
  (:func:`ctc_collapse`, :func:`attn_collapse`);
- the strip encoder (:func:`encode_strips`): column patches as tokens by
  one matmul, positions, then ``clip._block`` (its self-attention is
  ``ops.vit_attention.attention``, kernel B3 on the card: crnn-base's 4
  heads of 64 on the tensor cores) and a final LayerNorm;
- the CTC recognizer: :func:`logits` and :func:`recognize` (greedy: the
  argmax a column and the mean of each column's top probability, both
  left on the device);
- the attention recognizer: :func:`attn_read`, the same encoder's features
  as the cross-attention memory of whisper's KV-cached greedy decode
  (``whisper.decode_from_feats``) over a character vocabulary.

Parameters are the JAX package's tree with its keys and layouts, so
``models.convert.params_from_jax`` carries a trained JAX tree over
unchanged. The rounding follows the reference: the strips, the patch
matmul, the positions and the blocks in bf16; LayerNorm in f32; the head a
bf16 matmul, then f32, then the f32 bias. The training objectives
(``ctc_loss``, ``attn_loss``) are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from panoptikon_tpu_torch.models import clip as _clip
from panoptikon_tpu_torch.models import whisper

Params = dict[str, Any]

# Index 0 is the CTC blank.
DEFAULT_CHARSET = " !\"#$%&'()*+,-./0123456789:;<=>?@ABCDEFGHIJKLMNOPQRSTUVWXYZ[\\]^_`abcdefghijklmnopqrstuvwxyz{|}~"


@dataclasses.dataclass(frozen=True)
class OcrConfig:
    height: int = 32
    max_width: int = 512
    col_patch: int = 4  # columns per token
    width: int = 256
    layers: int = 4
    heads: int = 4
    charset: str = DEFAULT_CHARSET
    matmul_precision: str = "bf16"

    @property
    def tokens(self) -> int:
        return self.max_width // self.col_patch

    @property
    def classes(self) -> int:
        return len(self.charset) + 1  # + CTC blank at index 0


CONFIGS = {
    "crnn-base": OcrConfig(),
    "test-tiny": OcrConfig(
        height=16, max_width=128, col_patch=4, width=64, layers=2, heads=2,
        charset="0123456789",
    ),
}


def init_params(cfg: OcrConfig, gen: torch.Generator) -> Params:
    """Random f32 parameters with the JAX package's shapes and scales, drawn
    from ``gen`` on ``gen.device``; the blocks are ``clip._init_block``'s.
    The values differ from ``jax.random``'s: tests that compare the two
    packages convert one JAX tree instead."""
    dev = gen.device
    patch_dim = cfg.height * cfg.col_patch

    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=dev) * std

    return {
        "patch_w": normal((patch_dim, cfg.width), patch_dim**-0.5),
        "pos_emb": normal((cfg.tokens, cfg.width), 0.02),
        "blocks": [_clip._init_block(gen, cfg.width, 4 * cfg.width, torch.float32)
                   for _ in range(cfg.layers)],
        "ln_out": {"scale": torch.ones(cfg.width, device=dev),
                   "bias": torch.zeros(cfg.width, device=dev)},
        "head_w": normal((cfg.width, cfg.classes), cfg.width**-0.5),
        "head_b": torch.zeros(cfg.classes, device=dev),
    }


def bf16_linears(params: Params) -> Params:
    """The tree with every trunk block linear (weights and biases), and the
    attention reader's decoder linears, cast to bf16 once, as the forward
    casts them on each use; the LayerNorms, embeddings and the head stay
    f32. Other leaves are shared."""
    def cast(d):
        return {k: v.to(torch.bfloat16) for k, v in d.items()}

    out = {**params, "blocks": [{**blk, "attn": cast(blk["attn"]), "mlp": cast(blk["mlp"])}
                                for blk in params["blocks"]]}
    if "decoder" in params:
        out["decoder"] = whisper.bf16_linears({"decoder": params["decoder"]})["decoder"]
    return out


def encode_strips(params: Params, cfg: OcrConfig, strips):
    """strips (B, height, max_width) f32 in [0, 1] on the parameters' device
    → trunk features (B, tokens, width) bf16: the CTC head's input and the
    attention reader's cross-attention memory."""
    b = strips.shape[0]
    x = strips.to(torch.bfloat16)
    # (B, H, T·cp) → (B, T, H·cp): column patches as tokens.
    x = x.reshape(b, cfg.height, cfg.tokens, cfg.col_patch)
    x = x.permute(0, 2, 1, 3).reshape(b, cfg.tokens, -1)
    x = x @ params["patch_w"].to(x.dtype)
    x = x + params["pos_emb"].to(x.dtype)[None]
    for blk in params["blocks"]:
        x = _clip._block(x, blk, cfg.heads, causal=False, precision=cfg.matmul_precision)
    return _clip._layernorm(x, params["ln_out"])


def logits(params: Params, cfg: OcrConfig, strips):
    """strips (B, height, max_width) → (B, tokens, classes) f32."""
    x = encode_strips(params, cfg, strips)
    return (x @ params["head_w"].to(x.dtype)).to(torch.float32) + params["head_b"]


@torch.inference_mode()
def recognize(params: Params, cfg: OcrConfig, strips):
    """Greedy CTC, the counterpart of the reference's ``recognize_jit``: the
    argmax class of each column (B, tokens) int64 and the mean of each
    column's top softmax probability (B,) f32, both on the device."""
    lg = logits(params, cfg, strips)
    probs = torch.softmax(lg, dim=-1)
    return torch.argmax(lg, dim=-1), probs.amax(dim=-1).mean(dim=-1)


def ctc_collapse(ids: np.ndarray, charset: str) -> str:
    """Collapse repeats, drop blanks (id 0)."""
    out = []
    prev = -1
    for i in ids.tolist():
        if i != prev and i != 0:
            out.append(charset[i - 1])
        prev = i
    return "".join(out)


# ---------------------------------------------------------------------------
# Host-side line segmentation (projection profiles)
# ---------------------------------------------------------------------------


def segment_lines(gray: np.ndarray, *, min_height: int = 4) -> list[tuple[int, int, int, int]]:
    """(H, W) grayscale [0,255] → [(top, bottom, left, right)] line boxes.

    Dark-on-light assumed; inverts automatically when the page mean says
    otherwise. Row-projection with gap splitting, column trim per line.
    """
    g = gray.astype(np.float32)
    if g.mean() < 127:
        g = 255.0 - g
    ink = (g < g.mean() - 0.15 * g.std()).astype(np.float32)
    rows = ink.sum(axis=1)
    active = rows > max(1.0, 0.02 * ink.shape[1])
    boxes = []
    start = None
    for y, a in enumerate(active.tolist() + [False]):
        if a and start is None:
            start = y
        elif not a and start is not None:
            if y - start >= min_height:
                cols = ink[start:y].sum(axis=0)
                nz = np.flatnonzero(cols > 0)
                if len(nz):
                    boxes.append((start, y, int(nz[0]), int(nz[-1]) + 1))
            start = None
    return boxes


def prepare_strip(gray: np.ndarray, box, cfg: OcrConfig) -> np.ndarray:
    """Crop a line box, normalize to (height, max_width) in [0,1] ink-on-
    zero orientation, right-padded."""
    top, bottom, left, right = box
    crop = gray[top:bottom, left:right].astype(np.float32)
    if crop.mean() > 127:
        crop = 255.0 - crop  # ink → high values
    crop /= max(crop.max(), 1.0)
    h, w = crop.shape
    new_w = max(1, int(round(w * cfg.height / h)))
    # Nearest-neighbor resize (no external deps).
    yi = np.clip((np.arange(cfg.height) * h / cfg.height).astype(int), 0, h - 1)
    xi = np.clip((np.arange(new_w) * w / new_w).astype(int), 0, w - 1)
    resized = crop[yi][:, xi]
    if new_w >= cfg.max_width:
        return resized[:, : cfg.max_width]
    out = np.zeros((cfg.height, cfg.max_width), np.float32)
    out[:, :new_w] = resized
    return out


# ---------------------------------------------------------------------------
# The attention recognizer (seq2seq over the same strip encoder)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttnOcrConfig:
    enc: OcrConfig = OcrConfig()
    max_chars: int = 64  # decoder context (incl. SOT + EOT)
    dec_layers: int = 2
    dec_heads: int = 4

    # Vocabulary layout shares the CTC label convention: 0 is PAD/blank,
    # chars are 1 + charset.index(c); SOT/EOT follow.
    @property
    def n_chars(self) -> int:
        return len(self.enc.charset)

    @property
    def sot(self) -> int:
        return self.n_chars + 1

    @property
    def eot(self) -> int:
        return self.n_chars + 2

    @property
    def n_vocab(self) -> int:
        return self.n_chars + 3

    def decoder_cfg(self):
        """Synthetic WhisperConfig driving the shared decoder kernels —
        only the text-side fields matter here."""
        from panoptikon_tpu_torch.models import whisper as _w

        return _w.WhisperConfig(
            n_vocab=self.n_vocab,
            n_text_ctx=self.max_chars,
            n_text_state=self.enc.width,
            n_text_layers=self.dec_layers,
            n_text_heads=self.dec_heads,
            n_audio_state=self.enc.width,
            sot=self.sot,
            eot=self.eot,
        )


ATTN_CONFIGS = {
    "attn-base": AttnOcrConfig(),
    "test-tiny": AttnOcrConfig(
        enc=CONFIGS["test-tiny"], max_chars=16, dec_layers=2, dec_heads=2
    ),
}


def init_attn_params(cfg: AttnOcrConfig, gen: torch.Generator) -> Params:
    """The encoder trunk (the CTC recognizer's layout: checkpoints share the
    trunk) and a whisper-layout ``decoder`` (``whisper.init_decoder``),
    drawn from ``gen``."""
    params = init_params(cfg.enc, gen)
    params["decoder"] = whisper.init_decoder(cfg.decoder_cfg(), gen)
    return params


@torch.inference_mode()
def attn_read(params: Params, cfg: AttnOcrConfig, strips):
    """strips (B, height, max_width) → (tokens (B, max_chars) int32,
    lengths (B,), confidence (B,) f32) by whisper's KV-cached greedy decode,
    on the device: the counterpart of the reference's ``attn_read_jit``.
    tokens[:, 0] is the SOT prompt; a row's characters are tokens[j,
    1:lengths[j]]."""
    memory = encode_strips(params, cfg.enc, strips)
    prompt = torch.full((strips.shape[0], 1), cfg.sot, dtype=torch.int32, device=strips.device)
    tokens, lengths, avg_logp = whisper.decode_from_feats(
        params, cfg.decoder_cfg(), memory, prompt, cfg.max_chars)
    return tokens, lengths, torch.exp(avg_logp)


def attn_collapse(tokens: np.ndarray, length: int, charset: str) -> str:
    """Generated token ids → text (PAD and specials dropped)."""
    out = []
    for t in tokens[1:length]:
        t = int(t)
        if 1 <= t <= len(charset):
            out.append(charset[t - 1])
    return "".join(out)
