"""Audio embedding tower on tensors — the port of ``models/audio.py``.

The CLAP-class audio tower (the reference worker's
``python/inferio/impl/clap.py``: audio file → normalized embedding): an
AST-style transformer over log-mel patches. The host log-mel is whisper's
(``models.whisper``), padded or center-cropped within the clip's content
to a static frame budget (:func:`prepare_mels`); non-overlapping
(mel × time) patches embed as one reshape and one matmul; the trunk is the
CLIP block (``models.clip._block``, bf16, attention through kernel B3 on
the card: 320 tokens a clip at ``clap-base``); mean pooling, a projection
into the shared audio-text space, L2 normalisation.

``AudioConfig``, ``CONFIGS``, :func:`prepare_mels` and the HF ``ASTModel``
checkpoint mapping (:func:`load_ast_checkpoint`) are copied from the JAX
package and held to it by ``tests/test_torch_host_copies.py``. The exporter,
:func:`save_ast_checkpoint`, writes the same state dict as a torch ``.bin``
(the reference writes ``.safetensors``, a package the card machine lacks).
Parameters keep the JAX package's keys and layouts, so
``models.convert.params_from_jax`` carries a JAX tree over unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from panoptikon_tpu_torch.models import clip as _clip

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class AudioConfig:
    n_mels: int = 80
    time_frames: int = 1024  # ~10.2 s at hop 160 / 16 kHz
    mel_patch: int = 16
    time_patch: int = 16
    width: int = 768
    layers: int = 12
    heads: int = 12
    embed_dim: int = 512
    mlp_ratio: int = 4
    matmul_precision: str = "bf16"

    @property
    def grid(self) -> tuple[int, int]:
        return (self.n_mels // self.mel_patch, self.time_frames // self.time_patch)

    @property
    def tokens(self) -> int:
        g = self.grid
        return g[0] * g[1]


CONFIGS = {
    "ast-base": AudioConfig(),
    "clap-base": AudioConfig(width=512, layers=8, heads=8, embed_dim=512),
    "test-tiny": AudioConfig(
        n_mels=16, time_frames=64, mel_patch=8, time_patch=8,
        width=32, layers=2, heads=2, embed_dim=32,
    ),
}


def init_params(cfg: AudioConfig, gen: torch.Generator) -> Params:
    """Random f32 parameters with the JAX package's shapes and scales, drawn
    from ``gen`` on ``gen.device``. The values differ from ``jax.random``'s;
    tests that compare the two packages convert one JAX tree instead."""
    dev, f32 = gen.device, torch.float32
    patch_dim = cfg.mel_patch * cfg.time_patch
    return {
        "patch_w": _clip._normal(gen, (patch_dim, cfg.width), patch_dim**-0.5, f32),
        "pos_emb": _clip._normal(gen, (cfg.tokens, cfg.width), 0.02, f32),
        "ln_pre": _clip._ln(cfg.width, f32, dev),
        "blocks": [_clip._init_block(gen, cfg.width, cfg.mlp_ratio * cfg.width, f32)
                   for _ in range(cfg.layers)],
        "ln_post": _clip._ln(cfg.width, f32, dev),
        "proj": _clip._normal(gen, (cfg.width, cfg.embed_dim), cfg.width**-0.5, f32),
    }


def encode_audio(params: Params, cfg: AudioConfig, mels, normalize: bool = True):
    """mels (B, n_mels, time_frames) log-mel on the parameters' device →
    (B, embed_dim) f32, L2-normalized."""
    b = mels.shape[0]
    gm, gt = cfg.grid
    x = mels.to(torch.bfloat16)
    # (B, gm, mp, gt, tp) → (B, gm·gt, mp·tp): the patch conv as one matmul.
    x = x.reshape(b, gm, cfg.mel_patch, gt, cfg.time_patch).permute(0, 1, 3, 2, 4)
    x = x.reshape(b, gm * gt, -1) @ params["patch_w"].to(x.dtype)
    x = x + params["pos_emb"].to(x.dtype)[None]
    x = _clip._layernorm(x, params["ln_pre"])
    for blk in params["blocks"]:
        x = _clip._block(x, blk, cfg.heads, causal=False, precision=cfg.matmul_precision)
    x = _clip._layernorm(x, params["ln_post"])
    pooled = x.mean(dim=1)
    feats = (pooled @ params["proj"].to(pooled.dtype)).to(torch.float32)
    return _clip._normalize(feats) if normalize else feats


@torch.inference_mode()
def embed_audio(params: Params, cfg: AudioConfig, mels):
    """L2-normalized audio embeddings (the retrieval embed)."""
    return encode_audio(params, cfg, mels)


def prepare_mels(pcm: np.ndarray, cfg: AudioConfig) -> np.ndarray:
    """Mono f32 PCM @16 kHz → (n_mels, time_frames) log-mel, padded or
    center-cropped to the static frame budget."""
    from panoptikon_tpu_torch.models import whisper as _w

    mel = _w.log_mel_spectrogram(pcm, cfg.n_mels)
    # Whisper's mel is zero-padded to a full 30 s chunk; crop within the
    # ACTUAL content (center) so short clips don't embed pure padding.
    actual = min(mel.shape[1], max(1, len(pcm) // _w.HOP))
    mel = mel[:, :actual]
    t = mel.shape[1]
    if t < cfg.time_frames:
        mel = np.pad(mel, ((0, 0), (0, cfg.time_frames - t)))
    elif t > cfg.time_frames:
        start = (t - cfg.time_frames) // 2
        mel = mel[:, start : start + cfg.time_frames]
    return mel.astype(np.float32)


# ---------------------------------------------------------------------------
# HF ASTModel checkpoint mapping (BERT-style block naming)
# ---------------------------------------------------------------------------


def _bert_block(sd, prefix: str) -> dict:
    def lin(p):
        return (
            np.asarray(sd[f"{p}.weight"], np.float32).T,
            np.asarray(sd[f"{p}.bias"], np.float32),
        )

    qw, qb = lin(f"{prefix}.attention.attention.query")
    kw, kb = lin(f"{prefix}.attention.attention.key")
    vw, vb = lin(f"{prefix}.attention.attention.value")
    ow, ob = lin(f"{prefix}.attention.output.dense")
    fw, fb = lin(f"{prefix}.intermediate.dense")
    pw, pb = lin(f"{prefix}.output.dense")

    def ln(p):
        return {
            "scale": np.asarray(sd[f"{p}.weight"], np.float32),
            "bias": np.asarray(sd[f"{p}.bias"], np.float32),
        }

    return {
        "ln_1": ln(f"{prefix}.layernorm_before"),
        "attn": {
            "qkv_w": np.concatenate([qw, kw, vw], axis=1),
            "qkv_b": np.concatenate([qb, kb, vb]),
            "out_w": ow,
            "out_b": ob,
        },
        "ln_2": ln(f"{prefix}.layernorm_after"),
        "mlp": {"fc_w": fw, "fc_b": fb, "proj_w": pw, "proj_b": pb},
    }


def load_ast_checkpoint(path, cfg: AudioConfig) -> Params:
    """HF ``ASTModel`` state dict → our audio param tree. The AST patch
    conv is (width, 1, mp, tp) → flattened (mp·tp, width); CLS/distill
    tokens are dropped (we mean-pool); position embeddings are cropped to
    the patch grid."""
    from panoptikon_tpu_torch.models.weights import load_state_dict

    sd = load_state_dict(path)
    pfx = "audio_spectrogram_transformer" if any(
        k.startswith("audio_spectrogram_transformer") for k in sd
    ) else ""
    dot = "." if pfx else ""
    conv = np.asarray(
        sd[f"{pfx}{dot}embeddings.patch_embeddings.projection.weight"], np.float32
    )
    width = conv.shape[0]
    patch_w = conv.transpose(2, 3, 1, 0).reshape(-1, width)
    pos = np.asarray(sd[f"{pfx}{dot}embeddings.position_embeddings"], np.float32)
    pos = pos.reshape(-1, width)[-cfg.tokens:]

    def ln(p):
        return {
            "scale": np.asarray(sd[f"{p}.weight"], np.float32),
            "bias": np.asarray(sd[f"{p}.bias"], np.float32),
        }

    params = {
        "patch_w": patch_w,
        "pos_emb": pos,
        # AST has no pre-LN; identity.
        "ln_pre": {
            "scale": np.ones(width, np.float32),
            "bias": np.zeros(width, np.float32),
        },
        "blocks": [
            _bert_block(sd, f"{pfx}{dot}encoder.layer.{i}")
            for i in range(cfg.layers)
        ],
        "ln_post": ln(f"{pfx}{dot}layernorm"),
        "proj": np.asarray(
            sd.get("audio_projection.weight", np.eye(width, cfg.embed_dim, dtype=np.float32).T),
            np.float32,
        ).T
        if "audio_projection.weight" in sd
        else np.eye(width, cfg.embed_dim, dtype=np.float32),
    }
    return params


def save_ast_checkpoint(params, cfg: AudioConfig, path) -> None:
    """Our audio param tree → an HF ``ASTModel``-layout state dict, as a torch
    ``.bin`` — the export inverse of :func:`load_ast_checkpoint`. The
    reference's exporter writes the same tensors as ``.safetensors``. CLS and
    distillation position rows are written as zeros (the loader crops to the
    trailing patch grid) and the projection is stored under
    ``audio_projection.weight``."""
    out: dict[str, np.ndarray] = {}
    patch_w = np.asarray(params["patch_w"], np.float32)
    width = patch_w.shape[1]
    out["embeddings.patch_embeddings.projection.weight"] = (
        patch_w.reshape(cfg.mel_patch, cfg.time_patch, 1, width).transpose(3, 2, 0, 1))
    out["embeddings.patch_embeddings.projection.bias"] = np.zeros(width, np.float32)
    pos = np.asarray(params["pos_emb"], np.float32)
    out["embeddings.position_embeddings"] = np.concatenate(
        [np.zeros((2, width), np.float32), pos])[None]
    out["embeddings.cls_token"] = np.zeros((1, 1, width), np.float32)
    out["embeddings.distillation_token"] = np.zeros((1, 1, width), np.float32)

    def put_ln(prefix, q):
        out[f"{prefix}.weight"] = np.asarray(q["scale"], np.float32)
        out[f"{prefix}.bias"] = np.asarray(q["bias"], np.float32)

    def put_lin(prefix, w, b):
        out[f"{prefix}.weight"] = np.asarray(w, np.float32).T
        out[f"{prefix}.bias"] = np.asarray(b, np.float32)

    for i, blk in enumerate(params["blocks"]):
        p = f"encoder.layer.{i}"
        qkv_w = np.asarray(blk["attn"]["qkv_w"], np.float32)
        qkv_b = np.asarray(blk["attn"]["qkv_b"], np.float32)
        d = qkv_w.shape[0]
        put_ln(f"{p}.layernorm_before", blk["ln_1"])
        for j, name in enumerate(("query", "key", "value")):
            put_lin(f"{p}.attention.attention.{name}", qkv_w[:, j * d:(j + 1) * d],
                    qkv_b[j * d:(j + 1) * d])
        put_lin(f"{p}.attention.output.dense", blk["attn"]["out_w"], blk["attn"]["out_b"])
        put_ln(f"{p}.layernorm_after", blk["ln_2"])
        put_lin(f"{p}.intermediate.dense", blk["mlp"]["fc_w"], blk["mlp"]["fc_b"])
        put_lin(f"{p}.output.dense", blk["mlp"]["proj_w"], blk["mlp"]["proj_b"])
    put_ln("layernorm", params["ln_post"])
    out["audio_projection.weight"] = np.asarray(params["proj"], np.float32).T
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in out.items()}, str(path))
