"""Checkpoint loading: HuggingFace state dicts → the port's parameter trees.

The jax-free half of ``panoptikon_tpu/models/weights.py``: the HF
``CLIPModel`` mapping (with its export inverse) and the BERT-style
sentence-transformer mapping, copied function for function and held to the
reference's by ``tests/test_torch_host_copies.py``. The trees come out as
NumPy arrays with the JAX package's keys and layouts;
``models.convert.params_from_jax`` puts them on a device. The configs are
the port's ``ClipConfig`` and ``TextEncoderConfig``.

A ``.bin``/``.pt`` pickle loads through ``torch.load(weights_only=True)``. A
``.safetensors`` file needs the ``safetensors`` package, imported when such
a file is loaded; where it is missing the load raises and says so. The
whisper and timm mappings are not here yet (ROADMAP A.11).

This module never downloads; it loads from local paths.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Mapping

import numpy as np

from panoptikon_tpu_torch.models.clip import ClipConfig
from panoptikon_tpu_torch.models.text_embed import TextEncoderConfig


def load_state_dict(path: str | Path) -> dict[str, np.ndarray]:
    path = Path(path)
    if path.is_dir():
        for candidate in ("model.safetensors", "pytorch_model.bin", "open_clip_pytorch_model.bin"):
            if (path / candidate).exists():
                path = path / candidate
                break
        else:
            raise FileNotFoundError(f"no checkpoint file under {path}")
    if path.suffix == ".safetensors":
        try:
            from safetensors.numpy import load_file
        except ImportError as exc:
            raise RuntimeError(
                f"{path}: loading a .safetensors checkpoint needs the safetensors package, "
                "which is not installed; save the state dict as a torch .bin instead"
            ) from exc

        return dict(load_file(str(path)))
    import torch

    sd = torch.load(str(path), map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v) for k, v in sd.items()}


def _ln(sd: Mapping[str, np.ndarray], prefix: str) -> dict:
    return {
        "scale": np.asarray(sd[f"{prefix}.weight"], np.float32),
        "bias": np.asarray(sd[f"{prefix}.bias"], np.float32),
    }


def _linear(sd: Mapping[str, np.ndarray], prefix: str) -> tuple[np.ndarray, np.ndarray]:
    # torch Linear stores (out, in); our matmuls are x @ W so transpose.
    w = np.asarray(sd[f"{prefix}.weight"], np.float32).T
    b = np.asarray(sd[f"{prefix}.bias"], np.float32)
    return w, b


def _hf_clip_block(sd: Mapping[str, np.ndarray], prefix: str) -> dict:
    qw, qb = _linear(sd, f"{prefix}.self_attn.q_proj")
    kw, kb = _linear(sd, f"{prefix}.self_attn.k_proj")
    vw, vb = _linear(sd, f"{prefix}.self_attn.v_proj")
    ow, ob = _linear(sd, f"{prefix}.self_attn.out_proj")
    fw, fb = _linear(sd, f"{prefix}.mlp.fc1")
    pw, pb = _linear(sd, f"{prefix}.mlp.fc2")
    return {
        "ln_1": _ln(sd, f"{prefix}.layer_norm1"),
        "attn": {
            "qkv_w": np.concatenate([qw, kw, vw], axis=1),
            "qkv_b": np.concatenate([qb, kb, vb]),
            "out_w": ow,
            "out_b": ob,
        },
        "ln_2": _ln(sd, f"{prefix}.layer_norm2"),
        "mlp": {"fc_w": fw, "fc_b": fb, "proj_w": pw, "proj_b": pb},
    }


def load_clip_checkpoint(path: str | Path, cfg: ClipConfig) -> dict[str, Any]:
    """HF ``CLIPModel`` state dict → our CLIP param tree."""
    sd = load_state_dict(path)
    v_prefix = "vision_model"
    t_prefix = "text_model"
    # Patch conv (out, in, kh, kw) → (kh·kw·in, out) matching our
    # (g,p,g,p,C) → (p·p·3) patch flatten order.
    conv = np.asarray(sd[f"{v_prefix}.embeddings.patch_embedding.weight"], np.float32)
    out_ch = conv.shape[0]
    patch_w = conv.transpose(2, 3, 1, 0).reshape(-1, out_ch)
    pos = np.asarray(sd[f"{v_prefix}.embeddings.position_embedding.weight"], np.float32)
    visual = {
        "patch_w": patch_w,
        "class_emb": np.asarray(sd[f"{v_prefix}.embeddings.class_embedding"], np.float32).reshape(-1),
        "pos_emb": pos,
        "ln_pre": _ln(sd, f"{v_prefix}.pre_layrnorm")
        if f"{v_prefix}.pre_layrnorm.weight" in sd
        else _ln(sd, f"{v_prefix}.pre_layernorm"),
        "blocks": [
            _hf_clip_block(sd, f"{v_prefix}.encoder.layers.{i}")
            for i in range(cfg.vision_layers)
        ],
        "ln_post": _ln(sd, f"{v_prefix}.post_layernorm"),
        "proj": np.asarray(sd["visual_projection.weight"], np.float32).T,
    }
    text = {
        "token_emb": np.asarray(sd[f"{t_prefix}.embeddings.token_embedding.weight"], np.float32),
        "pos_emb": np.asarray(sd[f"{t_prefix}.embeddings.position_embedding.weight"], np.float32),
        "blocks": [
            _hf_clip_block(sd, f"{t_prefix}.encoder.layers.{i}")
            for i in range(cfg.text_layers)
        ],
        "ln_final": _ln(sd, f"{t_prefix}.final_layer_norm"),
        "proj": np.asarray(sd["text_projection.weight"], np.float32).T,
    }
    return {
        "visual": visual,
        "text": text,
        "logit_scale": np.asarray(sd.get("logit_scale", np.log(1 / 0.07)), np.float32),
    }


def save_clip_checkpoint(params, cfg: ClipConfig, path: str | Path) -> None:
    """Our CLIP param tree → an HF ``CLIPModel`` state dict on disk
    (torch ``.bin``) — the export inverse of :func:`load_clip_checkpoint`,
    round-trip tested. Lets finetuned towers interoperate with the HF/
    OpenCLIP ecosystem and gives the test suite a REAL checkpoint format
    to prove the load path end-to-end."""
    import torch

    sd: dict[str, np.ndarray] = {}

    def put_linear(prefix: str, w: np.ndarray, b: np.ndarray) -> None:
        sd[f"{prefix}.weight"] = np.asarray(w, np.float32).T
        sd[f"{prefix}.bias"] = np.asarray(b, np.float32)

    def put_ln(prefix: str, p) -> None:
        sd[f"{prefix}.weight"] = np.asarray(p["scale"], np.float32)
        sd[f"{prefix}.bias"] = np.asarray(p["bias"], np.float32)

    def put_block(prefix: str, blk) -> None:
        qkv_w = np.asarray(blk["attn"]["qkv_w"], np.float32)
        qkv_b = np.asarray(blk["attn"]["qkv_b"], np.float32)
        w3 = np.split(qkv_w, 3, axis=1)
        b3 = np.split(qkv_b, 3)
        for name, w, b in zip(("q_proj", "k_proj", "v_proj"), w3, b3):
            put_linear(f"{prefix}.self_attn.{name}", w, b)
        put_linear(f"{prefix}.self_attn.out_proj",
                   blk["attn"]["out_w"], blk["attn"]["out_b"])
        put_ln(f"{prefix}.layer_norm1", blk["ln_1"])
        put_ln(f"{prefix}.layer_norm2", blk["ln_2"])
        put_linear(f"{prefix}.mlp.fc1", blk["mlp"]["fc_w"], blk["mlp"]["fc_b"])
        put_linear(f"{prefix}.mlp.fc2", blk["mlp"]["proj_w"], blk["mlp"]["proj_b"])

    v = params["visual"]
    patch_w = np.asarray(v["patch_w"], np.float32)
    p = cfg.patch_size
    out_ch = patch_w.shape[1]
    sd["vision_model.embeddings.patch_embedding.weight"] = (
        patch_w.reshape(p, p, 3, out_ch).transpose(3, 2, 0, 1)
    )
    sd["vision_model.embeddings.class_embedding"] = np.asarray(
        v["class_emb"], np.float32
    )
    sd["vision_model.embeddings.position_embedding.weight"] = np.asarray(
        v["pos_emb"], np.float32
    )
    put_ln("vision_model.pre_layrnorm", v["ln_pre"])
    for i, blk in enumerate(v["blocks"]):
        put_block(f"vision_model.encoder.layers.{i}", blk)
    put_ln("vision_model.post_layernorm", v["ln_post"])
    sd["visual_projection.weight"] = np.asarray(v["proj"], np.float32).T

    t = params["text"]
    sd["text_model.embeddings.token_embedding.weight"] = np.asarray(
        t["token_emb"], np.float32
    )
    sd["text_model.embeddings.position_embedding.weight"] = np.asarray(
        t["pos_emb"], np.float32
    )
    for i, blk in enumerate(t["blocks"]):
        put_block(f"text_model.encoder.layers.{i}", blk)
    put_ln("text_model.final_layer_norm", t["ln_final"])
    sd["text_projection.weight"] = np.asarray(t["proj"], np.float32).T
    sd["logit_scale"] = np.asarray(params["logit_scale"], np.float32)

    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}, str(path))


def load_text_encoder_checkpoint(path: str | Path, cfg: TextEncoderConfig) -> dict[str, Any]:
    """BERT-style (MiniLM/mpnet) state dict → our text encoder params."""
    sd = load_state_dict(path)

    def find(*names):
        for n in names:
            if n in sd:
                return np.asarray(sd[n], np.float32)
        raise KeyError(f"none of {names} in checkpoint")

    params: dict[str, Any] = {
        "token_emb": find("embeddings.word_embeddings.weight", "bert.embeddings.word_embeddings.weight"),
        "pos_emb": find("embeddings.position_embeddings.weight", "bert.embeddings.position_embeddings.weight"),
        "type_emb": find("embeddings.token_type_embeddings.weight", "bert.embeddings.token_type_embeddings.weight"),
        "ln_emb": {
            "scale": find("embeddings.LayerNorm.weight", "bert.embeddings.LayerNorm.weight"),
            "bias": find("embeddings.LayerNorm.bias", "bert.embeddings.LayerNorm.bias"),
        },
        "blocks": [],
    }
    i = 0
    while f"encoder.layer.{i}.attention.self.query.weight" in sd or f"bert.encoder.layer.{i}.attention.self.query.weight" in sd:
        p = f"encoder.layer.{i}" if f"encoder.layer.{i}.attention.self.query.weight" in sd else f"bert.encoder.layer.{i}"
        qw, qb = _linear(sd, f"{p}.attention.self.query")
        kw, kb = _linear(sd, f"{p}.attention.self.key")
        vw, vb = _linear(sd, f"{p}.attention.self.value")
        ow, ob = _linear(sd, f"{p}.attention.output.dense")
        fw, fb = _linear(sd, f"{p}.intermediate.dense")
        pw, pb = _linear(sd, f"{p}.output.dense")
        params["blocks"].append(
            {
                "attn": {
                    "qkv_w": np.concatenate([qw, kw, vw], axis=1),
                    "qkv_b": np.concatenate([qb, kb, vb]),
                    "out_w": ow,
                    "out_b": ob,
                },
                "ln_attn": _ln(sd, f"{p}.attention.output.LayerNorm"),
                "mlp": {"fc_w": fw, "fc_b": fb, "proj_w": pw, "proj_b": pb},
                "ln_mlp": _ln(sd, f"{p}.output.LayerNorm"),
            }
        )
        i += 1
    if i != cfg.layers:
        raise ValueError(f"checkpoint has {i} layers, config expects {cfg.layers}")
    return params
