"""In-process CLIP model implementation — the port of
``panoptikon_tpu/models/impls.py::ClipImpl``.

The same predict contract as the JAX class: inputs with an image ``file``,
pre-decoded ``{"pixels": (S, S, 3)}`` or ``{"text": ...}``; outputs are
L2-normalized f32 embeddings as npy bytes, or an ``input`` error slot for
that position only (a payload that does not decode, a wrong pixels shape, an
input of no known kind). Batches pad to the bucket ladder of
``models.batching``.

``precision="int8"`` is the serving embed: block weights are quantized once
in :meth:`ClipImpl.load`, the first real image batch and the first real
text batch each calibrate the static activation scales (one bf16 pass), and
every batch then runs the static-int8 block (``clip._block_int8_static``).

The host modules are the port's own copies of the JAX package's
(``models.base``, ``models.batching``, ``utils.npy``); ``PredictionInput``
and ``npy`` stay importable from here. The tokenizer and image decode are
re-declared here; ``tokenizers`` and ``PIL`` import lazily, as in the JAX
``impls`` module.
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
from typing import Any, Optional, Sequence

import numpy as np
import torch

from panoptikon_tpu_torch.device import device as select_device
from panoptikon_tpu_torch.models import batching, clip
from panoptikon_tpu_torch.models.base import InferenceModel, PredictionInput, SlotError
from panoptikon_tpu_torch.utils import npy

__all__ = ["ClipImpl", "HashTokenizer", "PredictionInput", "decode_image", "load_tokenizer", "npy"]

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)
INIT_SEED = 0


def decode_image(payload: bytes, size: int) -> np.ndarray:
    """bytes -> (size, size, 3) f32, CLIP-normalized (shorter side resized,
    then center crop). Raises SlotError('input') for undecodable payloads."""
    from PIL import Image

    try:
        with Image.open(io.BytesIO(payload)) as im:
            im = im.convert("RGB")
            w, h = im.size
            scale = size / min(w, h)
            im = im.resize((max(size, round(w * scale)), max(size, round(h * scale))))
            w, h = im.size
            left, top = (w - size) // 2, (h - size) // 2
            im = im.crop((left, top, left + size, top + size))
            arr = np.asarray(im, dtype=np.float32) / 255.0
    except Exception as exc:
        raise SlotError("input", f"Undecodable image payload: {exc}") from exc
    return (arr - CLIP_MEAN) / CLIP_STD


class HashTokenizer:
    """Deterministic fallback tokenizer (no vocab files offline): whitespace
    split + stable hash into the vocab, the JAX package's ids exactly."""

    def __init__(self, vocab: int, bos: int = 1, eos: int = 2):
        self.vocab = vocab
        self.bos = bos
        self.eos = eos

    def encode(self, text: str) -> list[int]:
        ids = [self.bos]
        for word in text.lower().split():
            h = int.from_bytes(hashlib.sha1(word.encode()).digest()[:4], "little")
            ids.append(3 + h % (self.vocab - 3))
        ids.append(self.eos)
        return ids


def load_tokenizer(tokenizer_path: Optional[str], vocab: int):
    if tokenizer_path:
        try:
            from tokenizers import Tokenizer

            tok = Tokenizer.from_file(tokenizer_path)
            return lambda text: tok.encode(text).ids
        except Exception:
            pass
    return HashTokenizer(vocab).encode


class ClipImpl(InferenceModel):
    """OpenCLIP-equivalent image/text encoder on one explicit device: encodes
    image files, pre-decoded pixels and ``{"text": ...}`` inputs in one
    batch, L2-normalized f32 features as npy bytes."""

    def __init__(
        self,
        model_arch: str = "ViT-B-32",
        checkpoint: Optional[str] = None,
        tokenizer_path: Optional[str] = None,
        context_length: Optional[int] = None,
        batch_cap: int = 64,
        precision: str = "bf16",
        device: str | torch.device = "cuda",
        **_: Any,
    ):
        if checkpoint:
            raise NotImplementedError(
                "ClipImpl(checkpoint=...): the checkpoint weight mapping "
                "(panoptikon_tpu/models/weights.py) imports jax; see ROADMAP A.8"
            )
        self.arch = model_arch
        self.cfg = clip.CONFIGS.get(model_arch) or clip.CONFIGS["ViT-B-32"]
        if precision != self.cfg.matmul_precision:
            self.cfg = dataclasses.replace(self.cfg, matmul_precision=precision)
        self.device = select_device(str(device))
        self.context_length = context_length or self.cfg.text_ctx
        self.batch_ladder = batching.bucket_ladder(batch_cap)
        self.tokenize = load_tokenizer(tokenizer_path, self.cfg.text_vocab)
        self.params = None
        # Calibrated per-tensor activation scales of the static int8 paths:
        # taken from the FIRST real batch of each kind (one bf16 pass), then
        # frozen — standard PTQ calibration.
        self._act_scales = None
        self._text_scales = None

    @classmethod
    def name(cls) -> str:
        return "clip"

    def load(self) -> None:
        if self.params is not None:
            return
        gen = torch.Generator(device=self.device).manual_seed(INIT_SEED)
        self.params = clip.init_params(self.cfg, gen)
        if self.cfg.matmul_precision == "int8":
            # Weight quantization happens ONCE here, not per forward.
            self.params = clip.quantize_block_weights(self.params)

    def unload(self) -> None:
        self.params = None
        self._act_scales = None
        self._text_scales = None

    def prepare(self) -> None:
        """Prewarm every bucket shape (kernel builds, library handles). With
        int8 the warm-up calibrates on its all-zeros batch and THROWS the
        scales away: keeping them would understate real activation ranges
        and freeze saturating scales, since predict only calibrates while
        unset — the first genuine batch must calibrate."""
        self.load()
        size = self.cfg.image_size
        for bucket in self.batch_ladder:
            images = torch.zeros((bucket, size, size, 3), dtype=torch.float32, device=self.device)
            ids = torch.zeros((bucket, self.cfg.text_ctx), dtype=torch.int32, device=self.device)
            if self.cfg.matmul_precision == "int8":
                warm = self._act_scales
                if warm is None:
                    warm = clip.calibrate_image_scales(self.params, self.cfg, images)
                clip.embed_images_scaled(self.params, self.cfg, images, warm)
                warm_t = self._text_scales
                if warm_t is None:
                    warm_t = clip.calibrate_text_scales(self.params, self.cfg, ids)
                clip.embed_texts_scaled(self.params, self.cfg, ids, warm_t)
            else:
                clip.embed_images(self.params, self.cfg, images)
                clip.embed_texts(self.params, self.cfg, ids)

    def _embed_images(self, batch: np.ndarray) -> np.ndarray:
        images = torch.from_numpy(batch).to(self.device)
        if self.cfg.matmul_precision != "int8":
            return clip.embed_images(self.params, self.cfg, images).cpu().numpy()
        if self._act_scales is None:
            self._act_scales = clip.calibrate_image_scales(self.params, self.cfg, images)
        feats = clip.embed_images_scaled(self.params, self.cfg, images, self._act_scales)
        return feats.cpu().numpy()

    def _embed_texts(self, ids: np.ndarray) -> np.ndarray:
        token_ids = torch.from_numpy(ids).to(self.device)
        if self.cfg.matmul_precision != "int8":
            return clip.embed_texts(self.params, self.cfg, token_ids).cpu().numpy()
        if self._text_scales is None:
            self._text_scales = clip.calibrate_text_scales(self.params, self.cfg, token_ids)
        feats = clip.embed_texts_scaled(self.params, self.cfg, token_ids, self._text_scales)
        return feats.cpu().numpy()

    def token_ids(self, texts: Sequence[str]) -> np.ndarray:
        """(bucket, text_ctx) int32 token ids of ``texts``, padded to the
        batch bucket, exactly as :meth:`predict` embeds them."""
        seqs = [self.tokenize(t)[: self.context_length] for t in texts]
        ids, _, _ = batching.pad_token_batch(seqs, [self.cfg.text_ctx], self.batch_ladder)
        return ids

    def predict(self, inputs: Sequence[PredictionInput]) -> list[Any]:
        self.load()
        outputs: list[Any] = [None] * len(inputs)
        images, image_pos = [], []
        texts, text_pos = [], []
        want = (self.cfg.image_size, self.cfg.image_size, 3)
        for i, inp in enumerate(inputs):
            if inp.file is not None:
                try:
                    images.append(decode_image(inp.file, self.cfg.image_size))
                    image_pos.append(i)
                except SlotError as err:
                    outputs[i] = err.to_slot()
            elif isinstance(inp.data, dict) and "pixels" in inp.data:
                arr = np.asarray(inp.data["pixels"], dtype=np.float32)
                if arr.shape != want:
                    outputs[i] = SlotError("input", f"pixels shape {arr.shape} != {want}").to_slot()
                else:
                    images.append(arr)
                    image_pos.append(i)
            elif isinstance(inp.data, dict) and "text" in inp.data:
                texts.append(str(inp.data["text"]))
                text_pos.append(i)
            else:
                outputs[i] = SlotError(
                    "input", "Input must be an image file or {'text': ...}"
                ).to_slot()

        if images:
            bucket = batching.bucket_for(len(images), self.batch_ladder)
            padded, _ = batching.pad_batch(np.stack(images), bucket)
            feats = self._embed_images(padded)
            for j, pos in enumerate(image_pos):
                outputs[pos] = npy.serialize_npy(feats[j])
        if texts:
            feats = self._embed_texts(self.token_ids(texts))
            for j, pos in enumerate(text_pos):
                outputs[pos] = npy.serialize_npy(feats[j])
        return outputs
