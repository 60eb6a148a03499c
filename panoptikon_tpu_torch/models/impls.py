"""In-process model implementations — the port of
``panoptikon_tpu/models/impls.py``: ``ClipImpl``, ``TextEmbedImpl``,
``TaggerImpl``, ``WhisperImpl``, ``ClapImpl``, ``CaptionerImpl``,
``VlmTaggerImpl``, the host-only ``Md5LookupImpl``, ``ApiEmbedImpl`` and
``TagApiImpl`` (copied text for text), ``OcrImpl`` and the fixture impls the
manager's tests drive, indexed by ``impl_class`` in :data:`IMPL_INDEX`, which
holds every ``impl_class`` of the reference's; any other raises
``ModelLoadError`` at load through ``models.discovery`` unless a user's
``impl_dirs`` defines it, as in the reference.

``ClipImpl`` has the same predict contract as the JAX class: inputs with an
image ``file``, pre-decoded ``{"pixels": (S, S, 3)}`` or ``{"text": ...}``; outputs are
L2-normalized f32 embeddings as npy bytes, or an ``input`` error slot for
that position only (a payload that does not decode, a wrong pixels shape, an
input of no known kind). Images and texts embed in slices of at most the top
batch bucket, each padded to its bucket of ``models.batching``'s ladder.

``precision="int8"`` is the serving embed: block weights are quantized once
in :meth:`ClipImpl.load`, the first real image slice and the first real
text slice each calibrate the static activation scales (one bf16 pass), and
every slice then runs the static-int8 block (``clip._block_int8_static``).
``TaggerImpl`` takes the same option for its trunk.

``TextEmbedImpl`` is the sentence-transformer embedder: one text in, a 2D
npy array of chunk embeddings out, with the reference's chunking, task
prompt and combined row. It encodes a call's chunks in slices of at most
the top batch bucket, shortest chunks first, each slice padded to its own
(length × batch) bucket, so any number of chunks gives every text its rows
(the JAX class pads all of a call's chunks as one batch, which fails past
the top bucket: ROADMAP §C).

``KimiVlImpl`` (the port's own: no JAX class) is a real VLM captioner,
Kimi-VL-A3B (``models.kimi_vl``), on the captioner's contract; it takes
image files and pre-decoded ``{"pixels": ...}`` as ``ClipImpl`` does.

``TaggerImpl``, ``CaptionerImpl`` and ``VlmTaggerImpl`` take image files,
as the JAX classes do, and have an array entry each (``tag_arrays``,
``caption_arrays``) that takes normalised pixels: ``predict`` is the host
decode and that entry.

``OcrImpl`` takes image files, as the JAX class does, and has an array
entry (``read_arrays``) that takes grayscale pages; it recognizes a call's
line strips in slices of at most the top batch bucket (the JAX class pads
them as one batch and raises past it: ROADMAP §C).

``WhisperImpl`` and ``ClapImpl`` take WAV files (``decode_wav``, copied
from the JAX package: mono 16 kHz, a downmix and a linear resample
otherwise), with the JAX classes' outputs: a transcript with its language
and confidences, and an L2-normalized audio embedding.

A ``checkpoint`` (a local HF ``.bin`` or ``.safetensors``, or a folder
holding one; a timm state dict for the tagger, and a whisper-decoder one as
the captioner's ``decoder_checkpoint``) loads through ``models.weights`` and
``models.convert.params_from_jax``; without one the weights are random,
drawn from a fixed seed on the impl's device.

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
import time
from typing import Any, Optional, Sequence

import numpy as np
import torch

from panoptikon_tpu_torch import tracing
from panoptikon_tpu_torch.device import device as select_device
from panoptikon_tpu_torch.models import (audio, batching, clip, convert, kimi_vl, ocr,
                                         text_embed, weights, whisper)
from panoptikon_tpu_torch.models.base import InferenceModel, PredictionInput, SlotError
from panoptikon_tpu_torch.utils import npy

__all__ = ["IMPL_INDEX", "ApiEmbedImpl", "CaptionerImpl", "ClapImpl", "ClipImpl", "HashTokenizer",
           "KimiVlImpl", "Md5LookupImpl", "OcrImpl", "PredictionInput", "TagApiImpl", "TaggerImpl",
           "TextEmbedImpl", "VlmTaggerImpl", "WhisperImpl", "decode_image", "decode_wav",
           "load_tokenizer", "npy"]

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)
INIT_SEED = 0  # ClipImpl's random weights; the other impls' seeds follow
TEXT_INIT_SEED = 1
TAGGER_INIT_SEED = 2
WHISPER_INIT_SEED = 4
CLAP_INIT_SEED = 5
CAPTIONER_INIT_SEED = 7
OCR_INIT_SEED = 11
KIMI_VL_INIT_SEED = 13
# The pixels of an image slice go to the card in chunks of this many bytes,
# each uploaded while the host copies the next into the staging buffer (on
# the card's host every size from 2 to 160 MB staged a slice alike: PERF.md
# §6).
STAGE_CHUNK_BYTES = 16 << 20


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
    image files, pre-decoded pixels and ``{"text": ...}`` inputs,
    L2-normalized f32 features as npy bytes. Images and texts go in slices
    of at most the top batch bucket, each padded to its own bucket (the JAX
    class pads a call as one batch and raises past the top bucket: ROADMAP
    §C, C.4); with int8 the first image slice and the first text slice
    calibrate. Image slices share one staging buffer, so an instance takes
    one call at a time, as the model manager's dispatch gives it."""

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
        self.arch = model_arch
        self.cfg = clip.CONFIGS.get(model_arch) or clip.CONFIGS["ViT-B-32"]
        if precision != self.cfg.matmul_precision:
            self.cfg = dataclasses.replace(self.cfg, matmul_precision=precision)
        self.checkpoint = checkpoint
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
        # The host buffer image slices are staged in (allocated at first
        # use), and the event after its last upload (CUDA only).
        self._staging: Optional[torch.Tensor] = None
        self._staged = None

    @classmethod
    def name(cls) -> str:
        return "clip"

    def load(self) -> None:
        if self.params is not None:
            return
        if self.checkpoint:
            tree = weights.load_clip_checkpoint(self.checkpoint, self.cfg)
            self.params = convert.params_from_jax(tree, device=self.device)
        else:
            gen = torch.Generator(device=self.device).manual_seed(INIT_SEED)
            self.params = clip.init_params(self.cfg, gen)
        if self.cfg.matmul_precision == "int8":
            # Weight quantization happens ONCE here, not per forward.
            self.params = clip.quantize_block_weights(self.params)

    def unload(self) -> None:
        self.params = None
        self._act_scales = None
        self._text_scales = None
        self._staging = None
        self._staged = None

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

    def _stage_images(self, images: Sequence[np.ndarray], bucket: int) -> torch.Tensor:
        """The (bucket, S, S, 3) f32 batch of ``images`` on the device, pad
        rows repeating row 0 as ``batching.pad_batch`` pads them. The rows
        are copied straight into the leading ``bucket`` rows of one reused
        host buffer of the top bucket, page-locked on a CUDA device, where
        each chunk of :data:`STAGE_CHUNK_BYTES` is uploaded ``non_blocking``
        once it is written: the card copies one chunk while the host writes
        the next. An event recorded after the last chunk's copy is waited on
        before the buffer is written again. On the CPU the buffer's rows are
        the batch."""
        rows = [*images, *[images[0]] * (bucket - len(images))]
        cuda = self.device.type == "cuda"
        if self._staging is None:
            size = self.cfg.image_size
            self._staging = torch.empty((self.batch_ladder[-1], size, size, 3),
                                        dtype=torch.float32, pin_memory=cuda)
        elif self._staged is not None:
            self._staged.synchronize()
        staging = self._staging[:bucket]
        batch = torch.empty_like(staging, device=self.device) if cuda else staging
        step = max(1, STAGE_CHUNK_BYTES // staging[0].nbytes)
        for lo in range(0, bucket, step):
            chunk = slice(lo, lo + step)
            torch.stack([torch.from_numpy(r) for r in rows[chunk]], out=staging[chunk])
            if cuda:
                batch[chunk].copy_(staging[chunk], non_blocking=True)
        tracing.count("impls.clip_upload_bytes", staging.nbytes)
        if cuda:
            self._staged = torch.cuda.Event()
            self._staged.record()
            tracing.count("impls.clip_staged_upload_bytes", staging.nbytes)
        return batch

    def _embed_images(self, images: torch.Tensor) -> np.ndarray:
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
        """(bucket, text_ctx) int32 token ids of at most the top bucket of
        ``texts``, padded to the batch bucket, exactly as :meth:`predict`
        embeds a slice of them."""
        seqs = [self.tokenize(t)[: self.context_length] for t in texts]
        ids, _, _ = batching.pad_token_batch(seqs, [self.cfg.text_ctx], self.batch_ladder)
        return ids

    def predict(self, inputs: Sequence[PredictionInput]) -> list[Any]:
        self.load()
        outputs: list[Any] = [None] * len(inputs)
        images, image_pos = [], []
        texts, text_pos = [], []
        want = (self.cfg.image_size, self.cfg.image_size, 3)
        cap = self.batch_ladder[-1]
        with tracing.span("impls.clip_predict.stack"):
            for i, inp in enumerate(inputs):
                if inp.file is not None:
                    try:
                        images.append(decode_image(inp.file, self.cfg.image_size))
                        image_pos.append(i)
                    except SlotError as err:
                        outputs[i] = err.to_slot()
                elif isinstance(inp.data, dict) and "pixels" in inp.data:
                    # Contiguous: torch.from_numpy takes no negative strides.
                    arr = np.ascontiguousarray(inp.data["pixels"], dtype=np.float32)
                    if arr.shape != want:
                        outputs[i] = SlotError(
                            "input", f"pixels shape {arr.shape} != {want}").to_slot()
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
        for lo in range(0, len(images), cap):
            with tracing.span("impls.clip_predict.stack"):
                part = images[lo : lo + cap]
                batch = self._stage_images(part, batching.bucket_for(len(part), self.batch_ladder))
            feats = self._embed_images(batch)
            with tracing.span("impls.clip_predict.serialize"):
                for j, pos in enumerate(image_pos[lo : lo + cap]):
                    outputs[pos] = npy.serialize_npy(feats[j])
        for lo in range(0, len(texts), cap):
            feats = self._embed_texts(self.token_ids(texts[lo : lo + cap]))
            with tracing.span("impls.clip_predict.serialize"):
                for j, pos in enumerate(text_pos[lo : lo + cap]):
                    outputs[pos] = npy.serialize_npy(feats[j])
        return outputs


class TextEmbedImpl(InferenceModel):
    """Sentence-transformers-equivalent text embedder with the chunking and
    combined-embedding contract (reference impl/sentence_transformers.py),
    on one explicit device. One input text → a 2D npy array of chunk
    embeddings (unnormalised f32), plus the mean row once a text has
    ``combine_threshold`` chunks."""

    def __init__(
        self,
        model_arch: str = "minilm-l6",
        checkpoint: Optional[str] = None,
        tokenizer_path: Optional[str] = None,
        max_seq_length: Optional[int] = None,
        combine_threshold: int = -1,
        batch_cap: int = 64,
        query_prompt_name_map: Optional[dict] = None,
        device: str | torch.device = "cuda",
        **_: Any,
    ):
        self.cfg = text_embed.CONFIGS.get(model_arch) or text_embed.CONFIGS["minilm-l6"]
        self.checkpoint = checkpoint
        self.device = select_device(str(device))
        self.max_seq_length = min(max_seq_length or self.cfg.ctx, self.cfg.ctx)
        self.combine_threshold = combine_threshold
        self.batch_ladder = batching.bucket_ladder(batch_cap)
        self.length_ladder = [
            n for n in (32, 64, 128, 256, 512) if n <= self.max_seq_length
        ] or [self.max_seq_length]
        self.tokenize = load_tokenizer(tokenizer_path, self.cfg.vocab)
        self.query_prompt_name_map = query_prompt_name_map or {}
        self.params = None

    @classmethod
    def name(cls) -> str:
        return "sentence_transformers"

    def load(self) -> None:
        if self.params is not None:
            return
        if self.checkpoint:
            tree = weights.load_text_encoder_checkpoint(self.checkpoint, self.cfg)
            params = convert.params_from_jax(tree, device=self.device)
        else:
            gen = torch.Generator(device=self.device).manual_seed(TEXT_INIT_SEED)
            params = text_embed.init_params(self.cfg, gen)
        self.params = text_embed.bf16_linears(params)

    def unload(self) -> None:
        self.params = None

    def prepare(self) -> None:
        """Prewarm: run every (length × batch) bucket once (kernel builds,
        library handles, the allocator's pools), as the JAX class compiles
        them."""
        self.load()
        for length in self.length_ladder:
            for bucket in self.batch_ladder:
                ids = torch.zeros((bucket, length), dtype=torch.int32, device=self.device)
                mask = torch.ones((bucket, length), dtype=torch.int32, device=self.device)
                text_embed.encode(self.params, self.cfg, ids, mask)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def encode_chunks(self, chunks: Sequence[Sequence[int]]) -> np.ndarray:
        """Token chunks → (len(chunks), embed_dim) f32, in order. Slices of
        at most the top batch bucket, shortest chunks first, each padded to
        its own (length × batch) bucket; one copy back at the end."""
        order = sorted(range(len(chunks)), key=lambda i: len(chunks[i]))
        cap = self.batch_ladder[-1]
        parts = []
        for lo in range(0, len(order), cap):
            part = [chunks[i] for i in order[lo : lo + cap]]
            ids, mask, _ = batching.pad_token_batch(part, self.length_ladder, self.batch_ladder)
            feats = text_embed.encode(
                self.params, self.cfg, torch.from_numpy(ids).to(self.device),
                torch.from_numpy(mask).to(self.device),
            )
            parts.append(feats[: len(part)])
        out = np.empty((len(chunks), self.cfg.embed_dim), dtype=np.float32)
        if parts:
            out[order] = torch.cat(parts).cpu().numpy()
        return out

    def predict(self, inputs: Sequence[PredictionInput]) -> list[Any]:
        self.load()
        texts = []
        combine_at = []
        for inp in inputs:
            data = inp.data if isinstance(inp.data, dict) else {}
            text = str(data.get("text", ""))
            # Task routing (reference sentence_transformers.py
            # query_prompt_name_map): a query-side embed carries a task name
            # (preprocess sends "s2s"); the mapped prompt prefixes the text.
            task = data.get("task")
            if task and task in self.query_prompt_name_map:
                text = f"{self.query_prompt_name_map[task]}{text}"
            texts.append(text)
            combine_at.append(int(data.get("combine_threshold", self.combine_threshold)))

        # Chunk every text (rebalanced tail), track ownership.
        all_chunks: list[list[int]] = []
        chunk_map: list[int] = []
        for idx, text in enumerate(texts):
            tokens = self.tokenize(text) or [0]
            for chunk in text_embed.split_tokens(tokens, self.max_seq_length):
                all_chunks.append(chunk or [0])
                chunk_map.append(idx)
        feats = self.encode_chunks(all_chunks)

        grouped: list[list[np.ndarray]] = [[] for _ in texts]
        for emb, owner in zip(feats, chunk_map):
            grouped[owner].append(emb)
        outputs = []
        for idx, emb_list in enumerate(grouped):
            arr = text_embed.combine_chunks(np.stack(emb_list), combine_at[idx])
            outputs.append(npy.serialize_npy(arr))
        return outputs


class TaggerImpl(InferenceModel):
    """WD-tagger-equivalent multi-label tagger (reference impl/wd_tagger.py)
    on one explicit device: a CLIP visual trunk's raw pooled features, a
    sigmoid head, and the rating/character/general tag maps with mcut and
    fixed thresholds. :meth:`tag_arrays` is the array entry (normalised
    pixels in, tag maps out); :meth:`predict` decodes image files and calls
    it. The trunk embeds in slices of at most the top batch bucket, each
    padded to its own bucket (the JAX class pads a call as one batch and
    raises past the top bucket: ROADMAP §C); with ``precision="int8"`` the
    trunk is the static-int8 block and the first slice calibrates. The head
    is applied on the device in f32 (the JAX class applies it on the host
    in f32)."""

    def __init__(
        self,
        model_arch: str = "test-tiny",
        checkpoint: Optional[str] = None,
        namespace: str = "danbooru",
        tag_vocab: Optional[list[str]] = None,
        rating_tags: Optional[list[str]] = None,
        character_tags: Optional[list[str]] = None,
        character_threshold: float = 0.75,
        batch_cap: int = 32,
        precision: str = "bf16",
        device: str | torch.device = "cuda",
        **_: Any,
    ):
        self.precision = precision
        self.cfg = clip.CONFIGS.get(model_arch) or clip.CONFIGS["test-tiny"]
        if precision == "int8":
            self.cfg = dataclasses.replace(self.cfg, matmul_precision="int8")
        self._act_scales = None
        self.checkpoint = checkpoint
        self.device = select_device(str(device))
        self.namespace = namespace
        self.rating_tags = rating_tags or ["general", "safe", "sensitive", "questionable", "explicit"]
        self.tag_vocab = tag_vocab or [f"tag_{i}" for i in range(64)]
        # The WD head layout is [ratings | general | characters]; character
        # tags take a fixed threshold rather than mcut (impl/wd_tagger.py).
        self.character_tags = character_tags or []
        self.character_threshold = character_threshold
        self.batch_ladder = batching.bucket_ladder(batch_cap)
        self.params = None
        self.head = None
        self.head_bias = None

    @classmethod
    def name(cls) -> str:
        return "wd_tagger"

    def load(self) -> None:
        if self.params is not None:
            return
        if self.checkpoint:
            # timm ViT mapping (the reference's WD taggers are timm models):
            # identity projection, the head on the raw pooled features; the
            # head's width overrides the vocabulary.
            self.cfg = dataclasses.replace(self.cfg, embed_dim=self.cfg.vision_width)
            visual, head_w, head_b = weights.load_timm_vit_checkpoint(self.checkpoint, self.cfg)
            self.params = convert.params_from_jax({"visual": visual}, device=self.device)
            self.head = torch.from_numpy(head_w).to(self.device)
            self.head_bias = torch.from_numpy(head_b).to(self.device)
            n_out = head_w.shape[1]
            declared = len(self.rating_tags) + len(self.tag_vocab) + len(self.character_tags)
            if declared != n_out:
                self.character_tags = []
                self.tag_vocab = [f"tag_{i}" for i in range(n_out - len(self.rating_tags))]
        else:
            gen = torch.Generator(device=self.device).manual_seed(TAGGER_INIT_SEED)
            self.params = clip.init_params(self.cfg, gen)
            n_out = len(self.rating_tags) + len(self.tag_vocab) + len(self.character_tags)
            dim = self.cfg.embed_dim
            self.head = torch.randn((dim, n_out), generator=gen, device=self.device) * dim**-0.5
            self.head_bias = torch.zeros(n_out, device=self.device)
        if self.precision == "int8":
            self.params = clip.quantize_block_weights(self.params)

    def unload(self) -> None:
        self.params = None
        self.head = None
        self._act_scales = None

    def prepare(self) -> None:
        """Run every bucket once (kernel builds, library handles). With int8
        the warm-up calibrates on its all-zeros batch and throws the scales
        away, as ``ClipImpl.prepare`` does: the first real slice
        calibrates."""
        self.load()
        size = self.cfg.image_size
        for bucket in self.batch_ladder:
            images = torch.zeros((bucket, size, size, 3), device=self.device)
            if self.precision == "int8":
                warm = self._act_scales
                if warm is None:
                    warm = clip.calibrate_image_scales(self.params, self.cfg, images)
                clip.embed_images_raw_scaled(self.params, self.cfg, images, warm)
            else:
                clip.embed_images_raw(self.params, self.cfg, images)

    @staticmethod
    def mcut_threshold(probs: np.ndarray) -> float:
        """Maximum-category-cut: threshold at the largest gap in the sorted
        score curve (impl/utils.py mcut)."""
        sorted_probs = np.sort(probs)[::-1]
        if len(sorted_probs) < 2:
            return 0.0
        gaps = sorted_probs[:-1] - sorted_probs[1:]
        t = int(np.argmax(gaps))
        return float((sorted_probs[t] + sorted_probs[t + 1]) / 2)

    def raw_features(self, images: np.ndarray) -> torch.Tensor:
        """(N, S, S, 3) normalised pixels → the trunk's raw pooled features
        (N, embed_dim) f32 on the device, in slices of at most the top
        bucket, each padded to its own bucket; under int8 the first slice
        calibrates."""
        self.load()
        cap = self.batch_ladder[-1]
        parts = []
        for lo in range(0, len(images), cap):
            part = images[lo : lo + cap]
            bucket = batching.bucket_for(len(part), self.batch_ladder)
            padded = torch.from_numpy(batching.pad_batch(part, bucket)[0]).to(self.device)
            if self.precision == "int8":
                if self._act_scales is None:
                    self._act_scales = clip.calibrate_image_scales(self.params, self.cfg, padded)
                feats = clip.embed_images_raw_scaled(self.params, self.cfg, padded, self._act_scales)
            else:
                feats = clip.embed_images_raw(self.params, self.cfg, padded)
            parts.append(feats[: len(part)])
        return torch.cat(parts)

    def probabilities(self, images: np.ndarray) -> np.ndarray:
        """(N, S, S, 3) normalised pixels → the head's sigmoid (N, n_out)."""
        logits = self.raw_features(images) @ self.head + self.head_bias
        return torch.sigmoid(logits).cpu().numpy()

    def tag_arrays(self, images: np.ndarray, configs: Sequence[Optional[dict]]) -> list[dict]:
        """(N, S, S, 3) normalised pixels and each one's config (``threshold``,
        ``character_threshold``) → the tagger's output for each."""
        probs = self.probabilities(images)
        n_rating = len(self.rating_tags)
        n_general = len(self.tag_vocab)
        outputs = []
        for j, config in enumerate(configs):
            config = config if isinstance(config, dict) else {}
            rating_probs = probs[j, :n_rating]
            general_probs = probs[j, n_rating : n_rating + n_general]
            char_probs = probs[j, n_rating + n_general :]
            thresh = config.get("threshold")
            mcut = self.mcut_threshold(general_probs)
            eff = mcut if not thresh else float(thresh)
            general = {
                self.tag_vocab[t]: float(general_probs[t])
                for t in np.flatnonzero(general_probs >= eff)
            }
            char_eff = float(config.get("character_threshold", self.character_threshold))
            character = {
                self.character_tags[t]: float(char_probs[t])
                for t in np.flatnonzero(char_probs >= char_eff)
            }
            rating = {self.rating_tags[int(np.argmax(rating_probs))]: float(rating_probs.max())}
            outputs.append({
                "namespace": self.namespace,
                "tags": [("rating", rating), ("character", character), ("general", general)],
                "mcut": mcut,
                "rating_severity": self.rating_tags,
                "metadata": {},
                "metadata_score": 0.0,
            })
        return outputs

    def predict(self, inputs: Sequence[PredictionInput]) -> list[Any]:
        self.load()
        outputs: list[Any] = [None] * len(inputs)
        images, kept = [], []
        for i, inp in enumerate(inputs):
            if inp.file is None:
                outputs[i] = SlotError("input", "Tagger requires an image file").to_slot()
                continue
            try:
                images.append(decode_image(inp.file, self.cfg.image_size))
                kept.append(i)
            except SlotError as err:
                outputs[i] = err.to_slot()
        if images:
            configs = [inputs[pos].data for pos in kept]
            for pos, out in zip(kept, self.tag_arrays(np.stack(images), configs)):
                outputs[pos] = out
        return outputs


def decode_wav(payload: bytes) -> np.ndarray:
    """WAV bytes → mono f32 PCM at 16 kHz (linear resample). Non-WAV audio
    needs ffmpeg, which is probed and ledgered as a blocker when missing —
    the failed-media 'blocked' pattern."""
    import io as _io
    import wave

    try:
        with wave.open(_io.BytesIO(payload)) as w:
            rate = w.getframerate()
            channels = w.getnchannels()
            width = w.getsampwidth()
            frames = w.readframes(w.getnframes())
    except Exception as exc:
        raise SlotError("input", f"Undecodable WAV payload: {exc}") from exc
    if width == 2:
        pcm = np.frombuffer(frames, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 1:
        pcm = (np.frombuffer(frames, dtype=np.uint8).astype(np.float32) - 128) / 128.0
    elif width == 4:
        pcm = np.frombuffer(frames, dtype="<i4").astype(np.float32) / 2**31
    else:
        raise SlotError("input", f"Unsupported WAV sample width {width}")
    if channels > 1:
        pcm = pcm.reshape(-1, channels).mean(axis=1)
    if rate != 16000:
        n_out = int(len(pcm) * 16000 / rate)
        pcm = np.interp(
            np.linspace(0, len(pcm) - 1, n_out), np.arange(len(pcm)), pcm
        ).astype(np.float32)
    return pcm


class WhisperImpl(InferenceModel):
    """Whisper speech-to-text (reference impl/whisper.py) on one explicit
    device: WAV audio files → ``{"text", "language", "language_confidence",
    "confidence"}``, the confidence being exp(avg logprob). Without a
    tokenizer the text is the generated tokens as ``<id>``."""

    def __init__(
        self,
        model_arch: str = "test-tiny",
        checkpoint: Optional[str] = None,
        tokenizer_path: Optional[str] = None,
        max_tokens: int = 64,
        device: str | torch.device = "cuda",
        **_: Any,
    ):
        self.cfg = whisper.CONFIGS.get(model_arch) or whisper.CONFIGS["test-tiny"]
        self.checkpoint = checkpoint
        self.tokenizer_path = tokenizer_path
        self.max_tokens = max_tokens
        self.device = select_device(str(device))
        self.params = None
        self.detokenize = None

    @classmethod
    def name(cls) -> str:
        return "whisper"

    def load(self) -> None:
        if self.params is not None:
            return
        if self.checkpoint:
            tree = weights.load_whisper_checkpoint(self.checkpoint, self.cfg)
            params = convert.params_from_jax(tree, device=self.device)
        else:
            gen = torch.Generator(device=self.device).manual_seed(WHISPER_INIT_SEED)
            params = whisper.init_params(self.cfg, gen)
        self.params = whisper.bf16_linears(params)
        if self.tokenizer_path and self.detokenize is None:
            try:
                from tokenizers import Tokenizer

                tok = Tokenizer.from_file(self.tokenizer_path)
                self.detokenize = lambda ids: tok.decode(
                    [i for i in ids if 0 <= i < tok.get_vocab_size()]
                )
            except Exception:
                pass

    def unload(self) -> None:
        self.params = None

    @torch.inference_mode()
    def transcribe(self, mel: np.ndarray):
        """mel (B, n_mels, frames) → (language index, its probability,
        tokens, lengths, avg logprob) as NumPy arrays. The reference encodes
        the batch twice, in ``detect_language`` and in ``greedy_decode``; the
        port encodes it once and hands the features to both."""
        feats = whisper.encode_audio(self.params, self.cfg, torch.from_numpy(mel).to(self.device))
        lang_idx, lang_conf = whisper.language_probe(self.params, self.cfg, feats)
        prompt = whisper.prompt_tokens(self.cfg, mel.shape[0], self.cfg.language_base + lang_idx,
                                       self.device)
        decoded = whisper.decode_from_feats(self.params, self.cfg, feats, prompt, self.max_tokens)
        return tuple(t.cpu().numpy() for t in (lang_idx, lang_conf, *decoded))

    def predict(self, inputs: Sequence[PredictionInput]) -> list[Any]:
        self.load()
        outputs: list[Any] = [None] * len(inputs)
        mels, kept = [], []
        for i, inp in enumerate(inputs):
            if inp.file is None:
                outputs[i] = SlotError("input", "Whisper requires an audio file").to_slot()
                continue
            try:
                pcm = decode_wav(inp.file)
                mels.append(whisper.log_mel_spectrogram(pcm, self.cfg.n_mels))
                kept.append(i)
            except SlotError as err:
                outputs[i] = err.to_slot()
        if mels:
            lang_idx, lang_conf, tokens, lengths, logprob = self.transcribe(np.stack(mels))
            for j, pos in enumerate(kept):
                toks = tokens[j, 4 : lengths[j]].tolist()
                text = (
                    self.detokenize(toks)
                    if self.detokenize
                    else " ".join(f"<{t}>" for t in toks)
                )
                outputs[pos] = {
                    "text": text,
                    "language": whisper.LANGUAGES[int(lang_idx[j])],
                    "language_confidence": float(lang_conf[j]),
                    "confidence": float(np.exp(logprob[j])),
                }
        return outputs


class ClapImpl(InferenceModel):
    """CLAP-class audio embeddings (reference impl/clap.py) on one explicit
    device: WAV audio files → L2-normalized f32 embeddings as npy bytes,
    through the AST-style tower of ``models.audio``. Clips are embedded in
    slices of at most the top batch bucket, each padded to its bucket (the
    JAX class pads a call's clips as one batch, which raises past the top
    bucket: ROADMAP §C)."""

    def __init__(
        self,
        model_arch: str = "test-tiny",
        checkpoint: Optional[str] = None,
        batch_cap: int = 16,
        device: str | torch.device = "cuda",
        **_: Any,
    ):
        self.cfg = audio.CONFIGS.get(model_arch) or audio.CONFIGS["test-tiny"]
        self.checkpoint = checkpoint
        self.device = select_device(str(device))
        self.batch_ladder = batching.bucket_ladder(batch_cap)
        self.params = None

    @classmethod
    def name(cls) -> str:
        return "clap"

    def load(self) -> None:
        if self.params is not None:
            return
        if self.checkpoint:
            tree = audio.load_ast_checkpoint(self.checkpoint, self.cfg)
            self.params = convert.params_from_jax(tree, device=self.device)
        else:
            gen = torch.Generator(device=self.device).manual_seed(CLAP_INIT_SEED)
            self.params = audio.init_params(self.cfg, gen)

    def unload(self) -> None:
        self.params = None

    def prepare(self) -> None:
        """Run every bucket once (kernel builds, library handles), as the JAX
        class compiles one program a bucket."""
        self.load()
        for bucket in self.batch_ladder:
            mels = torch.zeros((bucket, self.cfg.n_mels, self.cfg.time_frames), device=self.device)
            audio.embed_audio(self.params, self.cfg, mels)

    def embed(self, mels: np.ndarray) -> np.ndarray:
        """(N, n_mels, time_frames) → (N, embed_dim) f32, in slices of at most
        the top bucket, each padded to its own bucket."""
        cap = self.batch_ladder[-1]
        parts = []
        for lo in range(0, len(mels), cap):
            part = mels[lo : lo + cap]
            padded, _ = batching.pad_batch(part, batching.bucket_for(len(part), self.batch_ladder))
            feats = audio.embed_audio(self.params, self.cfg, torch.from_numpy(padded).to(self.device))
            parts.append(feats[: len(part)])
        return torch.cat(parts).cpu().numpy()

    def predict(self, inputs: Sequence[PredictionInput]) -> list[Any]:
        self.load()
        outputs: list[Any] = [None] * len(inputs)
        mels, kept = [], []
        for i, inp in enumerate(inputs):
            if inp.file is None:
                outputs[i] = SlotError("input", "CLAP requires an audio file").to_slot()
                continue
            try:
                pcm = decode_wav(inp.file)
                mels.append(audio.prepare_mels(pcm, self.cfg))
                kept.append(i)
            except SlotError as err:
                outputs[i] = err.to_slot()
        if mels:
            feats = self.embed(np.stack(mels))
            for j, pos in enumerate(kept):
                outputs[pos] = npy.serialize_npy(feats[j])
        return outputs


class CaptionerImpl(InferenceModel):
    """VLM captioner family (reference impl/florence2.py / md_captioner.py /
    qwen3_vl.py) on one explicit device: image → caption text. CLIP vision
    tokens (``clip.encode_image_tokens``) are the cross-attention memory of a
    Whisper-style text decoder, decoded greedily by
    ``whisper.decode_from_feats``. :meth:`caption_arrays` is the array entry
    (normalised pixels in, one unpadded batch); :meth:`predict` decodes
    image files and calls it. The decoder is ``vision_width`` wide with 2
    heads (a head dim of 384 at ViT-B widths). The decode step's attention
    is plain tensor ops (``whisper._step_attention``), as the reference's
    is, and never launches B3; whole token rows through
    ``whisper._decoder_logits`` take B3's CUDA-core route at that head
    dim."""

    def __init__(
        self,
        model_arch: str = "test-tiny",
        checkpoint: Optional[str] = None,
        decoder_checkpoint: Optional[str] = None,
        tokenizer_path: Optional[str] = None,
        max_tokens: int = 32,
        prompt: Optional[str] = None,
        device: str | torch.device = "cuda",
        **_: Any,
    ):
        self.vision_cfg = clip.CONFIGS.get(model_arch) or clip.CONFIGS["test-tiny"]
        self.checkpoint = checkpoint
        self.decoder_checkpoint = decoder_checkpoint
        self.max_tokens = max_tokens
        self.prompt = prompt
        self.tokenizer_path = tokenizer_path
        self.device = select_device(str(device))
        n_ctx = 1 + self.vision_cfg.grid**2
        self.decoder_cfg = whisper.WhisperConfig(
            n_mels=1,
            n_audio_ctx=n_ctx,
            n_audio_state=self.vision_cfg.vision_width,
            n_audio_layers=0,
            n_audio_heads=1,
            n_vocab=512,
            n_text_ctx=max(max_tokens, 16),
            n_text_state=self.vision_cfg.vision_width,
            n_text_layers=2,
            n_text_heads=2,
            sot=500, eot=501, no_timestamps=503, transcribe=502,
        )
        self.vision_params = None
        self.decoder_params = None
        self.detokenize = None
        self._prompt_ids: tuple = ()

    @classmethod
    def name(cls) -> str:
        return "captioner"

    def load(self) -> None:
        if self.vision_params is not None:
            return
        gen = torch.Generator(device=self.device).manual_seed(CAPTIONER_INIT_SEED)
        if self.checkpoint:
            tree = weights.load_clip_checkpoint(self.checkpoint, self.vision_cfg)
            self.vision_params = convert.params_from_jax(tree, device=self.device)
        else:
            self.vision_params = clip.init_params(self.vision_cfg, gen)
        if self.decoder_checkpoint:
            # Real decoder weights (HF whisper decoder layout; the same
            # cross-attention block mapping the whisper loader uses).
            tree = weights.load_whisper_decoder_checkpoint(self.decoder_checkpoint, self.decoder_cfg)
            decoder = convert.params_from_jax(tree, device=self.device)
        else:
            decoder = whisper.init_params(self.decoder_cfg, gen)
        self.decoder_params = whisper.bf16_linears(decoder)
        if self.tokenizer_path and self.detokenize is None:
            try:
                from tokenizers import Tokenizer

                tok = Tokenizer.from_file(self.tokenizer_path)
                self.detokenize = lambda ids: tok.decode(
                    [i for i in ids if 0 <= i < tok.get_vocab_size()]
                )
                if self.prompt:
                    # Task-prompted decode (reference florence2.py task
                    # prompts): the tokenized prompt extends the SOT triple,
                    # bounded by the decoder context and the KV cache
                    # (max_tokens − SOT triple − at least one generated slot).
                    ids = tok.encode(self.prompt).ids
                    budget = max(min(self.decoder_cfg.n_text_ctx // 2, self.max_tokens - 4), 1)
                    self._prompt_ids = tuple(
                        int(i) for i in ids[:budget] if 0 <= i < self.decoder_cfg.n_vocab
                    )
            except Exception:
                pass

    def unload(self) -> None:
        self.vision_params = None
        self.decoder_params = None
        self.detokenize = None

    def caption_arrays(self, images: np.ndarray) -> list[dict]:
        """(N, S, S, 3) normalised pixels, one unpadded batch → a caption
        each: ``{"text", "confidence", "language", "language_confidence"}``.
        Without a tokenizer the text is the generated tokens as ``<id>``."""
        self.load()
        feats = clip.encode_image_tokens(self.vision_params, self.vision_cfg,
                                         torch.from_numpy(images).to(self.device))
        tokens, lengths, logprob = (t.cpu().numpy() for t in _caption_decode(
            self.decoder_params, self.decoder_cfg, feats, self.max_tokens, self._prompt_ids))
        p_len = 3 + len(self._prompt_ids)
        outputs = []
        for j in range(len(images)):
            toks = tokens[j, p_len : lengths[j]].tolist()
            text = self.detokenize(toks) if self.detokenize else " ".join(f"<{t}>" for t in toks)
            outputs.append({
                "text": text,
                "confidence": float(np.exp(logprob[j])),
                "language": "en",
                "language_confidence": 1.0,
            })
        return outputs

    def predict(self, inputs: Sequence[PredictionInput]) -> list[Any]:
        self.load()
        outputs: list[Any] = [None] * len(inputs)
        images, kept = [], []
        for i, inp in enumerate(inputs):
            if inp.file is None:
                outputs[i] = SlotError("input", "Captioner requires an image file").to_slot()
                continue
            try:
                images.append(decode_image(inp.file, self.vision_cfg.image_size))
                kept.append(i)
            except SlotError as err:
                outputs[i] = err.to_slot()
        if images:
            for pos, out in zip(kept, self.caption_arrays(np.stack(images))):
                outputs[pos] = out
        return outputs


def _caption_decode(params, cfg, feats, max_tokens: int, extra_ids=()):
    """Greedy decode against vision features (the cross-attention memory
    fed directly, no audio encoder) through the KV-cached
    ``whisper.decode_from_feats``; the prompt is [SOT, transcribe,
    no_timestamps, *extra_ids]."""
    ids = [cfg.sot, cfg.transcribe, cfg.no_timestamps, *extra_ids]
    prompt = torch.tensor(ids, dtype=torch.int32, device=feats.device)
    return whisper.decode_from_feats(params, cfg, feats, prompt.expand(feats.shape[0], len(ids)),
                                     max_tokens)


class VlmTaggerImpl(CaptionerImpl):
    """VLM-prompted tagger (reference impl/md_tagger.py: a moondream VLM
    asked to list tags). Reuses the captioner's vision-tokens →
    cross-attention decoder; the decoded text is parsed as a comma/
    whitespace-separated tag list and emitted in the tagger output shape
    so extraction's tags output-handler ingests it unchanged. Confidence
    is the decode's avg-logprob (one value for the whole list — the
    reference's VLM taggers report a fixed confidence the same way)."""

    def __init__(self, namespace: str = "vlm", max_tags: int = 16,
                 **kwargs: Any):
        super().__init__(**kwargs)
        self.namespace = namespace
        self.max_tags = max_tags

    @classmethod
    def name(cls) -> str:
        return "vlm_tagger"

    def predict(self, inputs: Sequence[PredictionInput]) -> list[Any]:
        caps = super().predict(inputs)
        outputs: list[Any] = []
        for cap in caps:
            if not isinstance(cap, dict) or "text" not in cap:
                outputs.append(cap)  # slot error passthrough
                continue
            conf = float(cap.get("confidence", 0.0))
            seen: dict[str, float] = {}
            for raw in cap["text"].replace(",", " ").split():
                tag = raw.strip().strip(".").lower()
                if tag and tag not in seen:
                    seen[tag] = conf
                if len(seen) >= self.max_tags:
                    break
            outputs.append({
                "namespace": self.namespace,
                "tags": [("rating", {}), ("character", {}), ("general", seen)],
                "mcut": 0.0,
                "rating_severity": [],
                "metadata": {},
                "metadata_score": conf,
            })
        return outputs

    def tag_arrays(self, images: np.ndarray) -> list[dict]:
        """(N, S, S, 3) normalised pixels → the tag map of each one's
        caption, parsed as :meth:`predict` parses it (a test holds the two
        equal)."""
        outputs = []
        for cap in self.caption_arrays(images):
            conf = float(cap["confidence"])
            seen: dict[str, float] = {}
            for raw in cap["text"].replace(",", " ").split():
                tag = raw.strip().strip(".").lower()
                if tag and tag not in seen:
                    seen[tag] = conf
                if len(seen) >= self.max_tags:
                    break
            outputs.append({
                "namespace": self.namespace,
                "tags": [("rating", {}), ("character", {}), ("general", seen)],
                "mcut": 0.0,
                "rating_severity": [],
                "metadata": {},
                "metadata_score": conf,
            })
        return outputs


class KimiVlImpl(InferenceModel):
    """Kimi-VL-A3B-Instruct as a captioner (``models.kimi_vl``): image →
    caption on :class:`CaptionerImpl`'s contract, ``{"text", "confidence",
    "language", "language_confidence"}`` a slot, the text the generated
    tokens as ``<id>`` while no tokenizer is given. Inputs are image files
    (``decode_image``, then MoonViT's normalisation) or pre-decoded
    ``{"pixels": (S, S, 3)}`` arrays (already normalised, as ``ClipImpl``
    takes them); anything else is an ``input`` slot error. A call captions
    its images in slices of at most ``batch_cap``: the tower, the prompt
    (``prefix_ids``, the image's tokens, ``suffix_ids``) and greedy decoding
    through the latent cache to ``max_new_tokens``. Each batch shape's
    latent caches and captured decode step are kept until :meth:`unload`.

    Weights are drawn from ``seed`` at :meth:`load`, unless ``params`` was
    set before it; real weights need a ``.safetensors`` reader the port does
    not have, so ``checkpoint`` raises ``ModelLoadError``."""

    def __init__(
        self,
        model_arch: str = "Kimi-VL-A3B-Instruct",
        checkpoint: Optional[str] = None,
        max_new_tokens: int = 64,
        image_size: Optional[int] = None,
        prefix_ids: Sequence[int] = (),
        suffix_ids: Sequence[int] = (),
        batch_cap: int = 64,
        seed: int = KIMI_VL_INIT_SEED,
        device: str | torch.device = "cuda",
        **_: Any,
    ):
        if model_arch not in kimi_vl.CONFIGS:
            raise ValueError(f"unknown Kimi-VL arch {model_arch!r}; have {sorted(kimi_vl.CONFIGS)}")
        self.cfg = kimi_vl.CONFIGS[model_arch]
        if image_size and image_size != self.cfg.image_size:
            self.cfg = dataclasses.replace(self.cfg, image_size=int(image_size))
        self.checkpoint = checkpoint
        self.max_new_tokens = int(max_new_tokens)
        self.prefix_ids = tuple(int(i) for i in prefix_ids)
        self.suffix_ids = tuple(int(i) for i in suffix_ids)
        self.batch_cap = int(batch_cap)
        self.seed = int(seed)
        self.device = select_device(str(device))
        self.params = None
        self._decoders: dict = {}

    @classmethod
    def name(cls) -> str:
        return "kimi_vl"

    def load(self) -> None:
        if self.params is not None:
            return
        if self.checkpoint:
            from panoptikon_tpu_torch.models.manager import ModelLoadError

            raise ModelLoadError(
                f"kimi_vl: no reader for the checkpoint {self.checkpoint!r}: Kimi-VL's weights "
                "ship as .safetensors, and models.weights has no .safetensors reader")
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self.params = kimi_vl.init_params(self.cfg, gen)

    def unload(self) -> None:
        self.params = None
        self._decoders = {}

    def prepare(self) -> None:
        """One image through every stage (library handles, the allocator)."""
        self.load()
        size = self.cfg.image_size
        self._caption(np.zeros((1, size, size, 3), np.float32), max_new=2)

    def _caption(self, images: np.ndarray, keep: Sequence[int] = (),
                 max_new: Optional[int] = None):
        """(captions, kept): a caption for each of (N, S, S, 3) normalised
        pixels, one unpadded batch, and for the batch positions ``keep`` what
        ``kimi_vl.generate`` keeps of them: ``logits`` (positions, V) at each
        generated position that was computed, ``image_tokens``, ``tokens``
        and ``routes`` (each expert layer's picks at each token)."""
        self.load()
        pixels = torch.from_numpy(np.ascontiguousarray(images, dtype=np.float32)).to(self.device)
        out = kimi_vl.generate(self.params, self.cfg, pixels, self.prefix_ids, self.suffix_ids,
                               max_new or self.max_new_tokens, keep, self._decoders)
        tokens, lengths, logprob = out["tokens"], out["lengths"], out["logprob"]
        captions = []
        for j in range(len(images)):
            toks = tokens[j, : int(lengths[j])].tolist()
            captions.append({
                "text": " ".join(f"<{t}>" for t in toks),
                "confidence": float(np.exp(float(logprob[j]))),
                "language": "en",
                "language_confidence": 1.0,
            })
        kept = {int(pos): {"logits": out["logits"][i, : out["positions"]],
                           "image_tokens": out["image_tokens"][i],
                           "tokens": tokens[int(pos)], "routes": out["routes"][i]}
                for i, pos in enumerate(keep)}
        return captions, kept

    def caption_arrays(self, images: np.ndarray) -> list[dict]:
        """(N, S, S, 3) normalised pixels, one unpadded batch → a caption
        each: ``{"text", "confidence", "language", "language_confidence"}``."""
        return self._caption(images)[0]

    def _pixels(self, inp: PredictionInput) -> np.ndarray:
        size = self.cfg.image_size
        if inp.file is not None:
            # decode_image normalises as CLIP does; MoonViT takes mean and
            # std 0.5 on each channel.
            arr = decode_image(inp.file, size) * CLIP_STD + CLIP_MEAN
            return (arr - 0.5) / 0.5
        if isinstance(inp.data, dict) and "pixels" in inp.data:
            arr = np.asarray(inp.data["pixels"], dtype=np.float32)
            if arr.shape != (size, size, 3):
                raise SlotError("input", f"pixels shape {arr.shape} != {(size, size, 3)}")
            return arr
        raise SlotError("input", "Kimi-VL requires an image file or {'pixels': ...}")

    def predict_keeping(self, inputs: Sequence[PredictionInput], keep: Sequence[int] = ()):
        """:meth:`predict`, and for the input positions ``keep`` what
        :meth:`_caption` keeps (logits, image tokens, tokens, expert picks)."""
        self.load()
        outputs: list[Any] = [None] * len(inputs)
        images, kept_pos, keep = [], [], set(keep)
        for i, inp in enumerate(inputs):
            try:
                images.append(self._pixels(inp))
                kept_pos.append(i)
            except SlotError as err:
                outputs[i] = err.to_slot()
        kept: dict = {}
        for lo in range(0, len(images), self.batch_cap):
            part = kept_pos[lo : lo + self.batch_cap]
            want = [j for j, pos in enumerate(part) if pos in keep]
            caps, extra = self._caption(np.stack(images[lo : lo + self.batch_cap]), want)
            for pos, cap in zip(part, caps):
                outputs[pos] = cap
            kept.update({part[j]: v for j, v in extra.items()})
        return outputs, kept

    def predict(self, inputs: Sequence[PredictionInput]) -> list[Any]:
        return self.predict_keeping(inputs)[0]


class Md5LookupImpl(InferenceModel):
    """md5-lookup tagger (reference impl/danbooru.py + saucenao/): tags by
    hash against a local dump (JSON/sqlite: md5 → [[namespace, name,
    confidence], ...]). Remote lookups are out of scope in a zero-egress
    build; a missing dump yields transient blocked errors, never verdicts."""

    def __init__(self, dump_path: Optional[str] = None, namespace: str = "danbooru", **_: Any):
        self.dump_path = dump_path
        self.namespace = namespace
        self.table: Optional[dict] = None
        self._conn = None  # sqlite backend (the at-scale default)

    @classmethod
    def name(cls) -> str:
        return "md5_lookup"

    def load(self) -> None:
        if self.table is not None or self._conn is not None or self.dump_path is None:
            return
        from pathlib import Path as _Path

        path = _Path(self.dump_path)
        if not path.exists():
            return
        if path.suffix in (".db", ".sqlite", ".sqlite3"):
            # sqlite dump (a danbooru-scale table is GBs as a resident
            # dict): `tags(md5 TEXT, namespace TEXT, name TEXT,
            # confidence REAL)` with an md5 index, queried per batch.
            import sqlite3 as _sqlite3

            self._conn = _sqlite3.connect(
                f"file:{path}?mode=ro", uri=True, check_same_thread=False
            )
        else:
            import json as _json

            self.table = _json.loads(path.read_text())

    def _lookup(self, md5: str):
        if self.table is not None:
            return self.table.get(md5)
        rows = self._conn.execute(
            "SELECT namespace, name, confidence FROM tags WHERE md5 = ?",
            (md5,),
        ).fetchall()
        return rows or None

    def unload(self) -> None:
        self.table = None
        if self._conn is not None:
            self._conn.close()
            self._conn = None

    def predict(self, inputs: Sequence[PredictionInput]) -> list[Any]:
        self.load()
        out = []
        for inp in inputs:
            md5 = (inp.data or {}).get("md5") if isinstance(inp.data, dict) else None
            if md5 is None:
                out.append(SlotError("input", "md5 lookup requires data.md5").to_slot())
                continue
            if self.table is None and self._conn is None:
                out.append(
                    {
                        "__error__": {
                            "class": "transient",
                            "message": "blocked: no tag dump configured (blocker=tag-dump)",
                        }
                    }
                )
                continue
            entry = self._lookup(md5)
            tags: dict[str, float] = {}
            if entry:
                for ns, tag_name, conf in entry:
                    tags[tag_name] = float(conf)
            out.append(
                {
                    "namespace": self.namespace,
                    "tags": [("general", tags)],
                    "mcut": 0.0,
                    "rating_severity": [],
                    "metadata": {},
                    "metadata_score": 0.0,
                }
            )
        return out


class ApiEmbedImpl(InferenceModel):
    """Remote-API embedding backends (reference impl/jina_clip.py — Jina's
    hosted CLIP API — and the nemotron/qwen embed family): text and image
    inputs are POSTed to an OpenAI/Jina-style ``/embeddings`` endpoint and
    the returned vectors are re-emitted as L2-normalized npy bytes.

    Offline/gated semantics follow the failed-media design: no endpoint
    configured → every slot gets a typed ``transient`` error naming the
    blocker; a transport failure is likewise transient (retry later), and
    a per-item API rejection is an ``input`` verdict."""

    def __init__(
        self,
        endpoint: Optional[str] = None,
        model: str = "jina-clip-v1",
        api_key_env: str = "EMBED_API_KEY",
        timeout: float = 60.0,
        normalize: bool = True,
        **_: Any,
    ):
        self.endpoint = endpoint
        self.model = model
        self.api_key_env = api_key_env
        self.timeout = timeout
        self.normalize = normalize

    @classmethod
    def name(cls) -> str:
        return "api_embed"

    @classmethod
    def available(cls, config: dict) -> bool:
        """Availability overlay (the reference's capability probe,
        inferio/capability.rs): API backends are usable only with an
        endpoint configured."""
        return bool(config.get("endpoint"))

    def load(self) -> None:
        pass

    def unload(self) -> None:
        pass

    def predict(self, inputs: Sequence[PredictionInput]) -> list[Any]:
        import base64
        import json as _json
        import os
        import urllib.request

        if not self.endpoint:
            err = SlotError(
                "transient",
                "blocked: no embeddings endpoint configured (blocker=embed-api)",
            ).to_slot()
            return [err for _ in inputs]
        payload_inputs = []
        for inp in inputs:
            if inp.file is not None:
                payload_inputs.append(
                    {"image": base64.b64encode(inp.file).decode()}
                )
            elif isinstance(inp.data, dict) and "text" in inp.data:
                payload_inputs.append({"text": str(inp.data["text"])})
            else:
                payload_inputs.append({"text": ""})
        body = _json.dumps(
            {"model": self.model, "input": payload_inputs}
        ).encode()
        headers = {"content-type": "application/json"}
        key = os.environ.get(self.api_key_env)
        if key:
            headers["authorization"] = f"Bearer {key}"
        req = urllib.request.Request(
            self.endpoint, data=body, headers=headers, method="POST"
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                out = _json.loads(resp.read())
        except Exception as exc:
            err = SlotError("transient", f"embeddings API failed: {exc}").to_slot()
            return [err for _ in inputs]
        outputs: list[Any] = []
        data = out.get("data", [])
        # OpenAI/Jina-style responses may reorder or omit entries; the
        # per-entry "index" field is authoritative for slot alignment.
        by_index = {}
        for pos, entry in enumerate(data):
            if isinstance(entry, dict):
                by_index[int(entry.get("index", pos))] = entry
        for i in range(len(inputs)):
            entry = by_index.get(i)
            if not entry or "embedding" not in entry:
                outputs.append(
                    SlotError("input", "no embedding returned for slot").to_slot()
                )
                continue
            vec = np.asarray(entry["embedding"], np.float32)
            if self.normalize:
                vec = vec / max(float(np.linalg.norm(vec)), 1e-8)
            outputs.append(npy.serialize_npy(vec))
        return outputs


class TagApiImpl(InferenceModel):
    """Remote tag-lookup backend (reference impl/saucenao/ + the hosted
    half of impl/danbooru.py): each image's md5 (or the provided hash) is
    POSTed to a configured JSON API and the response's tag map is emitted
    in the tagger output shape. Same offline/gated semantics as
    ApiEmbedImpl: no endpoint → typed transient blocker; transport
    failure → transient; an explicit per-item miss → empty tags (a valid
    verdict, not an error — the reference records "no match" results)."""

    def __init__(
        self,
        endpoint: Optional[str] = None,
        namespace: str = "danbooru",
        api_key_env: str = "TAG_API_KEY",
        timeout: float = 30.0,
        default_confidence: float = 1.0,
        **_: Any,
    ):
        self.endpoint = endpoint
        self.namespace = namespace
        self.api_key_env = api_key_env
        self.timeout = timeout
        self.default_confidence = default_confidence

    @classmethod
    def name(cls) -> str:
        return "tag_api"

    @classmethod
    def available(cls, config: dict) -> bool:
        return bool(config.get("endpoint"))

    def load(self) -> None:
        pass

    def unload(self) -> None:
        pass

    def predict(self, inputs: Sequence[PredictionInput]) -> list[Any]:
        import json as _json
        import os
        import urllib.request

        if not self.endpoint:
            err = SlotError(
                "transient",
                "blocked: no tag API endpoint configured (blocker=tag-api)",
            ).to_slot()
            return [err for _ in inputs]
        hashes = []
        for inp in inputs:
            if isinstance(inp.data, dict) and inp.data.get("md5"):
                hashes.append(str(inp.data["md5"]))
            elif inp.file is not None:
                hashes.append(hashlib.md5(inp.file).hexdigest())
            else:
                hashes.append(None)
        body = _json.dumps({"md5": [h for h in hashes if h]}).encode()
        headers = {"content-type": "application/json"}
        key = os.environ.get(self.api_key_env)
        if key:
            headers["authorization"] = f"Bearer {key}"
        req = urllib.request.Request(
            self.endpoint, data=body, headers=headers, method="POST"
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                out = _json.loads(resp.read())
        except Exception as exc:
            err = SlotError("transient", f"tag API failed: {exc}").to_slot()
            return [err for _ in inputs]
        # Response: {"results": {"<md5>": {"tags": {name: conf | null}}}}.
        results = out.get("results", {})
        outputs: list[Any] = []
        for h in hashes:
            if h is None:
                outputs.append(
                    SlotError("input", "tag lookup requires a file or md5").to_slot()
                )
                continue
            entry = results.get(h) or {}
            tags = {
                str(name): (float(conf) if conf is not None
                            else self.default_confidence)
                for name, conf in (entry.get("tags") or {}).items()
            }
            outputs.append({
                "namespace": self.namespace,
                "tags": [("rating", {}), ("character", {}), ("general", tags)],
                "mcut": 0.0,
                "rating_severity": [],
                "metadata": {"source": "tag_api", "matched": bool(tags)},
                "metadata_score": 0.0,
            })
        return outputs


class OcrImpl(InferenceModel):
    """OCR (reference impl/ocr.py docTR / eocr.py EasyOCR) on one explicit
    device: image → ``{"text", "confidence", "language"}``.

    Projection-profile line segmentation on the host (``models/ocr.py``),
    then one of two recognizers over fixed-height line strips:
    ``recognizer="ctc"`` (greedy CTC over the strip encoder) or ``"attn"``
    (whisper's KV-cached decode over the same encoder's features).
    :meth:`read_arrays` is the array entry (grayscale pages in, one output
    each); :meth:`predict` decodes image files (PIL, ``convert("L")``, in
    :meth:`decode_gray`) and calls it. The strips of a call go to the card
    in slices of at most the top batch bucket, each padded to its own
    bucket: the JAX class pads every strip of a call as one batch and raises
    ``ValueError`` past the top bucket, so a page of more than 16 lines
    fails there (ROADMAP §C). A checkpoint is the reference's pickle of a
    NumPy parameter tree; without one the weights are random, drawn from a
    fixed seed on the impl's device."""

    def __init__(
        self,
        model_arch: str = "crnn-base",
        checkpoint: Optional[str] = None,
        batch_cap: int = 16,
        min_confidence: float = 0.0,
        recognizer: str = "ctc",
        device: str | torch.device = "cuda",
        **_: Any,
    ):
        self.recognizer = recognizer
        if recognizer == "attn":
            self.attn_cfg = ocr.ATTN_CONFIGS.get(model_arch) or ocr.ATTN_CONFIGS["attn-base"]
            self.cfg = self.attn_cfg.enc
        else:
            self.attn_cfg = None
            self.cfg = ocr.CONFIGS.get(model_arch) or ocr.CONFIGS["crnn-base"]
        self.checkpoint = checkpoint
        self.device = select_device(str(device))
        self.batch_ladder = batching.bucket_ladder(batch_cap)
        self.min_confidence = min_confidence
        self.params = None

    @classmethod
    def name(cls) -> str:
        return "ocr"

    def load(self) -> None:
        if self.params is not None:
            return
        if self.checkpoint:
            import pickle

            with open(self.checkpoint, "rb") as f:
                tree = convert.params_from_jax(pickle.load(f), device=self.device)
        else:
            gen = torch.Generator(device=self.device).manual_seed(OCR_INIT_SEED)
            if self.recognizer == "attn":
                tree = ocr.init_attn_params(self.attn_cfg, gen)
            else:
                tree = ocr.init_params(self.cfg, gen)
        self.params = ocr.bf16_linears(tree)

    def unload(self) -> None:
        self.params = None

    def prepare(self) -> None:
        """Run every bucket of the ladder once through the configured
        recognizer (kernel builds, library handles)."""
        self.load()
        for bucket in self.batch_ladder:
            self._recognize(np.zeros((bucket, self.cfg.height, self.cfg.max_width), np.float32))

    def _recognize(self, strips: np.ndarray) -> list[tuple[str, float]]:
        """One padded slice of strips → (text, confidence) a strip, the
        device's results brought back by one copy."""
        x = torch.from_numpy(strips).to(self.device)
        if self.recognizer == "attn":
            toks, lens, conf = ocr.attn_read(self.params, self.attn_cfg, x)
            host = torch.cat([toks.to(torch.float32), lens.to(torch.float32)[:, None],
                              conf[:, None]], dim=1).cpu().numpy()
            return [(ocr.attn_collapse(row[:-2].astype(np.int64), int(row[-2]), self.cfg.charset),
                     float(row[-1])) for row in host]
        ids, conf = ocr.recognize(self.params, self.cfg, x)
        host = torch.cat([ids.to(torch.float32), conf[:, None]], dim=1).cpu().numpy()
        return [(ocr.ctc_collapse(row[:-1].astype(np.int64), self.cfg.charset), float(row[-1]))
                for row in host]

    def read_lines(self, grays: Sequence[np.ndarray]) -> list[list[tuple[str, float]]]:
        """Grayscale pages ((H, W) uint8 each) → each page's lines as (text,
        confidence), top to bottom: every page segmented and its strips
        prepared on the host, then recognized in slices of at most the top
        bucket, each padded to its own bucket."""
        self.load()
        strips, owners = [], []
        for i, gray in enumerate(grays):
            for box in ocr.segment_lines(gray):
                strips.append(ocr.prepare_strip(gray, box, self.cfg))
                owners.append(i)
        lines: list = []
        cap = self.batch_ladder[-1]
        for lo in range(0, len(strips), cap):
            part = np.stack(strips[lo : lo + cap])
            bucket = batching.bucket_for(len(part), self.batch_ladder)
            lines += self._recognize(batching.pad_batch(part, bucket)[0])[: len(part)]
        pages: list = [[] for _ in grays]
        for owner, line in zip(owners, lines):
            pages[owner].append(line)
        return pages

    def read_arrays(self, grays: Sequence[np.ndarray]) -> list[dict]:
        """Grayscale pages → the reference's output for each: the lines at
        or above ``min_confidence`` (and not empty) joined by newlines, with
        their mean confidence; a page with no line (or none kept) gives
        ``{"text": "", "confidence": 0.0, "language": None}``."""
        outputs = []
        for lines in self.read_lines(grays):
            kept = [(t, c) for t, c in lines if c >= self.min_confidence and t]
            outputs.append({
                "text": "\n".join(t for t, _ in kept),
                "confidence": float(np.mean([c for _, c in kept])) if kept else 0.0,
                "language": None,
            })
        return outputs

    @staticmethod
    def decode_gray(payload: bytes) -> np.ndarray:
        """Image bytes → (H, W) uint8 grayscale, as the reference decodes
        them (PIL's ``convert("L")``); raises on an undecodable payload."""
        from PIL import Image

        with Image.open(io.BytesIO(payload)) as im:
            return np.asarray(im.convert("L"))

    def predict(self, inputs: Sequence[PredictionInput]) -> list[Any]:
        self.load()
        outputs: list[Any] = [None] * len(inputs)
        grays, kept = [], []
        for i, inp in enumerate(inputs):
            if inp.file is None:
                outputs[i] = SlotError("input", "OCR requires an image file").to_slot()
                continue
            try:
                grays.append(self.decode_gray(inp.file))
            except Exception as exc:
                outputs[i] = SlotError("input", f"Undecodable image: {exc}").to_slot()
                continue
            kept.append(i)
        for pos, out in zip(kept, self.read_arrays(grays)):
            outputs[pos] = out
        return outputs


# ---------------------------------------------------------------------------
# Fixture impls — the reference's behavior-probe zoo (SURVEY.md §4), used by
# the manager/API tests exactly as the reference uses its fake workers.
# ---------------------------------------------------------------------------

class EchoImpl(InferenceModel):
    def __init__(self, **kwargs: Any):
        self.kwargs = kwargs
        self.loaded = False

    @classmethod
    def name(cls) -> str:
        return "echo_impl"

    def load(self) -> None:
        self.loaded = True

    def unload(self) -> None:
        self.loaded = False

    def predict(self, inputs):
        return [
            {"echo": inp.data, "file_len": len(inp.file) if inp.file else 0}
            for inp in inputs
        ]


class BatchSizeImpl(InferenceModel):
    """Reports the batch size it observed (batching-dynamics tests)."""

    def __init__(self, **_: Any):
        pass

    @classmethod
    def name(cls) -> str:
        return "batchsize_impl"

    def load(self) -> None:
        pass

    def unload(self) -> None:
        pass

    def predict(self, inputs):
        return [{"observed_batch": len(inputs)} for _ in inputs]


class OomImpl(InferenceModel):
    """Raises a device-OOM-shaped error for batches above ``oom_above`` —
    exercises the dispatch layer's batch-halving retry (the reference's
    run_with_oom_retry, impl/utils.py)."""

    def __init__(self, oom_above: int = 2, **_: Any):
        self.oom_above = oom_above
        self.calls: list[int] = []

    @classmethod
    def name(cls) -> str:
        return "oom_impl"

    def load(self) -> None:
        pass

    def unload(self) -> None:
        pass

    def predict(self, inputs):
        self.calls.append(len(inputs))
        if len(inputs) > self.oom_above:
            raise RuntimeError(
                "RESOURCE_EXHAUSTED: Out of memory allocating 9999 bytes"
            )
        return [{"n": len(inputs)} for _ in inputs]


class FailBatchImpl(InferenceModel):
    """Fails any merged batch (>1 input) — exercises the per-request
    fallback (dispatch.rs:28-35)."""

    def __init__(self, **_: Any):
        pass

    @classmethod
    def name(cls) -> str:
        return "failbatch_impl"

    def load(self) -> None:
        pass

    def unload(self) -> None:
        pass

    def predict(self, inputs):
        if len(inputs) > 1:
            raise RuntimeError("merged batch refused")
        return [{"ok": True} for _ in inputs]


class ErrorSlotImpl(InferenceModel):
    """Emits typed error slots on demand: data {"fail": "input"|"transient"}."""

    def __init__(self, **_: Any):
        pass

    @classmethod
    def name(cls) -> str:
        return "errorslot_impl"

    def load(self) -> None:
        pass

    def unload(self) -> None:
        pass

    def predict(self, inputs):
        out = []
        for inp in inputs:
            fail = (inp.data or {}).get("fail") if isinstance(inp.data, dict) else None
            if fail:
                out.append(SlotError(fail, f"requested {fail} failure").to_slot())
            else:
                out.append({"ok": True})
        return out


class SlowImpl(InferenceModel):
    def __init__(self, delay: float = 0.2, **_: Any):
        self.delay = delay

    @classmethod
    def name(cls) -> str:
        return "slow_impl"

    def load(self) -> None:
        pass

    def unload(self) -> None:
        pass

    def predict(self, inputs):
        time.sleep(self.delay)
        return [{"ok": True} for _ in inputs]


class BrokenLoadImpl(InferenceModel):
    def __init__(self, **_: Any):
        pass

    @classmethod
    def name(cls) -> str:
        return "broken_impl"

    def load(self) -> None:
        raise RuntimeError("deliberately broken load")

    def unload(self) -> None:
        pass

    def predict(self, inputs):
        return []


class LoadCountImpl(InferenceModel):
    """Class-level load()/prepare() call counters — proves prewarm-loop
    behavior (a warmed model's first predict must show NO load/compile
    stall, i.e. no additional load call)."""

    loads = 0
    prepares = 0

    def __init__(self, **_: Any):
        pass

    @classmethod
    def name(cls) -> str:
        return "loadcount_impl"

    @classmethod
    def reset_counters(cls) -> None:
        cls.loads = 0
        cls.prepares = 0

    def load(self) -> None:
        type(self).loads += 1

    def prepare(self) -> None:
        type(self).prepares += 1

    def unload(self) -> None:
        pass

    def predict(self, inputs):
        return [{"ok": True} for _ in inputs]


IMPL_INDEX: dict[str, type[InferenceModel]] = {
    cls.name(): cls
    for cls in [
        ClipImpl,
        TextEmbedImpl,
        TaggerImpl,
        WhisperImpl,
        ClapImpl,
        CaptionerImpl,
        VlmTaggerImpl,
        KimiVlImpl,
        Md5LookupImpl,
        ApiEmbedImpl,
        TagApiImpl,
        OcrImpl,
        EchoImpl,
        BatchSizeImpl,
        FailBatchImpl,
        OomImpl,
        ErrorSlotImpl,
        SlowImpl,
        BrokenLoadImpl,
        LoadCountImpl,
    ]
}
