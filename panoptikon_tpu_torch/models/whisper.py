"""Whisper-architecture speech-to-text on tensors — the port of
``models/whisper.py``.

The standard Whisper encoder-decoder (the reference worker's
``python/inferio/impl/whisper.py``: audio → text, language, confidence):

- the host log-mel spectrogram (n_fft 400, hop 160, 80 mel bins, one 30 s
  window → 3,000 frames), copied from the JAX package with its constants,
  ``WhisperConfig``, ``LANGUAGES`` and ``CONFIGS`` and held to it by
  ``tests/test_torch_host_copies.py``;
- the encoder (:func:`encode_audio`): two convolutions (stride 1, then 2:
  3,000 frames → 1,500), sinusoidal positions and pre-LN blocks whose
  self-attention is ``ops.vit_attention.attention`` (kernel B3 on the card:
  1,500 keys take its two-pass form), q, k and v read in place from the
  fused qkv projection;
- the decoder: :func:`_decoder_logits` runs whole token rows (the language
  probe's one [SOT] step, :func:`language_probe`, and the re-run oracle)
  with causal self-attention and cross-attention through B3;
  :func:`decode_from_feats` is the greedy decode with static KV caches,
  one position a step (:func:`_decode_step`), whose attention over the
  caches is plain tensor ops in f32, as the reference's is outside any
  Pallas kernel. The reference's ``lax.while_loop`` is a host loop on the
  same condition: its tensors stay on the device and the done test is its
  one synchronisation a step.

Parameters are the JAX package's tree with its keys and layouts (linear
weights (in, out) applied as ``x @ w``, the convolutions (K, C_in, C_out)),
so ``models.convert.params_from_jax`` carries a JAX tree over unchanged and
``models.weights.load_whisper_checkpoint`` maps an HF ``WhisperModel`` state
dict onto it. The rounding follows the reference point for point:
activations and matmuls in bf16 with the bias added in bf16; LayerNorm in
f32 (population variance, eps 1e-5), cast back; tanh GELU; sinusoids in
f32, then cast; ``token_emb`` gathered in f32, then cast; the logits an f32
product with the tied ``token_emb``ᵀ (TF32 stays off: ``ops/exact.py`` and
PyTorch's default).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from panoptikon_tpu_torch.ops import vit_attention

Params = dict[str, Any]

SAMPLE_RATE = 16000
N_FFT = 400
HOP = 160
N_MELS = 80
CHUNK_SECONDS = 30


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    n_mels: int = N_MELS
    n_audio_ctx: int = 1500
    n_audio_state: int = 384
    n_audio_layers: int = 4
    n_audio_heads: int = 6
    n_vocab: int = 51865
    n_text_ctx: int = 448
    n_text_state: int = 384
    n_text_layers: int = 4
    n_text_heads: int = 6
    # Special tokens (multilingual vocab layout).
    sot: int = 50258
    eot: int = 50257
    no_timestamps: int = 50363
    transcribe: int = 50359
    # Language tokens: ids [lang_base, lang_base + n_langs) map onto
    # LANGUAGES[:n_langs] (OpenAI layout: the 99 language tokens follow
    # SOT). lang_base None → sot + 1.
    n_langs: int = 99
    lang_base: "int | None" = None

    @property
    def language_base(self) -> int:
        return self.sot + 1 if self.lang_base is None else self.lang_base


# OpenAI whisper's language-token order (tokenizer.py LANGUAGES): token
# sot+1+i names LANGUAGES[i].
LANGUAGES = [
    "en", "zh", "de", "es", "ru", "ko", "fr", "ja", "pt", "tr", "pl", "ca",
    "nl", "ar", "sv", "it", "id", "hi", "fi", "vi", "he", "uk", "el", "ms",
    "cs", "ro", "da", "hu", "ta", "no", "th", "ur", "hr", "bg", "lt", "la",
    "mi", "ml", "cy", "sk", "te", "fa", "lv", "bn", "sr", "az", "sl", "kn",
    "et", "mk", "br", "eu", "is", "hy", "ne", "mn", "bs", "kk", "sq", "sw",
    "gl", "mr", "pa", "si", "km", "sn", "yo", "so", "af", "oc", "ka", "be",
    "tg", "sd", "gu", "am", "yi", "lo", "uz", "fo", "ht", "ps", "tk", "nn",
    "mt", "sa", "lb", "my", "bo", "tl", "mg", "as", "tt", "haw", "ln", "ha",
    "ba", "jw", "su",
]


CONFIGS = {
    "whisper-tiny": WhisperConfig(),
    "whisper-base": WhisperConfig(
        n_audio_state=512, n_audio_layers=6, n_audio_heads=8,
        n_text_state=512, n_text_layers=6, n_text_heads=8,
    ),
    "test-tiny": WhisperConfig(
        n_mels=16, n_audio_ctx=32, n_audio_state=32, n_audio_layers=2,
        n_audio_heads=2, n_vocab=128, n_text_ctx=16, n_text_state=32,
        n_text_layers=2, n_text_heads=2, sot=100, eot=101,
        no_timestamps=103, transcribe=102,
        n_langs=4, lang_base=104,  # eot sits at sot+1 here → explicit base
    ),
}


# ---------------------------------------------------------------------------
# Host-side mel spectrogram
# ---------------------------------------------------------------------------


def mel_filterbank(n_mels: int, n_fft: int = N_FFT, sr: int = SAMPLE_RATE) -> np.ndarray:
    """Slaney-style mel filterbank (n_mels, n_fft//2 + 1)."""

    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)

    fmax = sr / 2
    mels = np.linspace(hz_to_mel(0), hz_to_mel(fmax), n_mels + 2)
    freqs = mel_to_hz(mels)
    # Continuous triangular ramps over the FFT bin center frequencies —
    # avoids degenerate all-zero filters from integer bin collapse.
    bin_freqs = np.linspace(0, fmax, n_fft // 2 + 1)
    lo = freqs[:-2][:, None]
    mid = freqs[1:-1][:, None]
    hi = freqs[2:][:, None]
    up = (bin_freqs[None, :] - lo) / np.maximum(mid - lo, 1e-10)
    down = (hi - bin_freqs[None, :]) / np.maximum(hi - mid, 1e-10)
    return np.maximum(0.0, np.minimum(up, down)).astype(np.float32)


def log_mel_spectrogram(audio: np.ndarray, n_mels: int = N_MELS) -> np.ndarray:
    """f32 PCM (-1..1) at 16 kHz → (n_mels, frames) log-mel, padded/trimmed
    to one 30 s chunk (3000 frames), Whisper's normalization."""
    target = SAMPLE_RATE * CHUNK_SECONDS
    audio = np.asarray(audio, dtype=np.float32)[:target]
    if len(audio) < target:
        audio = np.pad(audio, (0, target - len(audio)))
    # Centered STFT (reflect pad N_FFT/2 both sides) → exactly
    # target/HOP = 3000 frames.
    audio = np.pad(audio, (N_FFT // 2, N_FFT // 2), mode="reflect")
    window = np.hanning(N_FFT + 1)[:-1].astype(np.float32)
    frames = target // HOP
    strided = np.lib.stride_tricks.as_strided(
        audio,
        shape=(frames, N_FFT),
        strides=(audio.strides[0] * HOP, audio.strides[0]),
    )
    stft = np.fft.rfft(strided * window, axis=1)
    power = (np.abs(stft) ** 2).astype(np.float32)
    fb = mel_filterbank(n_mels)
    mel = fb @ power.T  # (n_mels, frames)
    log_spec = np.log10(np.maximum(mel, 1e-10))
    log_spec = np.maximum(log_spec, log_spec.max() - 8.0)
    return ((log_spec + 4.0) / 4.0).astype(np.float32)



# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _normal(gen: torch.Generator, shape, std: float):
    return torch.randn(shape, generator=gen, device=gen.device) * std


def _ln(w: int, dev) -> Params:
    return {"scale": torch.ones(w, device=dev), "bias": torch.zeros(w, device=dev)}


def _init_attn(gen: torch.Generator, w: int) -> Params:
    dev = gen.device
    return {"qkv_w": _normal(gen, (w, 3 * w), w**-0.5), "qkv_b": torch.zeros(3 * w, device=dev),
            "out_w": _normal(gen, (w, w), w**-0.5), "out_b": torch.zeros(w, device=dev)}


def _init_cross(gen: torch.Generator, w: int) -> Params:
    dev = gen.device
    return {"q_w": _normal(gen, (w, w), w**-0.5), "q_b": torch.zeros(w, device=dev),
            "kv_w": _normal(gen, (w, 2 * w), w**-0.5), "kv_b": torch.zeros(2 * w, device=dev),
            "out_w": _normal(gen, (w, w), w**-0.5), "out_b": torch.zeros(w, device=dev)}


def _init_mlp(gen: torch.Generator, w: int) -> Params:
    dev = gen.device
    return {"fc_w": _normal(gen, (w, 4 * w), w**-0.5), "fc_b": torch.zeros(4 * w, device=dev),
            "proj_w": _normal(gen, (4 * w, w), (4 * w) ** -0.5), "proj_b": torch.zeros(w, device=dev)}


def init_decoder(cfg: WhisperConfig, gen: torch.Generator) -> Params:
    """The text decoder's random f32 tree (``params["decoder"]``), drawn from
    ``gen``: the whisper decoder's, and OCR's attention reader's over its
    strip features (``models/ocr.init_attn_params``)."""
    dev, w = gen.device, cfg.n_text_state
    return {
        "token_emb": _normal(gen, (cfg.n_vocab, w), 0.02),
        "pos_emb": _normal(gen, (cfg.n_text_ctx, w), 0.01),
        "blocks": [{"ln_1": _ln(w, dev), "attn": _init_attn(gen, w), "ln_cross": _ln(w, dev),
                    "cross": _init_cross(gen, w), "ln_2": _ln(w, dev), "mlp": _init_mlp(gen, w)}
                   for _ in range(cfg.n_text_layers)],
        "ln_post": _ln(w, dev),
    }


def init_params(cfg: WhisperConfig, gen: torch.Generator) -> Params:
    """Random f32 parameters with the JAX package's shapes and scales, drawn
    from ``gen`` on ``gen.device``. The values differ from ``jax.random``'s;
    tests that compare the two packages convert one JAX tree instead."""
    dev, w_a = gen.device, cfg.n_audio_state
    encoder = {
        "conv1_w": _normal(gen, (3, cfg.n_mels, w_a), 0.02),
        "conv1_b": torch.zeros(w_a, device=dev),
        "conv2_w": _normal(gen, (3, w_a, w_a), 0.02),
        "conv2_b": torch.zeros(w_a, device=dev),
        "blocks": [{"ln_1": _ln(w_a, dev), "attn": _init_attn(gen, w_a), "ln_2": _ln(w_a, dev),
                    "mlp": _init_mlp(gen, w_a)} for _ in range(cfg.n_audio_layers)],
        "ln_post": _ln(w_a, dev),
    }
    return {"encoder": encoder, "decoder": init_decoder(cfg, gen)}


def bf16_linears(params: Params) -> Params:
    """The tree with the convolutions and every block linear (weights and
    biases) cast to bf16 once, as the forward casts them on each use;
    LayerNorms and the embedding tables stay f32. Other leaves are shared.
    A decoder-only tree (the captioner's checkpoint) stays decoder-only."""
    def cast(d):
        return {k: v.to(torch.bfloat16) for k, v in d.items()}

    def blocks(bs):
        return [{k: cast(v) if k in ("attn", "cross", "mlp") else v for k, v in blk.items()}
                for blk in bs]

    dec = params["decoder"]
    out = {"decoder": {**dec, "blocks": blocks(dec["blocks"])}}
    if "encoder" in params:
        enc = params["encoder"]
        convs = cast({k: enc[k] for k in ("conv1_w", "conv1_b", "conv2_w", "conv2_b")})
        out["encoder"] = {**enc, **convs, "blocks": blocks(enc["blocks"])}
    return out


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _layernorm(x, p):
    # In f32 with the population variance, cast back to x's dtype: the
    # reference's arithmetic, as one library call (a decode step holds 19).
    return F.layer_norm(x.to(torch.float32), (x.shape[-1],), p["scale"], p["bias"], 1e-5).to(x.dtype)


def _linear(x, w, b):
    return x @ w.to(x.dtype) + b.to(x.dtype)


def _self_attention(x, p, heads: int, causal: bool = False):
    b, n, w = x.shape
    qkv = _linear(x, p["qkv_w"], p["qkv_b"])
    # q, k, v as views of the fused projection: B3 reads them in place.
    q, k, v = (t.view(b, n, heads, w // heads) for t in qkv.split(w, dim=-1))
    out = vit_attention.attention(q, k, v, causal=causal).reshape(b, n, w)
    return _linear(out, p["out_w"], p["out_b"])


def _mlp(x, p):
    h = F.gelu(_linear(x, p["fc_w"], p["fc_b"]), approximate="tanh")
    return _linear(h, p["proj_w"], p["proj_b"])


def _sinusoids(length: int, channels: int, device):
    log_timescale = torch.log(torch.tensor(10000.0, device=device)) / (channels // 2 - 1)
    inv = torch.exp(-log_timescale * torch.arange(channels // 2, dtype=torch.float32, device=device))
    scaled = torch.arange(length, dtype=torch.float32, device=device)[:, None] * inv[None, :]
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=1)


def _conv1d(x, w, b, stride: int):
    """x (B, T, C_in); w (K, C_in, C_out), the reference's WIO layout; 'same'
    padding of K // 2 on both sides; the bias added after the convolution's
    rounding, as the reference adds it."""
    out = F.conv1d(x.transpose(1, 2), w.permute(2, 1, 0), stride=stride, padding=w.shape[0] // 2)
    return out.transpose(1, 2) + b


def encode_audio(params: Params, cfg: WhisperConfig, mel):
    """mel (B, n_mels, frames) on the parameters' device → (B, n_audio_ctx,
    n_audio_state) f32."""
    e = params["encoder"]
    x = mel.transpose(1, 2).to(torch.bfloat16)  # (B, T, mels)
    x = F.gelu(_conv1d(x, e["conv1_w"].to(x.dtype), e["conv1_b"].to(x.dtype), 1), approximate="tanh")
    x = F.gelu(_conv1d(x, e["conv2_w"].to(x.dtype), e["conv2_b"].to(x.dtype), 2), approximate="tanh")
    x = x[:, : cfg.n_audio_ctx]
    x = x + _sinusoids(cfg.n_audio_ctx, cfg.n_audio_state, x.device).to(x.dtype)[None]
    for blk in e["blocks"]:
        x = x + _self_attention(_layernorm(x, blk["ln_1"]), blk["attn"], cfg.n_audio_heads)
        x = x + _mlp(_layernorm(x, blk["ln_2"]), blk["mlp"])
    return _layernorm(x, e["ln_post"]).to(torch.float32)


def _decoder_logits(params: Params, cfg: WhisperConfig, tokens, audio_feats, token_mask):
    """tokens (B, L), causal over the row; audio_feats (B, M, state) →
    logits (B, L, vocab) f32. ``token_mask`` is the reference's parameter,
    which it accepts and never reads (the causal mask alone bounds each
    position), so the port takes it and does the same. At a head dim past
    128 (the captioner's decoder: D 384) B3 takes its CUDA-core route."""
    d = params["decoder"]
    b, n = tokens.shape
    w, heads = cfg.n_text_state, cfg.n_text_heads
    x = d["token_emb"][tokens.long()].to(torch.bfloat16)
    x = x + d["pos_emb"].to(x.dtype)[None, :n]
    audio = audio_feats.to(x.dtype)
    m = audio.shape[1]
    for blk in d["blocks"]:
        x = x + _self_attention(_layernorm(x, blk["ln_1"]), blk["attn"], heads, causal=True)
        h = _layernorm(x, blk["ln_cross"])
        q = _linear(h, blk["cross"]["q_w"], blk["cross"]["q_b"])
        k, v = _linear(audio, blk["cross"]["kv_w"], blk["cross"]["kv_b"]).split(w, dim=-1)
        # Cross-attention (N_q tokens × M audio frames) through B3. q's rows
        # are w wide and the fused kv's 2·w, so k and v are copied apart to
        # the layout q has.
        out = vit_attention.attention(
            q.view(b, n, heads, w // heads), k.reshape(b, m, heads, w // heads).contiguous(),
            v.reshape(b, m, heads, w // heads).contiguous(),
        ).reshape(b, n, w)
        x = x + _linear(out, blk["cross"]["out_w"], blk["cross"]["out_b"])
        x = x + _mlp(_layernorm(x, blk["ln_2"]), blk["mlp"])
    x = _layernorm(x, d["ln_post"]).to(torch.float32)
    return x @ d["token_emb"].to(torch.float32).t()


def language_probe(params: Params, cfg: WhisperConfig, audio_feats):
    """The standard whisper language probe over encoded audio: one decoder
    step from a bare [SOT] prompt, the logits restricted to the language
    tokens, softmax. Returns (index into LANGUAGES (B,) int32, its
    probability (B,) f32)."""
    b = audio_feats.shape[0]
    tokens = torch.full((b, 1), cfg.sot, dtype=torch.int64, device=audio_feats.device)
    logits = _decoder_logits(params, cfg, tokens, audio_feats, None)[:, 0]
    base = cfg.language_base
    probs = torch.softmax(logits[:, base: base + cfg.n_langs], dim=-1)
    idx = torch.argmax(probs, dim=-1)
    return idx.to(torch.int32), probs.gather(1, idx[:, None])[:, 0]


@torch.inference_mode()
def detect_language(params: Params, cfg: WhisperConfig, mel):
    """:func:`language_probe` of the encoded ``mel`` (B, n_mels, frames)."""
    return language_probe(params, cfg, encode_audio(params, cfg, mel))


def _cross_kv(params: Params, cfg: WhisperConfig, audio_feats):
    """Every layer's cross-attention K and V over the audio, computed once
    a decode: two (layers, B, M, W) bf16 stacks."""
    audio = audio_feats.to(torch.bfloat16)
    ks, vs = [], []
    for blk in params["decoder"]["blocks"]:
        k, v = _linear(audio, blk["cross"]["kv_w"], blk["cross"]["kv_b"]).split(
            cfg.n_text_state, dim=-1)
        ks.append(k)
        vs.append(v)
    return torch.stack(ks), torch.stack(vs)


def _heads(keys, values, heads: int):
    """Keys and values (…, B, T, W) in the layout a step's attention reads,
    in f32: K (…, B, H, hd, T) and V (…, B, H, T, hd)."""
    *lead, b, t, w = keys.shape
    split = (*lead, b, t, heads, w // heads)
    n = len(lead)
    kh = keys.reshape(split).permute(*range(n), n, n + 2, n + 3, n + 1).to(torch.float32)
    vh = values.reshape(split).transpose(n + 1, n + 2).to(torch.float32)
    return kh, vh


def _cross_heads(params: Params, cfg: WhisperConfig, audio_feats):
    """:func:`_cross_kv` in the layout every step reads, made once a decode:
    K (layers, B, H, hd, M) and V (layers, B, H, M, hd), f32 (the same
    values the reference casts at each step)."""
    kh, vh = _heads(*_cross_kv(params, cfg, audio_feats), cfg.n_text_heads)
    return kh.contiguous(), vh.contiguous()


def _step_attention(q, kh, vh, key_valid=None):
    """One query position over keys in f32 (the reference's plain form):
    q (B, 1, W); kh (B, H, hd, T), vh (B, H, T, hd) f32 (:func:`_heads`);
    ``key_valid`` (T,) bool or None. Returns (B, 1, W) f32."""
    b, heads, hd, _ = kh.shape
    qh = q.reshape(b, 1, heads, hd).transpose(1, 2).to(torch.float32)
    lt = (qh @ kh) * (hd**-0.5)
    if key_valid is not None:
        lt = torch.where(key_valid, lt, -torch.inf)
    p = torch.softmax(lt, dim=-1)
    return (p @ vh).transpose(1, 2).reshape(b, 1, heads * hd)


def _decode_step(params: Params, cfg: WhisperConfig, tok, pos: int, self_k, self_v,
                 cross_k, cross_v, max_tokens: int):
    """One incremental decoder step over static KV caches: ``tok`` (B,) the
    tokens AT position ``pos``; ``self_k``, ``self_v`` (layers, B,
    max_tokens, W) bf16, written in place at ``pos``; ``cross_k``,
    ``cross_v`` from :func:`_cross_heads`. Returns the logits (B, vocab)
    f32."""
    d = params["decoder"]
    w, heads = cfg.n_text_state, cfg.n_text_heads
    x = d["token_emb"][tok.long()].to(torch.bfloat16)[:, None, :] + d["pos_emb"][pos].to(torch.bfloat16)
    key_valid = torch.arange(max_tokens, device=x.device) <= pos  # causal == cache validity
    for li, blk in enumerate(d["blocks"]):
        h = _layernorm(x, blk["ln_1"])
        q, k, v = _linear(h, blk["attn"]["qkv_w"], blk["attn"]["qkv_b"]).split(w, dim=-1)
        self_k[li, :, pos] = k[:, 0]
        self_v[li, :, pos] = v[:, 0]
        out = _step_attention(q, *_heads(self_k[li], self_v[li], heads), key_valid).to(x.dtype)
        x = x + _linear(out, blk["attn"]["out_w"], blk["attn"]["out_b"])
        h = _layernorm(x, blk["ln_cross"])
        q = _linear(h, blk["cross"]["q_w"], blk["cross"]["q_b"])
        out = _step_attention(q, cross_k[li], cross_v[li]).to(x.dtype)
        x = x + _linear(out, blk["cross"]["out_w"], blk["cross"]["out_b"])
        x = x + _mlp(_layernorm(x, blk["ln_2"]), blk["mlp"])
    x = _layernorm(x, d["ln_post"]).to(torch.float32)
    return x[:, 0] @ d["token_emb"].to(torch.float32).t()


def _greedy(logits):
    """The argmax token (B,) int32 and its log-probability (B,) f32."""
    nxt = torch.argmax(logits, dim=-1)
    logp = torch.log_softmax(logits, dim=-1).gather(1, nxt[:, None])[:, 0]
    return nxt.to(torch.int32), logp


@torch.inference_mode()
def decode_from_feats(params: Params, cfg: WhisperConfig, audio_feats, prompt, max_tokens: int):
    """Greedy decode against encoded audio with incremental KV caching.

    prompt (B, p_len) int32 on the device. Returns (tokens (B, max_tokens)
    int32, lengths (B,), avg logprob (B,) f32): greedy, EOT-latched (after
    EOT a row's token stays EOT), the logprob averaged over the generated
    tokens before each row's EOT."""
    b, p_len = prompt.shape
    if p_len >= max_tokens:
        raise ValueError(
            f"prompt length {p_len} must be < max_tokens {max_tokens}: the "
            f"KV cache is sized max_tokens and the prompt prefill would "
            f"overrun it (raise max_tokens or shorten the configured prompt)"
        )
    dev = audio_feats.device
    cross_k, cross_v = _cross_heads(params, cfg, audio_feats)
    self_k = torch.zeros((cfg.n_text_layers, b, max_tokens, cfg.n_text_state),
                         dtype=torch.bfloat16, device=dev)
    self_v = torch.zeros_like(self_k)
    tokens = torch.zeros((b, max_tokens), dtype=torch.int32, device=dev)
    tokens[:, :p_len] = prompt
    # Prefill: the prompt's positions through the step; the last one's
    # logits give the first generated token.
    for i in range(p_len):
        logits = _decode_step(params, cfg, prompt[:, i], i, self_k, self_v, cross_k, cross_v,
                              max_tokens)
    nxt, tok_logp = _greedy(logits)
    tokens[:, p_len] = nxt
    done = nxt == cfg.eot
    lp_sum = torch.where(done, 0.0, tok_logp)
    count = torch.where(done, 0, 1)
    pos = p_len
    # lax.while_loop's condition, tested on the host: the one synchronisation
    # a step.
    while pos + 1 < max_tokens and not bool(done.all()):
        logits = _decode_step(params, cfg, tokens[:, pos], pos, self_k, self_v, cross_k, cross_v,
                              max_tokens)
        nxt, tok_logp = _greedy(logits)
        nxt = torch.where(done, cfg.eot, nxt)
        tokens[:, pos + 1] = nxt
        skip = done | (nxt == cfg.eot)
        lp_sum = lp_sum + torch.where(skip, 0.0, tok_logp)
        count = count + torch.where(skip, 0, 1)
        done = skip
        pos += 1
    lengths = torch.cumprod((tokens != cfg.eot).to(torch.int32), dim=1).sum(dim=1)
    return tokens, lengths, lp_sum / torch.clamp(count.to(torch.float32), min=1.0)


def prompt_tokens(cfg: WhisperConfig, b: int, lang_tokens=None, device=None):
    """(B, 3) [SOT, transcribe, no_timestamps], or with ``lang_tokens`` (B,)
    the full whisper layout (B, 4) [SOT, lang, transcribe, no_timestamps];
    int32 on ``device``."""
    def full(tok):
        return torch.full((b,), tok, dtype=torch.int32, device=device)

    if lang_tokens is None:
        return torch.stack([full(cfg.sot), full(cfg.transcribe), full(cfg.no_timestamps)], dim=1)
    lang = torch.as_tensor(lang_tokens, dtype=torch.int32, device=device)
    return torch.stack([full(cfg.sot), lang, full(cfg.transcribe), full(cfg.no_timestamps)], dim=1)


@torch.inference_mode()
def greedy_decode(params: Params, cfg: WhisperConfig, mel, *, max_tokens: int = 64,
                  lang_tokens=None):
    """Batched greedy transcription of ``mel`` (B, n_mels, frames): (tokens
    (B, max_tokens), lengths (B,), avg logprob (B,)), the avg logprob being
    the reference's persisted confidence signal. With ``lang_tokens`` (B,)
    the prompt is [SOT, lang, transcribe, no_timestamps]."""
    feats = encode_audio(params, cfg, mel)
    prompt = prompt_tokens(cfg, mel.shape[0], lang_tokens, feats.device)
    return decode_from_feats(params, cfg, feats, prompt, max_tokens)


@torch.inference_mode()
def _greedy_decode_rerun(params: Params, cfg: WhisperConfig, mel, *, max_tokens: int = 64,
                         lang_tokens=None):
    """The full-prefix decode (the decoder re-run over the whole token
    buffer every step), O(L) more decoder work than the cached form: the
    equivalence oracle of :func:`greedy_decode`, as in the reference."""
    audio_feats = encode_audio(params, cfg, mel)
    b = mel.shape[0]
    prompt = prompt_tokens(cfg, b, lang_tokens, audio_feats.device)
    p_len = prompt.shape[1]
    tokens = torch.zeros((b, max_tokens), dtype=torch.int32, device=audio_feats.device)
    tokens[:, :p_len] = prompt
    done = torch.zeros(b, dtype=torch.bool, device=tokens.device)
    lp_sum = torch.zeros(b, dtype=torch.float32, device=tokens.device)
    count = torch.zeros(b, dtype=torch.int64, device=tokens.device)
    pos = p_len
    while pos < max_tokens and not bool(done.all()):
        logits = _decoder_logits(params, cfg, tokens, audio_feats, None)
        nxt, tok_logp = _greedy(logits[:, pos - 1])
        nxt = torch.where(done, cfg.eot, nxt)
        tokens[:, pos] = nxt
        skip = done | (nxt == cfg.eot)
        lp_sum = lp_sum + torch.where(skip, 0.0, tok_logp)
        count = count + torch.where(skip, 0, 1)
        done = skip
        pos += 1
    lengths = torch.cumprod((tokens != cfg.eot).to(torch.int32), dim=1).sum(dim=1)
    return tokens, lengths, lp_sum / torch.clamp(count.to(torch.float32), min=1.0)
