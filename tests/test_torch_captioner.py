"""The port's captioner (``CaptionerImpl``, ``_caption_decode``,
``VlmTaggerImpl``, ``clip.encode_image_tokens``) and the whisper-decoder
checkpoint mapping against the JAX package's, at test-tiny on the CPU, with
the JAX impl's loaded weights carried over (``models.convert``).

Tolerances, as ``tests/test_torch_whisper.py`` sets them for the same
decoder: vision tokens at cosine ≥ 0.999 a token; the decoder's steps
teacher-forced on the JAX decode's tokens at cosine ≥ 0.999 a position, the
argmax equal wherever the JAX top-2 margin exceeds twice the observed max
abs error; free-running tokens equal up to the first position whose margin
is below that (two implementations may split at a near-tie, so no test
requires more).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panoptikon_tpu.models import clip as ref_clip
from panoptikon_tpu.models import impls as ref
from panoptikon_tpu.models import weights as ref_weights
from panoptikon_tpu.models import whisper as ref_whisper
from panoptikon_tpu.models.base import PredictionInput as RefInput
from panoptikon_tpu_torch.models import clip, convert, impls, weights, whisper
from panoptikon_tpu_torch.models.base import PredictionInput

from test_torch_tagger import pngs, same_trees
from test_torch_whisper import check_teacher_forced, cosines, same_up_to_split

MAX_TOKENS = 12
_ref_tokens = jax.jit(ref_clip.encode_image_tokens, static_argnums=1)
_ref_step = jax.jit(ref_whisper._decode_step, static_argnames=("cfg", "max_tokens"))


def carry(jimpl, timpl):
    """The JAX impl's loaded vision and decoder trees into the port's impl."""
    timpl.vision_params = convert.params_from_jax(jax.tree.map(np.asarray, jimpl.vision_params),
                                                  device="cpu")
    timpl.decoder_params = whisper.bf16_linears(
        convert.params_from_jax(jax.tree.map(np.asarray, jimpl.decoder_params), device="cpu"))
    return timpl


@pytest.fixture(scope="module")
def pair():
    jimpl = ref.CaptionerImpl("test-tiny", max_tokens=MAX_TOKENS)
    jimpl.load()
    return jimpl, carry(jimpl, impls.CaptionerImpl("test-tiny", max_tokens=MAX_TOKENS, device="cpu"))


def images(n=4, seed=0):
    return np.stack([ref.decode_image(f, 32) for f in pngs(n, seed)])


def test_encode_image_tokens_matches(pair):
    jimpl, timpl = pair
    x = images(5)
    want = np.asarray(_ref_tokens(jimpl.vision_params, jimpl.vision_cfg, x))
    got = clip.encode_image_tokens(timpl.vision_params, timpl.vision_cfg, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape == (5, 1 + 2 * 2, 64)
    cos = cosines(got.numpy().reshape(-1, 64), want.reshape(-1, 64))
    assert cos.min() >= 0.999, cos.min()


def ref_teacher_forced(jimpl, feats, tokens):
    """The JAX decoder's incremental steps over token rows (B, L): logits
    (B, L - 1, vocab)."""
    cfg = jimpl.decoder_cfg
    b, length = tokens.shape
    ck, cv = ref_whisper._cross_kv(jimpl.decoder_params, cfg, feats)
    sk = jnp.zeros((cfg.n_text_layers, b, length, cfg.n_text_state), jnp.bfloat16)
    sv = jnp.zeros_like(sk)
    out = []
    for i in range(length - 1):
        logits, sk, sv = _ref_step(jimpl.decoder_params, cfg, jnp.asarray(tokens[:, i]),
                                   jnp.asarray(i), sk, sv, ck, cv, length)
        out.append(np.asarray(logits))
    return np.stack(out, axis=1)


@torch.inference_mode()
def port_teacher_forced(timpl, feats, tokens):
    cfg = timpl.decoder_cfg
    b, length = tokens.shape
    ck, cv = whisper._cross_heads(timpl.decoder_params, cfg, feats)
    sk = torch.zeros((cfg.n_text_layers, b, length, cfg.n_text_state), dtype=torch.bfloat16)
    sv = torch.zeros_like(sk)
    tokens = torch.from_numpy(np.array(tokens))
    return np.stack([whisper._decode_step(timpl.decoder_params, cfg, tokens[:, i], i, sk, sv, ck,
                                          cv, length).numpy() for i in range(length - 1)], axis=1)


@pytest.mark.parametrize("extra_ids", [(), (7, 9)])
def test_teacher_forced_steps_and_free_running_tokens(pair, extra_ids):
    jimpl, timpl = pair
    x = images(4, seed=1)
    jfeats = _ref_tokens(jimpl.vision_params, jimpl.vision_cfg, x)
    want_tokens, want_len, _ = (np.asarray(t) for t in ref._caption_decode(
        jimpl.decoder_params, jimpl.decoder_cfg, jfeats, MAX_TOKENS, extra_ids))
    feats = clip.encode_image_tokens(timpl.vision_params, timpl.vision_cfg, torch.from_numpy(x))
    got = port_teacher_forced(timpl, feats, want_tokens)
    want = ref_teacher_forced(jimpl, jfeats, want_tokens)
    p_len = 3 + len(extra_ids)
    _, first = check_teacher_forced(got, want, want_tokens, p_len, jimpl.decoder_cfg.eot)
    got_tokens, got_len, got_lp = (t.numpy() for t in impls._caption_decode(
        timpl.decoder_params, timpl.decoder_cfg, feats, MAX_TOKENS, extra_ids))
    assert got_tokens.shape == (4, MAX_TOKENS) and got_tokens.dtype == np.int32
    np.testing.assert_array_equal(got_tokens[:, :p_len], np.broadcast_to(
        [500, 502, 503, *extra_ids], (4, p_len)))
    same_up_to_split(got_tokens, want_tokens, first)
    assert np.isfinite(got_lp).all() and (got_lp <= 0).all()


def test_predict_matches_the_jax_impl(pair):
    # The caption text is the decoded tokens past the prompt (no tokenizer:
    # "<id>" each), equal to the JAX impl's up to the first narrow margin.
    jimpl, timpl = pair
    files = pngs(3, seed=2)
    want = jimpl.predict([RefInput(file=f) for f in files])
    got = timpl.predict([PredictionInput(file=f) for f in files])
    x = np.stack([impls.decode_image(f, 32) for f in files])
    assert got == timpl.caption_arrays(x)
    feats = clip.encode_image_tokens(timpl.vision_params, timpl.vision_cfg, torch.from_numpy(x))
    tokens = impls._caption_decode(timpl.decoder_params, timpl.decoder_cfg, feats,
                                   MAX_TOKENS)[0].numpy()
    for g, w, row in zip(got, want, tokens):
        assert g["text"] == " ".join(f"<{t}>" for t in row[3:] if t != 501)
        assert (g["language"], g["language_confidence"]) == (w["language"], w["language_confidence"])
        assert 0 < g["confidence"] <= 1
    jfeats = _ref_tokens(jimpl.vision_params, jimpl.vision_cfg, x)
    want_tokens = np.asarray(ref._caption_decode(jimpl.decoder_params, jimpl.decoder_cfg, jfeats,
                                                 MAX_TOKENS)[0])
    _, first = check_teacher_forced(
        port_teacher_forced(timpl, feats, want_tokens),
        ref_teacher_forced(jimpl, jfeats, want_tokens), want_tokens, 3, 501)
    for g, w, f in zip(got, want, first):
        n = f + 1 - 3  # the generated tokens up to and including the first narrow margin
        assert g["text"].split()[:n] == w["text"].split()[:n]


def test_prompt_ids_extend_the_prefix_and_are_left_out_of_the_text(pair):
    # tests/test_captioner.py::TestPromptedDecode on the port: the prompt
    # conditions the decode and never reaches the output.
    _, timpl = pair
    files = pngs(2, seed=3)
    plain = timpl.predict([PredictionInput(file=f) for f in files])
    timpl._prompt_ids = (7, 9)
    try:
        prompted = timpl.predict([PredictionInput(file=f) for f in files])
        x = np.stack([impls.decode_image(f, 32) for f in files])
        tokens, lengths, _ = (t.numpy() for t in impls._caption_decode(
            timpl.decoder_params, timpl.decoder_cfg, clip.encode_image_tokens(
                timpl.vision_params, timpl.vision_cfg, torch.from_numpy(x)), MAX_TOKENS, (7, 9)))
    finally:
        timpl._prompt_ids = ()
    for out, row, n in zip(prompted, tokens, lengths):
        assert row[:5].tolist() == [500, 502, 503, 7, 9]
        assert out["text"] == " ".join(f"<{t}>" for t in row[5:n])
    assert [o["text"] for o in prompted] != [o["text"] for o in plain]


def test_non_image_inputs_get_error_slots(pair):
    _, timpl = pair
    out = timpl.predict([PredictionInput(data={"pixels": np.zeros((32, 32, 3))}),
                         PredictionInput(file=b"not an image"), PredictionInput(file=pngs(1)[0])])
    assert out[0]["__error__"] == {"class": "input", "message": "Captioner requires an image file"}
    assert out[1]["__error__"]["class"] == "input"
    assert out[2]["language"] == "en" and out[2]["text"]


CAPTION = "Red, dog. dog  CAT  tree,a, b. c d e f g h i j k l m n o p q r"


def test_vlm_tagger_parse_is_the_reference_s(monkeypatch):
    # One caption text (and an error slot) parsed by both packages' predict
    # and by the port's tag_arrays: equal tag maps, at most max_tags tags.
    caps = [{"text": CAPTION, "confidence": 0.25, "language": "en", "language_confidence": 1.0},
            {"__error__": {"class": "input", "message": "x"}}]
    monkeypatch.setattr(ref.CaptionerImpl, "predict", lambda self, inputs: caps)
    monkeypatch.setattr(impls.CaptionerImpl, "predict", lambda self, inputs: caps)
    want = ref.VlmTaggerImpl(model_arch="test-tiny", max_tags=6).predict([None, None])
    timpl = impls.VlmTaggerImpl(model_arch="test-tiny", max_tags=6, device="cpu")
    assert timpl.predict([None, None]) == want
    assert list(dict(want[0]["tags"])["general"]) == ["red", "dog", "cat", "tree", "a", "b"]
    monkeypatch.setattr(impls.CaptionerImpl, "caption_arrays", lambda self, images: caps[:1])
    assert timpl.tag_arrays(np.zeros((1, 32, 32, 3), np.float32)) == want[:1]


def test_vlm_tagger_arrays_equal_predict():
    timpl = impls.VlmTaggerImpl(model_arch="test-tiny", max_tokens=8, device="cpu")
    files = pngs(2, seed=4)
    got = timpl.predict([PredictionInput(file=f) for f in files])
    x = np.stack([impls.decode_image(f, 32) for f in files])
    assert timpl.tag_arrays(x) == got
    cats = dict(got[0]["tags"])
    assert set(cats) == {"rating", "character", "general"} and cats["general"]
    assert got[0]["namespace"] == "vlm"


def test_load_is_seeded_and_decoder_is_the_reference_s_layout():
    a = impls.CaptionerImpl("test-tiny", device="cpu")
    b = impls.CaptionerImpl("test-tiny", device="cpu")
    a.load()
    b.load()
    assert torch.equal(a.decoder_params["decoder"]["token_emb"], b.decoder_params["decoder"]["token_emb"])
    rcfg = ref.CaptionerImpl("test-tiny").decoder_cfg
    assert a.decoder_cfg.__dict__ == rcfg.__dict__
    big = impls.CaptionerImpl("ViT-B-32", max_tokens=48, device="cpu")
    # caption-base's decoder: 768 wide, 2 heads, so a head dim of 384.
    assert (big.decoder_cfg.n_text_state, big.decoder_cfg.n_text_heads,
            big.decoder_cfg.n_text_ctx) == (768, 2, 48)
    blk = a.decoder_params["decoder"]["blocks"][0]
    assert blk["attn"]["qkv_w"].dtype == torch.bfloat16 and blk["ln_1"]["scale"].dtype == torch.float32


def test_decoder_checkpoint_round_trips_through_both_packages(tmp_path):
    # Each package's exporter read by the other's loader gives the tree; the
    # port's impl loads its decoder from the file, and the vision tower from
    # an HF CLIP checkpoint, and decodes what the carried-over impl decodes.
    jimpl = ref.CaptionerImpl("test-tiny", max_tokens=MAX_TOKENS)
    jimpl.load()
    cfg = jimpl.decoder_cfg
    tree = jax.tree.map(np.asarray, jimpl.decoder_params)
    rng = np.random.default_rng(5)
    for blk in tree["decoder"]["blocks"]:  # a k-proj bias the HF layout omits
        blk["attn"]["qkv_b"] = rng.normal(size=blk["attn"]["qkv_b"].shape).astype(np.float32)
    dec = {"decoder": tree["decoder"]}
    ref_weights.save_whisper_decoder_checkpoint(dec, tmp_path / "ref.safetensors")
    weights.save_whisper_decoder_checkpoint(dec, tmp_path / "port.bin")
    same_trees(weights.load_whisper_decoder_checkpoint(tmp_path / "ref.safetensors", cfg), dec)
    same_trees(ref_weights.load_whisper_decoder_checkpoint(tmp_path / "port.bin", cfg), dec)
    vision = jax.tree.map(np.asarray, jimpl.vision_params)
    ref_weights.save_clip_checkpoint(vision, jimpl.vision_cfg, tmp_path / "clip.bin")
    timpl = impls.CaptionerImpl("test-tiny", max_tokens=MAX_TOKENS, checkpoint=str(tmp_path / "clip.bin"),
                                decoder_checkpoint=str(tmp_path / "port.bin"), device="cpu")
    timpl.load()
    assert set(timpl.decoder_params) == {"decoder"}
    carried = impls.CaptionerImpl("test-tiny", max_tokens=MAX_TOKENS, device="cpu")
    carried.vision_params = convert.params_from_jax(vision, device="cpu")
    carried.decoder_params = whisper.bf16_linears(convert.params_from_jax(dec, device="cpu"))
    x = images(2, seed=6)
    assert timpl.caption_arrays(x) == carried.caption_arrays(x)


def test_decoder_logits_at_the_caption_base_head_dim():
    # whisper._decoder_logits with the reference's fifth parameter (token_mask,
    # accepted and never read) at caption-base's decoder widths: 768 wide, 2
    # heads, so D 384, B3's CUDA-core route on the card. Whole teacher-forced
    # rows (causal self-attention, cross-attention over 50 vision tokens),
    # against the JAX function on the same tree: cosine ≥ 0.999 a position.
    rcfg = ref.CaptionerImpl("ViT-B-32", max_tokens=48).decoder_cfg
    cfg = impls.CaptionerImpl("ViT-B-32", max_tokens=48, device="cpu").decoder_cfg
    assert (cfg.n_text_state // cfg.n_text_heads, cfg.n_audio_ctx) == (384, 50)
    jparams = {"decoder": ref_whisper.init_params(jax.random.key(9), rcfg)["decoder"]}
    params = whisper.bf16_linears(convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                                          device="cpu"))
    rng = np.random.default_rng(10)
    tokens = np.concatenate([np.broadcast_to([[500, 502, 503]], (2, 3)),
                             rng.integers(0, 500, size=(2, 13))], axis=1).astype(np.int32)
    feats = rng.normal(size=(2, 50, 768)).astype(np.float32)
    want = np.asarray(jax.jit(ref_whisper._decoder_logits, static_argnums=1)(
        jparams, rcfg, jnp.asarray(tokens), jnp.asarray(feats), None))
    with torch.inference_mode():
        got = whisper._decoder_logits(params, cfg, torch.from_numpy(tokens),
                                      torch.from_numpy(feats), None).numpy()
        mask = torch.ones(tokens.shape, dtype=torch.bool)
        assert np.array_equal(got, whisper._decoder_logits(
            params, cfg, torch.from_numpy(tokens), torch.from_numpy(feats), mask).numpy())
    assert got.shape == want.shape == (2, 16, cfg.n_vocab) and got.dtype == np.float32
    assert cosines(got, want).min() >= 0.999
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()
