"""The port's Whisper tower and ``WhisperImpl`` (``models/whisper.py``,
``models/impls.py``) against the JAX package's on the same parameters
(carried over by ``models.convert``) and the same seeded inputs, on the CPU,
where B3's plain version stands in for the kernel.

Tolerances. Off the TPU the JAX ``attention`` is XLA's
``dot_product_attention``, not the Pallas kernel; the port's plain version
rounds p to bf16 as the kernel does (head dims ≥ 32). Both run bf16
activations, so:

- encoder features: cosine ≥ 0.999 a frame, max abs ≤ 2e-2 × max |ref|;
- decoder logits, teacher-forced (the port's step on the JAX decode's
  tokens): cosine ≥ 0.999 a position; the argmax equal wherever the JAX
  top-2 margin exceeds twice the observed max abs error;
- free-running greedy tokens: equal up to the first position whose JAX
  margin is below that (two implementations may split at a near-tie of
  51,865 bf16 logits, so no test requires more, and no seed is chosen to
  avoid a split);
- language probabilities within 2e-3; confidences (exp avg logprob) within
  2 % where the tokens agree.
"""

import dataclasses
import io
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panoptikon_tpu.models import impls as ref_impls
from panoptikon_tpu.models import weights as ref_weights
from panoptikon_tpu.models import whisper as ref
from panoptikon_tpu_torch.models import convert, impls, weights, whisper
from panoptikon_tpu_torch.models.base import PredictionInput, is_error_slot

COS_FLOOR = 0.999
PROB_ATOL = 2e-3
CONF_RTOL = 2e-2
# test-tiny's heads are 16 wide (the plain attention keeps p in f32 there);
# "d64" widens it to whisper-base's head dim of 64, where p rounds to bf16.
D64 = dict(n_audio_state=128, n_audio_heads=2, n_text_state=128, n_text_heads=2)


def configs(name):
    base = dataclasses.asdict(ref.CONFIGS["test-tiny"])
    fields = {**base, **(D64 if name == "d64" else {})}
    return ref.WhisperConfig(**fields), whisper.WhisperConfig(**fields)


def port_tree(jparams):
    return whisper.bf16_linears(convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                                        device="cpu"))


@pytest.fixture(scope="module", params=["test-tiny", "d64"])
def model(request):
    rcfg, cfg = configs(request.param)
    jparams = ref.init_params(jax.random.key(6), rcfg)
    return rcfg, cfg, jparams, port_tree(jparams)


def make_wav(seconds=1.0, rate=16000, freq=440.0, channels=1, width=2, noise=0.0, seed=0):
    t = np.linspace(0, seconds, int(rate * seconds), endpoint=False)
    sig = np.sin(2 * np.pi * freq * t) * 0.5
    sig = sig + noise * np.random.default_rng(seed).normal(size=t.size)
    if width == 1:
        pcm = (np.clip(sig, -1, 1) * 127 + 128).astype(np.uint8)
    elif width == 4:
        pcm = (np.clip(sig, -1, 1) * (2**31 - 1)).astype("<i4")
    else:
        pcm = (np.clip(sig, -1, 1) * 32767).astype("<i2")
    if channels == 2:
        pcm = np.stack([pcm, pcm[::-1]], axis=1).reshape(-1)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


def mels(cfg, n=3, seed=5):
    """Seeded log-mels: noise, a tone and a chirp (one 30 s window each)."""
    rng = np.random.default_rng(seed)
    t = np.arange(16000 * 3) / 16000
    pcms = [rng.normal(size=t.size) * 0.2, np.sin(2 * np.pi * 300 * t) * 0.5,
            np.sin(2 * np.pi * (200 + 600 * t) * t) * 0.4]
    return np.stack([ref.log_mel_spectrogram(p.astype(np.float32), cfg.n_mels) for p in pcms[:n]])


def cosines(a, b):
    return np.sum(a * b, axis=-1) / np.maximum(
        np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1), 1e-30)


# The JAX functions jitted once (eager, each op compiles on first use).
_ref_encode = jax.jit(ref.encode_audio, static_argnums=1)
_ref_logits = jax.jit(ref._decoder_logits, static_argnums=1)
_ref_step = jax.jit(ref._decode_step, static_argnames=("cfg", "max_tokens"))


def teacher_forced(rcfg, cfg, jparams, params, mel, tokens):
    """Both packages' incremental steps over the same token rows (B, L):
    logits (B, L - 1, vocab) at positions 0..L-2 (each deciding the next
    token), each package from its own encoder on ``mel``."""
    b, length = tokens.shape
    feats = _ref_encode(jparams, rcfg, jnp.asarray(mel))
    ck, cv = ref._cross_kv(jparams, rcfg, feats)
    sk = jnp.zeros((rcfg.n_text_layers, b, length, rcfg.n_text_state), jnp.bfloat16)
    sv = jnp.zeros_like(sk)
    want = []
    for i in range(length - 1):
        logits, sk, sv = _ref_step(jparams, rcfg, jnp.asarray(tokens[:, i]), jnp.asarray(i),
                                   sk, sv, ck, cv, length)
        want.append(np.asarray(logits))
    return port_steps(cfg, params, mel, tokens), np.stack(want, axis=1)


@torch.inference_mode()
def port_steps(cfg, params, mel, tokens):
    """The port's incremental step over token rows (B, L), from its own
    encoder on ``mel``: logits (B, L - 1, vocab)."""
    b, length = tokens.shape
    feats = whisper.encode_audio(params, cfg, torch.from_numpy(mel))
    ck, cv = whisper._cross_heads(params, cfg, feats)
    sk = torch.zeros((cfg.n_text_layers, b, length, cfg.n_text_state), dtype=torch.bfloat16)
    sv = torch.zeros_like(sk)
    tokens = torch.from_numpy(np.array(tokens))
    return np.stack([whisper._decode_step(params, cfg, tokens[:, i], i, sk, sv, ck, cv, length)
                     .numpy() for i in range(length - 1)], axis=1)


def margins(logits):
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


def check_teacher_forced(got, want, tokens, p_len, eot):
    """cosine ≥ COS_FLOOR a position and the argmax rule; returns (max abs
    error, first position of each row whose JAX margin is below twice it,
    or the row's length)."""
    cos = cosines(got, want)
    assert cos.min() >= COS_FLOOR, cos.min()
    err = float(np.abs(got - want).max())
    assert err <= 2e-2 * float(np.abs(want).max())
    margin = margins(want)
    decided = margin > 2 * err
    assert (np.argmax(got, -1) == np.argmax(want, -1))[decided].all()
    first = []
    for row, tok in zip(margin, tokens):
        live = np.flatnonzero(tok == eot)
        end = live[0] if live.size else tok.size - 1  # positions past EOT decide nothing
        low = np.flatnonzero(row[p_len - 1 : end] <= 2 * err)
        first.append(p_len - 1 + (low[0] if low.size else end - p_len + 1))
    return err, first


def same_up_to_split(got_tokens, want_tokens, first):
    """Free-running rows equal through each row's first low-margin position
    (the token that position decides may split)."""
    for g, w, f in zip(got_tokens, want_tokens, first):
        np.testing.assert_array_equal(g[: f + 1], w[: f + 1])


# ---------------------------------------------------------------------------
# Host copies and the encoder
# ---------------------------------------------------------------------------


def test_configs_and_host_mel_are_the_reference_s():
    for name, rcfg in ref.CONFIGS.items():
        assert dataclasses.asdict(whisper.CONFIGS[name]) == dataclasses.asdict(rcfg)
        assert whisper.CONFIGS[name].language_base == rcfg.language_base
    assert whisper.LANGUAGES == ref.LANGUAGES
    pcm = np.random.default_rng(1).normal(size=40_000).astype(np.float32) * 0.1
    for n_mels in (16, 80):
        np.testing.assert_array_equal(whisper.mel_filterbank(n_mels), ref.mel_filterbank(n_mels))
        np.testing.assert_array_equal(whisper.log_mel_spectrogram(pcm, n_mels),
                                      ref.log_mel_spectrogram(pcm, n_mels))


@pytest.mark.parametrize("kw", [{}, {"rate": 44100, "channels": 2}, {"width": 1},
                                {"width": 4, "rate": 8000}])
def test_decode_wav_is_the_reference_s(kw):
    payload = make_wav(seconds=0.7, noise=0.05, **kw)
    np.testing.assert_array_equal(impls.decode_wav(payload), ref_impls.decode_wav(payload))


def test_decode_wav_rejects_what_the_reference_rejects():
    for payload in (b"not a wav", make_wav()[:30]):
        with pytest.raises(ref_impls.SlotError) as want:
            ref_impls.decode_wav(payload)
        with pytest.raises(impls.SlotError) as got:
            impls.decode_wav(payload)
        assert got.value.to_slot() == want.value.to_slot()


def test_encoder_features_match(model):
    rcfg, cfg, jparams, params = model
    mel = mels(cfg)
    want = np.asarray(_ref_encode(jparams, rcfg, jnp.asarray(mel)))
    with torch.inference_mode():
        got = whisper.encode_audio(params, cfg, torch.from_numpy(mel)).numpy()
    assert got.shape == want.shape == (3, cfg.n_audio_ctx, cfg.n_audio_state)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    assert cosines(got, want).min() >= COS_FLOOR
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()
    # Fewer frames than a 30 s window: the convolutions' padding and the crop.
    short = mel[:, :, :64]
    want = np.asarray(_ref_encode(jparams, rcfg, jnp.asarray(short)))
    with torch.inference_mode():
        got = whisper.encode_audio(params, cfg, torch.from_numpy(short)).numpy()
    assert got.shape == want.shape and cosines(got, want).min() >= COS_FLOOR


def test_detect_language_matches(model):
    rcfg, cfg, jparams, params = model
    mel = mels(cfg)
    want_idx, want_conf = (np.asarray(t) for t in ref.detect_language(jparams, rcfg, mel))
    got_idx, got_conf = (t.numpy() for t in whisper.detect_language(params, cfg, torch.from_numpy(mel)))
    assert got_idx.dtype == np.int32 and ((got_idx >= 0) & (got_idx < cfg.n_langs)).all()
    np.testing.assert_allclose(got_conf[got_idx == want_idx], want_conf[got_idx == want_idx],
                               rtol=0, atol=PROB_ATOL)
    # The probe's own probabilities, to see the margin of each decision.
    feats = _ref_encode(jparams, rcfg, jnp.asarray(mel))
    logits = np.asarray(_ref_logits(jparams, rcfg, jnp.full((3, 1), rcfg.sot), feats, None))
    probs = np.asarray(jax.nn.softmax(logits[:, 0, rcfg.language_base:][:, : rcfg.n_langs]))
    decided = margins(probs) > 2 * PROB_ATOL
    assert (got_idx == want_idx)[decided].all()


# ---------------------------------------------------------------------------
# The decoder
# ---------------------------------------------------------------------------


def test_teacher_forced_logits_and_free_running_tokens(model):
    rcfg, cfg, jparams, params = model
    mel = mels(cfg)
    idx, _ = ref.detect_language(jparams, rcfg, mel)
    lang = (rcfg.language_base + np.asarray(idx)).astype(np.int32)
    want_tokens, want_len, want_lp = (np.asarray(t) for t in ref.greedy_decode(
        jparams, rcfg, mel, max_tokens=16, lang_tokens=lang))
    got, want = teacher_forced(rcfg, cfg, jparams, params, mel, want_tokens)
    err, first = check_teacher_forced(got, want, want_tokens, 4, cfg.eot)
    got_tokens, got_len, got_lp = (t.numpy() for t in whisper.greedy_decode(
        params, cfg, torch.from_numpy(mel), max_tokens=16, lang_tokens=torch.from_numpy(lang)))
    assert got_tokens.shape == (3, 16) and got_tokens.dtype == np.int32
    np.testing.assert_array_equal(got_tokens[:, :4], want_tokens[:, :4])
    same_up_to_split(got_tokens, want_tokens, first)
    for j in range(3):
        if np.array_equal(got_tokens[j], want_tokens[j]):
            assert got_len[j] == want_len[j]
            np.testing.assert_allclose(np.exp(got_lp[j]), np.exp(want_lp[j]), rtol=CONF_RTOL)


def test_cached_decode_matches_the_rerun_oracle(model):
    # The incremental decode against the port's full-prefix oracle: the
    # step's logits against _decoder_logits (B3's plain version) on the same
    # tokens, then the free-running rule.
    _, cfg, _, params = model
    mel = torch.from_numpy(mels(cfg))
    got = whisper.greedy_decode(params, cfg, mel, max_tokens=12)
    want = whisper._greedy_decode_rerun(params, cfg, mel, max_tokens=12)
    tokens = want[0]
    with torch.inference_mode():
        feats = whisper.encode_audio(params, cfg, mel)
        full = whisper._decoder_logits(params, cfg, tokens, feats, None)[:, :-1].numpy()
        ck, cv = whisper._cross_heads(params, cfg, feats)
        sk = torch.zeros((cfg.n_text_layers, 3, 12, cfg.n_text_state), dtype=torch.bfloat16)
        sv = torch.zeros_like(sk)
        step = np.stack([whisper._decode_step(params, cfg, tokens[:, i], i, sk, sv, ck, cv, 12)
                         .numpy() for i in range(11)], axis=1)
    _, first = check_teacher_forced(step, full, tokens.numpy(), 3, cfg.eot)
    same_up_to_split(got[0].numpy(), tokens.numpy(), first)
    np.testing.assert_array_equal(got[0][:, :3].numpy(), [[cfg.sot, cfg.transcribe,
                                                           cfg.no_timestamps]] * 3)


def test_eot_latches_and_the_logprob_counts_generated_tokens(model):
    # EOT set to a token the decode reaches (row 0's first generated token,
    # then its third): a row stops there, later positions stay EOT (those
    # after the step where every row is done stay unwritten, 0, as in the
    # reference), its length is the first EOT's position, and its avg
    # logprob is the mean
    # over the generated tokens before it (0 with none), recomputed from the
    # step's own logits. The same config through the JAX decode gives the
    # same rows up to a split.
    rcfg, cfg, jparams, params = model
    mel = mels(cfg)
    tokens = whisper.greedy_decode(params, cfg, torch.from_numpy(mel), max_tokens=12)[0].numpy()
    for eot in (int(tokens[0, 3]), int(tokens[0, 5])):
        rcfg2, cfg2 = dataclasses.replace(rcfg, eot=eot), dataclasses.replace(cfg, eot=eot)
        got_t, got_len, got_lp = (t.numpy() for t in whisper.greedy_decode(
            params, cfg2, torch.from_numpy(mel), max_tokens=12))
        logp = torch.log_softmax(torch.from_numpy(port_steps(cfg2, params, mel, got_t)),
                                 dim=-1).numpy()
        for j, row in enumerate(got_t):
            hits = np.flatnonzero(row == eot)
            stop = hits[0] if hits.size else row.size
            assert np.isin(row[stop:], (eot, 0)).all() and got_len[j] == stop
            assert (np.diff((row[stop:] == 0).astype(int)) >= 0).all()
            gen = [logp[j, i - 1, row[i]] for i in range(3, stop)]
            np.testing.assert_allclose(got_lp[j], np.mean(gen) if gen else 0.0, rtol=1e-6,
                                       atol=1e-6)
        first_hit = 3 + list(tokens[0, 3:]).index(eot)
        assert got_len[0] == first_hit and (first_hit == 3) == (got_lp[0] == 0.0)
        want_t = np.asarray(ref.greedy_decode(jparams, rcfg2, mel, max_tokens=12)[0])
        tf_got, tf_want = teacher_forced(rcfg2, cfg2, jparams, params, mel, want_t)
        _, first = check_teacher_forced(tf_got, tf_want, want_t, 3, eot)
        same_up_to_split(got_t, want_t, first)


def test_prompt_longer_than_the_cache_raises(model):
    _, cfg, _, params = model
    feats = torch.zeros((1, cfg.n_audio_ctx, cfg.n_audio_state))
    with pytest.raises(ValueError, match="must be < max_tokens"):
        whisper.decode_from_feats(params, cfg, feats, whisper.prompt_tokens(cfg, 1, [105]), 4)


# ---------------------------------------------------------------------------
# WhisperImpl
# ---------------------------------------------------------------------------


def impl_pair(jparams, max_tokens=10):
    ref_impl = ref_impls.WhisperImpl("test-tiny", max_tokens=max_tokens)
    ref_impl.params = jparams
    port = impls.WhisperImpl("test-tiny", max_tokens=max_tokens, device="cpu")
    port.params = port_tree(jparams)
    return ref_impl, port


def token_rows(outputs, langs, cfg, length):
    """The full token rows behind predict()'s texts: the prompt, the text's
    ids, then EOT."""
    rows = np.full((len(outputs), length), cfg.eot, np.int32)
    for j, (out, lang) in enumerate(zip(outputs, langs)):
        ids = [int(t.strip("<>")) for t in out["text"].split()]
        rows[j, : 4 + len(ids)] = [cfg.sot, cfg.language_base + lang, cfg.transcribe,
                                   cfg.no_timestamps, *ids]
    return rows


def test_whisper_impl_matches_the_jax_impl():
    rcfg, cfg = configs("test-tiny")
    jparams = ref.init_params(jax.random.key(7), rcfg)
    ref_impl, port = impl_pair(jparams)
    payloads = [make_wav(freq=440.0), make_wav(seconds=2.0, rate=44100, channels=2, freq=1500.0),
                b"not a wav", None, make_wav(seconds=0.5, noise=0.3, seed=2)]
    inputs = [PredictionInput(file=p) if p is not None else PredictionInput(data={"x": 1})
              for p in payloads]
    ref_inputs = [ref_impls.PredictionInput(file=i.file, data=i.data) for i in inputs]
    got, want = port.predict(inputs), ref_impl.predict(ref_inputs)
    for j in (2, 3):
        assert is_error_slot(got[j]) and got[j] == want[j]
    kept = [0, 1, 4]
    for j in kept:
        assert got[j].keys() == want[j].keys() == {"text", "language", "language_confidence",
                                                   "confidence"}
        assert got[j]["language"] in whisper.LANGUAGES[: cfg.n_langs]
        assert 0 < got[j]["language_confidence"] <= 1 and 0 < got[j]["confidence"] <= 1
        assert abs(got[j]["language_confidence"] - want[j]["language_confidence"]) <= PROB_ATOL
    assert [got[j]["language"] for j in kept] == [want[j]["language"] for j in kept]
    # The texts by the free-running rule, against the JAX tokens' margins.
    mel = np.stack([ref.log_mel_spectrogram(ref_impls.decode_wav(payloads[j]), rcfg.n_mels)
                    for j in kept])
    langs = [whisper.LANGUAGES.index(want[j]["language"]) for j in kept]
    want_rows = token_rows([want[j] for j in kept], langs, cfg, 10)
    got_rows = token_rows([got[j] for j in kept], langs, cfg, 10)
    tf_got, tf_want = teacher_forced(rcfg, cfg, jparams, port.params, mel, want_rows)
    _, first = check_teacher_forced(tf_got, tf_want, want_rows, 4, cfg.eot)
    same_up_to_split(got_rows, want_rows, first)
    for j, g, w in zip(kept, got_rows, want_rows):
        if np.array_equal(g, w):
            assert got[j]["text"] == want[j]["text"]
            np.testing.assert_allclose(got[j]["confidence"], want[j]["confidence"], rtol=CONF_RTOL)


def test_predict_encodes_once_and_equals_the_two_encode_form(monkeypatch):
    rcfg, cfg = configs("test-tiny")
    _, port = impl_pair(ref.init_params(jax.random.key(8), rcfg))
    payloads = [make_wav(freq=300.0), make_wav(seconds=1.5, freq=2000.0, noise=0.1)]
    calls = []
    encode = whisper.encode_audio
    monkeypatch.setattr(whisper, "encode_audio",
                        lambda *a: calls.append(a[2].shape) or encode(*a))
    got = port.predict([PredictionInput(file=p) for p in payloads])
    assert calls == [(2, cfg.n_mels, 3000)]
    mel = torch.from_numpy(np.stack([whisper.log_mel_spectrogram(impls.decode_wav(p), cfg.n_mels)
                                     for p in payloads]))
    idx, conf = whisper.detect_language(port.params, cfg, mel)
    tokens, lengths, lp = whisper.greedy_decode(port.params, cfg, mel, max_tokens=10,
                                                lang_tokens=cfg.language_base + idx)
    for j, out in enumerate(got):
        assert out["language"] == whisper.LANGUAGES[int(idx[j])]
        assert out["language_confidence"] == float(conf[j])
        assert out["text"] == " ".join(f"<{t}>" for t in tokens[j, 4: lengths[j]].tolist())
        assert out["confidence"] == float(np.exp(lp[j].numpy()))


def test_load_is_seeded_and_prompt_layout():
    a = impls.WhisperImpl("test-tiny", device="cpu")
    b = impls.WhisperImpl("test-tiny", device="cpu")
    a.load()
    b.load()
    assert torch.equal(a.params["decoder"]["token_emb"], b.params["decoder"]["token_emb"])
    assert a.params["encoder"]["blocks"][0]["attn"]["qkv_w"].dtype == torch.bfloat16
    assert a.params["decoder"]["token_emb"].dtype == torch.float32
    cfg = a.cfg
    assert whisper.prompt_tokens(cfg, 2).tolist() == [[100, 102, 103]] * 2
    assert whisper.prompt_tokens(cfg, 2, [104, 107]).tolist() == [[100, 104, 102, 103],
                                                                 [100, 107, 102, 103]]
    a.unload()
    assert a.params is None


def test_trained_language_probe_reports_the_jax_languages():
    # tests/test_whisper.py's recipe: the test-tiny language head trained
    # (optax) until a 200 Hz tone reads "de" and a 3 kHz tone "en"; the
    # trained parameters carried over, the port's impl reports the same
    # languages, with confidences within PROB_ATOL of the JAX impl's.
    optax = pytest.importorskip("optax")
    rcfg = ref.CONFIGS["test-tiny"]
    ref_impl = ref_impls.WhisperImpl(model_arch="test-tiny", max_tokens=8)
    ref_impl.load()

    def mel_of(freq):
        t = np.linspace(0, 1.0, 16000, endpoint=False)
        return ref.log_mel_spectrogram((np.sin(2 * np.pi * freq * t) * 0.5).astype(np.float32),
                                       rcfg.n_mels)

    train = np.stack([mel_of(200.0), mel_of(3000.0)])
    targets = jnp.array([2, 0], dtype=jnp.int32)

    def loss_fn(params):
        feats = ref.encode_audio(params, rcfg, train)
        logits = ref._decoder_logits(params, rcfg, jnp.full((2, 1), rcfg.sot, jnp.int32), feats,
                                     None)[:, 0]
        lang = jax.lax.dynamic_slice_in_dim(logits, rcfg.language_base, rcfg.n_langs, axis=-1)
        logp = jax.nn.log_softmax(lang, axis=-1)
        return -jnp.take_along_axis(logp, targets[:, None], axis=1).mean()

    tx = optax.adam(3e-3)

    @jax.jit
    def step(params, opt):
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt = tx.update(grads, opt)
        return optax.apply_updates(params, updates), opt, loss

    params, opt = ref_impl.params, tx.init(ref_impl.params)
    for _ in range(150):
        params, opt, loss = step(params, opt)
    assert float(loss) < 0.1
    ref_impl.params = params
    port = impls.WhisperImpl("test-tiny", max_tokens=8, device="cpu")
    port.params = port_tree(params)
    for freq, lang in ((200.0, "de"), (3000.0, "en")):
        wav = make_wav(freq=freq)
        want = ref_impl.predict([ref_impls.PredictionInput(file=wav)])[0]
        got = port.predict([PredictionInput(file=wav)])[0]
        assert got["language"] == want["language"] == lang
        assert abs(got["language_confidence"] - want["language_confidence"]) <= PROB_ATOL
        assert 0.5 < got["language_confidence"] < 1.0


# ---------------------------------------------------------------------------
# Checkpoints and the registry
# ---------------------------------------------------------------------------


def _equal_trees(a, b):
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _equal_trees(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return isinstance(b, list) and len(a) == len(b) and all(
            _equal_trees(x, y) for x, y in zip(a, b))
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def test_params_from_jax_carries_the_audio_trees():
    # Whisper's and the audio tower's trees: dicts of lists of blocks, every
    # leaf the same shape and values, f32 on the named device.
    from panoptikon_tpu.models import audio as ref_audio

    for tree in (ref.init_params(jax.random.key(1), ref.CONFIGS["test-tiny"]),
                 ref_audio.init_params(jax.random.key(2), ref_audio.CONFIGS["test-tiny"])):
        host = jax.tree.map(np.asarray, tree)
        got = convert.params_from_jax(host, device="cpu")
        leaves, treedef = jax.tree.flatten(host)
        got_leaves, got_def = jax.tree.flatten(got)
        assert got_def == treedef and len(got_leaves) == len(leaves) > 10
        for g, w in zip(got_leaves, leaves):
            assert g.dtype == torch.float32 and g.device.type == "cpu"
            np.testing.assert_array_equal(g.numpy(), w)


def test_whisper_checkpoint_loads_the_reference_tree(tmp_path):
    rcfg = ref.CONFIGS["test-tiny"]
    tree = jax.tree.map(np.asarray, ref.init_params(jax.random.key(9), rcfg))
    # Random biases, so that every leaf of the mapping is exercised.
    rng = np.random.default_rng(3)
    tree = jax.tree.map(lambda a: a + rng.normal(size=a.shape).astype(np.float32) * 0.01, tree)
    ref_weights.save_whisper_checkpoint(tree, tmp_path / "model.safetensors")
    weights.save_whisper_checkpoint(tree, tmp_path / "pytorch_model.bin")
    cfg = whisper.CONFIGS["test-tiny"]
    for name in ("model.safetensors", "pytorch_model.bin"):
        got = weights.load_whisper_checkpoint(tmp_path / name, cfg)
        want = ref_weights.load_whisper_checkpoint(tmp_path / name, rcfg)
        assert _equal_trees(got, want) and _equal_trees(got, tree), name
    # HF's layout: no k_proj biases, the "model." prefix; both loaders
    # zero-fill the biases alike.
    sd = torch.load(tmp_path / "pytorch_model.bin", weights_only=True)
    hf = {f"model.{k}": v for k, v in sd.items() if not k.endswith("k_proj.bias")}
    torch.save(hf, tmp_path / "hf.bin")
    got = weights.load_whisper_checkpoint(tmp_path / "hf.bin", cfg)
    assert _equal_trees(got, ref_weights.load_whisper_checkpoint(tmp_path / "hf.bin", rcfg))
    w = cfg.n_text_state
    assert not got["decoder"]["blocks"][0]["cross"]["kv_b"][:w].any()
    assert not got["encoder"]["blocks"][1]["attn"]["qkv_b"][w: 2 * w].any()
    # The impl on the checkpoint embeds as the impl given the tree.
    loaded = impls.WhisperImpl("test-tiny", checkpoint=str(tmp_path / "pytorch_model.bin"),
                               max_tokens=8, device="cpu")
    direct = impls.WhisperImpl("test-tiny", max_tokens=8, device="cpu")
    direct.params = whisper.bf16_linears(convert.params_from_jax(tree, device="cpu"))
    inputs = [PredictionInput(file=make_wav(freq=700.0))]
    assert loaded.predict(inputs) == direct.predict(inputs)


def test_manager_loads_whisper_tiny_by_registry_id(monkeypatch):
    from panoptikon_tpu_torch.models.manager import ModelManager
    from panoptikon_tpu_torch.models.registry import Registry

    registry = Registry(None)
    rid = registry.resolve("whisper", "whisper-tiny")
    assert impls.IMPL_INDEX[rid.impl_class] is impls.WhisperImpl
    assert registry.group_metadata("whisper")["output_type"] == "text"
    monkeypatch.setattr(rid, "config", {**rid.config, "device": "cpu"})
    manager = ModelManager(registry, impls.IMPL_INDEX)
    try:
        manager.load_model("whisper/whisper-tiny")
        entry = manager._models["whisper/whisper-tiny"]
        assert isinstance(entry.model, impls.WhisperImpl) and entry.default_batch == 4
        assert entry.model.cfg == whisper.CONFIGS["whisper-tiny"] and entry.model.max_tokens == 64
        assert entry.model.device.type == "cpu"
        emb = entry.model.params["decoder"]["token_emb"]
        assert tuple(emb.shape) == (51865, 384) and emb.dtype == torch.float32
    finally:
        manager.shutdown()
