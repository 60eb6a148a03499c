"""The port's OCR (``models/ocr.py``, ``OcrImpl``) against the JAX package's,
on the CPU, where B3's plain version stands in for the kernel: the same
seeded strips and pages, the JAX tree carried over by ``models.convert``.

Tolerances, as ``tests/test_torch_whisper.py`` sets them for bf16 towers
(off the TPU the JAX ``attention`` is XLA's, the port's plain version rounds
p to bf16 as the kernel does):

- strip features and CTC logits: cosine ≥ 0.999 a token, max abs ≤ 2e-2 ×
  max |ref|; the CTC ids equal wherever the JAX top-2 margin exceeds twice
  the observed logit error; confidences within 1e-2;
- the attention reader: its decoder steps teacher-forced on the JAX
  decode's tokens at cosine ≥ 0.999 a position, the argmax rule above, and
  free-running tokens equal up to the first position whose JAX margin is
  below it (two implementations may split at a near-tie, so no test
  requires more);
- trained checkpoints (the reference's own recipe, ``tests/test_ocr.py``,
  copied here with its steps cut to 100, where its loss bars still hold):
  both packages' impls read every rendered digit string exactly.
"""

import dataclasses
import functools
import io
import pickle
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from panoptikon_tpu.models import impls as ref_impls
from panoptikon_tpu.models import ocr as ref
from panoptikon_tpu.models import whisper as ref_whisper
from panoptikon_tpu.models.base import PredictionInput as RefInput
from panoptikon_tpu_torch.models import convert, impls, ocr, whisper
from panoptikon_tpu_torch.models.base import PredictionInput

from test_torch_whisper import check_teacher_forced, cosines, margins, same_up_to_split

COS_FLOOR = 0.999
CONF_ATOL = 1e-2
TRAIN_STEPS = 100
SAMPLES = ["0123", "4567", "89", "31415", "2718", "909", "112358", "777"]
ATTN_SAMPLES = SAMPLES[:6]
GLYPHS = {
    "0": ["111", "101", "101", "101", "111"],
    "1": ["010", "110", "010", "010", "111"],
    "2": ["111", "001", "111", "100", "111"],
    "3": ["111", "001", "111", "001", "111"],
    "4": ["101", "101", "111", "001", "001"],
    "5": ["111", "100", "111", "001", "111"],
    "6": ["111", "100", "111", "101", "111"],
    "7": ["111", "001", "010", "010", "010"],
    "8": ["111", "101", "111", "101", "111"],
    "9": ["111", "101", "111", "001", "111"],
}


# ---------------------------------------------------------------------------
# Rendered digits (tests/test_ocr.py's 3 × 5 bitmap font and recipe)
# ---------------------------------------------------------------------------


def render_digits(text: str, *, scale=2, pad=3) -> np.ndarray:
    """A digit string as uint8 grayscale, dark ink on light."""
    h = 5 * scale + 2 * pad
    cols = [np.kron(np.array([[int(c) for c in row] for row in GLYPHS[ch]], np.uint8),
                    np.ones((scale, scale), np.uint8)) for ch in text]
    total_w = sum(c.shape[1] for c in cols) + pad * (len(cols) + 1)
    img = np.zeros((h, total_w), np.uint8)
    x = pad
    for c in cols:
        img[pad : pad + c.shape[0], x : x + c.shape[1]] = c
        x += c.shape[1] + pad
    return 255 - img * 255


def labels_for(text: str, cfg, max_len=12):
    lab = np.zeros((max_len,), np.int32)
    for i, ch in enumerate(text):
        lab[i] = cfg.charset.index(ch) + 1
    return lab, len(text)


def page(lines, width=None, gap=10, **kw) -> np.ndarray:
    """Rendered lines stacked top to bottom on a light page, ``gap`` rows
    apart."""
    rows = [render_digits(t, **kw) for t in lines]
    width = width or max(r.shape[1] for r in rows)
    out = []
    for r in rows:
        line = np.full((r.shape[0], width), 255, np.uint8)
        line[:, : r.shape[1]] = r
        out += [line, np.full((gap, width), 255, np.uint8)]
    return np.concatenate(out)


def png(gray: np.ndarray) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(gray).save(buf, format="PNG")
    return buf.getvalue()


def strip_of(text, cfg, **kw):
    img = render_digits(text, **kw)
    return ref.prepare_strip(img, ref.segment_lines(img)[0], cfg)


def seeded_texts(n, seed, lo=2, hi=9):
    rng = np.random.default_rng(seed)
    return ["".join(str(d) for d in rng.integers(0, 10, size=rng.integers(lo, hi)))
            for _ in range(n)]


def _train(loss, params, strips, labels, lengths, steps=TRAIN_STEPS):
    tx = optax.adam(2e-3)
    opt = tx.init(params)

    @jax.jit
    def step(params, opt):
        value, grads = jax.value_and_grad(loss)(params, strips, labels, lengths)
        updates, opt = tx.update(grads, opt)
        return optax.apply_updates(params, updates), opt, value

    value = None
    for _ in range(steps):
        params, opt, value = step(params, opt)
    return params, float(value)


@functools.lru_cache(maxsize=None)
def trained(kind: str):
    """The tiny recognizer of ``kind`` ("ctc" or "attn") overfit on rendered
    digit strings as tests/test_ocr.py trains it: (NumPy params, samples)."""
    if kind == "ctc":
        cfg, samples = ref.CONFIGS["test-tiny"], SAMPLES
        params = ref.init_params(jax.random.key(0), cfg)
        loss = functools.partial(ref.ctc_loss, cfg=cfg)
        bar = 0.5
    else:
        acfg, samples = ref.ATTN_CONFIGS["test-tiny"], ATTN_SAMPLES
        cfg = acfg.enc
        params = ref.init_attn_params(jax.random.key(3), acfg)
        loss = functools.partial(ref.attn_loss, cfg=acfg)
        bar = 0.2
    strips = np.stack([strip_of(s, cfg) for s in samples])
    labels = np.stack([labels_for(s, cfg)[0] for s in samples])
    lengths = np.array([labels_for(s, cfg)[1] for s in samples], np.int32)
    params, value = _train(lambda p, x, y, n: loss(p, strips=x, labels=y, label_lengths=n),
                           params, strips, labels, lengths)
    assert value < bar, f"{kind} failed to converge: {value}"
    return jax.device_get(params), samples


@pytest.fixture(scope="module", params=["ctc", "attn"])
def checkpoint(request, tmp_path_factory):
    params, samples = trained(request.param)
    path = tmp_path_factory.mktemp("ocr") / f"{request.param}.pkl"
    with open(path, "wb") as f:
        pickle.dump(params, f)
    return request.param, str(path), samples


def port_tree(jparams):
    return ocr.bf16_linears(convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                                    device="cpu"))


# ---------------------------------------------------------------------------
# The strip encoder and the CTC recognizer
# ---------------------------------------------------------------------------


def ctc_configs(name):
    # "d64": crnn-base's width, heads and 32 × 512 strips (128 tokens, D 64:
    # the tensor-core route on the card) with one layer.
    rcfg = ref.CONFIGS["test-tiny"] if name == "test-tiny" else dataclasses.replace(
        ref.CONFIGS["crnn-base"], layers=1)
    return rcfg, ocr.OcrConfig(**dataclasses.asdict(rcfg))


_ref_encode = jax.jit(ref.encode_strips, static_argnums=1)


@functools.partial(jax.jit, static_argnums=1)
def _ref_ctc(params, cfg, strips):
    """The JAX strip features, CTC logits and ``recognize_jit``'s (ids,
    confidence), traced as one program (one compile a shape)."""
    return (ref.encode_strips(params, cfg, strips), ref.logits(params, cfg, strips),
            *ref.recognize_jit(params, cfg, strips))


@pytest.mark.parametrize("name", ["test-tiny", "d64"])
def test_strip_features_logits_and_greedy_ctc_match(name):
    rcfg, cfg = ctc_configs(name)
    jparams = ref.init_params(jax.random.key(5), rcfg)
    params = port_tree(jparams)
    rng = np.random.default_rng(6)
    strips = np.stack([strip_of(t, rcfg) for t in seeded_texts(4, 7)]
                      + [rng.random((rcfg.height, rcfg.max_width), dtype=np.float32)])
    x = torch.from_numpy(strips)
    want, want_logits, want_ids, want_conf = (np.asarray(t) for t in _ref_ctc(
        jparams, rcfg, strips))
    want = want.astype(np.float32)
    with torch.inference_mode():
        got = ocr.encode_strips(params, cfg, x)
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == (5, cfg.tokens, cfg.width)
        got_logits = ocr.logits(params, cfg, x)
    got = got.float().numpy()
    assert cosines(got, want).min() >= COS_FLOOR
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()
    assert got_logits.dtype == torch.float32 and got_logits.shape == want_logits.shape
    got_logits = got_logits.numpy()
    assert cosines(got_logits, want_logits).min() >= COS_FLOOR
    err = float(np.abs(got_logits - want_logits).max())
    assert err <= 2e-2 * np.abs(want_logits).max()
    ids, conf = ocr.recognize(params, cfg, x)
    assert ids.shape == want_ids.shape and conf.dtype == torch.float32
    decided = margins(want_logits) > 2 * err
    assert decided.mean() > 0.5
    np.testing.assert_array_equal(ids.numpy()[decided], want_ids[decided])
    np.testing.assert_allclose(conf.numpy(), want_conf, rtol=0, atol=CONF_ATOL)


def test_configs_and_charsets_are_the_reference_s():
    for name, rcfg in ref.CONFIGS.items():
        assert dataclasses.asdict(ocr.CONFIGS[name]) == dataclasses.asdict(rcfg)
        assert (ocr.CONFIGS[name].tokens, ocr.CONFIGS[name].classes) == (rcfg.tokens, rcfg.classes)
    for name, rcfg in ref.ATTN_CONFIGS.items():
        cfg = ocr.ATTN_CONFIGS[name]
        assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
        assert dataclasses.asdict(cfg.decoder_cfg()) == dataclasses.asdict(rcfg.decoder_cfg())
        assert isinstance(cfg.decoder_cfg(), whisper.WhisperConfig)
    base = ocr.ATTN_CONFIGS["attn-base"]
    # The registry's readers: 4 heads of 64 in the trunk and the decoder.
    assert (base.enc.width // base.enc.heads, base.enc.tokens, base.max_chars) == (64, 128, 64)


def test_init_shapes_are_the_reference_s():
    for name, rcfg in ref.ATTN_CONFIGS.items():
        want = jax.eval_shape(lambda: ref.init_attn_params(jax.random.key(0), rcfg))
        got = ocr.init_attn_params(ocr.ATTN_CONFIGS[name], torch.Generator().manual_seed(0))
        assert jax.tree.map(lambda a: tuple(a.shape), got) == \
            jax.tree.map(lambda a: tuple(a.shape), want)
    a = ocr.init_params(ocr.CONFIGS["test-tiny"], torch.Generator().manual_seed(1))
    b = ocr.init_params(ocr.CONFIGS["test-tiny"], torch.Generator().manual_seed(1))
    assert torch.equal(a["patch_w"], b["patch_w"])


# ---------------------------------------------------------------------------
# The attention recognizer
# ---------------------------------------------------------------------------


def attn_configs(name):
    if name == "test-tiny":
        rcfg = ref.ATTN_CONFIGS["test-tiny"]
    else:  # attn-base's trunk and decoder widths (D 64), one layer each
        rcfg = ref.AttnOcrConfig(enc=dataclasses.replace(ref.CONFIGS["crnn-base"], layers=1),
                                 max_chars=24, dec_layers=1, dec_heads=4)
    cfg = ocr.AttnOcrConfig(enc=ocr.OcrConfig(**dataclasses.asdict(rcfg.enc)),
                            max_chars=rcfg.max_chars, dec_layers=rcfg.dec_layers,
                            dec_heads=rcfg.dec_heads)
    return rcfg, cfg


_ref_step = jax.jit(ref_whisper._decode_step, static_argnames=("cfg", "max_tokens"))


def ref_teacher_forced(jparams, dcfg, feats, tokens):
    b, length = tokens.shape
    ck, cv = ref_whisper._cross_kv(jparams, dcfg, feats)
    sk = jnp.zeros((dcfg.n_text_layers, b, length, dcfg.n_text_state), jnp.bfloat16)
    sv = jnp.zeros_like(sk)
    out = []
    for i in range(length - 1):
        logits, sk, sv = _ref_step(jparams, dcfg, jnp.asarray(tokens[:, i]), jnp.asarray(i),
                                   sk, sv, ck, cv, length)
        out.append(np.asarray(logits))
    return np.stack(out, axis=1)


@torch.inference_mode()
def port_teacher_forced(params, dcfg, feats, tokens):
    b, length = tokens.shape
    ck, cv = whisper._cross_heads(params, dcfg, feats)
    sk = torch.zeros((dcfg.n_text_layers, b, length, dcfg.n_text_state), dtype=torch.bfloat16)
    sv = torch.zeros_like(sk)
    tokens = torch.from_numpy(np.array(tokens))
    return np.stack([whisper._decode_step(params, dcfg, tokens[:, i], i, sk, sv, ck, cv, length)
                     .numpy() for i in range(length - 1)], axis=1)


@pytest.mark.parametrize("name", ["test-tiny", "d64"])
def test_attn_read_teacher_forced_and_free_running(name):
    rcfg, cfg = attn_configs(name)
    jparams = ref.init_attn_params(jax.random.key(8), rcfg)
    params = port_tree(jparams)
    strips = np.stack([strip_of(t, rcfg.enc) for t in seeded_texts(4, 9)])
    want_tokens, want_len, want_conf = (np.asarray(t) for t in ref.attn_read_jit(
        jparams, rcfg, strips))
    jfeats = _ref_encode(jparams, rcfg.enc, strips)
    with torch.inference_mode():
        feats = ocr.encode_strips(params, cfg.enc, torch.from_numpy(strips))
    got = port_teacher_forced(params, cfg.decoder_cfg(), feats, want_tokens)
    want = ref_teacher_forced(jparams, rcfg.decoder_cfg(), jfeats, want_tokens)
    _, first = check_teacher_forced(got, want, want_tokens, 1, rcfg.eot)
    tokens, lengths, conf = (t.numpy() for t in ocr.attn_read(params, cfg, torch.from_numpy(strips)))
    assert tokens.shape == (4, cfg.max_chars) and tokens.dtype == np.int32
    assert (tokens[:, 0] == cfg.sot).all() and np.isfinite(conf).all()
    assert ((conf > 0) & (conf <= 1)).all()
    same_up_to_split(tokens, want_tokens, first)
    for j in range(4):
        if np.array_equal(tokens[j], want_tokens[j]):
            assert lengths[j] == want_len[j]
            assert ocr.attn_collapse(tokens[j], int(lengths[j]), cfg.enc.charset) == \
                ref.attn_collapse(want_tokens[j], int(want_len[j]), rcfg.enc.charset)
            np.testing.assert_allclose(conf[j], want_conf[j], rtol=2e-2)


# ---------------------------------------------------------------------------
# OcrImpl
# ---------------------------------------------------------------------------


def impl_pair(kind, ckpt, **kw):
    recognizer = {"recognizer": "attn"} if kind == "attn" else {}
    return (ref_impls.OcrImpl(model_arch="test-tiny", checkpoint=ckpt, **recognizer, **kw),
            impls.OcrImpl("test-tiny", checkpoint=ckpt, device="cpu", **recognizer, **kw))


def test_trained_checkpoints_read_the_digits_in_both_impls(checkpoint):
    kind, ckpt, samples = checkpoint
    jimpl, timpl = impl_pair(kind, ckpt)
    payloads = [png(render_digits(s)) for s in samples]
    want = jimpl.predict([RefInput(file=p) for p in payloads])
    got = timpl.predict([PredictionInput(file=p) for p in payloads])
    assert [o["text"] for o in want] == [o["text"] for o in got] == samples
    assert min(o["confidence"] for o in got) > 0.5
    timpl.load()
    assert timpl.params["blocks"][0]["attn"]["qkv_w"].dtype == torch.bfloat16
    assert timpl.params["ln_out"]["scale"].dtype == torch.float32


def test_predict_matches_the_jax_impl_on_png_pages(checkpoint):
    # Multi-line pages, a blank page and error slots through both impls'
    # predict on PNG bytes: equal slots, texts and languages, confidences
    # within CONF_ATOL; the port's predict is its decode and read_arrays.
    kind, ckpt, samples = checkpoint
    jimpl, timpl = impl_pair(kind, ckpt)
    pages = [page(samples[:3]), page(samples[3:5], gap=6), page(samples[5:6])]
    payloads = [png(p) for p in pages] + [png(np.full((30, 60), 255, np.uint8))]
    want = jimpl.predict([RefInput(file=p) for p in payloads] + [
        RefInput(data={"x": 1}), RefInput(file=b"not an image")])
    got = timpl.predict([PredictionInput(file=p) for p in payloads] + [
        PredictionInput(data={"x": 1}), PredictionInput(file=b"not an image")])
    assert got[-2] == want[-2] == {"__error__": {"class": "input",
                                                 "message": "OCR requires an image file"}}
    assert got[-1]["__error__"]["class"] == "input" and \
        got[-1]["__error__"]["message"].startswith("Undecodable image: ")
    # PIL's message names the payload's BytesIO by its address.
    assert re.sub("0x[0-9a-f]+", "", got[-1]["__error__"]["message"]) == \
        re.sub("0x[0-9a-f]+", "", want[-1]["__error__"]["message"])
    assert got[3] == want[3] == {"text": "", "confidence": 0.0, "language": None}
    for g, w in zip(got[:3], want[:3]):
        assert g["text"] == w["text"] and g["language"] is w["language"] is None
        assert abs(g["confidence"] - w["confidence"]) <= CONF_ATOL
    assert got[0]["text"] == "\n".join(samples[:3])
    assert timpl.read_arrays(pages) == got[:3]
    # The min_confidence filter: above every line, every page reads empty.
    _, strict = impl_pair(kind, ckpt, min_confidence=1.01)
    assert strict.predict([PredictionInput(file=p) for p in payloads[:2]]) == [
        {"text": "", "confidence": 0.0, "language": None}] * 2


def test_the_reference_fault_shape_returns_every_line(tmp_path):
    # One 200 × 240 page with 20 text lines at batch_cap 16: the JAX impl
    # pads every strip of the call as one batch and raises; the port reads
    # them in slices of 16 and 4 (each padded to its bucket), and its lines
    # equal the JAX recognize_jit fed the same slices, wherever every column
    # of a line is decided by a wide margin.
    params, _ = trained("ctc")
    rcfg = ref.CONFIGS["test-tiny"]
    # At least 5 digits a line: every glyph row holds ink in every digit, so
    # each of a line's 5 rows passes the 2 % projection threshold.
    texts = seeded_texts(20, 11, lo=5, hi=10)
    gray = page(texts, width=240, gap=3, scale=1, pad=1)
    assert gray.shape == (200, 240)
    boxes = ref.segment_lines(gray)
    assert len(boxes) == 20
    ckpt = tmp_path / "ocr.pkl"
    with open(ckpt, "wb") as f:
        pickle.dump(params, f)
    jimpl, timpl = impl_pair("ctc", str(ckpt), batch_cap=16)
    with pytest.raises(ValueError, match="exceeds bucket 16"):
        jimpl.predict([RefInput(file=png(gray))])
    lines = timpl.read_lines([gray])[0]
    assert timpl.predict([PredictionInput(file=png(gray))])[0]["text"] == "\n".join(
        t for t, _ in lines if t)
    assert len(lines) == 20
    strips = np.stack([ref.prepare_strip(gray, box, rcfg) for box in boxes])
    held = 0
    for lo, bucket in ((0, 16), (16, 4)):
        part = strips[lo : lo + 16]
        padded = np.concatenate([part, np.zeros((bucket - len(part), *part.shape[1:]), np.float32)])
        _, want_logits, ids, conf = (np.asarray(t)[: len(part)] for t in _ref_ctc(
            params, rcfg, padded))
        with torch.inference_mode():
            got_logits = ocr.logits(port_tree(params), ocr.CONFIGS["test-tiny"],
                                    torch.from_numpy(padded)).numpy()[: len(part)]
        err = float(np.abs(got_logits - want_logits).max())
        for j in range(len(part)):
            text, c = lines[lo + j]
            assert abs(c - float(conf[j])) <= CONF_ATOL
            if (margins(want_logits[j]) > 2 * err).all():
                assert text == ref.ctc_collapse(ids[j], rcfg.charset)
                held += 1
    assert held >= 8, held


def test_random_weights_are_seeded_and_the_device_is_the_card_by_default(monkeypatch):
    a = impls.OcrImpl("test-tiny", recognizer="attn", device="cpu")
    b = impls.OcrImpl("test-tiny", recognizer="attn", device="cpu")
    a.load()
    b.load()
    assert torch.equal(a.params["decoder"]["token_emb"], b.params["decoder"]["token_emb"])
    assert a.attn_cfg == ocr.ATTN_CONFIGS["test-tiny"] and a.cfg == ocr.CONFIGS["test-tiny"]
    assert impls.OcrImpl("nope", device="cpu").cfg == ocr.CONFIGS["crnn-base"]
    assert impls.OcrImpl.name() == ref_impls.OcrImpl.name() == "ocr"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        impls.OcrImpl("test-tiny")


@pytest.mark.parametrize("model_id", ["doctr/ocr-default", "doctr/ocr-attn"])
def test_manager_loads_the_registry_ocr_entries(model_id, monkeypatch):
    # The built-in registry's two OCR ids through the port's manager with
    # prewarm: crnn-base and attn-base (the registry's widths), on the CPU;
    # a blank page and a page of digits through manager.predict.
    from panoptikon_tpu_torch.models.manager import ModelManager
    from panoptikon_tpu_torch.models.registry import Registry

    registry = Registry(None)
    group, name = model_id.split("/")
    rid = registry.resolve(group, name)
    assert impls.IMPL_INDEX[rid.impl_class] is impls.OcrImpl
    monkeypatch.setattr(rid, "config", {**rid.config, "device": "cpu"})
    manager = ModelManager(registry, impls.IMPL_INDEX)
    try:
        manager.load_model(model_id, prewarm=True)
        entry = manager._models[model_id]
        impl = entry.model
        assert type(impl) is impls.OcrImpl and entry.default_batch == 16
        if name == "ocr-attn":
            assert impl.recognizer == "attn" and impl.attn_cfg == ocr.ATTN_CONFIGS["attn-base"]
        else:
            assert impl.recognizer == "ctc" and impl.cfg == ocr.CONFIGS["crnn-base"]
        out = manager.predict(model_id, [PredictionInput(file=png(np.full((20, 40), 255, np.uint8))),
                                         PredictionInput(file=png(page(["0123", "456"])))])
        assert out[0] == {"text": "", "confidence": 0.0, "language": None}
        assert set(out[1]) == {"text", "confidence", "language"} and 0 <= out[1]["confidence"] <= 1
    finally:
        manager.shutdown()
