"""The port's ClipImpl (models/impls.py) against the JAX package's ClipImpl
at test-tiny, bf16 and int8: the JAX instance's loaded parameters are
carried over, both predict on the same inputs (pre-decoded pixels, an
undecodable file, a wrong pixels shape, texts and an unknown input), and
the outputs are compared slot by slot — embeddings under the repo's cosine
gates, error slots exactly. With int8 each side calibrates on its own first
image and text batch; the scales must agree to 2 %."""

import io

import jax
import numpy as np
import pytest
import torch

from panoptikon_tpu.models import impls as ref
from panoptikon_tpu.models.base import PredictionInput
from panoptikon_tpu.utils import npy
from panoptikon_tpu_torch.models import convert, impls

from test_torch_clip import _cos

TEXTS = ["a red image", "two dogs on a beach at night", "x"]


def _inputs(seed, n_images=5):
    """n_images pixel inputs, an undecodable file, a wrong pixels shape, the
    texts and an unknown input, in that order."""
    rng = np.random.default_rng(seed)
    size = impls.clip.CONFIGS["test-tiny"].image_size
    pixels = [rng.normal(size=(size, size, 3)).astype(np.float32) for _ in range(n_images)]
    inputs = [PredictionInput(data={"pixels": p}) for p in pixels]
    inputs.append(PredictionInput(file=b"not an image"))
    inputs.append(PredictionInput(data={"pixels": np.zeros((3, 3, 3), np.float32)}))
    inputs += [PredictionInput(data={"text": t}) for t in TEXTS]
    inputs.append(PredictionInput(data={"unknown": 1}))
    return inputs


@pytest.fixture(scope="module", params=["bf16", "int8"])
def pair(request):
    kwargs = dict(model_arch="test-tiny", precision=request.param, batch_cap=8)
    jimpl = ref.ClipImpl(**kwargs)
    jimpl.load()
    timpl = impls.ClipImpl(**kwargs, device="cpu")
    timpl.params = convert.params_from_jax(jax.tree.map(np.asarray, jimpl.params), device="cpu")
    return request.param, jimpl, timpl


def test_predict_matches_reference(pair):
    precision, jimpl, timpl = pair
    inputs = _inputs(0)
    want, got = jimpl.predict(inputs), timpl.predict(inputs)
    assert len(got) == len(inputs)
    images, texts, errors = range(5), range(7, 7 + len(TEXTS)), [5, 6, len(inputs) - 1]
    for i in errors:
        assert got[i]["__error__"]["class"] == want[i]["__error__"]["class"] == "input"
    # The decoder's message names a buffer object, so it is compared by its kind.
    assert got[5]["__error__"]["message"].startswith("Undecodable image payload")
    assert got[6] == want[6] and got[-1] == want[-1]
    g_img = np.stack([npy.parse_npy(got[i]) for i in images])
    w_img = np.stack([npy.parse_npy(want[i]) for i in images])
    g_txt = np.stack([npy.parse_npy(got[i]) for i in texts])
    w_txt = np.stack([npy.parse_npy(want[i]) for i in texts])
    assert g_img.dtype == np.float32 and g_img.shape == w_img.shape
    np.testing.assert_allclose(np.linalg.norm(g_img, axis=-1), 1.0, atol=1e-5)
    assert _cos(g_img, w_img).min() >= 0.999
    cos = _cos(g_txt, w_txt)
    assert cos.min() >= 0.998 and cos.mean() >= 0.999, (cos.min(), cos.mean())
    if precision == "int8":
        np.testing.assert_allclose(timpl._act_scales.numpy(), np.asarray(jimpl._act_scales),
                                   rtol=2e-2)
        np.testing.assert_allclose(timpl._text_scales.numpy(), np.asarray(jimpl._text_scales),
                                   rtol=2e-2)


def test_scales_frozen_after_first_batch():
    timpl = impls.ClipImpl(model_arch="test-tiny", precision="int8", batch_cap=8, device="cpu")
    assert timpl._act_scales is None and timpl._text_scales is None
    timpl.predict(_inputs(1, n_images=2))
    first = (timpl._act_scales, timpl._text_scales)
    assert first[0] is not None and first[1] is not None
    timpl.predict(_inputs(2, n_images=3))
    assert timpl._act_scales is first[0] and timpl._text_scales is first[1]


def test_prepare_keeps_no_calibration():
    timpl = impls.ClipImpl(model_arch="test-tiny", precision="int8", batch_cap=4, device="cpu")
    timpl.prepare()
    assert timpl.params is not None
    assert timpl._act_scales is None and timpl._text_scales is None
    q = timpl.params["visual"]["blocks"][0]["attn"]["qkv_w"]
    assert q["q"].dtype == torch.int8 and q["s"].dtype == torch.float32
    timpl.unload()
    assert timpl.params is None


def test_load_is_seeded():
    a = impls.ClipImpl(model_arch="test-tiny", device="cpu")
    b = impls.ClipImpl(model_arch="test-tiny", device="cpu")
    a.load()
    b.load()
    assert torch.equal(a.params["visual"]["proj"], b.params["visual"]["proj"])


def test_tokenizers_match_reference():
    vocab = impls.clip.CONFIGS["ViT-L-14"].text_vocab
    for text in TEXTS + ["", "  Mixed CASE  words\tand tabs "]:
        assert impls.HashTokenizer(vocab).encode(text) == ref.HashTokenizer(vocab).encode(text)
        assert impls.load_tokenizer(None, vocab)(text) == ref.load_tokenizer(None, vocab)(text)


def test_token_ids_are_what_predict_embeds():
    timpl = impls.ClipImpl(model_arch="test-tiny", batch_cap=8, device="cpu")
    ids = timpl.token_ids(TEXTS)
    cfg = timpl.cfg
    assert ids.shape == (4, cfg.text_ctx) and ids.dtype == np.int32  # the bucket of 3 is 4
    for row, text in zip(ids, TEXTS):
        seq = ref.HashTokenizer(cfg.text_vocab).encode(text)
        assert row[: len(seq)].tolist() == seq and not row[len(seq):].any()
    got = timpl.predict([PredictionInput(data={"text": t}) for t in TEXTS])
    want = impls.clip.embed_texts(timpl.params, cfg, torch.from_numpy(ids)).numpy()[: len(TEXTS)]
    np.testing.assert_array_equal(np.stack([npy.parse_npy(g) for g in got]), want)


def test_decode_image_matches_reference():
    from PIL import Image

    buf = io.BytesIO()
    rng = np.random.default_rng(3)
    Image.fromarray(rng.integers(0, 256, size=(40, 60, 3), dtype=np.uint8)).save(buf, "PNG")
    np.testing.assert_array_equal(impls.decode_image(buf.getvalue(), 32),
                                  ref.decode_image(buf.getvalue(), 32))


def test_checkpoint_and_device_are_explicit(tmp_path):
    # A checkpoint loads when the impl loads (test_torch_weights.py holds the
    # loaded weights); one that is not there raises then, never falling back
    # to random weights.
    impl = impls.ClipImpl(model_arch="test-tiny", checkpoint=str(tmp_path / "missing.bin"),
                          device="cpu")
    with pytest.raises(FileNotFoundError):
        impl.load()
    assert impl.params is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):  # no silent fallback to the CPU
            impls.ClipImpl(model_arch="test-tiny")
