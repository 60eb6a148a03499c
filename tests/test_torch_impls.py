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


@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_every_row_past_the_top_bucket(precision):
    # ROADMAP §C, C.4: the JAX impl pads a call's images (and texts) as one
    # batch and raises past the top bucket; the port embeds slices of at
    # most the top bucket, each padded to its own, and its rows are the JAX
    # impl's fed the same slices in order (with int8 the first slice of each
    # kind calibrates on both sides).
    kwargs = dict(model_arch="test-tiny", precision=precision, batch_cap=4)
    jimpl = ref.ClipImpl(**kwargs)
    jimpl.load()
    rng = np.random.default_rng(7)
    size = impls.clip.CONFIGS["test-tiny"].image_size
    images = [PredictionInput(data={"pixels": rng.normal(size=(size, size, 3)).astype(np.float32)})
              for _ in range(5)]
    texts = [PredictionInput(data={"text": f"caption {i} of a seeded batch"}) for i in range(5)]
    with pytest.raises(ValueError, match="exceeds bucket 4"):
        jimpl.predict(images)
    with pytest.raises(IndexError):
        jimpl.predict(texts)
    timpl = impls.ClipImpl(**kwargs, device="cpu")
    timpl.params = convert.params_from_jax(jax.tree.map(np.asarray, jimpl.params), device="cpu")
    got = timpl.predict(texts + images)
    assert len(got) == 10
    want = [*jimpl.predict(texts[:4]), *jimpl.predict(texts[4:]),
            *jimpl.predict(images[:4]), *jimpl.predict(images[4:])]
    g = np.stack([npy.parse_npy(o) for o in got])
    w = np.stack([npy.parse_npy(o) for o in want])
    assert _cos(g[5:], w[5:]).min() >= 0.999
    cos = _cos(g[:5], w[:5])
    assert cos.min() >= 0.998 and cos.mean() >= 0.999, (cos.min(), cos.mean())
    if precision == "int8":
        np.testing.assert_allclose(timpl._act_scales.numpy(), np.asarray(jimpl._act_scales),
                                   rtol=2e-2)
        np.testing.assert_allclose(timpl._text_scales.numpy(), np.asarray(jimpl._text_scales),
                                   rtol=2e-2)
    # A call of five is a call of four and a call of one, bit for bit.
    np.testing.assert_array_equal(
        g, np.stack([npy.parse_npy(o) for o in [*timpl.predict(texts[:4]), *timpl.predict(texts[4:]),
                                                *timpl.predict(images[:4]),
                                                *timpl.predict(images[4:])]]))


# ---------------------------------------------------------------------------
# The host-only impls (copied text for text; test_torch_host_copies.py holds
# the text): both packages on the same dumps and the same localhost stub.
# ---------------------------------------------------------------------------

def _both(name, **kwargs):
    return getattr(ref, name)(**kwargs), getattr(impls, name)(**kwargs)


def _as_ref(inputs):
    return [ref.PredictionInput(data=i.data, file=i.file) for i in inputs]


def test_md5_lookup_on_json_and_sqlite_dumps(tmp_path):
    import json
    import sqlite3

    table = {"a" * 32: [["general", "scenery", 0.8], ["general", "sky", 0.5]],
             "b" * 32: [["character", "alice", 1.0]]}
    (tmp_path / "dump.json").write_text(json.dumps(table))
    conn = sqlite3.connect(tmp_path / "dump.sqlite")
    conn.executescript("CREATE TABLE tags (md5 TEXT, namespace TEXT, name TEXT, confidence REAL);"
                       "CREATE INDEX tags_md5 ON tags(md5);")
    conn.executemany("INSERT INTO tags VALUES (?, ?, ?, ?)",
                     [(md5, *row) for md5, rows in table.items() for row in rows])
    conn.commit()
    conn.close()
    inputs = [PredictionInput(data={"md5": "a" * 32}), PredictionInput(data={"md5": "b" * 32}),
              PredictionInput(data={"md5": "c" * 32}), PredictionInput(data={"other": 1}),
              PredictionInput(file=b"x")]
    for dump in ("dump.json", "dump.sqlite", "missing.json"):
        want_impl, got_impl = _both("Md5LookupImpl", dump_path=str(tmp_path / dump), namespace="db")
        got, want = got_impl.predict(inputs), want_impl.predict(_as_ref(inputs))
        assert got == want, dump
        if dump == "missing.json":
            assert got[0]["__error__"]["class"] == "transient" and "tag-dump" in \
                got[0]["__error__"]["message"]
        else:
            assert dict(got[0]["tags"])["general"] == {"scenery": 0.8, "sky": 0.5}
            assert dict(got[2]["tags"])["general"] == {}
        assert got[3]["__error__"]["class"] == got[4]["__error__"]["class"] == "input"
        got_impl.unload()
        want_impl.unload()


@pytest.fixture
def api_stub():
    """A localhost endpoint answering /embeddings (vector = f(payload
    length), entries listed in reverse with their index) and /tags (the
    first md5 a hit, the rest misses); /fail answers 500."""
    import json
    import threading
    from http.server import BaseHTTPRequestHandler, HTTPServer

    seen = []

    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):
            body = json.loads(self.rfile.read(int(self.headers["content-length"])))
            seen.append((self.path, body, self.headers.get("authorization")))
            if self.path == "/fail":
                self.send_response(500)
                self.end_headers()
                return
            if self.path == "/embeddings":
                data = [{"index": i, "embedding": (np.arange(8.0) + len(
                    item.get("text") or item.get("image") or "")).tolist()}
                        for i, item in enumerate(body["input"]) if item.get("text") != "drop"]
                out = {"data": data[::-1]}
            else:
                out = {"results": {h: {"tags": {"1girl": 0.9, "outdoors": None}}
                                   for h in body["md5"][:1]}}
            raw = json.dumps(out).encode()
            self.send_response(200)
            self.send_header("content-type", "application/json")
            self.send_header("content-length", str(len(raw)))
            self.end_headers()
            self.wfile.write(raw)

        def log_message(self, *a):
            pass

    server = HTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_port}", seen
    server.shutdown()


def test_api_embed_matches_the_reference(api_stub, monkeypatch):
    url, seen = api_stub
    monkeypatch.setenv("EMBED_API_KEY", "sk-test")
    inputs = [PredictionInput(data={"text": "hello"}), PredictionInput(file=b"\x89PNGfake"),
              PredictionInput(data={"text": "drop"}), PredictionInput(data={"x": 1})]
    want_impl, got_impl = _both("ApiEmbedImpl", endpoint=f"{url}/embeddings", model="jina-clip-v1")
    got, want = got_impl.predict(inputs), want_impl.predict(_as_ref(inputs))
    assert got == want
    assert seen[0][1:] == seen[1][1:]  # the same request body and key from both
    v = npy.parse_npy(got[0])
    np.testing.assert_allclose(np.linalg.norm(v), 1.0, atol=1e-6)
    assert got[2]["__error__"]["class"] == "input"  # no entry returned for that slot
    assert impls.ApiEmbedImpl.available({"endpoint": url}) and not impls.ApiEmbedImpl.available({})
    for impl in (impls.ApiEmbedImpl(), impls.ApiEmbedImpl(endpoint=f"{url}/fail", timeout=5)):
        out = impl.predict(inputs[:2])
        assert [o["__error__"]["class"] for o in out] == ["transient", "transient"]
    assert "blocker=embed-api" in impls.ApiEmbedImpl().predict(inputs[:1])[0]["__error__"]["message"]


def test_tag_api_matches_the_reference(api_stub):
    url, seen = api_stub
    inputs = [PredictionInput(file=b"imagebytes"), PredictionInput(data={"md5": "deadbeef" * 4}),
              PredictionInput()]
    want_impl, got_impl = _both("TagApiImpl", endpoint=f"{url}/tags", namespace="remote",
                                default_confidence=0.5)
    got, want = got_impl.predict(inputs), want_impl.predict(_as_ref(inputs))
    assert got == want and seen[0][1] == seen[1][1]
    assert dict(got[0]["tags"])["general"] == {"1girl": 0.9, "outdoors": 0.5}
    assert got[0]["metadata"]["matched"] and not got[1]["metadata"]["matched"]
    assert got[2]["__error__"]["class"] == "input"
    blocked = impls.TagApiImpl().predict(inputs[:1])[0]["__error__"]
    assert blocked["class"] == "transient" and "blocker=tag-api" in blocked["message"]
    failed = impls.TagApiImpl(endpoint=f"{url}/fail", timeout=5).predict(inputs[:1])[0]
    assert failed["__error__"]["class"] == "transient"


IMAGE_TAG_IDS = {"tags/vit-tagger": "TaggerImpl", "tagmatch/local-dump": "Md5LookupImpl",
                 "tagmatch/remote-api": "TagApiImpl", "vlmtags/vlm-tagger": "VlmTaggerImpl",
                 "vlm/caption-base": "CaptionerImpl"}


@pytest.mark.parametrize("model_id", list(IMAGE_TAG_IDS))
def test_manager_loads_the_image_tag_entries(model_id, monkeypatch):
    # The built-in registry's tag and caption entries load through the
    # port's manager with prewarm; the device impls at test-tiny on the CPU
    # (the registry's ViT-B-32 runs on the card).
    from panoptikon_tpu_torch.models.manager import ModelManager
    from panoptikon_tpu_torch.models.registry import Registry

    registry = Registry(None)
    group, name = model_id.split("/")
    rid = registry.resolve(group, name)
    cls = getattr(impls, IMAGE_TAG_IDS[model_id])
    assert impls.IMPL_INDEX[rid.impl_class] is cls
    if "model_arch" in rid.config:
        assert rid.config["model_arch"] == "ViT-B-32"
        monkeypatch.setattr(rid, "config", {**rid.config, "model_arch": "test-tiny", "device": "cpu"})
    manager = ModelManager(registry, impls.IMPL_INDEX)
    try:
        manager.load_model(model_id, prewarm=True)
        entry = manager._models[model_id]
        assert type(entry.model) is cls
        assert entry.default_batch == registry.group_metadata(group)["default_batch_size"]
        if group == "vlm":
            assert entry.model.max_tokens == 48 and entry.model.decoder_params is not None
        if group == "tags":
            assert entry.model.params is not None and entry.model._act_scales is None
    finally:
        manager.shutdown()


def test_impl_index_is_the_reference_s_but_ocr():
    # Every impl_class of the JAX package's index has its port, OCR's
    # included now, under the same name; the port's only other impl_class is
    # its own Kimi-VL captioner.
    assert set(impls.IMPL_INDEX) == set(ref.IMPL_INDEX) | {"kimi_vl"}
    assert impls.IMPL_INDEX["ocr"] is impls.OcrImpl
    assert impls.IMPL_INDEX["kimi_vl"] is impls.KimiVlImpl
    for name, cls in impls.IMPL_INDEX.items():
        assert cls.__module__ == impls.__name__
        if name in ref.IMPL_INDEX:
            assert cls.__name__ == ref.IMPL_INDEX[name].__name__
