"""``TextEmbedImpl.predict`` on the port (CPU) against the JAX package's,
both on one BERT-layout checkpoint so that they hold the same weights: rows
per text, the combined row past ``combine_threshold``, the task prompt, and
each row within the text encoder's tolerance (min cosine ≥ 0.999, max abs
≤ 2e-2 × max |ref|).

The JAX impl pads all of a call's chunks as one batch
(``models/batching.py::pad_token_batch``), which raises ``IndexError`` once a
call has more chunks than the top batch bucket (ROADMAP §C). That is a
fault of the reference, not the expected result: the port must return every
text's rows there, equal to the JAX impl's predicting each text alone."""

import numpy as np
import pytest
import torch

from panoptikon_tpu.models import impls as ref_impls
from panoptikon_tpu.models import text_embed as ref_text
from panoptikon_tpu_torch.models import impls
from panoptikon_tpu_torch.models.impls import PredictionInput, npy


def synth_bert(cfg, layers, seed=4):
    """A BERT-layout state dict (tests/test_weights.py's recipe) with random
    LayerNorm affines, so that every leaf of the mapping is exercised."""
    rng = np.random.default_rng(seed)
    w = cfg.width

    def ln(prefix):
        sd[f"{prefix}.weight"] = (1 + 0.1 * rng.normal(size=w)).astype(np.float32)
        sd[f"{prefix}.bias"] = (0.1 * rng.normal(size=w)).astype(np.float32)

    sd = {
        "embeddings.word_embeddings.weight": rng.normal(size=(cfg.vocab, w)).astype(np.float32) * 0.02,
        "embeddings.position_embeddings.weight": rng.normal(size=(cfg.ctx, w)).astype(np.float32) * 0.02,
        "embeddings.token_type_embeddings.weight": rng.normal(size=(2, w)).astype(np.float32) * 0.02,
    }
    ln("embeddings.LayerNorm")
    for i in range(layers):
        p = f"encoder.layer.{i}"
        for name, (ci, co) in {
            "attention.self.query": (w, w), "attention.self.key": (w, w),
            "attention.self.value": (w, w), "attention.output.dense": (w, w),
            "intermediate.dense": (w, 4 * w), "output.dense": (4 * w, w),
        }.items():
            sd[f"{p}.{name}.weight"] = rng.normal(size=(co, ci)).astype(np.float32) * ci**-0.5
            sd[f"{p}.{name}.bias"] = rng.normal(size=co).astype(np.float32) * 0.02
        ln(f"{p}.attention.output.LayerNorm")
        ln(f"{p}.output.LayerNorm")
    return sd


def save_bert(sd, path):
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, str(path))
    return path


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    cfg = ref_text.CONFIGS["test-tiny"]
    return str(save_bert(synth_bert(cfg, cfg.layers, seed=9),
                         tmp_path_factory.mktemp("bert") / "model.bin"))


def _rows(outputs):
    return [npy.parse_npy(o) for o in outputs]


def _close(got, want):
    assert got.shape == want.shape and got.dtype == np.float32 and np.isfinite(got).all()
    cos = np.sum(got * want, axis=1) / (np.linalg.norm(got, axis=1) * np.linalg.norm(want, axis=1))
    assert cos.min() >= 0.999
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


def _words(n, seed):
    rng = np.random.default_rng(seed)
    return " ".join(f"w{int(i)}" for i in rng.integers(0, 500, size=n))


def test_predict_matches_the_jax_impl(ckpt):
    # test-tiny's context is 32 tokens: 6 words is one chunk, 40 two, 100
    # four (the combined row appears at combine_threshold 4). The "s2s"
    # task takes the mapped prompt; an unmapped task and a missing text are
    # embedded as given.
    kw = dict(combine_threshold=4, query_prompt_name_map={"s2s": "query: "})
    port = impls.TextEmbedImpl("test-tiny", checkpoint=ckpt, device="cpu", **kw)
    ref = ref_impls.TextEmbedImpl("test-tiny", checkpoint=ckpt, **kw)
    datas = [{"text": _words(6, 1)}, {"text": _words(40, 2)}, {"text": _words(100, 3)},
             {"text": _words(6, 1), "task": "s2s"}, {"text": _words(6, 4), "task": "other"},
             {"text": _words(100, 5), "combine_threshold": -1}, {}, {"text": ""}]
    inputs = [PredictionInput(data=d) for d in datas]
    got, want = _rows(port.predict(inputs)), _rows(ref.predict(inputs))
    assert [g.shape[0] for g in got] == [1, 2, 5, 1, 1, 4, 1, 1]
    for g, w in zip(got, want):
        _close(g, w)
    np.testing.assert_allclose(got[2][-1], got[2][:-1].mean(axis=0), rtol=1e-6, atol=1e-7)
    assert not np.allclose(got[0], got[3])  # the prompt changed the text


def test_the_reference_fault_shape_returns_every_row(ckpt):
    # Two 80-word texts are six chunks of test-tiny's context; batch_cap 4
    # makes the top bucket 4. The JAX impl indexes past it; the port encodes
    # the six chunks in two slices and returns three rows a text.
    texts = [PredictionInput(data={"text": _words(80, s)}) for s in (6, 7)]
    with pytest.raises(IndexError):
        ref_impls.TextEmbedImpl("test-tiny", checkpoint=ckpt, batch_cap=4).predict(texts)
    port = impls.TextEmbedImpl("test-tiny", checkpoint=ckpt, batch_cap=4, device="cpu")
    got = _rows(port.predict(texts))
    ref = ref_impls.TextEmbedImpl("test-tiny", checkpoint=ckpt, batch_cap=4)
    for g, text in zip(got, texts):
        assert g.shape == (3, 32)
        _close(g, npy.parse_npy(ref.predict([text])[0]))


def test_encode_chunks_slices_at_the_top_bucket(ckpt, monkeypatch):
    # Every slice handed to the encoder holds at most the top bucket's rows,
    # padded to its own bucket; the rows come back in the callers' order,
    # equal to encoding each chunk alone.
    port = impls.TextEmbedImpl("test-tiny", checkpoint=ckpt, batch_cap=4, device="cpu")
    port.load()
    seen = []
    encode = impls.text_embed.encode

    def spy(params, cfg, ids, mask, normalize=False):
        seen.append(tuple(ids.shape))
        return encode(params, cfg, ids, mask, normalize)

    monkeypatch.setattr(impls.text_embed, "encode", spy)
    rng = np.random.default_rng(11)
    chunks = [list(rng.integers(3, 128, size=n)) for n in (30, 2, 17, 9, 32, 5, 1, 12, 3)]
    got = port.encode_chunks(chunks)
    assert seen == [(4, 32), (4, 32), (1, 32)]
    seen.clear()
    for chunk, row in zip(chunks, got):
        np.testing.assert_allclose(port.encode_chunks([chunk])[0], row, rtol=2e-2, atol=2e-2)
    assert port.encode_chunks([]).shape == (0, 32)


def test_prepare_runs_every_bucket_and_load_is_seeded(monkeypatch):
    port = impls.TextEmbedImpl("test-tiny", batch_cap=4, device="cpu")
    seen = []
    encode = impls.text_embed.encode
    monkeypatch.setattr(impls.text_embed, "encode",
                        lambda p, c, ids, m, normalize=False: seen.append(tuple(ids.shape))
                        or encode(p, c, ids, m, normalize))
    port.prepare()
    assert seen == [(1, 32), (2, 32), (4, 32)]
    assert port.length_ladder == [32] and port.batch_ladder == [1, 2, 4]
    # Random weights from a fixed seed: two impls embed alike; the block
    # linears are bf16, the rest f32.
    other = impls.TextEmbedImpl("test-tiny", device="cpu")
    inputs = [PredictionInput(data={"text": "a red car"})]
    assert port.predict(inputs) == other.predict(inputs)
    assert port.params["blocks"][0]["attn"]["qkv_w"].dtype == torch.bfloat16
    assert port.params["blocks"][0]["ln_attn"]["scale"].dtype == torch.float32
    port.unload()
    assert port.params is None
    assert impls.TextEmbedImpl.name() == ref_impls.TextEmbedImpl.name() == "sentence_transformers"
    assert impls.TextEmbedImpl("mpnet-base", max_seq_length=100, device="cpu").length_ladder == [32, 64]
