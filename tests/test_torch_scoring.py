"""The port's scoring surface (ops/scoring.py) against
panoptikon_tpu/ops/scoring.py on the same inputs."""

import numpy as np
import pytest
import torch

from panoptikon_tpu.ops import codec as ref_codec
from panoptikon_tpu.ops import scoring as ref
from panoptikon_tpu_torch.ops import scoring


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    n, d = 512, 32
    corpus = rng.normal(size=(n, d)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    corpus[300] = corpus[20]
    queries = rng.normal(size=(6, d)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    queries[2] = corpus[20]
    scale = ref_codec.scale_from_absmax(ref_codec.corpus_absmax(corpus))
    codes = ref_codec.quantize_int8(corpus, scale)
    q_codes = ref_codec.quantize_int8(queries, scale)
    valid = rng.random(n) > 0.15
    valid[[20, 300]] = True
    return corpus, queries, codes, q_codes, valid, scale


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def test_row_sumsq(data):
    corpus, _, codes, *_ = data
    got = scoring.row_sumsq(torch.from_numpy(codes))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref.row_sumsq(codes)))
    chunked = scoring.row_sumsq_chunked(torch.from_numpy(codes), chunk_rows=100)
    np.testing.assert_array_equal(chunked.numpy(), got.numpy())
    np.testing.assert_allclose(scoring.row_sumsq(torch.from_numpy(corpus)).numpy(),
                               np.asarray(ref.row_sumsq(corpus)), rtol=1e-6)


@pytest.mark.parametrize("domain", ["int8", "f32"])
@pytest.mark.parametrize("distance", ["cosine", "l2"])
def test_streaming_topk(data, domain, distance):
    corpus, queries, codes, q_codes, valid, scale = data
    c, q = (codes, q_codes) if domain == "int8" else (corpus, queries)
    s = scale if domain == "int8" else 1.0
    sumsq = np.array(ref.row_sumsq(c))
    rv, ri, rok = ref.streaming_topk(c, sumsq, valid, q, k=12, distance=distance, scale=s, chunk_rows=128)
    gv, gi, gok = scoring.streaming_topk(*_t(c, sumsq, valid, q), k=12, distance=distance,
                                         scale=s, chunk_rows=128)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    np.testing.assert_allclose(gv.numpy(), np.asarray(rv), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(gok.numpy(), np.asarray(rok))


def test_exact_oneshot(data):
    corpus, queries, _, _, valid, _ = data
    rv, ri, _ = ref.exact_oneshot(corpus, valid, queries, k=10)
    gv, gi, _ = scoring.exact_oneshot(*_t(corpus, valid, queries), k=10)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    np.testing.assert_allclose(gv.numpy(), np.asarray(rv), atol=1e-6, rtol=0)


@pytest.mark.parametrize("largest", [False, True])
def test_grouped_scores_identity_then_topk(data, largest):
    _, _, codes, q_codes, valid, scale = data
    sumsq = np.array(ref.row_sumsq(codes))
    gids = np.arange(codes.shape[0], dtype=np.int32)
    m = 480  # capacity padding: groups < rows
    rd, rok, rcnt = ref.grouped_scores(codes, sumsq, valid, gids, q_codes, num_groups=m,
                                       scale=scale, identity=True)
    gd, gok, gcnt = scoring.grouped_scores(*_t(codes, sumsq, valid, q_codes), num_groups=m,
                                           scale=scale, identity=True)
    np.testing.assert_allclose(gd.numpy(), np.asarray(rd), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(gok.numpy(), np.asarray(rok))
    np.testing.assert_array_equal(gcnt.numpy(), np.asarray(rcnt))
    rv, ri, _ = ref.topk_of_scores(rd, rok, kk=20, largest=largest)
    gv, gi, _ = scoring.topk_of_scores(gd, gok, kk=20, largest=largest)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    np.testing.assert_allclose(gv.numpy(), np.asarray(rv), atol=1e-6, rtol=0)
    with pytest.raises(NotImplementedError):
        scoring.grouped_scores(*_t(codes, sumsq, valid, q_codes), num_groups=m)


def test_rescore_off_returns_candidates(data):
    corpus, queries, codes, q_codes, valid, scale = data
    sumsq = np.array(ref.row_sumsq(codes))
    rv, ri, _ = ref.int8_topk_rescored(codes, sumsq, valid, corpus, q_codes, queries, k=10,
                                       oversample=4, scale=scale, rescore=False)
    gv, gi, _ = scoring.int8_topk_rescored(*_t(codes, sumsq, valid, corpus, q_codes, queries),
                                           k=10, oversample=4, scale=scale, rescore=False)
    np.testing.assert_allclose(gv.numpy(), np.asarray(rv), atol=1e-6, rtol=0)
    # Candidates tied in int8 distance may come back in another order from
    # approx_min_k; as sets they agree.
    for g, r in zip(gi.numpy(), np.asarray(ri)):
        assert set(g.tolist()) == set(r.tolist())
