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
    gd, gok, gcnt = scoring.grouped_scores(*_t(codes, sumsq, valid, gids, q_codes), num_groups=m,
                                           scale=scale, identity=True)
    np.testing.assert_allclose(gd.numpy(), np.asarray(rd), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(gok.numpy(), np.asarray(rok))
    np.testing.assert_array_equal(gcnt.numpy(), np.asarray(rcnt))
    rv, ri, _ = ref.topk_of_scores(rd, rok, kk=20, largest=largest)
    gv, gi, _ = scoring.topk_of_scores(gd, gok, kk=20, largest=largest)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    np.testing.assert_allclose(gv.numpy(), np.asarray(rv), atol=1e-6, rtol=0)
    # The segmented path over the same one-row-per-group layout gives the
    # identity path's surface: a singleton segment's MIN is its row.
    sd, sok, scnt = scoring.grouped_scores(*_t(codes, sumsq, valid, gids, q_codes), num_groups=m,
                                           scale=scale, chunk_rows=128)
    np.testing.assert_array_equal(sd.numpy(), gd.numpy())
    np.testing.assert_array_equal(sok.numpy(), gok.numpy())
    np.testing.assert_array_equal(scnt.numpy(), gcnt.numpy())


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


def _segmented(data, seed):
    """Multi-row groups: 0-4 rows each, in shuffled order, a few rows past
    every group (invalid), weights for the weighted average."""
    _, _, codes, q_codes, valid, scale = data
    rng = np.random.default_rng(seed)
    n, m = codes.shape[0], 150
    gids = rng.integers(0, m, size=n).astype(np.int32)
    gids[rng.random(n) < 0.05] = m - 1
    weights = rng.uniform(0.1, 2.0, size=n).astype(np.float32)
    return codes, np.array(ref.row_sumsq(codes)), valid, gids, q_codes, m, weights, scale


# L2 on int8 codes takes only exact integer sums and one square root on
# both sides, so its per-row distances are bit-identical and MIN, MAX and
# the counts compare bit for bit. On cosine, XLA rewrites d / sqrt(x) into
# d * rsqrt(x), which is not correctly rounded: per-row values differ by
# ulps (within 1e-6). AVG and the weighted average are f32 sums in another
# order (within 1e-6 relative).
@pytest.mark.parametrize("distance", ["l2", "cosine"])
@pytest.mark.parametrize("aggregation,weighted", [("min", False), ("max", False), ("avg", False),
                                                  ("min", True)])
@pytest.mark.parametrize("chunk_rows", [512, 128, 64])
def test_grouped_scores_segmented(data, distance, aggregation, weighted, chunk_rows):
    codes, sumsq, valid, gids, q_codes, m, weights, scale = _segmented(data, 5)
    kw = dict(num_groups=m, distance=distance, aggregation=aggregation, scale=scale,
              chunk_rows=chunk_rows, weighted=weighted)
    rd, rok, rcnt = ref.grouped_scores(codes, sumsq, valid, gids, q_codes, weights=weights, **kw)
    gd, gok, gcnt = scoring.grouped_scores(*_t(codes, sumsq, valid, gids, q_codes),
                                           weights=torch.from_numpy(weights), **kw)
    np.testing.assert_array_equal(gok.numpy(), np.asarray(rok))
    assert not gok.numpy().all() and gok.numpy().any()  # empty groups among them
    exact_values = distance == "l2" and aggregation in ("min", "max") and not weighted
    if weighted:
        np.testing.assert_allclose(gcnt.numpy(), np.asarray(rcnt), rtol=1e-6)
    else:
        np.testing.assert_array_equal(gcnt.numpy(), np.asarray(rcnt))
    if exact_values:
        np.testing.assert_array_equal(gd.numpy(), np.asarray(rd))
    else:
        np.testing.assert_allclose(gd.numpy(), np.asarray(rd), rtol=1e-6, atol=1e-6)


def test_grouped_scores_segmented_f32_and_errors(data):
    corpus, queries, _, _, valid, _ = data
    gids = (np.arange(corpus.shape[0]) // 3).astype(np.int32)
    sumsq = np.array(ref.row_sumsq(corpus))
    rd, rok, rcnt = ref.grouped_scores(corpus, sumsq, valid, gids, queries, num_groups=171,
                                       aggregation="avg", chunk_rows=256)
    gd, gok, gcnt = scoring.grouped_scores(*_t(corpus, sumsq, valid, gids, queries),
                                           num_groups=171, aggregation="avg", chunk_rows=256)
    np.testing.assert_allclose(gd.numpy(), np.asarray(rd), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(gok.numpy(), np.asarray(rok))
    np.testing.assert_array_equal(gcnt.numpy(), np.asarray(rcnt))
    with pytest.raises(ValueError):
        scoring.grouped_scores(*_t(corpus, sumsq, valid, gids, queries), num_groups=171,
                               chunk_rows=100)
    with pytest.raises(ValueError):
        scoring.grouped_scores(*_t(corpus, sumsq, valid, gids, queries), num_groups=171,
                               aggregation="median")


@pytest.mark.parametrize("largest", [False, True])
def test_masked_topk_of_scores(data, largest):
    codes, sumsq, valid, gids, q_codes, m, _, scale = _segmented(data, 6)
    kw = dict(num_groups=m, distance="l2", scale=scale, chunk_rows=128)
    rd, rok, _ = ref.grouped_scores(codes, sumsq, valid, gids, q_codes, **kw)
    rng = np.random.default_rng(7)
    for mask in (rng.random((q_codes.shape[0], m)) < 0.4, rng.random((1, m)) < 0.4):
        rv, ri, rf = ref.masked_topk_of_scores(rd, rok, mask, kk=30, largest=largest)
        gv, gi, gf = scoring.masked_topk_of_scores(*_t(rd, rok, mask), kk=30, largest=largest)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(rv))
        np.testing.assert_array_equal(gf.numpy(), np.asarray(rf))


def test_gather_of_scores(data):
    codes, sumsq, valid, gids, q_codes, m, _, scale = _segmented(data, 8)
    rd, rok, _ = ref.grouped_scores(codes, sumsq, valid, gids, q_codes, num_groups=m,
                                    distance="l2", scale=scale, chunk_rows=128)
    rd, rok = np.asarray(rd), np.asarray(rok)
    idx = np.array([3, -1, 0, m - 1, 40, 40, -1, 77], np.int64)
    rv, rk = ref.gather_of_scores(rd, rok, idx)
    gv, gk = scoring.gather_of_scores(*_t(rd, rok, idx))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(gk.numpy(), np.asarray(rk))
    rows = np.random.default_rng(9).integers(-1, m, size=(rd.shape[0], 16))
    rv, rk = ref.gather_rows_of_scores(rd, rok, rows)
    gv, gk = scoring.gather_rows_of_scores(*_t(rd, rok, rows))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(gk.numpy(), np.asarray(rk))


@pytest.mark.parametrize("aggregation", ["min", "max"])
def test_streaming_grouped_topk(data, aggregation):
    codes, sumsq, valid, gids, q_codes, m, _, scale = _segmented(data, 11)
    kw = dict(num_groups=m, k=25, distance="l2", aggregation=aggregation, scale=scale,
              chunk_rows=256)
    rv, ri, rf = ref.streaming_grouped_topk(codes, sumsq, valid, gids, q_codes, **kw)
    gv, gi, gf = scoring.streaming_grouped_topk(*_t(codes, sumsq, valid, gids, q_codes), **kw)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(gf.numpy(), np.asarray(rf))
