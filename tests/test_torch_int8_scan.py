"""Kernel 1 of the port (ops/int8_scan.py) against the JAX Pallas kernel
``pallas_int8_topk`` run in interpret mode, as test_pallas_scan.py runs it:
identical ids, distances within 1e-5. On the CPU the wrapper takes the plain
version; test_torch_cuda_kernels.py holds the CUDA kernel against it."""

import numpy as np
import pytest
import torch

from panoptikon_tpu.ops import codec as ref_codec
from panoptikon_tpu.ops import scoring as ref_scoring
from panoptikon_tpu.ops.pallas_scan import pallas_int8_topk
from panoptikon_tpu_torch.ops import exact, int8_scan, scoring


def _corpus(seed=0, n=1024, d=64, q=8):
    rng = np.random.default_rng(seed)
    corpus = rng.normal(size=(n, d)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    corpus[700] = corpus[5]  # planted equal rows in different tiles
    corpus[300] = corpus[5]
    queries = rng.normal(size=(q, d)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    queries[1] = corpus[5]
    scale = ref_codec.scale_from_absmax(ref_codec.corpus_absmax(corpus))
    codes = ref_codec.quantize_int8(corpus, scale)
    q_codes = ref_codec.quantize_int8(queries, scale)
    sumsq = np.array(ref_scoring.row_sumsq(codes))
    valid = rng.random(n) > 0.1
    valid[[5, 300, 700]] = True
    return corpus, queries, codes, q_codes, sumsq, valid, scale


def _port(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("k", [10, 40])
def test_plain_matches_pallas_kernel(k):
    _, _, codes, q_codes, sumsq, valid, _ = _corpus()
    rv, ri, rok = pallas_int8_topk(codes, sumsq, valid, q_codes, k=k, tile_n=256, interpret=True)
    gv, gi, gok = int8_scan.int8_topk_plain(*_port(codes, sumsq, valid, q_codes), k=k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    np.testing.assert_allclose(gv.numpy(), np.asarray(rv), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(gok.numpy(), np.asarray(rok))
    # The planted rows tie exactly for query 1 and come back in row order.
    np.testing.assert_array_equal(gi.numpy()[1, :3], [5, 300, 700])


def test_wrapper_takes_plain_version_on_cpu():
    _, _, codes, q_codes, sumsq, valid, _ = _corpus(seed=1)
    args = _port(codes, sumsq, valid, q_codes)
    before = int8_scan.int8_topk.launches
    got = int8_scan.int8_topk(*args, k=16)
    want = int8_scan.int8_topk_plain(*args, k=16)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int8_scan.int8_topk.launches == before


def test_invalid_rows_never_win():
    _, _, codes, q_codes, sumsq, valid, _ = _corpus(seed=2)
    valid = valid.copy()
    valid[256:] = False
    _, ri, _ = pallas_int8_topk(codes, sumsq, valid, q_codes, k=10, tile_n=256, interpret=True)
    _, gi, gok = int8_scan.int8_topk_plain(*_port(codes, sumsq, valid, q_codes), k=10)
    assert (gi.numpy() < 256).all() and gok.numpy().all()
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))


def test_fewer_valid_rows_than_k():
    _, _, codes, q_codes, sumsq, _, _ = _corpus(seed=3)
    valid = np.zeros(codes.shape[0], bool)
    valid[[7, 400, 900]] = True
    gv, gi, gok = int8_scan.int8_topk_plain(*_port(codes, sumsq, valid, q_codes), k=5)
    assert gok.numpy()[:, :3].all() and not gok.numpy()[:, 3:].any()
    assert np.isinf(gv.numpy()[:, 3:]).all()
    assert set(gi.numpy()[0, :3].tolist()) == {7, 400, 900}


def test_cross_tile_tiebreak():
    row = np.full((1, 64), 64, dtype=np.int8)
    codes = np.tile(row, (512, 1))
    sumsq = np.array(ref_scoring.row_sumsq(codes))
    valid = np.ones(512, bool)
    _, gi, _ = int8_scan.int8_topk_plain(*_port(codes, sumsq, valid, row), k=4)
    _, ri, _ = pallas_int8_topk(codes, sumsq, valid, row, k=4, tile_n=128, interpret=True)
    np.testing.assert_array_equal(gi.numpy()[0], [0, 1, 2, 3])
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))


def test_wrapper_rejects_bad_inputs():
    _, _, codes, q_codes, sumsq, valid, _ = _corpus(seed=4)
    c, s, v, q = _port(codes, sumsq, valid, q_codes)
    with pytest.raises(ValueError):
        int8_scan.int8_topk(c, s.to(torch.int64), v, q, k=10)
    with pytest.raises(ValueError):
        int8_scan.int8_topk(c, s, v, q, k=int8_scan.MAX_K + 1)
    with pytest.raises(ValueError):  # neither CPU nor CUDA: no silent fallback
        int8_scan.int8_topk(c.to("meta"), s.to("meta"), v.to("meta"), q.to("meta"), k=10)


@pytest.mark.parametrize("distance", ["cosine", "l2"])
def test_int8_topk_rescored_matches_jax(distance):
    corpus, queries, codes, q_codes, sumsq, valid, scale = _corpus(seed=5)
    rv, ri, rok = ref_scoring.int8_topk_rescored(
        codes, sumsq, valid, corpus, q_codes, queries, k=10, oversample=4,
        distance=distance, scale=scale,
    )
    gv, gi, gok = scoring.int8_topk_rescored(
        *_port(codes, sumsq, valid, corpus, q_codes, queries), k=10, oversample=4,
        distance=distance, scale=scale,
    )
    # Tie-aware: approx_min_k does not order equal candidates by row, and
    # the rescore keeps candidate order among equal distances.
    assert exact.topk_agree(gv.numpy(), gi.numpy(), np.asarray(rv), np.asarray(ri), atol=1e-6)
    np.testing.assert_array_equal(gok.numpy(), np.asarray(rok))



@pytest.mark.parametrize("k", [10, 40])
def test_plain_l2_matches_jax_surface(k):
    # The L2 epilogue: scale · sqrt(max(qq − 2·dot + xx, 0)), the JAX
    # package's _distance_epilogue, through its identity surface and top-k.
    _, _, codes, q_codes, sumsq, valid, scale = _corpus(seed=6)
    n = codes.shape[0]
    rd, rok, _ = ref_scoring.grouped_scores(codes, sumsq, valid, np.arange(n, dtype=np.int32),
                                            q_codes, num_groups=n, distance="l2", scale=scale,
                                            identity=True)
    rv, ri, rvalid = ref_scoring.topk_of_scores(rd, rok, kk=k)
    gv, gi, gok = int8_scan.int8_topk_plain(*_port(codes, sumsq, valid, q_codes), k=k,
                                            distance="l2", scale=scale)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    np.testing.assert_allclose(gv.numpy(), np.asarray(rv), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(gok.numpy(), np.asarray(rvalid))
    np.testing.assert_array_equal(gi.numpy()[1, :3], [5, 300, 700])  # exact ties, row order
    assert (gv.numpy()[1, :3] == 0).all()


def test_l2_wrapper_takes_plain_version_on_cpu():
    _, _, codes, q_codes, sumsq, valid, scale = _corpus(seed=7)
    args = _port(codes, sumsq, valid, q_codes)
    before = int8_scan.int8_topk.launches
    got = int8_scan.int8_topk(*args, k=12, distance="l2", scale=scale)
    want = int8_scan.int8_topk_plain(*args, k=12, distance="l2", scale=scale)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int8_scan.int8_topk.launches == before
    with pytest.raises(ValueError):
        int8_scan.int8_topk(*args, k=12, distance="dot")
