"""Kernel B2 of the port (ops/int8_scan.py::int8_topk_v2) against the JAX
Pallas kernel ``pallas_int8_topk_v2`` run in interpret mode, as
test_pallas_scan.py runs it, and the serving path's Q > 512 route.

Ids are held identical, +inf sentinels included, and distances within 1e-6:
the port's cosine epilogue takes a correctly rounded ``rsqrt`` (its plain
version through f64), the JAX kernel the CPU's ``lax.rsqrt``, which may
differ by an ulp (6e-8 at distances near 1). On the CPU the wrapper takes the
plain version; test_torch_cuda_kernels.py holds the CUDA kernel against it."""

import numpy as np
import pytest
import torch

from panoptikon_tpu.ops import codec as ref_codec
from panoptikon_tpu.ops import scoring as ref_scoring
from panoptikon_tpu.ops.pallas_scan import pallas_int8_topk_v2
from panoptikon_tpu_torch.ops import exact, int8_scan, scoring

ATOL = 1e-6


def _port(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _codes(seed=0, n=1024, d=64, q=8, invalid=0.1):
    rng = np.random.default_rng(seed)
    corpus = rng.normal(size=(n, d)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    queries = rng.normal(size=(q, d)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    scale = ref_codec.scale_from_absmax(ref_codec.corpus_absmax(corpus))
    codes = ref_codec.quantize_int8(corpus, scale)
    q_codes = ref_codec.quantize_int8(queries, scale)
    valid = rng.random(n) > invalid
    return codes, q_codes, valid


def _sumsq(codes):
    return np.array(ref_scoring.row_sumsq(codes))


def _reference(codes, valid, q_codes, *, k, k_tile, tile_n, q_block=8):
    """The JAX kernel on inputs padded to its grid: corpus rows to a multiple
    of tile_n (invalid, zero codes), queries to a multiple of q_block."""
    n, d = codes.shape
    q = q_codes.shape[0]
    n_pad, q_pad = -(-n // tile_n) * tile_n, -(-q // q_block) * q_block
    codes_p = np.zeros((n_pad, d), np.int8)
    codes_p[:n] = codes
    valid_p = np.zeros(n_pad, bool)
    valid_p[:n] = valid
    q_p = np.zeros((q_pad, d), np.int8)
    q_p[:q] = q_codes
    rv, ri, rok = pallas_int8_topk_v2(codes_p, _sumsq(codes_p), valid_p, q_p, k=k, k_tile=k_tile,
                                      tile_n=tile_n, q_block=q_block, interpret=True)
    return np.asarray(rv)[:q], np.asarray(ri)[:q], np.asarray(rok)[:q]


def _assert_same(got, want):
    gv, gi, gok = (t.numpy() for t in got)
    rv, ri, rok = want
    np.testing.assert_array_equal(gi, ri)
    np.testing.assert_array_equal(gok, rok)
    finite = np.isfinite(rv)
    np.testing.assert_array_equal(np.isfinite(gv), finite)
    np.testing.assert_allclose(gv[finite], rv[finite], atol=ATOL, rtol=0)


@pytest.mark.parametrize("k,k_tile", [(64, 8), (16, 4)])
def test_plain_matches_pallas_kernel(k, k_tile):
    codes, q_codes, valid = _codes()
    want = _reference(codes, valid, q_codes, k=k, k_tile=k_tile, tile_n=256)
    got = int8_scan.int8_topk_v2_plain(*_port(codes, _sumsq(codes), valid, q_codes), k=k,
                                       k_tile=k_tile, tile_n=256)
    assert got[1].shape == (8, min(k, 4 * k_tile))
    _assert_same(got, want)


def test_ties_follow_lane_then_candidate_position():
    # Equal rows where lane order and row order disagree: in tile 0 at
    # lane 5 (row 5) and lane 2 (row 130); in tile 1 at lane 9 (row 265),
    # lane 1 (row 385), and twice in lane 3 (rows 259 and 387: the lower
    # bucket survives). Lane order within a tile, then candidate position
    # (tile·k_tile + round) across tiles, as lax.top_k orders the merge.
    rng = np.random.default_rng(1)
    codes = rng.integers(-40, 41, size=(512, 64), dtype=np.int8)
    target = np.full(64, 90, np.int8)
    planted = [5, 130, 265, 385, 259, 387]
    codes[planted] = target
    q_codes = rng.integers(-40, 41, size=(8, 64), dtype=np.int8)
    q_codes[0] = target
    valid = np.ones(512, bool)
    want = _reference(codes, valid, q_codes, k=8, k_tile=4, tile_n=256)
    got = int8_scan.int8_topk_v2_plain(*_port(codes, _sumsq(codes), valid, q_codes), k=8,
                                       k_tile=4, tile_n=256)
    _assert_same(got, want)
    assert got[1][0, :5].tolist() == [130, 5, 385, 259, 265]
    assert 387 not in got[1][0].tolist()


def test_invalid_rows_never_win_and_inf_rounds_are_sentinels():
    codes, q_codes, _ = _codes(seed=2, n=512)
    valid = np.zeros(512, bool)
    valid[[3, 200]] = True  # two valid rows, both in tile 0 of 2
    want = _reference(codes, valid, q_codes, k=8, k_tile=4, tile_n=256)
    gv, gi, gok = got = int8_scan.int8_topk_v2_plain(*_port(codes, _sumsq(codes), valid, q_codes),
                                                     k=8, k_tile=4, tile_n=256)
    _assert_same(got, want)
    assert gok[:, :2].all() and not gok[:, 2:].any()
    assert set(gi[0, :2].tolist()) == {3, 200}
    assert (gi[:, 2:] == int8_scan.SENTINEL_ROW).all() and torch.isinf(gv[:, 2:]).all()


@pytest.mark.parametrize("distance", ["cosine", "l2"])
def test_ragged_corpus_and_query_count(distance):
    # N = 1000 is not a multiple of tile_n: the port counts the tail as rows
    # at +inf; the JAX kernel gets the same rows padded as invalid. Q = 13 is
    # not a multiple of q_block.
    codes, q_codes, valid = _codes(seed=3, n=1000, q=13)
    args = _port(codes, _sumsq(codes), valid, q_codes)
    got = int8_scan.int8_topk_v2_plain(*args, k=24, k_tile=8, tile_n=256, distance=distance,
                                       scale=0.01)
    assert got[1].shape == (13, 24)
    if distance == "cosine":
        _assert_same(got, _reference(codes, valid, q_codes, k=24, k_tile=8, tile_n=256))
    else:  # the JAX kernel is cosine only: the plain L2 surface's lane minima
        n = codes.shape[0]
        rd, rok, _ = ref_scoring.grouped_scores(codes, _sumsq(codes), valid,
                                                np.arange(n, dtype=np.int32), q_codes,
                                                num_groups=n, distance="l2", scale=0.01,
                                                identity=True)
        dist = np.where(np.asarray(rok), np.asarray(rd), np.inf)
        dist = np.pad(dist, ((0, 0), (0, 1024 - n)), constant_values=np.inf)
        lanes = dist.reshape(13, 4, 2, 128).min(axis=2)  # (Q, tiles, 128)
        want = np.sort(np.sort(lanes, axis=-1)[..., :8].reshape(13, 32), axis=-1)[:, :24]
        np.testing.assert_allclose(got[0].numpy(), want, atol=ATOL, rtol=0)


def test_wrapper_takes_plain_version_on_cpu():
    codes, q_codes, valid = _codes(seed=4)
    args = _port(codes, _sumsq(codes), valid, q_codes)
    before = int8_scan.int8_topk_v2.launches
    got = int8_scan.int8_topk_v2(*args, k=40, k_tile=8, tile_n=256, distance="l2", scale=0.5)
    want = int8_scan.int8_topk_v2_plain(*args, k=40, k_tile=8, tile_n=256, distance="l2",
                                        scale=0.5)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int8_scan.int8_topk_v2.launches == before
    # A query-chunked call gives the same rows.
    part = int8_scan.int8_topk_v2(*args[:3], args[3][:3], k=40, k_tile=8, tile_n=256,
                                  distance="l2", scale=0.5)
    assert torch.equal(part[1], got[1][:3])


def test_wrapper_rejects_bad_inputs():
    codes, q_codes, valid = _codes(seed=5)
    c, s, v, q = _port(codes, _sumsq(codes), valid, q_codes)
    for kwargs in ({"tile_n": 200}, {"tile_n": 64}, {"k_tile": 0}, {"k_tile": 129}, {"k": 0},
                   {"distance": "dot"}):
        with pytest.raises(ValueError):
            int8_scan.int8_topk_v2(c, s, v, q, **kwargs)
    with pytest.raises(ValueError):
        int8_scan.int8_topk_v2(c, s.to(torch.int64), v, q)
    with pytest.raises(ValueError):  # neither CPU nor CUDA: no silent fallback
        int8_scan.int8_topk_v2(c.to("meta"), s.to("meta"), v.to("meta"), q.to("meta"))


def _planted_batch(q=520, n=20_480, d=32, tile_n=2048, seed=6):
    """Q queries over N rows, each query with 10 near neighbours, one in each
    of 10 tiles at a lane of its own: the lane buckets lose none of them."""
    rng = np.random.default_rng(seed)
    corpus = rng.normal(size=(n, d)).astype(np.float32)
    queries = rng.normal(size=(q, d)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    for j in range(10):
        rows = j * tile_n + (np.arange(q) + 7 * j) % tile_n
        corpus[rows] = queries + 0.05 * rng.normal(size=(q, d)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    valid = rng.random(n) > 0.02
    for j in range(10):
        valid[j * tile_n + (np.arange(q) + 7 * j) % tile_n] = True
    scale = ref_codec.scale_from_absmax(ref_codec.corpus_absmax(corpus))
    codes = ref_codec.quantize_int8(corpus, scale)
    q_codes = ref_codec.quantize_int8(queries, scale)
    return corpus, queries, codes, q_codes, _sumsq(codes), valid, scale


@pytest.mark.parametrize("distance", ["cosine", "l2"])
def test_int8_topk_rescored_takes_v2_above_512_queries(monkeypatch, distance):
    corpus, queries, codes, q_codes, sumsq, valid, scale = _planted_batch()
    calls = []
    for name in ("int8_topk", "int8_topk_v2"):
        fn = getattr(int8_scan, name)
        monkeypatch.setattr(int8_scan, name,
                            lambda *a, _fn=fn, _name=name, **kw:
                            calls.append(_name) or _fn(*a, **kw))
    args = _port(codes, sumsq, valid, corpus, q_codes, queries)
    gv, gi, gok = scoring.int8_topk_rescored(*args, k=10, oversample=8, distance=distance,
                                             scale=scale)
    assert calls == ["int8_topk_v2"]
    rv, ri, rok = ref_scoring.int8_topk_rescored(codes, sumsq, valid, corpus, q_codes, queries,
                                                 k=10, oversample=8, distance=distance,
                                                 scale=scale)
    # The f32 rescore sums in another order than XLA's; for L2 the square
    # root amplifies that in qq − 2·dot + xx ≈ 0.07 (distances near 0.27) to
    # 1.5e-6, so L2 is held to 4e-6.
    atol = ATOL if distance == "cosine" else 4e-6
    assert exact.topk_agree(gv.numpy(), gi.numpy(), np.asarray(rv), np.asarray(ri), atol=atol)
    np.testing.assert_array_equal(gok.numpy(), np.asarray(rok))
    # At the limit itself the exact scan serves.
    scoring.int8_topk_rescored(*[a[:int8_scan.V1_MAX_QUERIES] if i >= 4 else a
                                 for i, a in enumerate(args)], k=10, distance=distance,
                               scale=scale)
    assert calls == ["int8_topk_v2", "int8_topk"]


def _unit_inputs(seed, n, d, q, invalid=0.1):
    """Seeded unit rows and queries, their int8 codes under the corpus
    scale, row sums and validity, as the JAX package builds them."""
    rng = np.random.default_rng(seed)
    corpus = rng.normal(size=(n, d)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    queries = rng.normal(size=(q, d)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    scale = ref_codec.scale_from_absmax(ref_codec.corpus_absmax(corpus))
    codes = ref_codec.quantize_int8(corpus, scale)
    q_codes = ref_codec.quantize_int8(queries, scale)
    valid = rng.random(n) > invalid
    return corpus, queries, codes, q_codes, _sumsq(codes), valid, scale


def _held_to_jax(n, q, k, oversample, seed):
    """int8_topk_rescored of the port and of the JAX package on the same
    inputs: k valid rows a query, in agreement up to ties."""
    corpus, queries, codes, q_codes, sumsq, valid, scale = _unit_inputs(seed, n, 32, q)
    gv, gi, gok = scoring.int8_topk_rescored(
        *_port(codes, sumsq, valid, corpus, q_codes, queries), k=k, oversample=oversample,
        scale=scale)
    rv, ri, rok = ref_scoring.int8_topk_rescored(codes, sumsq, valid, corpus, q_codes, queries,
                                                 k=k, oversample=oversample, scale=scale)
    assert gv.shape == (q, k) and bool(gok.all())
    np.testing.assert_array_equal(gok.numpy(), np.asarray(rok))
    assert exact.topk_agree(gv.numpy(), gi.numpy(), np.asarray(rv), np.asarray(ri), atol=ATOL)
    assert bool(torch.from_numpy(valid)[gi].all())


@pytest.mark.parametrize("n,q,k,oversample", [(600, 520, 10, 8), (6000, 520, 10, 8),
                                              (16_384, 513, 80, 4)])
def test_int8_topk_rescored_above_512_queries_gives_k_rows(n, q, k, oversample):
    # Above 512 queries B2's tiles give ceil(N / 2,048) * 8 candidates; where
    # that is fewer than k * oversample the exact B1 serves, so every query
    # gets k valid rows, as from the JAX function.
    assert scoring.candidate_route(q, n, min(k * oversample, n)) == "b1"
    _held_to_jax(n, q, k, oversample, seed=n + q)


def test_int8_topk_rescored_past_the_scan_k_limit():
    # k * oversample = 1,600 > MAX_K and B2's 24 candidates: the exact surface.
    assert scoring.candidate_route(64, 5000, 1600) == "surface"
    _held_to_jax(5000, 64, 100, 16, seed=8)


def _logged(monkeypatch):
    calls = []
    for module, name in ((int8_scan, "int8_topk"), (int8_scan, "int8_topk_v2"),
                         (scoring, "surface_topk")):
        fn = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, _fn=fn, _name=name, **kw:
                            calls.append(_name) or _fn(*a, **kw))
    return calls


@pytest.mark.parametrize("q,n,k,oversample,route", [
    (512, 20_480, 10, 8, "b1"), (513, 20_480, 10, 8, "b2"),   # the query split
    (513, 4096, 2, 8, "b2"), (513, 4096, 17, 1, "b1"),        # kk = tiles * 8, + 1
    (513, 20_480, 128, 8, "b1"), (513, 20_480, 205, 5, "surface"),  # kk = 1,024, 1,025
])
def test_candidate_route_boundaries(monkeypatch, q, n, k, oversample, route):
    corpus, queries, codes, q_codes, sumsq, valid, scale = _unit_inputs(q + n + k, n, 16, q)
    kk = min(k * oversample, n)
    assert scoring.candidate_route(q, n, kk) == route
    calls = _logged(monkeypatch)
    gv, gi, gok = scoring.int8_topk_rescored(*_port(codes, sumsq, valid, corpus, q_codes, queries),
                                             k=k, oversample=oversample, scale=scale,
                                             rescore=False)
    assert calls == [{"b1": "int8_topk", "b2": "int8_topk_v2", "surface": "surface_topk"}[route]]
    assert gv.shape == (q, k) and bool(gok.all())


def test_candidate_route_on_a_large_corpus():
    # At most 512 queries and kk past MAX_K, B2 where its tiles give kk.
    n = 1_048_576
    assert scoring.candidate_route(512, n, 1024) == "b1"
    assert scoring.candidate_route(512, n, 1025) == "b2"
    assert scoring.candidate_route(512, n, 4096) == "b2"
    assert scoring.candidate_route(512, n, 4097) == "surface"


def test_scan_ablation_edits_apply_to_the_kernel_source():
    # profiling --scan's dot-stage build replaces B2's fold in
    # csrc/int8_scan.cu: the text it replaces must be there, once.
    from panoptikon_tpu_torch import _build, profiling

    text = (_build.CSRC / "int8_scan.cu").read_text()
    for name, edits in profiling.SCAN_ABLATIONS.items():
        for old, _ in edits:
            assert text.count(old) == 1, (name, old)
    assert {"dots_only", "b1_dots_only"} <= set(profiling.SCAN_ABLATIONS)
