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


NO_KEY = torch.iinfo(torch.int64).max


def _fold(lst, pend, k, slots):
    """The kernel's fold: the pending keys sorted (``slots`` wide, empty at
    NO_KEY), list[i] = min(list[i], pend[len - 1 - i]) over the list's
    slots the pending keys reach, then sorted (the kernel's bitonic merge);
    returns the list and its new tau."""
    length = lst.numel()
    pend = torch.sort(torch.cat([pend, torch.full((slots - pend.numel(),), NO_KEY)])).values
    lst = lst.clone()
    idx = torch.arange(max(length - slots, 0), length)
    lst[idx] = torch.minimum(lst[idx], pend[length - 1 - idx])
    lst = torch.sort(lst).values
    return lst, lst[k - 1]


def _emulate_b1(codes, sumsq, valid, q_codes, *, k, sms):
    """B1's selection in plain torch: strips of b1_layout, each query's keys
    offered bucket by bucket against its tau into the form's pending slots
    (a full buffer folds and the refused keys are offered again), folds once
    three quarters of the slots hold keys and at the strip's end, then one top-k over
    every strip's list. Also checks after every fold that the list starts
    with the k smallest keys seen."""
    n, d = codes.shape
    q = q_codes.shape[0]
    _, strip_rows, length = int8_scan.b1_layout(q, n, d, k, sms)
    slots = int8_scan.NARROW_PENDING if k <= int8_scan.NARROW_LIST else int8_scan.WIDE_PENDING
    dist = int8_scan._distances(exact.int8_dots(q_codes, codes), sumsq, exact.row_sumsq(q_codes),
                                "cosine", 1.0)
    keys = exact.pack_keys(torch.where(valid[None, :], dist, exact.INF),
                           torch.arange(n).expand(q, n))
    out = []
    for qi in range(q):
        lists = []
        for lo in range(0, n, strip_rows):
            hi = min(lo + strip_rows, n)
            lst, tau, pend, folds = torch.full((length,), NO_KEY), NO_KEY, [], 0
            for b0 in range(lo, hi, int8_scan.BUCKET):
                offered = keys[qi, b0:min(b0 + int8_scan.BUCKET, hi)]
                while offered.numel():
                    fresh = offered[offered < tau]
                    room = slots - len(pend)
                    pend += fresh[:room].tolist()
                    offered = fresh[room:]
                    if offered.numel() or len(pend) >= slots * 3 // 4:  # kFoldAt
                        lst, tau = _fold(lst, torch.tensor(pend, dtype=torch.int64), k, slots)
                        pend, folds = [], folds + 1
                        seen = torch.sort(keys[qi, lo:min(b0 + int8_scan.BUCKET, hi)]).values
                        if not offered.numel():
                            m = min(k, seen.numel())
                            assert torch.equal(lst[:m], seen[:m]) and (lst[m:k] == NO_KEY).all()
            if pend:
                lst, tau = _fold(lst, torch.tensor(pend, dtype=torch.int64), k, slots)
            assert folds or pend
            lists.append(lst)
        out.append(torch.topk(torch.cat(lists), k, largest=False, sorted=True).values)
    return exact.unpack_keys(torch.stack(out))


@pytest.mark.parametrize("n,k,valid_rows", [(3000, 1, None), (3000, 80, None),
                                            (5000, 1024, None), (2900, 80, 3)])
def test_b1_selection_emulated_matches_plain(n, k, valid_rows):
    # Planted equal rows in different strips (row 5 at n // 2 and n - 1,
    # query 1 at row 5), a ragged N that is not a multiple of the strip, and
    # a corpus with fewer valid rows than k.
    rng = np.random.default_rng(n + k)
    corpus = rng.normal(size=(n, 48)).astype(np.float32)
    corpus[[n // 2, n - 1]] = corpus[5]
    queries = rng.normal(size=(4, 48)).astype(np.float32)
    queries[1] = corpus[5]
    scale = ref_codec.scale_from_absmax(ref_codec.corpus_absmax(corpus))
    codes = torch.from_numpy(np.asarray(ref_codec.quantize_int8(corpus, scale)))
    q_codes = torch.from_numpy(np.asarray(ref_codec.quantize_int8(queries, scale)))
    valid = torch.from_numpy(rng.random(n) > 0.1)
    valid[[5, n // 2, n - 1]] = True
    if valid_rows:
        valid[:] = False
        valid[[5, n // 2, n - 1][:valid_rows]] = True
    sumsq = exact.row_sumsq(codes)
    _, strip_rows, _ = int8_scan.b1_layout(4, n, 48, k, 4)
    assert n % strip_rows and n // strip_rows >= 2
    ev, ei = _emulate_b1(codes, sumsq, valid, q_codes, k=k, sms=4)
    pv, pi, pok = int8_scan.int8_topk_plain(codes, sumsq, valid, q_codes, k=k)
    assert torch.equal(ei, pi) and torch.equal(ev, pv)
    assert pi[1, :min(k, 3)].tolist() == [5, n // 2, n - 1][:k]
    if valid_rows:
        assert int(pok.sum().item()) == 4 * valid_rows


def test_b1_layout_fills_the_card():
    # On 132 SMs, one wave of about one block an SM at every serving Q;
    # strips of whole buckets that cover N; the narrow form up to k = 128 (64
    # queries a block at every Q and D), the wide one above (16 queries a
    # block past 256 keys).
    for q in (1, 64, 256, 512):
        q_block, strip_rows, length = int8_scan.b1_layout(q, 1_048_576, 512, 80, 132)
        strips = -(-1_048_576 // strip_rows)
        assert (q_block, length) == (64, 128)
        assert strip_rows % int8_scan.BUCKET == 0
        assert 120 <= -(-q // q_block) * strips <= 132
    assert int8_scan.b1_layout(4096, 262_144, 768, 80, 132)[::2] == (64, 128)
    assert int8_scan.b1_layout(4096, 1_048_576, 512, 80, 132) == (64, 524_288, 128)
    assert int8_scan.b1_layout(600, 16_384, 32, 80, 132) == (64, 1_280, 128)
    assert int8_scan.b1_layout(256, 500_000, 512, 300, 132)[::2] == (16, 512)
    assert int8_scan.b1_layout(256, 500_000, 512, 200, 132)[::2] == (32, 256)
    assert int8_scan.b1_layout(3, 1000, 64, 1000, 132) == (16, 128, 1024)
