"""The port's RRF fusion (ops/fusion.py) against panoptikon_tpu/ops/fusion.py
on the same seeded inputs: ids and ranks equal, f32 totals bit for bit
(``assert_array_equal``: the host certifies fused pages against them)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panoptikon_tpu.ops import fusion as ref
from panoptikon_tpu_torch.ops import fusion


def _ties(rng, shape, levels=7):
    """f32 scores drawn from a few levels, so that many tie."""
    return (rng.integers(0, levels, size=shape) / levels).astype(np.float32)


def _candidates(rng, s, q, kk, n_ids):
    """(S, Q, kk) int32 candidate lists: distinct ids per (space, query)
    from a shared domain, with invalid slots (−1, −7, 2^30 and above)."""
    cand = np.stack([np.stack([rng.permutation(n_ids)[:kk] for _ in range(q)])
                     for _ in range(s)]).astype(np.int32)
    holes = rng.random(cand.shape) < 0.15
    cand[holes] = rng.choice(np.array([-1, -7, 2**30, 2**30 + 5], np.int32), size=holes.sum())
    return cand


@pytest.mark.parametrize("s", [1, 2, 3])
@pytest.mark.parametrize("per_space_k", [False, True])
def test_rrf_fuse_candidates(s, per_space_k):
    rng = np.random.default_rng(10 + s)
    q, kk, k = 5, 24, 12
    cand = _candidates(rng, s, q, kk, n_ids=40)
    weights = rng.uniform(0.2, 1.5, size=s).astype(np.float32)
    rrf_k = rng.uniform(1, 80, size=s).astype(np.float32) if per_space_k else 60.0
    rv, ri = ref.rrf_fuse_candidates(jnp.asarray(cand), jnp.asarray(weights), k=k, rrf_k=rrf_k)
    gv, gi = fusion.rrf_fuse_candidates(torch.from_numpy(cand), torch.from_numpy(weights), k=k,
                                        rrf_k=rrf_k)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))


def test_rrf_fuse_candidates_ties_and_short_lists():
    # Equal weights over mirrored lists give equal totals: lowest sorted
    # position (smallest id) first, as lax.top_k orders them; k above the
    # valid count leaves -inf totals on sentinel ids.
    cand = np.array([[[3, 1, 2, -1]], [[1, 3, 2, 2**30]]], np.int32)
    weights = np.ones(2, np.float32)
    rv, ri = ref.rrf_fuse_candidates(jnp.asarray(cand), jnp.asarray(weights), k=4)
    gv, gi = fusion.rrf_fuse_candidates(torch.from_numpy(cand), torch.from_numpy(weights), k=4)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    assert gi.numpy()[0, :3].tolist() == [1, 3, 2] and gv.numpy()[0, 3] == -np.inf


def _surfaces(rng, s, b, sizes):
    surfs = [_ties(rng, (b, m)) for m in sizes[:s]]
    valids = [rng.random((b, m)) < 0.85 for m in sizes[:s]]
    return surfs, valids


def _item_maps(rng, sizes, n_items, contiguous):
    """Per-space slot→item maps: contiguous (item = slot + offset), or
    scattered with padding (−1), repeated items and ids past the domain."""
    maps, offs = [], []
    for si, m in enumerate(sizes):
        if contiguous:
            off = [0, 3, n_items - m + 2][si % 3]  # the last runs past n_items
            maps.append(np.arange(off, off + m, dtype=np.int32))
            offs.append(off)
        else:
            idx = rng.integers(0, n_items, size=m).astype(np.int32)
            idx[rng.random(m) < 0.1] = -1
            idx[0] = n_items + 4
            maps.append(idx)
            offs.append(None)
    return maps, offs


@pytest.mark.parametrize("s", [1, 2, 3])
@pytest.mark.parametrize("contiguous", [False, True])
def test_rank_join_topk(s, contiguous):
    rng = np.random.default_rng(20 + s + 10 * contiguous)
    sizes, n_items, kk = (48, 40, 56), 64, 32
    surfs, valids = _surfaces(rng, s, 1, sizes)
    maps, offs = _item_maps(rng, sizes[:s], n_items, contiguous)
    ws = rng.uniform(0.3, 1.2, size=s).astype(np.float32)
    ks = rng.uniform(5, 70, size=s).astype(np.float32)
    rc, rr, rt = ref.rank_join_topk(
        tuple(jnp.asarray(x[0]) for x in surfs), tuple(jnp.asarray(v[0]) for v in valids),
        tuple(jnp.asarray(m) for m in maps), ws, ks, kk=kk, n_items=n_items,
        contig_offsets=tuple(offs))
    gc, gr, gt = fusion.rank_join_topk(
        tuple(torch.from_numpy(x[0]) for x in surfs), tuple(torch.from_numpy(v[0]) for v in valids),
        tuple(torch.from_numpy(m) for m in maps), ws, ks, kk=kk, n_items=n_items,
        contig_offsets=tuple(offs))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(rc))
    np.testing.assert_array_equal(gr.numpy(), np.asarray(rr))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(rt))
    assert int(fusion.RANK_MISSING) == int(ref.RANK_MISSING)


@pytest.mark.parametrize("s", [1, 2, 3])
@pytest.mark.parametrize("contiguous", [False, True])
def test_rank_join_topk_batch(s, contiguous):
    rng = np.random.default_rng(40 + s + 10 * contiguous)
    sizes, n_items, kk, b = (48, 40, 56), 64, 20, 4
    surfs, valids = _surfaces(rng, s, b, sizes)
    maps, offs = _item_maps(rng, sizes[:s], n_items, contiguous)
    wb = rng.uniform(0.3, 1.2, size=(b, s)).astype(np.float32)
    kb = rng.uniform(5, 70, size=(b, s)).astype(np.float32)
    rc, rr, rt = ref.rank_join_topk_batch(
        tuple(jnp.asarray(x) for x in surfs), tuple(jnp.asarray(v) for v in valids),
        tuple(jnp.asarray(m) for m in maps), wb, kb, kk=kk, n_items=n_items,
        contig_offsets=tuple(offs))
    gc, gr, gt = fusion.rank_join_topk_batch(
        tuple(torch.from_numpy(x) for x in surfs), tuple(torch.from_numpy(v) for v in valids),
        tuple(torch.from_numpy(m) for m in maps), wb, kb, kk=kk, n_items=n_items,
        contig_offsets=tuple(offs))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(rc))
    np.testing.assert_array_equal(gr.numpy(), np.asarray(rr))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(rt))
    # A row of the batch is its solo run.
    solo = fusion.rank_join_topk(
        tuple(torch.from_numpy(x[1]) for x in surfs), tuple(torch.from_numpy(v[1]) for v in valids),
        tuple(torch.from_numpy(m) for m in maps), wb[1], kb[1], kk=kk, n_items=n_items,
        contig_offsets=tuple(offs))
    for got, want in zip(solo, (gc[1], gr[1], gt[1])):
        np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("s", [1, 2, 3])
def test_rrf_fuse_full(s):
    rng = np.random.default_rng(60 + s)
    q, m, k = 4, 50, 9
    dists = _ties(rng, (s, q, m))
    valids = rng.random((s, q, m)) < 0.8
    valids[:, 0, :5] = False  # ids valid in no space
    weights = rng.uniform(0.3, 1.2, size=s).astype(np.float32)
    rv, ri = ref.rrf_fuse_full(jnp.asarray(dists), jnp.asarray(valids), jnp.asarray(weights),
                               k=k, rrf_k=17.0)
    gv, gi = fusion.rrf_fuse_full(torch.from_numpy(dists), torch.from_numpy(valids),
                                  torch.from_numpy(weights), k=k, rrf_k=17.0)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))


@pytest.mark.parametrize("weights,rrf_k,kk", [
    ([1.0, 0.8, 0.6], 60.0, 1024), ([1.0, 0.5], [10.0, 70.0], 128), ([2.0], 1.0, 8)])
def test_candidate_exactness_bound(weights, rrf_k, kk):
    assert fusion.candidate_exactness_bound(weights, rrf_k, kk) == \
        ref.candidate_exactness_bound(weights, rrf_k, kk)
