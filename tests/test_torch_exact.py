"""The port's exact fp32 oracle against panoptikon_tpu/ops/exact.py: ids
identical (lowest-row tiebreak), distances within 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panoptikon_tpu.ops import exact as ref
from panoptikon_tpu_torch.ops import exact


def _data(seed=0, n=96, d=24, q=5, groups=30):
    rng = np.random.default_rng(seed)
    corpus = rng.normal(size=(n, d)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)  # embeddings are unit rows
    corpus[10] = corpus[3]  # planted duplicate rows: exact ties
    corpus[50] = corpus[3]
    queries = rng.normal(size=(q, d)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    queries[0] = corpus[3] * 2.0  # cosine ties with rows 3, 10, 50; L2 away from 0
    valid = rng.random(n) > 0.2
    valid[[3, 10, 50]] = True
    group_ids = np.sort(rng.integers(0, groups, n)).astype(np.int32)
    weights = rng.random(n).astype(np.float32) + 0.1
    return corpus, queries, valid, group_ids, weights


@pytest.mark.parametrize("distance", ["cosine", "l2"])
def test_pairwise_distance(distance):
    corpus, queries, *_ = _data()
    got = exact.pairwise_distance(torch.from_numpy(corpus), torch.from_numpy(queries), distance)
    want = ref.pairwise_distance(corpus, queries, distance)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


@pytest.mark.parametrize("aggregation", ["min", "max", "avg", "weighted"])
def test_aggregate_rows(aggregation):
    corpus, queries, valid, gids, weights = _data(seed=1)
    dist = np.array(ref.pairwise_distance(corpus, queries))[1]
    w = weights if aggregation == "weighted" else None
    agg = "min" if aggregation == "weighted" else aggregation
    gv, gok = exact.aggregate_rows(
        torch.from_numpy(dist), torch.from_numpy(gids), 32, agg,
        row_valid=torch.from_numpy(valid), weights=None if w is None else torch.from_numpy(w),
    )
    rv, rok = ref.aggregate_rows(dist, gids, 32, agg, row_valid=valid, weights=w)
    np.testing.assert_array_equal(gok.numpy(), np.asarray(rok))
    np.testing.assert_allclose(gv.numpy(), np.asarray(rv), atol=1e-6, rtol=0)


def test_topk_tiebreak_lowest_index():
    values = np.array([0.5, 0.1, 0.5, 0.1, 0.3, 0.1, -0.0, 0.0, 0.5], np.float32)
    valid = np.array([1, 1, 1, 1, 1, 1, 1, 1, 0], bool)
    for k in (3, 6, 9):
        _, gi, gok = exact.topk_ascending(torch.from_numpy(values), torch.from_numpy(valid), k)
        _, ri, rok = ref.topk_ascending(jnp.asarray(values), jnp.asarray(valid), k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
        np.testing.assert_array_equal(gok.numpy(), np.asarray(rok))
        _, gi, _ = exact.topk_descending(torch.from_numpy(values), torch.from_numpy(valid), k)
        _, ri, _ = ref.topk_descending(jnp.asarray(values), jnp.asarray(valid), k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))


@pytest.mark.parametrize("distance", ["cosine", "l2"])
@pytest.mark.parametrize("aggregation", ["min", "avg"])
def test_exact_search(distance, aggregation):
    corpus, queries, valid, gids, _ = _data(seed=2)
    gd, gi, gok = exact.exact_search(
        torch.from_numpy(corpus), torch.from_numpy(valid), torch.from_numpy(gids),
        torch.from_numpy(queries), num_groups=32, k=8, distance=distance, aggregation=aggregation,
    )
    rd, ri, rok = ref.exact_search(
        corpus, valid, gids, queries, num_groups=32, k=8, distance=distance, aggregation=aggregation,
    )
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(gok.numpy(), np.asarray(rok))
    np.testing.assert_allclose(gd.numpy(), np.asarray(rd), atol=1e-6, rtol=0)
