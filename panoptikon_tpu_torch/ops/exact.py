"""Exact fp32 vector scorer — the brute-force ground truth, on tensors.

Port of ``panoptikon_tpu/ops/exact.py``: the same distances (L2, cosine),
per-item aggregation (MIN/MAX/AVG, or ``SUM(d·w)/SUM(w)`` with weights) and
deterministic order (ties broken by ascending position).

Two choices carry the reference's guarantees over:

- TF32 is switched off for matmuls and cuDNN. The JAX oracle pins
  ``Precision.HIGHEST``; on the card an f32 product in TF32 keeps about three
  decimal digits, which would put noise into the baseline itself.
- ``lax.top_k`` prefers the lowest position among equal values, and
  ``torch.topk`` promises no order among ties. Top-k here runs on packed
  int64 keys, ``(order-preserving int32 of the value) << 32 | position``:
  every key is unique, so the smallest k keys are the smallest values with
  the lowest positions first, on any device.
"""

from __future__ import annotations

from typing import Literal

import numpy as np
import torch
import torch.nn.functional as F

Distance = Literal["l2", "cosine"]
Aggregation = Literal["min", "max", "avg"]

INF = float("inf")

# The oracle must be exact f32 on the card (see the module docstring).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def pack_keys(values: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """(f32 value, int position < 2**32) -> int64 key, ordered by value then
    position. The order is IEEE total order, as ``lax.top_k``'s: ``-0.0``
    sorts before ``+0.0``."""
    bits = values.to(torch.float32).contiguous().view(torch.int32)
    ordered = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    return (ordered.to(torch.int64) << 32) | index.to(torch.int64)


def unpack_keys(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`pack_keys`: (f32 values, int64 positions)."""
    hi = (keys >> 32).to(torch.int32)
    bits = hi ^ ((hi >> 31) & 0x7FFFFFFF)
    return bits.view(torch.float32), keys & 0xFFFFFFFF


def int8_dots(queries: torch.Tensor, codes: torch.Tensor, chunk_rows: int = 131072) -> torch.Tensor:
    """Exact int8 dot products (Q, D) x (N, D)^T -> (Q, N) int32.

    Through f64, which holds every such dot exactly for any D, on any
    device (:func:`int_mm` is the card's integer GEMM); ``chunk_rows``
    bounds the f64 copy."""
    qd = queries.to(torch.float64)
    return torch.cat([
        (qd @ codes[i:i + chunk_rows].to(torch.float64).T).to(torch.int32)
        for i in range(0, codes.shape[0], chunk_rows)
    ], dim=1)


def int_mm(a, b):
    """(M, K) int8 × (K, N) int8 -> (M, N) int32, exact, through
    ``torch._int_mm``. Its CUDA path (cuBLASLt) takes M > 16 and K and N
    multiples of 8, and runs fastest with B column-major (``chip_smoke.py``
    times both layouts at the ViT-L/14 qkv GEMM). The rule is applied on
    every device: short or ragged operands are zero-padded (which adds
    nothing to a dot), the result is cut back, and a row-major B is copied
    to column-major (``clip._quantize_weight`` stores weights that way, so
    the block's GEMMs copy nothing)."""
    m, k = a.shape
    n = b.shape[1]
    pad_m, pad_k, pad_n = max(17 - m, 0), -k % 8, -n % 8
    if pad_m or pad_k:
        a = F.pad(a, (0, pad_k, 0, pad_m))
    if pad_k or pad_n:
        b = F.pad(b, (0, pad_n, 0, pad_k))
    if not b.t().is_contiguous():
        b = b.t().contiguous().t()
    return torch._int_mm(a.contiguous(), b)[:m, :n]


def row_sumsq(corpus: torch.Tensor) -> torch.Tensor:
    """Per-row sum of squares: int8 codes -> int32 (exact up to
    D = 131072), anything else -> f32, summed in f64 from the f32 values
    and rounded once, so that it is the same on every device and equals
    the f32 self-dot of ``scoring._chunk_dots``."""
    if corpus.dtype == torch.int8:
        wide = corpus.to(torch.int32)
        return torch.sum(wide * wide, dim=-1, dtype=torch.int32)
    step = 131072  # rows widened to f64 at a time
    return torch.cat([
        torch.sum(torch.square(corpus[i:i + step].to(torch.float32).to(torch.float64)), dim=-1)
        for i in range(0, max(corpus.shape[0], 1), step)
    ]).to(torch.float32)


def smallest_k(values: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """k smallest along the last axis, lowest position first among ties.
    Returns (values, int64 positions), ascending."""
    pos = torch.arange(values.shape[-1], device=values.device).expand(values.shape)
    keys = torch.topk(pack_keys(values, pos), k, dim=-1, largest=False, sorted=True).values
    return unpack_keys(keys)


def pairwise_distance(corpus, queries, distance: Distance = "cosine") -> torch.Tensor:
    """corpus (N, D), queries (Q, D) -> (Q, N) f32 distances.

    L2 expands ``|x−q|² = |x|² − 2x·q + |q|²`` into one matmul; the clamp
    guards the small negatives that cancellation produces."""
    corpus = corpus.to(torch.float32)
    queries = queries.to(torch.float32)
    dots = queries @ corpus.T
    if distance == "cosine":
        denom = torch.linalg.norm(queries, dim=-1)[:, None] * torch.linalg.norm(corpus, dim=-1)[None, :]
        return 1.0 - dots / torch.clamp(denom, min=1e-30)
    if distance == "l2":
        corpus_sq = torch.sum(corpus * corpus, dim=-1)
        query_sq = torch.sum(queries * queries, dim=-1)
        return torch.sqrt(torch.clamp(query_sq[:, None] - 2.0 * dots + corpus_sq[None, :], min=0.0))
    raise ValueError(f"Unknown distance {distance!r}")


def aggregate_rows(
    row_dist: torch.Tensor,
    group_ids: torch.Tensor,
    num_groups: int,
    aggregation: Aggregation = "min",
    row_valid: torch.Tensor | None = None,
    weights: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row distances (..., N) -> per-group values (..., num_groups) and
    validity. With ``weights`` the value is ``SUM(d·w)/SUM(w)`` and
    ``aggregation`` is ignored. Invalid rows never contribute; groups with no
    valid row come back invalid at +inf."""
    row_dist = row_dist.to(torch.float32)
    n = row_dist.shape[-1]
    dev = row_dist.device
    if row_valid is None:
        row_valid = torch.ones(n, dtype=torch.bool, device=dev)
    # Invalid rows go to a scrap group so they cannot contribute.
    safe_ids = torch.where(row_valid, group_ids.to(torch.int64), num_groups)
    index = safe_ids.expand(row_dist.shape)
    out_shape = (*row_dist.shape[:-1], num_groups + 1)

    def seg(src, reduce, base):
        init = torch.full(out_shape, base, dtype=torch.float32, device=dev)
        return init.scatter_reduce(-1, index, src, reduce=reduce, include_self=True)[..., :num_groups]

    valid_f = row_valid.to(torch.float32).expand(row_dist.shape)
    counts = seg(valid_f, "sum", 0.0)
    group_valid = counts > 0
    if weights is not None:
        w = torch.where(row_valid, weights.to(torch.float32), 0.0).expand(row_dist.shape)
        group_dist = seg(row_dist * w, "sum", 0.0) / torch.clamp(seg(w, "sum", 0.0), min=1e-30)
    elif aggregation == "min":
        group_dist = seg(torch.where(row_valid, row_dist, INF), "amin", INF)
    elif aggregation == "max":
        group_dist = seg(torch.where(row_valid, row_dist, -INF), "amax", -INF)
    elif aggregation == "avg":
        total = seg(torch.where(row_valid, row_dist, 0.0), "sum", 0.0)
        group_dist = total / torch.clamp(counts, min=1.0)
    else:
        raise ValueError(f"Unknown aggregation {aggregation!r}")
    return torch.where(group_valid, group_dist, INF), group_valid


def topk_ascending(values, valid, k: int):
    """Smallest k along the last axis, lowest index first among ties.
    Returns (values, indices, valid); a tail of fewer than k valid entries
    comes back at +inf and not valid."""
    top_v, idx = smallest_k(torch.where(valid, values, INF), k)
    return top_v, idx, torch.isfinite(top_v)


def topk_descending(values, valid, k: int):
    """Largest k along the last axis, lowest index first among ties."""
    neg, idx = smallest_k(-torch.where(valid, values, -INF), k)
    top_v = -neg
    return top_v, idx, torch.isfinite(top_v)


def exact_search(
    corpus,
    row_valid,
    group_ids,
    queries,
    *,
    num_groups: int,
    k: int,
    distance: Distance = "cosine",
    aggregation: Aggregation = "min",
    weights=None,
):
    """One-shot exact search: queries (Q, D) -> per-query top-k groups.
    Returns (dist (Q, k), group_idx (Q, k), valid (Q, k))."""
    dists = pairwise_distance(corpus, queries, distance)
    group_dist, group_valid = aggregate_rows(
        dists, group_ids, num_groups, aggregation, row_valid=row_valid, weights=weights
    )
    return topk_ascending(group_dist, group_valid, k)


def topk_agree(dist_a, ids_a, dist_b, ids_b, *, atol: float) -> bool:
    """Whether two (Q, k) top-k results are the same up to ties (NumPy).

    Distances agree within ``atol`` rank by rank; every id that differs
    between the two sits in a group of distances tied within ``atol`` — at
    the same rank in the other result's tie group, or at the cut-off, where
    a tie may admit either row."""
    dist_a, ids_a = np.asarray(dist_a), np.asarray(ids_a)
    dist_b, ids_b = np.asarray(dist_b), np.asarray(ids_b)
    if dist_a.shape != dist_b.shape or not np.allclose(dist_a, dist_b, atol=atol, rtol=0):
        return False
    for da, ia, db, ib in zip(dist_a, ids_a, dist_b, ids_b):
        finite = np.isfinite(db)
        cut = db[finite].max() if finite.any() else np.inf
        for j in np.flatnonzero(ia != ib):
            if not np.isfinite(db[j]):
                continue  # both past the valid rows
            where = np.flatnonzero(ib == ia[j])
            tied_inside = where.size and abs(db[where[0]] - db[j]) <= atol
            tied_at_cut = not where.size and abs(da[j] - cut) <= atol
            if not (tied_inside or tied_at_cut):
                return False
    return True
