"""Scoring surface on tensors — the port of ``panoptikon_tpu/ops/scoring.py``.

The serving fast path, :func:`int8_topk_rescored`, takes its oversampled
candidates from a fused int8 scan and re-ranks them exactly against the f32
rows in plain PyTorch, as the JAX version left its rescore to XLA. The JAX
version takes its k·oversample candidates from ``lax.approx_min_k`` at every
Q and k, which has no PyTorch counterpart; :func:`candidate_route` maps that
stage by shape onto the JAX package's two scan kernels and one plain
product: up to 512 queries (``int8_scan.V1_MAX_QUERIES``, the JAX package's
split) the exact scan (``int8_scan.int8_topk``, B1); above it the
lane-bucket scan (``int8_scan.int8_topk_v2``, B2), whose contract is
``approx_min_k``'s — within one (2048-row tile, lane) only the best row
survives, and the ×8 oversampled rescore absorbs the loss — where its tiles
give k·oversample candidates, else B1; and where B1's k limit
(``int8_scan.MAX_K``) and B2's tiles both fall short, the exact surface
(:func:`surface_topk`). On the CPU every route takes plain PyTorch.

Distances over int8 codes follow the reference's quant arm: cosine on codes
equals cosine on the dequantized vectors (the scale cancels); L2 on codes is
the true distance ÷ scale, rescaled here by the frozen scale.

The executor's surfaces come from :func:`grouped_scores`, whose dots on the
card are ``torch._int_mm`` (``exact.int_mm``), as the JAX package takes them
from XLA's integer product outside any Pallas kernel; its top-k, masked
top-k and gathers follow (:func:`topk_of_scores`,
:func:`masked_topk_of_scores`, :func:`gather_of_scores`,
:func:`gather_rows_of_scores`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from panoptikon_tpu_torch.ops import int8_scan
from panoptikon_tpu_torch.ops.exact import (
    INF, Aggregation, Distance, int8_dots, int_mm, row_sumsq, smallest_k, topk_ascending,
)


def row_sumsq_chunked(corpus: torch.Tensor, chunk_rows: int = 250_000) -> torch.Tensor:
    """:func:`row_sumsq` a slice at a time: the widened square is 8 bytes per
    int8 element, 4 GiB at 1M×512 if taken whole."""
    n = corpus.shape[0]
    if n <= chunk_rows:
        return row_sumsq(corpus)
    return torch.cat([row_sumsq(corpus[i:i + chunk_rows]) for i in range(0, n, chunk_rows)])


# Rows a pass of the f32 dots converts to f64 (512 MB at D = 512).
F64_CHUNK_ROWS = 131072


def _chunk_dots(queries: torch.Tensor, chunk: torch.Tensor) -> torch.Tensor:
    """(Q, D) × (C, D)ᵀ. int8 inputs give exact int32 dots; others f32
    dots of the f32 values, accumulated in f64 and rounded once (as
    ``row_sumsq`` sums squares), so that they are the same on the card and
    on the CPU and a row's dot with itself is its sum of squares.

    On the card the int8 product is ``torch._int_mm`` (``exact.int_mm``) over
    the rows up to the last multiple of 8, so that the corpus is read in place
    (a ragged row count would make ``int_mm`` pad, that is copy, the corpus);
    the last rows, and a width not a multiple of 8, go through
    ``exact.int8_dots``. Both are exact, so the dots are the same on any
    device."""
    if chunk.dtype != torch.int8:
        qd = queries.to(torch.float32).to(torch.float64)
        return torch.cat([
            (qd @ chunk[i:i + F64_CHUNK_ROWS].to(torch.float64).T).to(torch.float32)
            for i in range(0, chunk.shape[0], F64_CHUNK_ROWS)
        ], dim=1)
    queries = queries.to(torch.int8)
    if chunk.device.type != "cuda" or chunk.shape[1] % 8:
        return int8_dots(queries, chunk)
    n8 = chunk.shape[0] - chunk.shape[0] % 8
    dots = int_mm(queries, chunk[:n8].t())
    if n8 == chunk.shape[0]:
        return dots
    return torch.cat([dots, int8_dots(queries, chunk[n8:])], dim=1)


def _distance_epilogue(dots, chunk_sumsq, query_sumsq, distance: Distance, scale: float):
    """Dot products -> distances on the true axis, all f32, in the JAX
    package's formula, every step correctly rounded: the square root is
    taken in f64 and rounded once (PyTorch's vectorised f32 ``sqrt`` on the
    CPU is not always correctly rounded), so the values are the same on the
    card and on the CPU. The scan kernel's own roundings (the L2 sum in
    integers, correctly rounded roots) are ``int8_scan._distances``, which
    the kernel's plain version uses."""
    dots = dots.to(torch.float32)
    xx = chunk_sumsq.to(torch.float32)[None, :]
    qq = query_sumsq.to(torch.float32)[:, None]
    if distance == "cosine":
        return 1.0 - dots / _sqrt_rn(torch.clamp(xx * qq, min=1e-30))
    if distance == "l2":
        root = _sqrt_rn(torch.clamp(qq - 2.0 * dots + xx, min=0.0))
        return torch.tensor(scale, dtype=torch.float32, device=root.device) * root
    raise ValueError(f"Unknown distance {distance!r}")


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root (the f64 root of an f32 rounds
    to f32 without a double-rounding error)."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def exact_oneshot(corpus, row_valid, queries, *, k: int, distance: Distance = "cosine"):
    """One-shot exact fp32 top-k (materializes (Q, N); TF32 is off, see
    ``ops.exact``). Returns (dist, row_idx, valid)."""
    corpus = corpus.to(torch.float32)
    queries = queries.to(torch.float32)
    dots = queries @ corpus.T
    dist = _distance_epilogue(dots, row_sumsq(corpus), row_sumsq(queries), distance, 1.0)
    top_v, idx = smallest_k(torch.where(row_valid[None, :], dist, INF), k)
    return top_v, idx, torch.isfinite(top_v)


def streaming_topk(
    corpus, sumsq, row_valid, queries, *, k: int, distance: Distance = "cosine",
    scale: float = 1.0, chunk_rows: int = 32768,
):
    """Top-k rows per query, one corpus chunk at a time; ascending distance,
    lowest row first among ties. corpus (N, D) int8 codes or f32, N a
    multiple of ``chunk_rows``; queries in the corpus's domain.

    Kept as the counterpart of the JAX package's streaming fallback, which
    ``bench.py`` and the recall probes under ``tools/`` use as their oracle;
    nothing in the port's serving path calls it (``int8_topk_rescored``
    takes the scan, whose plain version serves CPU tensors)."""
    n = corpus.shape[0]
    if n % chunk_rows:
        raise ValueError(f"corpus rows {n} must be a multiple of chunk_rows {chunk_rows}")
    query_sumsq = row_sumsq(queries)
    q = queries.shape[0]
    top_v = torch.full((q, k), INF, dtype=torch.float32, device=corpus.device)
    top_i = torch.full((q, k), torch.iinfo(torch.int32).max, dtype=torch.int64, device=corpus.device)
    for lo in range(0, n, chunk_rows):
        hi = lo + chunk_rows
        dist = _distance_epilogue(
            _chunk_dots(queries, corpus[lo:hi]), sumsq[lo:hi], query_sumsq, distance, scale
        )
        dist = torch.where(row_valid[None, lo:hi], dist, INF)
        rows = torch.arange(lo, hi, device=corpus.device).expand(q, -1)
        # Carried rows come first and are lower than this chunk's, so the
        # positional tiebreak is the ascending-row tiebreak.
        cand_v = torch.cat([top_v, dist], dim=1)
        cand_i = torch.cat([top_i, rows], dim=1)
        top_v, sel = smallest_k(cand_v, k)
        top_i = torch.gather(cand_i, 1, sel)
    return top_v, top_i, torch.isfinite(top_v)


# The exact surface's queries a pass: its (Q_chunk, N) f32 distances stay
# within this many bytes (the epilogue's f64 and int64 temporaries take up
# to three times more while a pass runs).
SURFACE_BYTES = 512 * 2**20


def candidate_route(q: int, n: int, kk: int) -> str:
    """Which stage gives ``int8_topk_rescored`` its kk candidates for Q
    queries over N rows: ``"b1"`` (exact) where kk ≤ ``MAX_K`` and either
    Q ≤ ``V1_MAX_QUERIES`` or B2's tiles give fewer than kk; else ``"b2"``
    (the ``approx_min_k`` contract) where they give kk; else ``"surface"``
    (exact, no k limit). Every route gives kk candidates."""
    b2_candidates = -(-n // int8_scan.V2_TILE_N) * int8_scan.V2_K_TILE
    if kk <= int8_scan.MAX_K and (q <= int8_scan.V1_MAX_QUERIES or b2_candidates < kk):
        return "b1"
    return "b2" if b2_candidates >= kk else "surface"


def surface_topk(codes, sumsq, row_valid, q_codes, *, k: int, distance: Distance = "cosine",
                 scale: float = 1.0):
    """The exact k smallest (distance, row) of int8 query codes against int8
    corpus codes at any k ≤ N: the int8 dots as a plain product (on the card
    ``torch._int_mm`` through ``exact.int_mm``, on the CPU
    ``exact.int8_dots``), B1's epilogue (``int8_scan._distances``, so the
    distances are B1's bit for bit), invalid rows at +inf, then
    ``smallest_k``, lowest row first among equal distances. A pass takes as
    many queries as keep its f32 surface within ``SURFACE_BYTES``.
    Returns (dist (Q, k) f32, row (Q, k) int64, valid (Q, k) bool)."""
    n = codes.shape[0]
    if not 1 <= k <= n:
        raise ValueError(f"k={k} must be in [1, N={n}]")
    on_card = codes.device.type == "cuda"
    qq = row_sumsq(q_codes)
    step = max(1, SURFACE_BYTES // (4 * n))
    out_v, out_i = [], []
    for lo in range(0, q_codes.shape[0], step):
        part = q_codes[lo:lo + step]
        dots = int_mm(part, codes.t()) if on_card else int8_dots(part, codes)
        dist = int8_scan._distances(dots, sumsq, qq[lo:lo + step], distance, scale)
        del dots
        top_v, rows = smallest_k(torch.where(row_valid[None, :], dist, INF), k)
        out_v.append(top_v)
        out_i.append(rows)
    if on_card:
        surface_topk.launches += 1
    top_v = torch.cat(out_v)
    return top_v, torch.cat(out_i), torch.isfinite(top_v)


surface_topk.launches = 0


def rescore_candidates(cand_v, cand_i, corpus_f32, q_f32, *, k: int, distance: Distance = "cosine"):
    """Exact f32 re-rank of (Q, kk) candidates, lowest candidate position
    first among equal distances. Candidates at +inf stay at +inf."""
    cand_rows = corpus_f32[cand_i].to(torch.float32)  # (Q, kk, D)
    qf = q_f32.to(torch.float32)
    cdots = torch.einsum("qd,qkd->qk", qf, cand_rows)
    if distance == "cosine":
        cn = torch.linalg.norm(cand_rows, dim=-1)
        qn = torch.linalg.norm(qf, dim=-1)[:, None]
        exact_d = 1.0 - cdots / torch.clamp(cn * qn, min=1e-30)
    else:
        csq = torch.sum(cand_rows * cand_rows, dim=-1)
        qsq = torch.sum(qf * qf, dim=-1)[:, None]
        exact_d = torch.sqrt(torch.clamp(qsq - 2.0 * cdots + csq, min=0.0))
    exact_d = torch.where(torch.isfinite(cand_v), exact_d, INF)
    top_v, sel = smallest_k(exact_d, k)
    return top_v, torch.gather(cand_i, 1, sel), torch.isfinite(top_v)


def int8_topk_rescored(
    codes, sumsq, row_valid, corpus_f32, q_codes, q_f32, *, k: int,
    oversample: int = 8, distance: Distance = "cosine", scale: float = 1.0,
    rescore: bool = True,
):
    """The serving fast path: int8 candidates (k·oversample) + f32 rescore.

    Candidates, cosine or L2 (code-space L2 × ``scale``), come from the
    stage :func:`candidate_route` names — B1 (``int8_scan.int8_topk``,
    exact), B2 (``int8_scan.int8_topk_v2``, the ``approx_min_k`` contract)
    or the exact surface (:func:`surface_topk`) — each on the card for CUDA
    tensors and in plain PyTorch for CPU ones; every route gives
    min(k·oversample, N) candidates.
    Returns (dist (Q,k), row (Q,k), valid (Q,k))."""
    kk = min(k * oversample, codes.shape[0])
    route = candidate_route(q_codes.shape[0], codes.shape[0], kk)
    scan = {"b1": int8_scan.int8_topk, "b2": int8_scan.int8_topk_v2, "surface": surface_topk}[route]
    cand_v, cand_i, _ = scan(codes, sumsq, row_valid, q_codes, k=kk, distance=distance, scale=scale)
    if not rescore:
        return cand_v[:, :k], cand_i[:, :k], torch.isfinite(cand_v[:, :k])
    # A corpus of fewer than k rows gives fewer than k candidates: the list
    # pads to k at +inf. A candidate at +inf (past the valid rows; B2's carries
    # the sentinel row past the corpus) stays at +inf through the rescore and
    # gathers row 0 instead.
    if cand_v.shape[1] < k:
        cand_v = F.pad(cand_v, (0, k - cand_v.shape[1]), value=INF)
        cand_i = F.pad(cand_i, (0, k - cand_i.shape[1]))
    cand_i = torch.where(torch.isfinite(cand_v), cand_i, 0)
    return rescore_candidates(cand_v, cand_i, corpus_f32, q_f32, k=k, distance=distance)


def grouped_scores(
    corpus, sumsq, row_valid, group_ids, queries, *, num_groups: int,
    distance: Distance = "cosine", aggregation: Aggregation = "min", scale: float = 1.0,
    chunk_rows: int = 32768, weighted: bool = False, weights=None, identity: bool = False,
):
    """Full per-group score surfaces: (Q, num_groups) distances, validity and
    contributing row counts (weight sums when ``weighted``).

    Rows stream ``chunk_rows`` at a time into per-group MIN, MAX or AVG, or
    the weighted average ``SUM(d·w)/SUM(w)`` when ``weighted``; invalid rows
    go to a scrap group ``num_groups``, as do group ids outside
    [0, num_groups), which the JAX segment reductions drop. MIN, MAX and the
    counts are exact reductions, so they equal the JAX function's bit for
    bit wherever its per-row distances are this epilogue's (the L2 one; XLA
    turns cosine's d / sqrt(x) into d · rsqrt(x), ulps away); AVG and the
    weighted average are f32 sums in another order. ``identity`` (row i is
    group slot i, ``num_groups`` ≤ N) skips the segments: the surface is the
    per-row epilogue."""
    n = corpus.shape[0]
    query_sumsq = row_sumsq(queries)
    if identity and not weighted:
        dots = _chunk_dots(queries, corpus)
        dist = _distance_epilogue(dots, sumsq, query_sumsq, distance, scale)
        dist = torch.where(row_valid[None, :], dist, INF)[:, :num_groups]
        group_valid = row_valid[None, :num_groups].expand(dist.shape)
        return dist, group_valid, group_valid.to(torch.float32)
    if n % chunk_rows:
        raise ValueError(f"corpus rows {n} must be a multiple of chunk_rows {chunk_rows}")
    q, m, dev = queries.shape[0], num_groups, corpus.device
    if weights is None:
        weights = torch.ones(n, dtype=torch.float32, device=dev)
    # Accumulators carry the scrap group as their last column.
    if weighted or aggregation == "avg":
        acc = torch.zeros((q, m + 1), dtype=torch.float32, device=dev)
        reduce = "sum"
    elif aggregation in ("min", "max"):
        fill = INF if aggregation == "min" else -INF
        acc = torch.full((q, m + 1), fill, dtype=torch.float32, device=dev)
        reduce = "amin" if aggregation == "min" else "amax"
    else:
        raise ValueError(f"Unknown aggregation {aggregation!r}")
    count = torch.zeros((q, m + 1), dtype=torch.float32, device=dev)
    for lo in range(0, n, chunk_rows):
        hi = lo + chunk_rows
        dist = _distance_epilogue(
            _chunk_dots(queries, corpus[lo:hi]), sumsq[lo:hi], query_sumsq, distance, scale
        )
        valid = row_valid[lo:hi]
        # Invalid rows, and ids outside [0, m) (which the JAX segment
        # reductions drop), go to the scrap group.
        gids = group_ids[lo:hi].to(torch.int64)
        index = torch.where(valid & (gids >= 0) & (gids < m), gids, m).expand(q, -1)
        if weighted:
            w = torch.where(valid, weights[lo:hi].to(torch.float32), 0.0)
            acc.scatter_add_(1, index, dist * w[None, :])
            count.scatter_add_(1, index, w.expand(q, -1))
            continue
        if reduce == "sum":
            acc.scatter_add_(1, index, torch.where(valid[None, :], dist, 0.0))
        else:
            acc.scatter_reduce_(1, index, torch.where(valid[None, :], dist, fill), reduce,
                                include_self=True)
        count.scatter_add_(1, index, valid.to(torch.float32).expand(q, -1))
    acc, count = acc[:, :m], count[:, :m]
    group_valid = count > 0
    if weighted:
        group_dist = acc / torch.clamp(count, min=1e-30)
    elif aggregation == "avg":
        group_dist = acc / torch.clamp(count, min=1.0)
    else:
        group_dist = acc
    return torch.where(group_valid, group_dist, INF), group_valid, count


def topk_of_scores(dist, valid, *, kk: int, largest: bool = False):
    """Exact top-kk over a (Q, M) score surface, lowest slot first among
    ties; invalid slots come back at ±inf and not valid."""
    if largest:
        neg, idx = smallest_k(-torch.where(valid, dist, -INF), kk)
        top_v = -neg
    else:
        top_v, idx = smallest_k(torch.where(valid, dist, INF), kk)
    return top_v, idx, torch.isfinite(top_v)


def masked_topk_of_scores(dist, valid, mask, *, kk: int, largest: bool = False):
    """:func:`topk_of_scores` restricted to a (Q, M) or (1, M) bool mask of
    groups in scope."""
    return topk_of_scores(dist, valid & mask, kk=kk, largest=largest)


def gather_of_scores(dist, valid, idx):
    """The scores of given slots off a (Q, M) surface: ``idx`` (S,) slot
    numbers, −1 for padding. Returns ((Q, S) values, +inf where not valid;
    (Q, S) validity)."""
    idx = idx.to(torch.int64)
    safe = torch.clamp(idx, 0, dist.shape[1] - 1)
    ok = (idx >= 0)[None, :] & valid[:, safe]
    return torch.where(ok, dist[:, safe], INF), ok


def gather_rows_of_scores(dist, valid, idx):
    """:func:`gather_of_scores` with each of the Q rows gathering its own
    slots: ``idx`` (Q, S), −1 for padding."""
    idx = idx.to(torch.int64)
    safe = torch.clamp(idx, 0, dist.shape[1] - 1)
    ok = (idx >= 0) & torch.gather(valid, 1, safe)
    return torch.where(ok, torch.gather(dist, 1, safe), INF), ok


def streaming_grouped_topk(
    corpus, sumsq, row_valid, group_ids, queries, *, num_groups: int, k: int,
    distance: Distance = "cosine", aggregation: Aggregation = "min", scale: float = 1.0,
    chunk_rows: int = 32768, weighted: bool = False, weights=None,
):
    """Top-k groups per query: :func:`grouped_scores`, then the k smallest,
    lowest group first among ties. Returns (dist, group, valid), each (Q, k)."""
    group_dist, group_valid, _ = grouped_scores(
        corpus, sumsq, row_valid, group_ids, queries, num_groups=num_groups,
        distance=distance, aggregation=aggregation, scale=scale, chunk_rows=chunk_rows,
        weighted=weighted, weights=weights,
    )
    return topk_ascending(group_dist, group_valid, k)
