"""Multi-space RRF fusion on tensors — the port of ``panoptikon_tpu/ops/fusion.py``.

Per-space ranked candidate lists (or whole score surfaces) fuse by
reciprocal-rank fusion, ``Σ_s w_s / (rrf_k_s + rank_s)``, and one top-k
extracts the page. The host certifies a fused page from the integer ranks
against the kk-th f32 total (``pql/executor.py``), so the f32 totals here
equal the JAX package's bit for bit:

- ranks come from stable sorts (``jnp.argsort`` is stable), twice for the
  inverse permutation;
- the slot→item scatter takes the smallest rank (``.at[].min``) into an
  ``n_items + 1`` buffer whose last slot is scrap;
- contributions are f32 ``w / (rrf_k + rank)`` and the spaces add in their
  order, as do ``rrf_fuse_candidates``' S − 1 shifted adds;
- the top-k prefers the lowest position among equal totals, as
  ``lax.top_k`` does: ``exact.smallest_k`` on the negated totals.

Exactness bound (for serving layers that must match a full-rank oracle): an
item absent from every space's candidate list has fused total
< Σ_s w_s/(rrf_k + kk + 1); a k-th total at or above it proves the page
equal to full-rank RRF, else the caller falls back to full surfaces
(:func:`rrf_fuse_full`).
"""

from __future__ import annotations

import torch

from panoptikon_tpu_torch.ops.exact import smallest_k

RANK_MISSING = 2**31 - 1
_ID_LIMIT = 2**30


def candidate_exactness_bound(weights, rrf_k, kk: int) -> float:
    """Max possible fused total for an item outside all candidate lists.
    ``rrf_k`` may be one float or a per-space sequence."""
    try:
        ks = list(rrf_k)
    except TypeError:
        ks = [rrf_k] * len(list(weights))
    return float(sum(w / (kf + kk + 1.0) for w, kf in zip(weights, ks)))


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _largest_k(values: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """k largest along the last axis, lowest position first among ties."""
    neg, pos = smallest_k(-values, k)
    return -neg, pos


def _ranks(key: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """1-based int32 rank of every entry along the last axis (ties by
    position), ``RANK_MISSING`` where not valid."""
    order = torch.argsort(key, dim=-1, stable=True)
    rank = torch.argsort(order, dim=-1, stable=True).to(torch.int32) + 1
    return torch.where(valid, rank, RANK_MISSING)


def _item_ranks(rank: torch.Tensor, idx, n_items: int, off) -> torch.Tensor:
    """Slot ranks (..., M) → item ranks (..., n_items): a shifted copy when
    the slot→item map is contiguous (item = slot + ``off``), else the
    smallest rank scattered per item (slots mapped outside [0, n_items) land
    in a scrap slot)."""
    if off is not None:
        ir = torch.full((*rank.shape[:-1], n_items), RANK_MISSING, dtype=torch.int32,
                        device=rank.device)
        lo, hi = min(off, n_items), min(off + rank.shape[-1], n_items)
        ir[..., lo:hi] = rank[..., :hi - lo]
        return ir
    idx = torch.as_tensor(idx, device=rank.device).to(torch.int64)
    safe = torch.where((idx >= 0) & (idx < n_items), idx, n_items).expand(rank.shape)
    ir = torch.full((*rank.shape[:-1], n_items + 1), RANK_MISSING, dtype=torch.int32,
                    device=rank.device)
    return ir.scatter_reduce(-1, safe, rank, "amin", include_self=True)[..., :n_items]


def rrf_fuse_candidates(cand_ids, weights, *, k: int, rrf_k=60.0):
    """Fuse S spaces' ranked candidate ids → fused top-k per query.

    cand_ids: (S, Q, kk) int — each space's top-kk ids in rank order
    (invalid slots: an id < 0 or ≥ 2^30; they contribute nothing).
    weights: (S,); rrf_k: one value or (S,) per-space constants. Returns
    (totals (Q, k) f32, ids (Q, k)).

    The join sorts ids per query; an id appears at most once per space, so
    at most S adjacent entries share one, and S − 1 shifted adds sum them
    into the first."""
    s, q, kk = cand_ids.shape
    dev = cand_ids.device
    ranks = torch.arange(1, kk + 1, dtype=torch.float32, device=dev)
    rrf_ks = _f32(rrf_k, dev).reshape(-1, 1, 1).expand(s, 1, 1)
    contrib = _f32(weights, dev)[:, None, None] / (rrf_ks + ranks[None, None, :])
    contrib = contrib.expand(s, q, kk)
    valid = (cand_ids >= 0) & (cand_ids < _ID_LIMIT)
    contrib = torch.where(valid, contrib, 0.0)
    safe_ids = torch.where(valid, cand_ids, _ID_LIMIT)

    flat_ids = safe_ids.transpose(0, 1).reshape(q, s * kk)
    flat_sc = contrib.transpose(0, 1).reshape(q, s * kk)
    order = torch.argsort(flat_ids, dim=1, stable=True)
    sid = torch.gather(flat_ids, 1, order)
    ssc = torch.gather(flat_sc, 1, order)
    total = ssc.clone()
    width = sid.shape[1]
    for shift in range(1, s):
        same = sid[:, shift:] == sid[:, :-shift]
        total[:, :width - shift] = total[:, :width - shift] + torch.where(same, ssc[:, shift:], 0.0)
    first = torch.cat([torch.ones_like(sid[:, :1], dtype=torch.bool), sid[:, 1:] != sid[:, :-1]],
                      dim=1)
    fused = torch.where(first & (sid < _ID_LIMIT), total, -torch.inf)
    top_v, pos = _largest_k(fused, k)
    return top_v, torch.gather(sid, 1, pos)


def rank_join_topk_batch(surfs, valids, item_idx, weights, rrf_ks, *, kk: int, n_items: int,
                         contig_offsets=None):
    """Exact RRF rank join of B queries at once: :func:`rank_join_topk` row
    by row, every stage row-independent, so a row equals its solo run.

    surfs/valids: sequences of (B, M_s); item_idx: (M_s,) slot→item maps
    shared by the batch; weights/rrf_ks: (B, S) — each query its own
    ``Rrf{k, weight}``. Returns (cand_items (B, kk) int32, cand_ranks
    (B, kk, S) int32 with ``RANK_MISSING`` for absent, totals (B, kk) f32)."""
    if contig_offsets is None:
        contig_offsets = (None,) * len(surfs)
    dev = surfs[0].device
    weights, rrf_ks = _f32(weights, dev), _f32(rrf_ks, dev)
    total = torch.zeros((surfs[0].shape[0], n_items), dtype=torch.float32, device=dev)
    item_ranks = []
    for si, (surf, valid, idx, off) in enumerate(zip(surfs, valids, item_idx, contig_offsets)):
        rank = _ranks(torch.where(valid, surf, torch.inf), valid)
        ir = _item_ranks(rank, idx, n_items, off)
        item_ranks.append(ir)
        contrib = weights[:, si, None] / (rrf_ks[:, si, None] + ir.to(torch.float32))
        total = total + torch.where(ir < RANK_MISSING, contrib, 0.0)
    t32, cand = _largest_k(total, kk)
    cand_ranks = torch.stack([torch.gather(ir, 1, cand) for ir in item_ranks], dim=2)
    return cand.to(torch.int32), cand_ranks, t32


def rank_join_topk(surfs, valids, item_idx, weights, rrf_ks, *, kk: int, n_items: int,
                   contig_offsets=None):
    """Exact RRF rank join over whole score surfaces.

    Per-space distance surfaces become per-slot ranks by a double stable
    argsort, move into a shared item-id domain (a shifted copy for a
    contiguous map, else a min-scatter), and fuse as Σ w/(k + rank); only
    the top-kk candidates (ids, their per-space ranks, f32 totals) leave the
    device, and the host recomputes exact totals from the integer ranks.

    surfs/valids/item_idx: sequences of (M_s,) ascending-better f32 scores,
    validity and slot→item maps (−1 = padding); ties rank by slot.
    weights/rrf_ks: (S,). Returns (cand_items (kk,) int32, cand_ranks
    (kk, S) int32 with ``RANK_MISSING`` for absent, totals (kk,) f32)."""
    if contig_offsets is None:
        contig_offsets = (None,) * len(surfs)
    dev = surfs[0].device
    weights, rrf_ks = _f32(weights, dev), _f32(rrf_ks, dev)
    total = torch.zeros(n_items, dtype=torch.float32, device=dev)
    item_ranks = []
    for si, (surf, valid, idx, off) in enumerate(zip(surfs, valids, item_idx, contig_offsets)):
        rank = _ranks(torch.where(valid, surf, torch.inf), valid)
        ir = _item_ranks(rank, idx, n_items, off)
        item_ranks.append(ir)
        contrib = weights[si] / (rrf_ks[si] + ir.to(torch.float32))
        total = total + torch.where(ir < RANK_MISSING, contrib, 0.0)
    t32, cand = _largest_k(total, kk)
    cand_ranks = torch.stack([ir[cand] for ir in item_ranks], dim=1)
    return cand.to(torch.int32), cand_ranks, t32


def rrf_fuse_full(dists, valids, weights, *, k: int, rrf_k: float = 60.0):
    """Full-surface RRF: per-space (Q, M) distances over a shared id domain
    → exact fused top-k. Ranks come from a stable per-space argsort
    (ascending distance, invalid last); invalid entries contribute nothing.

    dists, valids: (S, Q, M); weights: (S,). Returns (totals (Q, k),
    ids (Q, k)), ids being column indices."""
    masked = torch.where(valids, dists, torch.inf)
    order = torch.argsort(masked, dim=2, stable=True)
    rank = torch.argsort(order, dim=2, stable=True).to(torch.float32)
    contrib = _f32(weights, dists.device)[:, None, None] / (rrf_k + rank + 1.0)
    contrib = torch.where(valids, contrib, 0.0)
    totals = contrib[0]
    for s in range(1, contrib.shape[0]):
        totals = totals + contrib[s]
    totals = torch.where(valids.any(dim=0), totals, -torch.inf)
    return _largest_k(totals, k)
