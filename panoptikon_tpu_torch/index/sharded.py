"""Multi-device query path: corpus sharded over the mesh, merged top-k — the
port of ``panoptikon_tpu/index/sharded.py``.

The embedding matrix is sharded row-block-wise over the mesh's ``shard``
axis; each shard is one slab on one mesh device, scanned by its own launch;
the per-shard top-k candidates are gathered to the first mesh device of
this process and merged there. Queries and results are replicated (on a 2-D
``replica × shard`` mesh the queries split over ``replica``).

Determinism across shards: each shard's candidates carry *global* slots
(``shard · groups_per_shard + local``). After the gather the candidate
sequence is ordered (shard, local rank); the merge takes
``ops.exact.smallest_k``, which prefers lower candidate positions on ties
(as ``lax.top_k`` does, and ``torch.topk`` does not promise), so equal
distances resolve to the lowest global slot — the one-device scorer's total
order.

The per-shard stage: a one-row int8 space takes kernel B1
(``ops/int8_scan.int8_topk``: exact, ascending distance, lowest row first,
invalid rows +inf) wherever k ≤ ``int8_scan.MAX_K`` and the shard's rows and
D % 16 = 0 allow it; otherwise ``scoring.streaming_topk``, and grouped
spaces ``scoring.streaming_grouped_topk`` / ``grouped_scores``, as the
reference's XLA code. On the CPU each takes its plain version.

Item-locality invariant for grouped (multi-row-per-item) spaces:
``build_sharded`` places every item's rows in ONE shard, so per-item aggregation
never crosses a shard boundary and the merge stays a pure top-k.

Across processes (``parallel/multihost.py``) every process packs the same
corpus and holds only its own entries' slabs; the candidates (shard layout)
or the merged results (replica layout) are gathered over the gloo group
through host memory.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from panoptikon_tpu_torch.index.vector_index import SpaceSnapshot
from panoptikon_tpu_torch.ops import int8_scan, scoring
from panoptikon_tpu_torch.ops.exact import smallest_k
from panoptikon_tpu_torch.parallel import multihost
from panoptikon_tpu_torch.parallel.mesh import REPLICA_AXIS, SHARD_AXIS, Mesh


def _query_specs(mesh: Mesh) -> int:
    """Query partitioning: on a 2-D serving mesh the query batch splits over
    ``replica`` (QPS scale-out) while the corpus replicates over it; on the
    1-D mesh queries replicate. Returns the number of query slices."""
    if REPLICA_AXIS in mesh.axis_names:
        return mesh.shape[REPLICA_AXIS]
    return 1


@dataclass
class ShardedSpace:
    """Device-resident sharded layout of one embedding space.

    Rows are logically (S · rows_per_shard, …); ``corpus``, ``sumsq``,
    ``row_valid``, ``group_ids`` and ``weights`` hold one tensor a mesh
    entry (the grid in C order; entry ``r · S + s`` is shard ``s``), None
    where the entry belongs to another process. ``groups_per_shard`` is the
    per-shard group capacity; ``item_ids`` maps a global group slot
    (shard · groups_per_shard + local) → snapshot group slot on the host.
    """

    mesh: Mesh
    num_shards: int
    rows_per_shard: int
    groups_per_shard: int
    dim: int
    corpus: list  # per entry (R, D) f32 or int8
    sumsq: list  # per entry (R,)
    row_valid: list  # per entry (R,) bool
    group_ids: list  # per entry (R,) int32 local group slot
    weights: list  # per entry (R,) f32
    item_ids: np.ndarray  # (S·groups_per_shard,) int64, host
    row_perm: np.ndarray  # (S·R,) int64: packed row → snapshot row, -1 pad
    scale: float
    one_row_per_item: bool
    chunk_rows: int

    @property
    def nbytes(self) -> int:
        """Device bytes of this process's slabs (a slab shared by two
        entries on one device counts once)."""
        seen = {}
        for arrays in (self.corpus, self.sumsq, self.row_valid, self.group_ids, self.weights):
            for t in arrays:
                if t is not None:
                    seen[(t.data_ptr(), t.device)] = t.numel() * t.element_size()
        return sum(seen.values())

    @property
    def corpus_dtype(self) -> torch.dtype:
        return next(t.dtype for t in self.corpus if t is not None)


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _entries(mesh: Mesh) -> list:
    """(entry, replica, shard, device, local) for every mesh entry, in
    grid order."""
    s = mesh.shape[SHARD_AXIS]
    devs = mesh.devices.reshape(-1)
    procs = None if mesh.processes is None else mesh.processes.reshape(-1)
    rank = multihost.process_index()
    return [(e, e // s, e % s, devs[e], procs is None or int(procs[e]) == rank)
            for e in range(len(devs))]


def _upload_shards(mesh: Mesh, packed: np.ndarray) -> list:
    """One tensor a local mesh entry: shard ``s`` of (S, R, …) ``packed`` on
    the entry's device; entries of one shard on one device share it."""
    made = {}
    out = []
    for _e, _r, s, dev, local in _entries(mesh):
        if not local:
            out.append(None)
            continue
        key = (s, str(dev))
        if key not in made:
            made[key] = torch.from_numpy(np.ascontiguousarray(packed[s])).to(dev, copy=True)
        out.append(made[key])
    return out


def build_sharded(
    snapshot: SpaceSnapshot,
    mesh: Mesh,
    *,
    use_quant: bool = False,
    chunk_rows: int = 8192,
) -> ShardedSpace:
    """Repack a host snapshot into the sharded device layout.

    Items are assigned to shards greedily in ascending row order (keeping
    each item whole), then each shard is padded to a common static
    ``rows_per_shard`` (a multiple of the streaming chunk).
    """
    s = mesh.shape[SHARD_AXIS]
    size = snapshot.size
    valid = snapshot.row_valid[:size]
    if use_quant:
        if not snapshot.quant_ready:
            raise ValueError("quant arm requested but profile not ready")
        source = snapshot.codes[:size]
        scale = float(snapshot.scale)
    else:
        source = snapshot.vectors[:size]
        scale = 1.0
    gids = snapshot.group_ids[:size]

    # Row spans per group, in ascending first-row order (rows of one item
    # are appended in order; a group's rows may be scattered, so collect).
    order = np.argsort(gids, kind="stable")
    sorted_gids = gids[order]
    one_row_per_item = bool(
        size == 0 or not np.any(np.diff(sorted_gids) == 0)
    )

    dim = snapshot.dim
    dtype = source.dtype
    snap_weights = snapshot.weights[:size]

    if one_row_per_item:
        # Vectorized packing: with exactly one row per group the greedy
        # balance degenerates to contiguous equal splits of the valid rows
        # in ascending group order — no per-group Python loop (this path
        # must stay O(#shards) Python work at 1M+ rows).
        rows_all = order[valid[order]]
        total = len(rows_all)
        target = max(1, -(-total // s))
        counts = [max(0, min(target, total - si * target)) for si in range(s)]
        rows_per_shard = _round_up(max(max(counts), 1), chunk_rows)
        groups_per_shard = max(max(counts), 1)
        corpus = np.zeros((s, rows_per_shard, dim), dtype=dtype)
        row_valid = np.zeros((s, rows_per_shard), dtype=bool)
        local_gid = np.zeros((s, rows_per_shard), dtype=np.int32)
        weights = np.ones((s, rows_per_shard), dtype=np.float32)
        item_ids = np.full(s * groups_per_shard, -1, dtype=np.int64)
        row_perm = np.full((s, rows_per_shard), -1, dtype=np.int64)
        for si in range(s):
            seg = rows_all[si * target : si * target + counts[si]]
            n = len(seg)
            if n == 0:
                continue
            corpus[si, :n] = source[seg]
            row_valid[si, :n] = True
            local_gid[si, :n] = np.arange(n, dtype=np.int32)
            weights[si, :n] = snap_weights[seg]
            item_ids[si * groups_per_shard : si * groups_per_shard + n] = gids[seg]
            row_perm[si, :n] = seg
    else:
        boundaries = np.flatnonzero(np.diff(sorted_gids)) + 1
        group_row_lists = np.split(order, boundaries)
        unique_groups = sorted_gids[np.concatenate([[0], boundaries])] if size else []

        # Greedy round-robin by row count: keep shards balanced while
        # keeping each item whole.
        total_rows = int(valid.sum())
        target = max(1, -(-total_rows // s))
        shard_rows: list[list[np.ndarray]] = [[] for _ in range(s)]
        shard_groups: list[list[int]] = [[] for _ in range(s)]
        counts = [0] * s
        cursor = 0
        for g, rows in zip(unique_groups, group_row_lists):
            rows = rows[valid[rows]]
            if len(rows) == 0:
                continue
            while cursor < s - 1 and counts[cursor] >= target:
                cursor += 1
            shard_rows[cursor].append(rows)
            shard_groups[cursor].append(int(g))
            counts[cursor] += len(rows)

        rows_per_shard = _round_up(max(max(counts), 1), chunk_rows)
        groups_per_shard = max(max((len(g) for g in shard_groups), default=1), 1)

        corpus = np.zeros((s, rows_per_shard, dim), dtype=dtype)
        row_valid = np.zeros((s, rows_per_shard), dtype=bool)
        local_gid = np.zeros((s, rows_per_shard), dtype=np.int32)
        weights = np.ones((s, rows_per_shard), dtype=np.float32)
        item_ids = np.full(s * groups_per_shard, -1, dtype=np.int64)
        row_perm = np.full((s, rows_per_shard), -1, dtype=np.int64)

        # ``item_ids`` holds the *snapshot group slot* per packed group; the
        # host remaps slots → DB item ids after top-k (VectorIndex owns that
        # table).
        for si in range(s):
            at = 0
            for li, (g, rows) in enumerate(zip(shard_groups[si], shard_rows[si])):
                n = len(rows)
                corpus[si, at : at + n] = source[rows]
                row_valid[si, at : at + n] = True
                local_gid[si, at : at + n] = li
                weights[si, at : at + n] = snap_weights[rows]
                item_ids[si * groups_per_shard + li] = g
                row_perm[si, at : at + n] = rows
                at += n

    row_perm = row_perm.reshape(-1)
    # The device ends: one slab a shard on each of this process's mesh
    # entries; the row sums of squares from the uploaded slab.
    corpus_d = _upload_shards(mesh, corpus)
    sumsq_d = [None if t is None else scoring.row_sumsq_chunked(t) for t in corpus_d]
    return ShardedSpace(
        mesh=mesh,
        num_shards=s,
        rows_per_shard=rows_per_shard,
        groups_per_shard=groups_per_shard,
        dim=dim,
        corpus=corpus_d,
        sumsq=sumsq_d,
        row_valid=_upload_shards(mesh, row_valid),
        group_ids=_upload_shards(mesh, local_gid),
        weights=_upload_shards(mesh, weights),
        item_ids=item_ids,
        row_perm=row_perm,
        scale=scale,
        one_row_per_item=one_row_per_item,
        chunk_rows=chunk_rows,
    )


def _layout(mesh: Mesh) -> str:
    """How this process takes part: ``"local"`` (every entry its own),
    ``"shard"`` (a 1-D mesh across processes: candidates gather over the
    group, in process order = global shard order) or ``"replica"`` (each
    replica row one process's: results gather over the group)."""
    if mesh.processes is None or multihost.process_count() == 1:
        return "local"
    procs = mesh.processes.reshape(_query_specs(mesh), -1)
    if REPLICA_AXIS not in mesh.axis_names:
        if np.any(np.diff(procs[0]) < 0):
            raise ValueError("a shard mesh across processes must list them in order")
        return "shard"
    if not np.all(procs == procs[:, :1]) or np.any(np.diff(procs[:, 0]) < 0):
        raise ValueError("each replica row must belong to one process, in process order")
    return "replica"


def _all_gather(tensors: tuple) -> list:
    """gloo all-gather of each tensor of this process (same shapes on every
    process), through host memory: a tuple of lists in process order."""
    import torch.distributed as dist

    out = []
    for t in tensors:
        host = t.cpu()
        wire = host.to(torch.uint8) if host.dtype == torch.bool else host
        parts = [torch.empty_like(wire) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, wire)
        out.append([p.to(torch.bool) if host.dtype == torch.bool else p for p in parts])
    return out


def _on(dev):
    """The device context a launch on ``dev`` needs."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def _run(space: ShardedSpace, queries, shard_fn: Callable, merge_fn: Callable) -> tuple:
    """Every local entry's ``shard_fn(entry, shard, device, query slice)``
    (a tuple of (Qr, …) tensors), launched before any gather; then, per
    replica row, the shards' tuples on the first local device in shard order
    (across processes in the shard layout) through ``merge_fn(list of
    tuples)``; the rows' results concatenated over queries (across processes
    in the replica layout). Returns the merged tuple for all queries."""
    mesh = space.mesh
    layout = _layout(mesh)
    entries = _entries(mesh)
    local = [e for e in entries if e[4]]
    if not local:
        raise ValueError("this process holds no entry of the mesh")
    gather_dev = local[0][3]
    reps = _query_specs(mesh)
    qr = queries.shape[0] // reps
    slices = {}
    outs = {}
    for e, r, s, dev, _ in local:
        with _on(dev):
            key = (r, str(dev))
            if key not in slices:
                slices[key] = queries[r * qr:(r + 1) * qr].to(dev)
            outs[e] = shard_fn(e, s, dev, slices[key])
    rows = sorted({r for _e, r, _s, _d, _l in local})
    merged = []
    for r in rows:
        parts = [tuple(t.to(gather_dev) for t in outs[e])
                 for e, rr, _s, _d, _l in local if rr == r]
        if layout == "shard":
            stacked = tuple(torch.stack(ts) for ts in zip(*parts))
            gathered = _all_gather(stacked)
            parts = list(zip(*(
                [t.to(gather_dev) for block in blocks for t in block.unbind(0)]
                for blocks in gathered)))
        merged.append(merge_fn(parts))
    result = tuple(torch.cat(ts) for ts in zip(*merged))
    if layout == "replica":
        gathered = _all_gather(result)
        result = tuple(torch.cat([p.to(gather_dev) for p in parts]) for parts in gathered)
    return result


def _merge_topk(k: int) -> Callable:
    def merge(parts):
        all_v = torch.stack([p[0] for p in parts])  # (S, Q, k)
        all_i = torch.stack([p[1] for p in parts])
        q_n = all_v.shape[1]
        cand_v = all_v.permute(1, 0, 2).reshape(q_n, -1)
        cand_i = all_i.permute(1, 0, 2).reshape(q_n, -1)
        top_v, sel = smallest_k(cand_v, k)
        return top_v, torch.gather(cand_i, 1, sel)
    return merge


def _pad_queries(mesh: Mesh, queries):
    """Queries as a tensor, Q padded to a replica multiple on 2-D serving
    meshes (each replica takes an equal query slice)."""
    if not isinstance(queries, torch.Tensor):
        queries = torch.from_numpy(np.ascontiguousarray(queries))
    if REPLICA_AXIS not in mesh.axis_names:
        return queries, queries.shape[0]
    r = mesh.shape[REPLICA_AXIS]
    q = queries.shape[0]
    padded = _round_up(max(q, 1), r)
    if padded != q:
        queries = torch.nn.functional.pad(queries, (0, 0, 0, padded - q))
    return queries, q


def b1_takes(space: ShardedSpace, k: int) -> bool:
    """Whether a one-row int8 shard's top-k takes kernel B1."""
    return (space.corpus_dtype == torch.int8 and k <= min(int8_scan.MAX_K, space.rows_per_shard)
            and space.dim % 16 == 0 and space.dim <= int8_scan.V2_MAX_DIM)


def sharded_search(
    space: ShardedSpace,
    queries,
    *,
    k: int,
    distance: str = "cosine",
    aggregation: str = "min",
    weighted: bool = False,
):
    """Query a sharded space: (Q, D) queries → (dist, global_slot, valid,
    grouped), on this process's first mesh device.

    For one-row-per-item spaces the returned slots are global row indices;
    otherwise global group slots (shard · groups_per_shard + local), which
    ``space.item_ids`` maps back to snapshot group slots / item ids.
    """
    grouped = not space.one_row_per_item or aggregation != "min" or weighted
    b1 = not grouped and b1_takes(space, k)
    queries, q_real = _pad_queries(space.mesh, queries)
    gps = space.groups_per_shard

    def shard_fn(e, s, dev, q):
        if grouped:
            top_v, local_idx, _ = scoring.streaming_grouped_topk(
                space.corpus[e], space.sumsq[e], space.row_valid[e], space.group_ids[e], q,
                num_groups=gps, k=k, distance=distance, aggregation=aggregation,
                scale=space.scale, chunk_rows=space.chunk_rows, weighted=weighted,
                weights=space.weights[e],
            )
        elif b1:
            top_v, local_idx, _ = int8_scan.int8_topk(
                space.corpus[e], space.sumsq[e], space.row_valid[e],
                q.to(torch.int8).contiguous(), k=k, distance=distance, scale=space.scale,
            )
        else:
            top_v, local_idx, _ = scoring.streaming_topk(
                space.corpus[e], space.sumsq[e], space.row_valid[e], q, k=k,
                distance=distance, scale=space.scale, chunk_rows=space.chunk_rows,
            )
        # One row per item ⇒ packed local row index == local group slot, so
        # both paths share the group-slot identity space (and the (value,
        # slot) tie order matches ascending global row).
        return top_v, local_idx.to(torch.int64) + s * gps

    top_v, top_i = _run(space, queries, shard_fn, _merge_topk(k))
    top_v, top_i = top_v[:q_real], top_i[:q_real]
    return top_v, top_i, torch.isfinite(top_v), grouped


def _per_entry(space: ShardedSpace, packed: np.ndarray, dtype) -> list:
    """A packed-order (S·R,) host array as one tensor a local entry."""
    arr = np.asarray(packed, dtype=dtype).reshape(space.num_shards, space.rows_per_shard)
    return _upload_shards(space.mesh, arr)


def sharded_grouped_scores(
    space: ShardedSpace,
    queries,
    *,
    distance: str = "cosine",
    aggregation: str = "min",
    weighted: bool = False,
    row_valid=None,
    weights=None,
):
    """Full per-group scores over the mesh: (Q, S·G) dist/valid/count
    tensors keyed by PACKED global group slot (``space.item_ids`` maps slots
    back to snapshot group slots). ``weights``, when given, overrides the
    built-in per-row weights in PACKED order (query-time confidence
    weighting).

    This is the PQL composition surface on more than one shard, where rank
    fusion needs every candidate's score, not a top-k. ``row_valid``, when
    given, overrides the built-in validity and must be in packed order (use
    ``space.row_perm`` to permute a snapshot-order mask).
    """
    rv = space.row_valid if row_valid is None else _per_entry(space, row_valid, bool)
    wts = space.weights if weights is None else _per_entry(space, weights, np.float32)
    queries, q_real = _pad_queries(space.mesh, queries)

    def shard_fn(e, s, dev, q):
        # Every shard computes its local groups' scores; the gather puts
        # them side by side, (S, Q, G) → (Q, S·G) in packed global-slot
        # order.
        return scoring.grouped_scores(
            space.corpus[e], space.sumsq[e], rv[e], space.group_ids[e], q,
            num_groups=space.groups_per_shard, distance=distance, aggregation=aggregation,
            scale=space.scale, chunk_rows=space.chunk_rows, weighted=weighted, weights=wts[e],
        )

    def merge(parts):
        return tuple(torch.cat(ts, dim=1) for ts in zip(*parts))

    d, v, c = _run(space, queries, shard_fn, merge)
    return d[:q_real], v[:q_real], c[:q_real]
