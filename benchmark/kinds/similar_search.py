"""PQL ``similar_to`` search: stored rows of a space, plus noise, as queries.

Set-up makes the space from the seed on the device (unit Gaussian rows, an
item id each), appends it to a host ``VectorIndex``, builds its int8 arm
(``build_quant``) and uploads it (``DeviceIndex``), as the server does at
start-up. A pool of query batches is drawn in set-up and cycled: each query
is a row of the space plus Gaussian noise of norm about ``noise``,
normalized. A step is one batch through ``DeviceIndex.search`` (codec,
candidate stage B1 or B2, f32 rescore) and ``DeviceIndex.item_ids`` (ids on
the host).

The check: every answer of the window against the plain exact f32 cosine
similarities of its query over the same rows (``references/exact_topk.py``),
the rows worked out again from the item ids by the harness's own id map.
The cell's limits file names the numbers compared (``_judge``): where the
candidate stage is exact (B1), ``rank_gap``, the widest gap by which an
answer's j-th item lies below the reference's j-th best similarity (0 where
an answer is the reference's top-k in its order, a rounding where two items
all but tie, 2 for a missing, unknown or repeated id); where it keeps the
``approx_min_k`` contract (B2), the share of the reference's top-k the
answers lack and, exactly, the answers whose first item is not the
reference's best. The control is that reference computed in bfloat16, the
precision below the f32 rescore the configuration states.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from benchmark import inputs, roofline
from benchmark.references import exact_topk

WORK = "queries"
SPACE = "space"


def work(cell) -> int:
    return int(cell.traffic["queries_per_batch"])


@dataclass
class State:
    cell: object
    seed: int
    device: object
    rows: int
    dim: int
    k: int
    oversample: int
    pool: object  # (P, Q, D) f32 queries on the device
    index: object = None
    dindex: object = None


def _space_rows(cell, seed, device):
    import torch

    n, d = cell.config["space"]["rows"], cell.config["embed_dim"]
    gen = torch.Generator(device=device).manual_seed(inputs.sub_seed(seed, 10))
    return roofline.unit_rows(n, d, gen, device)


def _query_pool(cell, seed, rows):
    """(P, Q, D) queries: a row drawn from the seed plus noise, normalized."""
    import torch

    t = cell.traffic
    p, q = int(t["pool_batches"]), int(t["queries_per_batch"])
    n, d = rows.shape
    rng = np.random.default_rng(inputs.sub_seed(seed, 11))
    src = torch.from_numpy(rng.integers(0, n, size=p * q)).to(rows.device)
    gen = torch.Generator(device=rows.device).manual_seed(inputs.sub_seed(seed, 12))
    noise = torch.randn((p * q, d), generator=gen, device=rows.device) * (t["noise"] / d ** 0.5)
    x = rows[src] + noise
    return (x / torch.linalg.norm(x, dim=1, keepdim=True)).reshape(p, q, d)


def setup(cell, seed, device) -> State:
    import torch

    from panoptikon_tpu_torch.index import VectorIndex
    from panoptikon_tpu_torch.index.device_index import DeviceIndex

    if cell.config["space"]["distance"] != "cosine":
        raise ValueError("DeviceIndex.search ranks by cosine")
    rows = _space_rows(cell, seed, device)
    n, d = rows.shape
    pool = _query_pool(cell, seed, rows)
    host = rows.cpu().numpy()
    del rows
    index = VectorIndex()
    index.add(SPACE, inputs.item_ids(np.arange(n), seed), np.arange(n), host)
    del host
    index.build_quant(SPACE)
    dindex = DeviceIndex(index, SPACE, device)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = cell.traffic
    return State(cell=cell, seed=seed, device=device, rows=n, dim=d, k=int(t["k"]),
                 oversample=int(t["oversample"]), pool=pool, index=index, dindex=dindex)


def step(state: State, i: int, spans):
    p = i % state.pool.shape[0]
    with spans("search"):
        _, rows, valid = state.dindex.search(state.pool[p], state.k, oversample=state.oversample)
    if spans.traced and state.device.type == "cuda":
        # The traced run waits for the device here, so that the item_ids
        # span holds the readback and the id map, not the search's wait.
        import torch

        torch.cuda.synchronize(state.device)
    with spans("item_ids"):
        ids = state.dindex.item_ids(rows, valid)
    return p, ids


def warm(state: State, spans) -> None:
    for i in range(int(state.cell.traffic["warmup_batches"])):
        step(state, i, spans)


def release(state: State) -> None:
    state.dindex = None
    state.index = None


def _answer_rows(state: State, answer, lo: int, count: int) -> np.ndarray:
    """Rows ``lo`` to ``lo + count`` of a (Q, k) answer of item ids -> rows of
    the space (the harness's own id map, worked out again), -1 for an id
    that names no row or repeats in its answer, or where the answer is
    short."""
    ids = np.full((count, state.k), -1, dtype=np.int64)
    part = np.asarray(answer, dtype=np.int64)[lo:lo + count, :state.k]
    ids[:part.shape[0], :part.shape[1]] = part
    base = int(inputs.item_ids(0, state.seed))
    rows = (ids - base) // 7
    ok = (ids >= base) & ((ids - base) % 7 == 0) & (rows < state.rows)
    rows = np.where(ok, rows, -1)
    srt = np.sort(rows, axis=1)
    dup = ((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).any(axis=1)
    rows[dup] = -1
    return rows


def _judge(state: State, answers, dtype=None) -> dict:
    """The numbers the check can compare, over every distinct answer:

    - ``rank_gap``: the widest gap by which the j-th item of an answer lies
      below the reference's j-th best cosine similarity (2, the widest a
      cosine gap can be, for an id that names no row or repeats);
    - ``recall_miss``: the share of the reference's k best items that the
      answers lack (1 − recall@k);
    - ``top1_wrong``: how many answers do not start with the reference's
      best item.

    ``answers`` maps a pool batch to its distinct (Q, k) answers; with
    ``dtype`` the answers are the reference's own top-k computed in that
    precision (the control)."""
    import torch

    rows = _space_rows(state.cell, state.seed, state.device)
    gap, missed, total, wrong = 0.0, 0, 0, 0
    p_count, q, _ = state.pool.shape
    block = 512
    for p in range(p_count):
        for lo in range(0, q, block):
            queries = state.pool[p, lo:lo + block]
            sims = exact_topk.cosine_sims(rows, queries)
            best = torch.topk(sims, state.k, dim=1)
            if dtype is not None:
                low = exact_topk.cosine_sims(rows, queries, dtype=dtype)
                picks = [torch.topk(low, state.k, dim=1).indices]
                del low
            else:
                picks = [torch.from_numpy(_answer_rows(state, a, lo, len(queries))).to(rows.device)
                         for a in answers.get(p, [])]
            for pick in picks:
                got = torch.gather(sims, 1, pick.clamp(min=0))
                worst = torch.where(pick >= 0, best.values - got, torch.full_like(got, 2.0))
                gap = max(gap, float(worst.max().clamp(min=0)))
                hit = (pick[:, :, None] == best.indices[:, None, :]).any(dim=1)
                missed += int((~hit).sum())
                total += hit.numel()
                wrong += int((pick[:, 0] != best.indices[:, 0]).sum())
            del sims
    return {"rank_gap": gap, "recall_miss": missed / total if total else 1.0,
            "top1_wrong": float(wrong)}


def _distinct(outputs) -> dict:
    """Pool batch -> its distinct answers in the window (a pool batch is
    searched many times; each distinct answer is judged once)."""
    seen, out = set(), {}
    for p, ids in outputs:
        ids = np.asarray(ids)
        key = (p, ids.shape, ids.dtype.str, ids.tobytes())
        if key not in seen:
            seen.add(key)
            out.setdefault(p, []).append(ids)
    return out


def check(state: State, outputs) -> list:
    """The numbers the cell's limits name, each with its limit."""
    got = _judge(state, _distinct(outputs))
    return [(name, got[name], float(limit)) for name, limit in state.cell.limits.items()]


def control(state: State) -> list:
    """The reference in bfloat16, in the program's place."""
    import torch

    got = _judge(state, {}, dtype=torch.bfloat16)
    return [(name, got[name]) for name in state.cell.limits]
