"""Typed image search: batches of text queries through ``ClipImpl.predict``'s
text path, then ``DeviceIndex.search`` and ``DeviceIndex.item_ids``, as a
PQL text leaf embeds its query and searches an image space.

Set-up makes the space as ``similar_search`` does (its ``_space_rows``: unit
Gaussian rows drawn from the seed, a host ``VectorIndex``, its int8 arm,
uploaded), draws the text tower's f32 weights from the seed (``text_leaves``,
the layout ``clip.py`` reads) and hands them to a ``ClipImpl`` of the
configuration's architecture, and draws a pool of query batches: each query
1 to 16 words (geometric, mean 4), each word from a 20,000-word list drawn
from the seed. A step embeds one batch (``{"text": …}`` inputs: the port's
tokenizer, context 77, the bf16 text tower with causal B3), parses the npy
rows, searches them and maps the rows to item ids.

The check, once the window has closed: the first and the last query vectors
the window returned for each pool batch against the plain f32 text tower
(``references/clip_text.py``) on the same weights, over ids made by this
kind's own copy of the tokenizer, ``hash_token_ids`` (``text_embed_gap``:
the largest 1 − cosine); and every answer against the exact f32 top-k of
the program's own query vectors (``similar_search._judge``:
``recall_miss``, ``top1_wrong``). The control
puts the reference with float8 linears in the tower's place and the exact
top-k in bfloat16 in the answers' place.
"""

from __future__ import annotations

import hashlib

import numpy as np

from benchmark import inputs
from benchmark.kinds import similar_search
from benchmark.references import clip_text

WORK = "queries"
SPACE = similar_search.SPACE
LETTERS = np.array(list("abcdefghijklmnopqrstuvwxyz"))


def work(cell) -> int:
    return int(cell.traffic["queries_per_batch"])


def text_leaves(config: dict) -> list:
    """(path, shape, mean, std) of every leaf of the text tower, in order."""
    t = config["text_cfg"]
    w, ctx = t["width"], t["context_length"]
    mlp = config["assumed"]["mlp_ratio"] * w
    leaves = [("token_emb", (t["vocab_size"], w), 0.0, 0.02), ("pos_emb", (ctx, w), 0.0, 0.01)]
    for i in range(t["layers"]):
        b = f"blocks.{i}."
        leaves += [
            (b + "ln_1.scale", (w,), 1.0, 0.1), (b + "ln_1.bias", (w,), 0.0, 0.02),
            (b + "attn.qkv_w", (w, 3 * w), 0.0, w ** -0.5), (b + "attn.qkv_b", (3 * w,), 0.0, 0.02),
            (b + "attn.out_w", (w, w), 0.0, w ** -0.5), (b + "attn.out_b", (w,), 0.0, 0.02),
            (b + "ln_2.scale", (w,), 1.0, 0.1), (b + "ln_2.bias", (w,), 0.0, 0.02),
            (b + "mlp.fc_w", (w, mlp), 0.0, w ** -0.5), (b + "mlp.fc_b", (mlp,), 0.0, 0.02),
            (b + "mlp.proj_w", (mlp, w), 0.0, (2 * w) ** -0.5), (b + "mlp.proj_b", (w,), 0.0, 0.02),
        ]
    return leaves + [("ln_final.scale", (w,), 1.0, 0.1), ("ln_final.bias", (w,), 0.0, 0.02),
                     ("proj", (w, config["embed_dim"]), 0.0, w ** -0.5)]


def text_params(config: dict, seed: int, device) -> dict:
    """The text tower's f32 weights as a nested dict (blocks a list), drawn
    by one ``torch.randn`` on ``device``."""
    import torch

    leaves = text_leaves(config)
    total = sum(int(np.prod(shape)) for _, shape, _, _ in leaves)
    gen = torch.Generator(device=device).manual_seed(inputs.sub_seed(seed, 40))
    flat = torch.randn(total, generator=gen, device=device)
    tree: dict = {"blocks": [{} for _ in range(config["text_cfg"]["layers"])]}
    at = 0
    for path, shape, mean, std in leaves:
        size = int(np.prod(shape))
        leaf = flat[at:at + size].view(shape).mul_(std).add_(mean)
        at += size
        keys = path.split(".")
        node = tree
        if keys[0] == "blocks":
            node, keys = tree["blocks"][int(keys[1])], keys[2:]
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = leaf
    return tree


def query_texts(traffic: dict, seed: int) -> list:
    """``pool_batches`` lists of ``queries_per_batch`` texts."""
    rng = np.random.default_rng(inputs.sub_seed(seed, 41))
    lengths = rng.integers(3, 11, size=traffic["vocabulary"])
    words = ["".join(rng.choice(LETTERS, size=n)) for n in lengths]
    p, q = int(traffic["pool_batches"]), int(traffic["queries_per_batch"])
    counts = np.minimum(rng.geometric(1.0 / traffic["mean_words"], size=p * q),
                        traffic["max_words"])
    picks = rng.integers(0, len(words), size=int(counts.sum()))
    texts, at = [], 0
    for c in counts:
        texts.append(" ".join(words[i] for i in picks[at:at + c]))
        at += c
    return [texts[i * q:(i + 1) * q] for i in range(p)]


def hash_token_ids(texts, vocab: int, ctx: int):
    """(len(texts), ctx) int64 ids as the port's tokenizer without vocab
    files (``HashTokenizer``) makes them, written out again: whitespace split
    of the lower-cased text, each word the first 4 bytes of its SHA-1,
    little-endian, mod V − 3, plus 3; 1 first, 2 last; cut at ``ctx``, zeros
    after."""
    import torch

    ids = torch.zeros((len(texts), ctx), dtype=torch.int64)
    for i, text in enumerate(texts):
        row = [1]
        for word in text.lower().split():
            h = int.from_bytes(hashlib.sha1(word.encode()).digest()[:4], "little")
            row.append(3 + h % (vocab - 3))
        row = (row + [2])[:ctx]
        ids[i, :len(row)] = torch.tensor(row)
    return ids


class State(similar_search.State):
    """similar_search's state; ``pool`` holds the program's query vectors
    (P, Q, D) once the window has closed, which the judge reads."""

    def __init__(self, impl, texts, inputs_, **kw):
        super().__init__(**kw)
        self.impl, self.texts, self.inputs = impl, texts, inputs_
        self.params = None
        self.first, self.last = {}, {}  # pool batch -> its query vectors


def setup(cell, seed, device) -> State:
    import torch

    from panoptikon_tpu_torch.index import VectorIndex
    from panoptikon_tpu_torch.index.device_index import DeviceIndex
    from panoptikon_tpu_torch.models.impls import ClipImpl, PredictionInput

    t = cell.traffic
    rows = similar_search._space_rows(cell, seed, device)
    n, d = rows.shape
    host = rows.cpu().numpy()
    del rows
    index = VectorIndex()
    index.add(SPACE, inputs.item_ids(np.arange(n), seed), np.arange(n), host)
    del host
    index.build_quant(SPACE)
    dindex = DeviceIndex(index, SPACE, device)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    port = cell.config["port"]
    impl = ClipImpl(model_arch=port["arch"], precision=port["precision"],
                    batch_cap=int(t["queries_per_batch"]), device=device)
    impl.params = {"text": text_params(cell.config, seed, device)}
    texts = query_texts(t, seed)
    batches = [[PredictionInput(data={"text": s}) for s in b] for b in texts]
    return State(impl, texts, batches, cell=cell, seed=seed, device=device, rows=n, dim=d,
                 k=int(t["k"]), oversample=int(t["oversample"]), pool=None, index=index,
                 dindex=dindex)


def step(state: State, i: int, spans):
    import torch

    from panoptikon_tpu_torch.utils import npy

    p = i % len(state.inputs)
    with spans("predict"):
        out = state.impl.predict(state.inputs[p])
    with spans("parse"):
        vecs = np.concatenate([npy.parse_npy_matrix(o) for o in out])
    with spans("search"):
        q = torch.from_numpy(vecs).to(state.device)
        _, rows, valid = state.dindex.search(q, state.k, oversample=state.oversample)
    if spans.traced and state.device.type == "cuda":
        torch.cuda.synchronize(state.device)  # as similar_search: item_ids holds no wait
    with spans("item_ids"):
        ids = state.dindex.item_ids(rows, valid)
    state.first.setdefault(p, vecs)
    state.last[p] = vecs
    return p, ids


def warm(state: State, spans) -> None:
    for i in range(int(state.cell.traffic["warmup_batches"])):
        step(state, i, spans)
    state.first.clear()
    state.last.clear()


def release(state: State) -> None:
    state.params = state.impl.params["text"]
    state.impl = None
    state.dindex = None
    state.index = None


def _embed_gap(state: State, linear_fp8: bool = False) -> float:
    """The largest 1 − cosine of the window's query vectors (or, for the
    control, the fp8 reference's) against the f32 reference's, over the pool
    batches the window answered."""
    import torch

    t = state.cell.config["text_cfg"]
    worst = 0.0
    for p in sorted(state.first):
        ids = hash_token_ids(state.texts[p], t["vocab_size"], t["context_length"])
        want = clip_text.embed_texts(state.params, state.cell.config, ids.to(state.device))
        if linear_fp8:
            got = [clip_text.embed_texts(state.params, state.cell.config, ids.to(state.device),
                                         linear_fp8=True)]
        else:
            got = [torch.from_numpy(v).to(state.device) for v in (state.first[p], state.last[p])]
        for g in got:
            if g.shape != want.shape:
                return 1.0
            g = g.to(torch.float32)
            cos = (g * want).sum(1) / torch.clamp(torch.linalg.norm(g, dim=1), min=1e-30)
            worst = max(worst, float((1.0 - cos).max()))
    return worst


def _answers_judged(state: State, outputs, dtype=None) -> dict:
    """similar_search's judge over the program's own query vectors, of the
    pool batches the window answered."""
    import torch

    order = sorted(state.first)
    at = {p: i for i, p in enumerate(order)}
    state.pool = torch.stack([torch.from_numpy(state.first[p]) for p in order]).to(state.device)
    answers = similar_search._distinct([(at[p], ids) for p, ids in outputs])
    return similar_search._judge(state, answers, dtype=dtype)


def check(state: State, outputs) -> list:
    if not state.first:
        got = {"text_embed_gap": 1.0, "recall_miss": 1.0, "top1_wrong": float("inf")}
    else:
        got = {"text_embed_gap": _embed_gap(state), **_answers_judged(state, outputs)}
    return [(name, got[name], float(limit)) for name, limit in state.cell.limits.items()]


def control(state: State) -> list:
    """The fp8 tower and the bfloat16 top-k, in the program's place."""
    import torch

    got = {"text_embed_gap": _embed_gap(state, linear_fp8=True),
           **_answers_judged(state, [], dtype=torch.bfloat16)}
    return [(name, got[name]) for name in state.cell.limits]
