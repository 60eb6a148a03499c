"""The image-index build: decoded images through ``ClipImpl.predict``, then
``VectorIndex.add``, as the extraction job does.

Set-up makes the image tower's f32 weights from the seed on the device
(``inputs.vit_params``) and hands them to a ``ClipImpl`` of the
configuration's architecture and precision: the program quantizes them as
its ``load`` does (``clip.quantize_block_weights`` under int8) and, under
int8, calibrates on the first batch it embeds. A pool of pixel batches is
made in set-up and cycled, so that host RNG never paces the window. A step
embeds one batch (``{"pixels": …}`` inputs, as the card gets decoded
images), parses the npy rows as the extraction job does and appends them to
the space under new item ids.

The check, once the window has closed and the program's weights are freed:
for a sample of the pool's images drawn from the seed, every embedding the
window returned for them against the plain f32 tower of
``references/<config's reference>.py`` on the same f32 weights
(``embed_gap``: the largest 1 − cosine), and every row the index holds for
them against what ``predict`` returned, under the right item id
(``index_rows_wrong``, exact). The control is the reference with its block
linears in int4, the precision below the int8 the configuration states.
"""

from __future__ import annotations

import dataclasses
import importlib
import io
from dataclasses import dataclass

import numpy as np

from benchmark import inputs

WORK = "images"
SPACE = "space"


def work(cell) -> int:
    return int(cell.traffic["images_per_batch"])


@dataclass
class State:
    cell: object
    seed: int
    device: object
    impl: object
    pool: list  # P host arrays (B, S, S, 3) f32
    pool_inputs: list  # P lists of PredictionInput
    index: object
    next_item: int = 0
    sample: object = None  # (pool batch, position) pairs the check compares
    reference: object = None  # (len(sample), E) f32 of the reference


def port_config(config: dict):
    """The port's ``ClipConfig`` for this configuration, required to hold
    the file's widths and depth."""
    from panoptikon_tpu_torch.models import clip

    port = config["port"]
    cfg = dataclasses.replace(clip.CONFIGS[port["arch"]], matmul_precision=port["precision"])
    v, a = config["vision_cfg"], config["assumed"]
    want = {"image_size": v["image_size"], "patch_size": v["patch_size"],
            "vision_width": v["width"], "vision_layers": v["layers"],
            "vision_heads": v["width"] // a["vision_head_width"], "embed_dim": config["embed_dim"],
            "mlp_ratio": a["mlp_ratio"]}
    got = {key: getattr(cfg, key) for key in want}
    if got != want:
        raise ValueError(f"the port's {port['arch']} is {got}, the configuration {want}")
    return cfg


def setup(cell, seed, device) -> State:
    from panoptikon_tpu_torch.index import VectorIndex
    from panoptikon_tpu_torch.models import clip
    from panoptikon_tpu_torch.models.impls import ClipImpl, PredictionInput

    cfg = port_config(cell.config)
    t = cell.traffic
    batch = int(t["images_per_batch"])
    impl = ClipImpl(model_arch=cell.config["port"]["arch"], precision=cfg.matmul_precision,
                    batch_cap=batch, device=device)
    params = {"visual": inputs.vit_params(cell.config, seed, device)}
    # What ClipImpl.load does with the weights it reads, on the weights
    # handed over in memory.
    impl.params = clip.quantize_block_weights(params) if cfg.matmul_precision == "int8" else params
    del params
    pool = inputs.pixel_batches(cell.config, seed, int(t["pool_batches"]), batch, device)
    pool_inputs = [[PredictionInput(data={"pixels": img}) for img in b] for b in pool]
    return State(cell=cell, seed=seed, device=device, impl=impl, pool=pool,
                 pool_inputs=pool_inputs, index=VectorIndex())


def step(state: State, i: int, spans):
    from panoptikon_tpu_torch.utils import npy

    p = i % len(state.pool)
    with spans("predict"):
        out = state.impl.predict(state.pool_inputs[p])
    with spans("parse"):
        vecs = np.concatenate([npy.parse_npy_matrix(o) for o in out])
    n = len(out)
    first = state.next_item
    state.next_item += n
    items = inputs.item_ids(np.arange(first, first + n), state.seed)
    with spans("index_add"):
        state.index.add(SPACE, items, items, vecs)
    return p, first, out


def warm(state: State, spans) -> None:
    """The first batch calibrates (under int8) and builds the kernels; the
    rest run the window's own shapes. Their rows stay in the space."""
    for i in range(int(state.cell.traffic["warmup_batches"])):
        step(state, i, spans)


def release(state: State) -> None:
    state.impl.unload()
    state.impl = None


def _sample(state: State) -> list:
    t = state.cell.traffic
    p, b = int(t["pool_batches"]), int(t["images_per_batch"])
    rng = np.random.default_rng(inputs.sub_seed(state.seed, 20))
    flat = rng.choice(p * b, size=min(int(t["sample_images"]), p * b), replace=False)
    return sorted((int(x) // b, int(x) % b) for x in flat)


def _reference(state: State, linear_bits=None):
    import torch

    ref = importlib.import_module(f"benchmark.references.{state.cell.config['reference']}")
    params = inputs.vit_params(state.cell.config, state.seed, state.device)
    images = torch.from_numpy(np.stack([state.pool[p][j] for p, j in state.sample]))
    out = ref.embed_images(params, state.cell.config, images.to(state.device),
                           linear_bits=linear_bits)
    return out.cpu().numpy().astype(np.float64)


def _gap(got: np.ndarray, want: np.ndarray) -> float:
    """The largest 1 − cosine of rows of ``got`` against rows of ``want``."""
    got = got.astype(np.float64)
    cos = (got * want).sum(1) / np.maximum(
        np.linalg.norm(got, axis=1) * np.linalg.norm(want, axis=1), 1e-30)
    return float(np.max(1.0 - cos)) if len(cos) else 1.0


def check(state: State, outputs) -> list:
    state.sample = _sample(state)
    state.reference = _reference(state)
    by_batch: dict = {}
    for n, (p, j) in enumerate(state.sample):
        by_batch.setdefault(p, []).append((j, n))
    snap = state.index.snapshot(SPACE)
    row_of = {int(r): i for i, r in enumerate(snap.row_ids[: snap.size])}
    items = state.index.item_id_of_groups(SPACE, snap.group_ids[: snap.size])
    got, want, wrong = [], [], 0
    for p, first, out in outputs:
        for j, n in by_batch.get(p, []):
            try:
                vec = np.load(io.BytesIO(out[j])).reshape(-1)
            except (IndexError, TypeError, ValueError, OSError):
                wrong += 1  # an answer that is missing or is not an embedding
                continue
            got.append(vec)
            want.append(state.reference[n])
            item = int(inputs.item_ids(first + j, state.seed))
            row = row_of.get(item)
            if row is None or items[row] != item or not np.array_equal(snap.vectors[row], vec):
                wrong += 1
    limits = state.cell.limits
    gap = _gap(np.array(got), np.array(want)) if got else 1.0
    return [("embed_gap", gap, float(limits["embed_gap"])),
            ("index_rows_wrong", float(wrong), float(limits["index_rows_wrong"]))]


def control(state: State) -> list:
    """The reference with int4 block linears, in the program's place."""
    low = _reference(state, linear_bits=4)
    return [("embed_gap", _gap(low, state.reference))]
