"""What a run hands to the program and to the reference alike, made from the seed.

Weights and corpus rows are drawn on the device from a ``torch.Generator``
seeded from ``--seed``, in a few large calls: the same seed gives the same
inputs. The weight tree has the layout both sides read: linear weights are
(in, out) and applied as ``x @ w``; the patch embedding is the stride-p
convolution as one (p·p·3, W) matmul over NHWC patches in (row, column,
channel) order; q, k and v are the column thirds of ``qkv_w``, heads
contiguous in each.
"""

from __future__ import annotations

import numpy as np


def sub_seed(seed: int, tag: int) -> int:
    """A seed for one stream of a run's inputs (any ``--seed`` up to 2**63)."""
    return int(np.random.SeedSequence([int(seed) % 2**63, tag]).generate_state(2, np.uint64)[0]
               % 2**63)


def vit_leaves(config: dict) -> list:
    """(path, shape, mean, std) of every leaf of the image tower, in order."""
    v = config["vision_cfg"]
    w, p, size = v["width"], v["patch_size"], v["image_size"]
    mlp = config["assumed"]["mlp_ratio"] * w
    patch_dim = p * p * 3
    n = (size // p) ** 2 + 1
    leaves = [("patch_w", (patch_dim, w), 0.0, patch_dim ** -0.5),
              ("class_emb", (w,), 0.0, 0.02), ("pos_emb", (n, w), 0.0, 0.02),
              ("ln_pre.scale", (w,), 1.0, 0.1), ("ln_pre.bias", (w,), 0.0, 0.02)]
    for i in range(v["layers"]):
        b = f"blocks.{i}."
        leaves += [
            (b + "ln_1.scale", (w,), 1.0, 0.1), (b + "ln_1.bias", (w,), 0.0, 0.02),
            (b + "attn.qkv_w", (w, 3 * w), 0.0, w ** -0.5), (b + "attn.qkv_b", (3 * w,), 0.0, 0.02),
            (b + "attn.out_w", (w, w), 0.0, w ** -0.5), (b + "attn.out_b", (w,), 0.0, 0.02),
            (b + "ln_2.scale", (w,), 1.0, 0.1), (b + "ln_2.bias", (w,), 0.0, 0.02),
            (b + "mlp.fc_w", (w, mlp), 0.0, w ** -0.5), (b + "mlp.fc_b", (mlp,), 0.0, 0.02),
            (b + "mlp.proj_w", (mlp, w), 0.0, (2 * w) ** -0.5), (b + "mlp.proj_b", (w,), 0.0, 0.02),
        ]
    leaves += [("ln_post.scale", (w,), 1.0, 0.1), ("ln_post.bias", (w,), 0.0, 0.02),
               ("proj", (w, config["embed_dim"]), 0.0, w ** -0.5)]
    return leaves


def vit_params(config: dict, seed: int, device) -> dict:
    """The image tower's f32 weights as a nested dict (blocks a list), drawn
    by one ``torch.randn`` on ``device``."""
    import torch

    leaves = vit_leaves(config)
    total = sum(int(np.prod(shape)) for _, shape, _, _ in leaves)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 1))
    flat = torch.randn(total, generator=gen, device=device)
    tree: dict = {"blocks": [{} for _ in range(config["vision_cfg"]["layers"])]}
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


def pixel_batches(config: dict, seed: int, count: int, batch: int, device) -> list:
    """``count`` batches of ``batch`` (S, S, 3) f32 images, normalized
    pixels as the card gets decoded images (standard normal values), as
    host arrays."""
    import torch

    size = config["vision_cfg"]["image_size"]
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 2))
    return [torch.randn((batch, size, size, 3), generator=gen, device=device).cpu().numpy()
            for _ in range(count)]


def item_ids(rows, seed: int) -> np.ndarray:
    """The DB item id of each corpus row: ascending, one item a row, and not
    the row number (an id map that returned rows would be wrong)."""
    base = 1_000 + sub_seed(seed, 3) % 1_000_000
    return base + 7 * np.asarray(rows, dtype=np.int64)
