"""Carry a JAX parameter tree over to the port.

The port keeps the JAX package's parameter keys and layouts — linear weights
(in, out) applied as ``x @ w``, the patch embedding as a (p·p·3, width)
matmul weight over NHWC patches, whisper's convolutions (K, C_in, C_out) —
so conversion transposes nothing: each array becomes a tensor of the same
shape and values, in the same nesting of dicts and lists (every tower's
blocks are a list; whisper's are under ``encoder`` and ``decoder``). The tree
arrives as
NumPy arrays (``jax.tree.map(np.asarray, params)``), which keeps this module
free of JAX.

For training, :func:`trainable` sets ``requires_grad`` on a tree's floating
leaves and :func:`grads_numpy` reads their gradients back by path
(:func:`named_leaves`), as the tests hold them to ``jax.grad``'s.
"""

from __future__ import annotations

import numpy as np
import torch

from panoptikon_tpu_torch.device import device as resolve_device


def params_from_jax(tree, device="cuda", dtype: torch.dtype | None = None):
    """Nested dicts/lists of arrays -> the same nesting of tensors on
    ``device``, the card unless the caller names the CPU (resolved by
    ``panoptikon_tpu_torch.device.device``, which raises without CUDA).
    Floating arrays are cast to ``dtype`` when it is given,
    except inside a quantized weight (a ``{"q", "s"}`` dict from
    ``quantize_block_weights``), whose int8 codes and f32 per-channel scales
    keep their dtype. Calibrated activation scales are a separate array:
    convert them without ``dtype``, as they are f32 in both packages."""
    return _convert(tree, resolve_device(str(device)), dtype)


def _convert(tree, device: torch.device, dtype: torch.dtype | None):
    if isinstance(tree, dict):
        if set(tree) == {"q", "s"}:
            dtype = None
        return {k: _convert(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_convert(v, device, dtype) for v in tree]
    arr = np.array(tree, copy=True)
    if arr.dtype.kind not in "biuf":
        # ml_dtypes' bfloat16 (what a bf16 JAX array becomes) has no torch
        # counterpart in from_numpy; f32 holds it exactly.
        arr = arr.astype(np.float32)
    t = torch.from_numpy(arr).to(device)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t


def named_leaves(tree, prefix: str = "") -> dict:
    """Every leaf of a nested dict/list tree by its dotted path
    (``visual.blocks.0.attn.qkv_w``), in the tree's order: the same paths
    for a tensor tree and for the NumPy tree it came from."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for key, sub in items:
        out.update(named_leaves(sub, f"{prefix}.{key}" if prefix else str(key)))
    return out


def trainable(tree) -> list:
    """Set ``requires_grad`` on every floating leaf of a tensor tree (in
    place) and return those leaves, in the tree's order: an optimizer's
    parameter list. Leaves keep their dtype, so f32 masters stay f32."""
    leaves = [t for t in named_leaves(tree).values() if t.is_floating_point()]
    for t in leaves:
        t.requires_grad_(True)
    return leaves


def grads_numpy(tree) -> dict:
    """The gradient of every leaf that requires grad, by path, as f32 NumPy
    arrays (zeros where backward reached none of it)."""
    return {path: (t.grad if t.grad is not None else torch.zeros_like(t))
            .detach().to("cpu", torch.float32).numpy()
            for path, t in named_leaves(tree).items() if t.requires_grad}
