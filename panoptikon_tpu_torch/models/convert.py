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
(:func:`named_leaves`), as the tests hold them to ``jax.grad``'s. For the
sharded step (``parallel/train.py``), :func:`shard_params` cuts a tree into
one tree a mesh entry by a placement rule (``clip.param_shard_rules``), and
:func:`gather_params` / :func:`gather_grads` put the reference's full
layout back together.
"""

from __future__ import annotations

import numpy as np
import torch

from panoptikon_tpu_torch.device import device as resolve_device
from panoptikon_tpu_torch.parallel.mesh import Placement, local_entries


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


def _map_leaves(fn, tree, prefix: str = ""):
    """The same nesting with ``fn(path, leaf)`` at each leaf (paths as in
    :func:`named_leaves`)."""
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v, f"{prefix}.{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_leaves(fn, v, f"{prefix}.{i}" if prefix else str(i))
                for i, v in enumerate(tree)]
    return fn(prefix, tree)


def shard_params(tree, mesh, rules) -> list:
    """One tree a mesh entry this process holds (``mesh.local_entries``
    order), on the entry's device: each leaf the block its placement
    (``rules(path)``, a ``Placement`` spec) gives that entry, a copy of its
    own; a replicated leaf is one copy an entry."""
    return [_map_leaves(lambda path, t, c=coords, d=dev: Placement(mesh, rules(path)).block(t, c)
                        .to(d, copy=True).contiguous(), tree)
            for coords, dev in local_entries(mesh)]


def _gather(shards, mesh, rules, leaf_of):
    entries = local_entries(mesh)
    if len(entries) != mesh.size or len(shards) != mesh.size:
        raise ValueError("gathering needs every mesh entry's shard in this process")
    index = {tuple(c.values()): i for i, (c, _) in enumerate(entries)}
    leaves = [named_leaves(tree) for tree in shards]
    return _map_leaves(lambda path, _t: Placement(mesh, rules(path)).assemble(
        lambda coords: leaf_of(leaves[index[tuple(coords.values())]][path])), shards[0])


def gather_params(shards, mesh, rules):
    """The full tree, in the reference's layout, from every entry's shard
    (:func:`shard_params`' inverse; replicated leaves from entry 0), on the
    first entry's device."""
    return _gather(shards, mesh, rules, lambda t: t.detach())


def gather_grads(shards, mesh, rules):
    """:func:`gather_params` of the leaves' gradients (zeros where a leaf
    has none)."""
    return _gather(shards, mesh, rules,
                   lambda t: t.grad if t.grad is not None else torch.zeros_like(t))
