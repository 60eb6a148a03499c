"""The dp × tp CLIP train step: part (a) of the JAX package's
``dryrun_multichip`` (``__graft_entry__.py``) on the port. A ``data ×
model`` mesh (``mesh.train_mesh``), CLIP's parameters placed by
``clip.param_shard_rules``, the batch split over ``data``, and one AdamW
step of the contrastive loss over the global batch.

PyTorch has no GSPMD, so the collectives XLA inserts are written out here.

- **Tensor parallelism** (Megatron's layout). qkv and fc are
  column-parallel: an entry holds the q, k and v columns of its own heads
  and a block of fc's columns, so attention (B3 forward, B3′ backward) runs
  over the entry's heads alone. out and the MLP's proj are row-parallel:
  the entries' partial products are summed over ``model`` in f32 and
  rounded once, then the replicated bias is added once. Two autograd
  Functions carry it: copy-to-model (identity forward, the sum over
  ``model`` backward) at each column-parallel input, reduce-from-model (the
  sum forward, identity backward) at each row-parallel output. A
  differentiable all-reduce whose backward is an all-reduce too would
  multiply every gradient below it by the model size.
- **Data parallelism.** Each entry runs the towers on its rows of the
  batch. The contrastive loss spans the global batch, so the features are
  gathered over ``data``, and each data shard takes the terms of its own
  rows: its images' rows and its texts' columns of the logits, each a
  log-softmax over all B, divided by the global B. The loss is the sum of
  these parts over ``data``. The gather's backward sums the gradient over
  ``data`` and keeps the entry's rows, so one rule holds for every leaf:
  its gradient is the sum over ``data`` of the entries' gradients
  (:func:`reduce_grads`), never over ``model`` (copy-to-model already gave
  each entry's replicated leaves the whole gradient of its data shard).
  ``logit_scale``, used after the gather, keeps to it too: each data shard
  differentiates its own part alone. Adam's update hides a uniform scale
  error (m̂/√v̂ does not change when g is scaled), so the tests hold the
  gradients themselves to the one-device ones.

Each entry's loss is the global loss in value, with its own part's
gradient; ``torch.autograd.backward`` of the entries' losses, then
:func:`reduce_grads`, leaves every leaf the one-device gradient.

Two backends compute the same thing: in one process the collectives act
on the list of every mesh entry (entries may share a card); across
processes (a mesh from ``train_mesh`` after ``multihost.initialize``, one
entry a process) they go through the mesh's gloo groups in host memory,
in f32 on both. Nothing falls back to one device: a mesh, shard or
collective that does not fit raises.
"""

from __future__ import annotations

import time

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from panoptikon_tpu_torch.models import clip
from panoptikon_tpu_torch.models.convert import named_leaves, trainable
from panoptikon_tpu_torch.parallel import multihost
from panoptikon_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Placement, local_entries

# optax.adamw(1e-4)'s settings, decay on every leaf (torch's default decay
# is 1e-2).
LR, BETAS, EPS, WEIGHT_DECAY = 1e-4, (0.9, 0.999), 1e-8, 1e-4


class Traffic:
    """What the collectives moved: calls, the f32 bytes this process's
    entries put in, and, while ``timed`` is set, the seconds spent in them
    (the devices synchronized before and after each)."""

    def __init__(self):
        self.reset()

    def reset(self, timed: bool = False) -> None:
        self.calls, self.bytes, self.seconds, self.timed = 0, 0, 0.0, timed


traffic = Traffic()


def _sync(entries) -> None:
    for dev in {dev for _, dev in entries if dev.type == "cuda"}:
        torch.cuda.synchronize(dev)


class Collectives:
    """Sums and gathers over one mesh axis for this process's entries, f32
    out. In one process a line of entries along the axis is summed (or
    concatenated) in axis order; across processes each process holds one
    entry and the mesh's gloo group along the axis does it on host copies."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.entries = local_entries(mesh)
        self.across = mesh.processes is not None and multihost.process_count() > 1
        if self.across and (len(self.entries) != 1
                            or set(mesh.groups) != set(mesh.axis_names)):
            raise ValueError("a train mesh across processes holds one entry a process and "
                             "the gloo group of each axis (train_mesh joins them)")
        if not self.across and len(self.entries) != mesh.size:
            raise ValueError("a train mesh in one process holds every entry")

    def _lines(self, axis: str) -> list:
        lines = {}
        for i, (coords, _) in enumerate(self.entries):
            lines.setdefault(tuple(v for k, v in coords.items() if k != axis), []).append(i)
        return list(lines.values())

    def _run(self, xs, axis: str, reduce):
        traffic.calls += 1
        traffic.bytes += sum(4 * x.numel() for x in xs)
        if traffic.timed:
            _sync(self.entries)
            t0 = time.perf_counter()
        if self.across:
            (_, dev), = self.entries
            out = [reduce([xs[0].detach().to("cpu", torch.float32, copy=True)],
                          self.mesh.groups[axis]).to(dev)]
        else:
            out = [None] * len(xs)
            for line in self._lines(axis):
                dev = self.entries[line[0]][1]
                total = reduce([xs[i].detach().to(dev, torch.float32) for i in line], None)
                out[line[0]] = total  # a new tensor: the line's first entry takes it
                for i in line[1:]:
                    out[i] = total.to(self.entries[i][1], copy=True)
        if traffic.timed:
            _sync(self.entries)
            traffic.seconds += time.perf_counter() - t0
        return out

    def sum(self, xs, axis: str) -> list:
        """Each entry's sum over its line along ``axis``."""
        import torch.distributed as dist

        def reduce(parts, group):
            if group is None:
                total = parts[0].clone()
                for p in parts[1:]:
                    total += p
                return total
            dist.all_reduce(parts[0], group=group)
            return parts[0]

        return self._run(xs, axis, reduce)

    def gather(self, xs, axis: str) -> list:
        """Each entry's line along ``axis``, concatenated on dim 0."""
        import torch.distributed as dist

        def reduce(parts, group):
            if group is not None:
                mine = parts[0]
                parts = [torch.empty_like(mine) for _ in range(dist.get_world_size(group))]
                dist.all_gather(parts, mine, group=group)
            return torch.cat(parts)

        return self._run(xs, axis, reduce)


class _CopyToModel(torch.autograd.Function):
    """Identity forward; backward, the gradient summed over ``model``."""

    @staticmethod
    def forward(ctx, comm, *xs):
        ctx.comm = comm
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        sums = ctx.comm.sum(grads, MODEL_AXIS)
        return (None, *(s.to(g.dtype) for s, g in zip(sums, grads)))


class _ReduceFromModel(torch.autograd.Function):
    """The sum over ``model`` of f32 partials forward, rounded once to
    ``dtype``; identity backward."""

    @staticmethod
    def forward(ctx, comm, dtype, *xs):
        ctx.dtypes = [x.dtype for x in xs]
        return tuple(s.to(dtype) for s in comm.sum(xs, MODEL_AXIS))

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        return (None, None, *(g.to(dt) for g, dt in zip(grads, ctx.dtypes)))


class _GatherData(torch.autograd.Function):
    """Rows gathered over ``data`` forward; backward, the gradient summed
    over ``data``, the entry's own rows kept."""

    @staticmethod
    def forward(ctx, comm, *xs):
        ctx.comm = comm
        ctx.rows = [(coords[DATA_AXIS] * x.shape[0], x.shape[0])
                    for (coords, _), x in zip(comm.entries, xs)]
        return tuple(comm.gather(xs, DATA_AXIS))

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        sums = ctx.comm.sum(grads, DATA_AXIS)
        return (None, *(s[lo:lo + n] for s, (lo, n) in zip(sums, ctx.rows)))


class _ValueOf(torch.autograd.Function):
    """``total`` in value, ``part``'s gradient."""

    @staticmethod
    def forward(ctx, part, total):
        return total.clone()

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _partial(x, w):
    """A row-parallel linear's partial product, unrounded: ``x @ w`` of the
    bf16 operands the one-device matmul multiplies (``w`` rounded from its
    f32 master), accumulated and returned in f32."""
    return x.to(torch.float32) @ w.to(x.dtype).to(torch.float32)


def _row_parallel(comm, xs, ws, bs) -> list:
    """``x @ w + b`` with ``w`` split on its input axis: the partials summed
    over ``model`` in f32 and rounded once to x's dtype, then the
    replicated bias added once, in that dtype, as ``clip._linear`` adds it."""
    ys = _ReduceFromModel.apply(comm, xs[0].dtype, *(_partial(x, w) for x, w in zip(xs, ws)))
    return [y + b.to(y.dtype) for y, b in zip(ys, bs)]


def _block(comm, xs, blocks, heads: int, causal: bool) -> list:
    """One residual block on every entry; ``heads`` is an entry's share."""
    attn, mlp = [p["attn"] for p in blocks], [p["mlp"] for p in blocks]
    hs = _CopyToModel.apply(comm, *(clip._layernorm(x, p["ln_1"]) for x, p in zip(xs, blocks)))
    hs = [clip._attend(clip._linear(h, p["qkv_w"], p["qkv_b"]), heads, causal)
          for h, p in zip(hs, attn)]
    ys = _row_parallel(comm, hs, [p["out_w"] for p in attn], [p["out_b"] for p in attn])
    xs = [x + y for x, y in zip(xs, ys)]
    hs = _CopyToModel.apply(comm, *(clip._layernorm(x, p["ln_2"]) for x, p in zip(xs, blocks)))
    hs = [F.gelu(clip._linear(h, p["fc_w"], p["fc_b"]), approximate="tanh")
          for h, p in zip(hs, mlp)]
    ys = _row_parallel(comm, hs, [p["proj_w"] for p in mlp], [p["proj_b"] for p in mlp])
    return [x + y for x, y in zip(xs, ys)]


def _towers(comm, shards, cfg, images, tokens) -> tuple:
    """Every entry's normalized image and text features, (B / data, E) f32."""
    model = comm.mesh.shape[MODEL_AXIS]
    vis, txt = [t["visual"] for t in shards], [t["text"] for t in shards]
    xs = [clip._embed_patches(v, cfg, im) for v, im in zip(vis, images)]
    for i in range(cfg.vision_layers):
        xs = _block(comm, xs, [v["blocks"][i] for v in vis], cfg.vision_heads // model, False)
    img = [clip._normalize(clip._pool_image(v, x)) for v, x in zip(vis, xs)]
    xs = [clip._embed_tokens(t, tok) for t, tok in zip(txt, tokens)]
    for i in range(cfg.text_layers):
        xs = _block(comm, xs, [t["blocks"][i] for t in txt], cfg.text_heads // model, True)
    return img, [clip._normalize(clip._pool_text(t, x, tok)) for t, x, tok in zip(txt, xs, tokens)]


def _check(shards, mesh, comm, images, tokens) -> None:
    if len(shards) != len(comm.entries):
        raise ValueError(f"{len(shards)} shard trees for {len(comm.entries)} local mesh entries")
    for tree, (coords, dev) in zip(shards, comm.entries):
        wrong = [p for p, t in named_leaves(tree).items() if t.device != dev]
        if wrong:
            raise ValueError(f"entry {coords}: leaves {wrong[:3]} are not on {dev}")
    data = mesh.shape[DATA_AXIS]
    if images.shape[0] != tokens.shape[0] or images.shape[0] % data:
        raise ValueError(f"a global batch of {images.shape[0]} images and {tokens.shape[0]} "
                         f"token rows over {data} data shards")


def sharded_clip_loss(shards, cfg, mesh, images, tokens) -> list:
    """``clip.clip_loss`` over the global batch (``images`` (B, H, W, 3),
    ``tokens`` (B, ctx), the same on every process), on a train mesh:
    ``shards`` holds one tree an entry this process holds
    (``convert.shard_params``). Returns each entry's loss, the global loss
    in value with the gradient of that entry's part."""
    comm = Collectives(mesh)
    _check(shards, mesh, comm, images, tokens)
    rows = Placement(mesh, (DATA_AXIS,))
    ims = [rows.block(images, c).to(dev) for c, dev in comm.entries]
    toks = [rows.block(tokens, c).to(dev) for c, dev in comm.entries]
    img, txt = _towers(comm, shards, cfg, ims, toks)
    all_img = _GatherData.apply(comm, *img)
    all_txt = _GatherData.apply(comm, *txt)
    n = images.shape[0]
    parts = []
    for (coords, dev), tree, mine, a, b in zip(comm.entries, shards, ims, all_img, all_txt):
        own = torch.arange(mine.shape[0], device=dev)
        cols = own + coords[DATA_AXIS] * mine.shape[0]
        scale = clip.logit_scale(tree["logit_scale"])
        li = -F.log_softmax(scale * a[cols] @ b.T, dim=-1)[own, cols].sum()
        lt = -F.log_softmax(scale * b[cols] @ a.T, dim=-1)[own, cols].sum()
        parts.append(0.5 * (li + lt) / n)
    totals = comm.sum([p.detach() for p in parts], DATA_AXIS)
    return [_ValueOf.apply(p, t.to(p.dtype)) for p, t in zip(parts, totals)]


def reduce_grads(shards, mesh) -> None:
    """Sum each leaf's gradient over ``data`` (one flat f32 buffer an
    entry), in place."""
    comm = Collectives(mesh)
    leaves = [[t for t in named_leaves(tree).values() if t.requires_grad] for tree in shards]
    flats = [torch.cat([(t.grad if t.grad is not None else torch.zeros_like(t))
                        .reshape(-1).to(torch.float32) for t in ls]) for ls in leaves]
    for ls, total in zip(leaves, comm.sum(flats, DATA_AXIS)):
        for t, g in zip(ls, total.split([t.numel() for t in ls])):
            if t.grad is None:
                t.grad = g.view_as(t).to(t.dtype, copy=True)
            else:
                t.grad.copy_(g.view_as(t))


def adamw(shards) -> list:
    """Mark each entry's floating leaves trainable and return one
    ``torch.optim.AdamW`` an entry over them (its own Adam state) at
    optax.adamw(1e-4)'s settings."""
    return [torch.optim.AdamW(trainable(tree), lr=LR, betas=BETAS, eps=EPS,
                              weight_decay=WEIGHT_DECAY) for tree in shards]


def train_step(shards, cfg, mesh, optimizers, images, tokens) -> torch.Tensor:
    """One step: :func:`sharded_clip_loss`, its backward, :func:`reduce_grads`
    and each entry's optimizer step (``optimizers`` from :func:`adamw`).
    Returns the global loss (a 0-d tensor on the first entry's device)."""
    for opt in optimizers:
        opt.zero_grad(set_to_none=True)
    losses = sharded_clip_loss(shards, cfg, mesh, images, tokens)
    torch.autograd.backward(losses)
    reduce_grads(shards, mesh)
    for opt in optimizers:
        opt.step()
    return losses[0].detach()
