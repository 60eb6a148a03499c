"""The dp × tp CLIP train step on the port (``parallel/train.py``) against
the JAX package's sharded step, on the CPU at ``test-tiny``.

The JAX step is part (a) of ``__graft_entry__.py``'s ``dryrun_multichip``
rebuilt here from the JAX package's own pieces: a ``("data", "model")``
``Mesh`` of 4 of conftest's 8 virtual CPU devices, the parameters placed by
``clip.param_shard_rules``, the batch by ``P("data")``, and
``optax.adamw(1e-4)`` over ``jax.value_and_grad(clip.clip_loss)`` under
``jax.jit``. The port's step runs on a 2 × 2 mesh of 4 CPU entries
(``set_devices([cpu] * 4)``) in one process, and in 4 processes over gloo.
Both packages start from one seeded JAX tree and 8 seeded pairs; the gloo
processes, which import only the port, from the port's seeded tree, held
to the in-process form from that tree.
Tolerances, each with its reason:

- the loss within 1e-2 relative and every leaf's gathered gradient at
  cosine ≥ 0.99 with its norm within 5 %, as ``test_torch_train.py`` holds
  the one-device step: the towers run in bf16 in both packages, which
  round at different points (and the port's row-parallel linears sum f32
  partials, rounding once). The norm is what catches a gradient off by a
  factor of ``data`` or ``model``: a scale leaves the cosine at 1, and
  Adam's update hides it too.
- the losses over 5 AdamW steps within 2e-2 relative: the weights drift
  apart by the bf16 differences above.
- the gloo form against the in-process form within 1e-6 relative (the
  losses of 2 steps, and each entry's gradients at step 0 by norm of the
  difference): both sum the same f32 values, two at a time, so they agree
  to rounding.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from panoptikon_tpu.models import clip as ref_clip
from panoptikon_tpu_torch.models import clip, convert
from panoptikon_tpu_torch.parallel import mesh as meshlib
from panoptikon_tpu_torch.parallel import train
from tests.test_torch_train import clip_batch, cosine

REPO = Path(__file__).resolve().parent.parent
DATA, MODEL, BATCH, STEPS, GLOO_STEPS = 2, 2, 8, 5, 2
COS_FLOOR, NORM_RTOL, LOSS_RTOL, STEPS_RTOL, GLOO_RTOL = 0.99, 0.05, 1e-2, 2e-2, 1e-6
CPU4 = [torch.device("cpu")] * (DATA * MODEL)
CFG = clip.CONFIGS["test-tiny"]


def grad_mismatches(got: dict, want: dict) -> list:
    """The leaves whose gradient is not finite, or below COS_FLOOR in
    cosine, or off by more than NORM_RTOL in norm."""
    assert set(got) == set(want)
    bad = []
    for path, w in want.items():
        g = got[path]
        nw = np.linalg.norm(w)
        if (g.shape != w.shape or not np.isfinite(g).all() or cosine(g, w) < COS_FLOOR
                or abs(np.linalg.norm(g) - nw) > NORM_RTOL * nw):
            bad.append(path)
    return bad


def jax_tree():
    return ref_clip.init_params(jax.random.key(0), ref_clip.CONFIGS["test-tiny"])


def numpy_grads(tree) -> dict:
    return {p: t.numpy() for p, t in convert.named_leaves(tree).items()}


@pytest.fixture(scope="module")
def jax_sharded():
    """The JAX package's dp × tp step: the loss and gathered gradients at
    step 0, and the losses of STEPS adamw steps."""
    rcfg = ref_clip.CONFIGS["test-tiny"]
    mesh = Mesh(np.array(jax.devices()[:DATA * MODEL]).reshape(DATA, MODEL), ("data", "model"))
    rule = ref_clip.param_shard_rules(rcfg)

    def spec_of(path, _leaf):
        return rule("/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path))

    params = jax_tree()
    specs = jax.tree_util.tree_map_with_path(spec_of, params)
    params = jax.device_put(params, jax.tree.map(lambda s: NamedSharding(mesh, s), specs))
    tx = optax.adamw(1e-4)
    opt_state = jax.device_put(tx.init(params), jax.tree.map(
        lambda _: NamedSharding(mesh, P()), tx.init(params)))
    images, tokens = clip_batch(rcfg, BATCH, seed=1)
    images, tokens = (jax.device_put(a, NamedSharding(mesh, P("data"))) for a in (images, tokens))

    @jax.jit
    def step(params, opt_state, images, tokens):
        loss, grads = jax.value_and_grad(ref_clip.clip_loss)(params, rcfg, images, tokens)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, grads

    losses = []
    for i in range(STEPS):
        params, opt_state, loss, grads = step(params, opt_state, images, tokens)
        losses.append(float(loss))
        if i == 0:
            grads0 = convert.named_leaves(jax.tree.map(np.asarray, grads))
    return losses, grads0


def sharded_run(steps: int, tree=None):
    """The port's in-process 2 × 2 step from ``tree`` (else jax_tree()):
    the step-0 loss, gathered gradients and each entry's gradients, and
    every step's loss."""
    meshlib.set_devices(CPU4)
    try:
        mesh = meshlib.train_mesh(DATA, MODEL)
    finally:
        meshlib.set_devices(None)
    rules = clip.param_shard_rules(CFG, MODEL)
    if tree is None:
        tree = convert.params_from_jax(jax.tree.map(np.asarray, jax_tree()), device="cpu")
    shards = convert.shard_params(tree, mesh, rules)
    opts = train.adamw(shards)
    images, tokens = (torch.from_numpy(a) for a in clip_batch(CFG, BATCH, seed=1))
    losses = train.sharded_clip_loss(shards, CFG, mesh, images, tokens)
    assert len({loss.item() for loss in losses}) == 1  # every entry reads the global loss
    torch.autograd.backward(losses)
    train.reduce_grads(shards, mesh)
    grads = numpy_grads(convert.gather_grads(shards, mesh, rules))
    entries = [{p: t.grad.numpy().copy() for p, t in convert.named_leaves(s).items()}
               for s in shards]
    for opt in opts:
        opt.step()
    values = [losses[0].item()]
    for _ in range(steps - 1):
        values.append(train.train_step(shards, CFG, mesh, opts, images, tokens).item())
    return values, grads, entries


@pytest.fixture(scope="module")
def port_sharded():
    return sharded_run(STEPS)


@pytest.fixture(scope="module")
def port_one_device():
    """The port's one-device step on the same tree and batch, AdamW at the
    sharded step's settings."""
    tree = convert.params_from_jax(jax.tree.map(np.asarray, jax_tree()), device="cpu")
    leaves = convert.trainable(tree)
    opt = torch.optim.AdamW(leaves, lr=train.LR, betas=train.BETAS, eps=train.EPS,
                            weight_decay=train.WEIGHT_DECAY)
    images, tokens = (torch.from_numpy(a) for a in clip_batch(CFG, BATCH, seed=1))
    losses = []
    for i in range(STEPS):
        opt.zero_grad()
        loss = clip.clip_loss(tree, CFG, images, tokens)
        loss.backward()
        if i == 0:
            grads = convert.grads_numpy(tree)
        opt.step()
        losses.append(loss.item())
    return losses, grads


@pytest.mark.parametrize("reference", ["jax_sharded", "port_one_device"])
def test_sharded_step_matches(reference, port_sharded, request):
    # 1 (against the JAX package's GSPMD step) and 2 (against the port's
    # one-device step): loss and every leaf's gradient at step 0.
    want_losses, want_grads = request.getfixturevalue(reference)
    losses, grads, _ = port_sharded
    assert abs(losses[0] - want_losses[0]) <= LOSS_RTOL * abs(want_losses[0])
    assert grad_mismatches(grads, want_grads) == []


@pytest.mark.parametrize("reference", ["jax_sharded", "port_one_device"])
def test_sharded_adamw_steps_track(reference, port_sharded, request):
    want, _ = request.getfixturevalue(reference)
    got = port_sharded[0]
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=STEPS_RTOL)
    assert got[-1] < got[0]


@pytest.mark.parametrize("leaf", ["logit_scale", "visual.blocks.0.attn.qkv_w"])
def test_norm_check_rejects_a_gradient_off_by_the_axis_size(leaf, port_sharded, jax_sharded):
    # A gradient summed once too often over data or model is 2x here; the
    # cosine cannot see it, the norm check must.
    _, grads, _ = port_sharded
    assert grad_mismatches(grads, jax_sharded[1]) == []
    assert grad_mismatches({**grads, leaf: grads[leaf] * DATA}, jax_sharded[1]) == [leaf]


def test_norm_check_rejects_an_all_reduce_backward(monkeypatch, jax_sharded):
    # The trap of a differentiable all-reduce whose backward all-reduces
    # again: each block's branch passes back twice its gradient, so the
    # leaves beneath (the embeddings here) are off in norm.
    def summed(ctx, *grads):
        sums = train.Collectives(ctx.mesh).sum(grads, meshlib.MODEL_AXIS)
        return (None, None, *(s.to(dt) for s, dt in zip(sums, ctx.dtypes)))

    forward = train._ReduceFromModel.forward

    def keep_mesh(ctx, comm, dtype, *xs):
        ctx.mesh = comm.mesh
        return forward(ctx, comm, dtype, *xs)

    monkeypatch.setattr(train._ReduceFromModel, "forward", staticmethod(keep_mesh))
    monkeypatch.setattr(train._ReduceFromModel, "backward", staticmethod(summed))
    _, grads, _ = sharded_run(1)
    bad = grad_mismatches(grads, jax_sharded[1])
    assert "visual.patch_w" in bad and "text.token_emb" in bad


def test_rules_are_the_references_with_qkv_per_head():
    rcfg = ref_clip.CONFIGS["test-tiny"]
    ref_rule, rule = ref_clip.param_shard_rules(rcfg), clip.param_shard_rules(CFG, MODEL)
    paths = ["/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(jax_tree())[0]]
    assert len(paths) == len(convert.named_leaves(jax_tree()))
    per_head = set()
    for path in paths:
        want, got = tuple(ref_rule(path)), rule(path)
        assert rule(path.replace("/", ".")) == got
        if path.endswith(("qkv_w", "qkv_b")):
            per_head.add(path)
            assert got[:-1] == want[:-1] and got[-1] == meshlib.Split(want[-1], 3)
        else:
            assert got == want, path
    assert len(per_head) == 2 * (rcfg.vision_layers + rcfg.text_layers)


def test_shard_then_gather_is_the_identity_and_heads_stay_whole():
    mesh = meshlib.train_mesh(DATA, MODEL, devs=CPU4)
    rules = clip.param_shard_rules(CFG, MODEL)
    tree = convert.params_from_jax(jax.tree.map(np.asarray, jax_tree()), device="cpu")
    shards = convert.shard_params(tree, mesh, rules)
    full = convert.named_leaves(tree)
    for path, t in convert.named_leaves(convert.gather_params(shards, mesh, rules)).items():
        assert torch.equal(t, full[path]), path
    w = full["visual.blocks.0.attn.qkv_w"]
    width = CFG.vision_width
    for (coords, _), shard in zip(meshlib.local_entries(mesh), shards):
        # entry (d, m): heads [m·H/M, (m+1)·H/M) of q, k and v; replicated
        # leaves a copy of its own
        m, cut = coords["model"], width // MODEL
        cols = [j * width + m * cut + c for j in range(3) for c in range(cut)]
        assert torch.equal(shard["visual"]["blocks"][0]["attn"]["qkv_w"], w[:, cols])
        assert shard["logit_scale"].data_ptr() != tree["logit_scale"].data_ptr()


def test_placements_are_the_references():
    # corpus_sharding, replicated and pad_to_multiple against the JAX
    # package's; a placement's blocks reassemble the tensor.
    from panoptikon_tpu.parallel import mesh as ref_mesh

    rmesh, mesh = ref_mesh.index_mesh(jax.devices()[:4]), meshlib.index_mesh(CPU4)
    assert tuple(ref_mesh.corpus_sharding(rmesh).spec) == meshlib.corpus_sharding(mesh).spec
    assert tuple(ref_mesh.replicated(rmesh).spec) == meshlib.replicated(mesh).spec == ()
    rows = torch.arange(32.0).reshape(16, 2)
    rows_on = meshlib.corpus_sharding(mesh)
    assert torch.equal(rows_on.block(rows, {"shard": 2}), rows[8:12])
    assert torch.equal(rows_on.assemble(lambda c: rows_on.block(rows, c)), rows)
    assert meshlib.replicated(mesh).block(rows, {"shard": 3}) is rows
    for n, m in ((0, 4), (1, 4), (8, 4), (9, 8), (1000, 64)):
        assert meshlib.pad_to_multiple(n, m) == ref_mesh.pad_to_multiple(n, m)


def test_a_model_axis_that_splits_a_head_raises():
    with pytest.raises(ValueError, match="does not divide"):
        clip.param_shard_rules(CFG, CFG.vision_heads + 2)


def test_train_mesh_raises_without_devices_or_on_a_mismatch():
    meshlib.set_devices(None)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="needs devices"):
            meshlib.train_mesh(2, 2)
    with pytest.raises(ValueError, match="3x2"):
        meshlib.train_mesh(3, 2, devs=CPU4)
    mesh = meshlib.train_mesh(model=2, devs=CPU4)
    assert mesh.shape == {"data": 2, "model": 2} and mesh.groups == {}


def test_sharded_loss_raises_on_shards_that_do_not_fit():
    mesh = meshlib.train_mesh(DATA, MODEL, devs=CPU4)
    tree = convert.params_from_jax(jax.tree.map(np.asarray, jax_tree()), device="cpu")
    shards = convert.shard_params(tree, mesh, clip.param_shard_rules(CFG, MODEL))
    images, tokens = (torch.from_numpy(a) for a in clip_batch(CFG, BATCH, seed=1))
    with pytest.raises(ValueError, match="3 shard trees"):
        train.sharded_clip_loss(shards[:3], CFG, mesh, images, tokens)
    with pytest.raises(ValueError, match="global batch"):
        train.sharded_clip_loss(shards, CFG, mesh, images[:7], tokens[:7])


# Process RANK of DATA·MODEL over gloo at COORD, one CPU entry each, from
# the port's seeded tree and the batch in OUT/batch.npz: its entry's step-0
# gradients to OUT/RANK.npz, then a JSON line with the losses of GLOO_STEPS
# steps. It imports only the port.
GLOO_WORKER = """
import json, sys
from pathlib import Path
import numpy as np, torch
from panoptikon_tpu_torch.models import clip, convert
from panoptikon_tpu_torch.parallel import mesh as meshlib, multihost, train

rank, coord, out, steps = int(sys.argv[1]), sys.argv[2], Path(sys.argv[3]), int(sys.argv[4])
cfg = clip.CONFIGS["test-tiny"]
assert multihost.initialize(coord, 4, rank)
meshlib.set_devices([torch.device("cpu")])
mesh = meshlib.train_mesh(2, 2)
assert mesh.processes.tolist() == [[0, 1], [2, 3]] and set(mesh.groups) == {"data", "model"}
tree = clip.init_params(cfg, torch.Generator().manual_seed(0))
(shard,) = convert.shard_params(tree, mesh, clip.param_shard_rules(cfg, 2))
opts = train.adamw([shard])
with np.load(out / "batch.npz") as batch:
    images, tokens = torch.from_numpy(batch["images"]), torch.from_numpy(batch["tokens"])
(loss,) = train.sharded_clip_loss([shard], cfg, mesh, images, tokens)
loss.backward()
train.reduce_grads([shard], mesh)
np.savez(out / f"{rank}.npz", **{p: t.grad.numpy() for p, t in convert.named_leaves(shard).items()})
opts[0].step()
losses = [loss.item()] + [train.train_step([shard], cfg, mesh, opts, images, tokens).item()
                          for _ in range(steps - 1)]
print(json.dumps({"rank": rank, "entry": meshlib.local_entries(mesh)[0][0], "losses": losses}))
"""


def test_gloo_form_equals_the_in_process_form(tmp_path):
    # 5: four processes spawned as test_torch_multihost.py spawns them,
    # against the in-process form from the same tree and batch.
    import socket

    images, tokens = clip_batch(CFG, BATCH, seed=1)
    np.savez(tmp_path / "batch.npz", images=images, tokens=tokens)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{s.getsockname()[1]}"
    env = {**os.environ, "PYTHONPATH": str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    env.pop("MASTER_ADDR", None)
    procs = [subprocess.Popen([sys.executable, "-c", GLOO_WORKER, str(r), coord, str(tmp_path),
                               str(GLOO_STEPS)], cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(DATA * MODEL)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    losses, _, entries = sharded_run(GLOO_STEPS, clip.init_params(CFG, torch.Generator().manual_seed(0)))
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out[-4000:]
        got = json.loads(out.strip().splitlines()[-1])
        assert got["rank"] == rank and got["entry"] == {"data": rank // MODEL,
                                                        "model": rank % MODEL}
        np.testing.assert_allclose(got["losses"], losses, rtol=GLOO_RTOL)
        with np.load(tmp_path / f"{rank}.npz") as grads:
            assert set(grads.files) == set(entries[rank])
            for path, want in entries[rank].items():
                diff = np.linalg.norm(grads[path] - want)
                assert diff <= GLOO_RTOL * np.linalg.norm(want), (rank, path, diff)
