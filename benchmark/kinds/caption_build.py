"""The captioning extraction job: decoded images through a VLM captioner's
``predict``, each caption parsed as the extraction job parses a text output.

Set-up resolves the configuration's inference id (``port.inference_id``)
through the port's registry, as the model manager does, and builds that
impl with the registry's config, the configuration's architecture and the
traffic's prompt: 6 prefix and 16 suffix ids drawn from the seed around
the image's placeholders, ``max_new_tokens`` greedy tokens. Its weights are
the benchmark's (:func:`kimi_params`: drawn from the seed on the device,
bf16 as the configuration states, the routers f32), each expert layer's
router then set from a calibration batch of its own seeded images
(``references.kimi_vl.balance_routers``), so that the loads fall as a
trained router's do; the impl is handed the tree before its ``load``. A
pool of pixel batches is made in set-up and cycled
(``inputs.pixel_batches``). A step captions one batch
(``{"pixels": …}`` inputs, as the card gets decoded images) and parses the
outputs with the job's own parse; for the sampled images of the batch the
impl also hands back its logits at each generated position and the
projected image tokens (``predict_keeping``), which the check reads.

The check, once the window has closed: every output of the window is a
caption (``captions_missing``, exact); for each sampled image and each
distinct token sequence the window generated for it, the plain f32
reference (``references/<config's reference>.py``) runs the whole sequence,
prompt and generated tokens teacher-forced, on the benchmark's own copy of
the weights (drawn again from the seed once the program has let its copy
go, with the routers set-up calibrated):

- ``logit_gap``: the largest gap between the program's logits and the
  reference's at any generated position, over the standard deviation of the
  reference's logits at that position (prefill's last position, then the
  decode steps through the latent cache);
- ``vision_gap``: the largest relative L2 gap of a projected image token;
- ``route_mismatch``: the share of (token, expert layer) pairs where the
  program's expert picks differ from the reference's own router's.

Routing is a discrete choice that a near-tie of two experts' biased scores
lets rounding flip, and a flipped pick moves its token's output by far
more than rounding. So the reference runs on the program's own picks for
``logit_gap`` (the gap then measures the arithmetic; the picks are data
the program prepared), and ``route_mismatch`` holds the picks themselves to
the reference's router.

The control is the reference with every bf16 linear's operands rounded to
float8 e4m3, the precision below the configuration's bf16.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass

import numpy as np

from benchmark import inputs

WORK = "images"
# Images in the batch that sets the routers at set-up.
CALIBRATION_IMAGES = 16


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
    prefix: tuple
    suffix: tuple
    sample: list  # (pool batch, position) pairs the check compares
    routers: list  # each expert layer's calibrated (router, router_bias)
    params: object = None  # the reference's copy of the weights, drawn at the check
    outputs: list = None  # the window's outputs, kept for the control


def kimi_leaves(config: dict) -> list:
    """(path, shape, mean, std) of every leaf of the tree in the program's
    layout: linears (in, out), an expert layer's SwiGLU weights stacked
    (experts, in, out) with gate and up side by side."""
    v = config["vision_cfg"]
    w, m, p = v["width"], v["mlp_width"], v["patch_size"]
    out = [("vision.patch_w", (p * p * 3, w), 0.0, (p * p * 3) ** -0.5),
           ("vision.patch_b", (w,), 0.0, 0.02),
           ("vision.pos_emb", (v["pos_table"], v["pos_table"], w), 0.0, 0.02)]
    for i in range(v["layers"]):
        b = f"vision.blocks.{i}."
        out += [(b + "ln0.scale", (w,), 1.0, 0.1), (b + "ln0.bias", (w,), 0.0, 0.02),
                (b + "qkv_w", (w, 3 * w), 0.0, w ** -0.5), (b + "qkv_b", (3 * w,), 0.0, 0.02),
                (b + "out_w", (w, w), 0.0, w ** -0.5), (b + "out_b", (w,), 0.0, 0.02),
                (b + "ln1.scale", (w,), 1.0, 0.1), (b + "ln1.bias", (w,), 0.0, 0.02),
                (b + "fc0_w", (w, m), 0.0, w ** -0.5), (b + "fc0_b", (m,), 0.0, 0.02),
                (b + "fc1_w", (m, w), 0.0, m ** -0.5), (b + "fc1_b", (w,), 0.0, 0.02)]
    wide, h = v["merge"] ** 2 * w, config["hidden_size"]
    out += [("vision.ln_post.scale", (w,), 1.0, 0.1), ("vision.ln_post.bias", (w,), 0.0, 0.02),
            ("projector.ln.scale", (w,), 1.0, 0.1), ("projector.ln.bias", (w,), 0.0, 0.02),
            ("projector.fc1_w", (wide, wide), 0.0, wide ** -0.5),
            ("projector.fc1_b", (wide,), 0.0, 0.02),
            ("projector.fc2_w", (wide, h), 0.0, wide ** -0.5),
            ("projector.fc2_b", (h,), 0.0, 0.02),
            ("lm.embed", (config["vocab_size"], h), 0.0, 1.0)]
    heads, nope, rope = (config["num_attention_heads"], config["qk_nope_head_dim"],
                         config["qk_rope_head_dim"])
    lora, vd = config["kv_lora_rank"], config["v_head_dim"]
    e, ew = config["n_routed_experts"], config["moe_intermediate_size"]
    sw = config["n_shared_experts"] * ew
    for i in range(config["num_hidden_layers"]):
        b = f"lm.layers.{i}."
        out += [(b + "attn_norm", (h,), 1.0, 0.1),
                (b + "q_w", (h, heads * (nope + rope)), 0.0, h ** -0.5),
                (b + "kva_w", (h, lora + rope), 0.0, h ** -0.5),
                (b + "kv_norm", (lora,), 1.0, 0.1),
                (b + "kvb_w", (lora, heads * (nope + vd)), 0.0, lora ** -0.5),
                (b + "o_w", (heads * vd, h), 0.0, (heads * vd) ** -0.5),
                (b + "ffn_norm", (h,), 1.0, 0.1)]
        if i < config["first_k_dense_replace"]:
            d = config["intermediate_size"]
            out += [(b + "mlp.gate_up", (h, 2 * d), 0.0, h ** -0.5),
                    (b + "mlp.down", (d, h), 0.0, d ** -0.5)]
        else:
            out += [(b + "moe.router", (h, e), 0.0, h ** -0.5),
                    (b + "moe.router_bias", (e,), 0.0, 0.02),
                    (b + "moe.gate_up", (e, h, 2 * ew), 0.0, h ** -0.5),
                    (b + "moe.down", (e, ew, h), 0.0, ew ** -0.5),
                    (b + "moe.shared_gate_up", (h, 2 * sw), 0.0, h ** -0.5),
                    (b + "moe.shared_down", (sw, h), 0.0, sw ** -0.5)]
    out += [("lm.norm", (h,), 1.0, 0.1), ("lm.head", (h, config["vocab_size"]), 0.0, h ** -0.5)]
    return out


def kimi_params(config: dict, seed: int, device) -> dict:
    """The tree drawn from the seed on ``device``, leaf by leaf in f32 and
    kept in bf16, the routers (``router``, ``router_bias``) in f32: norm
    scales 1 ± 0.1, biases ± 0.02, the position table ± 0.02, embeddings
    N(0, 1), linear weights N(0, 1/fan_in), the correction bias N(0, 0.02²).
    Lists hold the vision blocks and the language model's layers."""
    import torch

    gen = torch.Generator(device=device).manual_seed(inputs.sub_seed(seed, 30))
    tree: dict = {}
    for path, shape, mean, std in kimi_leaves(config):
        leaf = torch.randn(shape, generator=gen, device=device).mul_(std).add_(mean)
        keys = path.split(".")
        if not keys[-1].startswith("router"):
            leaf = leaf.to(torch.bfloat16)
        node = tree
        for key, nxt in zip(keys[:-1], keys[1:]):
            if key.isdigit():
                continue
            if nxt.isdigit():
                lst = node.setdefault(key, [])
                lst.extend({} for _ in range(int(nxt) + 1 - len(lst)))
                node = lst[int(nxt)]
            else:
                node = node.setdefault(key, {})
        node[keys[-1]] = leaf
    return tree


def _moe_layers(params: dict) -> list:
    return [layer["moe"] for layer in params["lm"]["layers"] if "moe" in layer]


def port_config(config: dict):
    """The port's ``KimiVlConfig`` of the configuration's architecture,
    required to hold every width and depth the file states."""
    from panoptikon_tpu_torch.models import kimi_vl

    cfg = kimi_vl.CONFIGS[config["port"]["arch"]]
    v, a = config["vision_cfg"], config["assumed"]
    want = {
        "image_size": v["image_size"], "patch_size": v["patch_size"], "vision_width": v["width"],
        "vision_layers": v["layers"], "vision_heads": v["heads"], "vision_mlp": v["mlp_width"],
        "merge": v["merge"], "pos_table": v["pos_table"], "vision_rope_theta": v["rope_theta"],
        "hidden": config["hidden_size"], "layers": config["num_hidden_layers"],
        "heads": config["num_attention_heads"], "qk_nope": config["qk_nope_head_dim"],
        "qk_rope": config["qk_rope_head_dim"], "v_head": config["v_head_dim"],
        "kv_lora": config["kv_lora_rank"], "dense_width": config["intermediate_size"],
        "first_dense": config["first_k_dense_replace"], "experts": config["n_routed_experts"],
        "experts_per_token": config["num_experts_per_tok"],
        "expert_width": config["moe_intermediate_size"],
        "shared_experts": config["n_shared_experts"],
        "routed_scale": config["routed_scaling_factor"], "vocab": config["vocab_size"],
        "rope_theta": config["rope_theta"], "rms_eps": config["rms_norm_eps"],
        "media_id": a["media_id"], "eos_id": a["eos_id"],
    }
    got = {key: getattr(cfg, key) for key in want}
    if got != want:
        raise ValueError(f"the port's {config['port']['arch']} is {got}, the configuration {want}")
    return cfg


def _prompt(cell, seed) -> tuple:
    """The prefix and suffix ids, drawn from the seed below the placeholder
    and EOS ids."""
    a, t = cell.config["assumed"], cell.traffic
    rng = np.random.default_rng(inputs.sub_seed(seed, 31))
    high = min(a["media_id"], a["eos_id"])
    ids = rng.integers(0, high, size=t["prefix_ids"] + t["suffix_ids"]).tolist()
    return tuple(ids[:t["prefix_ids"]]), tuple(ids[t["prefix_ids"]:])


def _prompt_ids(cell, prefix, suffix):
    """The prompt a row: the prefix, the image's placeholders, the suffix."""
    import torch

    a = cell.config["assumed"]
    v = cell.config["vision_cfg"]
    tokens = (v["image_size"] // v["patch_size"] // v["merge"]) ** 2
    return torch.tensor([*prefix, *([a["media_id"]] * tokens), *suffix], dtype=torch.long)


def _sample(cell, seed) -> list:
    """The sampled (pool batch, position) pairs, drawn from the seed: the
    i-th from pool batch i mod P, so that the first batch a window runs
    always holds one."""
    t = cell.traffic
    p, b = int(t["pool_batches"]), int(t["images_per_batch"])
    rng = np.random.default_rng(inputs.sub_seed(seed, 32))
    count = min(int(t["sample_images"]), p * b)
    per_batch = [rng.permutation(b)[: (count - q + p - 1) // p] for q in range(p)]
    return sorted((q, int(j)) for q in range(p) for j in per_batch[q])


def _calibrated(cell, seed, device, prefix, suffix) -> dict:
    """:func:`kimi_params`, each expert layer's router set by the reference
    over ``CALIBRATION_IMAGES`` seeded images (drawn as the pool's are) and
    the traffic's prompt."""
    import torch

    ref = importlib.import_module(f"benchmark.references.{cell.config['reference']}")
    params = kimi_params(cell.config, seed, device)
    size = cell.config["vision_cfg"]["image_size"]
    gen = torch.Generator(device=device).manual_seed(inputs.sub_seed(seed, 34))
    images = torch.randn((CALIBRATION_IMAGES, size, size, 3), generator=gen, device=device)
    prompt = _prompt_ids(cell, prefix, suffix)
    ids = prompt.to(device).expand(CALIBRATION_IMAGES, prompt.numel())
    ref.balance_routers(params, cell.config, images, ids, prompt_len=prompt.numel())
    return params


def setup(cell, seed, device) -> State:
    from panoptikon_tpu_torch.models.impls import IMPL_INDEX, PredictionInput
    from panoptikon_tpu_torch.models.registry import Registry

    cfg = port_config(cell.config)
    t = cell.traffic
    batch = int(t["images_per_batch"])
    group, _, name = cell.config["port"]["inference_id"].partition("/")
    rid = Registry(None).resolve(group, name)
    prefix, suffix = _prompt(cell, seed)
    impl = IMPL_INDEX[rid.impl_class](**{
        **rid.spawn_kwargs(), "model_arch": cell.config["port"]["arch"],
        "image_size": cfg.image_size, "max_new_tokens": int(t["max_new_tokens"]),
        "prefix_ids": prefix, "suffix_ids": suffix, "batch_cap": batch, "device": device})
    impl.params = _calibrated(cell, seed, device, prefix, suffix)
    routers = [(moe["router"].clone(), moe["router_bias"].clone())
               for moe in _moe_layers(impl.params)]
    impl.load()
    pool = inputs.pixel_batches(cell.config, seed, int(t["pool_batches"]), batch, device)
    pool_inputs = [[PredictionInput(data={"pixels": img}) for img in b] for b in pool]
    return State(cell=cell, seed=seed, device=device, impl=impl, pool=pool,
                 pool_inputs=pool_inputs, prefix=prefix, suffix=suffix,
                 sample=_sample(cell, seed), routers=routers)


def step(state: State, i: int, spans):
    from panoptikon_tpu_torch.jobs.extraction import _decode_outputs

    p = i % len(state.pool)
    keep = [j for q, j in state.sample if q == p]
    with spans("predict"):
        out, kept = state.impl.predict_keeping(state.pool_inputs[p], keep)
    with spans("parse"):
        parsed = [_decode_outputs("text", o) if isinstance(o, dict) and "text" in o else None
                  for o in out]
    return p, parsed, kept


def warm(state: State, spans) -> None:
    """Every shape the window runs: each batch's tower, prefill and decode."""
    for i in range(int(state.cell.traffic["warmup_batches"])):
        step(state, i, spans)


def release(state: State) -> None:
    """The impl lets its weights go; the check draws its own copy."""
    state.impl.unload()
    state.impl = None


def _reference_params(state: State) -> dict:
    """The benchmark's copy of the weights: :func:`kimi_params` drawn again
    from the seed, with the routers set-up calibrated."""
    if state.params is None:
        state.params = kimi_params(state.cell.config, state.seed, state.device)
        for moe, (router, bias) in zip(_moe_layers(state.params), state.routers):
            moe["router"], moe["router_bias"] = router, bias
    return state.params


def _sequences(outputs) -> dict:
    """(pool batch, position) -> {key: [kept entries]}: the distinct
    generated sequences (tokens and expert picks) of each sampled image, each
    with every occurrence of it in the window."""
    seqs: dict = {}
    for p, _, kept in outputs:
        for j, entry in kept.items():
            key = entry["tokens"].numpy().tobytes() + entry["routes"].numpy().tobytes()
            seqs.setdefault((p, j), {}).setdefault(key, []).append(entry)
    return seqs


def _reference(state: State, items: list, fp8: bool = False, block: int = 4) -> list:
    """The reference over ``items`` ((pool batch, position, kept entry, routes
    or None)): (image tokens (n, H), logits at the entry's generated
    positions, its own expert picks (layers, N, k)) each, f32 on the host."""
    import torch

    ref = importlib.import_module(f"benchmark.references.{state.cell.config['reference']}")
    params = _reference_params(state)
    prompt = _prompt_ids(state.cell, state.prefix, state.suffix)
    n = prompt.numel()
    out = []
    for lo in range(0, len(items), block):
        part = items[lo:lo + block]
        length = min(e["logits"].shape[0] for _, _, e, _ in part)
        images = torch.from_numpy(np.stack([state.pool[p][j] for p, j, _, _ in part]))
        ids = torch.stack([torch.cat([prompt, e["tokens"][:length - 1]]) for _, _, e, _ in part])
        routes = None
        if part[0][3] is not None:
            routes = torch.stack([r[:, :n + length - 1] for _, _, _, r in part]).to(state.device)
        img, logits, own = ref.forward(params, state.cell.config, images.to(state.device),
                                       ids.to(state.device), prompt_len=n, logits_from=n - 1,
                                       linear_fp8=fp8, routes=routes)
        out += [(img[r].cpu(), logits[r].cpu(), own[r].cpu()) for r in range(len(part))]
    return out


def _finite(x: float) -> float:
    return x if np.isfinite(x) else float("inf")


def _gaps(got, want) -> dict:
    """The numbers of one sequence: ``got`` and ``want`` are (image tokens,
    logits, expert picks), the reference's run on the picks of ``got``."""
    import torch

    g_img, g_logits, g_picks = (t.to(torch.float32) if t.is_floating_point() else t for t in got)
    w_img, w_logits, w_picks = want
    t = min(g_logits.shape[0], w_logits.shape[0])
    vision = (g_img - w_img).norm(dim=-1) / w_img.norm(dim=-1).clamp(min=1e-30)
    logit = (g_logits[:t] - w_logits[:t]).abs().amax(dim=-1) / w_logits[:t].std(dim=-1)
    n = min(g_picks.shape[1], w_picks.shape[1])
    apart = (g_picks[:, :n].sort(dim=-1).values != w_picks[:, :n].sort(dim=-1).values).any(-1)
    return {"vision_gap": _finite(float(vision.max())),
            "logit_gap": _finite(float(logit.max())) if t else float("inf"),
            "route_mismatch": float(apart.to(torch.float32).mean())}


def _worst(rows: list) -> dict:
    names = ("logit_gap", "vision_gap", "route_mismatch")
    if not rows:
        return dict.fromkeys(names, float("inf"))
    return {name: max(r[name] for r in rows) for name in names}


def _judge(state: State, outputs) -> dict:
    """Each distinct sequence of each sampled image against the reference
    run on the program's own expert picks."""
    groups = [(p, j, entries) for (p, j), by in _sequences(outputs).items()
              for entries in by.values()]
    want = _reference(state, [(p, j, es[0], es[0]["routes"]) for p, j, es in groups])
    return _worst([_gaps((e["image_tokens"], e["logits"], e["routes"]), w)
                   for (_, _, es), w in zip(groups, want) for e in es])


def check(state: State, outputs) -> list:
    """The numbers the cell's limits name, each with its limit."""
    state.outputs = outputs
    b = int(state.cell.traffic["images_per_batch"])
    missing = sum(sum(1 for o in parsed if o is None) + b - len(parsed)
                  for _, parsed, _ in outputs)
    got = {**_judge(state, outputs), "captions_missing": float(missing)}
    return [(name, got[name], float(limit)) for name, limit in state.cell.limits.items()]


def control(state: State) -> list:
    """The reference with float8 e4m3 linears and its own expert picks, in
    the program's place, over the sequences the last run generated."""
    items = [(p, j, es[0], None)
             for (p, j), by in _sequences(state.outputs).items() for es in by.values()]
    low = _reference(state, items, fp8=True)
    replay = [(p, j, e, own) for (p, j, e, _), (_, _, own) in zip(items, low)]
    want = _reference(state, replay)
    got = _worst([_gaps(g, w) for g, w in zip(low, want)])
    return [(name, got[name]) for name in state.cell.limits if name in got]
