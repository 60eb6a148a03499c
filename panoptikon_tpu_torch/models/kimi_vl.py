"""Kimi-VL-A3B-Instruct on tensors: a MoonViT image tower, an MLP projector and
a DeepSeek-V3-style language model with latent attention (MLA) and routed
experts, decoding greedily through a latent KV cache.

Parameters are a plain dict tree, drawn from a ``torch.Generator``
(:func:`init_params`); linear weights are (in, out) and applied as ``x @ w``.
Weights and activations are bf16 with f32 accumulation; RMSNorm, LayerNorm
statistics, the router and softmax are f32. The same functions run in f32
when the tree is f32 (the tests compare both with the plain reference,
``benchmark/references/kimi_vl.py``, which computes these equations in f32).

**MoonViT** (the image tower, at a fixed image size S, grid g = S / 14):

- patches: the 14×14 stride-14 convolution (3 → W) as a reshape of NHWC
  pixels to (g², 14·14·3) rows in (row, column, channel) order and one
  matmul with bias;
- positions: the learned (P, P, W) table resized bicubically to (g, g)
  (``align_corners=False``, no antialias) and added;
- each block: ``x + o(attn(LN0(x)))``, then ``x + fc1(gelu_tanh(fc0(LN1(x))))``;
  qkv and out projections with bias, 16 heads of width 72, full attention
  within an image scaled by 1/√72;
- 2D RoPE (θ 10,000) on q and k: the head's D/2 pairs are adjacent
  elements (2j, 2j + 1); pair j turns by ``column · f_{j//2}`` for even j
  and ``row · f_{j//2}`` for odd j, ``f_i = θ^(-4i/D)``;
- a final LayerNorm; LayerNorms take eps 1e-5 and the population variance.

**Projector**: LayerNorm(W) on each token, then each 2×2 block of
neighbours concatenated in row-major order ((g/2)² tokens of 4W), then
``fc2(gelu(fc1(x)))`` (erf GELU; both linears with bias) to the language
model's width.

**Language model** (hidden H, L layers, each pre-RMSNorm: ``h + attn(norm(h))``
then ``h + ffn(norm(h))``):

- the prompt's embeddings, with the image tokens in place of the
  placeholder id's positions;
- MLA: ``q = h W_q`` splits per head into ``q_nope`` (128) and ``q_pe`` (64);
  ``[c_kv, k_pe] = h W_kva`` (576 wide), ``c_kv = RMSNorm(c_kv)``;
  ``[k_nope, v] = c_kv W_kvb`` per head (128, 128); RoPE (θ 800,000, the
  half-split rotation over the 64 dims) on ``q_pe`` and the shared ``k_pe``;
  causal attention scaled by 1/√192; out ``concat_h(v) W_o``;
- layer 0 a SwiGLU MLP ``(silu(h W_gate) · h W_up) W_down``; the others the
  expert layer: ``s = sigmoid(h W_g)`` (f32) over the experts, the top k by
  ``s + b`` (``b`` the correction bias), weights ``s_i / Σ s`` of the chosen
  times the routed scaling factor, ``y = Σ w_i E_i(h) + S(h)``, each ``E_i``
  a SwiGLU of the expert width and ``S`` one SwiGLU of the shared width;
- the final RMSNorm (eps 1e-5), then the untied head.

**Decoding** (:func:`generate`): one latent cache a layer, (B, prompt +
max_new, 576) holding ``[c_kv, k_pe]`` (``k_pe`` after its rotation), 1,152
bytes a token a layer in bf16. Prefill takes the expanded form above
(``F.scaled_dot_product_attention``, v padded to the q·k width). A decode
step takes the absorbed form: ``q_lat = q_nope W_UKᵀ`` per head (512 wide),
scores ``[q_lat, q_pe] · [c_kv, k_pe]`` over the cache, ``o = (p · c_kv)
W_UV``, over the whole cache with the positions not yet written masked, so
that every step has the same shapes and the step runs as one CUDA graph,
captured once for each (batch, cache length) with its caches and replayed
by every later batch of that shape. Greedy argmax; a row stops at the EOS
id and the rest run on to ``max_new``.

**Routed experts** (:func:`routed_experts`): no Python loop over experts.
Each pick goes to its expert's rows of one buffer padded to a capacity,
then one ``torch.bmm`` a projection runs over every expert held. A prefill
pads to the largest load (read back once a layer); a decode step to its
token count, so that nothing is read back inside the graph.

Spans and counters (``panoptikon_tpu_torch.tracing``, under the profiler):
``kimi_vl.vision`` (tower and projector), ``kimi_vl.prefill`` and
``kimi_vl.decode`` (the tokens on the host), each ending with its output
ready; counters ``kimi_vl.decode_steps``, ``kimi_vl.prefill_tokens`` and
``kimi_vl.cache_bytes`` (the latent cache the batch runs through).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import torch
import torch.nn.functional as F

from panoptikon_tpu_torch import tracing
from panoptikon_tpu_torch.models import clip

Params = dict[str, Any]

# How often (in decode steps) generate reads back whether every row has
# stopped.
DONE_CHECK_STEPS = 8


@dataclasses.dataclass(frozen=True)
class KimiVlConfig:
    # MoonViT and the projector
    image_size: int = 448
    patch_size: int = 14
    vision_width: int = 1152
    vision_layers: int = 27
    vision_heads: int = 16
    vision_mlp: int = 4304
    pos_table: int = 64
    merge: int = 2
    vision_rope_theta: float = 10000.0
    # the language model
    hidden: int = 2048
    layers: int = 27
    heads: int = 16
    qk_nope: int = 128
    qk_rope: int = 64
    v_head: int = 128
    kv_lora: int = 512
    dense_width: int = 11264
    first_dense: int = 1
    experts: int = 64
    experts_per_token: int = 6
    expert_width: int = 1408
    shared_experts: int = 2
    routed_scale: float = 2.446
    vocab: int = 163840
    rope_theta: float = 800000.0
    rms_eps: float = 1e-5
    # the placeholder of an image token in the prompt, and the end of a turn
    media_id: int = 163605
    eos_id: int = 163586

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def image_tokens(self) -> int:
        return (self.grid // self.merge) ** 2

    @property
    def vision_head_dim(self) -> int:
        return self.vision_width // self.vision_heads

    @property
    def qk_head(self) -> int:
        return self.qk_nope + self.qk_rope

    @property
    def latent(self) -> int:
        return self.kv_lora + self.qk_rope


CONFIGS = {
    "Kimi-VL-A3B-Instruct": KimiVlConfig(),
    "test-tiny": KimiVlConfig(
        image_size=56, patch_size=14, vision_width=64, vision_layers=2, vision_heads=4,
        vision_mlp=128, pos_table=8, hidden=64, layers=3, heads=4, qk_nope=16, qk_rope=8,
        v_head=16, kv_lora=32, dense_width=128, experts=8, experts_per_token=2,
        expert_width=32, shared_experts=1, vocab=512, media_id=500, eos_id=501,
    ),
}


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _leaves(cfg: KimiVlConfig) -> list:
    """(path, shape, mean, std) of every leaf, in the order they are drawn."""
    w, m, p = cfg.vision_width, cfg.vision_mlp, cfg.patch_size
    out = [("vision.patch_w", (p * p * 3, w), 0.0, (p * p * 3) ** -0.5),
           ("vision.patch_b", (w,), 0.0, 0.02),
           ("vision.pos_emb", (cfg.pos_table, cfg.pos_table, w), 0.0, 0.02)]
    for i in range(cfg.vision_layers):
        b = f"vision.blocks.{i}."
        out += [(b + "ln0.scale", (w,), 1.0, 0.1), (b + "ln0.bias", (w,), 0.0, 0.02),
                (b + "qkv_w", (w, 3 * w), 0.0, w ** -0.5), (b + "qkv_b", (3 * w,), 0.0, 0.02),
                (b + "out_w", (w, w), 0.0, w ** -0.5), (b + "out_b", (w,), 0.0, 0.02),
                (b + "ln1.scale", (w,), 1.0, 0.1), (b + "ln1.bias", (w,), 0.0, 0.02),
                (b + "fc0_w", (w, m), 0.0, w ** -0.5), (b + "fc0_b", (m,), 0.0, 0.02),
                (b + "fc1_w", (m, w), 0.0, m ** -0.5), (b + "fc1_b", (w,), 0.0, 0.02)]
    wide = cfg.merge ** 2 * w
    h = cfg.hidden
    out += [("vision.ln_post.scale", (w,), 1.0, 0.1), ("vision.ln_post.bias", (w,), 0.0, 0.02),
            ("projector.ln.scale", (w,), 1.0, 0.1), ("projector.ln.bias", (w,), 0.0, 0.02),
            ("projector.fc1_w", (wide, wide), 0.0, wide ** -0.5),
            ("projector.fc1_b", (wide,), 0.0, 0.02),
            ("projector.fc2_w", (wide, h), 0.0, wide ** -0.5),
            ("projector.fc2_b", (h,), 0.0, 0.02),
            ("lm.embed", (cfg.vocab, h), 0.0, 1.0)]
    heads, e, ew = cfg.heads, cfg.experts, cfg.expert_width
    sw = cfg.shared_experts * ew
    for i in range(cfg.layers):
        b = f"lm.layers.{i}."
        out += [(b + "attn_norm", (h,), 1.0, 0.1),
                (b + "q_w", (h, heads * cfg.qk_head), 0.0, h ** -0.5),
                (b + "kva_w", (h, cfg.latent), 0.0, h ** -0.5),
                (b + "kv_norm", (cfg.kv_lora,), 1.0, 0.1),
                (b + "kvb_w", (cfg.kv_lora, heads * (cfg.qk_nope + cfg.v_head)), 0.0,
                 cfg.kv_lora ** -0.5),
                (b + "o_w", (heads * cfg.v_head, h), 0.0, (heads * cfg.v_head) ** -0.5),
                (b + "ffn_norm", (h,), 1.0, 0.1)]
        if i < cfg.first_dense:
            d = cfg.dense_width
            out += [(b + "mlp.gate_up", (h, 2 * d), 0.0, h ** -0.5),
                    (b + "mlp.down", (d, h), 0.0, d ** -0.5)]
        else:
            out += [(b + "moe.router", (h, e), 0.0, h ** -0.5),
                    (b + "moe.router_bias", (e,), 0.0, 0.02),
                    (b + "moe.gate_up", (e, h, 2 * ew), 0.0, h ** -0.5),
                    (b + "moe.down", (e, ew, h), 0.0, ew ** -0.5),
                    (b + "moe.shared_gate_up", (h, 2 * sw), 0.0, h ** -0.5),
                    (b + "moe.shared_down", (sw, h), 0.0, sw ** -0.5)]
    out += [("lm.norm", (h,), 1.0, 0.1), ("lm.head", (h, cfg.vocab), 0.0, h ** -0.5)]
    return out


# Leaves of an expert layer kept in f32 whatever the tree's dtype.
F32_LEAVES = ("router", "router_bias")


def _put(tree: Params, path: str, leaf) -> None:
    """Set ``leaf`` at a dotted path; a numeric key indexes a list."""
    keys = path.split(".")
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


def init_params(cfg: KimiVlConfig, gen: torch.Generator) -> Params:
    """The whole tree drawn from ``gen`` on its device, leaf by leaf (each in
    f32, then cast to bf16): norm scales 1 ± 0.1, biases ± 0.02, the position table
    ± 0.02, the embedding table N(0, 1), linear weights N(0, 1/fan_in), the
    correction bias N(0, 0.02²). The router and its bias stay f32."""
    tree: Params = {}
    for path, shape, mean, std in _leaves(cfg):
        leaf = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
        leaf.mul_(std).add_(mean)
        _put(tree, path, leaf if path.split(".")[-1] in F32_LEAVES else leaf.to(torch.bfloat16))
    return tree


# ---------------------------------------------------------------------------
# Shared pieces
# ---------------------------------------------------------------------------


def _rmsnorm(x, w, eps: float):
    x32 = x.to(torch.float32)
    y = x32 * torch.rsqrt(x32.pow(2).mean(dim=-1, keepdim=True) + eps)
    return (y * w.to(torch.float32)).to(x.dtype)


def _swiglu(x, gate_up, down):
    a = x @ gate_up.to(x.dtype)
    g, u = a.chunk(2, dim=-1)
    return (F.silu(g) * u) @ down.to(x.dtype)


def rope_tables(positions, dim: int, theta: float):
    """cos and sin (N, dim) of the half-split rotation at ``positions``, f32."""
    inv = theta ** (-torch.arange(0, dim, 2, dtype=torch.float32, device=positions.device) / dim)
    ang = positions.to(torch.float32)[:, None] * inv[None]
    ang = torch.cat([ang, ang], dim=-1)
    return torch.cos(ang), torch.sin(ang)


def _rope(x, cos, sin):
    """Half-split rotation of x's last axis in f32, cast back: cos and sin
    broadcast against x."""
    x32 = x.to(torch.float32)
    half = x.shape[-1] // 2
    rot = torch.cat([-x32[..., half:], x32[..., :half]], dim=-1)
    return (x32 * cos + rot * sin).to(x.dtype)


def _stage_ready(t) -> None:
    """A stage span ends with its output on the device computed: while the
    profiler records (never otherwise), wait for ``t``'s device."""
    if t.is_cuda and torch.autograd._profiler_enabled():
        torch.cuda.synchronize(t.device)


# ---------------------------------------------------------------------------
# MoonViT and the projector
# ---------------------------------------------------------------------------


def vision_rope_tables(cfg: KimiVlConfig, device):
    """cos and sin (g², D/2) of MoonViT's 2D rotation, f32."""
    g, d = cfg.grid, cfg.vision_head_dim
    freqs = cfg.vision_rope_theta ** (
        -torch.arange(0, d, 4, dtype=torch.float32, device=device)[: d // 4] / d)
    idx = torch.arange(g * g, device=device)
    col, row = (idx % g).to(torch.float32), (idx // g).to(torch.float32)
    ang = torch.stack([col[:, None] * freqs[None], row[:, None] * freqs[None]], dim=-1)
    ang = ang.reshape(g * g, d // 2)
    return torch.cos(ang), torch.sin(ang)


def _rope_2d(x, cos, sin):
    """(B, N, H, D) rotated pairwise over adjacent elements, in f32, cast back."""
    shape = x.shape
    x32 = x.to(torch.float32).reshape(*shape[:-1], shape[-1] // 2, 2)
    a, b = x32[..., 0], x32[..., 1]
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    return torch.stack([a * c - b * s, a * s + b * c], dim=-1).reshape(shape).to(x.dtype)


def vision_positions(v: Params, cfg: KimiVlConfig):
    """The position table resized bicubically to the grid: (g², W) f32."""
    g = cfg.grid
    table = v["pos_emb"].to(torch.float32).permute(2, 0, 1)[None]
    if table.shape[-1] != g:
        table = F.interpolate(table, size=(g, g), mode="bicubic", align_corners=False)
    return table[0].permute(1, 2, 0).reshape(g * g, cfg.vision_width)


def _vision_attend(q, k, v):
    """MoonViT's attention, full within an image, at head width 72:
    ``F.scaled_dot_product_attention``. B3 takes D 72 only on its CUDA-core
    route, which took 89.4 ms at 64 × 1,024 × 16 × 72 against SDPA's 0.90
    on the H100 (PERF.md)."""
    o = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    return o.transpose(1, 2)


def _vision_block(x, blk, cfg: KimiVlConfig, cos, sin):
    b, n, w = x.shape
    heads, d = cfg.vision_heads, cfg.vision_head_dim
    qkv = clip._linear(clip._layernorm(x, blk["ln0"]), blk["qkv_w"], blk["qkv_b"])
    q, k, v = (t.reshape(b, n, heads, d) for t in qkv.split(w, dim=-1))
    q, k = _rope_2d(q, cos, sin), _rope_2d(k, cos, sin)
    o = _vision_attend(q, k, v.contiguous()).reshape(b, n, w)
    x = x + clip._linear(o, blk["out_w"], blk["out_b"])
    h = clip._linear(clip._layernorm(x, blk["ln1"]), blk["fc0_w"], blk["fc0_b"])
    return x + clip._linear(F.gelu(h, approximate="tanh"), blk["fc1_w"], blk["fc1_b"])


def merge_patches(x, cfg: KimiVlConfig):
    """(B, g², C) in row-major grid order -> (B, (g/m)², m²·C): each m×m
    block of neighbours concatenated in row-major order."""
    b, _, c = x.shape
    g, m = cfg.grid, cfg.merge
    x = x.reshape(b, g // m, m, g // m, m, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (g // m) ** 2, m * m * c)


def encode_images(params: Params, cfg: KimiVlConfig, images):
    """(B, S, S, 3) normalised pixels -> (B, image_tokens, hidden) image
    tokens in the tree's dtype: the tower, the merge and the projector."""
    v, pj = params["vision"], params["projector"]
    dtype = v["patch_w"].dtype
    b, p, g = images.shape[0], cfg.patch_size, cfg.grid
    x = images.to(dtype).reshape(b, g, p, g, p, 3).permute(0, 1, 3, 2, 4, 5)
    x = clip._linear(x.reshape(b, g * g, p * p * 3), v["patch_w"], v["patch_b"])
    x = x + vision_positions(v, cfg).to(dtype)[None]
    cos, sin = vision_rope_tables(cfg, images.device)
    for blk in v["blocks"]:
        x = _vision_block(x, blk, cfg, cos, sin)
    x = clip._layernorm(clip._layernorm(x, v["ln_post"]), pj["ln"])
    x = merge_patches(x, cfg)
    x = F.gelu(clip._linear(x, pj["fc1_w"], pj["fc1_b"]))
    return clip._linear(x, pj["fc2_w"], pj["fc2_b"])


# ---------------------------------------------------------------------------
# Routed experts
# ---------------------------------------------------------------------------


def route(h, moe: Params, cfg: KimiVlConfig):
    """The router, in f32: (T, k) expert ids, chosen by ``s + b``, and their
    weights ``s_i / Σ s`` (the chosen) times the routed scaling factor."""
    s = torch.sigmoid(h.to(torch.float32) @ moe["router"])
    idx = torch.topk(s + moe["router_bias"], cfg.experts_per_token, dim=-1).indices
    w = s.gather(1, idx)
    return idx, w / (w.sum(dim=-1, keepdim=True) + 1e-20) * cfg.routed_scale


def routed_experts(x, gate_up, down, idx, weights, experts: Optional[Sequence[int]] = None,
                   n_experts: Optional[int] = None, capacity: Optional[int] = None):
    """``Σ_i w_i E_i(x)`` over each token's picks of the experts held here.

    x (T, H); ``gate_up`` (E_h, H, 2I) and ``down`` (E_h, I, H) the SwiGLU
    weights of the experts held, whose global ids are ``experts`` (default
    all ``n_experts`` = E_h, in order); idx, weights (T, k) each token's picks
    (global ids, distinct in a row) and their weights. Picks of experts not
    held add nothing. Returns (T, H) f32.

    No Python loop runs over experts: each pick is ranked among its
    expert's picks (a running count over the tokens), pick (t, e) of rank r
    goes to row ``e·C + r`` of one (E_h, C, H) buffer, one ``torch.bmm`` a
    projection runs over every expert held, and each token sums its k rows
    back, weighted. C is ``capacity``, which no expert's load may pass: by
    default the largest load, read back from the device; a decode step
    passes its token count (a token picks an expert at most once), so that
    nothing is read back."""
    t, k = idx.shape
    held = gate_up.shape[0]
    total = n_experts if n_experts is not None else held
    dev = x.device
    if experts is None:
        local = torch.arange(total, device=dev)
    else:
        local = torch.full((total,), held, dtype=torch.long, device=dev)
        local[torch.as_tensor(list(experts), dtype=torch.long, device=dev)] = torch.arange(
            held, device=dev)
    key = local[idx].reshape(-1)  # held experts 0..E_h-1, the rest E_h
    w = torch.where(key < held, weights.reshape(-1).to(torch.float32),
                    torch.zeros((), device=dev))
    # An expert's row of picks, scanned along the row (a scan down the
    # other axis runs one thread a column, and took tens of ms a prefill).
    onehot = torch.zeros((held + 1, t * k), dtype=torch.int32, device=dev)
    onehot.scatter_(0, key[None], 1)
    counts = onehot.cumsum(1, dtype=torch.int32)
    rank = counts.gather(0, key[None])[0] - 1
    if capacity is None:
        capacity = int(counts[:held, -1].max()) if t else 0
    capacity = max(capacity, 1)
    held_pick = key < held
    slot = torch.where(held_pick, key * capacity + rank, held * capacity)
    hd = x.shape[1]
    buf = x.new_zeros((held * capacity + 1, hd))  # the last row takes the picks not held
    buf[slot] = x[:, None].expand(t, k, hd).reshape(t * k, hd)
    act = torch.bmm(buf[:-1].view(held, capacity, hd), gate_up.to(x.dtype))
    g, u = act.chunk(2, dim=-1)
    out = torch.bmm(F.silu(g) * u, down.to(x.dtype)).reshape(held * capacity, hd)
    rows = out[torch.where(held_pick, slot, 0)]  # a pick not held reads row 0 at weight 0
    return (rows.to(torch.float32) * w[:, None]).view(t, k, hd).sum(dim=1)


def _moe(h, moe: Params, cfg: KimiVlConfig, capacity: Optional[int] = None):
    """The expert layer over (T, H) rows: its output and the (T, k) experts
    each row picked; ``capacity`` as :func:`routed_experts` takes it."""
    idx, w = route(h, moe, cfg)
    y = routed_experts(h, moe["gate_up"], moe["down"], idx, w, n_experts=cfg.experts,
                       capacity=capacity)
    y = y + _swiglu(h, moe["shared_gate_up"], moe["shared_down"]).to(torch.float32)
    return y.to(h.dtype), idx


def _ffn(h, layer: Params, cfg: KimiVlConfig, routes, capacity: Optional[int] = None):
    """The layer's feed-forward over (T, H) rows; an expert layer appends
    its picks to ``routes`` (a list, or None)."""
    if "mlp" in layer:
        return _swiglu(h, layer["mlp"]["gate_up"], layer["mlp"]["down"])
    y, idx = _moe(h, layer["moe"], cfg, capacity)
    if routes is not None:
        routes.append(idx)
    return y


# ---------------------------------------------------------------------------
# The language model: prefill (expanded) and decode (absorbed)
# ---------------------------------------------------------------------------


def embed_prompt(lm: Params, cfg: KimiVlConfig, ids, image_tokens):
    """(B, N) ids -> (B, N, H): the embeddings, with the image tokens (B,
    n, H) in place of the placeholder positions (n a row)."""
    x = lm["embed"][ids]
    mask = (ids == cfg.media_id)[..., None]
    return x.masked_scatter(mask, image_tokens.to(x.dtype))


def _prefill_attention(h, layer: Params, cfg: KimiVlConfig, cache, cos, sin):
    """Expanded MLA over (B, N, H) rows, causal; writes the latent rows of
    positions 0..N-1 into ``cache`` (B, S, 576)."""
    b, n, _ = h.shape
    heads, nope, rope, vd = cfg.heads, cfg.qk_nope, cfg.qk_rope, cfg.v_head
    q = (h @ layer["q_w"].to(h.dtype)).view(b, n, heads, nope + rope)
    kva = h @ layer["kva_w"].to(h.dtype)
    c = _rmsnorm(kva[..., :cfg.kv_lora], layer["kv_norm"], cfg.rms_eps)
    k_pe = _rope(kva[..., cfg.kv_lora:], cos[None], sin[None])
    cache[:, :n, :cfg.kv_lora] = c
    cache[:, :n, cfg.kv_lora:] = k_pe
    kv = (c @ layer["kvb_w"].to(h.dtype)).view(b, n, heads, nope + vd)
    q = torch.cat([q[..., :nope], _rope(q[..., nope:], cos[None, :, None], sin[None, :, None])],
                  dim=-1)
    k = torch.cat([kv[..., :nope], k_pe[:, :, None].expand(b, n, heads, rope)], dim=-1)
    v = F.pad(kv[..., nope:], (0, nope + rope - vd))
    o = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                       is_causal=True, scale=(nope + rope) ** -0.5)
    o = o[..., :vd].transpose(1, 2).reshape(b, n, heads * vd)
    return o @ layer["o_w"].to(h.dtype)


def prefill(params: Params, cfg: KimiVlConfig, ids, image_tokens, caches, routes=None):
    """The prompt (B, N) through every layer, its latent rows written to
    ``caches`` (one (B, S, 576) a layer): the last position's logits (B, V).
    Each expert layer's (B·N, k) picks are appended to ``routes``."""
    lm = params["lm"]
    x = embed_prompt(lm, cfg, ids, image_tokens)
    b, n, hd = x.shape
    cos, sin = rope_tables(torch.arange(n, device=x.device), cfg.qk_rope, cfg.rope_theta)
    for layer, cache in zip(lm["layers"], caches):
        x = x + _prefill_attention(_rmsnorm(x, layer["attn_norm"], cfg.rms_eps), layer, cfg,
                                   cache, cos, sin)
        h = _rmsnorm(x, layer["ffn_norm"], cfg.rms_eps).reshape(b * n, hd)
        x = x + _ffn(h, layer, cfg, routes).reshape(b, n, hd)
    return _rmsnorm(x[:, -1], lm["norm"], cfg.rms_eps) @ lm["head"].to(x.dtype)


def absorbed(layer: Params, cfg: KimiVlConfig):
    """``W_UK`` (heads, 128, 512) and ``W_UV`` (heads, 512, 128), the per-head
    blocks of ``W_kvb`` that the decode step absorbs."""
    kvb = layer["kvb_w"].view(cfg.kv_lora, cfg.heads, cfg.qk_nope + cfg.v_head)
    w_uk = kvb[..., :cfg.qk_nope].permute(1, 2, 0).contiguous()
    w_uv = kvb[..., cfg.qk_nope:].permute(1, 0, 2).contiguous()
    return w_uk, w_uv


def _decode_attention(h, layer: Params, cfg: KimiVlConfig, cache, pos, valid, cos, sin, w_uk,
                      w_uv):
    """Absorbed MLA for one new token a row (B, H) at position ``pos`` (a
    (1,) tensor): writes its latent row, then attends over the whole cache
    with the positions past ``pos`` masked (``valid``), so that every step
    has the same shapes."""
    b = h.shape[0]
    heads, nope = cfg.heads, cfg.qk_nope
    q = (h @ layer["q_w"].to(h.dtype)).view(b, heads, nope + cfg.qk_rope)
    kva = h @ layer["kva_w"].to(h.dtype)
    row = torch.cat([_rmsnorm(kva[:, :cfg.kv_lora], layer["kv_norm"], cfg.rms_eps),
                     _rope(kva[:, cfg.kv_lora:], cos, sin)], dim=-1)
    cache.index_copy_(1, pos, row[:, None])
    q_lat = torch.bmm(q[..., :nope].transpose(0, 1), w_uk).transpose(0, 1)  # (B, heads, 512)
    qf = torch.cat([q_lat, _rope(q[..., nope:], cos, sin)], dim=-1)  # (B, heads, 576)
    scores = torch.bmm(qf, cache.transpose(1, 2)).to(torch.float32) * (cfg.qk_head ** -0.5)
    p = torch.softmax(scores.masked_fill(~valid, float("-inf")), dim=-1).to(h.dtype)
    o_lat = torch.bmm(p, cache)[..., :cfg.kv_lora]  # (B, heads, 512)
    o = torch.bmm(o_lat.transpose(0, 1), w_uv).transpose(0, 1).reshape(b, heads * cfg.v_head)
    return o @ layer["o_w"].to(h.dtype)


def decode_step(params: Params, cfg: KimiVlConfig, tokens, pos, caches, rope, absorb):
    """One token a row (B,) at position ``pos`` (a (1,) tensor) through every
    layer, reading and extending the latent caches (B, S, 576): the logits
    (B, V) and each expert layer's (B, k) picks, stacked. ``rope`` holds cos
    and sin of every position; ``absorb`` each layer's (W_UK, W_UV). No
    value reaches the host."""
    lm = params["lm"]
    x = lm["embed"][tokens]
    cos, sin = rope[0].index_select(0, pos), rope[1].index_select(0, pos)
    valid = torch.arange(caches[0].shape[1], device=tokens.device) <= pos
    routes: list = []
    for layer, cache, (w_uk, w_uv) in zip(lm["layers"], caches, absorb):
        x = x + _decode_attention(_rmsnorm(x, layer["attn_norm"], cfg.rms_eps), layer, cfg,
                                  cache, pos, valid, cos, sin, w_uk, w_uv)
        x = x + _ffn(_rmsnorm(x, layer["ffn_norm"], cfg.rms_eps), layer, cfg, routes,
                     capacity=x.shape[0])
    logits = _rmsnorm(x, lm["norm"], cfg.rms_eps) @ lm["head"].to(x.dtype)
    return logits, torch.stack(routes)


class _Decoder:
    """A batch shape's latent caches, one (B, length, 576) a layer, and
    :func:`decode_step` on fixed input buffers (the tokens and the position
    are copied in before each step). On the card the step is captured once
    as a CUDA graph and replayed: a step is some 1,700 small launches, and
    issued one by one from the host they took twice the device's time
    (PERF.md). A later batch of the same shape prefills into the same
    caches; the rows an earlier batch left past its prompt are each
    written before a step reads them."""

    def __init__(self, params: Params, cfg: KimiVlConfig, batch: int, length: int,
                 first_pos: int, capture: bool):
        lm = params["lm"]
        dev, dtype = lm["embed"].device, lm["embed"].dtype
        # Zeros: a decode step reads the rows not yet written, at probability 0.
        self.caches = [torch.zeros((batch, length, cfg.latent), dtype=dtype, device=dev)
                       for _ in range(cfg.layers)]
        self.tokens = torch.zeros(batch, dtype=torch.long, device=dev)
        self.pos = torch.full((1,), first_pos, dtype=torch.long, device=dev)
        rope = rope_tables(torch.arange(length, device=dev), cfg.qk_rope, cfg.rope_theta)
        absorb = [absorbed(layer, cfg) for layer in lm["layers"]]
        self.step = lambda: decode_step(params, cfg, self.tokens, self.pos, self.caches, rope,
                                        absorb)
        self.graph = None
        if capture and dev.type == "cuda":
            # A first run off the capture builds the library handles; it
            # writes the latent row of first_pos, which the first real step
            # writes again before it reads it.
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                self.step()
            torch.cuda.current_stream(dev).wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.out = self.step()

    def __call__(self, tokens, pos: int):
        self.tokens.copy_(tokens)
        self.pos.fill_(pos)
        if self.graph is None:
            return self.step()
        self.graph.replay()
        return self.out


def prompt_ids(cfg: KimiVlConfig, batch: int, prefix: Sequence[int], suffix: Sequence[int],
               device):
    """(B, N) prompt ids: ``prefix``, the image's placeholders, ``suffix``."""
    row = [*prefix, *([cfg.media_id] * cfg.image_tokens), *suffix]
    return torch.tensor(row, dtype=torch.long, device=device).expand(batch, len(row))


@torch.inference_mode()
def generate(params: Params, cfg: KimiVlConfig, images, prefix: Sequence[int] = (),
             suffix: Sequence[int] = (), max_new: int = 64, keep: Sequence[int] = (),
             decoders: Optional[dict] = None):
    """Greedy captions of (B, S, S, 3) normalised pixels.

    Returns a dict of host tensors: ``tokens`` (B, max_new) (EOS after a
    row's end), ``lengths`` (B,) tokens before the EOS, ``logprob`` (B,)
    mean log-probability of those tokens, ``positions`` how many positions
    were computed (max_new, or fewer where every row stopped early); for the
    rows ``keep``, also ``logits`` (len(keep), max_new, V) as computed at
    each generated position (prefill's last, then each decode step's; the
    first ``positions`` are set), ``image_tokens`` (len(keep), n, H) and
    ``routes`` (len(keep), expert layers, N + positions − 1, k), the experts
    each of their tokens picked in each expert layer, prompt then generated
    tokens.

    The prefill writes and the decode steps read the caches of a
    :class:`_Decoder` (a CUDA graph on the card), taken from ``decoders``
    (a dict the caller keeps, by batch and cache length) or made, and
    captured, before the first stage's span opens. The decode reads back
    only every :data:`DONE_CHECK_STEPS` steps whether every row has
    stopped."""
    dev = images.device
    b = images.shape[0]
    keep_idx = torch.as_tensor(list(keep), dtype=torch.long, device=dev)
    ids = prompt_ids(cfg, b, prefix, suffix, dev)
    n = ids.shape[1]
    shape = (b, n + max_new)
    decoder = decoders.get(shape) if decoders is not None else None
    if decoder is None:
        decoder = _Decoder(params, cfg, b, n + max_new, n, capture=max_new > 1)
        if decoders is not None:
            decoders[shape] = decoder
    caches = decoder.caches
    with tracing.span("kimi_vl.vision"):
        img = encode_images(params, cfg, images)
        _stage_ready(img)
    tracing.count("kimi_vl.cache_bytes", sum(c.nbytes for c in caches))
    routes = [] if len(keep) else None
    with tracing.span("kimi_vl.prefill"):
        logits = prefill(params, cfg, ids, img, caches, routes)
        _stage_ready(logits)
    tracing.count("kimi_vl.prefill_tokens", b * n)
    kept_logits = (torch.empty((len(keep), max_new, cfg.vocab), dtype=logits.dtype, device=dev)
                   if len(keep) else None)
    kept_routes = [] if len(keep) else None
    steps = 0
    with tracing.span("kimi_vl.decode"):
        tokens = torch.full((b, max_new), cfg.eos_id, dtype=torch.long, device=dev)
        done = torch.zeros(b, dtype=torch.bool, device=dev)
        logprob = torch.zeros(b, dtype=torch.float32, device=dev)
        length = torch.zeros(b, dtype=torch.long, device=dev)
        for s in range(max_new):
            if s:
                logits, picks = decoder(tok, n + s - 1)
                steps += 1
                if kept_routes is not None:
                    kept_routes.append(picks[:, keep_idx])
            if kept_logits is not None:
                kept_logits[:, s] = logits[keep_idx]
            tok = torch.argmax(logits, dim=-1)
            live = ~done & (tok != cfg.eos_id)
            lp = torch.log_softmax(logits.to(torch.float32), dim=-1).gather(1, tok[:, None])[:, 0]
            logprob += torch.where(live, lp, torch.zeros_like(lp))
            length += live.to(torch.long)
            tok = torch.where(done, torch.full_like(tok, cfg.eos_id), tok)
            tokens[:, s] = tok
            done |= tok == cfg.eos_id
            if (s + 1) % DONE_CHECK_STEPS == 0 and s + 1 < max_new and bool(done.all()):
                break
        out = {"tokens": tokens.cpu(), "lengths": length.cpu(),
               "logprob": (logprob / length.clamp(min=1).to(torch.float32)).cpu(),
               "positions": steps + 1}
    tracing.count("kimi_vl.decode_steps", steps)
    if len(keep):
        out["logits"] = kept_logits.cpu()
        out["image_tokens"] = img[keep_idx].cpu()
        # (layers, B·N, k) from the prefill, then (layers, kept, k) a step.
        prompt = torch.stack(routes).view(len(routes), b, n, -1)[:, keep_idx]
        out["routes"] = torch.cat([prompt, *(r[:, :, None] for r in kept_routes)],
                                  dim=2).transpose(0, 1).cpu()
    return out
