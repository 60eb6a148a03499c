"""Plain Kimi-VL-A3B in f32: the reference of the captioning cell.

The MoonViT tower, the patch merger, the projector and the language model's
full forward pass over whole token sequences, in plain PyTorch with TF32
off and nothing of the program: attention expanded (no cache), every expert
applied to its own tokens in a plain loop. It reads the configuration file
(the language model's keys at its top level, as the model's ``config.json``
names them; ``vision_cfg``; ``assumed``) and takes a bf16 parameter tree in
the program's layout, the one the benchmark draws from the seed
(``kinds/caption_build.kimi_params``), each weight upcast to f32 where it
is used, so that on the card it fits in the memory the tree takes.

The equations are those of ``panoptikon_tpu_torch/models/kimi_vl.py``'s
docstring: MoonViT (patch matmul in (row, column, channel) order, the
bicubic-resized position table, pre-LayerNorm blocks with 2D RoPE on
adjacent pairs, column then row, tanh GELU, a final LayerNorm), the
projector (LayerNorm a token, 2×2 row-major merge, erf GELU), and the
DeepSeek-V3 language model (RMSNorm, MLA with half-split RoPE on the 64
rotary dims, one leading SwiGLU layer, then sigmoid routing by ``s + b``
over the experts with normalised top-k weights times the scaling factor,
plus the shared SwiGLU), the final RMSNorm and the head. Routing is a
discrete choice: where two experts' biased scores all but tie, the
program's bf16 router and this f32 one may pick apart, and the token's
output then differs by far more than rounding. So :func:`forward` reports
its own choices and can apply the program's instead, and a check compares
the choices and the logits apart.

:func:`balance_routers` sets each expert layer's router and correction
bias as a trained router holds them (seeded weights route nearly every
token to a few experts), from the residual stream of a calibration batch.

``linear_fp8=True`` is the control: every linear the configuration runs in
bf16 on operands rounded to float8 e4m3 with a per-tensor absmax scale
(absmax / 448), the rest in f32. The router, which runs in f32, is left
as it is.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.references.exact_topk import no_tf32

FP8_MAX = 448.0


def _fp8(x):
    s = torch.clamp(x.abs().amax() / FP8_MAX, min=1e-30)
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def _linear(x, w, b=None, fp8=False):
    w = w.to(torch.float32)
    if fp8:
        x, w = _fp8(x), _fp8(w)
    y = x @ w
    return y if b is None else y + b.to(torch.float32)


def _layernorm(x, p, eps):
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    return (x - mean) / torch.sqrt(var + eps) * p["scale"].float() + p["bias"].float()


def _rmsnorm(x, w, eps):
    return x / torch.sqrt(x.pow(2).mean(dim=-1, keepdim=True) + eps) * w.float()


def _swiglu(x, gate_up, down, fp8):
    g, u = _linear(x, gate_up, fp8=fp8).chunk(2, dim=-1)
    return _linear(F.silu(g) * u, down, fp8=fp8)


def _vision(params, config, images, fp8):
    v, pj = params["vision"], params["projector"]
    vc, eps = config["vision_cfg"], config["assumed"]["ln_eps"]
    p, size, w, heads = vc["patch_size"], vc["image_size"], vc["width"], vc["heads"]
    g, d = size // p, vc["width"] // vc["heads"]
    b = images.shape[0]
    x = images.float().reshape(b, g, p, g, p, 3).permute(0, 1, 3, 2, 4, 5).reshape(b, g * g, -1)
    x = _linear(x, v["patch_w"], v["patch_b"], fp8)
    table = v["pos_emb"].float().permute(2, 0, 1)[None]
    if table.shape[-1] != g:
        table = F.interpolate(table, size=(g, g), mode="bicubic", align_corners=False)
    x = x + table[0].permute(1, 2, 0).reshape(g * g, w)
    freqs = vc["rope_theta"] ** (-torch.arange(0, d, 4, dtype=torch.float32,
                                               device=x.device)[: d // 4] / d)
    n = torch.arange(g * g, device=x.device)
    col, row = (n % g).float(), (n // g).float()
    ang = torch.stack([col[:, None] * freqs, row[:, None] * freqs], dim=-1).reshape(g * g, d // 2)
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]

    def rope(t):  # (B, N, H, D): pair j is elements 2j, 2j + 1
        a, c = t[..., 0::2], t[..., 1::2]
        return torch.stack([a * cos - c * sin, a * sin + c * cos], dim=-1).reshape(t.shape)

    for blk in v["blocks"]:
        qkv = _linear(_layernorm(x, blk["ln0"], eps), blk["qkv_w"], blk["qkv_b"], fp8)
        q, k, vv = (t.reshape(b, g * g, heads, d) for t in qkv.split(w, dim=-1))
        q, k = rope(q).transpose(1, 2), rope(k).transpose(1, 2)
        att = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(d), dim=-1)
        o = (att @ vv.transpose(1, 2)).transpose(1, 2).reshape(b, g * g, w)
        x = x + _linear(o, blk["out_w"], blk["out_b"], fp8)
        h = _linear(_layernorm(x, blk["ln1"], eps), blk["fc0_w"], blk["fc0_b"], fp8)
        x = x + _linear(F.gelu(h, approximate="tanh"), blk["fc1_w"], blk["fc1_b"], fp8)
    x = _layernorm(_layernorm(x, v["ln_post"], eps), pj["ln"], eps)
    m = vc["merge"]
    x = x.reshape(b, g // m, m, g // m, m, w).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(b, (g // m) ** 2, m * m * w)
    x = F.gelu(_linear(x, pj["fc1_w"], pj["fc1_b"], fp8))
    return _linear(x, pj["fc2_w"], pj["fc2_b"], fp8)


def _rope_half(x, pos, theta):
    """Half-split rotation of x's last axis at positions ``pos`` (x's axis 1)."""
    dim = x.shape[-1]
    inv = theta ** (-torch.arange(0, dim, 2, dtype=torch.float32, device=x.device) / dim)
    ang = pos.float()[:, None] * inv
    ang = torch.cat([ang, ang], dim=-1)
    shape = [1, len(pos)] + [1] * (x.dim() - 3) + [dim]
    cos, sin = torch.cos(ang).reshape(shape), torch.sin(ang).reshape(shape)
    half = dim // 2
    return x * cos + torch.cat([-x[..., half:], x[..., :half]], dim=-1) * sin


def _attention(h, layer, t, pos, fp8):
    b, n, _ = h.shape
    heads, nope, rope = t["num_attention_heads"], t["qk_nope_head_dim"], t["qk_rope_head_dim"]
    vd, lora = t["v_head_dim"], t["kv_lora_rank"]
    q = _linear(h, layer["q_w"], fp8=fp8).reshape(b, n, heads, nope + rope)
    kva = _linear(h, layer["kva_w"], fp8=fp8)
    c = _rmsnorm(kva[..., :lora], layer["kv_norm"], t["rms_norm_eps"])
    k_pe = _rope_half(kva[..., lora:], pos, t["rope_theta"])
    kv = _linear(c, layer["kvb_w"], fp8=fp8).reshape(b, n, heads, nope + vd)
    q = torch.cat([q[..., :nope], _rope_half(q[..., nope:], pos, t["rope_theta"])], dim=-1)
    k = torch.cat([kv[..., :nope], k_pe[:, :, None].expand(b, n, heads, rope)], dim=-1)
    logits = (q.transpose(1, 2) @ k.permute(0, 2, 3, 1)) / math.sqrt(nope + rope)
    causal = torch.ones(n, n, dtype=torch.bool, device=h.device).tril()
    att = torch.softmax(logits.masked_fill(~causal, float("-inf")), dim=-1)
    o = (att @ kv[..., nope:].transpose(1, 2)).transpose(1, 2).reshape(b, n, heads * vd)
    return _linear(o, layer["o_w"], fp8=fp8)


def _moe(h, moe, t, fp8, routes=None):
    """The expert layer over (T, H) rows: the router in f32, then each expert
    on its own tokens, one at a time. Its own (T, k) choice is returned;
    ``routes`` (T, k), where given, are the experts applied in its place
    (their weights are still this router's scores)."""
    s = torch.sigmoid(h @ moe["router"].float())
    own = torch.topk(s + moe["router_bias"].float(), t["num_experts_per_tok"], dim=-1).indices
    idx = own if routes is None else routes
    w = s.gather(1, idx)
    w = w / (w.sum(dim=-1, keepdim=True) + 1e-20) * t["routed_scaling_factor"]
    y = _swiglu(h, moe["shared_gate_up"], moe["shared_down"], fp8)
    for e in range(t["n_routed_experts"]):
        rows, which = torch.nonzero(idx == e, as_tuple=True)
        if rows.numel():
            out = _swiglu(h[rows], moe["gate_up"][e], moe["down"][e], fp8)
            y = y.index_add(0, rows, out * w[rows, which][:, None])
    return y, own


def _balance(h, moe, k, steps, rate):
    """The layer's router from its (T, H) input rows: the direction the rows
    share taken out of W_g and W_g scaled so that the logits spread by 1
    over the rows; then ``steps`` moves of the correction bias, each
    ``rate`` against the sign of each expert's load above the mean, as
    DeepSeek-V3's auxiliary-loss-free balancing moves it while training.
    The bias kept is the one whose largest load was the least."""
    mean = h.mean(dim=0)
    mean = mean / mean.norm().clamp(min=1e-30)
    w = moe["router"].float()
    w = w - mean[:, None] * (mean @ w)[None]
    w = w / (h @ w).std().clamp(min=1e-30)
    s = torch.sigmoid(h @ w)
    bias = moe["router_bias"].float().clone()
    best, least = bias.clone(), torch.tensor(float("inf"), device=h.device)
    ones = torch.ones(h.shape[0] * k, device=h.device)
    for _ in range(steps):
        idx = torch.topk(s + bias, k, dim=-1).indices.reshape(-1)
        load = torch.zeros(s.shape[1], device=h.device).scatter_add_(0, idx, ones)
        best = torch.where(load.max() < least, bias, best)
        least = torch.minimum(load.max(), least)
        bias += rate * torch.sign(load.mean() - load)
    moe["router"], moe["router_bias"] = w, best


def balance_routers(params: dict, config: dict, images: torch.Tensor, ids: torch.Tensor, *,
                    prompt_len: int, steps: int = 300, rate: float = 1e-3) -> None:
    """Sets every expert layer's ``router`` and ``router_bias`` in
    ``params`` (f32) from :func:`forward` over a calibration batch, layer by
    layer (each balanced before the next one's input is computed): see
    :func:`_balance`. The drawn router sees a residual stream whose tokens
    share one direction, so that one expert takes nearly every token; a
    trained one spreads them."""
    forward(params, config, images, ids, prompt_len=prompt_len, logits_from=ids.shape[1] - 1,
            balance=(steps, rate))


@torch.inference_mode()
def forward(params: dict, config: dict, images: torch.Tensor, ids: torch.Tensor, *,
            prompt_len: int, logits_from: int = 0, linear_fp8: bool = False, routes=None,
            balance=None):
    """(B, S, S, 3) normalised pixels and (B, N) prompt-and-answer ids ->
    ((B, n, H) projected image tokens, (B, N − logits_from, V) logits,
    (B, expert layers, N, k) the experts its router chose), f32. The image
    tokens replace the placeholder positions (the assumed ``media_id``) of
    the first ``prompt_len`` ids, the prompt; a generated id equal to the
    placeholder is embedded as any other. ``routes`` (B, expert layers, N, k), where given, are the
    experts applied at each token in place of its router's choice: the
    program's own, so that a near-tie the two routers break apart does not
    show as a gap in the logits. ``balance`` ((steps, rate)), where given,
    first sets each expert layer's router from its input rows
    (:func:`balance_routers`)."""
    t = config
    eps = t["rms_norm_eps"]
    with no_tf32():
        img = _vision(params, config, images, linear_fp8)
        lm = params["lm"]
        x = lm["embed"][ids].float()
        mask = (ids == config["assumed"]["media_id"])
        mask[:, prompt_len:] = False
        mask = mask[..., None]
        x = x.masked_scatter(mask, img)
        b, n, hd = x.shape
        pos = torch.arange(n, device=x.device)
        chosen = []
        for layer in lm["layers"]:
            x = x + _attention(_rmsnorm(x, layer["attn_norm"], eps), layer, t, pos, linear_fp8)
            h = _rmsnorm(x, layer["ffn_norm"], eps).reshape(b * n, hd)
            if "mlp" in layer:
                f = _swiglu(h, layer["mlp"]["gate_up"], layer["mlp"]["down"], linear_fp8)
            else:
                if balance is not None:
                    _balance(h, layer["moe"], t["num_experts_per_tok"], *balance)
                use = None if routes is None else routes[:, len(chosen)].reshape(b * n, -1)
                f, own = _moe(h, layer["moe"], t, linear_fp8, use)
                chosen.append(own.reshape(b, n, -1))
            x = x + f.reshape(b, n, hd)
        x = _rmsnorm(x[:, logits_from:], lm["norm"], eps)
        return img, _linear(x, lm["head"], fp8=linear_fp8), torch.stack(chosen, dim=1)
