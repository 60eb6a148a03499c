"""Operation and byte counts of a captioning batch through Kimi-VL-A3B: the
MoonViT tower and projector, the prompt's prefill and each decode step
through the latent cache, with the roofline bounds the per-layer metrics
read. Made from the configuration file and the traffic alone, never from
the program, with ``roofline.py``'s peaks (one H100 SXM at 700 W: 989
TFLOP/s bf16, 3.35 TB/s). Two operations a multiply-add; norms,
activations, softmax, rotations and the routing's bookkeeping are left out
(under 1 % of each stage).
"""

from __future__ import annotations

from benchmark.roofline import HBM_BYTES_PER_S, PEAK_OPS_PER_S


def vision_ops(config: dict) -> float:
    """One image through MoonViT and the projector: the patch matmul; each
    block's qkv (3W²), out (W²) and MLP (2·W·M) a token and attention
    (4·N²·W); the projector's two linears over the merged tokens."""
    v = config["vision_cfg"]
    w, m, p = v["width"], v["mlp_width"], v["patch_size"]
    n = (v["image_size"] // p) ** 2
    merged, wide = n // v["merge"] ** 2, v["merge"] ** 2 * w
    block = 2.0 * n * (4 * w * w + 2 * w * m) + 4.0 * n * n * w
    projector = 2.0 * merged * wide * (wide + config["hidden_size"])
    return 2.0 * n * p * p * 3 * w + v["layers"] * block + projector


def image_tokens(config: dict) -> int:
    v = config["vision_cfg"]
    return (v["image_size"] // v["patch_size"] // v["merge"]) ** 2


def prompt_length(config: dict, traffic: dict) -> int:
    return traffic["prefix_ids"] + image_tokens(config) + traffic["suffix_ids"]


def _projection_ops(config: dict) -> float:
    """A token's MLA projections: W_q, W_kva, W_kvb, W_o."""
    h, heads = config["hidden_size"], config["num_attention_heads"]
    nope, rope, vd = config["qk_nope_head_dim"], config["qk_rope_head_dim"], config["v_head_dim"]
    lora = config["kv_lora_rank"]
    return 2.0 * (h * heads * (nope + rope) + h * (lora + rope) + lora * heads * (nope + vd)
                  + heads * vd * h)


def ffn_ops(config: dict) -> float:
    """A token's feed-forward summed over the layers: the leading dense
    SwiGLUs (6·H·D), then in each expert layer the router (2·H·E), the k
    routed experts and the shared ones (6·H·I each)."""
    h = config["hidden_size"]
    dense = config["first_k_dense_replace"]
    moe = config["num_hidden_layers"] - dense
    i, k = config["moe_intermediate_size"], config["num_experts_per_tok"]
    e = config["n_routed_experts"]
    per_moe = 2.0 * h * e + 6.0 * h * i * (k + config["n_shared_experts"])
    return dense * 6.0 * h * config["intermediate_size"] + moe * per_moe


def prefill_ops(config: dict, traffic: dict) -> float:
    """A batch's prompts through the language model, expanded attention
    (q·k at qk_nope + qk_rope, p·v at v_head, causal: (N + 1)/2 keys a
    query on average), and the head at each row's last position."""
    b, n = traffic["images_per_batch"], prompt_length(config, traffic)
    heads = config["num_attention_heads"]
    qk = config["qk_nope_head_dim"] + config["qk_rope_head_dim"]
    attention = 2.0 * heads * (qk + config["v_head_dim"]) * (n + 1) / 2
    per_token = config["num_hidden_layers"] * (_projection_ops(config) + attention)
    head = 2.0 * b * config["hidden_size"] * config["vocab_size"]
    return b * n * (per_token + ffn_ops(config)) + head


def decode_step_ops(config: dict, traffic: dict, context: int) -> float:
    """One decode step of the batch over a cache of ``context`` positions,
    absorbed form: q_nope·W_UKᵀ and o_lat·W_UV (2·heads·128·512 each),
    scores over [c_kv, k_pe] (576 a position) and p·c_kv (512), the
    projections, the feed-forward and the head."""
    heads, lora = config["num_attention_heads"], config["kv_lora_rank"]
    nope, vd = config["qk_nope_head_dim"], config["v_head_dim"]
    latent = lora + config["qk_rope_head_dim"]
    attention = 2.0 * heads * (nope * lora + vd * lora + context * (latent + lora))
    per_token = (config["num_hidden_layers"] * (_projection_ops(config) + attention)
                 + ffn_ops(config) + 2.0 * config["hidden_size"] * config["vocab_size"])
    return traffic["images_per_batch"] * per_token


def lm_weight_bytes(config: dict) -> float:
    """Every weight of the language model but the embedding table, bf16 (the
    router and its bias f32), read once."""
    h, heads = config["hidden_size"], config["num_attention_heads"]
    layers = config["num_hidden_layers"]
    nope, rope, vd = config["qk_nope_head_dim"], config["qk_rope_head_dim"], config["v_head_dim"]
    lora = config["kv_lora_rank"]
    attention = (h * heads * (nope + rope) + h * (lora + rope) + lora + lora * heads * (nope + vd)
                 + heads * vd * h + 2 * h)
    dense = config["first_k_dense_replace"]
    i, e = config["moe_intermediate_size"], config["n_routed_experts"]
    s = config["n_shared_experts"]
    moe = 3 * h * i * (e + s)
    bf16 = layers * attention + dense * 3 * h * config["intermediate_size"] + (layers - dense) * moe
    bf16 += h + h * config["vocab_size"]  # the final norm and the head
    return 2.0 * bf16 + 4.0 * (layers - dense) * (h * e + e)


def cache_bytes_read(config: dict, traffic: dict, context: int) -> float:
    """The latent caches read once at ``context`` positions: 576 bf16 values
    a position a layer a row."""
    latent = config["kv_lora_rank"] + config["qk_rope_head_dim"]
    return 2.0 * config["num_hidden_layers"] * traffic["images_per_batch"] * context * latent


def decode_step_bound(config: dict, traffic: dict, context: int) -> float:
    """Seconds: the step's weights and caches at 3.35 TB/s, or its
    operations at 989 TFLOP/s, whichever is longer."""
    moved = lm_weight_bytes(config) + cache_bytes_read(config, traffic, context)
    return max(moved / HBM_BYTES_PER_S,
               decode_step_ops(config, traffic, context) / PEAK_OPS_PER_S["bf16"])


def decode_bound(config: dict, traffic: dict, steps: int) -> float:
    """Seconds of a batch's first ``steps`` decode steps at their bounds:
    step s (1, 2, …) reads a cache of prompt + s positions."""
    n = prompt_length(config, traffic)
    return sum(decode_step_bound(config, traffic, n + s) for s in range(1, steps + 1))
