"""Kimi-VL-A3B on the port (``models/kimi_vl.py``, ``KimiVlImpl``) against the
plain f32 reference ``benchmark/references/kimi_vl.py`` at the seeded
``test-tiny`` size: the tower and projector, prefill, prefill then decoding
through the latent cache against the reference's full forward over the same
tokens, the routed experts' padded batched form against a loop, the router,
the impl and its registry id."""

import numpy as np
import pytest
import torch

from benchmark.references import kimi_vl as ref
from panoptikon_tpu_torch import tracing
from panoptikon_tpu_torch.models import impls, kimi_vl
from panoptikon_tpu_torch.models.base import PredictionInput

CFG = kimi_vl.CONFIGS["test-tiny"]
PREFIX, SUFFIX = (3, 4, 5), (6, 7)


def ref_config(cfg):
    """The configuration file's form of ``cfg``, as the reference reads it."""
    return {
        "hidden_size": cfg.hidden, "num_hidden_layers": cfg.layers,
        "num_attention_heads": cfg.heads, "qk_nope_head_dim": cfg.qk_nope,
        "qk_rope_head_dim": cfg.qk_rope, "v_head_dim": cfg.v_head, "kv_lora_rank": cfg.kv_lora,
        "intermediate_size": cfg.dense_width, "moe_intermediate_size": cfg.expert_width,
        "n_routed_experts": cfg.experts, "num_experts_per_tok": cfg.experts_per_token,
        "n_shared_experts": cfg.shared_experts, "routed_scaling_factor": cfg.routed_scale,
        "first_k_dense_replace": cfg.first_dense, "vocab_size": cfg.vocab,
        "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.rms_eps,
        "vision_cfg": {"image_size": cfg.image_size, "patch_size": cfg.patch_size,
                       "width": cfg.vision_width, "layers": cfg.vision_layers,
                       "heads": cfg.vision_heads, "mlp_width": cfg.vision_mlp, "merge": cfg.merge,
                       "pos_table": cfg.pos_table, "rope_theta": cfg.vision_rope_theta},
        "assumed": {"ln_eps": 1e-5, "media_id": cfg.media_id, "eos_id": cfg.eos_id},
    }


REF_CFG = ref_config(CFG)


def cast_params(tree, dtype):
    """The tree with every leaf but the router's cast to ``dtype``."""
    if isinstance(tree, dict):
        return {k: (v if k in kimi_vl.F32_LEAVES else cast_params(v, dtype))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [cast_params(v, dtype) for v in tree]
    return tree.to(dtype)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The test size's ops are far smaller than a thread pool's start-up:
    one thread runs this file in a few seconds, many in tens."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def params():
    return kimi_vl.init_params(CFG, torch.Generator().manual_seed(23))


@pytest.fixture(scope="module")
def images():
    gen = torch.Generator().manual_seed(5)
    return torch.randn((3, CFG.image_size, CFG.image_size, 3), generator=gen)


def _gap(got, want):
    """The largest |got − want| over the reference's standard deviation."""
    want = want.to(torch.float32)
    return float((got.to(torch.float32) - want).abs().max() / want.std())


def _teacher_forced(params, images, out, max_new, replay=False):
    """The reference's logits at each generated position over the prompt and
    the tokens the program generated (with ``replay``, applying the
    program's expert picks), and its own picks at every token."""
    ids = kimi_vl.prompt_ids(CFG, images.shape[0], PREFIX, SUFFIX, images.device)
    n = ids.shape[1]
    full = torch.cat([ids, out["tokens"][:, : max_new - 1]], dim=1)
    _, logits, own = ref.forward(params, REF_CFG, images, full, prompt_len=n,
                                 logits_from=n - 1, routes=out["routes"] if replay else None)
    return logits, own


@pytest.mark.parametrize("dtype,limit", [
    # f32 on both sides: the two compute the same equations in another order
    # (the reference's plain loops and expanded attention), so they differ
    # by f32 rounding carried through 2 + 3 layers, under 1e-5 of a spread.
    (torch.float32, 1e-4),
    # bf16 weights and activations with f32 accumulation: bf16 keeps 8 bits
    # (a relative step of 2^-8); carried through the tower, the projector and
    # three layers the largest gap stays under a tenth of a spread.
    (torch.bfloat16, 0.1),
])
def test_tower_and_projector(params, images, dtype, limit):
    got = kimi_vl.encode_images(cast_params(params, dtype), CFG, images)
    ids = kimi_vl.prompt_ids(CFG, 3, PREFIX, SUFFIX, "cpu")
    want, _, _ = ref.forward(params, REF_CFG, images, ids, prompt_len=ids.shape[1])
    assert got.shape == (3, CFG.image_tokens, CFG.hidden) and got.dtype == dtype
    assert _gap(got, want) < limit


def test_prefill_logits_are_the_full_forward(params, images):
    p32 = cast_params(params, torch.float32)
    out = kimi_vl.generate(p32, CFG, images, PREFIX, SUFFIX, max_new=1, keep=(0, 1, 2))
    want, own = _teacher_forced(params, images, out, 1)
    assert out["logits"].shape == (3, 1, CFG.vocab)
    assert _gap(out["logits"], want) < 1e-4
    assert torch.equal(out["routes"].sort(-1).values, own.sort(-1).values)


def _position_gaps(got, want):
    """Each generated position's largest |got − want|, over the standard
    deviation of the reference's logits there: (B, T)."""
    return (got.to(torch.float32) - want).abs().amax(dim=-1) / want.std(dim=-1)


def test_cached_decode_is_the_full_forward_f32(params, images):
    """Prefill, then 6 decode steps through the latent cache: each
    generated position's logits against the reference's full forward over
    the prompt and the generated tokens. f32 on both sides: rounding alone
    (see test_tower_and_projector); the absorbed decode reorders the
    products q·k and p·v through W_UK and W_UV. The two routers pick alike
    at every token."""
    out = kimi_vl.generate(cast_params(params, torch.float32), CFG, images, PREFIX,
                           SUFFIX, max_new=7, keep=(0, 1, 2))
    want, own = _teacher_forced(params, images, out, 7)
    assert out["logits"].shape == (3, 7, CFG.vocab)
    assert out["routes"].shape == (3, CFG.layers - CFG.first_dense, own.shape[2], 2)
    assert torch.equal(out["routes"].sort(-1).values, own.sort(-1).values)
    assert float(_position_gaps(out["logits"], want).max()) < 1e-4


def test_cached_decode_is_the_full_forward_bf16(params, images):
    """The same in bf16, the reference applying the program's expert picks
    (a pick is a discrete choice: where two experts' biased scores all but
    tie, bf16 rounding may choose the other one, and that token's logits
    then move by up to 2 spreads at this size). Two tolerances:

    - the logits: bf16 keeps 8 bits (a relative step of 2^-8); through the
      tower, the projector and three layers the largest gap was 0.04–0.07
      of a spread over 10 seeds; held under 0.15;
    - the picks: the share of (token, expert layer) pairs the two routers
      pick apart was 0–4 % over those seeds; held at 10 %."""
    out = kimi_vl.generate(cast_params(params, torch.bfloat16), CFG, images, PREFIX,
                           SUFFIX, max_new=7, keep=(0, 1, 2))
    want, own = _teacher_forced(params, images, out, 7, replay=True)
    assert float(_position_gaps(out["logits"], want).max()) < 0.15
    apart = (out["routes"].sort(-1).values != own.sort(-1).values).any(-1)
    assert float(apart.to(torch.float32).mean()) <= 0.1


def test_a_generated_placeholder_id_is_a_token(params, images):
    """An answer may hold the placeholder id: the program embeds it as a
    token, and so does the reference, whose image tokens fill the prompt's
    placeholders alone."""
    ids = kimi_vl.prompt_ids(CFG, 3, PREFIX, SUFFIX, "cpu")
    n = ids.shape[1]
    answer = torch.tensor([[CFG.media_id, 9]] * 3)
    full = torch.cat([ids, answer], dim=1)
    _, logits, _ = ref.forward(params, REF_CFG, images, full, prompt_len=n, logits_from=n - 1)
    _, alone, _ = ref.forward(params, REF_CFG, images, ids, prompt_len=n, logits_from=n - 1)
    assert logits.shape == (3, 3, CFG.vocab) and torch.isfinite(logits).all()
    torch.testing.assert_close(logits[:, 0], alone[:, 0])  # causal: the prompt's last position


def test_the_latent_cache_holds_576_values_a_token_a_layer(params, images):
    """The cache is (B, prompt + max_new, kv_lora + qk_rope) a layer: the
    counter reads its bytes, and the decode steps and prefill tokens."""
    from torch.profiler import ProfilerActivity, profile

    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        out = kimi_vl.generate(params, CFG, images, PREFIX, SUFFIX, max_new=5)
    n = len(PREFIX) + CFG.image_tokens + len(SUFFIX)
    c = tracing.counters()
    assert CFG.latent == CFG.kv_lora + CFG.qk_rope == 40
    assert c["kimi_vl.cache_bytes"] == CFG.layers * 3 * (n + 5) * CFG.latent * 2
    assert c["kimi_vl.prefill_tokens"] == 3 * n and c["kimi_vl.decode_steps"] == 4
    assert {"kimi_vl.vision", "kimi_vl.prefill", "kimi_vl.decode"} <= set(tracing.totals())
    assert out["tokens"].shape == (3, 5)
    tracing.reset()
    kimi_vl.generate(params, CFG, images, PREFIX, SUFFIX, max_new=2)
    assert tracing.counters() == {} and tracing.totals() == {}


def test_a_kept_decoder_serves_the_next_batch_alike(params, images):
    """A batch shape's caches and decode step, kept in ``decoders``, serve
    the next batch of that shape as a fresh one would: the rows the first
    batch left in the caches are written again before a step reads them."""
    decoders: dict = {}
    kimi_vl.generate(params, CFG, images.flip(0), PREFIX, SUFFIX, max_new=5, keep=(0,),
                     decoders=decoders)
    assert len(decoders) == 1
    kept = kimi_vl.generate(params, CFG, images, PREFIX, SUFFIX, max_new=5, keep=(0, 1),
                            decoders=decoders)
    fresh = kimi_vl.generate(params, CFG, images, PREFIX, SUFFIX, max_new=5, keep=(0, 1))
    assert len(decoders) == 1
    for key in ("tokens", "logits", "routes"):
        assert torch.equal(kept[key], fresh[key]), key


def _loop_experts(x, gate_up, down, idx, w, experts):
    """Each expert held applied to its own tokens, one at a time."""
    y = torch.zeros(x.shape, dtype=torch.float32)
    for local, e in enumerate(experts):
        rows, which = torch.nonzero(idx == e, as_tuple=True)
        if rows.numel():
            g, u = (x[rows] @ gate_up[local]).chunk(2, dim=-1)
            y.index_add_(0, rows, ((torch.nn.functional.silu(g) * u) @ down[local])
                         * w[rows, which][:, None])
    return y


def _picks(case, t, e, k, gen):
    if case == "even":
        return torch.stack([(torch.arange(t) + j) % e for j in range(k)], dim=1)
    if case == "one_expert_takes_all":  # every token picks expert 3, then others
        others = [(4 + (torch.arange(t) + j) % (e - 1)) % e for j in range(k - 1)]
        return torch.stack([torch.full((t,), 3)] + others, dim=1)
    # an expert (5) with no token
    idx = torch.stack([torch.randperm(e - 1, generator=gen)[:k] for _ in range(t)])
    return torch.where(idx >= 5, idx + 1, idx)


@pytest.mark.parametrize("capacity", ["largest_load", "token_count"])
@pytest.mark.parametrize("tokens", [7, 137])
@pytest.mark.parametrize("case", ["even", "one_expert_takes_all", "an_expert_with_none"])
def test_padded_batched_experts_are_the_loop(case, tokens, capacity, monkeypatch):
    gen = torch.Generator().manual_seed(11)
    e, k, h, i = 8, 3, 16, 12
    x = torch.randn((tokens, h), generator=gen)
    gate_up = torch.randn((e, h, 2 * i), generator=gen) * h ** -0.5
    down = torch.randn((e, i, h), generator=gen) * i ** -0.5
    idx = _picks(case, tokens, e, k, gen)
    assert all(len(set(r)) == k for r in idx.tolist())
    w = torch.rand((tokens, k), generator=gen)
    bmm_calls = []
    real_bmm = torch.bmm
    monkeypatch.setattr(torch, "bmm", lambda *a, **kw: bmm_calls.append(1) or real_bmm(*a, **kw))
    # A prefill pads each expert to the largest load (read back), a decode
    # step to its token count; one batched matmul a projection either way.
    cap = None if capacity == "largest_load" else tokens
    got = kimi_vl.routed_experts(x, gate_up, down, idx, w, capacity=cap)
    assert len(bmm_calls) == 2
    torch.testing.assert_close(got, _loop_experts(x, gate_up, down, idx, w, range(e)),
                               rtol=1e-5, atol=1e-5)
    # The experts held split into two shares: each share's part, added,
    # gives the whole layer's routed sum.
    lo, hi = [0, 2, 4, 6], [1, 3, 5, 7]
    parts = [kimi_vl.routed_experts(x, gate_up[s], down[s], idx, w, experts=s, n_experts=e,
                                    capacity=cap) for s in (lo, hi)]
    torch.testing.assert_close(parts[0], _loop_experts(x, gate_up[lo], down[lo], idx, w, lo),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(parts[0] + parts[1], got, rtol=1e-5, atol=1e-5)


def test_the_correction_bias_moves_the_choice_not_the_weights(params):
    moe = params["lm"]["layers"][1]["moe"]
    h = torch.randn((32, CFG.hidden), generator=torch.Generator().manual_seed(2))
    idx0, w0 = kimi_vl.route(h, moe, CFG)
    s = torch.sigmoid(h @ moe["router"])
    biased = {**moe, "router_bias": moe["router_bias"].clone()}
    biased["router_bias"][6] += 10.0  # expert 6 now wins every token's choice
    idx1, w1 = kimi_vl.route(h, biased, CFG)
    assert (idx1 == 6).any(dim=1).all() and not (idx0 == 6).any(dim=1).all()
    # The weights are the unbiased scores of the chosen, normalised and scaled.
    want = s.gather(1, idx1)
    torch.testing.assert_close(w1, want / want.sum(1, keepdim=True) * CFG.routed_scale)
    torch.testing.assert_close(w1.sum(1), torch.full((32,), CFG.routed_scale))


def test_the_calibrated_routers_spread_the_loads(params):
    """The reference's ``balance_routers`` (the benchmark's stand-in for a
    trained router) changes only the routers and their correction biases,
    and on its calibration batch leaves every expert layer's largest load
    near the mean, where the drawn router sends most picks to a few."""
    import copy

    gen = torch.Generator().manual_seed(8)
    images = torch.randn((16, CFG.image_size, CFG.image_size, 3), generator=gen)
    ids = kimi_vl.prompt_ids(CFG, 16, PREFIX, SUFFIX, "cpu")
    n = ids.shape[1]

    def largest_over_mean(tree):
        _, _, own = ref.forward(tree, REF_CFG, images, ids, prompt_len=n, logits_from=n - 1)
        loads = [torch.bincount(own[:, i].reshape(-1), minlength=CFG.experts).float()
                 for i in range(own.shape[1])]
        return [float(x.max() / x.mean()) for x in loads]

    tree = copy.deepcopy(params)
    ref.balance_routers(tree, REF_CFG, images, ids, prompt_len=n)
    before, after = largest_over_mean(params), largest_over_mean(tree)
    # 36 picks an expert on average: one pick moves the share by 0.03; read
    # 1.17–1.19 against 2.6–3.2 drawn.
    assert max(after) < 1.25 < 2 < min(before)
    flat = dict(torch.utils._pytree.tree_flatten_with_path(params)[0])
    for path, leaf in torch.utils._pytree.tree_flatten_with_path(tree)[0]:
        if path[-1].key in kimi_vl.F32_LEAVES:
            assert not torch.equal(leaf, flat[path])
        else:
            assert torch.equal(leaf, flat[path])


def test_impl_captions_pixel_arrays_and_refuses_other_inputs(params):
    impl = impls.KimiVlImpl(model_arch="test-tiny", max_new_tokens=4, prefix_ids=PREFIX,
                            suffix_ids=SUFFIX, device="cpu")
    impl.params = params
    rng = np.random.default_rng(3)
    pixels = rng.standard_normal((2, CFG.image_size, CFG.image_size, 3)).astype(np.float32)
    inputs = [PredictionInput(data={"pixels": pixels[0]}), PredictionInput(data={"text": "a cat"}),
              PredictionInput(data={"pixels": pixels[1]}),
              PredictionInput(data={"pixels": pixels[1][:8]})]
    out, kept = impl.predict_keeping(inputs, keep=(2,))
    assert kept[2]["routes"].shape[0] == CFG.layers - CFG.first_dense
    assert out == impl.predict(inputs)
    for pos in (0, 2):
        cap = out[pos]
        assert set(cap) == {"text", "confidence", "language", "language_confidence"}
        toks = cap["text"].split()
        assert 0 < len(toks) <= 4 and all(t.startswith("<") and t.endswith(">") for t in toks)
        assert 0.0 < cap["confidence"] <= 1.0
    for pos in (1, 3):
        assert out[pos]["__error__"]["class"] == "input"
    assert set(kept) == {2} and kept[2]["logits"].shape == (4, CFG.vocab)
    # One image alone captions as it does in the batch.
    assert impl.caption_arrays(pixels[1:2])[0]["text"] == out[2]["text"]


def test_a_checkpoint_names_the_missing_reader():
    from panoptikon_tpu_torch.models.manager import ModelLoadError

    impl = impls.KimiVlImpl(model_arch="test-tiny", checkpoint="model.safetensors", device="cpu")
    with pytest.raises(ModelLoadError, match="safetensors"):
        impl.load()


def test_the_registry_resolves_the_id_to_the_impl(monkeypatch):
    from panoptikon_tpu_torch.models.manager import ModelManager
    from panoptikon_tpu_torch.models.registry import Registry

    registry = Registry(None)
    rid = registry.resolve("vlm", "kimi-vl-a3b")
    assert impls.IMPL_INDEX[rid.impl_class] is impls.KimiVlImpl
    assert rid.config["model_arch"] == "Kimi-VL-A3B-Instruct"
    assert rid.config["max_new_tokens"] == 64 and rid.config["image_size"] == 448
    assert registry.group_metadata("vlm")["output_type"] == "text"
    # Through the manager, at the test size on the CPU.
    monkeypatch.setattr(rid, "config", {**rid.config, "model_arch": "test-tiny",
                                        "image_size": CFG.image_size, "device": "cpu"})
    manager = ModelManager(registry, impls.IMPL_INDEX)
    try:
        manager.load_model("vlm/kimi-vl-a3b", prewarm=True)
        model = manager._models["vlm/kimi-vl-a3b"].model
        assert type(model) is impls.KimiVlImpl and model.params is not None
        assert model.max_new_tokens == 64
    finally:
        manager.shutdown()
