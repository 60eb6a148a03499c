"""The port's CUDA kernels against their plain PyTorch versions, on the card.

A CUDA kernel has no interpret mode, so these tests need an NVIDIA GPU and
skip without one. This file imports no JAX and nothing of the JAX package
(the machine with the card has no JAX); run it there without the repo's conftest, which imports JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from chip_smoke import EPILOGUE_CASES, epilogue_inputs
from panoptikon_tpu_torch.ops import codec as host_codec
from panoptikon_tpu_torch.ops import int8_epilogue, int8_scan, ln_quant, scoring, vit_attention

pytestmark = pytest.mark.cuda

ATTN_SHAPES = {
    # name: (b, n_q, n_kv, h, d, causal, masked)
    "vit_b32_image": (4, 50, 50, 12, 64, False, False),
    "clip_text": (4, 77, 77, 8, 64, True, False),
    "masked": (3, 40, 40, 4, 64, False, True),
    "masked_tiles": (2, 200, 200, 4, 64, False, True),
    "causal_tiles": (2, 300, 300, 2, 64, True, False),
    "cross": (2, 64, 300, 8, 64, False, False),
    "long": (1, 1500, 1500, 2, 64, False, False),
    "n_1": (3, 1, 1, 4, 64, False, False),
    "vit_l14": (2, 257, 257, 16, 64, False, False),
    "cross_ragged": (2, 70, 130, 4, 32, False, False),
    "head_dim_80": (2, 33, 33, 2, 80, False, False),
    "head_dim_128": (2, 100, 100, 2, 128, True, False),
    "head_dim_16": (2, 9, 9, 2, 16, True, False),
    "head_dim_40": (2, 50, 50, 2, 40, False, False),
}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _expected_route(dtype, d):
    """bf16 at D in 32..128, a multiple of 16, takes the tensor cores; f32
    and the other head dims take the CUDA-core kernel."""
    return "tensor_core" if dtype == torch.bfloat16 and d in (32, 48, 64, 80, 96, 112, 128) \
        else "cuda_core"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no interpret mode")
    return torch.device("cuda")


@pytest.fixture(params=["auto", "two_pass"])
def tc_form(request, monkeypatch):
    """The tensor-core kernel as the wrapper sets it up, and with its
    two-pass form forced at every N_kv (0 keys of logits in shared memory)."""
    if request.param == "two_pass":
        monkeypatch.setattr(vit_attention, "TC_LOGITS_MAX_KEYS", 0)
    return request.param


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", list(ATTN_SHAPES))
def test_mha_kernel_matches_plain(cuda_device, tc_form, shape, dtype):
    b, nq, nkv, h, d, causal, masked = ATTN_SHAPES[shape]
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    tdt = getattr(torch, dtype)
    q, k, v = (torch.randn((b, n, h, d), generator=gen, device=cuda_device).to(tdt)
               for n in (nq, nkv, nkv))
    mask = None
    if masked:
        mask = torch.rand((b, nkv), generator=gen, device=cuda_device) < 0.7
        mask[-1] = False  # a fully masked row
    before, routes = vit_attention.mha.launches, dict(vit_attention.mha.routes)
    got = vit_attention.mha(q, k, v, causal=causal, key_mask=mask)
    want = vit_attention.mha_plain(q, k, v, causal=causal, key_mask=mask)
    torch.cuda.synchronize()
    assert vit_attention.mha.launches == before + 1
    path = _expected_route(tdt, d)
    assert vit_attention.mha.routes == {**routes, path: routes[path] + 1}
    assert got.dtype == tdt and torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype], atol=TOL[dtype])


# The text encoders' attention (models/text_embed.py): key-masked with
# seeded ragged valid lengths, at minilm-l6's head dim (32) and mpnet-base's
# (64) up to its full context (N > 320 takes the two-pass form).
TEXT_SHAPES = {
    # name: (b, n, h, d)
    "minilm_l6": (64, 128, 12, 32),
    "mpnet_base_ctx512": (64, 512, 12, 64),
    "mpnet_base_n256": (128, 256, 12, 64),
}


def text_attention_inputs(b, n, h, d, device, seed=0, strided=True):
    """bf16 q, k, v of (B, N, H, D) — the three views of one fused
    (B, N, 3·H·D) projection as the encoder passes them, or contiguous
    copies — and a key mask of seeded valid lengths in [1, N]."""
    gen = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn((b, n, 3 * h * d), generator=gen, device=device).to(torch.bfloat16)
    q, k, v = (t.view(b, n, h, d) for t in qkv.split(h * d, dim=-1))
    if not strided:
        q, k, v = (t.contiguous() for t in (q, k, v))
    lengths = torch.randint(1, n + 1, (b, 1), generator=gen, device=device)
    lengths[0] = n
    mask = torch.arange(n, device=device)[None, :] < lengths
    return q, k, v, mask


@pytest.mark.parametrize("strided", [True, False])
@pytest.mark.parametrize("shape", list(TEXT_SHAPES))
def test_mha_text_encoder_shapes(cuda_device, tc_form, shape, strided):
    q, k, v, mask = text_attention_inputs(*TEXT_SHAPES[shape], cuda_device, strided=strided)
    assert vit_attention.row_stride(q, k, v) == (3 if strided else 1) * q.shape[2] * q.shape[3]
    routes = dict(vit_attention.mha.routes)
    got = vit_attention.mha(q, k, v, key_mask=mask)
    want = vit_attention.mha_plain(q, k, v, key_mask=mask)
    torch.cuda.synchronize()
    assert vit_attention.mha.routes == {**routes, "tensor_core": routes["tensor_core"] + 1}
    assert got.is_contiguous() and torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)
    # Strided or not, the kernel reads the same values.
    if strided:
        again = vit_attention.mha(*(t.contiguous() for t in (q, k, v)), key_mask=mask)
        assert torch.equal(got, again)


# The CUDA-core kernel's wide instantiation (128 < D <= 512, 32-key chunks):
# the captioner's decoder rows through whisper._decoder_logits (768 wide, 2
# heads: D 384) are its main caller.
WIDE_SHAPES = {
    # name: (b, n_q, n_kv, h, causal, masked)
    "self": (2, 70, 70, 2, False, False),
    "causal": (2, 48, 48, 2, True, False),  # the captioner's token rows
    "cross": (8, 48, 50, 2, False, False),  # over its 50 vision tokens
    "masked": (3, 100, 100, 2, False, True),  # four key chunks, a row fully masked
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [160, 256, 384, 512])
@pytest.mark.parametrize("shape", list(WIDE_SHAPES))
def test_mha_takes_wide_head_dims(cuda_device, shape, d, dtype):
    # B3 past D 128 on the CUDA-core route against its plain version, at the
    # tolerances of the narrow kernel; q, k, v as views of one fused qkv
    # read in place alike; past D 512 mha raises and launches nothing (it
    # never falls back to the plain version).
    b, nq, nkv, h, causal, masked = WIDE_SHAPES[shape]
    gen = torch.Generator(device=cuda_device).manual_seed(d)
    tdt = getattr(torch, dtype)
    q, k, v = (torch.randn((b, n, h, d), generator=gen, device=cuda_device).to(tdt)
               for n in (nq, nkv, nkv))
    mask = None
    if masked:
        mask = torch.rand((b, nkv), generator=gen, device=cuda_device) < 0.7
        mask[-1] = False
    routes = dict(vit_attention.mha.routes)
    got = vit_attention.mha(q, k, v, causal=causal, key_mask=mask)
    want = vit_attention.mha_plain(q, k, v, causal=causal, key_mask=mask)
    torch.cuda.synchronize()
    assert vit_attention.mha.routes == {**routes, "cuda_core": routes["cuda_core"] + 1}
    assert got.dtype == tdt and torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype], atol=TOL[dtype])
    if nq == nkv:
        qkv = torch.cat([t.reshape(b, nq, h * d) for t in (q, k, v)], dim=-1)
        views = [t.view(b, nq, h, d) for t in qkv.split(h * d, dim=-1)]
        assert vit_attention.row_stride(*views) == 3 * h * d
        assert torch.equal(vit_attention.mha(*views, causal=causal, key_mask=mask), got)
    wide = torch.zeros((1, 4, 2, vit_attention.MAX_HEAD_DIM + 16), dtype=tdt, device=cuda_device)
    before = vit_attention.mha.launches
    with pytest.raises(ValueError, match="D <= 512"):
        vit_attention.mha(wide, wide, wide, causal=True)
    assert vit_attention.mha.launches == before


def tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, dev) for v in tree]
    return tree.to(dev)


def test_ocr_trunk_on_the_card_equals_the_cpu(cuda_device):
    # doctr/ocr-default's recognizer (crnn-base: 4 layers, 4 heads of 64 over
    # 128 column tokens) on the card against the same weights on the CPU:
    # strip features and CTC logits at cosine ≥ 0.999 a token, the ids equal
    # wherever the CPU's top-2 margin exceeds twice the logits' max abs
    # error; each layer one B3 launch on the tensor cores.
    from panoptikon_tpu_torch.models import impls, ocr

    card = impls.OcrImpl("crnn-base")
    card.load()
    cpu = impls.OcrImpl("crnn-base", device="cpu")
    cpu.params = tree_to(card.params, "cpu")
    rng = np.random.default_rng(7)
    strips = (rng.random((8, 32, 512)) < 0.2).astype(np.float32)
    x = torch.from_numpy(strips)
    routes = dict(vit_attention.mha.routes)
    with torch.inference_mode():
        got = ocr.encode_strips(card.params, card.cfg, x.to(cuda_device)).float().cpu().numpy()
        assert vit_attention.mha.routes == {**routes, "tensor_core": routes["tensor_core"] + 4}
        want = ocr.encode_strips(cpu.params, cpu.cfg, x).float().numpy()
        got_l = ocr.logits(card.params, card.cfg, x.to(cuda_device)).cpu().numpy()
        want_l = ocr.logits(cpu.params, cpu.cfg, x).numpy()
    for a, b in ((got, want), (got_l, want_l)):
        cos = np.sum(a * b, -1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))
        assert cos.min() >= 0.999
    err = float(np.abs(got_l - want_l).max())
    top2 = np.sort(want_l, axis=-1)[..., -2:]
    decided = top2[..., 1] - top2[..., 0] > 2 * err
    ids, _ = ocr.recognize(card.params, card.cfg, x.to(cuda_device))
    assert (ids.cpu().numpy() == want_l.argmax(-1))[decided].all()


def test_captioner_launches_b3_only_in_its_vision_tower(cuda_device):
    # The registry's caption-base (ViT-B-32, max_tokens 48): the vision
    # tower's 12 blocks launch B3 on the tensor cores once each; the decode's
    # steps (at most 47: 3 prompt, 44 more) launch none.
    from panoptikon_tpu_torch.models import impls, whisper

    impl = impls.CaptionerImpl("ViT-B-32", max_tokens=48)
    impl.load()
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    pixels = torch.randn((3, 224, 224, 3), generator=gen, device=cuda_device).cpu().numpy()
    steps = []
    step = whisper._decode_step
    before = dict(vit_attention.mha.routes)
    try:
        whisper._decode_step = lambda *a, **k: steps.append(1) or step(*a, **k)
        out = impl.caption_arrays(pixels)
    finally:
        whisper._decode_step = step
    assert 3 < len(steps) <= 47 and len(out) == 3
    assert vit_attention.mha.routes == {**before, "tensor_core": before["tensor_core"] + 12}
    assert all(len(o["text"].split()) <= 45 and 0 < o["confidence"] <= 1 for o in out)


@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_tagger_trunk_on_the_card_equals_the_cpu(cuda_device, precision):
    # tags/vit-tagger's trunk (ViT-B-32) on the card against the same weights
    # on the CPU: raw features at cosine ≥ 0.999 a row, probabilities within
    # 1e-2 (bf16) and 3e-2 (int8), the tolerances of test_torch_tagger.py:
    # the raw features are unnormalized, so the head turns the two trunks'
    # cosine of 0.99993 (bf16), 0.9995 (int8) into 8e-3 and 2.3e-2; every
    # attention launch on the tensor cores, B4, B5 and the four GEMM
    # epilogues of each layer under int8.
    from panoptikon_tpu_torch.models import impls

    card = impls.TaggerImpl("ViT-B-32", precision=precision)
    cpu = impls.TaggerImpl("ViT-B-32", precision=precision, device="cpu")
    card.load()
    cpu.params, cpu.head, cpu.head_bias = (tree_to(t, "cpu") for t in
                                           (card.params, card.head, card.head_bias))
    pixels = np.random.default_rng(5).normal(size=(6, 224, 224, 3)).astype(np.float32)
    counts = (vit_attention.mha.routes["tensor_core"], vit_attention.mha_qkv.routes["tensor_core"],
              ln_quant.ln_quant_2d.launches, int8_epilogue.int8_epilogue.launches)
    got = card.raw_features(pixels).cpu().numpy()
    launched = (vit_attention.mha.routes["tensor_core"], vit_attention.mha_qkv.routes["tensor_core"],
                ln_quant.ln_quant_2d.launches, int8_epilogue.int8_epilogue.launches)
    want = cpu.raw_features(pixels).numpy()
    cos = np.sum(got * want, -1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(want, axis=-1))
    assert cos.min() >= 0.999
    atol = {"bf16": 1e-2, "int8": 3e-2}[precision]
    assert np.abs(card.probabilities(pixels) - cpu.probabilities(pixels)).max() <= atol
    grew = [b - a for a, b in zip(counts, launched)]
    if precision == "int8":  # calibration (bf16, 12 B3 launches), then the int8 trunk
        assert grew == [12, 12, 24, 48]
    else:
        assert grew == [12, 0, 0, 0]


AUDIO_SHAPES = {
    # name: (b, n_q, n_kv, h, d, causal, q/k/v views of one fused qkv)
    "whisper_encoder": (2, 1500, 1500, 8, 64, False, True),
    "whisper_probe_cross": (4, 1, 1500, 8, 64, False, False),
    "whisper_probe_causal": (4, 1, 1, 8, 64, True, True),
    "clap": (2, 320, 320, 8, 64, False, False),
}


@pytest.mark.parametrize("shape", list(AUDIO_SHAPES))
def test_mha_audio_shapes(cuda_device, tc_form, shape):
    # The audio towers' shapes (models/whisper.py, models/audio.py): the
    # encoder's and the probe's causal step read q, k, v in place from the
    # fused qkv (at N = 1 the row stride is the batch axis's), the probe's
    # cross-attention one query against 1,500 keys.
    b, nq, nkv, h, d, causal, fused = AUDIO_SHAPES[shape]
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    if fused:
        qkv = torch.randn((b, nq, 3 * h * d), generator=gen, device=cuda_device).to(torch.bfloat16)
        q, k, v = (t.view(b, nq, h, d) for t in qkv.split(h * d, dim=-1))
        assert vit_attention.row_stride(q, k, v) == 3 * h * d
    else:
        q, k, v = (torch.randn((b, n, h, d), generator=gen, device=cuda_device).to(torch.bfloat16)
                   for n in (nq, nkv, nkv))
    routes = dict(vit_attention.mha.routes)
    got = vit_attention.mha(q, k, v, causal=causal)
    want = vit_attention.mha_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert vit_attention.mha.routes == {**routes, "tensor_core": routes["tensor_core"] + 1}
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)
    if fused:
        assert torch.equal(got, vit_attention.mha(*(t.contiguous() for t in (q, k, v)),
                                                  causal=causal))


def test_mha_strided_views_need_the_tensor_cores_and_aligned_rows(cuda_device):
    # Both routes read the views of a fused qkv in place (the CUDA-core route
    # too, since the captioner's decoder rows at D 384 take it); the tensor
    # cores need 16-byte aligned rows, and views that share no row stride
    # are refused, with no launch.
    b, n, h, d = 2, 40, 2, 64
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    qkv = torch.randn((b, n, 3 * h * d), generator=gen, device=cuda_device)
    views = [t.view(b, n, h, d) for t in qkv.split(h * d, dim=-1)]
    routes = dict(vit_attention.mha.routes)
    got = vit_attention.mha(*views)  # f32: the CUDA-core route
    assert vit_attention.mha.routes == {**routes, "cuda_core": routes["cuda_core"] + 1}
    assert torch.equal(got, vit_attention.mha(*(t.contiguous() for t in views)))
    before = vit_attention.mha.launches
    with pytest.raises(ValueError, match="contiguous"):  # rows 3·H·D and H·D apart
        vit_attention.mha(views[0], torch.zeros((b, n, h, d), device=cuda_device), views[2])
    odd = torch.zeros((b, n, 3 * h * d + 1), device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):  # rows 2 bytes past 16
        vit_attention.mha(*(odd[..., i * h * d:(i + 1) * h * d].view(b, n, h, d)
                            for i in range(3)))
    assert vit_attention.mha.launches == before


def _codes_agree(got, want):
    """int8 outputs: no code more than one apart, at most 0.5 % apart at all."""
    diff = (got.to(torch.int32) - want.to(torch.int32)).abs()
    return diff.max().item() <= 1 and (diff > 0).float().mean().item() <= 5e-3


def test_mha_head_dim_16_keeps_p_in_f32(cuda_device):
    # Below D = 32 the kernel must not round p to bf16, as its plain version.
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn((4, 300, 2, 16), generator=gen, device=cuda_device).to(torch.bfloat16)
               for _ in range(3))
    routes = dict(vit_attention.mha.routes)
    got = vit_attention.mha(q, k, v)
    want = vit_attention.mha_plain(q, k, v)
    torch.cuda.synchronize()
    assert vit_attention.mha.routes == {**routes, "cuda_core": routes["cuda_core"] + 1}
    assert (got == want).float().mean().item() >= 0.995
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)


def test_mha_tensor_core_route_rejects_misaligned_operands(cuda_device):
    b, n, h, d = 2, 50, 4, 64
    flat = torch.zeros(b * n * h * d + 1, device=cuda_device, dtype=torch.bfloat16)
    q = flat[1:].view(b, n, h, d)  # contiguous, 2 bytes past a 16-byte boundary
    k = v = torch.zeros((b, n, h, d), device=cuda_device, dtype=torch.bfloat16)
    before = vit_attention.mha.launches
    with pytest.raises(ValueError, match="aligned"):
        vit_attention.mha(q, k, v)
    assert vit_attention.mha.launches == before


def div_rn_divisors(device):
    """Row sums the softmax can give (f32 ≥ 1): 1 and its neighbour, powers
    of two and the floats just under them, and 64 seeded log-uniform values
    up to 4,096."""
    rng = np.random.default_rng(5)
    under = np.nextafter(np.float32(2.0) ** np.arange(1, 13, dtype=np.float32), np.float32(0))
    values = np.concatenate([
        [1.0, np.nextafter(np.float32(1), np.float32(2)), 3.0, 257.0, 1500.0],
        2.0 ** np.arange(1, 13), under, np.exp(rng.uniform(0, np.log(4096), 64))])
    return torch.from_numpy(values.astype(np.float32)).to(device)


def test_kernel_division_is_correctly_rounded(cuda_device):
    # p = e / s by one correction of e·(1/s), bit for bit __fdiv_rn's, for
    # every float e in [0, 1].
    counts = vit_attention.check_div_rn(div_rn_divisors(cuda_device))
    assert counts.sum().item() == 0, counts.tolist()


QKV_SHAPES = {
    # name: (b, n, h, d, causal)
    "vit_l14_image": (2, 257, 16, 64, False),
    "vit_l14_text": (3, 77, 12, 64, True),
    "vit_h14_378": (1, 730, 16, 80, False),
    "head_dim_128": (2, 65, 2, 128, True),
    "n_1": (2, 1, 3, 64, False),
    "head_dim_16": (2, 40, 2, 16, True),
}


@pytest.mark.parametrize("out", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("shape", list(QKV_SHAPES))
def test_mha_qkv_kernel_matches_plain(cuda_device, tc_form, shape, out):
    b, n, h, d, causal = QKV_SHAPES[shape]
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    in_dt = torch.float32 if out == "float32" else torch.bfloat16
    qkv = torch.randn((b, n, 3 * h * d), generator=gen, device=cuda_device).to(in_dt)
    scale = torch.tensor(2.5, device=cuda_device) if out == "int8" else None
    before, routes = vit_attention.mha_qkv.launches, dict(vit_attention.mha_qkv.routes)
    got = vit_attention.mha_qkv(qkv, heads=h, causal=causal, out_scale=scale)
    want = vit_attention.mha_qkv_plain(qkv, heads=h, causal=causal, out_scale=scale)
    torch.cuda.synchronize()
    assert vit_attention.mha_qkv.launches == before + 1
    path = _expected_route(in_dt, d)
    assert vit_attention.mha_qkv.routes == {**routes, path: routes[path] + 1}
    assert got.dtype == want.dtype and got.shape == (b, n, h * d)
    if out == "int8":
        assert _codes_agree(got, want)
    else:
        torch.testing.assert_close(got.float(), want.float(), rtol=TOL[out], atol=TOL[out])


@pytest.mark.parametrize("r,w", [(256 * 257, 1024), (1000, 1280), (77, 40), (3, 2048)])
def test_ln_quant_kernel_matches_plain(cuda_device, r, w):
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    x = (torch.randn((r, w), generator=gen, device=cuda_device) * 3).to(torch.bfloat16)
    g = torch.randn(w, generator=gen, device=cuda_device)
    b = torch.randn(w, generator=gen, device=cuda_device)
    s = torch.tensor(4.2, device=cuda_device)
    before = ln_quant.ln_quant_2d.launches
    got = ln_quant.ln_quant_2d(x, g, b, s)
    want = ln_quant.ln_quant_plain(x, g, b, s)
    torch.cuda.synchronize()
    assert ln_quant.ln_quant_2d.launches == before + 1
    assert got.dtype == torch.int8 and _codes_agree(got, want)


def _epilogue_agrees(got, want, mode):
    """The bf16 modes bit for bit; the int8 codes of GELU's mode at most one
    apart, in under 1e-4 of the entries (its tanh may round an ulp apart
    from PyTorch's, which moves a bf16 hidden value rarely)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    if mode != "gelu_quant":
        return torch.equal(got, want)
    diff = (got.to(torch.int32) - want.to(torch.int32)).abs()
    share = (diff != 0).float().mean().item()
    assert diff.max().item() <= 1 and share < 1e-4, share
    return True


@pytest.mark.parametrize("shape", list(EPILOGUE_CASES))
def test_int8_epilogue_kernel_matches_plain(cuda_device, shape):
    # The four epilogues of a ViT-L/14 block at 256 images and of its text
    # tower at 64 texts; GELU's mode also holds its pre-GELU value (the bf16
    # mode's arithmetic in the kernel) bit for bit.
    rows, k, n, mode = EPILOGUE_CASES[shape]
    acc, step, sw, b, extra = epilogue_inputs(torch, rows, k, n, mode, cuda_device, seed=rows + n)
    before = int8_epilogue.int8_epilogue.launches
    got = int8_epilogue.int8_epilogue(acc, step, sw, b, **extra)
    want = int8_epilogue.int8_epilogue_plain(acc, step, sw, b, **extra)
    torch.cuda.synchronize()
    assert int8_epilogue.int8_epilogue.launches == before + 1
    assert _epilogue_agrees(got, want, mode)
    if mode == "gelu_quant":
        assert torch.equal(int8_epilogue.int8_epilogue(acc, step, sw, b),
                           int8_epilogue.int8_epilogue_plain(acc, step, sw, b))


@pytest.mark.parametrize("mode", ["bf16", "residual", "gelu_quant"])
def test_int8_epilogue_kernel_takes_a_padded_gemm_output(cuda_device, mode):
    # N 36 is padded to 40 by int_mm and cut back, so acc has a row stride of
    # 40; 77 rows are a ragged last row block; no bias.
    from panoptikon_tpu_torch.models import clip

    gen = torch.Generator(device=cuda_device).manual_seed(3)
    xq = torch.randint(-127, 128, (77, 64), generator=gen, device=cuda_device, dtype=torch.int8)
    w = clip._quantize_weight(torch.randn((64, 36), generator=gen, device=cuda_device))
    acc = clip._int_mm(xq, w["q"])
    assert acc.stride(0) == 40
    _, step, _, _, extra = epilogue_inputs(torch, 77, 64, 36, mode, cuda_device, seed=4)
    got = int8_epilogue.int8_epilogue(acc, step, w["s"], None, **extra)
    want = int8_epilogue.int8_epilogue_plain(acc, step, w["s"], None, **extra)
    torch.cuda.synchronize()
    assert _epilogue_agrees(got, want, mode)
    with pytest.raises(ValueError, match="N % 4"):
        int8_epilogue.int8_epilogue(acc[:, :34], step, w["s"][:, :34], None)


def planted_betas(sx: float) -> np.ndarray:
    """β values whose quotient by the step sx lands on every half-integer
    k + 0.5 in [-128.5, 127.5] and one ulp either side of it, and on and
    past the ±127 clamp: with γ = 0 they are the LN output y exactly."""
    half = (np.arange(-129, 128, dtype=np.float64) + 0.5) * sx
    exact = half.astype(np.float32)
    clamp = np.array([126.5, 127, 127.49, 127.5, 128, 1000, 1e30], np.float64) * sx
    values = np.concatenate([exact, np.nextafter(exact, np.float32(np.inf)),
                             np.nextafter(exact, np.float32(-np.inf)),
                             clamp.astype(np.float32), -clamp.astype(np.float32)])
    return values.astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [15.875, 4.2])
def test_ln_quant_kernel_planted_half_integers(cuda_device, s, dtype):
    # s = 15.875 makes the step sx = 1/8 exactly, so β / sx is k + 0.5 to
    # the bit; at s = 4.2 the same β land within an ulp or two of it. Every
    # code must equal the plain version's (a correctly rounded division, half
    # to even).
    sx = np.float32(max(np.float32(s) / np.float32(127), np.float32(1e-12)))
    beta = planted_betas(float(sx))
    w = -(-beta.size // 8) * 8
    b = torch.zeros(w, device=cuda_device)
    b[:beta.size] = torch.from_numpy(beta).to(cuda_device)
    g = torch.zeros(w, device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn((33, w), generator=gen, device=cuda_device).to(getattr(torch, dtype))
    scale = torch.tensor(s, device=cuda_device)
    got = ln_quant.ln_quant_2d(x, g, b, scale)
    want = ln_quant.ln_quant_plain(x, g, b, scale)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert got.abs().max().item() == 127


def test_quant_code_matches_correctly_rounded_division(cuda_device):
    # Every float y (all 2^32 bit patterns) at calibrated absmax values from
    # the floor of the step (1e-12) up to 1e30, and +inf.
    rng = np.random.default_rng(4)
    s = np.concatenate([[15.875, 4.2, 1.0, 127.0, 1e-12, 1e-10, 3e30, np.inf],
                        np.exp(rng.uniform(np.log(1e-3), np.log(1e3), 8))]).astype(np.float32)
    counts = ln_quant.check_quant_code(torch.from_numpy(s).to(cuda_device))
    assert counts.sum().item() == 0, counts.tolist()


B1_CASES = {
    # name: (n, d, q, k)
    "k80": (5000, 128, 40, 80),
    "k10_70k": (70_000, 512, 17, 10),
    "k1": (1100, 32, 3, 1),
    "k1024_5k": (5000, 64, 20, 1024),
    "k1024_70k": (70_000, 512, 40, 1024),
    "k_equals_n": (1000, 32, 5, 1000),
    "q1": (70_000, 512, 1, 80),
    "q600": (20_000, 128, 600, 80),
    "d48": (9000, 48, 33, 80),
    "d768": (20_000, 768, 70, 80),
    "k200_q_block_32": (30_000, 256, 45, 200),
    "k300_q_block_16": (30_000, 256, 45, 300),
}


def _b1_inputs(device, n, d, q):
    """Seeded codes with row 3 planted at n // 2 and n - 1 (equal rows in
    different strips); query 0 is row 3; about 10 % of rows invalid."""
    rng = np.random.default_rng(n + d + q)
    corpus = rng.normal(size=(n, d)).astype(np.float32)
    corpus[[n // 2, n - 1]] = corpus[3]
    queries = rng.normal(size=(q, d)).astype(np.float32)
    queries[0] = corpus[3]
    scale = host_codec.scale_from_absmax(host_codec.corpus_absmax(corpus))
    codes = torch.from_numpy(host_codec.quantize_int8_host(corpus, scale)).to(device)
    q_codes = torch.from_numpy(host_codec.quantize_int8_host(queries, scale)).to(device)
    valid = torch.from_numpy(rng.random(n) > 0.1).to(device)
    valid[[3, n // 2, n - 1]] = True
    return codes, q_codes, valid, scale


@pytest.mark.parametrize("distance", ["cosine", "l2"])
@pytest.mark.parametrize("case", list(B1_CASES))
def test_int8_topk_kernel_matches_plain(cuda_device, case, distance):
    n, d, q, k = B1_CASES[case]
    codes, q_codes, valid, scale = _b1_inputs(cuda_device, n, d, q)
    args = (codes, scoring.row_sumsq(codes), valid, q_codes)
    before = int8_scan.int8_topk.launches
    gv, gi, gok = int8_scan.int8_topk(*args, k=k, distance=distance, scale=scale)
    pv, pi, pok = int8_scan.int8_topk_plain(*args, k=k, distance=distance, scale=scale)
    torch.cuda.synchronize()
    assert int8_scan.int8_topk.launches == before + 1
    assert torch.equal(gi, pi) and torch.equal(gok, pok) and torch.equal(gv, pv)
    assert gi[0, :min(k, 3)].tolist() == [3, n // 2, n - 1][:k]


@pytest.mark.parametrize("distance", ["cosine", "l2"])
@pytest.mark.parametrize("k", [2, 80, 1024])
def test_int8_topk_kernel_all_rows_invalid_but_three(cuda_device, k, distance):
    # Fewer valid rows than k: the rest come back at +inf, lowest row first.
    codes, q_codes, valid, scale = _b1_inputs(cuda_device, 30_000, 128, 9)
    valid[:] = False
    valid[[17, 12_345, 29_999]] = True
    args = (codes, scoring.row_sumsq(codes), valid, q_codes)
    gv, gi, gok = int8_scan.int8_topk(*args, k=k, distance=distance, scale=scale)
    pv, pi, pok = int8_scan.int8_topk_plain(*args, k=k, distance=distance, scale=scale)
    torch.cuda.synchronize()
    assert torch.equal(gi, pi) and torch.equal(gok, pok) and torch.equal(gv, pv)
    assert int(gok.sum().item()) == 9 * min(k, 3)


@pytest.mark.parametrize("distance", ["cosine", "l2"])
@pytest.mark.parametrize("q", [1, 64])
def test_four_shard_search_on_one_card_is_unsharded_b1(cuda_device, q, distance):
    # Four shards on cuda:0, each a slab with its own B1 launch, merged on
    # the card: the ids and distances of one B1 over the whole corpus (the
    # planted equal rows in different shards resolve to the lowest row).
    from panoptikon_tpu_torch.index import VectorIndex, sharded
    from panoptikon_tpu_torch.parallel import mesh as meshlib

    n, d = 70_000, 128
    codes, q_codes, valid, scale = _b1_inputs(torch.device("cpu"), n, d, q)
    idx = VectorIndex(chunk_rows=8192)
    idx.add("s", np.arange(n) + 1, np.arange(n), codes.numpy().astype(np.float32) * scale)
    idx.build_quant("s", scale=scale)
    snap = idx.snapshot("s")
    assert np.array_equal(snap.codes[:n], codes.numpy())
    rows_valid = valid.numpy()
    idx.remove_items("s", np.flatnonzero(~rows_valid) + 1)
    snap = idx.snapshot("s")
    meshlib.set_devices([cuda_device] * 4)
    try:
        space = sharded.build_sharded(snap, meshlib.index_mesh(), use_quant=True)
        before = int8_scan.int8_topk.launches
        sv, si, sok, grouped = sharded.sharded_search(space, q_codes.to(cuda_device), k=80,
                                                      distance=distance)
        torch.cuda.synchronize()
        assert int8_scan.int8_topk.launches == before + 4 and not grouped
    finally:
        meshlib.set_devices(None)
    dev_codes = torch.from_numpy(snap.codes[:n]).to(cuda_device)
    args = (dev_codes, scoring.row_sumsq(dev_codes), torch.from_numpy(snap.row_valid[:n]).to(
        cuda_device), q_codes.to(cuda_device))
    gv, gi, gok = int8_scan.int8_topk(*args, k=80, distance=distance, scale=snap.scale)
    assert np.array_equal(space.item_ids[si.cpu().numpy()], snap.group_ids[gi.cpu().numpy()])
    assert torch.equal(sok.cpu(), gok.cpu())
    assert (sv - gv).abs().max().item() <= 1e-6


@pytest.mark.parametrize("distance", ["cosine", "l2"])
def test_surface_topk_matches_plain(cuda_device, distance):
    # The exact surface on the card (torch._int_mm) against B1's plain
    # version at k <= 1,024, and against its own CPU form past it.
    codes, q_codes, valid, scale = _b1_inputs(cuda_device, 5000, 96, 70)
    args = (codes, scoring.row_sumsq(codes), valid, q_codes)
    before = scoring.surface_topk.launches
    got = scoring.surface_topk(*args, k=1000, distance=distance, scale=scale)
    want = int8_scan.int8_topk_plain(*args, k=1000, distance=distance, scale=scale)
    assert scoring.surface_topk.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    got = scoring.surface_topk(*args, k=1600, distance=distance, scale=scale)
    want = scoring.surface_topk(*(t.cpu() for t in args), k=1600, distance=distance, scale=scale)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("distance", ["cosine", "l2"])
@pytest.mark.parametrize("n,d,q,k", [(5000, 128, 40, 80), (70_000, 512, 600, 80), (1100, 32, 3, 8)])
def test_int8_topk_v2_kernel_matches_plain(cuda_device, n, d, q, k, distance):
    rng = np.random.default_rng(n + 1)
    corpus = rng.normal(size=(n, d)).astype(np.float32)
    corpus[[5, 130, n - 1]] = corpus[3]  # equal rows: lane order, row order and tiles disagree
    queries = rng.normal(size=(q, d)).astype(np.float32)
    queries[0] = corpus[3]
    scale = host_codec.scale_from_absmax(host_codec.corpus_absmax(corpus))
    codes = torch.from_numpy(host_codec.quantize_int8_host(corpus, scale)).to(cuda_device)
    q_codes = torch.from_numpy(host_codec.quantize_int8_host(queries, scale)).to(cuda_device)
    valid = torch.from_numpy(rng.random(n) > 0.1).to(cuda_device)
    valid[[3, 5, 130, n - 1]] = True
    valid[2048:4096] = False  # a whole tile invalid: +inf rounds, sentinel rows
    args = (codes, scoring.row_sumsq(codes), valid, q_codes)
    before = int8_scan.int8_topk_v2.launches
    gv, gi, gok = int8_scan.int8_topk_v2(*args, k=k, distance=distance, scale=scale)
    pv, pi, pok = int8_scan.int8_topk_v2_plain(*args, k=k, distance=distance, scale=scale)
    torch.cuda.synchronize()
    assert int8_scan.int8_topk_v2.launches == before + 1
    assert torch.equal(gi, pi) and torch.equal(gok, pok)
    assert (gv - pv).abs().nan_to_num(0.0).max().item() <= 1e-6
    # Lanes 2, 3, 5 of tile 0, then the last tile.
    assert gi[0, :4].tolist() == [130, 3, 5, n - 1]
    assert (gi[~gok] == int8_scan.SENTINEL_ROW).all()


def test_b2_rsqrt_is_correctly_rounded(cuda_device):
    # B2's branch-free reciprocal square root against __frsqrt_rn, over
    # every positive normal float.
    assert int8_scan.check_rsqrt_rn(cuda_device) == 0


def _v2_corpus(n, d, q, seed):
    """Seeded codes with planted exact ties to row 3: rows 131 and 259 (lane
    3 of later buckets), 5 and 130 (other lanes of tile 0), n - 1; query 0
    is row 3. About 10 % of rows invalid, the planted ones valid."""
    rng = np.random.default_rng(seed)
    corpus = rng.normal(size=(n, d)).astype(np.float32)
    planted = [r for r in (131, 259, 5, 130, n - 1) if r < n]
    corpus[planted] = corpus[3]
    queries = rng.normal(size=(q, d)).astype(np.float32)
    queries[0] = corpus[3]
    scale = host_codec.scale_from_absmax(host_codec.corpus_absmax(corpus))
    codes = torch.from_numpy(host_codec.quantize_int8_host(corpus, scale))
    q_codes = torch.from_numpy(host_codec.quantize_int8_host(queries, scale))
    valid = torch.from_numpy(rng.random(n) > 0.1)
    valid[[3, *planted]] = True
    return codes, q_codes, valid, scale


V2_CASES = {
    # name: (n, d, q, tile_n, k_tile, k); q is never a multiple of 128 here
    "d48_k_tail": (9000, 48, 300, 2048, 8, 80),
    "d768": (20_000, 768, 257, 2048, 8, 80),
    "d1024": (20_000, 1024, 129, 2048, 8, 80),
    "d32": (4100, 32, 5, 2048, 8, 16),
    "tile_128_k_tile_1": (5000, 512, 130, 128, 1, 40),
    "tile_32768_k_tile_128": (70_000, 512, 70, 32768, 128, 300),
    "k_tile_128": (5000, 256, 300, 2048, 128, 300),
}


@pytest.mark.parametrize("distance", ["cosine", "l2"])
@pytest.mark.parametrize("case", list(V2_CASES))
def test_int8_topk_v2_kernel_shapes(cuda_device, case, distance):
    n, d, q, tile_n, k_tile, k = V2_CASES[case]
    codes, q_codes, valid, scale = (t.to(cuda_device) if torch.is_tensor(t) else t
                                    for t in _v2_corpus(n, d, q, seed=n + d))
    args = (codes, scoring.row_sumsq(codes), valid, q_codes)
    kw = dict(k=k, k_tile=k_tile, tile_n=tile_n, distance=distance, scale=scale)
    before = int8_scan.int8_topk_v2.launches
    gv, gi, gok = int8_scan.int8_topk_v2(*args, **kw)
    pv, pi, pok = int8_scan.int8_topk_v2_plain(*args, **kw)
    torch.cuda.synchronize()
    assert int8_scan.int8_topk_v2.launches == before + 1
    assert torch.equal(gi, pi) and torch.equal(gok, pok)
    assert (gv - pv)[gok].abs().max().item() <= 1e-6
    assert (gi[~gok] == int8_scan.SENTINEL_ROW).all()


@pytest.mark.parametrize("distance", ["cosine", "l2"])
def test_int8_topk_v2_kernel_planted_ties(cuda_device, distance):
    # Rows 3, 131 and 259 share lane 3 of tile 0 (buckets 0, 1, 2): only
    # the lowest bucket survives. Rows 130, 3 and 5 are lanes 2, 3, 5 of the
    # tile: the rounds take them lowest lane first; then the last tile's copy.
    n, d = 10_000, 512
    codes, q_codes, valid, scale = (t.to(cuda_device) if torch.is_tensor(t) else t
                                    for t in _v2_corpus(n, d, 200, seed=7))
    args = (codes, scoring.row_sumsq(codes), valid, q_codes)
    got = int8_scan.int8_topk_v2(*args, k=80, distance=distance, scale=scale)
    want = int8_scan.int8_topk_v2_plain(*args, k=80, distance=distance, scale=scale)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert (got[0] - want[0])[got[2]].abs().max().item() <= 1e-6
    assert got[1][0, :4].tolist() == [130, 3, 5, n - 1]
    assert not set(got[1][0].tolist()) & {131, 259}


def test_int8_topk_v2_kernel_rejects_d_past_its_limit(cuda_device):
    d = int8_scan.V2_MAX_DIM + 16
    codes = torch.zeros((300, d), dtype=torch.int8, device=cuda_device)
    q_codes = torch.zeros((2, d), dtype=torch.int8, device=cuda_device)
    valid = torch.ones(300, dtype=torch.bool, device=cuda_device)
    before = int8_scan.int8_topk_v2.launches
    with pytest.raises(ValueError, match="D <="):
        int8_scan.int8_topk_v2(codes, scoring.row_sumsq(codes), valid, q_codes)
    assert int8_scan.int8_topk_v2.launches == before


# B3's backward (csrc/attention_bwd.cu) against mha_backward_plain: one shape
# per form and instantiation, and the tensor-core route's edges (N 1, 63-65,
# 128; cross 1 x 128 and 63 x 128; causal 63; D 32 to 128). Tolerance
# relative to the largest gradient element: both compute in f32 from the
# same inputs and round once to the output dtype (the tensor-core route also
# rounds dS to bf16 for dQ and dK), so bf16 results sit within two bf16 ulps
# of it (1e-2) and f32 within the sums' order (2e-5).
BACKWARD_SHAPES = {
    # name: (b, n_q, n_kv, h, d, causal, masked)
    "vit_b32_image": (4, 50, 50, 12, 64, False, False),
    "clip_text_causal": (4, 77, 77, 8, 64, True, False),
    "cross": (2, 63, 128, 4, 64, False, False),
    "key_masked": (3, 128, 128, 4, 32, False, True),
    "head_dim_16": (4, 300, 300, 2, 16, False, False),
    "wide_self": (2, 48, 48, 2, 384, False, False),
    "wide_causal": (2, 48, 48, 2, 384, True, False),
    "wide_cross": (2, 48, 50, 2, 384, False, False),
    "wide_masked_512": (3, 40, 40, 2, 512, False, True),
    "n_1": (3, 1, 1, 4, 64, False, False),
    "n_63": (2, 63, 63, 4, 64, False, False),
    "n_64": (2, 64, 64, 4, 64, False, False),
    "n_65": (2, 65, 65, 4, 64, False, False),
    "n_128": (2, 128, 128, 4, 64, False, False),
    "cross_1x128": (3, 1, 128, 4, 64, False, False),
    "causal_63": (2, 63, 63, 4, 64, True, False),
    "head_dim_32": (2, 77, 77, 4, 32, True, False),
    "head_dim_48": (2, 50, 50, 4, 48, False, False),
    "head_dim_80": (2, 65, 65, 2, 80, False, True),
    "head_dim_128": (2, 128, 128, 2, 128, True, False),
    "head_dim_128_cross": (2, 100, 128, 2, 128, False, False),
    "n_129": (2, 129, 129, 2, 64, False, False),
}
BACKWARD_TOL = {"float32": 2e-5, "bfloat16": 1e-2}


def backward_inputs(shape, dtype, device, seed=0):
    b, nq, nkv, h, d, causal, masked = BACKWARD_SHAPES[shape]
    gen = torch.Generator(device=device).manual_seed(seed)
    tdt = getattr(torch, dtype)
    q, k, v = (torch.randn((b, n, h, d), generator=gen, device=device).to(tdt)
               for n in (nq, nkv, nkv))
    dout = torch.randn((b, nq, h, d), generator=gen, device=device).to(tdt)
    mask = None
    if masked:
        mask = torch.rand((b, nkv), generator=gen, device=device) < 0.7
        mask[-1] = False  # a fully masked row: uniform p, gradients through every key
    return q, k, v, dout, causal, mask


def assert_grads_close(got, want, dtype):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and torch.isfinite(g.float()).all()
        scale = w.float().abs().max().item()
        assert (g.float() - w.float()).abs().max().item() <= BACKWARD_TOL[dtype] * scale


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", list(BACKWARD_SHAPES))
def test_mha_backward_kernel_matches_plain(cuda_device, shape, dtype):
    q, k, v, dout, causal, mask = backward_inputs(shape, dtype, cuda_device)
    out = vit_attention.mha(q, k, v, causal=causal, key_mask=mask)
    before, routes = vit_attention.mha_backward.launches, dict(vit_attention.mha_backward.routes)
    got = vit_attention.mha_backward(q, k, v, out, dout, causal=causal, key_mask=mask)
    want = vit_attention.mha_backward_plain(q, k, v, out, dout, causal=causal, key_mask=mask)
    torch.cuda.synchronize()
    assert vit_attention.mha_backward.launches == before + 1
    path = vit_attention.backward_route(q.dtype, q.shape[3], q.shape[1], k.shape[1])
    assert vit_attention.mha_backward.routes == {**routes, path: routes[path] + 1}
    assert_grads_close(got, want, dtype)


TC_BACKWARD_SHAPES = [name for name, (b, nq, nkv, h, d, _, _) in BACKWARD_SHAPES.items()
                      if vit_attention.backward_route(torch.bfloat16, d, nq, nkv) == "tensor_core"]


@pytest.mark.parametrize("shape", TC_BACKWARD_SHAPES)
def test_mha_backward_both_routes_match_plain(cuda_device, shape):
    # Where the tensor-core route takes a shape, both kernels launch on it
    # and each is held to the plain version; each counts on its own route.
    q, k, v, dout, causal, mask = backward_inputs(shape, "bfloat16", cuda_device)
    out = vit_attention.mha(q, k, v, causal=causal, key_mask=mask)
    want = vit_attention.mha_backward_plain(q, k, v, out, dout, causal=causal, key_mask=mask)
    for path, launch in (("tensor_core", vit_attention.mha_backward_tensor_core),
                         ("cuda_core", vit_attention.mha_backward_cuda_core)):
        before, routes = vit_attention.mha_backward.launches, dict(vit_attention.mha_backward.routes)
        got = launch(q, k, v, dout, causal=causal, key_mask=mask)
        torch.cuda.synchronize()
        assert vit_attention.mha_backward.launches == before + 1
        assert vit_attention.mha_backward.routes == {**routes, path: routes[path] + 1}
        assert_grads_close(got, want, "bfloat16")
    # No atomics: the tensor-core route gives the same bits run after run.
    again = vit_attention.mha_backward_tensor_core(q, k, v, dout, causal=causal, key_mask=mask)
    first = vit_attention.mha_backward_tensor_core(q, k, v, dout, causal=causal, key_mask=mask)
    assert all(torch.equal(a, b) for a, b in zip(again, first))


@pytest.mark.parametrize("shape", [(4, 50, 50, 12, 64, False, False),
                                   (2, 63, 63, 4, 64, True, False),
                                   (3, 64, 64, 2, 64, False, True),
                                   (2, 100, 128, 2, 128, False, False),
                                   (2, 128, 128, 2, 128, True, False)])
def test_tensor_core_backward_p_is_the_forwards_bit_for_bit(cuda_device, shape):
    # With V and dO one-hot (V[j, c] = [c == j], dO[i, c] = [c == i]; N_q,
    # N_kv <= D) the forward's output is its p~ (out[i, j] = p~[i, j]) and
    # the backward's dV is the backward's p~ transposed (dV[j, i] =
    # p~[i, j]), each a single exact product rounded from a bf16 value: the
    # two kernels form the same p~ bit for bit.
    b, nq, nkv, h, d, causal, masked = shape
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    q = torch.randn((b, nq, h, d), generator=gen, device=cuda_device).to(torch.bfloat16)
    k = torch.randn((b, nkv, h, d), generator=gen, device=cuda_device).to(torch.bfloat16)
    eye = torch.eye(d, device=cuda_device, dtype=torch.bfloat16)
    v = eye[:nkv][None, :, None, :].expand(b, nkv, h, d).contiguous()
    dout = eye[:nq][None, :, None, :].expand(b, nq, h, d).contiguous()
    mask = None
    if masked:
        mask = torch.rand((b, nkv), generator=gen, device=cuda_device) < 0.7
        mask[-1] = False
    out = vit_attention.mha(q, k, v, causal=causal, key_mask=mask)
    _, _, dv = vit_attention.mha_backward_tensor_core(q, k, v, dout, causal=causal, key_mask=mask)
    torch.cuda.synchronize()
    assert torch.equal(out[..., :nkv], dv[..., :nq].permute(0, 3, 2, 1))
    assert out.float().sum(dim=-1).sub(1).abs().max().item() < 0.05  # rows of p~ sum to ~1


def test_tensor_core_backward_refuses_what_it_does_not_take(cuda_device):
    # Misaligned q or dO rows raise on the tensor-core route (no fallback
    # to the other kernel), as do shapes backward_route sends elsewhere;
    # nothing is counted.
    b, n, h, d = 2, 50, 4, 64
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    flat = torch.randn(b * n * h * d + 1, generator=gen, device=cuda_device).to(torch.bfloat16)
    q = flat[1:].view(b, n, h, d)  # contiguous, 2 bytes past an aligned base
    k, v, dout = (torch.randn((b, n, h, d), generator=gen, device=cuda_device).to(torch.bfloat16)
                  for _ in range(3))
    before, routes = vit_attention.mha_backward.launches, dict(vit_attention.mha_backward.routes)
    with pytest.raises(ValueError, match="16-byte aligned"):
        vit_attention.mha_backward_tensor_core(q, k, v, dout)
    with pytest.raises(ValueError, match="16-byte aligned"):
        vit_attention.mha_backward(q, k, v, dout, dout)
    with pytest.raises(ValueError, match="16-byte aligned"):  # dO read by cp.async too
        vit_attention.mha_backward_tensor_core(k, k, v, q)
    long = torch.randn((1, 129, 1, 64), generator=gen, device=cuda_device).to(torch.bfloat16)
    with pytest.raises(ValueError, match="tensor-core backward"):
        vit_attention.mha_backward_tensor_core(long, long, long, long)
    with pytest.raises(ValueError, match="tensor-core backward"):
        vit_attention.mha_backward_tensor_core(*(t.float() for t in (k, k, v, dout)))
    assert vit_attention.mha_backward.launches == before
    assert vit_attention.mha_backward.routes == routes


@pytest.mark.parametrize("d", [64, 384])
def test_mha_under_grad_launches_the_backward_on_fused_qkv_views(cuda_device, d):
    # whisper's self-attention hands B3 the three views of one fused qkv;
    # under grad the forward and backward read them in place, and the
    # gradient of the fused projection is the plain version's.
    b, n, h = 3, 40, 2
    gen = torch.Generator(device=cuda_device).manual_seed(d)
    qkv = torch.randn((b, n, 3 * h * d), generator=gen, device=cuda_device).to(torch.bfloat16)
    qkv.requires_grad_()
    dout = torch.randn((b, n, h, d), generator=gen, device=cuda_device).to(torch.bfloat16)
    views = [t.view(b, n, h, d) for t in qkv.split(h * d, dim=-1)]
    fwd, bwd = vit_attention.mha.launches, vit_attention.mha_backward.launches
    routes = dict(vit_attention.mha_backward.routes)
    out = vit_attention.mha(*views, causal=True)
    assert out.grad_fn is not None
    (grad,) = torch.autograd.grad(out, qkv, dout)
    torch.cuda.synchronize()
    assert (vit_attention.mha.launches, vit_attention.mha_backward.launches) == (fwd + 1, bwd + 1)
    path = "tensor_core" if d == 64 else "cuda_core"  # ld = 3·H·D: read in place on both
    assert vit_attention.mha_backward.routes == {**routes, path: routes[path] + 1}
    plain = vit_attention.mha_backward_plain(*(t.detach() for t in views), out.detach(), dout,
                                             causal=True)
    want = torch.cat([g.reshape(b, n, h * d) for g in plain], dim=-1)
    assert_grads_close([grad], [want], "bfloat16")
    with torch.no_grad():  # inference: the direct launch, nothing saved
        assert vit_attention.mha(*views, causal=True).grad_fn is None


def test_sharded_train_step_launches_b3_and_its_backward_on_the_tensor_cores(cuda_device):
    # The dp × tp step (parallel/train.py) on a 2 × 2 mesh of cuda:0 at
    # test-tiny: each entry attends over its one head (D 32) forward and
    # backward on the tensor cores, a block's attention an entry, and the
    # loss is the CPU mesh's within 1e-2.
    from panoptikon_tpu_torch.models import clip, convert
    from panoptikon_tpu_torch.parallel import mesh as meshlib
    from panoptikon_tpu_torch.parallel import train

    cfg = clip.CONFIGS["test-tiny"]
    gen = torch.Generator().manual_seed(0)
    images = torch.randn((8, cfg.image_size, cfg.image_size, 3), generator=gen)
    tokens = torch.randint(1, cfg.text_vocab - 1, (8, cfg.text_ctx), generator=gen)
    tokens[:, -1] = cfg.text_vocab - 1
    tree = clip.init_params(cfg, gen)
    rules = clip.param_shard_rules(cfg, 2)
    losses = {}
    for dev in ("cpu", cuda_device):
        mesh = meshlib.train_mesh(2, 2, devs=[torch.device(dev)] * 4)
        shards = convert.shard_params(tree, mesh, rules)
        opts = train.adamw(shards)
        fwd, bwd = vit_attention.mha.launches, vit_attention.mha_backward.launches
        routes = dict(vit_attention.mha_backward.routes)
        losses[str(dev)] = train.train_step(shards, cfg, mesh, opts, images, tokens).item()
    torch.cuda.synchronize()
    per_step = 4 * (cfg.vision_layers + cfg.text_layers)
    assert vit_attention.mha.launches - fwd == per_step
    assert vit_attention.mha_backward.launches - bwd == per_step
    assert vit_attention.mha_backward.routes["tensor_core"] - routes["tensor_core"] == per_step
    assert vit_attention.route(torch.bfloat16, cfg.vision_width // cfg.vision_heads) == \
        "tensor_core"
    assert abs(losses[str(cuda_device)] - losses["cpu"]) <= 1e-2 * abs(losses["cpu"])


def test_kernels_with_no_backward_refuse_grad(cuda_device):
    # B1, B2, B4 and B5 have no backward: under grad each raises, naming
    # itself, instead of returning an output that drops the gradient.
    qkv = torch.randn((2, 8, 3 * 64), device=cuda_device, requires_grad=True)
    with pytest.raises(ValueError, match="mha_qkv"):
        vit_attention.mha_qkv(qkv, heads=1)
    x = torch.randn((8, 64), device=cuda_device, requires_grad=True)
    g, bta = torch.ones(64, device=cuda_device), torch.zeros(64, device=cuda_device)
    with pytest.raises(ValueError, match="ln_quant_2d"):
        ln_quant.ln_quant_2d(x, g, bta, 4.0)
    with pytest.raises(ValueError, match="ln_quant"):
        ln_quant.ln_quant(x.view(2, 4, 64), {"scale": g, "bias": bta}, 4.0)
    codes, q_codes, valid, _ = _b1_inputs(cuda_device, 1000, 64, 4)
    scale = torch.tensor(1.0, device=cuda_device, requires_grad=True)
    sumsq = scoring.row_sumsq(codes)
    with pytest.raises(ValueError, match="int8_topk"):
        int8_scan.int8_topk(codes, sumsq, valid, q_codes, distance="l2", scale=scale)
    with pytest.raises(ValueError, match="int8_topk_v2"):
        int8_scan.int8_topk_v2(codes, sumsq, valid, q_codes, distance="l2", scale=scale)
    with torch.no_grad():
        assert vit_attention.mha_qkv(qkv, heads=1).shape == (2, 8, 64)
        assert ln_quant.ln_quant_2d(x, g, bta, 4.0).dtype == torch.int8


def test_kimi_vl_on_the_card_is_the_reference(cuda_device):
    # The tiny Kimi-VL on the card in bf16 (the decode steps replayed as a
    # CUDA graph, kept for the second batch) against
    # the plain f32 reference on the same weights, applying the card's own
    # expert picks: the tolerances of tests/test_torch_kimi_vl.py's bf16 case.
    import json
    from pathlib import Path

    from benchmark.kinds.caption_build import port_config
    from benchmark.references import kimi_vl as ref
    from panoptikon_tpu_torch.models import kimi_vl

    # The test size's configuration file, as the reference reads it.
    ref_cfg = json.loads((Path(__file__).resolve().parents[1] / "benchmark" / "tests" / "data"
                          / "configs" / "tiny-kimi.json").read_text())
    cfg = port_config(ref_cfg)
    assert cfg is kimi_vl.CONFIGS["test-tiny"]
    params = kimi_vl.init_params(cfg, torch.Generator(device=cuda_device).manual_seed(5))
    images = torch.randn((48, cfg.image_size, cfg.image_size, 3), device=cuda_device,
                         generator=torch.Generator(device=cuda_device).manual_seed(6))
    prefix, suffix = (3, 4), (5,)
    decoders: dict = {}
    kimi_vl.generate(params, cfg, images.flip(0), prefix, suffix, 7, (), decoders)
    out = kimi_vl.generate(params, cfg, images, prefix, suffix, 7, tuple(range(48)), decoders)
    assert len(decoders) == 1 and next(iter(decoders.values())).graph is not None
    ids = kimi_vl.prompt_ids(cfg, 48, prefix, suffix, cuda_device)
    full = torch.cat([ids, out["tokens"][:, :6].to(cuda_device)], dim=1)
    _, want, own = ref.forward(params, ref_cfg, images, full, prompt_len=ids.shape[1],
                               logits_from=ids.shape[1] - 1,
                               routes=out["routes"].to(cuda_device))
    want = want.cpu()
    gap = (out["logits"].float() - want).abs().amax(-1) / want.std(-1)
    assert float(gap.max()) < 0.15
    apart = (out["routes"].sort(-1).values != own.cpu().sort(-1).values).any(-1)
    assert float(apart.float().mean()) <= 0.1
