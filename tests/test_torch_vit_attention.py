"""Kernels B3 and B4 of the port (ops/vit_attention.py) against the JAX
Pallas kernels ``mha`` and ``mha_qkv`` in interpret mode, in all four modes.
Tolerances are those of test_vit_attention.py: 2e-5 in f32; 2e-2 in bf16,
where the two frameworks round to bf16 at different points. The
tensor-core kernel's order of arithmetic, emulated in PyTorch, is held
against the plain version at ViT-L/14's head shape within the card's int8
limits. test_torch_cuda_kernels.py holds the CUDA kernels against the plain
version."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from panoptikon_tpu.ops import vit_attention as ref
from panoptikon_tpu_torch.ops import vit_attention
from panoptikon_tpu_torch.ops.codec import quantize_static

MODES = {
    # name: (b, n_q, n_kv, h, d, causal, masked)
    "self": (2, 33, 33, 4, 64, False, False),
    "causal": (2, 17, 17, 2, 64, True, False),
    "masked": (3, 21, 21, 4, 32, False, True),
    "cross": (2, 12, 40, 4, 32, False, False),
}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(mode, seed=0):
    b, nq, nkv, h, d, causal, masked = MODES[mode]
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, nq, h, d)).astype(np.float32)
    k = rng.normal(size=(b, nkv, h, d)).astype(np.float32)
    v = rng.normal(size=(b, nkv, h, d)).astype(np.float32)
    mask = None
    if masked:
        mask = rng.random((b, nkv)) < 0.7
        mask[:, 0] = True
        mask[-1] = False  # a fully masked row: uniform weights, never NaN
    return q, k, v, causal, mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", list(MODES))
def test_plain_matches_pallas_kernel(mode, dtype):
    q, k, v, causal, mask = _inputs(mode)
    np_dt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    want = ref.mha(
        jnp.asarray(q.astype(np_dt)), jnp.asarray(k.astype(np_dt)), jnp.asarray(v.astype(np_dt)),
        causal=causal, key_mask=None if mask is None else jnp.asarray(mask), interpret=True,
    )
    tdt = getattr(torch, dtype)
    got = vit_attention.mha_plain(
        torch.from_numpy(q).to(tdt), torch.from_numpy(k).to(tdt), torch.from_numpy(v).to(tdt),
        causal=causal, key_mask=None if mask is None else torch.from_numpy(mask),
    )
    assert got.dtype == tdt
    got = got.to(torch.float32).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=TOL[dtype], atol=TOL[dtype])


WIDE_MODES = {
    # name: (b, n_q, n_kv, h, causal, masked); cross at the captioner's
    # teacher-forced rows (48 tokens over 50 vision tokens)
    "self": (2, 19, 19, 2, False, False),
    "causal": (2, 17, 17, 2, True, False),
    "cross": (1, 48, 50, 2, False, False),
    "masked": (3, 21, 21, 2, False, True),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [160, 256, 384, 512])
@pytest.mark.parametrize("mode", list(WIDE_MODES))
def test_plain_matches_pallas_kernel_past_head_dim_128(mode, d, dtype):
    # The head dims of the CUDA-core kernel's wide instantiation (the
    # captioner's decoder: D 384), against the JAX mha that ``attention``
    # runs on the TPU, in interpret mode, at the same tolerances.
    b, nq, nkv, h, causal, masked = WIDE_MODES[mode]
    rng = np.random.default_rng(d)
    q, k, v = (rng.normal(size=(b, n, h, d)).astype(np.float32) for n in (nq, nkv, nkv))
    mask = None
    if masked:
        mask = rng.random((b, nkv)) < 0.7
        mask[:, 0] = True
        mask[-1] = False
    np_dt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    want = ref.mha(*(jnp.asarray(a.astype(np_dt)) for a in (q, k, v)), causal=causal,
                   key_mask=None if mask is None else jnp.asarray(mask), interpret=True)
    tdt = getattr(torch, dtype)
    got = vit_attention.mha_plain(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                                  causal=causal,
                                  key_mask=None if mask is None else torch.from_numpy(mask))
    assert got.dtype == tdt and vit_attention.route(tdt, d) == "cuda_core"
    got = got.to(torch.float32).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=TOL[dtype], atol=TOL[dtype])


def test_wrapper_takes_plain_version_on_cpu():
    q, k, v, causal, mask = _inputs("masked", seed=1)
    args = [torch.from_numpy(a) for a in (q, k, v)]
    before = vit_attention.mha.launches
    got = vit_attention.mha(*args, key_mask=torch.from_numpy(mask))
    want = vit_attention.mha_plain(*args, key_mask=torch.from_numpy(mask))
    assert torch.equal(got, want)
    assert torch.equal(vit_attention.attention(*args, causal=True),
                       vit_attention.mha_plain(*args, causal=True))
    assert vit_attention.mha.launches == before


def test_wrapper_rejects_bad_inputs():
    q, k, v, _, _ = _inputs("cross")
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    with pytest.raises(ValueError):  # causal needs N_q == N_kv
        vit_attention.mha(tq, tk, tv, causal=True)
    with pytest.raises(ValueError):
        vit_attention.mha(tq, tk.to(torch.bfloat16), tv)
    with pytest.raises(ValueError):  # neither CPU nor CUDA: no silent fallback
        vit_attention.mha(tq.to("meta"), tk.to("meta"), tv.to("meta"))



def _bf16_ulp(x):
    """The spacing of bf16 values at |x| (8 significant bits)."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(x), np.finfo(np.float32).tiny))) - 7)


@pytest.mark.parametrize("d", [16, 64])
def test_mha_bf16_bit_parity_with_pallas_kernel(d):
    # Head dims under 32 run in f32 in the reference (p is not rounded to
    # V's bf16); the port must follow, or some 40 % of the outputs at D=16
    # land an ulp or more away. An output near zero sums terms far larger
    # than itself, so the f32 summation order moves it by more than its own
    # ulp: the ulp is taken at no less than 1/8, the outputs' typical size.
    rng = np.random.default_rng(11)
    q, k, v = (rng.normal(size=(4, 300, 2, d)).astype(ml_dtypes.bfloat16) for _ in range(3))
    want = np.asarray(ref.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True),
                      np.float32)
    got = vit_attention.mha_plain(
        *(torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16) for a in (q, k, v)))
    got = got.to(torch.float32).numpy()
    assert (got == want).mean() >= 0.995, (got == want).mean()
    assert (np.abs(got - want) <= _bf16_ulp(np.maximum(np.abs(want), 0.125))).all()


QKV_CASES = {
    # name: (b, n, h, d, causal)
    "image": (2, 33, 2, 32, False),
    "text_causal": (2, 17, 2, 32, True),
    "head_dim_16": (2, 9, 2, 16, True),
}


def _qkv(case, seed=0):
    b, n, h, d, causal = QKV_CASES[case]
    rng = np.random.default_rng(seed)
    return rng.normal(size=(b, n, 3 * h * d)).astype(np.float32), h, causal


@pytest.mark.parametrize("out", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("case", list(QKV_CASES))
def test_mha_qkv_plain_matches_pallas_kernel(case, out):
    qkv, h, causal = _qkv(case)
    in_dt = "bfloat16" if out == "bfloat16" else "float32"
    np_dt = ml_dtypes.bfloat16 if in_dt == "bfloat16" else np.float32
    scale = 2.5 if out == "int8" else None
    want = np.asarray(ref.mha_qkv(jnp.asarray(qkv.astype(np_dt)), heads=h, causal=causal,
                                  out_scale=scale, interpret=True))
    got = vit_attention.mha_qkv_plain(torch.from_numpy(qkv).to(getattr(torch, in_dt)), heads=h,
                                      causal=causal, out_scale=scale)
    assert got.dtype == (torch.int8 if out == "int8" else getattr(torch, in_dt))
    if out == "int8":
        assert np.abs(got.numpy().astype(np.int32) - want.astype(np.int32)).max() <= 1
    else:
        np.testing.assert_allclose(got.to(torch.float32).numpy(), want.astype(np.float32),
                                   rtol=TOL[out], atol=TOL[out])


def test_mha_qkv_wrapper_takes_plain_version_on_cpu():
    qkv, h, causal = _qkv("text_causal", seed=1)
    t = torch.from_numpy(qkv)
    before = vit_attention.mha_qkv.launches
    for scale in (None, torch.tensor(3.0)):
        got = vit_attention.mha_qkv(t, heads=h, causal=causal, out_scale=scale)
        assert torch.equal(got, vit_attention.mha_qkv_plain(t, heads=h, causal=causal, out_scale=scale))
    assert vit_attention.mha_qkv.launches == before
    with pytest.raises(ValueError):  # 3·H·D must split into H heads
        vit_attention.mha_qkv(t[..., :-1], heads=h)
    with pytest.raises(ValueError):  # neither CPU nor CUDA: no silent fallback
        vit_attention.mha_qkv(t.to("meta"), heads=h)


def _kernel_order_attention(q, k, v, causal=False, key_mask=None, smem_logits=True, tile=64):
    """The tensor-core kernel's order of arithmetic (csrc/attention.cu,
    ``mha_tc_kernel``) in PyTorch, in f32 with p rounded to bf16.

    Logits l = (q·k)·D^-0.5 (causal −inf, then the additive −1e9 key mask;
    padded keys −inf) by 64-key tiles. Lane t of a row's four owns columns
    8n + 2t and 8n + 2t + 1 (n = 0..7) of every tile and sums its
    exponentials in that order; the four sums are added (s0 + s1) + (s2 +
    s3). With ``smem_logits`` the row max m comes first and each lane sums
    exp(l − m); in the two-pass form m grows tile by tile (the four lanes
    agree on it) and a lane's sum is rescaled by exp(m_old − m_new) when it
    does. Then p = exp(l − m) / s rounded to bf16, and p·V accumulated in
    f32. The products' own summation order (the tensor cores') is not
    emulated."""
    b, n_q, h, d = q.shape
    n_kv = k.shape[1]
    lt = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (float(d) ** -0.5)
    if causal:
        keep = torch.arange(n_kv)[None, :] <= torch.arange(n_q)[:, None]
        lt = torch.where(keep, lt, -torch.inf)
    if key_mask is not None:
        lt = torch.where(key_mask[:, None, None, :], lt, lt - 1e9)
    n_pad = -(-n_kv // tile) * tile
    lt = torch.nn.functional.pad(lt, (0, n_pad - n_kv), value=-torch.inf)
    m = lt.amax(-1) if smem_logits else torch.full((b, h, n_q), -torch.inf)
    s = torch.zeros((4, b, h, n_q))
    for j0 in range(0, n_pad, tile):
        lj = lt[..., j0:j0 + tile]
        mn = m if smem_logits else torch.maximum(m, lj.amax(-1))
        live = mn > -torch.inf
        alpha = torch.where(live, torch.exp(m - mn), 0.0)
        for t in range(4):
            ts = torch.zeros_like(m)
            for c in (8 * nt + 2 * t + e for nt in range(tile // 8) for e in range(2)):
                ts = ts + torch.where(live, torch.exp(lj[..., c] - mn), 0.0)
            s[t] = torch.where(live, s[t] * alpha + ts, s[t])
        m = mn
    total = (s[0] + s[1]) + (s[2] + s[3])
    p = (torch.exp(lt - m[..., None]) / total[..., None]).to(torch.bfloat16).float()
    return torch.einsum("bhqk,bkhd->bqhd", p[..., :n_kv], v.float())


def _split_qkv(qkv, heads):
    b, n, w3 = qkv.shape
    return tuple(t.reshape(b, n, heads, w3 // 3 // heads) for t in qkv.split(w3 // 3, dim=-1))


@pytest.mark.parametrize("smem_logits", [True, False])
@pytest.mark.parametrize("causal", [False, True])
def test_kernel_order_matches_plain_at_vit_l14_head_shape(causal, smem_logits):
    # The tensor-core kernel normalises before it rounds p, as the
    # reference; its int8 codes stay within the card's limits of the plain
    # version at ViT-L/14's head shape (N = 257, H = 16, D = 64).
    rng = np.random.default_rng(21)
    qkv = torch.from_numpy(rng.normal(size=(2, 257, 3 * 16 * 64)).astype(np.float32))
    qkv = qkv.to(torch.bfloat16)
    scale = torch.tensor(3.0)
    got = _kernel_order_attention(*_split_qkv(qkv, 16), causal=causal, smem_logits=smem_logits)
    codes = quantize_static(got.reshape(2, 257, -1), scale)
    want = vit_attention.mha_qkv_plain(qkv, heads=16, causal=causal, out_scale=scale)
    diff = (codes.to(torch.int32) - want.to(torch.int32)).abs()
    assert diff.max().item() <= 1 and (diff > 0).float().mean().item() <= 5e-3
    want_bf16 = vit_attention.mha_qkv_plain(qkv, heads=16, causal=causal)
    torch.testing.assert_close(got.reshape(2, 257, -1).to(torch.bfloat16).float(),
                               want_bf16.float(), rtol=2e-2, atol=2e-2)


def test_one_pass_rounding_would_break_the_int8_limit():
    # FlashAttention-2's usual form rounds the unnormalised exp(l − m) to
    # bf16 and divides by the sum at the end. At ViT-L/14's head shape that
    # moves more of mha_qkv's int8 codes than the card's checks allow
    # (0.5 %), which is why the kernel finds the row's max and sum first.
    rng = np.random.default_rng(21)
    qkv = torch.from_numpy(rng.normal(size=(2, 257, 3 * 16 * 64)).astype(np.float32))
    qkv = qkv.to(torch.bfloat16)
    q, k, v = (t.float() for t in _split_qkv(qkv, 16))
    lt = torch.einsum("bqhd,bkhd->bhqk", q, k) * 64 ** -0.5
    e = torch.exp(lt - lt.amax(-1, keepdim=True))
    out = torch.einsum("bhqk,bkhd->bqhd", e.to(torch.bfloat16).float(), v)
    out = out / e.sum(-1).permute(0, 2, 1)[..., None]
    scale = torch.tensor(3.0)
    codes = quantize_static(out.reshape(2, 257, -1), scale)
    want = vit_attention.mha_qkv_plain(qkv, heads=16, out_scale=scale)
    assert (codes != want).float().mean().item() > 5e-3


@pytest.mark.parametrize("smem_logits", [True, False])
@pytest.mark.parametrize("case", ["image", "text_causal"])
def test_kernel_order_matches_pallas_kernel(case, smem_logits):
    qkv, h, causal = _qkv(case, seed=3)
    qkv_bf16 = qkv.astype(ml_dtypes.bfloat16)
    got = _kernel_order_attention(
        *_split_qkv(torch.from_numpy(qkv).to(torch.bfloat16), h), causal=causal,
        smem_logits=smem_logits)
    b, n, _ = qkv.shape
    want = np.asarray(ref.mha_qkv(jnp.asarray(qkv_bf16), heads=h, causal=causal, interpret=True),
                      np.float32)
    np.testing.assert_allclose(got.reshape(b, n, -1).to(torch.bfloat16).float().numpy(), want,
                               rtol=2e-2, atol=2e-2)
    codes = np.asarray(ref.mha_qkv(jnp.asarray(qkv_bf16), heads=h, causal=causal,
                                   out_scale=2.5, interpret=True))
    mine = quantize_static(got.reshape(b, n, -1), torch.tensor(2.5)).numpy()
    assert np.abs(mine.astype(np.int32) - codes.astype(np.int32)).max() <= 1


@pytest.mark.parametrize("smem_logits", [True, False])
def test_kernel_order_key_mask_with_a_fully_masked_row(smem_logits):
    q, k, v, _, mask = _inputs("masked", seed=4)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = _kernel_order_attention(tq, tk, tv, key_mask=torch.from_numpy(mask),
                                  smem_logits=smem_logits)
    want = vit_attention.mha_plain(tq, tk, tv, key_mask=torch.from_numpy(mask))
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.to(torch.bfloat16).float(), want.float(), rtol=2e-2, atol=2e-2)


def test_route_follows_dtype_and_head_dim():
    # Decided before a launch, from the dtype and D alone: bf16 with D a
    # multiple of 16 in [32, 128] on the tensor cores; f32 (held to 2e-5)
    # and the other head dims (p in f32 below 32; 128 < D <= 512, the wide
    # instantiation) on the CUDA cores.
    for d in (32, 48, 64, 80, 96, 112, 128):
        assert vit_attention.route(torch.bfloat16, d) == "tensor_core"
        assert vit_attention.route(torch.float32, d) == "cuda_core"
    for d in (1, 8, 16, 24, 40, 72, 100, 129, 160, 384, 512):
        assert vit_attention.route(torch.bfloat16, d) == "cuda_core"
    # Past 512 no kernel takes the head dim: the route raises before any
    # launch, and mha never falls back to its plain version on the card.
    for dtype in (torch.bfloat16, torch.float32):
        assert vit_attention.route(dtype, vit_attention.MAX_HEAD_DIM) == "cuda_core"
        with pytest.raises(ValueError, match="D <= 512"):
            vit_attention.route(dtype, vit_attention.MAX_HEAD_DIM + 1)
    from panoptikon_tpu_torch.models import clip

    for cfg in clip.CONFIGS.values():
        if cfg.vision_width >= 32 * cfg.vision_heads:  # every CLIP tower but test-tiny's
            assert vit_attention.route(torch.bfloat16, cfg.vision_width // cfg.vision_heads) \
                == "tensor_core"
    assert set(vit_attention.mha.routes) == set(vit_attention.mha_qkv.routes) == \
        set(vit_attention.ROUTES)


# B3's backward routes: (dtype, D, N_q, N_kv) -> the kernel a CUDA call
# launches. The tensor cores take the forward's head dims in bf16 up to
# BWD_TC_MAX_ROWS (128) query rows and keys; the CUDA cores take f32, the
# other head dims and longer rows.
BACKWARD_ROUTE_EDGES = {
    "n_1": (torch.bfloat16, 64, 1, 1, "tensor_core"),
    "n_63": (torch.bfloat16, 64, 63, 63, "tensor_core"),
    "n_64": (torch.bfloat16, 64, 64, 64, "tensor_core"),
    "n_65": (torch.bfloat16, 64, 65, 65, "tensor_core"),
    "n_128": (torch.bfloat16, 64, 128, 128, "tensor_core"),
    "n_129": (torch.bfloat16, 64, 129, 129, "cuda_core"),
    "cross_1x128": (torch.bfloat16, 64, 1, 128, "tensor_core"),
    "cross_63x128": (torch.bfloat16, 64, 63, 128, "tensor_core"),
    "cross_63x129": (torch.bfloat16, 64, 63, 129, "cuda_core"),
    "cross_129x1": (torch.bfloat16, 64, 129, 1, "cuda_core"),
    "d_32": (torch.bfloat16, 32, 128, 128, "tensor_core"),
    "d_48": (torch.bfloat16, 48, 50, 50, "tensor_core"),
    "d_80": (torch.bfloat16, 80, 50, 50, "tensor_core"),
    "d_128": (torch.bfloat16, 128, 128, 128, "tensor_core"),
    "d_16": (torch.bfloat16, 16, 50, 50, "cuda_core"),
    "d_40": (torch.bfloat16, 40, 50, 50, "cuda_core"),
    "d_144": (torch.bfloat16, 144, 50, 50, "cuda_core"),
    "d_384": (torch.bfloat16, 384, 48, 48, "cuda_core"),
    "f32_d64": (torch.float32, 64, 50, 50, "cuda_core"),
    "f32_d16": (torch.float32, 16, 300, 300, "cuda_core"),
}


def _phase_16_shapes():
    from chip_smoke import BWD_CASES

    return {name: (getattr(torch, dtype), d, nq, nkv)
            for name, (_, nq, nkv, _, d, _, _, dtype) in BWD_CASES.items()}


@pytest.mark.parametrize("case", [*_phase_16_shapes(), *BACKWARD_ROUTE_EDGES])
def test_backward_route_follows_dtype_head_dim_and_rows(case):
    # Decided before a launch, as the forward's route: the forward's own
    # test (bf16, D a multiple of 16 in [32, 128]) and N_q, N_kv <= 128.
    # Every shape training gives B3 (phase 16's bf16 shapes at D 64 and the
    # key-masked D 32) takes the tensor cores; D 384 and f32 do not.
    if case in BACKWARD_ROUTE_EDGES:
        dtype, d, nq, nkv, want = BACKWARD_ROUTE_EDGES[case]
    else:
        dtype, d, nq, nkv = _phase_16_shapes()[case]
        want = ("tensor_core" if dtype == torch.bfloat16 and d in (32, 64) else "cuda_core")
    assert vit_attention.backward_route(dtype, d, nq, nkv) == want
    assert vit_attention.BWD_TC_MAX_ROWS == 128
    if want == "tensor_core":
        assert vit_attention.route(dtype, d) == "tensor_core"
    with pytest.raises(ValueError, match="D <= 512"):
        vit_attention.backward_route(dtype, vit_attention.MAX_HEAD_DIM + 1, nq, nkv)


def test_backward_launchers_take_only_cuda_tensors():
    # On the CPU mha_backward takes the plain version; each kernel's
    # launcher raises there (and counts nothing) rather than fall back.
    q, k, v, _, _ = _inputs("self")
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    before = (vit_attention.mha_backward.launches, dict(vit_attention.mha_backward.routes))
    for launch in (vit_attention.mha_backward_tensor_core, vit_attention.mha_backward_cuda_core):
        with pytest.raises(ValueError, match="CUDA"):
            launch(tq, tk, tv, tq)
    assert (vit_attention.mha_backward.launches, vit_attention.mha_backward.routes) == before
    assert set(vit_attention.mha_backward.routes) == set(vit_attention.ROUTES)


@pytest.mark.parametrize("b, n", [(4, 1), (1, 1), (1, 5), (4, 5), (3, 1500)])
def test_row_stride_of_fused_qkv_views(b, n):
    # The views of one fused (B, N, 3·H·D) qkv share the row stride 3·H·D,
    # N = 1 included (a decoder's one-token step: PyTorch reports any stride
    # for the length-1 axis, so the batch axis gives it); the kernel's
    # addressing, (b·N + i)·ld + head·D + c from each view's base, reads
    # every element of each view.
    h, d = 2, 64
    qkv = torch.arange(b * n * 3 * h * d, dtype=torch.float32).reshape(b, n, 3 * h * d)
    views = [t.view(b, n, h, d) for t in qkv.split(h * d, dim=-1)]
    ld = vit_attention.row_stride(*views)
    assert ld == (h * d if b == n == 1 else 3 * h * d)
    for t in views:
        assert torch.equal(t.as_strided(t.shape, (n * ld, ld, d, 1)), t)
    # Contiguous heads (a cross-attention's q of one token beside its own
    # keys) share H·D; views of two different projections share nothing.
    q = torch.zeros(b, 1, h, d)
    kv = [torch.zeros(b, 7, h, d)] * 2
    assert vit_attention.row_stride(q, *kv) == h * d
    if b > 1:
        fused_kv = torch.zeros(b, 7, 2 * h * d).split(h * d, dim=-1)
        assert vit_attention.row_stride(views[0][:, :1], *(t.view(b, 7, h, d) for t in fused_kv)) \
            is None


def test_qkv_fused_fits_is_the_kernels_limit():
    from panoptikon_tpu_torch.models import clip

    for name, cfg in clip.CONFIGS.items():
        assert vit_attention.qkv_fused_fits(cfg.vision_width // cfg.vision_heads), name
        assert vit_attention.qkv_fused_fits(cfg.text_width // cfg.text_heads), name
    # The JAX package's VMEM rule rejects ViT-H-14-378 (N = 730, D = 80); the
    # card's kernel streams keys, so only the head dim bounds it.
    assert not ref.qkv_fused_fits(16, 80, 730)
    assert vit_attention.qkv_fused_fits(80)
    # mha_qkv keeps the 128 limit past which mha's CUDA-core kernel widens.
    assert vit_attention.qkv_fused_fits(vit_attention.QKV_MAX_HEAD_DIM)
    assert not vit_attention.qkv_fused_fits(vit_attention.QKV_MAX_HEAD_DIM + 1)
    assert not vit_attention.qkv_fused_fits(vit_attention.MAX_HEAD_DIM + 1)


def test_mha_under_grad_on_the_cpu_gives_the_plain_gradients():
    # On the CPU mha under grad runs the Function the card runs: mha_plain
    # forward, mha_backward_plain backward. In f32 its gradients are
    # autograd's of mha_plain (within the sums' order); q, k, v may be the
    # views of one fused projection, as whisper passes them.
    b, n, h, d = 2, 24, 2, 64
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(rng.normal(size=(b, n, 3 * h * d)).astype(np.float32))
    dout = torch.from_numpy(rng.normal(size=(b, n, h, d)).astype(np.float32))
    grads = []
    for fn in (vit_attention.mha, vit_attention.mha_plain):
        x = qkv.clone().requires_grad_()
        views = [t.view(b, n, h, d) for t in x.split(h * d, dim=-1)]
        before = vit_attention.mha_backward.launches
        (grad,) = torch.autograd.grad(fn(*views, causal=True), x, dout)
        assert vit_attention.mha_backward.launches == before  # the CPU launches nothing
        grads.append(grad.numpy())
    scale = np.abs(grads[1]).max()
    assert np.abs(grads[0] - grads[1]).max() <= 2e-5 * scale
    with torch.no_grad():  # inference: no Function, nothing saved
        x = qkv.clone().requires_grad_()
        assert vit_attention.mha(*[t.view(b, n, h, d) for t in x.split(h * d, dim=-1)]
                                 ).grad_fn is None


def test_refuse_grad_names_the_kernel():
    # The guard of the kernels with no backward (B1, B2, B4, B5 on the card):
    # under grad a tensor that requires it raises, naming the kernel; under
    # no_grad, or with no such tensor, nothing happens.
    from panoptikon_tpu_torch.ops import refuse_grad

    x = torch.ones(3, requires_grad=True)
    with pytest.raises(ValueError, match="mha_qkv"):
        refuse_grad("mha_qkv", x, 2.0)
    refuse_grad("mha_qkv", x.detach(), None, 2.0)
    with torch.no_grad():
        refuse_grad("mha_qkv", x)
