"""Kernel 2 of the port (ops/vit_attention.py) against the JAX Pallas kernel
``mha`` in interpret mode, in all four modes. Tolerances are those of
test_vit_attention.py: 2e-5 in f32; 2e-2 in bf16, where the two frameworks
round to bf16 at different points. test_torch_cuda_kernels.py holds the
CUDA kernel against the plain version."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from panoptikon_tpu.ops import vit_attention as ref
from panoptikon_tpu_torch.ops import vit_attention

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


def test_qkv_fused_fits_is_the_kernels_limit():
    from panoptikon_tpu_torch.models import clip

    for name, cfg in clip.CONFIGS.items():
        assert vit_attention.qkv_fused_fits(cfg.vision_width // cfg.vision_heads), name
        assert vit_attention.qkv_fused_fits(cfg.text_width // cfg.text_heads), name
    # The JAX package's VMEM rule rejects ViT-H-14-378 (N = 730, D = 80); the
    # card's kernel streams keys, so only the head dim bounds it.
    assert not ref.qkv_fused_fits(16, 80, 730)
    assert vit_attention.qkv_fused_fits(80)
    assert not vit_attention.qkv_fused_fits(vit_attention.MAX_HEAD_DIM + 1)
