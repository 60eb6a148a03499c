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

