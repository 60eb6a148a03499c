"""Kernel B5 of the port (ops/ln_quant.py) against the JAX Pallas kernel
``ln_quant_2d`` in interpret mode and its jnp reference ``_ln_quant_ref``,
on the same seeded bf16 rows. Same math, different sum order: codes may
differ by one on a rounding boundary (the JAX kernel's own test allows the
same), so the limits are |Δcode| ≤ 1 with at least 99.9 % identical; on
these inputs 0 to 2.9e-6 of the codes differ, by one. test_torch_cuda_kernels.py
holds the CUDA kernel against the plain version."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from panoptikon_tpu.ops import ln_quant as ref
from panoptikon_tpu_torch.ops import ln_quant


def _inputs(r, w, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(r, w)) * 3.0).astype(ml_dtypes.bfloat16)
    g = rng.normal(size=w).astype(np.float32)
    b = rng.normal(size=w).astype(np.float32)
    return x, g, b, np.float32(4.2)


def _torch(x, g, b):
    return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16), torch.from_numpy(g), torch.from_numpy(b)


def _code_diff(got, want):
    diff = np.abs(got.astype(np.int32) - np.asarray(want).astype(np.int32))
    return diff.max(), (diff > 0).mean()


@pytest.mark.parametrize("r,w", [(1024, 1024), (300, 768), (1000, 1280)])
def test_plain_matches_pallas_kernel_and_reference(r, w):
    x, g, b, s = _inputs(r, w)
    got = ln_quant.ln_quant_plain(*_torch(x, g, b), float(s))
    assert got.dtype == torch.int8 and tuple(got.shape) == (r, w)
    got = got.numpy()
    for want in (ref.ln_quant_2d(jnp.asarray(x), g, b, s, interpret=True),
                 ref._ln_quant_ref(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), s)):
        worst, share = _code_diff(got, want)
        assert worst <= 1 and share <= 1e-3, (worst, share)


def test_saturation_and_tiny_scale():
    x, g, b, _ = _inputs(64, 256, seed=1)
    for s in (np.float32(0.5), np.float32(0.0)):  # saturates; sx floors at 1e-12
        got = ln_quant.ln_quant_plain(*_torch(x, g, b), float(s)).numpy()
        want = np.asarray(ref._ln_quant_ref(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), s))
        assert np.abs(got).max() == 127
        assert _code_diff(got, want)[0] <= 1


def _planted_betas(sx):
    """β whose quotient by the step sx lands on every half-integer k + 0.5
    in [-128.5, 127.5] and one ulp either side, and on and past the ±127
    clamp (the card test plants the same)."""
    exact = ((np.arange(-129, 128, dtype=np.float64) + 0.5) * sx).astype(np.float32)
    clamp = (np.array([126.5, 127, 127.49, 127.5, 128, 1000, 1e30]) * sx).astype(np.float32)
    return np.concatenate([exact, np.nextafter(exact, np.float32(np.inf)),
                           np.nextafter(exact, np.float32(-np.inf)), clamp, -clamp])


@pytest.mark.parametrize("s", [15.875, 4.2])
def test_planted_half_integers_match_the_reference(s):
    # With γ = 0 the LN output is β exactly, so y / sx sits on (s = 15.875:
    # sx = 1/8) or within an ulp of (s = 4.2) every rounding boundary: the
    # plain version's codes, which the kernel must keep, equal the JAX
    # reference's, half to even.
    sx = np.maximum(np.float32(s) / np.float32(127), np.float32(1e-12))
    beta = _planted_betas(float(sx))
    w = beta.size
    x, _, _, _ = _inputs(16, w, seed=4)
    g = np.zeros(w, np.float32)
    got = ln_quant.ln_quant_plain(*_torch(x, g, beta), float(s)).numpy()
    want = np.asarray(ref._ln_quant_ref(jnp.asarray(x), jnp.asarray(g), jnp.asarray(beta),
                                        np.float32(s)))
    assert np.array_equal(got, want)
    half = np.rint(np.arange(-129, 128) + 0.5)  # half to even, before the clamp
    if s == 15.875:
        assert np.array_equal(got[0, :257], np.clip(half, -127, 127).astype(np.int8))
    assert np.abs(got).max() == 127


def test_nd_wrapper_and_cpu_dispatch():
    x, g, b, s = _inputs(2 * 7, 128, seed=2)
    tx, tg, tb = _torch(x, g, b)
    before = ln_quant.ln_quant_2d.launches
    out = ln_quant.ln_quant(tx.reshape(2, 7, 128), {"scale": tg, "bias": tb}, torch.tensor(s))
    assert out.shape == (2, 7, 128) and out.dtype == torch.int8
    assert torch.equal(out.reshape(14, 128), ln_quant.ln_quant_plain(tx, tg, tb, s))
    assert ln_quant.ln_quant_2d.launches == before  # the CPU takes the plain version


def test_wrapper_rejects_bad_inputs():
    x, g, b, s = _inputs(8, 64, seed=3)
    tx, tg, tb = _torch(x, g, b)
    with pytest.raises(ValueError):
        ln_quant.ln_quant_2d(tx, tg[:10], tb, s)
    with pytest.raises(ValueError):
        ln_quant.ln_quant_2d(tx.to(torch.int32), tg, tb, s)
    with pytest.raises(ValueError):  # neither CPU nor CUDA: no silent fallback
        ln_quant.ln_quant_2d(tx.to("meta"), tg.to("meta"), tb.to("meta"), s)
