"""The port's tensor codec is bit-identical to the host codec and to the JAX
device codec (panoptikon_tpu/ops/codec.py)."""

import numpy as np
import pytest
import torch

from panoptikon_tpu.ops import codec as ref
from panoptikon_tpu_torch.ops import codec


def _cases():
    rng = np.random.default_rng(0)
    normal = rng.normal(size=(64, 48)).astype(np.float32)
    scale = ref.scale_from_absmax(ref.corpus_absmax(normal))
    s = np.float32(0.5)
    edge = np.array(
        [np.nan, np.inf, -np.inf, 0.0, -0.0,
         0.5, 1.5, 2.5, -0.5, -1.5, -2.5,       # ties at .5 round to even
         126.5, 127.49, 127.5, 128.0, 1e9,       # saturation at +127
         -127.5, -128.0, -128.5, -129.0, -1e9],  # saturation at -128
        dtype=np.float32,
    ) * s
    return [(normal, scale), (normal * 3.0, scale), (edge[None, :], float(s))]


@pytest.mark.parametrize("case", range(3))
def test_quantize_matches_host_and_jax(case):
    x, scale = _cases()[case]
    got = codec.quantize_int8(torch.from_numpy(x), scale).numpy()
    np.testing.assert_array_equal(got, ref.quantize_int8(x, scale))
    np.testing.assert_array_equal(got, np.asarray(ref.quantize_int8_jax(x, scale)))
    assert got.dtype == np.int8


def test_dequantize_matches_jax():
    codes = np.arange(-128, 128, dtype=np.int8).reshape(16, 16)
    got = codec.dequantize_int8(torch.from_numpy(codes), 0.0123).numpy()
    np.testing.assert_array_equal(got, np.asarray(ref.dequantize_int8_jax(codes, 0.0123)))
    np.testing.assert_array_equal(got, ref.dequantize_int8(codes, 0.0123))


def test_host_codec_is_reexported():
    # The host codec is the port's own copy (it imports nothing of the JAX
    # package) under the names the port has always exported, and it gives
    # the reference's codes (test_torch_host_copies.py holds it in full).
    for fn in (codec.scale_from_absmax, codec.quantize_int8_host, codec.corpus_absmax):
        assert fn.__module__ == "panoptikon_tpu_torch.ops.codec"
    x, scale = _cases()[0]
    np.testing.assert_array_equal(codec.quantize_int8_host(x, scale), ref.quantize_int8(x, scale))
