"""Int8 vector codec on tensors — the port of ``ops/codec.py``'s device half.

``quantize_int8`` is bit-identical to the host codec's ``quantize_int8`` and
to ``quantize_int8_jax``: ``clamp(rint(x / s), -128, 127)`` with
round-half-to-even (``torch.round``), NaN mapped to 0 by an explicit select
before the cast (a float->int8 cast of NaN is undefined), and the clamp before
the cast so the cast is exact. The division runs in f32 against an f32 scale,
as NumPy's ``x / np.float32(scale)`` does.

:func:`quantize_static` is the other int8 codec of the port: the static
per-tensor activation quantization of the calibrated int8 CLIP block,
``clip(round(x / max(s / 127, 1e-12)), -127, 127)``, which the JAX package
writes out in ``models/clip.py::_linear``, ``ops/ln_quant.py`` and the
epilogue of ``ops/vit_attention.py::mha_qkv``.

The host codec (scale derivation, the scale artifact, NumPy quantization for
index builds) is jax-free and re-exported from the JAX package unchanged.
"""

from __future__ import annotations

import torch

from panoptikon_tpu.ops.codec import (  # noqa: F401  (re-exported host codec)
    ARTIFACT_MIN_VECTORS,
    INT8_MAX_CODE,
    artifact_scale,
    compute_query_quant,
    corpus_absmax,
    scale_artifact,
    scale_from_absmax,
)
from panoptikon_tpu.ops.codec import quantize_int8 as quantize_int8_host  # noqa: F401


def quantize_int8(vectors: torch.Tensor, scale: float) -> torch.Tensor:
    """f32 vectors -> int8 codes under ``scale``, on the tensor's device."""
    x = vectors.to(torch.float32)
    codes = torch.round(x / torch.tensor(scale, dtype=torch.float32, device=x.device))
    codes = torch.where(torch.isnan(codes), torch.zeros_like(codes), codes)
    return codes.clamp(-128.0, INT8_MAX_CODE).to(torch.int8)


def dequantize_int8(codes: torch.Tensor, scale: float) -> torch.Tensor:
    return codes.to(torch.float32) * torch.tensor(scale, dtype=torch.float32, device=codes.device)


def static_step(act_scale, device) -> torch.Tensor:
    """The quantization step of a calibrated absmax: ``max(s / 127, 1e-12)``,
    an f32 scalar tensor on ``device`` (``act_scale`` may stay on the device:
    nothing is read back)."""
    s = torch.as_tensor(act_scale, dtype=torch.float32, device=device)
    return torch.clamp(s / 127.0, min=1e-12)


def quantize_static(x: torch.Tensor, act_scale) -> torch.Tensor:
    """Activations -> int8 at a static per-tensor absmax: the f32 division is
    correctly rounded and ``torch.round`` rounds half to even, as ``jnp.round``."""
    sx = static_step(act_scale, x.device)
    return torch.clamp(torch.round(x.to(torch.float32) / sx), -127.0, 127.0).to(torch.int8)
