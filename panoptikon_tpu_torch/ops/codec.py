"""Int8 vector codec — the port of ``panoptikon_tpu/ops/codec.py``.

The reference stores every embedding space as int8 codes under one frozen
per-space scale (global symmetric absmax quantization), byte-compatible
with ``panoptikon/src/db/vector_quants.rs:1446-1511``:

- ``scale = absmax / 127`` puts the corpus absmax exactly on +127; a
  degenerate all-zero (or non-finite-absmax) corpus yields scale 1.0 so
  every code is zero rather than dividing by zero.
- codes are ``clamp(rint(x / s), -128, 127)`` with round-half-to-even;
  clamping absorbs out-of-range *query* components.
- the scale artifact is the 4-byte little-endian f32 payload; reading
  rejects anything that is not a usable positive finite scale.

Two halves, bit-identical to each other and to the JAX package's codec:

- the host half (NumPy: scale derivation, the scale artifact,
  :func:`quantize_int8_host` for index builds) is the port's own copy of the
  reference's host path: :func:`corpus_absmax` and
  :func:`quantize_int8_host` stream through the native C++ codec
  (``panoptikon_tpu_torch.native``, built at first use with the host
  compiler) where it builds, as the reference's ``_native()`` does, and
  keep the NumPy path where it does not; the NumPy path stays the semantic
  reference (the two agree bit for bit). :data:`native_calls` counts the
  calls that took the native path;
- the tensor half: :func:`quantize_int8` is ``clamp(rint(x / s), -128,
  127)`` with round-half-to-even (``torch.round``), NaN mapped to 0 by an
  explicit select before the cast (a float->int8 cast of NaN is undefined),
  and the clamp before the cast so the cast is exact. The division runs in
  f32 against an f32 scale, as NumPy's ``x / np.float32(scale)`` does.

:func:`quantize_static` is the other int8 codec of the port: the static
per-tensor activation quantization of the calibrated int8 CLIP block,
``clip(round(x / max(s / 127, 1e-12)), -127, 127)``, which the JAX package
writes out in ``models/clip.py::_linear``, ``ops/ln_quant.py`` and the
epilogue of ``ops/vit_attention.py::mha_qkv``.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

INT8_MAX_CODE = 127.0

# The artifact only freezes once a space is statistically "real"; below this
# the reconcile loop keeps recomputing it (vector_quants.rs:34
# `ARTIFACT_MIN_VECTORS`).
ARTIFACT_MIN_VECTORS = 1024

# Host chunk sizes: the elementwise chains allocate a few f32 temporaries of
# their input's size, so large corpora are reduced and quantized a slice at
# a time.
_ABSMAX_CHUNK_BYTES = 32 << 20
_QUANT_WHOLE_MAX_BYTES = 256 << 20
_QUANT_CHUNK_BYTES = 64 << 20

_native_mod = None
_native_checked = False
# Calls of corpus_absmax and quantize_int8_host that took the native path.
native_calls = {"absmax": 0, "quantize": 0}


def _native():
    """The C++ host codec (``panoptikon_tpu_torch.native``), built lazily
    once per process; None without a host compiler or library, and every
    caller then keeps its NumPy path."""
    global _native_mod, _native_checked
    if not _native_checked:
        _native_checked = True
        try:
            from panoptikon_tpu_torch import native as n

            if n.ensure_built():
                _native_mod = n
        except Exception:
            _native_mod = None
    return _native_mod


def native_available() -> bool:
    """Whether the host half runs through the native codec."""
    return _native() is not None


# ---------------------------------------------------------------------------
# Host half (NumPy)
# ---------------------------------------------------------------------------


def scale_from_absmax(absmax: float) -> float:
    """Scale for a corpus whose largest component magnitude is ``absmax``:
    positive finite absmax → ``absmax / 127`` (vector_quants.rs:1465),
    anything else (zero corpus, inf/NaN) → 1.0."""
    absmax = float(absmax)
    if absmax > 0.0 and np.isfinite(absmax):
        # Through f32: the artifact stores the scale as a 4-byte LE f32, and
        # codes built at derivation time must equal codes backfilled under
        # the round-tripped scale.
        return float(np.float32(absmax / INT8_MAX_CODE))
    return 1.0


def scale_artifact(scale: float) -> bytes:
    """Serialize a scale as the 4-byte little-endian f32 artifact payload."""
    return struct.pack("<f", np.float32(scale))


def artifact_scale(artifact: bytes) -> float | None:
    """Read a scale artifact; ``None`` unless it is a positive finite f32
    (callers treat ``None`` as "this quant pair is not usable",
    vector_quants.rs:1457-1461)."""
    if len(artifact) != 4:
        return None
    (scale,) = struct.unpack("<f", artifact)
    if np.isfinite(scale) and scale > 0.0:
        return float(scale)
    return None


def corpus_absmax(vectors: np.ndarray, valid: np.ndarray | None = None) -> float:
    """Largest component magnitude across a batch of f32 vectors.

    ``valid`` (optional, (n,) bool) restricts the reduction to masked rows
    without a masked copy of the corpus. NaN never wins (the reference
    streams with ``value > absmax`` comparisons); big corpora reduce a
    32 MB slice at a time."""
    x = np.asarray(vectors)
    if x.size == 0:
        return 0.0
    n = _native()
    if n is not None and valid is None and x.dtype == np.float32 and x.flags["C_CONTIGUOUS"]:
        # One streaming native pass, no |x| temporary.
        native_calls["absmax"] += 1
        return float(n.absmax(x))
    if x.ndim < 2 or x.nbytes <= _ABSMAX_CHUNK_BYTES:
        x32 = x.astype(np.float32, copy=False)
        if valid is not None:
            x32 = x32[np.asarray(valid, bool)]
        return float(np.nanmax(np.abs(x32), initial=0.0))
    out = 0.0
    step = max(1, _ABSMAX_CHUNK_BYTES // max(x[0].nbytes, 1))
    for lo in range(0, x.shape[0], step):
        chunk = x[lo : lo + step].astype(np.float32, copy=False)
        if valid is not None:
            chunk = chunk[np.asarray(valid[lo : lo + step], bool)]
        if chunk.size:
            out = max(out, float(np.nanmax(np.abs(chunk), initial=0.0)))
    return out


def quantize_int8_host(
    vectors: np.ndarray, scale: float, out: np.ndarray | None = None
) -> np.ndarray:
    """Quantize f32 vectors to int8 codes: ``clamp(rint(x/s), -128, 127)``,
    round-half-to-even (vector_quants.rs:1489), NaN → 0 (Rust's saturating
    ``as i8``). Any shape; the last axis is the component axis. ``out``
    (optional, int8, same shape) receives the codes in place, so bulk index
    builds write them exactly once."""
    x = np.asarray(vectors, dtype=np.float32)
    if out is not None and (out.dtype != np.int8 or out.shape != x.shape):
        raise ValueError(
            f"out must be int8 with shape {x.shape}, got {out.dtype}/{out.shape}"
        )
    n = _native()
    if n is not None and x.flags["C_CONTIGUOUS"]:
        dst = out if out is not None else np.empty(x.shape, dtype=np.int8)
        if n.quantize_int8_into(x, dst, scale):
            native_calls["quantize"] += 1
            return dst
    if x.ndim >= 2 and x.shape[0] and (x.nbytes > _QUANT_WHOLE_MAX_BYTES or out is not None):
        if out is None:
            out = np.empty(x.shape, dtype=np.int8)
        step = max(1, _QUANT_CHUNK_BYTES // max(x[0].nbytes, 1))
        for lo in range(0, x.shape[0], step):
            out[lo : lo + step] = quantize_int8_host(x[lo : lo + step], scale)
        return out
    codes = np.rint(x / np.float32(scale))
    codes = np.where(np.isnan(codes), np.float32(0.0), codes)
    codes = np.clip(codes, -128.0, INT8_MAX_CODE).astype(np.int8)
    if out is not None:
        out[...] = codes
        return out
    return codes


def dequantize_int8_host(codes: np.ndarray, scale: float) -> np.ndarray:
    """Reconstruct f32 approximations from int8 codes."""
    return codes.astype(np.float32) * np.float32(scale)


def compute_query_quant(query: np.ndarray, scale: float) -> np.ndarray:
    """Quantize a query with the pair's frozen scale: the write side's code
    path, so the two are byte-compatible by construction
    (vector_quants.rs:1501-1505)."""
    return quantize_int8_host(query, scale)


# ---------------------------------------------------------------------------
# Tensor half
# ---------------------------------------------------------------------------


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
