"""ctypes bindings for the native C++ host codec: the port's copy of
``panoptikon_tpu/native/__init__.py``, held to it by
``tests/test_torch_host_copies.py``.

The library is ``csrc/host_codec.cpp`` (the reference's ``codec.cpp``, text
for text), built lazily by ``ensure_built`` with the host compiler and no
CUDA into ``build/torch_kernels/`` (``_build.build_host``: the flags of the
reference's Makefile, a file name that carries a hash of the source, the
flags and the processor). Every binding has a NumPy fallback so the port
works without a compiler; ``ops.codec`` consults :func:`available` to pick
the fast path. Only where the library lives (``ensure_built``, ``_load``) and
``quantize_int8``'s fallback (the port's NumPy quantizer is
``ops.codec.quantize_int8_host``) differ from the reference.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

from panoptikon_tpu_torch import _build

_NAME = "host_codec"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def ensure_built(force: bool = False) -> bool:
    """Build the shared library if missing; returns availability."""
    global _tried
    try:
        _build.build_host(_NAME, force=force)
    except Exception:
        _tried = True
        return False
    return _load() is not None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None:
            return _lib
        _tried = True
        try:
            path = _build.host_library_path(_NAME)
        except Exception:  # no host compiler: nothing was built
            return None
        if not path.exists():
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        lib.pk_absmax.restype = ctypes.c_float
        lib.pk_absmax.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.pk_scale_from_absmax.restype = ctypes.c_float
        lib.pk_scale_from_absmax.argtypes = [ctypes.c_float]
        lib.pk_quantize_int8.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_float,
        ]
        lib.pk_dequantize_int8.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_float,
        ]
        lib.pk_row_sumsq_int8.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ]
        lib.pk_mix_array.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ]
        _lib = lib
        return lib


def available() -> bool:
    return _load() is not None


def absmax(data: np.ndarray) -> float:
    lib = _load()
    flat = np.ascontiguousarray(data, dtype=np.float32).reshape(-1)
    if lib is None:
        return float(np.nanmax(np.abs(flat), initial=0.0)) if flat.size else 0.0
    return float(lib.pk_absmax(flat.ctypes.data, flat.size))


def quantize_int8(data: np.ndarray, scale: float) -> np.ndarray:
    lib = _load()
    src = np.ascontiguousarray(data, dtype=np.float32)
    if lib is None:
        from panoptikon_tpu_torch.ops import codec

        return codec.quantize_int8_host(src, scale)
    out = np.empty(src.shape, dtype=np.int8)
    lib.pk_quantize_int8(src.ctypes.data, out.ctypes.data, src.size, scale)
    return out


def quantize_int8_into(
    src: np.ndarray, out: np.ndarray, scale: float
) -> bool:
    """Quantize ``src`` (f32, C-contiguous) into ``out`` (int8, same shape,
    C-contiguous) in one native pass — zero temporaries, which is the whole
    point on a VMM-backed host where every fresh page costs a fault.
    Returns False (caller falls back) when the library or layout
    preconditions aren't met."""
    lib = _load()
    if (
        lib is None
        or src.dtype != np.float32 or not src.flags["C_CONTIGUOUS"]
        or out.dtype != np.int8 or not out.flags["C_CONTIGUOUS"]
        or src.shape != out.shape
    ):
        return False
    lib.pk_quantize_int8(
        src.ctypes.data, out.ctypes.data, src.size, float(scale)
    )
    return True


def dequantize_int8(codes: np.ndarray, scale: float) -> np.ndarray:
    lib = _load()
    src = np.ascontiguousarray(codes, dtype=np.int8)
    if lib is None:
        return src.astype(np.float32) * np.float32(scale)
    out = np.empty(src.shape, dtype=np.float32)
    lib.pk_dequantize_int8(src.ctypes.data, out.ctypes.data, src.size, scale)
    return out


def row_sumsq_int8(codes: np.ndarray) -> np.ndarray:
    lib = _load()
    src = np.ascontiguousarray(codes, dtype=np.int8)
    if lib is None:
        wide = src.astype(np.int32)
        return np.sum(wide * wide, axis=-1, dtype=np.int32)
    rows, dim = src.shape
    out = np.empty(rows, dtype=np.int32)
    lib.pk_row_sumsq_int8(src.ctypes.data, out.ctypes.data, rows, dim)
    return out


def pk_mix_array(ids: np.ndarray, seed: int) -> np.ndarray:
    lib = _load()
    src = np.ascontiguousarray(ids, dtype=np.int64)
    if lib is None:
        from panoptikon_tpu_torch.utils.splitmix import pk_mix_array as py_mix

        return py_mix(src, seed)
    out = np.empty(src.shape, dtype=np.int64)
    lib.pk_mix_array(src.ctypes.data, out.ctypes.data, src.size, seed)
    return out
