"""npy ⇄ f32 codec.

The port's own copy of ``panoptikon_tpu/utils/npy.py``. The inference
layer's wire format for embeddings is ``.npy`` bytes (the reference
produces them with ``serialize_array`` in
``python/inferio/impl/utils.py`` and parses them in
``panoptikon/src/pql/embedding_utils.rs:80+``). This module is a standalone
parser — deliberately not ``np.load`` — so the accepted surface is explicit
and pickle is never on the path:

- versions 1.x, 2.x, 3.x headers;
- dtypes: f2/f4/f8, i1–i8, u1–u8, b1; little- or big-endian; C or Fortran
  order; 1D or 2D shapes.

``parse_npy_embedding`` reproduces the reference's query-embedding rule:
a 2D array yields its FIRST ROW only (embedding_utils.rs:57-75 — a query is
one vector, possibly wrapped in a batch axis). ``parse_npy_matrix`` returns
the full 2D matrix, used for chunked text embeddings where every row is
stored (``write_text_embedding_output`` semantics).
"""

from __future__ import annotations

import ast
import io
import struct

import numpy as np

_MAGIC = b"\x93NUMPY"

_KINDS = {"f": "float", "i": "int", "u": "uint", "b": "bool"}
_FLOAT_SIZES = {2, 4, 8}
_INT_SIZES = {1, 2, 4, 8}


class NpyError(ValueError):
    """Raised for any malformed or unsupported npy payload."""


def _parse_header(buffer: bytes) -> tuple[np.dtype, bool, tuple[int, ...], int]:
    """Returns (dtype, fortran_order, shape, data_offset)."""
    if len(buffer) < 10:
        raise NpyError("Numpy buffer too small")
    if buffer[:6] != _MAGIC:
        raise NpyError("Invalid numpy magic header")
    major = buffer[6]
    if major == 1:
        (header_len,) = struct.unpack_from("<H", buffer, 8)
        header_start = 10
    elif major in (2, 3):
        if len(buffer) < 12:
            raise NpyError("Numpy buffer too small")
        (header_len,) = struct.unpack_from("<I", buffer, 8)
        header_start = 12
    else:
        raise NpyError(f"Unsupported numpy version {major}.{buffer[7]}")
    header_end = header_start + header_len
    if header_end > len(buffer):
        raise NpyError("Numpy header truncated")
    try:
        header = buffer[header_start:header_end].decode(
            "utf-8" if major == 3 else "latin-1"
        )
        meta = ast.literal_eval(header.strip())
    except Exception as exc:
        raise NpyError(f"Invalid numpy header: {exc}") from exc
    if not isinstance(meta, dict):
        raise NpyError("Numpy header is not a dict")
    try:
        descr = meta["descr"]
        fortran = bool(meta["fortran_order"])
        shape = tuple(int(d) for d in meta["shape"])
    except KeyError as exc:
        raise NpyError(f"Numpy header missing {exc.args[0]}") from exc
    dtype = _parse_descr(descr)
    return dtype, fortran, shape, header_end


def _parse_descr(descr: object) -> np.dtype:
    if not isinstance(descr, str) or len(descr) < 2:
        raise NpyError(f"Unsupported numpy descr: {descr!r}")
    byteorder = descr[0]
    if byteorder not in "<>|=":
        raise NpyError(f"Unsupported numpy byte order: {descr!r}")
    kind = descr[1]
    if kind not in _KINDS:
        raise NpyError(f"Unsupported numpy dtype kind: {descr!r}")
    try:
        size = int(descr[2:])
    except ValueError as exc:
        raise NpyError(f"Unsupported numpy descr: {descr!r}") from exc
    if kind == "f" and size not in _FLOAT_SIZES:
        raise NpyError(f"Unsupported float size {size}")
    if kind in "iu" and size not in _INT_SIZES:
        raise NpyError(f"Unsupported int size {size}")
    if kind == "b" and size != 1:
        raise NpyError(f"Unsupported bool size {size}")
    return np.dtype(descr)


def parse_npy(buffer: bytes) -> np.ndarray:
    """Parse npy bytes into an array (native byte order, original shape)."""
    dtype, fortran, shape, offset = _parse_header(buffer)
    if len(shape) == 0:
        raise NpyError("Numpy array has empty shape")
    total = 1
    for dim in shape:
        total *= dim
    nbytes = total * dtype.itemsize
    if offset + nbytes > len(buffer):
        raise NpyError("Numpy data truncated")
    flat = np.frombuffer(buffer, dtype=dtype, count=total, offset=offset)
    arr = flat.reshape(shape, order="F" if fortran else "C")
    if arr.dtype.byteorder == ">":
        arr = arr.astype(arr.dtype.newbyteorder("="))
    return arr


def parse_npy_embedding(buffer: bytes) -> np.ndarray:
    """npy bytes → one f32 vector; 2D input yields its first row.

    Matches ``parse_npy_f32`` (embedding_utils.rs:37-77): >2D rejected,
    2D takes row 0 (shape[1] components).
    """
    arr = parse_npy(buffer)
    if arr.ndim > 2:
        raise NpyError("Only 1D or 2D embeddings are supported")
    if arr.ndim == 2:
        if arr.shape[0] == 0:
            raise NpyError("Numpy array has no rows")
        arr = arr[0]
    return np.ascontiguousarray(arr, dtype=np.float32)


def parse_npy_matrix(buffer: bytes) -> np.ndarray:
    """npy bytes → (rows, dim) f32 matrix; 1D input becomes one row."""
    arr = parse_npy(buffer)
    if arr.ndim > 2:
        raise NpyError("Only 1D or 2D embeddings are supported")
    if arr.ndim == 1:
        arr = arr[None, :]
    return np.ascontiguousarray(arr, dtype=np.float32)


def serialize_npy(arr: np.ndarray) -> bytes:
    """Array → npy v1 bytes (C order, little-endian) — the wire format the
    model layer emits (reference ``serialize_array``, impl/utils.py)."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.byteorder == ">":
        arr = arr.astype(arr.dtype.newbyteorder("<"))
    out = io.BytesIO()
    shape = arr.shape if arr.ndim != 1 else (arr.shape[0],)
    shape_repr = (
        "(" + ", ".join(str(d) for d in shape) + ("," if len(shape) == 1 else "") + ")"
    )
    descr = arr.dtype.str
    if descr.startswith("="):
        descr = "<" + descr[1:]
    header = f"{{'descr': {descr!r}, 'fortran_order': False, 'shape': {shape_repr}, }}"
    # Pad so that data starts on a 64-byte boundary (npy spec).
    header_len = len(header) + 1  # trailing newline
    total = 10 + header_len
    pad = (64 - total % 64) % 64
    header = header + " " * pad + "\n"
    out.write(_MAGIC)
    out.write(bytes([1, 0]))
    out.write(struct.pack("<H", len(header)))
    out.write(header.encode("latin-1"))
    out.write(arr.tobytes())
    return out.getvalue()


def f32_blob(vector: np.ndarray) -> bytes:
    """Vector → little-endian f32 blob (the DB storage format,
    embedding_utils.rs:15 ``serialize_f32``)."""
    return np.ascontiguousarray(vector, dtype="<f4").tobytes()


def blob_f32(blob: bytes) -> np.ndarray:
    """Little-endian f32 blob → vector."""
    if len(blob) % 4:
        raise NpyError("f32 blob length not a multiple of 4")
    return np.frombuffer(blob, dtype="<f4").astype(np.float32)
