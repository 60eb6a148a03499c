"""Fused int8 scan with top-k — kernel B1 of the port.

Port of ``panoptikon_tpu/ops/pallas_scan.py::pallas_int8_topk``, with the L2
epilogue of ``ops/scoring.py::_distance_epilogue`` beside its cosine one.
The kernel (``csrc/int8_scan.cu``) computes exact int8 dot products, the
cosine epilogue ``1 − dot·rsqrt(max(xx·qq, 1e-30))`` or the L2 epilogue
``scale·sqrt(max(qq − 2·dot + xx, 0))`` (the sum formed exactly in integers),
and each 1024-row corpus tile's k best rows, and writes them as packed
(distance, row) keys; the (Q, N) distances never reach device memory. The merge over
(Q, tiles·k) is one ``torch.topk`` over unique keys, which keeps the
ascending-row tiebreak of the reference's ``lax.top_k``.

:func:`int8_topk` launches the kernel for CUDA tensors and takes
:func:`int8_topk_plain` for CPU tensors; any other device raises. The plain
version computes the same values bit for bit (exact dots, correctly rounded
``rsqrt`` and ``sqrt``, the same f32 roundings) and is what the tests and
``chip_smoke.py`` hold the kernel against.
"""

from __future__ import annotations

import ctypes

import torch

from panoptikon_tpu_torch import _build
from panoptikon_tpu_torch.ops.exact import INF, int8_dots, row_sumsq, smallest_k, unpack_keys

_SIGNATURES = {
    "pk_int8_topk": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p],
    "pk_int8_topk_tile_rows": [],
}
MAX_K = 1024


def _check(codes, sumsq, row_valid, q_codes, k, distance):
    if distance not in ("cosine", "l2"):
        raise ValueError(f"Unknown distance {distance!r}")
    n, d = codes.shape
    expect = {
        "codes": (codes, torch.int8, (n, d)),
        "sumsq": (sumsq, torch.int32, (n,)),
        "row_valid": (row_valid, torch.bool, (n,)),
        "q_codes": (q_codes, torch.int8, (q_codes.shape[0], d)),
    }
    for name, (t, dtype, shape) in expect.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {dtype} {shape}, got {t.dtype} {tuple(t.shape)}")
        if t.device != codes.device:
            raise ValueError(f"{name} is on {t.device}, codes on {codes.device}")
    if not 1 <= k <= min(MAX_K, n):
        raise ValueError(f"k={k} must be in [1, min({MAX_K}, N={n})]")


def _distances(dots, sumsq, qq, distance, scale):
    """The kernel's epilogue on (Q, N) int32 dots, in the same roundings."""
    if distance == "l2":
        sq = qq.to(torch.int64)[:, None] - 2 * dots.to(torch.int64) + sumsq.to(torch.int64)[None, :]
        sq = torch.clamp(sq, min=0).to(torch.float32)
        # sqrt through f64, rounded once to f32: the correctly rounded value.
        root = torch.sqrt(sq.to(torch.float64)).to(torch.float32)
        return root * torch.tensor(scale, dtype=torch.float32, device=dots.device)
    xx = sumsq.to(torch.float32)[None, :]
    qqf = qq.to(torch.float32)[:, None]
    # rsqrt through f64, rounded once to f32: the correctly rounded value.
    den = torch.rsqrt(torch.clamp(xx * qqf, min=1e-30).to(torch.float64)).to(torch.float32)
    return 1.0 - dots.to(torch.float32) * den


def int8_topk_plain(codes, sumsq, row_valid, q_codes, *, k: int = 10,
                    distance: str = "cosine", scale: float = 1.0):
    """Plain PyTorch version of :func:`int8_topk` (same results, bit for bit).
    Returns (dist (Q, k) f32, row (Q, k) int64, valid (Q, k) bool)."""
    _check(codes, sumsq, row_valid, q_codes, k, distance)
    dist = _distances(int8_dots(q_codes, codes), sumsq, row_sumsq(q_codes), distance, scale)
    dist = torch.where(row_valid[None, :], dist, INF)
    top_v, rows = smallest_k(dist, k)
    return top_v, rows, torch.isfinite(top_v)


def int8_topk(codes, sumsq, row_valid, q_codes, *, k: int = 10,
              distance: str = "cosine", scale: float = 1.0):
    """Top-k of int8 query codes against int8 corpus codes, by cosine
    distance or by L2 distance on the true axis (code-space L2 × ``scale``).

    codes (N, D) int8 with D % 16 == 0; sumsq (N,) int32 (``row_sumsq``);
    row_valid (N,) bool; q_codes (Q, D) int8. Invalid rows score +inf and
    come back with ``valid`` False only when fewer than k rows are valid.
    Returns (dist (Q, k) f32, row (Q, k) int64, valid (Q, k) bool), ascending,
    lowest row first among equal distances."""
    if codes.device.type == "cpu":
        return int8_topk_plain(codes, sumsq, row_valid, q_codes, k=k, distance=distance,
                               scale=scale)
    if codes.device.type != "cuda":
        raise ValueError(f"int8_topk: unsupported device {codes.device}")
    _check(codes, sumsq, row_valid, q_codes, k, distance)
    n, d = codes.shape
    q = q_codes.shape[0]
    if d % 16 or n >= 2**31:
        raise ValueError(f"int8_topk kernel needs D % 16 == 0 and N < 2**31, got N={n} D={d}")
    if not all(t.is_contiguous() for t in (codes, sumsq, row_valid, q_codes)):
        raise ValueError("int8_topk kernel needs contiguous inputs")
    qq = row_sumsq(q_codes)
    lib = _build.load("int8_scan", _SIGNATURES)
    tiles = -(-n // lib.pk_int8_topk_tile_rows())
    keys = torch.empty((q, tiles, k), dtype=torch.int64, device=codes.device)
    err = lib.pk_int8_topk(
        codes.data_ptr(), sumsq.data_ptr(), row_valid.data_ptr(), q_codes.data_ptr(),
        qq.data_ptr(), keys.data_ptr(), n, d, q, k, int(distance == "l2"), float(scale),
        torch.cuda.current_stream(codes.device).cuda_stream,
    )
    _build.check(err, "int8_topk")
    int8_topk.launches += 1
    top = torch.topk(keys.view(q, tiles * k), k, dim=-1, largest=False, sorted=True).values
    top_v, rows = unpack_keys(top)
    return top_v, rows, torch.isfinite(top_v)


int8_topk.launches = 0
