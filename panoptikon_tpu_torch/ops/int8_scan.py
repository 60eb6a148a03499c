"""Fused int8 scans with top-k — kernels B1 and B2 of the port.

Ports of ``panoptikon_tpu/ops/pallas_scan.py``'s two kernels, with the L2
epilogue of ``ops/scoring.py::_distance_epilogue`` beside their cosine one.
Both (``csrc/int8_scan.cu``) compute exact int8 dot products, the cosine
epilogue ``1 − dot·rsqrt(max(xx·qq, 1e-30))`` or the L2 epilogue
``scale·sqrt(max(qq − 2·dot + xx, 0))`` (the sum formed exactly in
integers), in one shared device function; the (Q, N) distances never reach
device memory.

- :func:`int8_topk` (B1, ``pallas_int8_topk``): each strip of consecutive
  corpus rows (:func:`b1_layout`) gives a list of packed (distance, row)
  keys that starts with its k best, merged by one ``torch.topk`` over
  unique keys — the exact top-k, lowest row first among ties.
- :func:`int8_topk_v2` (B2, ``pallas_int8_topk_v2``): per (query, tile of
  ``tile_n`` rows) one survivor per 128-row-strided lane bucket, then
  ``k_tile`` extract-min rounds over the 128 lanes, merged by one top-k
  over (Q, tiles·k_tile) candidates keyed by (distance, candidate
  position) — the approximation contract of ``lax.approx_min_k``.

Both run their dots on the int8 tensor cores (``mma.sync`` s8 × s8 → s32)
through one dot stage.

:data:`V1_MAX_QUERIES` splits the serving path's candidate stage between
them (``scoring.candidate_route``).

Each wrapper launches its kernel for CUDA tensors and takes its plain
version for CPU tensors; any other device raises. Neither kernel has a
backward: on the card each raises ``ValueError`` under grad (of their inputs
only a tensor ``scale`` can require it). The plain versions
compute the same values bit for bit (exact dots, correctly rounded
``rsqrt`` and ``sqrt``, the same f32 roundings) and are what the tests and
``chip_smoke.py`` hold the kernels against.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from panoptikon_tpu_torch import _build
from panoptikon_tpu_torch.ops import refuse_grad
from panoptikon_tpu_torch.ops.exact import (
    INF, int8_dots, pack_keys, row_sumsq, smallest_k, unpack_keys,
)

_SIGNATURES = {
    "pk_int8_topk": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p],
    "pk_int8_topk_v2": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p],
    "pk_check_rsqrt_rn": [ctypes.c_void_p, ctypes.c_void_p],
}
MAX_K = 1024

# The candidate stage of the serving path takes B1 up to this many queries
# and B2 above it: the JAX package's v1 keeps every query resident in VMEM,
# "capping Q at ~512 while the bench serves 4096-query batches", and v2 was
# written for those batches (pallas_scan.py:16-20, 181-182).
V1_MAX_QUERIES = 512

# B2's row for a round that found only +inf (pallas_scan.py:244).
SENTINEL_ROW = 2**30
LANES = 128
# B2's tile and survivors a tile unless the caller names others (the JAX
# package's defaults).
V2_TILE_N, V2_K_TILE = 2048, 8
# Both kernels keep a block's query codes in shared memory for a whole strip
# or tile: D up to 1,024, every CONFIGS embed dim.
V2_MAX_DIM = 1024

# B1's selection (csrc/int8_scan.cu): corpus rows a block multiplies at a
# time; a query's list and pending slots in the narrow form (k <= 128, the
# list in device memory) and the pending slots of the wide form (k > 128,
# lists of the next power of two >= k keys in shared memory). A bucket's
# end folds a query's pending keys once three quarters of its slots hold
# keys (kFoldAt; a full buffer folds at once).
BUCKET = 128
NARROW_LIST, NARROW_PENDING, WIDE_PENDING = 128, 64, 128


def b1_layout(q: int, n: int, d: int, k: int, sms: int) -> tuple[int, int, int]:
    """B1's grid for Q queries, N rows of D codes and k on a card of ``sms``
    SMs: (queries a block, rows a strip, the length of a query's list).

    k ≤ 128 takes the narrow form: 64 queries a block, lists of 128 keys in
    device memory. k > 128 takes the wide form: lists of the next power of
    two ≥ k keys in shared memory, 32 queries a block up to 256 keys and 16
    above. Strips of whole 128-row buckets, as many as give one block an SM
    with the query blocks (a block's shared memory leaves one resident an
    SM, and a strip's first k keys all pass its tau, so fewer and longer
    strips admit fewer keys), at least one and at most one a bucket."""
    if k <= NARROW_LIST:
        length, q_block = NARROW_LIST, 64
    else:
        length = 1 << (k - 1).bit_length()
        q_block = 32 if length <= 256 else 16
    q_blocks = -(-q // q_block)
    strips = max(1, min(sms // q_blocks, -(-n // BUCKET)))
    strip_rows = -(-n // strips)
    return q_block, -(-strip_rows // BUCKET) * BUCKET, length


def _check_inputs(codes, sumsq, row_valid, q_codes, distance):
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


def _check(codes, sumsq, row_valid, q_codes, k, distance):
    _check_inputs(codes, sumsq, row_valid, q_codes, distance)
    n = codes.shape[0]
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

    codes (N, D) int8 with D % 16 == 0 (and D ≤ 1,024 on the card); sumsq
    (N,) int32 (``row_sumsq``); row_valid (N,) bool; q_codes (Q, D) int8. Invalid rows score +inf and
    come back with ``valid`` False only when fewer than k rows are valid.
    Returns (dist (Q, k) f32, row (Q, k) int64, valid (Q, k) bool), ascending,
    lowest row first among equal distances."""
    if codes.device.type == "cpu":
        return int8_topk_plain(codes, sumsq, row_valid, q_codes, k=k, distance=distance,
                               scale=scale)
    if codes.device.type != "cuda":
        raise ValueError(f"int8_topk: unsupported device {codes.device}")
    refuse_grad("int8_topk", codes, sumsq, row_valid, q_codes, scale)
    _check(codes, sumsq, row_valid, q_codes, k, distance)
    n, d = codes.shape
    q = q_codes.shape[0]
    if d % 16 or d > V2_MAX_DIM or n >= 2**30:
        raise ValueError(f"int8_topk kernel needs D % 16 == 0, D <= {V2_MAX_DIM} and N < 2**30, "
                         f"got N={n} D={d}")
    if not all(t.is_contiguous() for t in (codes, sumsq, row_valid, q_codes)):
        raise ValueError("int8_topk kernel needs contiguous inputs")
    qq = row_sumsq(q_codes)
    lib = _build.load("int8_scan", _SIGNATURES)
    sms = torch.cuda.get_device_properties(codes.device).multi_processor_count
    q_block, strip_rows, length = b1_layout(q, n, d, k, sms)
    strips = -(-n // strip_rows)
    keys = torch.empty((q, strips * length), dtype=torch.int64, device=codes.device)
    err = lib.pk_int8_topk(
        codes.data_ptr(), sumsq.data_ptr(), row_valid.data_ptr(), q_codes.data_ptr(),
        qq.data_ptr(), keys.data_ptr(), n, d, q, k, q_block, strip_rows, int(distance == "l2"),
        float(scale), torch.cuda.current_stream(codes.device).cuda_stream,
    )
    _build.check(err, "int8_topk")
    int8_topk.launches += 1
    # Each strip's list holds its k smallest keys first; the rest are keys of
    # the strip too (or LLONG_MAX), so the k smallest of all lists are exact.
    top = torch.topk(keys, k, dim=-1, largest=False, sorted=True).values
    top_v, rows = unpack_keys(top)
    return top_v, rows, torch.isfinite(top_v)


int8_topk.launches = 0


def _check_v2(codes, sumsq, row_valid, q_codes, k, k_tile, tile_n, distance):
    _check_inputs(codes, sumsq, row_valid, q_codes, distance)
    if k < 1 or not 1 <= k_tile <= LANES:
        raise ValueError(f"k={k} must be >= 1 and k_tile={k_tile} in [1, {LANES}]")
    if tile_n % LANES or not LANES <= tile_n <= 256 * LANES:
        raise ValueError(f"tile_n={tile_n} must be a multiple of {LANES} "
                         f"in [{LANES}, {256 * LANES}]")


def int8_topk_v2_plain(codes, sumsq, row_valid, q_codes, *, k: int = 80, k_tile: int = V2_K_TILE,
                       tile_n: int = V2_TILE_N, distance: str = "cosine", scale: float = 1.0):
    """Plain PyTorch version of :func:`int8_topk_v2` (same results, bit for
    bit). Per query; a batch split by queries gives the same rows.
    Returns (dist (Q, kk) f32, row (Q, kk) int64, valid (Q, kk) bool),
    kk = min(k, tiles·k_tile)."""
    _check_v2(codes, sumsq, row_valid, q_codes, k, k_tile, tile_n, distance)
    n, q = codes.shape[0], q_codes.shape[0]
    tiles, buckets = -(-n // tile_n), tile_n // LANES
    dev = codes.device
    dist = _distances(int8_dots(q_codes, codes), sumsq, row_sumsq(q_codes), distance, scale)
    dist = torch.where(row_valid[None, :], dist, INF)
    # The corpus tail pads to whole tiles with rows at +inf, as the reference's
    # invalid padding rows.
    dist = F.pad(dist, (0, tiles * tile_n - n), value=INF).view(q, tiles, buckets, LANES)
    # Lane minima over the buckets, lowest bucket first among equal values.
    bucket = torch.arange(buckets, device=dev).view(1, 1, buckets, 1).expand(dist.shape)
    lane_v, lane_b = unpack_keys(pack_keys(dist, bucket).amin(dim=2))  # (Q, tiles, 128)
    del dist, bucket
    lane = torch.arange(LANES, device=dev)
    lane_row = torch.arange(tiles, device=dev)[:, None] * tile_n + lane_b * LANES + lane
    # k_tile rounds of extract-min, lowest lane first among equal values: the
    # k_tile smallest (value, lane) keys.
    rounds = torch.topk(pack_keys(lane_v, lane.expand(lane_v.shape)), k_tile, dim=-1,
                        largest=False, sorted=True).values
    cand_v, cand_lane = unpack_keys(rounds)
    cand_row = torch.gather(lane_row, 2, cand_lane)
    cand_row = torch.where(torch.isfinite(cand_v), cand_row, SENTINEL_ROW)
    # Merge in candidate order tile·k_tile + round, lower position first.
    kk = min(k, tiles * k_tile)
    top_v, pos = smallest_k(cand_v.reshape(q, tiles * k_tile), kk)
    rows = torch.gather(cand_row.reshape(q, tiles * k_tile), 1, pos)
    return top_v, rows, torch.isfinite(top_v)


def int8_topk_v2(codes, sumsq, row_valid, q_codes, *, k: int = 80, k_tile: int = V2_K_TILE,
                 tile_n: int = V2_TILE_N, distance: str = "cosine", scale: float = 1.0):
    """Approximate top-k candidates of int8 query codes against int8 corpus
    codes, any Q: the ``lax.approx_min_k`` contract of the JAX package's
    ``pallas_int8_topk_v2``, cosine or L2 (code-space L2 × ``scale``).

    Within one (tile of ``tile_n`` rows, lane l) — rows ``l``, ``l + 128``,
    … of the tile — only the best row survives; ``k_tile`` survivors per
    tile go to the merge. ``tile_n`` and ``k_tile`` define the result. A
    ragged corpus tail counts as rows at +inf (nothing is copied). Inputs as
    :func:`int8_topk`. Returns (dist (Q, kk) f32, row (Q, kk) int64,
    valid (Q, kk) bool), kk = min(k, tiles·k_tile), ascending, the lower
    candidate position (tile·k_tile + round) first among equal distances; a
    candidate at +inf has row ``SENTINEL_ROW`` and is not valid."""
    if codes.device.type == "cpu":
        return int8_topk_v2_plain(codes, sumsq, row_valid, q_codes, k=k, k_tile=k_tile,
                                  tile_n=tile_n, distance=distance, scale=scale)
    if codes.device.type != "cuda":
        raise ValueError(f"int8_topk_v2: unsupported device {codes.device}")
    refuse_grad("int8_topk_v2", codes, sumsq, row_valid, q_codes, scale)
    _check_v2(codes, sumsq, row_valid, q_codes, k, k_tile, tile_n, distance)
    n, d = codes.shape
    q = q_codes.shape[0]
    tiles = -(-n // tile_n)
    if d % 16 or d > V2_MAX_DIM or n + tile_n >= 2**31 or tiles > 65535:
        raise ValueError(f"int8_topk_v2 kernel needs D % 16 == 0, D <= {V2_MAX_DIM}, "
                         f"N + tile_n < 2**31 and at most 65535 tiles, "
                         f"got N={n} D={d} tile_n={tile_n}")
    if not all(t.is_contiguous() for t in (codes, sumsq, row_valid, q_codes)):
        raise ValueError("int8_topk_v2 kernel needs contiguous inputs")
    qq = row_sumsq(q_codes)
    lib = _build.load("int8_scan", _SIGNATURES)
    keys = torch.empty((q, tiles * k_tile), dtype=torch.int64, device=codes.device)
    rows = torch.empty((q, tiles * k_tile), dtype=torch.int32, device=codes.device)
    err = lib.pk_int8_topk_v2(
        codes.data_ptr(), sumsq.data_ptr(), row_valid.data_ptr(), q_codes.data_ptr(),
        qq.data_ptr(), keys.data_ptr(), rows.data_ptr(), n, d, q, tile_n, k_tile,
        int(distance == "l2"), float(scale), torch.cuda.current_stream(codes.device).cuda_stream,
    )
    _build.check(err, "int8_topk_v2")
    int8_topk_v2.launches += 1
    kk = min(k, tiles * k_tile)
    top, pos = torch.topk(keys, kk, dim=-1, largest=False, sorted=True)
    top_v, _ = unpack_keys(top)
    return top_v, torch.gather(rows, 1, pos).to(torch.int64), torch.isfinite(top_v)


int8_topk_v2.launches = 0


def check_rsqrt_rn(dev) -> int:
    """Both scans' cosine epilogue takes a branch-free correctly rounded
    reciprocal square root (``rsqrt_rn`` in csrc/int8_scan.cu). Returns how
    many positive normal floats — every one — it and ``__frsqrt_rn`` round
    differently on the card ``dev`` (0 is right)."""
    if torch.device(dev).type != "cuda":
        raise ValueError("check_rsqrt_rn runs on a CUDA device")
    count = torch.zeros(1, dtype=torch.int64, device=dev)
    lib = _build.load("int8_scan", _SIGNATURES)
    _build.check(lib.pk_check_rsqrt_rn(count.data_ptr(),
                                       torch.cuda.current_stream(count.device).cuda_stream),
                 "check_rsqrt_rn")
    return int(count.item())
