"""Multi-head attention — kernels B3 and B4 of the port.

Port of ``panoptikon_tpu/ops/vit_attention.py``: ``mha`` (and ``attention``,
its caller-facing name) and ``mha_qkv``, both through one kernel
(``csrc/attention.cu``).

- :func:`mha` takes q (B, N_q, H, D) and k, v (B, N_kv, H, D): self, causal,
  key-padding masked (additive −1e9, so a fully masked row gives uniform
  probabilities, never NaN) and cross (N_q ≠ N_kv) attention.
- :func:`mha_qkv` takes the unsplit (B, N, 3·H·D) output of the fused qkv
  projection (q | k | v along the last axis), optionally causal, and returns
  (B, N, H·D) in qkv's dtype or, with a static ``out_scale``, int8 quantized
  from the f32 accumulator (the out-projection's input quant).

Softmax in f32; probabilities are rounded to V's dtype before the AV
product when D ≥ 32 and stay f32 below that (the reference computes head
dims under 32 in f32); AV accumulates in f32.

Each wrapper launches a kernel for CUDA tensors and takes its plain
version (:func:`mha_plain`, :func:`mha_qkv_plain`) for CPU tensors; any
other device raises. Unlike the JAX ``attention``, which picks by the
default backend, the choice follows the tensor. On CUDA, :func:`route`
picks one of two kernels from the dtype and head dim, before the launch:

- ``"tensor_core"`` (``pk_mha_tc``): bf16 with 32 ≤ D ≤ 128 and D a
  multiple of 16 — every CLIP tower. ``mma.sync`` bf16 tiles; p is rounded
  to bf16 after the normalisation, as the reference rounds it, so the row
  max and sum come first: from logits kept in shared memory up to
  ``TC_LOGITS_MAX_KEYS`` keys, else from a first pass over the keys whose
  logits the second pass recomputes. Needs 16-byte aligned operands.
- ``"cuda_core"`` (``pk_mha``, ``pk_mha_qkv``): f32 (held to 2e-5, which
  TF32 would break) and the other head dims: below 32 p stays f32; past
  128, up to :data:`MAX_HEAD_DIM` = 512 and for :func:`mha` alone, a second
  instantiation of the kernel with smaller key chunks (the captioner's
  decoder is 768 wide with 2 heads: D 384).

On either route q, k and v may be views that share one row stride
(:func:`row_stride`), such as the three parts of a fused qkv projection:
the kernel reads them in place, with no split copies.

Each wrapper counts its launches (``.launches``) and its launches by route
(``.routes``).
"""

from __future__ import annotations

import ctypes

import torch

from panoptikon_tpu_torch import _build
from panoptikon_tpu_torch.ops.codec import quantize_static

_SIGNATURES = {
    "pk_mha": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p],
    "pk_mha_qkv": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p],
    "pk_mha_tc": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
    + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    "pk_check_div_rn": [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p],
}
MAX_HEAD_DIM = 512  # mha's: the CUDA-core kernel's wide instantiation
QKV_MAX_HEAD_DIM = 128  # mha_qkv's, and the tensor-core kernel's
ROUTES = ("tensor_core", "cuda_core")
# The tensor-core kernel's variants, each the faster at the towers' shapes
# in ``python3 -m panoptikon_tpu_torch.profiling --attention``: query rows a
# block (64 or 128), and the longest key axis whose logits it keeps in
# shared memory (longer ones take the two-pass form; 0 for two passes
# always). 64 rows × 320 keys of f32 logits, with the bf16 q, K and V
# tiles, take at most 132 KB of a block's 227 KB, at D = 128.
TC_QUERY_ROWS = 64
TC_LOGITS_MAX_KEYS = 320


def route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel a CUDA call of :func:`mha` or :func:`mha_qkv` launches:
    ``"tensor_core"`` for bf16 with 32 ≤ D ≤ 128 and D % 16 == 0, else
    ``"cuda_core"`` (bf16 past 128 included). Past :data:`MAX_HEAD_DIM` no
    kernel takes the head dim: it raises ``ValueError``."""
    if head_dim > MAX_HEAD_DIM:
        raise ValueError(f"mha kernel supports D <= {MAX_HEAD_DIM}, got {head_dim}")
    if dtype == torch.bfloat16 and 32 <= head_dim <= QKV_MAX_HEAD_DIM and head_dim % 16 == 0:
        return "tensor_core"
    return "cuda_core"


def _tensor_core(q_ptr, k_ptr, v_ptr, mask, out, scale_t, ld, b, n_q, n_kv, h, d, causal,
                 device):
    """Launch ``pk_mha_tc`` on bf16 operands given by base pointer and row
    stride ``ld`` (elements)."""
    if any(ptr % 16 for ptr in (q_ptr, k_ptr, v_ptr)) or ld % 8:
        raise ValueError("the tensor-core attention kernel needs 16-byte aligned q, k, v rows")
    lib = _build.load("attention", _SIGNATURES)
    return lib.pk_mha_tc(
        q_ptr, k_ptr, v_ptr, None if mask is None else mask.data_ptr(), out.data_ptr(),
        None if scale_t is None else scale_t.data_ptr(), ld, b, n_q, n_kv, h, d, int(causal),
        float(d) ** -0.5, TC_QUERY_ROWS, int(n_kv <= TC_LOGITS_MAX_KEYS),
        torch.cuda.current_stream(device).cuda_stream,
    )


def check_div_rn(divisors: torch.Tensor) -> torch.Tensor:
    """The tensor-core kernel forms p = e / s as one correction of e·(1/s)
    (``div_rn`` in csrc/common.cuh). For each divisor (f32 ≥ 1, on the
    card) returns how many floats in [0, 1] — every one — it rounds
    otherwise than a correctly rounded division (int64; all 0 is right)."""
    if divisors.device.type != "cuda" or divisors.dtype != torch.float32:
        raise ValueError("check_div_rn takes f32 divisors on a CUDA device")
    b = divisors.contiguous()
    if not bool((b >= 1).all()):
        raise ValueError("check_div_rn takes divisors >= 1, as a row sum of the softmax is")
    counts = torch.zeros(b.numel(), dtype=torch.int64, device=b.device)
    lib = _build.load("attention", _SIGNATURES)
    err = lib.pk_check_div_rn(b.data_ptr(), b.numel(), counts.data_ptr(),
                              torch.cuda.current_stream(b.device).cuda_stream)
    _build.check(err, "check_div_rn")
    return counts


def _check(q, k, v, causal, key_mask):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, N, H, D)")
    b, n_q, h, d = q.shape
    n_kv = k.shape[1]
    if tuple(k.shape) != (b, n_kv, h, d) or tuple(v.shape) != (b, n_kv, h, d):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match q {tuple(q.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q, k, v must share dtype f32 or bf16, got {q.dtype} {k.dtype} {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    if n_kv < 1:
        raise ValueError("attention needs at least one key")
    if causal and n_q != n_kv:
        raise ValueError(f"causal attention needs N_q == N_kv, got {n_q} and {n_kv}")
    if key_mask is not None and (tuple(key_mask.shape) != (b, n_kv) or key_mask.device != q.device):
        raise ValueError(f"key_mask must be (B, N_kv) = {(b, n_kv)} on {q.device}")


def _attend(q, k, v, causal, key_mask):
    """The attention output in f32, before its final cast, in the reference's
    arithmetic."""
    n_q, n_kv, d = q.shape[1], k.shape[1], q.shape[3]
    lt = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32), k.to(torch.float32)) * (float(d) ** -0.5)
    if causal:
        keep = torch.arange(n_kv, device=q.device)[None, :] <= torch.arange(n_q, device=q.device)[:, None]
        lt = torch.where(keep, lt, -torch.inf)
    if key_mask is not None:
        valid = (key_mask.to(torch.float32) > 0)[:, None, None, :]
        lt = torch.where(valid, lt, lt - 1e9)
    e = torch.exp(lt - lt.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    if d >= 32:
        p = p.to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(torch.float32), v.to(torch.float32))


def row_stride(q, k, v):
    """The row stride (elements) that q, k and v share when each is laid out
    as rows of ``ld`` elements with its heads packed inside a row — element
    (b, i, head, c) at ``(b·N + i)·ld + head·D + c`` — as contiguous
    (B, N, H, D) tensors are (``ld = H·D``) and as the three views of one
    fused (B, N, 3·H·D) projection split along its last axis are
    (``ld = 3·H·D``). None when they are not.

    An axis of length 1 has no stride of its own (PyTorch reports any): at
    N = 1 the row stride is the batch axis's, as in a decoder's one-token
    step, and a single row (B = N = 1) reads alike at any stride."""
    h, d = q.shape[2], q.shape[3]
    if q.is_contiguous() and k.is_contiguous() and v.is_contiguous():
        return h * d
    strides = set()
    for t in (q, k, v):
        b, n = t.shape[0], t.shape[1]
        if t.stride(3) != 1 or (h > 1 and t.stride(2) != d):
            return None
        if n > 1:
            if b > 1 and t.stride(0) != n * t.stride(1):
                return None
            strides.add(t.stride(1))
        elif b > 1:
            strides.add(t.stride(0))
    if len(strides) > 1:
        return None
    ld = strides.pop() if strides else h * d
    return ld if ld >= h * d else None


def mha_plain(q, k, v, *, causal: bool = False, key_mask=None):
    """Plain PyTorch version of :func:`mha`, in the reference's arithmetic."""
    _check(q, k, v, causal, key_mask)
    return _attend(q, k, v, causal, key_mask).to(q.dtype)


def mha(q, k, v, *, causal: bool = False, key_mask=None):
    """Fused multi-head attention. q (B, N_q, H, D); k, v (B, N_kv, H, D),
    f32 or bf16, D ≤ 512; ``key_mask`` (B, N_kv), truthy for valid keys;
    ``causal`` needs N_q == N_kv. Returns (B, N_q, H, D) in q's dtype. On
    CUDA q, k, v are contiguous or views sharing one row stride
    (:func:`row_stride`); past D 512 it raises and launches nothing."""
    if q.device.type == "cpu":
        return mha_plain(q, k, v, causal=causal, key_mask=key_mask)
    if q.device.type != "cuda":
        raise ValueError(f"mha: unsupported device {q.device}")
    _check(q, k, v, causal, key_mask)
    b, n_q, h, d = q.shape
    n_kv = k.shape[1]
    path = route(q.dtype, d)
    ld = row_stride(q, k, v)
    if ld is None:
        raise ValueError("mha kernel needs contiguous q, k, v or views that share one row "
                         "stride, such as the split of a fused qkv")
    mask = None
    if key_mask is not None:
        mask = (key_mask.to(torch.float32) > 0).to(torch.uint8).contiguous()
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if path == "tensor_core":
        err = _tensor_core(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask, out, None, ld,
                           b, n_q, n_kv, h, d, causal, q.device)
    else:
        lib = _build.load("attention", _SIGNATURES)
        err = lib.pk_mha(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(), ld,
            b, n_q, n_kv, h, d, int(causal), int(q.dtype == torch.bfloat16),
            float(d) ** -0.5, torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(err, "mha")
    mha.launches += 1
    mha.routes[path] += 1
    return out


mha.launches = 0
mha.routes = dict.fromkeys(ROUTES, 0)


def attention(q, k, v, *, causal: bool = False):
    """The towers' attention: :func:`mha` without a key mask."""
    return mha(q, k, v, causal=causal)


def qkv_fused_fits(head_dim: int) -> bool:
    """Whether :func:`mha_qkv`'s kernels take this head dim. Both stream keys
    through shared memory in 64-key tiles, so N and H are free (the JAX
    rule of the same name, which also takes them, bounds VMEM). D ≤ 128:
    a CUDA-core lane holds D/32 accumulators (a 16-row q block and one K
    and one V chunk in f32 are 74 KB of shared memory), and a tensor-core
    warp holds D/2 f32 accumulators and D/4 registers of q per lane (a
    block's 64 query rows, K and V tiles in bf16 and up to 80 KB of logits
    are at most 132 KB of the H100's 227 KB). Every ``CONFIGS`` entry fits,
    ViT-H-14-378 (D = 80, N = 730) included; the JAX package's VMEM rule
    rejects that one. The int8 path reaches no wider head, so the CUDA-core
    kernel's wide instantiation (D ≤ 512) serves :func:`mha` alone."""
    return 1 <= head_dim <= QKV_MAX_HEAD_DIM


def _check_qkv(qkv, heads):
    if qkv.dim() != 3 or qkv.shape[2] % (3 * heads):
        raise ValueError(f"qkv must be (B, N, 3·H·D) with H = {heads}, got {tuple(qkv.shape)}")
    if qkv.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"qkv must be f32 or bf16, got {qkv.dtype}")
    if qkv.shape[1] < 1:
        raise ValueError("attention needs at least one key")


def mha_qkv_plain(qkv, *, heads: int, causal: bool = False, out_scale=None):
    """Plain PyTorch version of :func:`mha_qkv`, in the arithmetic of the
    reference's ``_attn_qkv_kernel``."""
    _check_qkv(qkv, heads)
    b, n, w3 = qkv.shape
    w = w3 // 3
    q, k, v = (t.reshape(b, n, heads, w // heads) for t in qkv.split(w, dim=-1))
    out = _attend(q, k, v, causal, None).reshape(b, n, w)
    if out_scale is None:
        return out.to(qkv.dtype)
    return quantize_static(out, out_scale)


def mha_qkv(qkv, *, heads: int, causal: bool = False, out_scale=None):
    """Attention over the unsplit qkv projection output.

    qkv (B, N, 3·H·D), f32 or bf16, D ≤ 128 (:func:`qkv_fused_fits`).
    Returns (B, N, H·D) in qkv's dtype, or int8 at the static calibrated
    absmax ``out_scale`` (a scalar; a CUDA tensor stays on the device)."""
    if qkv.device.type == "cpu":
        return mha_qkv_plain(qkv, heads=heads, causal=causal, out_scale=out_scale)
    if qkv.device.type != "cuda":
        raise ValueError(f"mha_qkv: unsupported device {qkv.device}")
    _check_qkv(qkv, heads)
    b, n, w3 = qkv.shape
    w = w3 // 3
    d = w // heads
    if not qkv_fused_fits(d):
        raise ValueError(f"mha_qkv kernel supports D <= {QKV_MAX_HEAD_DIM}, got {d}")
    if not qkv.is_contiguous():
        raise ValueError("mha_qkv kernel needs a contiguous qkv")
    scale_t = None
    if out_scale is not None:
        scale_t = torch.as_tensor(out_scale, dtype=torch.float32, device=qkv.device).reshape(1)
        out = torch.empty((b, n, w), dtype=torch.int8, device=qkv.device)
    else:
        out = torch.empty((b, n, w), dtype=qkv.dtype, device=qkv.device)
    path = route(qkv.dtype, d)
    if path == "tensor_core":
        base, part = qkv.data_ptr(), w * qkv.element_size()  # q | k | v, no split copies
        err = _tensor_core(base, base + part, base + 2 * part, None, out, scale_t, w3, b, n, n,
                           heads, d, causal, qkv.device)
    else:
        lib = _build.load("attention", _SIGNATURES)
        err = lib.pk_mha_qkv(
            qkv.data_ptr(), out.data_ptr(), None if scale_t is None else scale_t.data_ptr(),
            b, n, heads, d, int(causal), int(qkv.dtype == torch.bfloat16), float(d) ** -0.5,
            torch.cuda.current_stream(qkv.device).cuda_stream,
        )
    _build.check(err, "mha_qkv")
    mha_qkv.launches += 1
    mha_qkv.routes[path] += 1
    return out


mha_qkv.launches = 0
mha_qkv.routes = dict.fromkeys(ROUTES, 0)
