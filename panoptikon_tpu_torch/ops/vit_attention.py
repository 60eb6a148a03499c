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

:func:`mha` is differentiable. Where grad mode is on and q, k or v requires
grad it runs as a ``torch.autograd.Function``: the same forward launch (or
plain version on the CPU), then :func:`mha_backward`, B3's backward
(``csrc/attention_bwd.cu`` on the card, :func:`mha_backward_plain` on the
CPU), for dq, dk and dv. On the card :func:`backward_route` picks its
kernel as :func:`route` picks the forward's: ``"tensor_core"``
(:func:`mha_backward_tensor_core`, one block a (batch row, head), the five
products on ``mma.sync``) where the forward's test holds and N_q, N_kv ≤
:data:`BWD_TC_MAX_ROWS`, else ``"cuda_core"``
(:func:`mha_backward_cuda_core`, f32 arithmetic, up to D 512).
``key_mask`` and ``causal`` take no gradient. The Function saves q, k, v
as given: views of a fused qkv keep the qkv alive, which holds exactly
their bytes. Inference calls launch directly and save
nothing. :func:`mha_qkv` (B4) has no backward: on the card it raises
``ValueError`` under grad rather than drop the gradient.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from panoptikon_tpu_torch import _build
from panoptikon_tpu_torch.ops import refuse_grad
from panoptikon_tpu_torch.ops.codec import quantize_static

_SIGNATURES = {
    "pk_mha": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p],
    "pk_mha_qkv": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p],
    "pk_mha_tc": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    "pk_check_div_rn": [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p],
}
_BACKWARD_SIGNATURES = {
    "pk_mha_bwd": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p],
    "pk_mha_bwd_tc": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p],
}
MAX_HEAD_DIM = 512  # mha's: the CUDA-core kernel's wide instantiation
QKV_MAX_HEAD_DIM = 128  # mha_qkv's, and the tensor-core kernel's
ROUTES = ("tensor_core", "cuda_core")
# The longest key axis whose logits the tensor-core kernel keeps in shared
# memory; longer ones take the two-pass form. A block's 64 query rows × 320
# keys of f32 logits, with the bf16 q, K and V tiles, take at most 132 KB of
# its 227 KB, at D = 128.
TC_LOGITS_MAX_KEYS = 320
# The tensor-core backward holds one (batch row, head)'s q, K, V, dO, p~ and
# dS whole in a block's shared memory: N_q and N_kv up to this many rows
# (208,896 bytes at D 128, of the H100's 232,448 a block).
BWD_TC_MAX_ROWS = 128


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


def backward_route(dtype: torch.dtype, head_dim: int, n_q: int, n_kv: int) -> str:
    """The kernel a CUDA call of :func:`mha_backward` launches:
    ``"tensor_core"`` where the forward's own test holds (:func:`route`:
    bf16, 32 ≤ D ≤ 128, D % 16 == 0) and N_q, N_kv ≤ :data:`BWD_TC_MAX_ROWS`
    — every shape training gives B3 — else ``"cuda_core"``. Past
    :data:`MAX_HEAD_DIM` it raises ``ValueError``, as :func:`route` does."""
    if route(dtype, head_dim) == "tensor_core" and max(n_q, n_kv) <= BWD_TC_MAX_ROWS:
        return "tensor_core"
    return "cuda_core"


def _check_aligned(ptrs, ld, what, names="q, k, v"):
    if any(ptr % 16 for ptr in ptrs) or ld % 8:
        raise ValueError(f"the tensor-core {what} kernel needs 16-byte aligned {names} rows")


def _tensor_core(q_ptr, k_ptr, v_ptr, mask, out, scale_t, ld, b, n_q, n_kv, h, d, causal,
                 device):
    """Launch ``pk_mha_tc`` on bf16 operands given by base pointer and row
    stride ``ld`` (elements)."""
    _check_aligned((q_ptr, k_ptr, v_ptr), ld, "attention")
    lib = _build.load("attention", _SIGNATURES)
    return lib.pk_mha_tc(
        q_ptr, k_ptr, v_ptr, None if mask is None else mask.data_ptr(), out.data_ptr(),
        None if scale_t is None else scale_t.data_ptr(), ld, b, n_q, n_kv, h, d, int(causal),
        float(d) ** -0.5, int(n_kv <= TC_LOGITS_MAX_KEYS),
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


def _probs(q, k, causal, key_mask):
    """The softmax probabilities (B, H, N_q, N_kv) in f32, unrounded, in the
    reference's arithmetic."""
    n_q, n_kv, d = q.shape[1], k.shape[1], q.shape[3]
    lt = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32), k.to(torch.float32)) * (float(d) ** -0.5)
    if causal:
        keep = torch.arange(n_kv, device=q.device)[None, :] <= torch.arange(n_q, device=q.device)[:, None]
        lt = torch.where(keep, lt, -torch.inf)
    if key_mask is not None:
        valid = (key_mask.to(torch.float32) > 0)[:, None, None, :]
        lt = torch.where(valid, lt, lt - 1e9)
    e = torch.exp(lt - lt.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def _rounded(p, v):
    """p as the AV product takes it: rounded to V's dtype at D ≥ 32."""
    return p.to(v.dtype).to(torch.float32) if v.shape[3] >= 32 else p


def _attend(q, k, v, causal, key_mask):
    """The attention output in f32, before its final cast, in the reference's
    arithmetic."""
    p = _rounded(_probs(q, k, causal, key_mask), v)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.to(torch.float32))


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


def _forward(q, k, v, causal, key_mask):
    """One forward call: the plain version on the CPU, else the kernel."""
    if q.device.type == "cpu":
        return mha_plain(q, k, v, causal=causal, key_mask=key_mask)
    _check(q, k, v, causal, key_mask)
    b, n_q, h, d = q.shape
    n_kv = k.shape[1]
    path = route(q.dtype, d)
    ld = _launch_stride(q, k, v)
    mask = _mask_bytes(key_mask)
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


def _launch_stride(q, k, v):
    ld = row_stride(q, k, v)
    if ld is None:
        raise ValueError("mha kernel needs contiguous q, k, v or views that share one row "
                         "stride, such as the split of a fused qkv")
    return ld


def _mask_bytes(key_mask):
    """The key mask as the kernels read it: (B, N_kv) uint8, 1 for a valid key."""
    if key_mask is None:
        return None
    return (key_mask.to(torch.float32) > 0).to(torch.uint8).contiguous()


class _Mha(torch.autograd.Function):
    """:func:`mha` with B3's backward (:func:`mha_backward`)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, key_mask):
        out = _forward(q, k, v, causal, key_mask)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, out, key_mask)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        q, k, v, out, key_mask = ctx.saved_tensors
        dq, dk, dv = mha_backward(q, k, v, out, dout, causal=ctx.causal, key_mask=key_mask)
        return dq, dk, dv, None, None


def mha(q, k, v, *, causal: bool = False, key_mask=None):
    """Fused multi-head attention. q (B, N_q, H, D); k, v (B, N_kv, H, D),
    f32 or bf16, D ≤ 512; ``key_mask`` (B, N_kv), truthy for valid keys;
    ``causal`` needs N_q == N_kv. Returns (B, N_q, H, D) in q's dtype. On
    CUDA q, k, v are contiguous or views sharing one row stride
    (:func:`row_stride`); past D 512 it raises and launches nothing. Under
    grad (grad mode on, q, k or v requiring it) the call is differentiable
    in q, k and v through :func:`mha_backward`."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"mha: unsupported device {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _Mha.apply(q, k, v, causal, key_mask)
    return _forward(q, k, v, causal, key_mask)


mha.launches = 0
mha.routes = dict.fromkeys(ROUTES, 0)


def _check_backward(q, out, dout):
    for name, t in (("out", out), ("dout", dout)):
        if t is None:  # the kernels' launchers take no out
            continue
        if tuple(t.shape) != tuple(q.shape) or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must be (B, N_q, H, D) = {tuple(q.shape)} in {q.dtype} on "
                             f"{q.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")


def mha_backward_plain(q, k, v, out, dout, *, causal: bool = False, key_mask=None):
    """Plain PyTorch version of :func:`mha_backward`: (dq, dk, dv) in q's
    dtype, computed in f32 in the kernel's form. With p the forward's
    unrounded probabilities and p̃ p rounded to V's dtype (at D ≥ 32, as
    the forward rounds it): dV = p̃ᵀ·dO, dP = dO·Vᵀ, delta = rowsum(p∘dP),
    dS = p∘(dP − delta), dQ = dS·K·D^-½, dK = dSᵀ·Q·D^-½ — the gradient
    straight through the rounding of p, with delta from p∘dP in f32 (not
    from dO∘O, whose O is rounded to q's dtype). ``out`` is the forward's
    output; this form does not read it beyond checking its shape."""
    _check(q, k, v, causal, key_mask)
    _check_backward(q, out, dout)
    scale = float(q.shape[3]) ** -0.5
    qf, kf, vf, df = (t.to(torch.float32) for t in (q, k, v, dout))
    p = _probs(q, k, causal, key_mask)
    dv = torch.einsum("bhqk,bqhd->bkhd", _rounded(p, v), df)
    dp = torch.einsum("bqhd,bkhd->bhqk", df, vf)
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def mha_backward(q, k, v, out, dout, *, causal: bool = False, key_mask=None):
    """B3's backward: the gradient of :func:`mha` with respect to q, k and v,
    given the forward's inputs, its output ``out`` and ``dout`` (B, N_q, H,
    D) in q's dtype. Returns (dq, dk, dv), contiguous, in q's dtype. On
    CUDA it launches the kernel :func:`backward_route` picks
    (:func:`mha_backward_tensor_core` or :func:`mha_backward_cuda_core`,
    ``csrc/attention_bwd.cu``; q, k, v read in place at one row stride); on
    the CPU it takes :func:`mha_backward_plain`."""
    if q.device.type == "cpu":
        return mha_backward_plain(q, k, v, out, dout, causal=causal, key_mask=key_mask)
    if q.device.type != "cuda":
        raise ValueError(f"mha_backward: unsupported device {q.device}")
    _check(q, k, v, causal, key_mask)
    _check_backward(q, out, dout)
    path = backward_route(q.dtype, q.shape[3], q.shape[1], k.shape[1])
    launch = mha_backward_tensor_core if path == "tensor_core" else mha_backward_cuda_core
    return launch(q, k, v, dout, causal=causal, key_mask=key_mask)


def _backward_operands(q, k, v, dout, causal, key_mask):
    """The checked launch operands of a backward kernel: (ld, mask bytes,
    contiguous dout, empty dq, dk, dv)."""
    _check(q, k, v, causal, key_mask)
    _check_backward(q, None, dout)
    if q.device.type != "cuda":
        raise ValueError(f"mha_backward kernels take CUDA tensors, got {q.device}")
    if q.shape[3] > MAX_HEAD_DIM:
        raise ValueError(f"mha_backward kernel supports D <= {MAX_HEAD_DIM}, got {q.shape[3]}")
    grads = tuple(torch.empty(t.shape, dtype=q.dtype, device=q.device) for t in (q, k, v))
    return _launch_stride(q, k, v), _mask_bytes(key_mask), dout.contiguous(), grads


def _count_backward(path):
    mha_backward.launches += 1
    mha_backward.routes[path] += 1


def mha_backward_tensor_core(q, k, v, dout, *, causal: bool = False, key_mask=None):
    """Launch ``pk_mha_bwd_tc``: one block a (head, batch row), the five
    products on the tensor cores. Takes what :func:`backward_route` sends to
    ``"tensor_core"`` and 16-byte aligned q, k, v and dout rows (``ld % 8 ==
    0``), else raises ``ValueError``; it never falls back to the other
    kernel."""
    ld, mask, dout, (dq, dk, dv) = _backward_operands(q, k, v, dout, causal, key_mask)
    b, n_q, h, d = q.shape
    n_kv = k.shape[1]
    if backward_route(q.dtype, d, n_q, n_kv) != "tensor_core":
        raise ValueError(f"the tensor-core backward takes bf16, D in 32..128 (a multiple of 16) "
                         f"and N_q, N_kv <= {BWD_TC_MAX_ROWS}; got {q.dtype}, D {d}, "
                         f"N_q {n_q}, N_kv {n_kv}")
    _check_aligned((q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr()), ld,
                   "attention backward", "q, k, v and dout")
    lib = _build.load("attention_bwd", _BACKWARD_SIGNATURES)
    err = lib.pk_mha_bwd_tc(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None if mask is None else mask.data_ptr(),
        dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), ld, b, n_q, n_kv, h, d,
        int(causal), float(d) ** -0.5, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "mha_backward")
    _count_backward("tensor_core")
    return dq, dk, dv


def mha_backward_cuda_core(q, k, v, dout, *, causal: bool = False, key_mask=None):
    """Launch ``pk_mha_bwd``: three kernels on the CUDA cores in f32, every
    form, dtype and head dim (≤ :data:`MAX_HEAD_DIM`) :func:`mha` takes."""
    ld, mask, dout, (dq, dk, dv) = _backward_operands(q, k, v, dout, causal, key_mask)
    b, n_q, h, d = q.shape
    n_kv = k.shape[1]
    stats = torch.empty((3, b, h, n_q), dtype=torch.float32, device=q.device)
    lib = _build.load("attention_bwd", _BACKWARD_SIGNATURES)
    err = lib.pk_mha_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None if mask is None else mask.data_ptr(),
        dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(), ld,
        b, n_q, n_kv, h, d, int(causal), int(q.dtype == torch.bfloat16), float(d) ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "mha_backward")
    _count_backward("cuda_core")
    return dq, dk, dv


mha_backward.launches = 0
mha_backward.routes = dict.fromkeys(ROUTES, 0)


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
    refuse_grad("mha_qkv", qkv, out_scale)
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
