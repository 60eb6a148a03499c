"""Multi-head attention — kernel 2 of the port.

Port of ``panoptikon_tpu/ops/vit_attention.py::mha`` (and ``attention``,
its caller-facing name). Four modes through one kernel
(``csrc/attention.cu``): self, causal, key-padding masked (additive −1e9,
so a fully masked row gives uniform probabilities, never NaN) and cross
(N_q ≠ N_kv). Softmax in f32; probabilities are rounded to V's dtype before
the AV product, which accumulates in f32; the output is in q's dtype.

Layout: q (B, N_q, H, D), k and v (B, N_kv, H, D) — the (B, N, H·D)
activations the towers produce, viewed per head.

:func:`mha` launches the kernel for CUDA tensors and takes
:func:`mha_plain` for CPU tensors; any other device raises. Unlike the JAX
``attention``, which picks by the default backend, the choice follows the
tensor.
"""

from __future__ import annotations

import ctypes

import torch

from panoptikon_tpu_torch import _build

_SIGNATURES = {
    "pk_mha": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p],
}
MAX_HEAD_DIM = 128


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


def mha_plain(q, k, v, *, causal: bool = False, key_mask=None):
    """Plain PyTorch version of :func:`mha`, in the reference's arithmetic."""
    _check(q, k, v, causal, key_mask)
    n_q, n_kv, d = q.shape[1], k.shape[1], q.shape[3]
    lt = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32), k.to(torch.float32)) * (float(d) ** -0.5)
    if causal:
        keep = torch.arange(n_kv, device=q.device)[None, :] <= torch.arange(n_q, device=q.device)[:, None]
        lt = torch.where(keep, lt, -torch.inf)
    if key_mask is not None:
        valid = (key_mask.to(torch.float32) > 0)[:, None, None, :]
        lt = torch.where(valid, lt, lt - 1e9)
    e = torch.exp(lt - lt.amax(dim=-1, keepdim=True))
    p = (e / e.sum(dim=-1, keepdim=True)).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(torch.float32), v.to(torch.float32))
    return out.to(q.dtype)


def mha(q, k, v, *, causal: bool = False, key_mask=None):
    """Fused multi-head attention. q (B, N_q, H, D); k, v (B, N_kv, H, D),
    f32 or bf16, D ≤ 128; ``key_mask`` (B, N_kv), truthy for valid keys;
    ``causal`` needs N_q == N_kv. Returns (B, N_q, H, D) in q's dtype."""
    if q.device.type == "cpu":
        return mha_plain(q, k, v, causal=causal, key_mask=key_mask)
    if q.device.type != "cuda":
        raise ValueError(f"mha: unsupported device {q.device}")
    _check(q, k, v, causal, key_mask)
    b, n_q, h, d = q.shape
    n_kv = k.shape[1]
    if d > MAX_HEAD_DIM:
        raise ValueError(f"mha kernel supports D <= {MAX_HEAD_DIM}, got {d}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("mha kernel needs contiguous q, k, v")
    mask = None
    if key_mask is not None:
        mask = (key_mask.to(torch.float32) > 0).to(torch.uint8).contiguous()
    out = torch.empty_like(q)
    lib = _build.load("attention", _SIGNATURES)
    err = lib.pk_mha(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if mask is None else mask.data_ptr(), out.data_ptr(),
        b, n_q, n_kv, h, d, int(causal), int(q.dtype == torch.bfloat16),
        float(d) ** -0.5, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "mha")
    mha.launches += 1
    return out


mha.launches = 0


def attention(q, k, v, *, causal: bool = False):
    """The towers' attention: :func:`mha` without a key mask."""
    return mha(q, k, v, causal=causal)
