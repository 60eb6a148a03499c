"""Fused LayerNorm → static-scale int8 quantize — kernel B5 of the port.

Port of ``panoptikon_tpu/ops/ln_quant.py``. In the calibrated static-int8
CLIP block every LayerNorm output exists only to be quantized as the next
GEMM's input; the kernel (``csrc/ln_quant.cu``) reads each row once, 16
bytes a load, takes f32 statistics (the mean, then the centered variance),
normalizes, applies γ/β and writes int8 at the calibrated per-tensor scale,
8 codes a store. Its division by the scale's step is a multiplication by
the step's reciprocal and one exact correction; :func:`check_quant_code`
holds the codes it gives against a correctly rounded division over every
float.

:func:`ln_quant_2d` launches the kernel for CUDA tensors and takes
:func:`ln_quant_plain` (the arithmetic of the reference's ``_ln_quant_ref``)
for CPU tensors; any other device raises. :func:`ln_quant` is the N-d
wrapper the CLIP block calls. Both raise ``ValueError`` on the card under
grad (an input requiring it): the kernel has no backward. The JAX package's production path calls the
``jnp`` form because on the TPU the Pallas boundary cost more than the pass
it saved; that was a TPU measurement, so on the card the port calls the
kernel, and ``chip_smoke.py`` times the two.
"""

from __future__ import annotations

import ctypes

import torch

from panoptikon_tpu_torch import _build
from panoptikon_tpu_torch.ops import refuse_grad
from panoptikon_tpu_torch.ops.codec import quantize_static

_SIGNATURES = {
    "pk_ln_quant": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    "pk_check_quant_code": [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p],
}
MAX_WIDTH = 2048  # a lane holds at most 64 of a row's values in registers
GROUP = 8  # elements a lane loads (16 bytes of bf16) and stores at once


def _check(x, gamma, beta):
    if x.dim() != 2:
        raise ValueError(f"x must be (R, W), got {tuple(x.shape)}")
    w = x.shape[1]
    if tuple(gamma.shape) != (w,) or tuple(beta.shape) != (w,):
        raise ValueError(f"gamma {tuple(gamma.shape)} / beta {tuple(beta.shape)} must be ({w},)")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be f32 or bf16, got {x.dtype}")
    if not (x.device == gamma.device == beta.device):
        raise ValueError("x, gamma and beta must be on one device")


def ln_quant_plain(x, gamma, beta, act_scale):
    """Plain PyTorch version of :func:`ln_quant_2d`: (R, W) -> (R, W) int8."""
    _check(x, gamma, beta)
    x = x.to(torch.float32)
    mean = x.mean(dim=-1, keepdim=True)
    xc = x - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + 1e-5)
    y = y * gamma.to(torch.float32) + beta.to(torch.float32)
    return quantize_static(y, act_scale)


def ln_quant_2d(x, gamma, beta, act_scale):
    """(R, W) f32 or bf16 activations -> (R, W) int8: LN(x)·γ+β quantized at
    the calibrated per-tensor absmax ``act_scale`` (a scalar; a CUDA tensor
    stays on the device). The kernel takes W ≤ 2048 with W % 8 == 0 and a
    16-byte aligned x."""
    if x.device.type == "cpu":
        return ln_quant_plain(x, gamma, beta, act_scale)
    if x.device.type != "cuda":
        raise ValueError(f"ln_quant_2d: unsupported device {x.device}")
    refuse_grad("ln_quant_2d", x, gamma, beta, act_scale)
    _check(x, gamma, beta)
    r, w = x.shape
    if w > MAX_WIDTH or w % GROUP:
        raise ValueError(f"ln_quant kernel takes W <= {MAX_WIDTH}, a multiple of {GROUP}; got {w}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("ln_quant kernel needs a contiguous, 16-byte aligned x")
    g = gamma.to(torch.float32).contiguous()
    b = beta.to(torch.float32).contiguous()
    s = torch.as_tensor(act_scale, dtype=torch.float32, device=x.device).reshape(1)
    out = torch.empty((r, w), dtype=torch.int8, device=x.device)
    lib = _build.load("ln_quant", _SIGNATURES)
    err = lib.pk_ln_quant(
        x.data_ptr(), g.data_ptr(), b.data_ptr(), s.data_ptr(), out.data_ptr(),
        r, w, int(x.dtype == torch.bfloat16), torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "ln_quant")
    ln_quant_2d.launches += 1
    return out


ln_quant_2d.launches = 0


def check_quant_code(act_scales: torch.Tensor) -> torch.Tensor:
    """For each calibrated absmax in ``act_scales`` (f32, on the card), the
    number of floats y (every bit pattern) whose code in the kernel differs
    from ``clip(rint(y / sx), -127, 127)`` with a correctly rounded
    division (``__fdiv_rn``), sx = max(s / 127, 1e-12). Returns (n,) int64
    counts; all zero when the kernel's division keeps the reference's
    codes."""
    if act_scales.device.type != "cuda" or act_scales.dtype != torch.float32:
        raise ValueError("check_quant_code takes f32 absmax values on the card")
    s = act_scales.contiguous()
    counts = torch.zeros(s.numel(), dtype=torch.int64, device=s.device)
    lib = _build.load("ln_quant", _SIGNATURES)
    err = lib.pk_check_quant_code(s.data_ptr(), s.numel(), counts.data_ptr(),
                                  torch.cuda.current_stream(s.device).cuda_stream)
    _build.check(err, "check_quant_code")
    return counts


def ln_quant(x, ln_params, act_scale):
    """(…, W) -> int8 of the same shape, through :func:`ln_quant_2d` (which,
    on the card, raises under grad: B5 has no backward)."""
    if x.device.type == "cuda":
        refuse_grad("ln_quant", x, ln_params["scale"], ln_params["bias"], act_scale)
    w = x.shape[-1]
    out = ln_quant_2d(x.reshape(-1, w), ln_params["scale"], ln_params["bias"], act_scale)
    return out.reshape(x.shape)
