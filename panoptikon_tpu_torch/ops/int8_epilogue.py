"""The fused epilogue of the static-int8 CLIP block's int8 GEMMs.

Each int8 GEMM of ``models/clip.py::_block_int8_static`` gives an (R, N)
int32 output, and its consumer reads bf16 or int8. The kernel
(``csrc/int8_epilogue.cu``) reads the int32 output once and writes what the
consumer reads, in one of three modes:

- bf16 out (qkv): ``bf16((f32(acc)·sx)·sw + b)``;
- plus the residual (out, proj): ``x + bf16(...)``, added in f32 and
  rounded to bf16, as PyTorch adds two bf16 tensors;
- GELU and the next GEMM's static quantize (fc): ``h = bf16(gelu_tanh(
  bf16(...)))``, then ``clip(round(h / s3), -127, 127)`` as int8.

``sx`` and ``s3`` are static steps (``codec.static_step`` of a calibrated
absmax, f32 tensors that stay on the device), ``sw`` the GEMM's
per-output-channel weight scales and ``b`` its bias. It replaces no TPU
kernel: XLA fuses this chain on the TPU, where PyTorch runs each operation
as its own pass over the output.

:func:`int8_epilogue` launches the kernel for CUDA tensors, counting
``.launches``, and takes :func:`int8_epilogue_plain` (the chain the kernel
replaces, operation by operation) for CPU tensors; any other device raises,
as does a CUDA call under grad: the kernel has no backward. The kernel keeps
the plain chain's rounding points, so the first two modes are bit-equal to
it on the card; in the third, GELU's tanh may round apart from PyTorch's
by an ulp, which moves a bf16 ``h`` and so at most one code, rarely.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from panoptikon_tpu_torch import _build
from panoptikon_tpu_torch.ops import refuse_grad

_SIGNATURES = {
    "pk_int8_epilogue": ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6
                         + [ctypes.c_int] * 3 + [ctypes.c_void_p]),
}
VEC = 4  # int32 values a lane loads at once (16 bytes)
_MODES = {"bf16": 0, "residual": 1, "gelu_quant": 2}


def _check(acc, step, sw, b, residual, out_step):
    if acc.dim() != 2 or acc.dtype != torch.int32:
        raise ValueError(f"acc must be (R, N) int32, got {tuple(acc.shape)} {acc.dtype}")
    n = acc.shape[1]
    if sw.numel() != n or (b is not None and b.numel() != n):
        raise ValueError(f"sw and b must hold {n} values, got {sw.numel()} and "
                         f"{None if b is None else b.numel()}")
    if residual is not None and out_step is not None:
        raise ValueError("int8_epilogue takes a residual or an out_step, not both")
    if residual is not None and tuple(residual.shape) != tuple(acc.shape):
        raise ValueError(f"residual {tuple(residual.shape)} must be {tuple(acc.shape)}")
    for t in (step, out_step):
        if t is not None and (t.numel() != 1 or t.dtype != torch.float32):
            raise ValueError("step and out_step must be one f32 value each")
    tensors = [t for t in (acc, step, sw, b, residual, out_step) if t is not None]
    if any(t.device != acc.device for t in tensors):
        raise ValueError("int8_epilogue's operands must be on one device")


def int8_epilogue_plain(acc, step, sw, b, residual=None, out_step=None):
    """Plain PyTorch version of :func:`int8_epilogue`: the chain of passes
    the kernel fuses."""
    _check(acc, step, sw, b, residual, out_step)
    y = acc.to(torch.float32) * step * sw
    if b is not None:
        y = y + b.to(torch.float32)
    y = y.to(torch.bfloat16)
    if residual is not None:
        return residual + y
    if out_step is not None:
        h = F.gelu(y, approximate="tanh").to(torch.float32)
        return torch.clamp(torch.round(h / out_step), -127.0, 127.0).to(torch.int8)
    return y


def int8_epilogue(acc, step, sw, b, residual=None, out_step=None):
    """(R, N) int32 GEMM output -> (R, N) bf16, or int8 with ``out_step``.

    ``step`` is the GEMM input's static step and ``sw`` (N values) its
    weight's scales, ``b`` (N values) the bias or None, ``residual`` an
    (R, N) bf16 tensor to add, ``out_step`` the step to quantize GELU's
    output at. On the card ``acc`` may have a row stride (a padded
    ``int_mm`` output cut back) and takes N % 4 == 0; ``sw`` and ``b`` are
    read as contiguous f32, and copied to that first if they are not (the
    block's are stored so, by ``clip.quantize_block_weights``)."""
    if acc.device.type == "cpu":
        return int8_epilogue_plain(acc, step, sw, b, residual, out_step)
    if acc.device.type != "cuda":
        raise ValueError(f"int8_epilogue: unsupported device {acc.device}")
    refuse_grad("int8_epilogue", acc, step, sw, b, residual, out_step)
    _check(acc, step, sw, b, residual, out_step)
    r, n = acc.shape
    if n % VEC or acc.stride(1) != 1 or acc.stride(0) % VEC or acc.data_ptr() % 16:
        raise ValueError(f"int8_epilogue kernel takes N % {VEC} == 0 and 16-byte aligned rows "
                         f"of acc; got N {n}, strides {acc.stride()}")
    sw, b = (t if t is None or (t.dtype == torch.float32 and t.is_contiguous())
             else t.to(torch.float32).contiguous() for t in (sw, b))
    if residual is not None:
        if residual.dtype != torch.bfloat16:
            raise ValueError(f"the residual must be bf16, got {residual.dtype}")
        residual = residual.contiguous()
    if any(t.data_ptr() % 16 for t in (sw, b, residual) if t is not None):
        raise ValueError("int8_epilogue kernel needs 16-byte aligned sw, b and residual")
    mode = "residual" if residual is not None else "gelu_quant" if out_step is not None else "bf16"
    out = torch.empty((r, n), dtype=torch.int8 if mode == "gelu_quant" else torch.bfloat16,
                      device=acc.device)
    b_ptr, res_ptr, out_step_ptr = (None if t is None else t.data_ptr()
                                    for t in (b, residual, out_step))
    lib = _build.load("int8_epilogue", _SIGNATURES)
    err = lib.pk_int8_epilogue(
        acc.data_ptr(), acc.stride(0), step.data_ptr(), sw.data_ptr(), b_ptr, res_ptr,
        out_step_ptr, out.data_ptr(), r, n, _MODES[mode],
        torch.cuda.current_stream(acc.device).cuda_stream,
    )
    _build.check(err, "int8_epilogue")
    int8_epilogue.launches += 1
    return out


int8_epilogue.launches = 0
