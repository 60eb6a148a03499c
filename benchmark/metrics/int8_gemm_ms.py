"""int8_gemm_ms (ms, device_trace): device time a batch in the int8 GEMMs
that ``torch._int_mm`` (``ops/exact.int_mm``) runs through cuBLASLt: library
GEMM kernels whose names give s8 operands (``metrics_common.is_int8_gemm``)."""

from benchmark.metrics_common import is_int8_gemm


def read(r):
    s = r.slice
    if s is None or not s.steps:
        return None
    t = s.seconds(is_int8_gemm)
    return 1e3 * t / s.steps if t else None
