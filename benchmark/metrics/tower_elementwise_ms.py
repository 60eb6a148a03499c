"""tower_elementwise_ms (ms, device_trace): device time a batch in kernels
that are neither a GEMM nor one of the port's own kernels: the casts,
scales, adds, LayerNorms, GELUs and copy kernels between them. Copies
between host and card (Memcpy, Memset) are left out."""

from benchmark.metrics_common import is_gemm, is_port_kernel


def read(r):
    s = r.slice
    if s is None or not s.steps:
        return None
    t = s.seconds(lambda op: not op.is_copy and not is_gemm(op) and not is_port_kernel(op))
    return 1e3 * t / s.steps if t else None
