"""What several metric readers share: kernel families and the device's idle
share, read from a traced slice."""

from __future__ import annotations

import re

from benchmark.roofline import PEAK_OPS_PER_S, rescore_ops, scan_roofline

# Kernels of the port's own CUDA sources (csrc/*.cu): B1, B2, B3/B4 and their
# backward, B5.
PORT_KERNEL = re.compile(r"\b(int8_topk_(v2_)?kernel|mha_\w*kernel|ln_quant_kernel)\b")
# Library GEMM and GEMV kernels (cuBLAS, cuBLASLt, CUTLASS), by name; of
# them the int8 ones name their s8 (or i8, imma) operands.
GEMM = re.compile(r"gemm|gemv|xmma|cutlass|nvjet", re.IGNORECASE)
INT8 = re.compile(r"_s8|s8s8|_i8|int8|imma", re.IGNORECASE)


def is_port_kernel(op) -> bool:
    return PORT_KERNEL.search(op.name) is not None


def is_gemm(op) -> bool:
    return not op.is_copy and GEMM.search(op.name) is not None


def is_int8_gemm(op) -> bool:
    return is_gemm(op) and INT8.search(op.name) is not None


def idle_pct(r):
    s = r.slice
    if s is None or s.wall_s <= 0 or not s.ops:
        return None
    return 100.0 * (1.0 - s.busy_s / s.wall_s)


def scan_share(r, kernel: str):
    """A scan kernel's bound (``scan_roofline`` at the cell's shapes, once a
    batch) over its device time in the slice, in %."""
    s = r.slice
    if s is None or not s.steps:
        return None
    t = s.kernel_seconds(kernel)
    if not t:
        return None
    q, kk = r.traffic["queries_per_batch"], r.traffic["k"] * r.traffic["oversample"]
    bound = scan_roofline(q, r.config["space"]["rows"], r.config["embed_dim"], kk)["bound_s"]
    return 100.0 * bound * s.steps / t


SCAN = re.compile(r"\bint8_topk_(v2_)?kernel\b")


def rescore_ms(r):
    """Device milliseconds a batch of the search's kernels other than the
    scan (B1 or B2), copies left out."""
    s = r.slice
    if s is None or not s.steps:
        return None
    t = s.seconds(lambda op: not op.is_copy and not SCAN.search(op.name))
    return 1e3 * t / s.steps if t else None


def search_mfu(r, seconds):
    """The search's int8 operations (the scan's 2·Q·N·D and the rescore's
    4·Q·kk·D) times the slice's batches, over ``seconds``, as a share of
    the card's int8 peak, in %."""
    if not r.steps or not seconds or seconds <= 0:
        return None
    t, c = r.traffic, r.config
    q, kk = t["queries_per_batch"], t["k"] * t["oversample"]
    n, d = c["space"]["rows"], c["embed_dim"]
    ops = 2.0 * q * n * d + rescore_ops(q, kk, d)
    return 100.0 * ops * r.steps / seconds / PEAK_OPS_PER_S["int8"]
