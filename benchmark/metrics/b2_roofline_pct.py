"""b2_roofline_pct (%, device_trace): kernel B2's bound over its device time
in the traced slice, with B1's bound arithmetic (``b1_roofline_pct``): 2·Q·N·D
int8 operations at 1,979 TOP/s or the bytes once at 3.35 TB/s (published H100
SXM peaks at 700 W)."""

from benchmark.metrics_common import scan_share

KERNEL = r"\bint8_topk_v2_kernel\b"


def read(r):
    return scan_share(r, KERNEL)
