"""b1_roofline_pct (%, device_trace): kernel B1's bound over its device time
in the traced slice. The bound is ``roofline.scan_roofline`` at the cell's
shapes (Q queries a batch, the space's N rows of D codes, k·oversample
kept), once a batch: 2·Q·N·D int8 operations at 1,979 TOP/s, or the bytes
read and written once at 3.35 TB/s, whichever is longer (published H100 SXM
peaks at its 700 W limit; the run reports the card's limit beside it)."""

from benchmark.metrics_common import scan_share

KERNEL = r"\bint8_topk_kernel\b"


def read(r):
    return scan_share(r, KERNEL)
