"""search_mfu_pct.b2 (%, host_clock): the whole search batch's share of the
card's int8 peak where the scan is B2: the scan's 2·Q·N·D operations and the
rescore's 4·Q·kk·D, times the batches of the traced slice, over its wall
seconds (search_qps's measure), over 1,979 TOP/s (published H100 SXM int8
peak at 700 W; the run reports the card's limit beside it)."""

from benchmark.metrics_common import search_mfu


def read(r):
    return search_mfu(r, r.window_s)
