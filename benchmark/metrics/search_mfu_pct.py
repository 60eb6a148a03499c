"""search_mfu_pct (%, device_trace): the search batch's share of the card's
int8 peak: the scan's 2·Q·N·D operations and the rescore's 4·Q·kk·D, times
the batches of the traced slice, over the card's busy seconds in the slice
(search_device_ms's measure), over 1,979 TOP/s (published H100 SXM int8
peak at 700 W; the run reports the card's limit beside it)."""

from benchmark.metrics_common import search_mfu


def read(r):
    return search_mfu(r, r.slice.busy_s if r.slice is not None else None)
