"""device_idle_pct.caption (%, device_trace): the share of the traced slice's
wall in which no kernel, copy or memset ran on the card (the union of their
spans, so overlapping operations count once)."""

from benchmark.metrics_common import idle_pct


def read(r):
    return idle_pct(r)
