"""rescore_device_ms (ms, device_trace): device time a batch of the search's
kernels other than the scan B1: the query codec, the candidates' merge, the
gathers, the exact f32 rescore and its top-k. Copies are left out."""

from benchmark.metrics_common import rescore_ms


def read(r):
    return rescore_ms(r)
