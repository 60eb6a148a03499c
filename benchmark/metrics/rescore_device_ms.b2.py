"""rescore_device_ms.b2 (ms, device_trace): rescore_device_ms where the scan
is B2: device time a batch of the search's kernels other than B2. Copies are
left out."""

from benchmark.metrics_common import rescore_ms


def read(r):
    return rescore_ms(r)
