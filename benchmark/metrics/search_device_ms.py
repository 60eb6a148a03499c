"""search_device_ms (ms, device_trace): the card's busy time a batch of
similar_to queries, over the whole untraced window: the union of every
kernel, copy and memset the profiler recorded on the card while the window
ran (the query codec, the scan B1 or B2, the candidates' merge, the f32
rescore, the readback of the answers), over the batches completed. The host's
work, the id map among it, is not in it."""


def read(r):
    s = r.slice
    return 1e3 * s.busy_s / s.steps if s is not None and s.steps and s.busy_s > 0 else None
