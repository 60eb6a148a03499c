"""index_add_ms (ms, program_span): host seconds a batch in VectorIndex.add
(the batch's rows appended to the space), over the traced slice."""


def read(r):
    t = r.spans.get("index_add")
    return 1e3 * t / r.steps if t and r.steps else None
