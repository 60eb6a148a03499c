"""item_ids_ms (ms, program_span): host seconds a batch in
DeviceIndex.item_ids (the rows' readback and the group map), over the traced
slice. The traced run synchronizes before the call, so the span holds no
wait for the search."""


def read(r):
    t = r.spans.get("item_ids")
    return 1e3 * t / r.steps if t and r.steps else None
