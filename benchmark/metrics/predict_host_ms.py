"""predict_host_ms (ms, program_span): host seconds a batch in
``ClipImpl.predict``'s two host stages, the program's
``impls.clip_predict.stack`` (inputs read and stacked, slices padded) and
``impls.clip_predict.serialize`` (embeddings written as npy bytes) spans,
over the traced slice. None where the program records neither."""

STAGES = ("impls.clip_predict.stack", "impls.clip_predict.serialize")


def read(r):
    try:
        from panoptikon_tpu_torch import tracing
    except ImportError:
        return None
    totals = tracing.totals()
    spans = [totals[name] for name in STAGES if name in totals]
    return 1e3 * sum(spans) / r.steps if spans and r.steps else None
