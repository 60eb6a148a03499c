"""id_table_ms (ms, program_span): host seconds a batch in the program's
``vector_index.id_table`` span (the host index's item table turned from a
list into an array in ``VectorIndex.item_id_of_groups``), over the traced
slice. None where the program records no such span."""


def read(r):
    try:
        from panoptikon_tpu_torch import tracing
    except ImportError:
        return None
    seconds = tracing.totals().get("vector_index.id_table")
    return 1e3 * seconds / r.steps if seconds is not None and r.steps else None
