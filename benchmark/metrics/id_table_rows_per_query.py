"""id_table_rows_per_query (rows/query, program_counter): the entries the
program's ``vector_index.id_table_rows`` counter adds up (the host index's
item table, turned into an array on each call of
``VectorIndex.item_id_of_groups``), over the queries of the traced slice.
None where the program keeps no such counter."""


def read(r):
    try:
        from panoptikon_tpu_torch import tracing
    except ImportError:
        return None
    rows = tracing.counters().get("vector_index.id_table_rows")
    queries = r.work.get("queries")
    return rows / queries if rows is not None and queries else None
