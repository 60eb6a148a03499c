"""slice_qps (queries/s, host_clock): search_qps over the traced slice, for
the cells whose host id map spreads search_qps too widely for a bound: every
query whose ids reached the host, over the slice's wall seconds (the run
synchronizes after each search and runs under the profiler)."""


def read(r):
    return r.work["queries"] / r.window_s if r.window_s > 0 and r.work.get("queries") else None
