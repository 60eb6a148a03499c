"""search_qps (queries/s, host_clock): every query whose ids reached the host
in the window, over the window's seconds (closed loop, one dispatcher)."""


def read(r):
    return r.work["queries"] / r.window_s if r.window_s > 0 and r.work.get("queries") else None
