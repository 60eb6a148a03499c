"""steps_per_s (steps/s, host_clock): a metric defined only in test data:
the traced slice's steps over its seconds."""


def read(r):
    return r.steps / r.window_s if r.window_s > 0 else None
