"""decode_step_ms (ms, program_span): host seconds in the program's
``kimi_vl.decode`` span (the decode steps through the latent cache, ending
with the tokens on the host) over its ``kimi_vl.decode_steps`` counter, over
the traced slice. None where the program records neither."""


def read(r):
    try:
        from panoptikon_tpu_torch import tracing
    except ImportError:
        return None
    seconds = tracing.totals().get("kimi_vl.decode")
    steps = tracing.counters().get("kimi_vl.decode_steps")
    return 1e3 * seconds / steps if seconds is not None and steps else None
