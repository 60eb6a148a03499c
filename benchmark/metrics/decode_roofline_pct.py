"""decode_roofline_pct (%, program_span): the decode steps' bound over the
program's ``kimi_vl.decode`` span in the traced slice. A step's bound
(``moe_counts.decode_step_bound``) is every weight of the language model but
the embedding table read once plus the latent caches read at the step's
length, at 3.35 TB/s, or its operations at 989 TFLOP/s, whichever is
longer (published H100 SXM peaks at 700 W; the run reports the card's
limit beside it); summed over each batch's ``kimi_vl.decode_steps``. None
where the program records neither."""

from benchmark import moe_counts


def read(r):
    try:
        from panoptikon_tpu_torch import tracing
    except ImportError:
        return None
    seconds = tracing.totals().get("kimi_vl.decode")
    steps = tracing.counters().get("kimi_vl.decode_steps")
    if not seconds or not steps or not r.steps:
        return None
    per_batch = steps // r.steps
    bound = moe_counts.decode_bound(r.config, r.traffic, per_batch) * r.steps
    return 100.0 * bound / seconds
