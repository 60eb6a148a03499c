"""prefill_mfu_pct (%, program_span): the tower's, the projector's and the
prefill's operations at the traffic's shapes (``moe_counts.vision_ops`` an
image, ``moe_counts.prefill_ops`` a batch: 6 routed and the shared experts a
token) times the batches of the traced slice, over the program's
``kimi_vl.vision`` and ``kimi_vl.prefill`` spans, over 989 TFLOP/s (the
published H100 SXM bf16 peak at 700 W; the run reports the card's limit
beside it). None where the program records neither span."""

from benchmark import moe_counts
from benchmark.roofline import PEAK_OPS_PER_S


def read(r):
    try:
        from panoptikon_tpu_torch import tracing
    except ImportError:
        return None
    totals = tracing.totals()
    spans = [totals[name] for name in ("kimi_vl.vision", "kimi_vl.prefill") if name in totals]
    if not spans or not r.steps:
        return None
    images = r.traffic["images_per_batch"]
    ops = moe_counts.vision_ops(r.config) * images + moe_counts.prefill_ops(r.config, r.traffic)
    return 100.0 * ops * r.steps / sum(spans) / PEAK_OPS_PER_S["bf16"]
