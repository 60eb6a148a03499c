"""attention_roofline_pct (%, device_trace): the attention kernels' bound
(B3 ``mha`` and B4 ``mha_qkv``, forward) over their device time in the
traced slice. The bound is ``roofline.attention_roofline`` at the cell's
shapes, once a block a batch: 4·B·H·N²·D operations at 989 TFLOP/s bf16,
or q, k, v (bf16) read once and the output (int8 under the int8 precision,
else bf16) written once at 3.35 TB/s, whichever is longer (published H100
SXM peaks at 700 W; the run reports the card's limit beside it)."""

from benchmark import roofline

KERNEL = r"\bmha_(tc_)?kernel\b"


def read(r):
    s = r.slice
    if s is None or not s.steps:
        return None
    t = s.kernel_seconds(KERNEL)
    if not t:
        return None
    v = r.config["vision_cfg"]
    n = (v["image_size"] // v["patch_size"]) ** 2 + 1
    d = r.config["assumed"]["vision_head_width"]
    bound = roofline.attention_roofline(
        r.traffic["images_per_batch"], n, n, v["width"] // d, d,
        out_bytes=1 if r.config["port"]["precision"] == "int8" else 2)["bound_s"]
    return 100.0 * bound * v["layers"] * s.steps / t
