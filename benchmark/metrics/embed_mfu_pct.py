"""embed_mfu_pct (%, host_clock): the whole image-embed step's share of the
card's peak at the configuration's matmul precision: ``roofline.vit_image_ops``
(patch embedding, block linears, attention, projection; about 162 GFLOP an
image at ViT-L/14) times the images of the traced slice, over its wall
seconds, over 1,979 TOP/s for int8 or 989 TFLOP/s for bf16 (published H100
SXM peaks at 700 W; the run reports the card's limit beside it)."""

from benchmark import roofline


def read(r):
    images = r.work.get("images")
    if not images or r.window_s <= 0:
        return None
    peak = roofline.PEAK_OPS_PER_S[r.config["port"]["precision"]]
    return 100.0 * roofline.vit_image_ops(r.config) * images / r.window_s / peak
