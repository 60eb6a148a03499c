"""The yardstick's arithmetic: published peaks, rooflines and operation counts.

The peaks, :func:`roofline`, :func:`scan_roofline` and
:func:`attention_roofline` are copied from ``chip_smoke.py`` (lines 559-560
and 620-660; there they take tensors, here the shapes they read), so that a
change to the program cannot move them. Every count is made from the shapes
of the configuration and the traffic, never from the program's code: a
program that replaces a kernel is held to the same work.

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense rates at the full
700 W power limit: 1,979 TOP/s int8, 989 TFLOP/s bf16, 67 TFLOP/s f32 off the
tensor cores, 3.35 TB/s of HBM. A share of a peak is stated against these,
whatever the card's power limit; the run reports the limit beside it.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}


def roofline(ops: float, kind: str, moved: float) -> dict:
    """The bound of one call: operations over the peak of their type, or
    bytes over the memory rate, whichever is larger (``chip_smoke.py:620``)."""
    t_ops, t_bytes = ops / PEAK_OPS_PER_S[kind], moved / HBM_BYTES_PER_S
    return {"bound_s": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def scan_roofline(q: int, n: int, d: int, k: int) -> dict:
    """An int8 scan of Q queries over N rows of D codes keeping k: 2·Q·N·D
    int8 operations; reads the codes, the int32 row sums of squares, the row
    validity and the query codes once, writes (Q, k) f32 distances, int64
    rows and bools once (``chip_smoke.py:628``)."""
    moved = n * d + 4 * n + n + q * d + q * k * (4 + 8 + 1)
    return roofline(2 * q * n * d, "int8", moved)


def attention_roofline(b: int, nq: int, nkv: int, h: int, d: int, *, causal: bool = False,
                       in_bytes: int = 2, out_bytes: int = 2) -> dict:
    """QKᵀ and PV: 4·B·H·N_q·N_kv·D operations (half the keys when causal),
    in bf16; q, k and v read once, the output written once
    (``chip_smoke.py:655``)."""
    ops = 4 * b * h * nq * nkv * d * ((nq + 1) / (2 * nq) if causal else 1)
    moved = in_bytes * b * h * d * (nq + 2 * nkv) + out_bytes * b * nq * h * d
    return roofline(ops, "bf16", moved)


def rescore_ops(q: int, kk: int, d: int) -> float:
    """The exact f32 rescore of kk candidates a query: a dot and a norm each,
    2·D operations apiece."""
    return 4.0 * q * kk * d


def vit_image_ops(config: dict) -> float:
    """Operations of one image through a ViT image tower at the
    configuration's shapes: the patch embedding, four block linears
    (qkv 3W², out W², fc and proj mlp_ratio·W² each) and attention
    (4·N²·W) in every block, and the projection; 2 operations a
    multiply-add. LayerNorms, GELU and softmax are left out (under 1 %)."""
    v = config["vision_cfg"]
    w, layers, p, size = v["width"], v["layers"], v["patch_size"], v["image_size"]
    mlp = config["assumed"]["mlp_ratio"]
    patches = (size // p) ** 2
    n = patches + 1
    linears = 2 * n * w * w * (3 + 1 + 2 * mlp)
    attention = 4 * n * n * w
    patch_embed = 2.0 * patches * p * p * 3 * w
    return patch_embed + layers * (linears + attention) + 2.0 * w * config["embed_dim"]


def union_seconds(spans) -> float:
    """Seconds covered by at least one of the (start, end) spans, in the
    spans' unit: overlapping spans count once (``chip_smoke.py:1158``'s
    ``busy_share``)."""
    busy, end = 0.0, float("-inf")
    for lo, hi in sorted(spans):
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return busy


def unit_rows(n: int, dim: int, gen, dev):
    """n seeded unit rows, made 131,072 at a time on ``gen``'s device
    (``chip_smoke.py:646``)."""
    import torch

    parts = []
    for lo in range(0, n, 131_072):
        x = torch.randn((min(131_072, n - lo), dim), generator=gen, device=dev)
        parts.append(x / torch.linalg.norm(x, dim=1, keepdim=True))
    return torch.cat(parts)
