"""Where the device time goes on the port's main path, on one NVIDIA GPU.

    python3 -m panoptikon_tpu_torch.profiling [--out DIR] [--reps N]
                                              [--attention | --scan [--b1-before DIR] | --ln]

Four operations, each called ``reps`` times back to back under
``torch.profiler`` (CPU and CUDA activity), after three warm-up calls:

- ``search``: ``DeviceIndex.search`` at 1,048,576 × 512 (seeded unit rows
  in a host ``VectorIndex``, int8 arm built and uploaded), 256 Gaussian unit
  queries, k=10, oversample 8 (candidates from kernel B1);
- ``search_batch``: the same index searched by 4,096 Gaussian unit queries
  (candidates from kernel B2);
- ``embed``: ``clip.embed_images`` of CLIP ViT-B/32, bf16, seeded random
  weights, one batch of 256 images;
- ``embed_int8``: the serving embed, ``clip.embed_images_scaled`` of CLIP
  ViT-L/14 with block weights quantized once and activation scales
  calibrated on the batch itself (static int8, kernels ``mha_qkv`` and
  ``ln_quant``), seeded random weights, one batch of 256 images.

For each it prints one JSON line: device time per call (the sum of the
CUDA kernels' self time, as the profiler's "Self CUDA time total"), wall
time per call measured apart from the profiler with a synchronize after
every call (one request at a time, as a server sees it), the device's idle
share of that wall time, and the kernels that take the most device time.
The full ``key_averages()`` tables go to ``DIR/profile_<name>.txt``. The
card's name and power limit (nvidia-smi) lead the output.

``--attention`` is the attention probe instead: the tensor-core attention
kernel's variants (64 and 128 query rows a block; logits kept in shared
memory, or recomputed by a second pass) timed in turns with CUDA events
beside ``F.scaled_dot_product_attention`` at the towers' four shapes
(ViT-L/14 ``mha_qkv`` with int8 and with bf16 out, ViT-B/32
and CLIP text causal ``mha``), one JSON line each; then an ablation of its
exact softmax (``ABLATIONS``: timing-only edits of ``csrc/attention.cu``
built beside the kernels, never used by the port) at the serving shapes,
with each edit's division held against ``__fdiv_rn`` over every float in
[0, 1]; then the ``embed`` and ``embed_int8`` profiles. Every profile line
carries attention's share of the device time.

``--scan`` is the int8 GEMM probe (the port of
``tools/pallas_int8_gemm_probe.py``): first kernel B1 as built, its dot
stage alone (``SCAN_ABLATIONS["b1_dots_only"]``: an edit of
``csrc/int8_scan.cu`` whose test against tau admits no key and keeps every
dot live, built beside the kernels), its selection without the mma and its
ring alone, timed in turns at ``B1_SCAN_SHAPES`` beside B1's wrapper (the
kernel and its merge) and the ``torch._int_mm`` GEMM alone; with
``--b1-before DIR``, also B1 before its redesign (``__dp4a`` dots, 1,024-row
tiles, k rounds of extract-min: ``csrc/int8_scan.cu`` of a checkout of
commit 63654cc at DIR, built apart) in the same turns, its merge after it,
and its top-k checked equal to the new one's; then, at the
probe's shape, Q 4,096 × D 512 × C 32,768 int8 codes, the T(op)/s of
``torch._int_mm`` with B column-major (the library yardstick, which the
port never calls), of kernel B2's dot stage alone (``"dots_only"``: its
fold keeps every dot live by an xor) and of B2 as built; the two B2 builds
again at the batched search's 1,048,576 rows.

``--ln`` is the fused-LayerNorm probe (the port of
``tools/ln_fused_probe.py``): the ``embed_int8`` profile of three programs,
with device ms and img/s each: as built (kernel B5); B5 replaced by the
unfused ``ln_quant_plain``, the probe's baseline; and the probe's GEMM-chain
floor, LayerNorm scale-only (``x·γ + β``, then the static quantize) and the
attention core passed through (``v`` quantized in place of ``mha_qkv``).
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from panoptikon_tpu_torch.device import device
from panoptikon_tpu_torch.index import VectorIndex
from panoptikon_tpu_torch.index.device_index import DeviceIndex
from panoptikon_tpu_torch.models import clip

SEED = 0
N_ROWS, DIM, N_QUERIES, N_BATCH, K, OVERSAMPLE = 1_048_576, 512, 256, 4096, 10, 8
IMAGE_BATCH = 256
ATTN_SHAPES = {
    # name: (b, n, h, d, causal, out); out "int8" or "bf16" is mha_qkv, None mha
    "vit_l14_image_int8": (256, 257, 16, 64, False, "int8"),
    "vit_l14_image_bf16": (256, 257, 16, 64, False, "bf16"),
    "vit_b32_image": (256, 50, 12, 64, False, None),
    "clip_text_causal": (64, 77, 8, 64, True, None),
}
# (query rows a block, TC_LOGITS_MAX_KEYS): shared-memory logits, two passes.
VARIANTS = ((64, 320), (128, 320), (64, 0), (128, 0))
# Edits of csrc/attention.cu that price a part of the exact softmax: the
# division as __fdiv_rn, the division without its guard for numerators
# under 2^-80 (wrong there), and __expf for expf (less accurate). Each is
# built for D = 64 only.
_DIV_BODY = "  const float q = __fmul_rn(a, y);\n  return __fmaf_rn(__fmaf_rn(-b, q, a), y, q);"
ABLATIONS = {
    "as_built": [],
    "fdiv_rn": [(_DIV_BODY, "  return __fdiv_rn(a, b);")],
    "unguarded_div": [
        ("return a > 0.0f && a < kDivRnMin ? __fdiv_rn(a, b) : div_rn(a, b, y);",
         "return div_rn(a, b, y);"),
        ("if (!__any_sync(0xffffffffu, tiny)) {", "if (true) {")],
    "fast_exp": [("expf(", "__expf(")],
}
_OTHER_DIMS = [f"    PK_TC_CASE({d})\n" for d in (32, 48, 80, 96, 112, 128)]
SCAN_PROBE = (4096, 512, 32_768)  # Q, D, C of tools/pallas_int8_gemm_probe.py
# B2's fold as built, and in its place a sum that keeps every dot live.
_FOLD_BODY = """  const float d = scan_distance(dot, xx, qq, kL2, scale);
  const bool better = ok && d < best;  // a row that is not valid scores +inf: never better
  best = better ? d : best;
  buckets = better ? (buckets & ~(0xffu << shift)) | (b << shift) : buckets;"""
# B1's key of a (query, row) as built, and in its place a key no tau admits
# (no dot is INT_MAX: |dot| <= D * 127^2), which keeps every dot live and
# offers no key.
_OFFER_BODY = """  const float dist = ok ? scan_distance(dot, xx, qq, kL2, scale) : CUDART_INF_F;
  return pack(dist, row);"""
# B1's mma as built, and in its place none (the dots stay zero): with
# b1_dots_only, the ring and the barriers alone.
_B1_MMA = ("        for (int kk = 0; kk < kChunk / 32; ++kk) mma_kstep(acc, qa, ldq, st, kk, tiles, "
           "[](int) {});")
_B1_NO_MMA = "        if (qa == nullptr) mma_kstep(acc, qa, ldq, st, 0, tiles, [](int) {});"
_B1_NO_KEY = (_OFFER_BODY, "  return dot == INT_MAX ? 0 : LLONG_MAX;")
SCAN_ABLATIONS = {
    "as_built": [],
    "dots_only": [(_FOLD_BODY, "  best = __int_as_float(__float_as_int(best) ^ dot);")],
    "b1_dots_only": [_B1_NO_KEY],
    "b1_no_mma": [(_B1_MMA, _B1_NO_MMA)],
    "b1_loads_only": [_B1_NO_KEY, (_B1_MMA, _B1_NO_MMA)],
}
# B1's shapes in --scan: (Q, N, D, k, distance) of the search at Q = 256,
# 64 and 1, of chip_smoke.py's check at 65,536 rows, of the ViT-L/14 int8
# path's text (cosine) and L2 searches, and of the composed two-space
# bench's two spaces at k = 1,024 (ROADMAP A.5).
B1_SCAN_SHAPES = {
    "search_q256_k80": (256, N_ROWS, 512, 80, "cosine"),
    "search_q64_k80": (64, N_ROWS, 512, 80, "cosine"),
    "search_q1_k80": (1, N_ROWS, 512, 80, "cosine"),
    "check_q64_k80": (64, 65_536, 512, 80, "cosine"),
    "check_q64_k80_l2": (64, 65_536, 512, 80, "l2"),
    "int8_path_q64_k80": (64, 262_144, 768, 80, "cosine"),
    "int8_path_q128_k80_l2": (128, 262_144, 768, 80, "l2"),
    "composed_k1024": (256, 500_000, 512, 1024, "cosine"),
    "composed_k1024_d768": (256, 250_000, 768, 1024, "cosine"),
}
# The entry points of B1 before its redesign.
B1_BEFORE_SIGNATURES = {
    "pk_int8_topk": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p],
    "pk_int8_topk_tile_rows": [],
}


def _unit_rows(n: int, dim: int, gen: torch.Generator, dev) -> torch.Tensor:
    rows = torch.randn((n, dim), generator=gen, device=dev)
    return rows / torch.linalg.norm(rows, dim=1, keepdim=True)


def _search_ops(dev):
    gen = torch.Generator(device=dev).manual_seed(SEED)
    index = VectorIndex()
    index.reserve("clip", N_ROWS, DIM)
    step = 131_072
    for lo in range(0, N_ROWS, step):
        rows = _unit_rows(step, DIM, gen, dev).cpu().numpy()
        index.add("clip", np.arange(lo, lo + step), np.arange(lo, lo + step), rows)
    index.build_quant("clip")
    dindex = DeviceIndex(index, "clip", dev)
    queries = _unit_rows(N_QUERIES, DIM, gen, dev)
    batch = _unit_rows(N_BATCH, DIM, gen, dev)
    return {"search": lambda: dindex.search(queries, K, oversample=OVERSAMPLE),
            "search_batch": lambda: dindex.search(batch, K, oversample=OVERSAMPLE)}


def _embed_op(dev):
    cfg = clip.CONFIGS["ViT-B-32"]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = clip.init_params(cfg, gen, dtype=torch.bfloat16)
    images = torch.randn((IMAGE_BATCH, cfg.image_size, cfg.image_size, 3), generator=gen,
                         device=dev, dtype=torch.bfloat16)
    return lambda: clip.embed_images(params, cfg, images)


def _embed_int8_op(dev):
    cfg = dataclasses.replace(clip.CONFIGS["ViT-L-14"], matmul_precision="int8")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = clip.quantize_block_weights(clip.init_params(cfg, gen))
    images = torch.randn((IMAGE_BATCH, cfg.image_size, cfg.image_size, 3), generator=gen,
                         device=dev, dtype=torch.bfloat16)
    scales = clip.calibrate_image_scales(params, cfg, images)
    return lambda: clip.embed_images_scaled(params, cfg, images, scales)


def _wall_ms(fn, reps: int) -> float:
    total = 0.0
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        total += time.perf_counter() - t0
    return total / reps * 1e3


def _cuda_ms(fn, reps: int = 20) -> float:
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _attention_variants(dev, smi: str) -> None:
    """Time the tensor-core kernel's ``VARIANTS`` in turns (in order, then
    reversed) beside SDPA, at each of ``ATTN_SHAPES``."""
    import torch.nn.functional as F

    from panoptikon_tpu_torch.ops import vit_attention

    gen = torch.Generator(device=dev).manual_seed(SEED)
    for name, (b, n, h, d, causal, out) in ATTN_SHAPES.items():
        qkv = torch.randn((b, n, 3 * h * d), generator=gen, device=dev).to(torch.bfloat16)
        q, k, v = (t.contiguous() for t in qkv.view(b, n, 3, h, d).unbind(2))
        if out is None:
            call = lambda: vit_attention.mha(q, k, v, causal=causal)
        else:
            scale = torch.tensor(3.0, device=dev) if out == "int8" else None
            call = lambda: vit_attention.mha_qkv(qkv, heads=h, causal=causal, out_scale=scale)
        saved = vit_attention.TC_QUERY_ROWS, vit_attention.TC_LOGITS_MAX_KEYS
        times, outs = {var: [] for var in VARIANTS}, {}
        try:
            for var in (*VARIANTS, *reversed(VARIANTS)):
                vit_attention.TC_QUERY_ROWS, vit_attention.TC_LOGITS_MAX_KEYS = var
                times[var].append(_cuda_ms(call))
                outs[var] = call()
        finally:
            vit_attention.TC_QUERY_ROWS, vit_attention.TC_LOGITS_MAX_KEYS = saved
        sdpa_ms = _cuda_ms(lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=causal))
        names = {var: f"rows_{var[0]}_{'smem_logits' if var[1] else 'two_pass'}"
                 for var in VARIANTS}
        ms = {names[var]: sum(t) / len(t) for var, t in times.items()}
        by_form = {form: [o for var, o in outs.items() if var[1] == form] for _, form in VARIANTS}
        print(json.dumps({
            "card": smi, "probe": "attention", "shape": name, "b": b, "n": n, "h": h, "d": d,
            "causal": causal, "out": out or "bf16 (mha)", "ms": ms,
            "fastest": min(ms, key=ms.get), "sdpa_ms": sdpa_ms,
            # Rows a block do not change a row's arithmetic; the two forms
            # differ only in the order of the row sum.
            "rows_variants_identical": all(torch.equal(o[0], o[1]) for o in by_form.values()),
            "forms_max_diff": max(
                (a.float() - b.float()).abs().max().item() for a in outs.values()
                for b in outs.values()),
        }), flush=True)


def _ablation_lib(source: str, name: str, edits, signatures, csrc: Path | None = None) -> ctypes.CDLL:
    """``<source>.cu`` and the headers of ``csrc`` (default: the package's
    ``csrc/``) with each ``(old, new)`` edit applied wherever ``old``
    occurs, built apart from the kernels into
    ``build/torch_kernels/ablation/<source>_<name>/``."""
    from panoptikon_tpu_torch import _build

    csrc = csrc or _build.CSRC
    files = {path.name: path.read_text()
             for path in (csrc / f"{source}.cu", *sorted(csrc.glob("*.cuh")))}
    for old, new in edits:
        hits = [f for f, text in files.items() if old in text]
        if not hits:
            raise RuntimeError(f"ablation {name}: no source of {source}.cu has {old!r}")
        for f in hits:
            files[f] = files[f].replace(old, new)
    build = _build.BUILD_DIR / "ablation" / f"{source}_{name}"
    build.mkdir(parents=True, exist_ok=True)
    for f, text in files.items():
        (build / f).write_text(text)
    so = build / f"{source}.so"
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so),
                           str(build / f"{source}.cu")], capture_output=True, text=True, timeout=600)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for ablation {name}:\n{proc.stderr[-4000:]}")
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def _attention_ablation(dev, smi: str) -> None:
    """Each of ``ABLATIONS`` timed in turns at ViT-L/14's serving shape
    (``mha_qkv``, int8 out) and ViT-B/32's (``mha``), in both softmax forms,
    and its division checked over every float in [0, 1]."""
    from concurrent.futures import ThreadPoolExecutor

    from panoptikon_tpu_torch.ops import vit_attention

    def build(item):
        name, edits = item
        return _ablation_lib("attention", name, [*edits, *((case, "") for case in _OTHER_DIMS)],
                             vit_attention._SIGNATURES)

    with ThreadPoolExecutor(len(ABLATIONS)) as pool:
        libs = dict(zip(ABLATIONS, pool.map(build, ABLATIONS.items())))
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    stream = torch.cuda.current_stream(dev).cuda_stream
    divisors = torch.exp(torch.rand(64, generator=gen, device=dev) * np.log(4096.0))
    divisors = torch.cat([divisors, 2.0 ** torch.arange(13, device=dev)])
    for shape, (b, n, h, d, out) in {"vit_l14_image_int8": (256, 257, 16, 64, True),
                                     "vit_b32_image": (256, 50, 12, 64, False)}.items():
        qkv = torch.randn((b, n, 3 * h * d), generator=gen, device=dev).to(torch.bfloat16)
        o = torch.empty((b, n, h * d), device=dev, dtype=torch.int8 if out else torch.bfloat16)
        scale = torch.tensor([3.0], device=dev) if out else None
        base, part = qkv.data_ptr(), h * d * qkv.element_size()
        times = {}
        for logits in (1, 0):
            for name in (*ABLATIONS, *reversed(ABLATIONS)):
                lib = libs[name]
                times.setdefault(f"{name}_{'smem_logits' if logits else 'two_pass'}", []).append(
                    _cuda_ms(lambda: lib.pk_mha_tc(
                        base, base + part, base + 2 * part, None, o.data_ptr(),
                        None if scale is None else scale.data_ptr(), 3 * h * d, b, n, n, h, d,
                        0, float(d) ** -0.5, 64, logits, stream)))
        print(json.dumps({"card": smi, "probe": "attention_ablation", "shape": shape,
                          "ms": {k: sum(v) / len(v) for k, v in times.items()}}), flush=True)
    for name, lib in libs.items():
        counts = torch.zeros(divisors.numel(), dtype=torch.int64, device=dev)
        lib.pk_check_div_rn(divisors.data_ptr(), divisors.numel(), counts.data_ptr(), stream)
        torch.cuda.synchronize()
        print(json.dumps({"card": smi, "probe": "attention_ablation_division", "variant": name,
                          "divisors": divisors.numel(),
                          "floats_in_0_1_off_fdiv_rn": int(counts.sum().item()),
                          "divisors_with_any": int((counts > 0).sum().item())}), flush=True)


def _scan_probe(dev, smi: str, b1_before: Path | None) -> None:
    """B1 (``_b1_scan``), then B2 as built and its dot stage alone
    (``SCAN_ABLATIONS``), timed in turns, and ``torch._int_mm`` at
    ``SCAN_PROBE``; one JSON line a shape."""
    from concurrent.futures import ThreadPoolExecutor

    from panoptikon_tpu_torch import _build
    from panoptikon_tpu_torch.ops import int8_scan, scoring

    builds = {name: ("int8_scan", name, edits, int8_scan._SIGNATURES)
              for name, edits in SCAN_ABLATIONS.items()}
    if b1_before is not None:
        builds["b1_before"] = ("int8_scan", "before", [], B1_BEFORE_SIGNATURES,
                               b1_before / "panoptikon_tpu_torch" / "csrc")
    with ThreadPoolExecutor(len(builds)) as pool:
        all_libs = dict(zip(builds, pool.map(lambda args: _ablation_lib(*args), builds.values())))
    libs = {name: all_libs[name] for name in ("as_built", "dots_only")}
    _b1_scan(dev, smi, {name: lib for name, lib in all_libs.items()
                        if name == "as_built" or name.startswith("b1_")})
    gen = torch.Generator(device=dev).manual_seed(SEED)
    q_n, d, c = SCAN_PROBE
    tile_n, k_tile, k = 2048, 8, K * OVERSAMPLE
    q = torch.randint(-127, 128, (q_n, d), generator=gen, device=dev, dtype=torch.int8)
    qq = scoring.row_sumsq(q)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for shape, n in {"gemm_probe": c, "batched_search_1m": N_ROWS}.items():
        codes = torch.randint(-127, 128, (n, d), generator=gen, device=dev, dtype=torch.int8)
        sumsq = scoring.row_sumsq(codes)
        valid = torch.ones(n, dtype=torch.bool, device=dev)
        tiles = -(-n // tile_n)
        keys = torch.empty((q_n, tiles * k_tile), dtype=torch.int64, device=dev)
        rows = torch.empty((q_n, tiles * k_tile), dtype=torch.int32, device=dev)

        def launch(lib):
            return lambda: _build.check(lib.pk_int8_topk_v2(
                codes.data_ptr(), sumsq.data_ptr(), valid.data_ptr(), q.data_ptr(), qq.data_ptr(),
                keys.data_ptr(), rows.data_ptr(), n, d, q_n, tile_n, k_tile, 0, 1.0, stream),
                "int8_topk_v2 ablation")

        times = {}
        for name in (*libs, *reversed(libs)):
            times.setdefault(name, []).append(_cuda_ms(launch(libs[name]), reps=10))
        ms = {f"b2_{name}": sum(t) / len(t) for name, t in times.items()}
        ms["b2_wrapper_with_merge"] = _cuda_ms(
            lambda: int8_scan.int8_topk_v2(codes, sumsq, valid, q, k=k, k_tile=k_tile,
                                           tile_n=tile_n), reps=10)
        if n == c:
            # B column-major: the (C, D) codes transposed, as clip._int_mm stores weights.
            ms["torch_int_mm_b_column_major"] = _cuda_ms(lambda: torch._int_mm(q, codes.t()),
                                                         reps=10)
        ops = 2 * q_n * n * d
        print(json.dumps({"card": smi, "probe": "scan", "shape": shape, "q": q_n, "d": d,
                          "rows": n, "int8_ops": ops, "ms": ms,
                          "tops": {name: ops / (t * 1e-3) / 1e12 for name, t in ms.items()},
                          "epilogue_and_fold_ms": ms["b2_as_built"] - ms["b2_dots_only"]}),
              flush=True)
        del codes, sumsq, valid, keys, rows


def _b1_scan(dev, smi: str, libs) -> None:
    """B1 as built, its dot stage alone, its selection on zero dots (no mma),
    its ring alone (neither) and, where ``libs`` has it, B1 before its
    redesign, timed in turns at ``B1_SCAN_SHAPES`` (seeded random codes,
    every row valid) beside B1's wrapper and the GEMM alone."""
    from panoptikon_tpu_torch import _build
    from panoptikon_tpu_torch.ops import exact, int8_scan, scoring

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    stream = torch.cuda.current_stream(dev).cuda_stream
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    before = libs.get("b1_before")
    for shape, (q_n, n, d, k, distance) in B1_SCAN_SHAPES.items():
        l2 = int(distance == "l2")
        codes = torch.randint(-127, 128, (n, d), generator=gen, device=dev, dtype=torch.int8)
        q = torch.randint(-127, 128, (q_n, d), generator=gen, device=dev, dtype=torch.int8)
        sumsq, qq = scoring.row_sumsq_chunked(codes), scoring.row_sumsq(q)
        valid = torch.ones(n, dtype=torch.bool, device=dev)
        q_block, strip_rows, length = int8_scan.b1_layout(q_n, n, d, k, sms)
        keys = torch.empty((q_n, -(-n // strip_rows) * length), dtype=torch.int64, device=dev)

        def launch(lib):
            return lambda: _build.check(lib.pk_int8_topk(
                codes.data_ptr(), sumsq.data_ptr(), valid.data_ptr(), q.data_ptr(), qq.data_ptr(),
                keys.data_ptr(), n, d, q_n, k, q_block, strip_rows, l2, 1.0, stream),
                "int8_topk ablation")

        calls = {name: launch(lib) for name, lib in libs.items() if name != "b1_before"}
        if before is not None:
            tiles = -(-n // before.pk_int8_topk_tile_rows())
            old_keys = torch.empty((q_n, tiles * k), dtype=torch.int64, device=dev)

            def old_kernel():
                _build.check(before.pk_int8_topk(
                    codes.data_ptr(), sumsq.data_ptr(), valid.data_ptr(), q.data_ptr(),
                    qq.data_ptr(), old_keys.data_ptr(), n, d, q_n, k, l2, 1.0, stream),
                    "int8_topk before")

            def old_wrapper():
                old_kernel()
                return torch.topk(old_keys, k, dim=-1, largest=False, sorted=True).values

            calls["b1_before"], calls["b1_before_with_merge"] = old_kernel, old_wrapper

        def new_wrapper():
            return int8_scan.int8_topk(codes, sumsq, valid, q, k=k, distance=distance)

        calls["b1_wrapper_with_merge"] = new_wrapper
        times = {}
        for name in (*calls, *reversed(calls)):
            times.setdefault(name, []).append(_cuda_ms(calls[name], reps=10))
        ms = {name if name.startswith("b1_") else f"b1_{name}": sum(t) / len(t)
              for name, t in times.items()}
        ms["gemm_only"] = _cuda_ms(lambda: exact.int_mm(q, codes.t()), reps=10)
        record = {"card": smi, "probe": "scan_b1", "shape": shape, "q": q_n, "d": d, "rows": n,
                  "k": k, "distance": distance, "q_block": q_block, "strip_rows": strip_rows,
                  "int8_ops": 2 * q_n * n * d, "ms": ms, "turns_ms": times,
                  "tops": {name: 2 * q_n * n * d / (t * 1e-3) / 1e12 for name, t in ms.items()},
                  "selection_ms": ms["b1_as_built"] - ms["b1_dots_only"]}
        if before is not None:
            new_dist, new_rows, _ = new_wrapper()
            old_dist, old_rows = exact.unpack_keys(old_wrapper())
            record["equal_to_before"] = bool(torch.equal(new_rows, old_rows)
                                             and torch.equal(new_dist, old_dist))
            del old_keys
        print(json.dumps(record), flush=True)
        del codes, q, sumsq, valid, keys
        torch.cuda.empty_cache()


def _ln_probe(dev, smi: str, reps: int, out: Path) -> None:
    """The ``embed_int8`` profile of the three programs of
    ``tools/ln_fused_probe.py``: as built, B5 replaced by ``ln_quant_plain``,
    and the GEMM-chain floor; the first again last, for the spread."""
    from panoptikon_tpu_torch.ops import codec, ln_quant, vit_attention

    def ln_scale_only(x, p, act_scale):
        y = x.to(torch.float32) * p["scale"].to(torch.float32) + p["bias"].to(torch.float32)
        return codec.quantize_static(y, act_scale)

    def attention_passthrough(qkv, heads, causal=False, out_scale=None):
        return codec.quantize_static(qkv[..., 2 * qkv.shape[-1] // 3:], out_scale)

    programs = {
        "as_built": {},
        "plain_ln_quant": {(ln_quant, "ln_quant_2d"): ln_quant.ln_quant_plain},
        "gemm_chain_floor": {(ln_quant, "ln_quant"): ln_scale_only,
                             (vit_attention, "mha_qkv"): attention_passthrough},
    }
    fn = _embed_int8_op(dev)
    for name in (*programs, "as_built"):
        with contextlib.ExitStack() as patches:
            for (module, attr), value in programs[name].items():
                patches.enter_context(mock.patch.object(module, attr, value))
            record = _profile(f"embed_int8_{name}", fn, reps, out)
        print(json.dumps({"card": smi, "probe": "ln", "program": name,
                          "img_per_s": IMAGE_BATCH / (record["wall_ms_per_call"] / 1e3),
                          **record}), flush=True)


def _profile(name: str, fn, reps: int, out: Path) -> dict:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    wall_ms = _wall_ms(fn, reps)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    (out / f"profile_{name}.txt").write_text(
        events.table(sort_by="self_device_time_total", row_limit=40, max_name_column_width=90))
    kernels = [e for e in events
               if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
    device_us = sum(e.self_device_time_total for e in kernels)
    device_ms = device_us / reps / 1e3
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:8]
    attention_us = sum(e.self_device_time_total for e in kernels if "mha_" in e.key)
    ln_quant_us = sum(e.self_device_time_total for e in kernels if "ln_quant_kernel" in e.key)
    return {
        "op": name, "reps": reps, "device_ms_per_call": device_ms, "wall_ms_per_call": wall_ms,
        "device_idle_share": max(0.0, 1.0 - device_ms / wall_ms),
        "attention_ms_per_call": attention_us / reps / 1e3,
        "attention_share": attention_us / device_us,
        "ln_quant_ms_per_call": ln_quant_us / reps / 1e3,
        "top_kernels": [
            {"name": e.key[:90], "ms_per_call": e.self_device_time_total / reps / 1e3,
             "share": e.self_device_time_total / device_us, "launches_per_call": e.count / reps}
            for e in top
        ],
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=Path, default=Path("chiprun_out"))
    parser.add_argument("--reps", type=int, default=5)
    probes = parser.add_mutually_exclusive_group()
    probes.add_argument("--attention", action="store_true",
                        help="the attention probe and the two embed profiles")
    probes.add_argument("--scan", action="store_true",
                        help="the int8 GEMM probe: B1's and B2's dot stages, B1, B2 and torch._int_mm")
    parser.add_argument("--b1-before", type=Path, default=None, metavar="DIR",
                        help="with --scan, also time B1 of the checkout at DIR "
                             "(commit 63654cc, before B1's redesign)")
    probes.add_argument("--ln", action="store_true",
                        help="the fused-LayerNorm probe: three programs of the int8 embed")
    args = parser.parse_args(argv)
    dev = device("cuda")
    args.out.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    makers = (_search_ops, lambda d: {"embed": _embed_op(d)},
              lambda d: {"embed_int8": _embed_int8_op(d)})
    if args.scan:
        _scan_probe(dev, smi, args.b1_before)
        return 0
    if args.ln:
        _ln_probe(dev, smi, args.reps, args.out)
        return 0
    if args.attention:
        _attention_variants(dev, smi)
        _attention_ablation(dev, smi)
        makers = makers[1:]
    for make in makers:
        for name, fn in make(dev).items():
            record = _profile(name, fn, args.reps, args.out)
            print(json.dumps({"card": smi, **record}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
