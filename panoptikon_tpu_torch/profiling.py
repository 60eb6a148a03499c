"""Where the device time goes on the port's main path, on one NVIDIA GPU.

    python3 -m panoptikon_tpu_torch.profiling [--out DIR] [--reps N]

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
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

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
    return {
        "op": name, "reps": reps, "device_ms_per_call": device_ms, "wall_ms_per_call": wall_ms,
        "device_idle_share": max(0.0, 1.0 - device_ms / wall_ms),
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
    for make in makers:
        for name, fn in make(dev).items():
            record = _profile(name, fn, args.reps, args.out)
            print(json.dumps({"card": smi, **record}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
