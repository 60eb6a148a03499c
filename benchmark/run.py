"""Run one cell of the benchmark once, on the NVIDIA GPU of this machine.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

(or ``python3 -m benchmark.run …``), from the root of a checkout. With
``--trace 0`` it measures the cell's end-to-end metrics over a window of
``--seconds``; with ``--trace 1`` it runs the traffic's ``trace_batches``
steps under ``torch.profiler`` and reads the cell's per-layer metrics. Both
then check the window's answers against the plain reference. The last line
of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``: each number compared, with its limit); the last lines of
standard error are the same numbers and limits.

It exits non-zero and prints no result where there is no CUDA device, or
fewer than the cell asks for, and where JAX, jaxlib, flax or the JAX
package (``panoptikon_tpu``, compared by whole top-level name) is loaded
once the window has closed. Build and kernel caches stay under ``build/``
in the checkout.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "panoptikon_tpu")


def forbidden_modules(names=None) -> list:
    """Loaded modules (or ``names``) whose top-level name (before the first
    dot) is one of ``FORBIDDEN``, compared whole: ``panoptikon_tpu_torch`` is
    not ``panoptikon_tpu``."""
    names = list(sys.modules) if names is None else names
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))


def cache_env(root: Path) -> None:
    """Fixed cache directories inside the checkout (the port's kernels
    build into ``build/torch_kernels`` by themselves); nothing here loads
    JAX through ``transformers``."""
    build = root / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.splitlines()[0].strip() if out.strip() else None


def result_line(outcome, metrics: dict, device: dict, traced: bool) -> dict:
    line = {"correct": outcome.correct, "attempted": outcome.attempted, "failed": outcome.failed,
            "metrics": metrics, "device": device}
    if traced:
        s = outcome.reading.slice
        line["breakdown"] = {"device_ops": s.device_ops(), "idle_gaps": s.idle_gaps}
    line["checks"] = {name: {"value": value, "limit": limit}
                      for name, value, limit in outcome.checks}
    return line


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    cache_env(ROOT)

    import torch

    from benchmark import harness
    from benchmark.spec import Spec

    spec = Spec.load()
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA device(s), found {have}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    traced = bool(args.trace)
    outcome = harness.run(spec, args.workload, args.seed, args.seconds, traced, device, T0)
    metrics = harness.read_metrics(spec, outcome, traced)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": cell.chips,
           "memory_peak_bytes": outcome.memory_peak_bytes, "power_limit": power_limit()}
    if traced:
        dev["busy_s"] = outcome.reading.slice.busy_s / cell.chips
        dev["window_s"] = outcome.reading.slice.wall_s
    for err in outcome.errors:
        print(err, file=sys.stderr)
    line = result_line(outcome, metrics, dev, traced)
    for name, value, limit in outcome.checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    if Path(sys.path[0]).resolve() == Path(__file__).resolve().parent:
        # Run as a script: import the package from the checkout's root, and
        # let no file here shadow a module of the standard library.
        sys.path[0] = str(ROOT)
    sys.exit(main())
