"""The readings that the limits of a cell's check are set from.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 [--seconds 2]

For each seed, in one process: a run of the cell with a short window (the
program, as ``run.py`` runs it, its answers checked against the plain
reference), then the control in the program's place (the reference computed
in the precision below the one the configuration states; the kind's
``control``). One JSON line a seed, then the summary: for each number
compared, the lower reading (the largest of the program's) and the upper
(the smallest of the control's). A limit lies between the two. Benchmark
runs never run this.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402


def readings(spec, workload: str, seeds, seconds: float, device, t0: float) -> dict:
    """{"program": {name: [value a seed]}, "control": {name: [value a seed]}}."""
    import torch

    from benchmark import harness

    out = {"program": {}, "control": {}}
    for seed in seeds:
        outcome = harness.run(spec, workload, seed, seconds, False, device, t0)
        kind = spec.kind(outcome.reading.cell)
        program = {name: value for name, value, _ in outcome.checks}
        control = dict(kind.control(outcome.state))
        for side, values in (("program", program), ("control", control)):
            for name, value in values.items():
                out[side].setdefault(name, []).append(value)
        print(json.dumps({"workload": workload, "seed": seed, "failed": outcome.failed,
                          "program": program, "control": control}), flush=True)
        del outcome
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--seconds", type=float, default=2.0)
    args = parser.parse_args(argv)

    from benchmark.run import ROOT, cache_env

    cache_env(ROOT)
    import torch

    from benchmark.spec import Spec

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    got = readings(Spec.load(), args.workload, seeds, args.seconds, torch.device("cuda", 0), T0)
    summary = {name: {"lower": max(got["program"][name]),
                      "upper": min(got["control"].get(name, [float("nan")]))}
               for name in got["program"]}
    print(json.dumps({"workload": args.workload, "seeds": len(seeds), "summary": summary}),
          flush=True)
    return 0


if __name__ == "__main__":
    if Path(sys.path[0]).resolve() == Path(__file__).resolve().parent:
        sys.path[0] = str(Path(__file__).resolve().parent.parent)
    sys.exit(main())
