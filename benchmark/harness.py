"""One run of one cell: set-up, the window or the traced slice, the check.

Generic over what the data files name. A traffic kind (``kinds/<kind>.py``)
gives:

- ``WORK``: the unit a step completes (``"queries"``, ``"images"``) and
  ``work(cell)``, how many a step completes;
- ``setup(cell, seed, device)`` -> state, and ``warm(state, spans)``, which
  runs every shape the window will use;
- ``step(state, i, spans)`` -> the step's output, one closed-loop step (the
  next starts when it returns, its answers on the host);
- ``release(state)``: frees the program's device state once the window has
  closed and the memory peak is read;
- ``check(state, outputs)`` -> [(name, value, limit)]: the comparison with
  the plain reference (a value above its limit is not correct);
- ``control(state)`` -> [(name, value)]: the same numbers with the control
  in the program's place (``benchmark/control.py`` reads it, runs never).

Each metric is read by ``metrics/<name>.py``'s ``read(reading)``, which
returns a number, or None where it finds nothing to read. Where a cell has
an end-to-end metric whose source is ``device_trace``, its untraced window
runs on the card under the profiler, recording the device's operations
only, and the reading's ``slice`` holds them.
"""

from __future__ import annotations

import contextlib
import gc
import time
import traceback
from collections import defaultdict
from dataclasses import dataclass, field

from benchmark import trace as tracing


class Spans:
    """Host seconds by name around the harness's calls into the program;
    with ``traced`` each is also a ``bench.<name>`` range in the trace."""

    def __init__(self, traced: bool = False):
        self.traced = traced
        self.seconds = defaultdict(float)

    @contextlib.contextmanager
    def __call__(self, name: str):
        rf = contextlib.nullcontext()
        if self.traced:
            from torch.profiler import record_function

            rf = record_function(tracing.SPAN_PREFIX + name)
        with rf:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.seconds[name] += time.perf_counter() - t0


@dataclass
class Reading:
    """What the metric readers read."""

    cell: object
    setup_s: float
    steps: int = 0  # steps completed in the window or the slice
    window_s: float = 0.0
    work: dict = field(default_factory=dict)  # unit -> completed in the window or the slice
    slice: object = None  # trace.Slice of a traced run
    spans: dict = field(default_factory=dict)  # span name -> host seconds over the steps

    @property
    def config(self):
        return self.cell.config

    @property
    def traffic(self):
        return self.cell.traffic


@dataclass
class Outcome:
    reading: Reading
    attempted: int
    failed: int
    checks: list
    memory_peak_bytes: int
    errors: list
    state: object = None  # the kind's state, its program parts released

    @property
    def correct(self) -> bool:
        return self.failed == 0 and all(value <= limit for _, value, limit in self.checks)


def _steps(kind, state, spans, *, count=None, seconds=None):
    """Closed loop: ``count`` steps, or steps until ``seconds`` have passed
    (the step that crosses the end is kept, and the window ends with it).
    Returns (outputs, failed, errors, seconds)."""
    outputs, failed, errors = [], 0, []
    t_start = time.perf_counter()
    i = 0
    while True:
        try:
            with spans("step"):
                outputs.append(kind.step(state, i, spans))
        except Exception:  # a step that raises is an answer that never came
            failed += 1
            if len(errors) < 3:
                errors.append(traceback.format_exc())
        i += 1
        now = time.perf_counter()
        if (count is not None and i >= count) or (seconds is not None and now - t_start >= seconds):
            return outputs, failed, errors, now - t_start


def run(spec, name: str, seed: int, seconds: float, traced: bool, device, t0: float) -> Outcome:
    """One run of cell ``name``; ``t0`` is the host clock at the process's
    start, from which set-up is counted."""
    import torch

    cell = spec.cell(name)
    kind = spec.kind(cell)
    on_card = device.type == "cuda"
    state = kind.setup(cell, seed, device)
    kind.warm(state, Spans())
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    gc.collect()
    gc.freeze()
    reading = Reading(cell=cell, setup_s=time.perf_counter() - t0)
    spans = Spans(traced)
    if traced:
        box = {}

        def slice_steps():
            box["run"] = _steps(kind, state, spans, count=int(cell.traffic["trace_batches"]))
            return len(box["run"][0])

        reading.slice = tracing.profile_steps(slice_steps, device)
        outputs, failed, errors, _ = box["run"]
        reading.window_s = reading.slice.wall_s
    elif on_card and any(m["source"] == "device_trace" for m in cell.end_to_end):
        box = {}

        def window_steps():
            box["run"] = _steps(kind, state, spans, seconds=seconds)
            return len(box["run"][0])

        reading.slice = tracing.profile_steps(window_steps, device, host=False)
        outputs, failed, errors, reading.window_s = box["run"]
    else:
        # Each step ends with its answers on the host, so the window ends
        # with the device's work.
        outputs, failed, errors, reading.window_s = _steps(kind, state, spans, seconds=seconds)
    per_step = kind.work(cell)
    done = len(outputs)
    reading.steps = done
    reading.work = {kind.WORK: per_step * done}
    reading.spans = dict(spans.seconds)
    peak = int(torch.cuda.max_memory_allocated(device)) if on_card else 0
    kind.release(state)
    if on_card:
        torch.cuda.empty_cache()
    gc.unfreeze()
    checks = kind.check(state, outputs)
    return Outcome(reading=reading, attempted=per_step * (done + failed),
                   failed=per_step * failed, checks=checks, memory_peak_bytes=peak,
                   errors=errors, state=state)


def read_metrics(spec, outcome: Outcome, traced: bool) -> dict:
    """The cell's end-to-end metrics (untraced) or per-layer metrics
    (traced), by their readers; a reader that finds nothing is left out."""
    cell = outcome.reading.cell
    out = {}
    for metric in (cell.per_layer if traced else cell.end_to_end):
        value = spec.reader(metric).read(outcome.reading)
        if value is not None:
            out[metric["name"]] = {"value": float(value), "unit": metric["unit"]}
    return out
