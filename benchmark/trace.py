"""The traced slice of a run: ``torch.profiler`` over a fixed number of steps.

:func:`profile_steps` runs the steps under the profiler (CPU and CUDA
activity), a synchronize before and after, and returns a :class:`Slice`:
every device operation (a kernel, a copy or a memset) with its name and its
seconds; the device's busy seconds (the union of
those operations, ``roofline.union_seconds``) and the slice's wall seconds
on the host clock. The GPU-side copies of ``record_function`` ranges are
not operations and are left out. The per-layer metrics read the slice.
"""

from __future__ import annotations

import re
import time
from collections import defaultdict
from dataclasses import dataclass, field

from benchmark.roofline import union_seconds

# The harness's own ranges in the trace.
SPAN_PREFIX = "bench."


@dataclass
class DeviceOp:
    name: str
    start_s: float
    seconds: float

    @property
    def is_copy(self) -> bool:
        return self.name.startswith(("Memcpy", "Memset"))


@dataclass
class Slice:
    steps: int
    wall_s: float
    ops: list
    busy_s: float
    idle_gaps: list = field(default_factory=list)  # [(what the host was doing, seconds)]

    def seconds(self, match) -> float:
        """Device seconds of the operations for which ``match(op)`` holds."""
        return sum(op.seconds for op in self.ops if match(op))

    def kernel_seconds(self, pattern: str) -> float:
        """Device seconds of the kernels whose name matches ``pattern``."""
        rx = re.compile(pattern)
        return self.seconds(lambda op: not op.is_copy and rx.search(op.name) is not None)

    def device_ops(self, top: int = 10) -> list:
        by_name = defaultdict(float)
        for op in self.ops:
            by_name[op.name[:120]] += op.seconds
        return sorted(([n, s] for n, s in by_name.items()), key=lambda x: -x[1])[:top]


def _is_annotation(e) -> bool:
    return bool(getattr(e, "is_user_annotation", False))


def profile_steps(run_steps, device, host: bool = True) -> Slice:
    """Profile ``run_steps()``, which runs the slice's steps and returns how
    many completed. With ``host`` False only the device's operations are
    recorded (no host ranges, so no idle gaps are named), which costs the
    host loop least."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    on_card = device.type == "cuda"
    activities = (([ProfilerActivity.CPU] if host or not on_card else [])
                  + ([ProfilerActivity.CUDA] if on_card else []))
    if on_card:
        torch.cuda.synchronize(device)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        steps = run_steps()
        if on_card:
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    events = prof.events()
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    ops = [DeviceOp(e.name, e.time_range.start / 1e6, (e.time_range.end - e.time_range.start) / 1e6)
           for e in events if e.device_type == DeviceType.CUDA and not _is_annotation(e)]
    busy = union_seconds((op.start_s, op.start_s + op.seconds) for op in ops)
    return Slice(steps=steps, wall_s=wall, ops=ops, busy_s=busy, idle_gaps=_idle_gaps(ops, cpu))


def _idle_gaps(ops, cpu, top: int = 10) -> list:
    """The device's idle gaps inside the slice, each named by what the host
    was doing at its middle (the innermost bench span, then the innermost
    CPU operation there), summed by name: the longest ``top``."""
    steps = [e for e in cpu if e.name == SPAN_PREFIX + "step"]
    if not steps or not ops:
        return []
    lo = min(e.time_range.start for e in steps) / 1e6
    hi = max(e.time_range.end for e in steps) / 1e6
    busy = []
    for start, end in sorted((op.start_s, op.start_s + op.seconds) for op in ops):
        if busy and start <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], end)
        else:
            busy.append([start, end])
    gaps, prev = [], lo
    for start, end in busy:
        if start > prev:
            gaps.append((prev, min(start, hi)))
        prev = max(prev, end)
    if prev < hi:
        gaps.append((prev, hi))
    timed = sorted(((e.time_range.start / 1e6, e.time_range.end / 1e6, e.name) for e in cpu
                    if e.name != SPAN_PREFIX + "step"), key=lambda t: t[0])
    totals = defaultdict(float)
    j, inside = 0, []
    for g0, g1 in gaps:  # in time order: a sweep over the CPU events
        if g1 <= g0:
            continue
        mid = 0.5 * (g0 + g1)
        while j < len(timed) and timed[j][0] <= mid:
            inside.append(timed[j])
            j += 1
        inside = [t for t in inside if t[1] >= mid]
        span = min((t for t in inside if t[2].startswith(SPAN_PREFIX)),
                   key=lambda t: t[1] - t[0], default=None)
        op = min((t for t in inside if not t[2].startswith(SPAN_PREFIX)),
                 key=lambda t: t[1] - t[0], default=None)
        name = " > ".join(t[2] for t in (span, op) if t is not None) or "host (no op)"
        totals[name] += g1 - g0
    return sorted(([n, s] for n, s in totals.items()), key=lambda x: -x[1])[:top]
