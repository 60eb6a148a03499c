"""Spans and counters inside the port, recorded only under ``torch.profiler``.

There is one switch, torch's own profiler state: a span or a counter
records only while a ``torch.profiler`` session is active
(``torch.autograd._profiler_enabled()``). Otherwise :func:`span` returns one
shared no-op context manager and :func:`count` returns at once, so nothing
is allocated, recorded or synchronized.

While the profiler is on, ``span(name)`` opens
``torch.profiler.record_function(name)``, so the span sits in the trace on
the profiler's clock, where it keeps its nesting (a device idle gap inside it
takes its name), and adds its host seconds, on ``time.perf_counter_ns()``
inside that range, to a per-name total. Counters keep per-name sums. A span times host work only:
it never touches the device or waits for it; the trace attributes the
device's time.

Names are ``<module>.<unit>[.<stage>]``.

Spans:

- ``impls.clip_predict.stack``: ``ClipImpl.predict``'s inputs read and
  stacked, and each slice padded to its bucket;
  ``impls.clip_predict.serialize``: its embeddings written as npy bytes;
- ``vector_index.id_table``: ``VectorIndex.item_id_of_groups`` taking its
  view of the host index's slot → item table (no copy is made);
- ``kimi_vl.vision``, ``kimi_vl.prefill``, ``kimi_vl.decode``:
  ``models.kimi_vl.generate``'s stages (MoonViT and the projector; the
  prompt through the language model; the decode steps, ending with the
  tokens on the host). The first two end with a synchronize while the
  profiler is on, so that each holds its own stage's device time.

Counters:

- ``vector_index.id_table_rows``: the entries of the table that the call
  reads, each call;
- ``impls.clip_upload_bytes``: the bytes of each pixel batch that
  ``ClipImpl`` copies to its device;
- ``kimi_vl.decode_steps``, ``kimi_vl.prefill_tokens``,
  ``kimi_vl.cache_bytes``: a caption batch's decode steps, prompt tokens
  and the bytes of the latent cache it runs through (kept across batches
  of one shape).
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch

_OFF = contextlib.nullcontext()
_lock = threading.Lock()
_seconds: dict = {}  # span name -> host seconds
_counters: dict = {}  # counter name -> sum


class _Span:
    __slots__ = ("name", "start_ns", "_rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        took = time.perf_counter_ns() - self.start_ns
        self._rf.__exit__(*exc)
        with _lock:
            _seconds[self.name] = _seconds.get(self.name, 0.0) + took / 1e9
        return False


def span(name: str):
    """A context manager timing the host work inside it as span ``name``
    while the profiler is on; the shared no-op otherwise."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name)


def count(name: str, n) -> None:
    """Add ``n`` to counter ``name`` while the profiler is on."""
    if not torch.autograd._profiler_enabled():
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def totals() -> dict:
    """Span name -> its host seconds since the last :func:`reset`."""
    with _lock:
        return dict(_seconds)


def counters() -> dict:
    """Counter name -> its sum since the last :func:`reset`."""
    with _lock:
        return dict(_counters)


def reset() -> None:
    """Drop every total and counter (spans open now still close)."""
    with _lock:
        _seconds.clear()
        _counters.clear()
