"""Epoch-validated span result cache.

The port's copy of ``panoptikon_tpu/api/search_cache.py``, held to it unit for unit by
``tests/test_torch_host_copies.py``.

The reference's search cache (api/search_cache.rs, docs/search-span-cache-
design.md): results are cached in fixed 256-row spans keyed by the query
WITHOUT pagination (so any page that falls inside cached spans hits), and
validated by epoch equality — an entry remembers the (index, user_data)
epochs it was computed at and is valid iff both still match. Correctness is
exact: any committed write bumps an epoch and instantly invalidates.

A byte-budget LRU bounds memory; span inserts/evictions are whole-span.
Counts cache separately under the same key+epoch discipline.
"""

from __future__ import annotations

import hashlib
import json
import sys
import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Optional

SPAN_ROWS = 256  # api/search_cache.rs:43
DEFAULT_BYTE_BUDGET = 256 * 1024 * 1024


def query_cache_key(payload: dict) -> str:
    """Canonical query identity: the JSON payload minus pagination fields
    (page/page_size stay OUT so spans serve any window —
    search_cache.rs:56-92)."""
    scrubbed = {
        k: v
        for k, v in payload.items()
        if k not in ("page", "page_size", "prefetch_rows", "cache")
    }
    blob = json.dumps(scrubbed, sort_keys=True, separators=(",", ":"), default=str)
    return hashlib.sha256(blob.encode()).hexdigest()


@dataclass
class EpochSnapshot:
    index: int
    user_data: int

    def key(self) -> tuple[int, int]:
        return (self.index, self.user_data)


@dataclass
class _SpanEntry:
    rows: list[Any]
    epochs: tuple[int, int]
    nbytes: int


class SpanCache:
    def __init__(self, byte_budget: int = DEFAULT_BYTE_BUDGET):
        self.byte_budget = byte_budget
        self._lock = threading.Lock()
        self._spans: OrderedDict[tuple[str, int], _SpanEntry] = OrderedDict()
        self._counts: OrderedDict[str, tuple[int, tuple[int, int]]] = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0

    # -- rows ---------------------------------------------------------------

    def lookup_rows(
        self, key: str, offset: int, limit: int, epochs: EpochSnapshot
    ) -> Optional[list[Any]]:
        """Rows [offset, offset+limit) if every covering span is cached,
        valid, and long enough (search_cache.rs:409)."""
        if limit <= 0:
            return []
        first = offset // SPAN_ROWS
        last = (offset + limit - 1) // SPAN_ROWS
        out: list[Any] = []
        with self._lock:
            for span_idx in range(first, last + 1):
                entry = self._spans.get((key, span_idx))
                if entry is None or entry.epochs != epochs.key():
                    self.misses += 1
                    return None
                self._spans.move_to_end((key, span_idx))
                out.extend(entry.rows)
                if len(entry.rows) < SPAN_ROWS:
                    break  # terminal (short) span
            self.hits += 1
        start = offset - first * SPAN_ROWS
        window = out[start : start + limit]
        # A short read is only trustworthy if we saw the terminal span.
        if len(window) < limit and len(out) - start > len(window):
            return None
        if len(window) < limit:
            covered = first * SPAN_ROWS + len(out)
            if covered >= offset + limit:
                return None
            # The result set genuinely ends inside the cached range.
            return window
        return window

    def insert_rows(
        self, key: str, offset: int, rows: list[Any], epochs: EpochSnapshot,
        terminal: bool,
    ) -> None:
        """Cache rows starting at ``offset`` (must be span-aligned). Partial
        trailing spans are kept only when ``terminal`` (the result set ends
        there) — otherwise a short span would masquerade as the end
        (search_cache.rs:504)."""
        if offset % SPAN_ROWS:
            return
        with self._lock:
            for i in range(0, len(rows), SPAN_ROWS):
                span = rows[i : i + SPAN_ROWS]
                if len(span) < SPAN_ROWS and not terminal:
                    break
                span_idx = offset // SPAN_ROWS + i // SPAN_ROWS
                nbytes = _approx_bytes(span)
                old = self._spans.pop((key, span_idx), None)
                if old is not None:
                    self._bytes -= old.nbytes
                self._spans[(key, span_idx)] = _SpanEntry(
                    rows=span, epochs=epochs.key(), nbytes=nbytes
                )
                self._bytes += nbytes
            self._evict()

    # -- counts -------------------------------------------------------------

    def lookup_count(self, key: str, epochs: EpochSnapshot) -> Optional[int]:
        with self._lock:
            entry = self._counts.get(key)
            if entry is None or entry[1] != epochs.key():
                self.misses += 1
                return None
            self._counts.move_to_end(key)
            self.hits += 1
            return entry[0]

    def insert_count(self, key: str, count: int, epochs: EpochSnapshot) -> None:
        with self._lock:
            self._counts[key] = (count, epochs.key())
            self._counts.move_to_end(key)
            while len(self._counts) > 4096:
                self._counts.popitem(last=False)

    # -- management ---------------------------------------------------------

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._counts.clear()
            self._bytes = 0

    def resize(self, byte_budget: int) -> None:
        with self._lock:
            self.byte_budget = byte_budget
            self._evict()

    def stats(self) -> dict:
        with self._lock:
            return {
                "spans": len(self._spans),
                "counts": len(self._counts),
                "bytes": self._bytes,
                "byte_budget": self.byte_budget,
                "hits": self.hits,
                "misses": self.misses,
            }

    def _evict(self) -> None:
        while self._bytes > self.byte_budget and self._spans:
            _, entry = self._spans.popitem(last=False)
            self._bytes -= entry.nbytes


def _approx_bytes(rows: list[Any]) -> int:
    """Byte estimate for LRU accounting. Sampled: rows in one span share a
    query's column shape, so sizing every cell (256 rows × ~20 cells of
    ``getsizeof`` per insert, ~1.5 ms of GIL-held work per cached query)
    buys no accuracy over sizing a few rows and scaling."""
    if not rows:
        return 256

    def one(row: Any) -> int:
        if isinstance(row, dict):
            return sum(
                sys.getsizeof(k) + sys.getsizeof(v) for k, v in row.items()
            )
        return sys.getsizeof(row)

    step = max(1, len(rows) // 4)
    sample = rows[::step]
    return 256 + sum(one(r) for r in sample) * len(rows) // len(sample)
