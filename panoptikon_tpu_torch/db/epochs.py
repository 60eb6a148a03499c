"""Process-local epoch counters for cache validation.

The search result cache is validated by *epoch equality*, not TTL
(reference db/epochs.rs + docs/search-cache-design.md): every committed
index write bumps the index epoch; user_data writes bump the user-data
epoch. A cache entry remembers the epoch pair it was computed at and is
valid iff both still match — correctness is exact, not probabilistic.
"""

from __future__ import annotations

import itertools
import threading


class EpochCounters:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._index: dict[str, int] = {}
        self._user: dict[str, int] = {}
        self._seq = itertools.count(1)

    def index_epoch(self, db: str) -> int:
        with self._lock:
            return self._index.get(db, 0)

    def user_data_epoch(self, db: str) -> int:
        with self._lock:
            return self._user.get(db, 0)

    def bump_index(self, db: str) -> int:
        with self._lock:
            value = next(self._seq)
            self._index[db] = value
            return value

    def bump_user_data(self, db: str) -> int:
        with self._lock:
            value = next(self._seq)
            self._user[db] = value
            return value

    def snapshot(self, db: str) -> tuple[int, int]:
        with self._lock:
            return self._index.get(db, 0), self._user.get(db, 0)


# Process-wide instance (the reference keeps these as statics).
EPOCHS = EpochCounters()
