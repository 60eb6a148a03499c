"""The port's ``VectorIndex.item_id_of_groups`` (slot → DB item id) against
the JAX package's ``VectorIndex`` on the CPU: the same answers after every
kind of write, a lookup that copies no table, and a view taken before a
capacity doubling that still answers right while a writer appends."""

import sys
import threading
import tracemalloc

import numpy as np
import pytest

from panoptikon_tpu.index.vector_index import VectorIndex as RefIndex
from panoptikon_tpu_torch.index import VectorIndex

DIM = 4


def _rows(rng, n):
    return rng.normal(size=(n, DIM)).astype(np.float32)


def _bulk_grows(idx, rng, look):
    # Ascending batches of new items (two rows for every third item) across
    # the doublings 4,096 → 8,192 → 16,384.
    items = np.repeat(np.arange(1, 12_000) * 5, np.where(np.arange(11_999) % 3, 1, 2))
    for lo in range(0, 15_000, 2_999):
        batch = items[lo:lo + 2_999]
        idx.add("s", batch, np.arange(lo, lo + len(batch)), _rows(rng, len(batch)))
        look("s")


def _per_row(idx, rng, look):
    idx.add("s", [10, 20, 30], [0, 1, 2], _rows(rng, 3))
    look("s")
    # Out of order, repeated and new items take the per-row slot loop.
    for items in ([25, 5, 25], [20, 20, 40], [1, 30, 10**12, 2]):
        base = idx.stats()["s"]["rows"]
        idx.add("s", items, np.arange(base, base + len(items)), _rows(rng, len(items)))
        look("s")


def _interleaved(idx, rng, look):
    # A watch job: small appends, mostly new items and now and then an old
    # one, each followed by a lookup.
    seen, row = [], 0
    for i in range(60):
        new = list(range(1_000 + 97 * i, 1_000 + 97 * i + 90, 3))
        old = [seen[int(rng.integers(len(seen)))]] if seen and i % 4 == 3 else []
        items = old + new
        idx.add("s", items, np.arange(row, row + len(items)), _rows(rng, len(items)))
        seen += new
        row += len(items)
        look("s")


def _removed(idx, rng, look):
    idx.add("s", np.repeat(np.arange(500), 2), np.arange(1_000), _rows(rng, 1_000))
    idx.remove_items("s", [0, 7, 499, 10**6])
    look("s")


def _compacted(idx, rng, look):
    idx.add("s", np.repeat(np.arange(500), 2), np.arange(1_000), _rows(rng, 1_000))
    idx.remove_items("s", np.arange(0, 500, 3))
    idx.compact("s")
    look("s")
    idx.add("s", [600, 3], [1_000, 1_001], _rows(rng, 2))
    look("s")


def _compacted_empty(idx, rng, look):
    idx.add("s", [4, 4, 9], [0, 1, 2], _rows(rng, 3))
    idx.remove_items("s", [4, 9])
    idx.compact("s")  # every row tombstoned
    look("s")
    idx.add("s", [2, 1], [3, 4], _rows(rng, 2))
    look("s")


def _dropped_and_readded(idx, rng, look):
    idx.add("s", np.arange(5_000) * 2, np.arange(5_000), _rows(rng, 5_000))
    look("s")
    idx.drop_space("s")
    idx.add("s", [9, 3, 9, 8], [0, 1, 2, 3], _rows(rng, 4))
    look("s")


CASES = {f.__name__.lstrip("_"): f for f in (
    _bulk_grows, _per_row, _interleaved, _removed, _compacted, _compacted_empty,
    _dropped_and_readded)}


def _answers(index_cls, case):
    rng = np.random.default_rng(11)
    idx = index_cls(chunk_rows=1024)
    seen = []

    def look(space):
        n = idx.stats()[space]["items"]
        some = rng.integers(0, max(n, 1), 64)
        for slots in (np.array([-1, 0, n - 1, n, n + 1, 10**9], dtype=np.int64), some,
                      np.empty(0, dtype=np.int64),
                      np.array([[n, 0], [-1, max(n - 1, 0)]], dtype=np.int32)):
            seen.append((n, idx.item_id_of_groups(space, slots)))

    case(idx, rng, look)
    return seen


@pytest.mark.parametrize("case", list(CASES))
def test_item_ids_match_the_reference(case):
    got, want = _answers(VectorIndex, CASES[case]), _answers(RefIndex, CASES[case])
    assert len(got) == len(want) > 0
    for i, ((n, a), (m, b)) in enumerate(zip(got, want)):
        assert n == m, i
        assert a.dtype == b.dtype and a.shape == b.shape, i
        np.testing.assert_array_equal(a, b, err_msg=str(i))


def test_a_lookup_copies_no_table():
    n = 262_144
    items = np.arange(n, dtype=np.int64) * 3 + 1
    idx = VectorIndex()
    idx.add("s", items, np.arange(n), np.zeros((n, DIM), np.float32))
    slots = np.random.default_rng(5).integers(-1, n + 2, 40)
    item_list = items.tolist()
    tracemalloc.start()
    try:
        before, _ = tracemalloc.get_traced_memory()
        tracemalloc.reset_peak()
        got = idx.item_id_of_groups("s", slots)
        lookup = tracemalloc.get_traced_memory()[1] - before
        before, _ = tracemalloc.get_traced_memory()
        tracemalloc.reset_peak()
        table = np.asarray(item_list, dtype=np.int64)  # the table rebuilt
        rebuild = tracemalloc.get_traced_memory()[1] - before
    finally:
        tracemalloc.stop()
    ok = (slots >= 0) & (slots < n)
    np.testing.assert_array_equal(got, np.where(ok, items[np.where(ok, slots, 0)], -1))
    assert rebuild >= table.nbytes == 2 * 1024 * 1024
    assert lookup < 64 * 1024, lookup


def test_a_view_taken_before_a_grow_stays_right():
    # Bulk batches of new items cross the doublings 4,096 → … → 65,536
    # while readers map slots that were known before each append.
    batch, batches = 1_500, 24
    total = batch * batches
    items = np.arange(total, dtype=np.int64) * 7 + 3
    vectors = np.zeros((total, DIM), np.float32)
    ref = RefIndex(chunk_rows=1024)
    ref.add("s", items, np.arange(total), vectors)
    idx = VectorIndex(chunk_rows=1024)
    idx.add("s", items[:batch], np.arange(batch), vectors[:batch])
    errors, reads, done = [], [], threading.Event()
    started = threading.Barrier(4)

    def writer():
        started.wait()
        for lo in range(batch, total, batch):
            idx.add("s", items[lo:lo + batch], np.arange(lo, lo + batch), vectors[lo:lo + batch])
        done.set()

    def reader(seed):
        rng = np.random.default_rng(seed)
        started.wait()
        while True:
            last = done.is_set()
            known = idx.stats()["s"]["items"]
            slots = np.concatenate([[-1], rng.integers(0, known, 4_096)])
            got, want = idx.item_id_of_groups("s", slots), ref.item_id_of_groups("s", slots)
            if not np.array_equal(got, want):
                errors.append((known, int(np.sum(got != want))))
            reads.append(known)
            if last:
                return

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=writer)] + [
            threading.Thread(target=reader, args=(seed,)) for seed in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert idx.stats()["s"]["capacity"] == 65_536 and idx.stats()["s"]["items"] == total
    assert errors == [] and len(reads) >= 3
