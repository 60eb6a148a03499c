"""The port's spans and counters (``panoptikon_tpu_torch/tracing.py``) on the
CPU: nothing recorded without a profiler, the id map's and
``ClipImpl.predict``'s spans and counters under one, each span's seconds
held to its profiler ranges, and the same answers with tracing on and off."""

import gc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from panoptikon_tpu_torch import tracing
from panoptikon_tpu_torch.index import VectorIndex
from panoptikon_tpu_torch.index.device_index import DeviceIndex
from panoptikon_tpu_torch.models import impls

ITEMS, DIM, QUERIES, K = 5_000, 8, 32, 5
IMAGES, CAP = 8, 8


def _on():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture(scope="module")
def dindex():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((ITEMS, DIM)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    index = VectorIndex()
    index.add("s", np.arange(ITEMS) * 3 + 11, np.arange(ITEMS), x)
    index.build_quant("s")
    dindex = DeviceIndex(index, "s", torch.device("cpu"))
    _, rows, valid = dindex.search(torch.from_numpy(x[:QUERIES]), K)
    return dindex, rows, valid


@pytest.fixture(scope="module")
def clip_impl():
    impl = impls.ClipImpl(model_arch="test-tiny", batch_cap=CAP, device="cpu")
    size = impl.cfg.image_size
    rng = np.random.default_rng(3)
    inputs = [impls.PredictionInput(data={"pixels": rng.normal(size=(size, size, 3))
                                          .astype(np.float32)}) for _ in range(IMAGES)]
    return impl, inputs


@pytest.fixture(autouse=True)
def _fresh():
    tracing.reset()
    yield
    tracing.reset()


def _item_ids(dindex):
    d, rows, valid = dindex
    return d.item_ids(rows, valid)


def _predict(clip_impl):
    impl, inputs = clip_impl
    return impl.predict(inputs)


def test_without_a_profiler_nothing_is_recorded(dindex, clip_impl):
    assert tracing.span("a") is tracing.span("b")
    _item_ids(dindex)
    _predict(clip_impl)
    tracing.count("c", 1)
    assert tracing.totals() == {} and tracing.counters() == {}


def test_item_ids_records_the_id_table_and_its_rows(dindex):
    with _on():
        _item_ids(dindex)
        _item_ids(dindex)
        dindex[0].index.add("other", [1, 2], [1, 2], np.ones((2, DIM), np.float32))
    assert set(tracing.totals()) == {"vector_index.id_table"}
    # Each call counts the whole table that it reads (no copy is made).
    assert tracing.counters() == {"vector_index.id_table_rows": 2 * ITEMS}


def test_a_zero_count_is_kept_until_reset():
    with _on():
        tracing.count("c", 0)
        with tracing.span("s"):
            pass
    assert tracing.counters() == {"c": 0} and set(tracing.totals()) == {"s"}
    tracing.reset()
    assert tracing.totals() == {} and tracing.counters() == {}


def _profiled(run, arg):
    """The spans' seconds and the profiler's ranges (name -> µs each) over
    three calls of ``run``."""
    with _on():  # the first range of a process carries the profiler's own set-up
        with tracing.span("warm-up"):
            pass
    run(arg)
    tracing.reset()
    # A garbage collection inside a range but outside its span (a pass of
    # some 300 µs, whose timing moves with whatever the process imported)
    # is neither's work: none runs while the three calls are measured.
    gc.collect()
    gc.disable()
    try:
        with _on() as prof:
            for _ in range(3):
                run(arg)
    finally:
        gc.enable()
    ours = tracing.totals()
    theirs = {name: [e.time_range.end - e.time_range.start
                     for e in prof.events() if e.name == name] for name in ours}
    return ours, theirs


def test_id_table_seconds_match_its_profiler_events(dindex):
    ours, theirs = _profiled(_item_ids, dindex)
    (seconds,) = ours.values()
    (ranges,) = theirs.values()
    assert len(ranges) == 3
    b = sum(ranges)
    assert abs(seconds * 1e6 - b) <= max(0.05 * b, 50.0 * len(ranges)), (seconds, b)


def test_predict_stage_seconds_lie_within_their_profiler_ranges(clip_impl):
    # A stage's host clock reads inside its range, which also holds the
    # profiler's own bookkeeping at the range's edges.
    ours, theirs = _profiled(_predict, clip_impl)
    assert set(ours) == {"impls.clip_predict.stack", "impls.clip_predict.serialize"}
    for name, seconds in ours.items():
        assert len(theirs[name]) == (6 if name.endswith(".stack") else 3)
        assert 0 < seconds * 1e6 <= sum(theirs[name]), name


def test_predict_stages_and_upload_bytes(clip_impl):
    impl, inputs = clip_impl
    with _on():
        impl.predict(inputs)
    assert set(tracing.totals()) == {"impls.clip_predict.stack", "impls.clip_predict.serialize"}
    size = impl.cfg.image_size
    assert tracing.counters() == {"impls.clip_upload_bytes": CAP * size * size * 3 * 4}


@pytest.mark.parametrize("run", [_item_ids, _predict], ids=["item_ids", "predict"])
def test_answers_are_bit_equal_on_and_off(run, dindex, clip_impl):
    arg = dindex if run is _item_ids else clip_impl
    off = run(arg)
    with _on():
        on = run(arg)
    assert tracing.totals()
    if run is _item_ids:
        assert on.dtype == off.dtype and np.array_equal(on, off)
    else:
        assert on == off  # npy bytes, position by position
