"""The port's copies of the JAX package's host modules against their
originals, on the same seeded inputs: the host codec, ``VectorIndex``,
``utils.npy``, ``models.batching`` and ``models.base``. The port imports
nothing of ``panoptikon_tpu``; only this test imports both."""

import numpy as np
import pytest

from panoptikon_tpu.index.vector_index import VectorIndex as RefIndex
from panoptikon_tpu.models import base as ref_base
from panoptikon_tpu.models import batching as ref_batching
from panoptikon_tpu.ops import codec as ref_codec
from panoptikon_tpu.utils import npy as ref_npy
from panoptikon_tpu_torch.index import VectorIndex
from panoptikon_tpu_torch.models import base, batching
from panoptikon_tpu_torch.ops import codec
from panoptikon_tpu_torch.utils import npy


def _edge_rows(scale):
    edge = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5,
                     126.5, 127.49, 127.5, 128.0, 1e9, -127.5, -128.0, -128.5, -129.0, -1e9],
                    dtype=np.float32) * np.float32(scale)
    return np.stack([edge, -edge, edge * 3])


@pytest.mark.parametrize("absmax", [0.0, -1.0, 1.0, 0.37, 3e-20, 1e30, np.inf, -np.inf, np.nan])
def test_scale_and_artifact_match(absmax):
    scale = codec.scale_from_absmax(absmax)
    assert scale == ref_codec.scale_from_absmax(absmax)
    blob = codec.scale_artifact(scale)
    assert blob == ref_codec.scale_artifact(scale)
    assert codec.artifact_scale(blob) == ref_codec.artifact_scale(blob) == scale


@pytest.mark.parametrize("blob", [b"", b"\x00\x00\x80", b"\x00\x00\x80\x7f", b"\x00\x00\xc0\x7f",
                                  b"\x00\x00\x80\xbf", b"\x00\x00\x00\x00", b"\x00" * 5])
def test_artifact_rejects_unusable_scales(blob):
    assert codec.artifact_scale(blob) is None
    assert ref_codec.artifact_scale(blob) is None


@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_is_bit_identical(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(300, 96)).astype(np.float32)
    scale = codec.scale_from_absmax(codec.corpus_absmax(x))
    assert scale == ref_codec.scale_from_absmax(ref_codec.corpus_absmax(x))
    # Saturating queries and NaN / ±inf components beside ordinary rows.
    queries = np.concatenate([x[:5] * 4.0, np.pad(_edge_rows(scale), ((0, 0), (0, 96 - 21)))])
    for arr in (x, queries, _edge_rows(0.5), x[0]):
        got = codec.quantize_int8_host(arr, scale)
        np.testing.assert_array_equal(got, ref_codec.quantize_int8(arr, scale))
        np.testing.assert_array_equal(codec.compute_query_quant(arr, scale),
                                      ref_codec.compute_query_quant(arr, scale))
    # In place into a destination slab (the index build's chunked path).
    out = np.full(x.shape, 99, np.int8)
    assert codec.quantize_int8_host(x, scale, out=out) is out
    np.testing.assert_array_equal(out, ref_codec.quantize_int8(x, scale))
    with pytest.raises(ValueError):
        codec.quantize_int8_host(x, scale, out=np.zeros(x.shape, np.int16))
    codes = out
    np.testing.assert_array_equal(codec.dequantize_int8_host(codes, scale),
                                  ref_codec.dequantize_int8(codes, scale))


def test_corpus_absmax_matches_with_mask_nan_and_chunks():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(17_000, 512)).astype(np.float32)  # 35 MB: the chunked path
    x[3, 7] = np.nan
    x[16_999, 0] = -9.5
    valid = rng.random(17_000) > 0.3
    valid[16_999] = False
    assert codec.corpus_absmax(x) == ref_codec.corpus_absmax(x) == 9.5
    assert codec.corpus_absmax(x, valid) == ref_codec.corpus_absmax(x, valid) < 9.5
    assert codec.corpus_absmax(x[:10]) == ref_codec.corpus_absmax(x[:10])
    assert codec.corpus_absmax(np.zeros((0, 4), np.float32)) == 0.0


def _drive(index_cls, seed=3):
    """The same add / remove / build_quant / append / backfill / compact
    sequence; returns every snapshot and join along the way."""
    rng = np.random.default_rng(seed)
    idx = index_cls(chunk_rows=1024)
    seen = []

    def record(space):
        snap = idx.snapshot(space)
        seen.append((snap.generation, snap.size, snap.capacity, snap.num_groups, snap.scale,
                     snap.vectors[: snap.size].copy(), snap.row_valid.copy(),
                     snap.group_ids[: snap.size].copy(), snap.row_ids[: snap.size].copy(),
                     snap.weights[: snap.size].copy(),
                     None if snap.codes is None else snap.codes.copy()))

    idx.reserve("img", 3000, 32)
    items = np.repeat(np.arange(0, 2000, 2), 2)  # two rows per item
    idx.add("img", items, np.arange(2000), rng.normal(size=(2000, 32)).astype(np.float32))
    record("img")
    seen.append(idx.build_quant("img"))
    record("img")
    # Out-of-order items take the per-row slot loop.
    idx.add("img", [5001, 7, 5000], [2000, 2001, 2002],
            rng.normal(size=(3, 32)).astype(np.float32), weights=[0.5, 1.0, 2.0])
    record("img")  # not covered: the quant arm is hidden
    seen.append(idx.backfill_quant("img", idx.snapshot("img").scale or seen[1]))
    record("img")
    seen.append(idx.remove_items("img", [0, 10, 5001, 123456]))
    seen.append(idx.group_slots_for_items("img", np.array([[0, 2], [7, 999999]])))
    seen.append(idx.item_id_of_groups("img", np.array([-1, 0, 3, 10**6])))
    idx.compact("img")
    record("img")
    idx.add("txt", [1, 1, 2], [0, 1, 2], np.zeros((3, 8), np.float32))
    seen.append(idx.build_quant("txt"))  # a zero corpus: scale 1.0
    record("txt")
    idx.remove_items("txt", [1, 2])
    idx.compact("txt")  # every row tombstoned
    record("txt")
    idx.drop_quant("img")
    record("img")
    seen.append(idx.stats())
    seen.append(idx.space_names())
    return seen


def _equal(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray) and a.dtype == b.dtype
                and np.array_equal(a, b, equal_nan=a.dtype.kind == "f"))
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[key], b[key]) for key in a)
    return a == b


def test_vector_index_sequence_gives_identical_snapshots():
    got, want = _drive(VectorIndex), _drive(RefIndex)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert _equal(g, w), i


def test_npy_round_trip_matches():
    rng = np.random.default_rng(4)
    arrays = [rng.normal(size=(3, 5)).astype(np.float32), rng.normal(size=7),
              rng.integers(-9, 9, size=(2, 4), dtype=np.int16), np.array([True, False]),
              rng.normal(size=(4, 3)).astype(">f4"), np.asfortranarray(rng.normal(size=(3, 2)))]
    for arr in arrays:
        blob = npy.serialize_npy(arr)
        assert blob == ref_npy.serialize_npy(arr)
        assert _equal(npy.parse_npy(blob), ref_npy.parse_npy(blob))
        if arr.dtype.kind == "f":
            assert _equal(npy.parse_npy_embedding(blob), ref_npy.parse_npy_embedding(blob))
            assert _equal(npy.parse_npy_matrix(blob), ref_npy.parse_npy_matrix(blob))
    blob = _np_save(arrays[5])  # a Fortran-order payload as np.save writes it
    assert _equal(npy.parse_npy(blob), ref_npy.parse_npy(blob))
    vec = arrays[0][0]
    assert npy.f32_blob(vec) == ref_npy.f32_blob(vec)
    assert _equal(npy.blob_f32(npy.f32_blob(vec)), ref_npy.blob_f32(ref_npy.f32_blob(vec)))


def _np_save(arr):
    import io

    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


@pytest.mark.parametrize("blob", [
    b"", b"\x93NUMPY", b"NOTNUMPY\x01\x00", b"\x93NUMPY\x04\x00\x00\x00",
    b"\x93NUMPY\x01\x00\xff\x00{",
    b"\x93NUMPY\x01\x00\x10\x00[1, 2, 3]       ",
    b"\x93NUMPY\x01\x00\x20\x00{'descr': '<c8', 'fortran_order': False, 'shape': (1,)}",
    b"\x93NUMPY\x01\x00\x20\x00{'descr': '<f4', 'fortran_order': False, 'shape': (9,)}",
    b"\x93NUMPY\x01\x00\x20\x00{'descr': '<f4', 'shape': (1,)}                  ",
])
def test_npy_typed_errors_match(blob):
    with pytest.raises(ref_npy.NpyError) as want:
        ref_npy.parse_npy(blob)
    with pytest.raises(npy.NpyError) as got:
        npy.parse_npy(blob)
    assert isinstance(got.value, ValueError) and str(got.value) == str(want.value)
    with pytest.raises(npy.NpyError):
        npy.blob_f32(b"\x00\x00\x00")


def test_npy_embedding_shape_errors_match():
    for arr in (np.zeros((2, 2, 2), np.float32), np.zeros((0, 4), np.float32)):
        blob = npy.serialize_npy(arr)
        with pytest.raises(ref_npy.NpyError) as want:
            ref_npy.parse_npy_embedding(blob)
        with pytest.raises(npy.NpyError) as got:
            npy.parse_npy_embedding(blob)
        assert str(got.value) == str(want.value)


def test_batching_matches():
    for cap, b in ((1, 1), (64, 1), (100, 4), (256, 1)):
        ladder = batching.bucket_ladder(cap, b)
        assert ladder == ref_batching.bucket_ladder(cap, b)
        for n in (0, 1, 3, 64, 65, 300):
            assert batching.bucket_for(n, ladder) == ref_batching.bucket_for(n, ladder)
    rng = np.random.default_rng(5)
    batch = rng.normal(size=(5, 3, 2)).astype(np.float32)
    for bucket in (5, 8):
        assert _equal(batching.pad_batch(batch, bucket), ref_batching.pad_batch(batch, bucket))
    with pytest.raises(ValueError):
        batching.pad_batch(batch, 4)
    seqs = [[1, 2, 3], [4], list(range(9, 40))]
    for s in (seqs, []):
        assert _equal(batching.pad_token_batch(s, [8, 16], [1, 2, 4], pad_id=7),
                      ref_batching.pad_token_batch(s, [8, 16], [1, 2, 4], pad_id=7))


def test_error_slots_match():
    for cls, msg in (("input", "bad pixels"), ("transient", "")):
        slot = base.SlotError(cls, msg).to_slot()
        assert slot == ref_base.SlotError(cls, msg).to_slot()
        assert base.is_error_slot(slot) and ref_base.is_error_slot(slot)
        assert base.parse_error_slot(slot) == ref_base.parse_error_slot(slot) == (cls, msg)
    with pytest.raises(ValueError):
        base.SlotError("fatal", "x")
    for bad in ({"__error__": "x"}, {"__error__": {"class": "input", "message": 3}}):
        with pytest.raises(ValueError):
            base.parse_error_slot(bad)
        with pytest.raises(ValueError):
            ref_base.parse_error_slot(bad)
    assert not base.is_error_slot(b"npy") and not base.is_error_slot({"x": 1})
    inp = base.PredictionInput(data={"text": "a"})
    assert (inp.data, inp.file) == (ref_base.PredictionInput(data={"text": "a"}).data, None)
