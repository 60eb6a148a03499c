"""The port's sharded index and meshes (``index/sharded.py``,
``parallel/``) against the JAX package's on the CPU.

The JAX functions run on the 8 virtual CPU devices of ``tests/conftest.py``;
the port's mesh is 8 logical shards on the CPU (``set_devices([cpu] * 8)``),
each a slab of its own. ``build_sharded``'s layout must equal the
reference's bit for bit (the host packing is the reference's text). Searches
and surfaces must equal the JAX results up to ties (ids through
``item_ids``, distances within 1e-6: XLA turns cosine's ``d / sqrt(x)`` into
``d * rsqrt(x)``, ulps away) and the port's own one-device results with ids
exact."""

import numpy as np
import pytest
import torch

from panoptikon_tpu.index import sharded as ref_sharded
from panoptikon_tpu.index.vector_index import VectorIndex as RefIndex
from panoptikon_tpu.ops import codec as ref_codec
from panoptikon_tpu.parallel import mesh as ref_mesh
from panoptikon_tpu_torch.index import sharded
from panoptikon_tpu_torch.index.vector_index import VectorIndex
from panoptikon_tpu_torch.ops import codec, exact, int8_scan, scoring
from panoptikon_tpu_torch.parallel import mesh as meshlib
from panoptikon_tpu_torch.parallel import multihost

CHUNK = 16
CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(autouse=True)
def cpu_mesh():
    meshlib.set_devices(CPU8)
    yield
    meshlib.set_devices(None)
    meshlib.set_multihost_layout("replica")


def make_pair(n=240, dim=32, rows_per_item=1, seed=3, drop=()):
    """The same rows in a port index and a reference index; ``drop`` item
    ids removed from both (an uneven corpus)."""
    rng = np.random.default_rng(seed)
    vecs = rng.normal(size=(n, dim)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    items = np.arange(n) // rows_per_item + 1000
    port, ref = VectorIndex(chunk_rows=64), RefIndex(chunk_rows=64)
    for idx in (port, ref):
        idx.add("clip", items, np.arange(n), vecs)
        if drop:
            idx.remove_items("clip", np.asarray(drop))
        idx.build_quant("clip")
    return port, ref, vecs


def meshes(kind):
    if kind == "1d":
        return meshlib.index_mesh(), ref_mesh.index_mesh()
    return meshlib.serving_mesh(2), ref_mesh.serving_mesh(2)


def slabs(tensors, mesh):
    """The port's per-entry slabs of the first replica row, stacked."""
    return np.stack([t.numpy() for t in tensors[: meshlib.num_shards(mesh)]])


@pytest.mark.parametrize("kind", ["1d", "2x4"])
@pytest.mark.parametrize("rows_per_item", [1, 3])
@pytest.mark.parametrize("uneven", [False, True])
@pytest.mark.parametrize("use_quant", [False, True])
def test_layout_is_the_reference_s(kind, rows_per_item, uneven, use_quant):
    drop = (1001, 1002, 1013, 1040) if uneven else ()
    port, ref, _ = make_pair(rows_per_item=rows_per_item, drop=drop)
    mesh, rmesh = meshes(kind)
    got = sharded.build_sharded(port.snapshot("clip"), mesh, use_quant=use_quant,
                                chunk_rows=CHUNK)
    want = ref_sharded.build_sharded(ref.snapshot("clip"), rmesh, use_quant=use_quant,
                                     chunk_rows=CHUNK)
    assert meshlib.num_shards(mesh) == got.num_shards == want.num_shards == (8 if kind == "1d" else 4)
    for name in ("rows_per_shard", "groups_per_shard", "dim", "scale", "one_row_per_item",
                 "chunk_rows"):
        assert getattr(got, name) == getattr(want, name), name
    np.testing.assert_array_equal(got.item_ids, want.item_ids)
    np.testing.assert_array_equal(got.row_perm, want.row_perm)
    s, r = got.num_shards, got.rows_per_shard
    for name in ("corpus", "row_valid", "group_ids", "weights", "sumsq"):
        want_arr = np.asarray(getattr(want, name))
        got_arr = slabs(getattr(got, name), mesh)
        assert got_arr.dtype == want_arr.dtype, name
        if name == "sumsq" and not use_quant:
            # f32 sums of squares: the port's are rounded once from f64.
            np.testing.assert_allclose(got_arr.reshape(want_arr.shape), want_arr, rtol=1e-6)
        else:
            np.testing.assert_array_equal(got_arr.reshape(want_arr.shape), want_arr, err_msg=name)
    # Every mesh entry holds its shard's slab: replicas of a shard on one
    # device share one tensor.
    assert len(got.corpus) == mesh.size
    for e, t in enumerate(got.corpus):
        assert t is got.corpus[e % s] and t.shape[0] == r


def one_device(snap, q, *, k, distance, use_quant, grouped):
    """The port's one-device result in snapshot group slots."""
    corpus = torch.from_numpy(snap.codes if use_quant else snap.vectors)
    sumsq = scoring.row_sumsq_chunked(corpus)
    valid = torch.from_numpy(snap.row_valid)
    scale = float(snap.scale) if use_quant else 1.0
    if grouped:
        v, slots, _ = scoring.streaming_grouped_topk(
            corpus, sumsq, valid, torch.from_numpy(snap.group_ids), q,
            num_groups=snap.num_groups, k=k, distance=distance, scale=scale, chunk_rows=64)
        return v.numpy(), slots.numpy()
    if use_quant:
        # Unsharded B1 (its plain version: these tensors lie on the CPU).
        v, rows, _ = int8_scan.int8_topk_plain(corpus, sumsq, valid, q, k=k,
                                               distance=distance, scale=scale)
    else:
        v, rows, _ = scoring.streaming_topk(corpus, sumsq, valid, q, k=k, distance=distance,
                                            chunk_rows=64)
    return v.numpy(), snap.group_ids[rows.numpy()]


@pytest.mark.parametrize("kind", ["1d", "2x4"])
@pytest.mark.parametrize("rows_per_item,use_quant,distance", [
    (1, True, "cosine"), (1, True, "l2"), (1, False, "l2"), (3, False, "cosine"),
])
def test_search_equals_the_reference_and_one_device(kind, rows_per_item, use_quant, distance,
                                                     monkeypatch):
    port, ref, vecs = make_pair(rows_per_item=rows_per_item, seed=4, drop=(1003, 1077))
    snap, rsnap = port.snapshot("clip"), ref.snapshot("clip")
    mesh, rmesh = meshes(kind)
    q = np.random.default_rng(5).normal(size=(5, 32)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q_in = codec.compute_query_quant(q, snap.scale) if use_quant else q
    if use_quant:
        np.testing.assert_array_equal(q_in, ref_codec.compute_query_quant(q, rsnap.scale))
    calls = []
    real = int8_scan.int8_topk
    monkeypatch.setattr(int8_scan, "int8_topk", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    sp = sharded.build_sharded(snap, mesh, use_quant=use_quant, chunk_rows=CHUNK)
    dist, slots, valid, grouped = sharded.sharded_search(sp, q_in, k=10, distance=distance)
    # One-row int8 spaces take B1 on every shard (its plain version here).
    assert len(calls) == (mesh.size if use_quant and rows_per_item == 1 else 0)
    assert grouped == (rows_per_item > 1)
    rsp = ref_sharded.build_sharded(rsnap, rmesh, use_quant=use_quant, chunk_rows=CHUNK)
    rdist, rslots, rvalid, rgrouped = ref_sharded.sharded_search(rsp, q_in, k=10,
                                                                 distance=distance)
    assert rgrouped == grouped
    got_slots = sp.item_ids[slots.numpy()]
    assert exact.topk_agree(dist.numpy(), got_slots, np.asarray(rdist),
                            rsp.item_ids[np.asarray(rslots)], atol=1e-6)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(rvalid))
    # The port's one-device result: ids exact, distances within 1e-6.
    qt = torch.from_numpy(np.ascontiguousarray(q_in))
    one_v, one_slots = one_device(snap, qt, k=10, distance=distance, use_quant=use_quant,
                                  grouped=grouped)
    np.testing.assert_array_equal(got_slots, one_slots)
    np.testing.assert_allclose(dist.numpy(), one_v, atol=1e-6, rtol=0)


def unpack(space, d, v, c, num_groups):
    """Packed global slots → snapshot group slots."""
    d, v, c = (np.asarray(x) for x in (d, v, c))
    out = (np.full((d.shape[0], num_groups), np.inf, np.float32),
           np.zeros((d.shape[0], num_groups), bool), np.zeros((d.shape[0], num_groups), np.float32))
    sel = space.item_ids >= 0
    for o, x in zip(out, (d, v, c)):
        o[:, space.item_ids[sel]] = x[:, sel]
    return out


@pytest.mark.parametrize("kind,aggregation,weighted,override", [
    ("1d", "min", False, False), ("1d", "avg", False, False), ("1d", "max", False, False),
    ("1d", "min", True, False), ("1d", "avg", False, True), ("2x4", "avg", False, False),
    ("2x4", "min", True, True),
])
def test_grouped_scores_equal_the_reference_and_one_device(kind, aggregation, weighted,
                                                            override):
    port, ref, _ = make_pair(n=120, rows_per_item=3, seed=24, drop=(1005,))
    snap, rsnap = port.snapshot("clip"), ref.snapshot("clip")
    mesh, rmesh = meshes(kind)
    q = np.random.default_rng(25).normal(size=(5, 32)).astype(np.float32)
    rng = np.random.default_rng(26)
    row_weights = rng.uniform(0.1, 1.0, size=snap.capacity).astype(np.float32)
    row_mask = snap.row_valid & (rng.uniform(size=snap.capacity) > 0.3)
    sp = sharded.build_sharded(snap, mesh, chunk_rows=CHUNK)
    rsp = ref_sharded.build_sharded(rsnap, rmesh, chunk_rows=CHUNK)
    np.testing.assert_array_equal(sp.row_perm, rsp.row_perm)
    extra = {}
    if override:
        packed_valid = np.zeros(sp.row_perm.shape, bool)
        sel = sp.row_perm >= 0
        packed_valid[sel] = row_mask[sp.row_perm[sel]]
        extra["row_valid"] = packed_valid
    if weighted:
        packed_w = np.ones(sp.row_perm.shape, np.float32)
        sel = sp.row_perm >= 0
        packed_w[sel] = row_weights[sp.row_perm[sel]]
        extra["weights"] = packed_w
    kw = dict(distance="cosine", aggregation=aggregation, weighted=weighted, **extra)
    got = unpack(sp, *sharded.sharded_grouped_scores(sp, q, **kw), snap.num_groups)
    want = unpack(rsp, *ref_sharded.sharded_grouped_scores(rsp, q, **kw), snap.num_groups)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], atol=1e-6, rtol=0)
    np.testing.assert_allclose(got[2], want[2], atol=1e-6, rtol=0)
    # The port's one-device surface: validity exact; MIN and MAX exact, the
    # averages within 1e-6.
    corpus = torch.from_numpy(snap.vectors)
    one = scoring.grouped_scores(
        corpus, scoring.row_sumsq_chunked(corpus),
        torch.from_numpy(row_mask if override else snap.row_valid),
        torch.from_numpy(snap.group_ids), torch.from_numpy(q), num_groups=snap.num_groups,
        distance="cosine", aggregation=aggregation, chunk_rows=64, weighted=weighted,
        weights=torch.from_numpy(row_weights if weighted else snap.weights))
    one = tuple(t.numpy() for t in one)
    np.testing.assert_array_equal(got[1], one[1])
    if aggregation in ("min", "max") and not weighted:
        np.testing.assert_array_equal(got[0], one[0])
        np.testing.assert_array_equal(got[2], one[2])
    else:
        np.testing.assert_allclose(got[0], one[0], atol=1e-6, rtol=0)
        np.testing.assert_allclose(got[2], one[2], atol=1e-6, rtol=0)


def test_more_queries_than_replicas_divide():
    port, _, vecs = make_pair(n=64, seed=23)
    sp = sharded.build_sharded(port.snapshot("clip"), meshlib.serving_mesh(2), chunk_rows=CHUNK)
    d, i, v, _ = sharded.sharded_search(sp, vecs[:3], k=5)
    assert tuple(d.shape) == (3, 5)
    np.testing.assert_array_equal(sp.item_ids[i.numpy()[:, 0]], np.arange(3))


def test_b1_past_its_k_takes_the_streaming_scan(monkeypatch):
    port, _, vecs = make_pair(n=240, seed=8)
    snap = port.snapshot("clip")
    sp = sharded.build_sharded(snap, meshlib.index_mesh(), use_quant=True, chunk_rows=CHUNK)
    assert sp.rows_per_shard == 32 and not sharded.b1_takes(sp, 40) and sharded.b1_takes(sp, 32)
    monkeypatch.setattr(int8_scan, "int8_topk", None)  # would raise if called
    q = codec.compute_query_quant(vecs[:2], snap.scale)
    d, i, v, _ = sharded.sharded_search(sp, q, k=40)
    one_v, one_slots = one_device(snap, torch.from_numpy(q), k=40, distance="cosine",
                                  use_quant=True, grouped=False)
    np.testing.assert_array_equal(sp.item_ids[i.numpy()], one_slots)


# --- meshes and the runtime (tests/test_multihost_wiring.py's cases) -------


def test_devices_never_fall_back_to_the_cpu(monkeypatch):
    meshlib.set_devices(None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert meshlib.devices() == []
    assert meshlib.num_shards(meshlib.index_mesh()) == 0
    meshlib.set_devices(["cpu"] * 4)
    assert meshlib.devices() == [torch.device("cpu")] * 4
    assert meshlib.num_shards(meshlib.index_mesh()) == meshlib.serving_shards() == 4


def test_only_an_installed_mesh_shards(monkeypatch):
    # Every CUDA device of the process is the mesh's default, but an
    # executor shards only over devices someone installed: a host with two
    # cards serves from its executor's own device unless asked.
    meshlib.set_devices(None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert meshlib.devices() == [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert meshlib.num_shards(meshlib.index_mesh()) == 2
    assert meshlib.serving_shards() == 1
    monkeypatch.setattr(multihost, "process_count", lambda: 2)
    assert meshlib.serving_shards() == 1
    meshlib.set_devices(["cuda:1"])
    assert meshlib.serving_shards() == 1
    meshlib.set_devices(["cuda:0", "cuda:1"])
    assert meshlib.serving_shards() == 2


def test_initialize_is_a_no_op_without_a_coordinator(monkeypatch):
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    assert multihost.initialize() is False
    assert multihost.process_count() == 1 and multihost.process_index() == 0
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(ValueError, match="process count"):
        multihost.initialize("127.0.0.1:1")


def test_single_process_is_1d():
    mesh = meshlib.index_mesh()
    assert mesh.axis_names == (meshlib.SHARD_AXIS,)
    assert mesh.size == len(meshlib.devices()) == 8 and mesh.processes is None


@pytest.mark.parametrize("layout", ["replica", "shard"])
def test_multiprocess_layouts(monkeypatch, layout):
    monkeypatch.setattr(multihost, "process_count", lambda: 2)
    meshlib.set_multihost_layout(layout)
    mesh = meshlib.index_mesh()
    if layout == "replica":
        assert mesh.axis_names == (meshlib.REPLICA_AXIS, meshlib.SHARD_AXIS)
        assert mesh.shape == {"replica": 2, "shard": 8}
        np.testing.assert_array_equal(mesh.processes, [[0] * 8, [1] * 8])
    else:
        assert mesh.axis_names == (meshlib.SHARD_AXIS,)
        assert mesh.size == 16 and list(mesh.processes) == [0] * 8 + [1] * 8


def test_invalid_layout_rejected():
    with pytest.raises(ValueError):
        meshlib.set_multihost_layout("diagonal")


def test_meshes_match_the_reference_s_shapes():
    for got, want in ((meshlib.index_mesh(), ref_mesh.index_mesh()),
                      (meshlib.serving_mesh(4), ref_mesh.serving_mesh(4))):
        assert got.axis_names == want.axis_names
        assert got.shape == dict(want.shape) and got.size == want.size
    with pytest.raises(ValueError):
        meshlib.serving_mesh(3)
