"""The port's PQL executor (``pql/executor.py`` with ``pql/fused.py``) on the
CPU, against the JAX package's ``Executor`` and against the independent
oracle of ``tools/pql_equivalence.py``.

``pql_equivalence.seed_db`` seeds one DB with the JAX package's writer; the
port gets only port objects over the same files: its own ``Database`` on
them and its own ``VectorIndex`` filled with the same rows. Every shape
``build_shapes`` gives must show zero divergence from the tool's oracle
(the checks of its ``main``), and the page must equal the reference
executor's: ids, order and counts equal, selected score values within 1e-6.
Values may differ by ulps: XLA on the CPU rewrites the cosine epilogue's
``d / sqrt(x)`` into ``d * rsqrt(x)``, which is not correctly rounded; the
port rounds every step correctly and matches the oracle's NumPy epilogue
instead. The JAX executor runs here on the 8 virtual CPU devices of
``tests/conftest.py``, so it takes its sharded path; the port's executor
takes its one device (also where the process sees two CUDA devices but
installed no mesh), and again its sharded path on 8 logical CPU shards
(``meshlib.set_devices([cpu] * 8)``), whose pages must be the JAX
executor's too. The fused path must equal the full-readback path, and
coalesced concurrent queries their solo runs."""

import json
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))

import pql_equivalence as pe  # noqa: E402
import pql_fuzz  # noqa: E402

from chip_smoke import same_pages  # noqa: E402

from panoptikon_tpu.pql import model as ref_pql  # noqa: E402
from panoptikon_tpu.pql.executor import Executor as RefExecutor  # noqa: E402
from panoptikon_tpu_torch.db.connection import Database  # noqa: E402
from panoptikon_tpu_torch.index import VectorIndex  # noqa: E402
from panoptikon_tpu_torch.parallel import mesh as meshlib  # noqa: E402
from panoptikon_tpu_torch.pql import model as pql  # noqa: E402
from panoptikon_tpu_torch.pql.executor import Executor  # noqa: E402

N_ITEMS, N_SHAPES = 300, 68


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pql"))
    rng = np.random.default_rng(0)
    db, writer, index, rows, spaces, board_id = pe.seed_db(root, N_ITEMS, rng)
    port_index = VectorIndex(chunk_rows=64)
    for space, sp in spaces.items():
        port_index.add(space, sp.item_ids, sp.data_ids, sp.vecs)
        assert port_index.build_quant(space) == sp.scale
    port_db = Database(root, "diff")
    full = Executor(port_db, port_index, device="cpu")
    full.enable_fused = False
    solo = Executor(port_db, port_index, device="cpu")
    solo.enable_coalesce = False
    yield SimpleNamespace(
        db=db, spaces=spaces, rows=rows,
        shapes=pe.build_shapes(db, rows, spaces, board_id, rng),
        ref=RefExecutor(db, index), port=Executor(port_db, port_index, device="cpu"),
        sharded=Executor(port_db, port_index, device="cpu"),
        full=full, solo=solo, results={},
    )
    writer.close()


def _payload(obj) -> dict:
    return json.loads(json.dumps(obj))


def _run(ex, payload, model=pql):
    return ex.execute(model.PqlQuery.from_json(_payload(payload)))


def _oracle_problems(shape, res) -> list:
    """``pql_equivalence.main``'s checks of one shape's result."""
    want = shape["oracle"]()
    problems = []
    if shape["mode"] == "member-text":
        got = {(r["file_id"], r["data_id"]) for r in res.results}
        if got != want:
            problems.append(("membership", sorted(want - got)[:5], sorted(got - want)[:5]))
    elif shape["mode"] == "order":
        got, want_l = [r["file_id"] for r in res.results], list(want)
        if got[:50] != want_l[:50] or sorted(got) != sorted(want_l):
            problems.append(("order", got[:10], want_l[:10]))
    elif {r["file_id"] for r in res.results} != set(want):
        problems.append(("membership", len(res.results), len(want)))
    want_count = shape["count_override"]
    if want_count is None:
        want_count = len(want)
    if res.count is not None and res.count != want_count:
        problems.append(("count", res.count, want_count))
    if shape["extra_check"] and res.results:
        ok = shape["extra_check"](res)
        if ok is not True:
            problems.append(("extra_check", ok))
    return problems


def test_build_shapes_gives_every_shape(world):
    assert len(world.shapes) == N_SHAPES


@pytest.mark.parametrize("i", range(N_SHAPES))
def test_shape_matches_oracle_reference_and_full_path(world, i):
    shape = world.shapes[i]
    got = _run(world.port, shape["payload"])
    world.results[shape["name"]] = got
    assert _oracle_problems(shape, got) == [], shape["name"]
    assert same_pages(got, _run(world.ref, shape["payload"], ref_pql))
    full = _run(world.full, shape["payload"])
    assert full.count == got.count and full.results == got.results, shape["name"]


@pytest.fixture
def eight_shards(world, monkeypatch):
    """The port's executor on a mesh of 8 logical CPU shards; its one-shard
    path raises."""
    def one_shard(*a, **kw):
        raise AssertionError("an 8-shard mesh took the one-shard path")

    monkeypatch.setattr(world.sharded, "_device_arrays", one_shard)
    meshlib.set_devices([torch.device("cpu")] * 8)
    yield world.sharded
    meshlib.set_devices(None)


@pytest.mark.parametrize("i", range(N_SHAPES))
def test_sharded_shape_matches_the_reference_and_one_device(world, eight_shards, i):
    shape = world.shapes[i]
    got = _run(eight_shards, shape["payload"])
    assert _oracle_problems(shape, got) == [], shape["name"]
    assert same_pages(got, _run(world.ref, shape["payload"], ref_pql))
    assert same_pages(got, world.results.get(shape["name"]) or _run(world.solo, shape["payload"]))


@pytest.fixture
def two_cards(world, monkeypatch):
    """A process that sees two CUDA devices and installed no mesh: the
    port's CPU executor keeps to its one device; its sharded path raises."""
    def sharded(*a, **kw):
        raise AssertionError("an executor with no installed mesh took the sharded path")

    meshlib.set_devices(None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(world.solo, "_sharded_space", sharded)
    assert len(meshlib.devices()) == 2
    return world.solo


@pytest.mark.parametrize("i", range(N_SHAPES))
def test_two_card_host_keeps_the_executor_s_device(world, two_cards, i):
    shape = world.shapes[i]
    got = _run(two_cards, shape["payload"])
    assert _oracle_problems(shape, got) == [], shape["name"]
    assert same_pages(got, _run(world.ref, shape["payload"], ref_pql))


def test_exact_and_quant_arms_keep_membership(world):
    # pql_equivalence.main: identical membership across the exact and quant
    # arms of every paired semantic shape.
    arms: dict[str, dict] = {}
    for shape in world.shapes:
        root = shape["name"].rsplit("-", 1)
        if len(root) == 2 and root[1] in ("exact", "quant") and not shape["skip_arm_pair"]:
            res = world.results.get(shape["name"]) or _run(world.port, shape["payload"])
            arms.setdefault(root[0], {})[root[1]] = sorted(r["file_id"] for r in res.results)
    pairs = [a for a in arms.values() if len(a) == 2]
    assert len(pairs) > 10
    for a in pairs:
        assert a["exact"] == a["quant"]


def _b64(v):
    return pe.b64(np.asarray(v, np.float32))


def _concurrent(ex, payloads):
    """Run ``payloads`` in one thread each, with the coalescer's first
    drain held until every query is pending, so that they are served as one
    batch; returns the results in order and the coalescer's stats."""
    co = ex._scan_coalescer
    drain = co._drain

    def gated(key, rounds_budget=None):
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            with co._lock:
                if len(co._pending.get(key, ())) >= len(payloads):
                    break
            time.sleep(0.002)
        return drain(key, rounds_budget)

    co._drain = gated
    out = [None] * len(payloads)

    def one(j):
        out[j] = _run(ex, payloads[j])

    threads = [threading.Thread(target=one, args=(j,)) for j in range(len(payloads))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        co._drain = drain
    return out, co.stats()


@pytest.mark.parametrize("kind", ["single", "rrf3", "scoped"])
def test_coalesced_queries_equal_their_solo_runs(world, kind):
    _coalesced_equal_solo(world, world.port, kind)


@pytest.mark.parametrize("kind", ["single", "rrf3", "scoped"])
def test_sharded_coalesced_queries_equal_their_solo_runs(world, eight_shards, kind):
    # The coalesced surfaces and joins in packed slots, against the
    # one-device solo runs.
    _coalesced_equal_solo(world, eight_shards, kind)


def _coalesced_equal_solo(world, ex, kind):
    rng = np.random.default_rng({"single": 1, "rrf3": 2, "scoped": 3}[kind])
    clip, st = world.spaces["clip/test"], world.spaces["st/test"]

    def leaf(field, space, sp, extra=None):
        v = sp.vecs[int(rng.integers(len(sp.vecs)))] + rng.normal(scale=0.05, size=sp.vecs.shape[1])
        node = {field: {"query": _b64(v), "model": space, "embed": None, "index": "quant"}}
        return {**node, **(extra or {})}

    payloads = []
    for _ in range(8):
        if kind == "single":
            q = leaf("image_embeddings", "clip/test", clip)
        elif kind == "rrf3":
            rrf = {"row_n": True, "priority": 5}
            q = {"or_": [
                leaf("image_embeddings", "clip/test", clip, {**rrf, "rrf": {"k": 60, "weight": 1.0}}),
                leaf("image_embeddings", "clip/test", clip, {**rrf, "rrf": {"k": 30, "weight": 0.8}}),
                leaf("text_embeddings", "st/test", st, {**rrf, "rrf": {"k": 60, "weight": 0.6}}),
            ]}
        else:
            q = {"and_": [{"match": {"eq": {"type": "image/png"}}},
                          leaf("image_embeddings", "clip/test", clip)]}
        payloads.append({"query": q, "page_size": 12})
    before = ex._scan_coalescer.stats()
    got, after = _concurrent(ex, payloads)
    queries = after["queries"] - before["queries"]
    assert queries >= len(payloads) and after["dispatches"] - before["dispatches"] < queries
    for res, payload in zip(got, payloads):
        want = _run(world.solo, payload)
        assert res.count == want.count and res.results == want.results
        assert len(res.results) == 12


def test_fuzzed_trees_match_set_oracle_and_reference(world):
    # A few of tools/pql_fuzz.py's seeded AND/OR/NOT trees over its
    # primitives, and semantic leaves under them, through the port.
    rng = np.random.default_rng(3)
    prims, all_fids = pql_fuzz.build_primitives(world.db, world.db.reader(), rng)
    for _ in range(12):
        tree, want = pql_fuzz.gen_tree(prims, all_fids, rng, depth=3)
        payload = {"query": tree, "page_size": 10_000, "check_path": False}
        res = _run(world.port, payload)
        assert {r["file_id"] for r in res.results} == want and res.count == len(want)
        assert same_pages(res, _run(world.ref, payload, ref_pql))
    for j in range(6):
        tree, _ = pql_fuzz.gen_tree(prims, all_fids, rng, depth=2)
        field, space = [("image_embeddings", "clip/test"), ("text_embeddings", "st/test")][j % 2]
        sp = world.spaces[space]
        payload = {"query": {"and_": [tree, {field: {
            "query": _b64(sp.vecs[int(rng.integers(len(sp.vecs)))]), "model": space, "embed": None,
            "index": "quant" if j % 2 == 0 else "exact",
            "distance_aggregation": ["MIN", "AVG", "MAX"][j % 3]}}]},
            "page_size": 10_000, "check_path": False}
        assert same_pages(_run(world.port, payload), _run(world.ref, payload, ref_pql))


def test_executor_asks_for_its_device(world, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Executor(world.port.db, world.port.index)
    assert world.port.device == torch.device("cpu")


def synth_bert(cfg, layers, seed=4):
    """A BERT-layout state dict (tests/test_weights.py's recipe) with random
    LayerNorm affines, so that every leaf of the mapping is exercised."""
    rng = np.random.default_rng(seed)
    w = cfg.width

    def ln(prefix):
        sd[f"{prefix}.weight"] = (1 + 0.1 * rng.normal(size=w)).astype(np.float32)
        sd[f"{prefix}.bias"] = (0.1 * rng.normal(size=w)).astype(np.float32)

    sd = {
        "embeddings.word_embeddings.weight": rng.normal(size=(cfg.vocab, w)).astype(np.float32) * 0.02,
        "embeddings.position_embeddings.weight": rng.normal(size=(cfg.ctx, w)).astype(np.float32) * 0.02,
        "embeddings.token_type_embeddings.weight": rng.normal(size=(2, w)).astype(np.float32) * 0.02,
    }
    ln("embeddings.LayerNorm")
    for i in range(layers):
        p = f"encoder.layer.{i}"
        for name, (ci, co) in {
            "attention.self.query": (w, w), "attention.self.key": (w, w),
            "attention.self.value": (w, w), "attention.output.dense": (w, w),
            "intermediate.dense": (w, 4 * w), "output.dense": (4 * w, w),
        }.items():
            sd[f"{p}.{name}.weight"] = rng.normal(size=(co, ci)).astype(np.float32) * ci**-0.5
            sd[f"{p}.{name}.bias"] = rng.normal(size=co).astype(np.float32) * 0.02
        ln(f"{p}.attention.output.LayerNorm")
        ln(f"{p}.output.LayerNorm")
    return sd


def save_bert(sd, path):
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, str(path))
    return path


def test_hybrid_fts_and_text_query_through_the_manager(world, tmp_path):
    # BASELINE #4's shape (tools/e2e_server_bench.py's hybrid_payload): an
    # AND of a match_text RRF leaf and a text_embeddings RRF leaf whose query
    # is a text, which preprocess embeds through the port's model manager
    # and TextEmbedImpl on the CPU. Both impls load one checkpoint: the
    # vector is held to the JAX impl's within the text encoder's tolerance,
    # and the page the port serves to the one the JAX executor serves when
    # both are handed that same vector.
    from panoptikon_tpu.models import impls as ref_impls
    from panoptikon_tpu.models import text_embed as ref_text
    from panoptikon_tpu_torch.models.impls import IMPL_INDEX, PredictionInput
    from panoptikon_tpu_torch.models.manager import ModelManager
    from panoptikon_tpu_torch.models.registry import Registry
    from panoptikon_tpu_torch.pql import preprocess
    from panoptikon_tpu_torch.utils import npy

    ckpt = save_bert(synth_bert(ref_text.CONFIGS["test-tiny"], 2, seed=12), tmp_path / "st.bin")
    (tmp_path / "registry").mkdir()
    (tmp_path / "registry" / "00.toml").write_text(
        '[group.st]\nconfig.impl_class = "sentence_transformers"\n'
        '[group.st.inference_ids.test]\nconfig.model_arch = "test-tiny"\n'
        f'config.device = "cpu"\nconfig.checkpoint = "{ckpt}"\n')
    manager = ModelManager(Registry(tmp_path / "registry"), IMPL_INDEX)
    ex = Executor(world.port.db, world.port.index, manager=manager, device="cpu")

    def payload(query, embed):
        return {"query": {"and_": [
            {"match_text": {"match": '"gamma"'}, "order_by": True, "row_n": True, "priority": 5,
             "rrf": {"k": 60, "weight": 1.0}},
            {"text_embeddings": {"query": query, "model": "st/test", "embed": embed,
                                 "index": "quant"},
             "row_n": True, "priority": 5, "rrf": {"k": 60, "weight": 0.5}}]}, "page_size": 10}

    text = "gamma delta epsilon token0004c0"
    preprocess.EMBED_CACHE.clear()
    try:
        query = pql.PqlQuery.from_json(_payload(payload(text, {"cache_key": "hybrid"})))
        res = ex.execute(query)
    finally:
        manager.shutdown()
    vec = query.query.and_[1].text_embeddings._embedding
    want = npy.parse_npy_embedding(ref_impls.TextEmbedImpl("test-tiny", checkpoint=str(ckpt)).predict(
        [PredictionInput(data={"text": text, "task": "s2s"})])[0])
    assert vec.shape == want.shape == (32,) and np.isfinite(vec).all()
    assert float(vec @ want / (np.linalg.norm(vec) * np.linalg.norm(want))) >= 0.999
    assert np.abs(vec - want).max() <= 2e-2 * np.abs(want).max()
    given = payload(_b64(vec), None)
    port = _run(world.port, given)
    assert len(res.results) > 0 and res.count == port.count and res.results == port.results
    assert same_pages(port, _run(world.ref, given, ref_pql))
