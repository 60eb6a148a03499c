"""The build path on the port (``jobs/``) against the JAX package's, on the
same seeded inputs and one checkpoint loaded by both registries:

- the image build: PNG fixtures scanned by each package's ``rescan_folders``,
  ``run_extraction_job`` with ``clip`` at ``test-tiny`` (with the
  ``decoded_image`` handler and with none), the finishing reconcile; items,
  files and item_data equal, embeddings at cosine ≥ 0.999, snapshots equal
  in row ids, item ids and weights, coverage ``ready`` on both sides;
- the text chain (``test_text_embedding_chain``'s scenario, item and data
  ids apart) with ``TextEmbedImpl("test-tiny")``, a window holding
  multi-chunk texts: the JAX impl pads all of a call's chunks as one batch
  and raises ``IndexError`` past the top bucket (ROADMAP §C), so the JAX job
  falls back to one predict per input and skips the text longer than the
  top bucket as ``transient``. That is the reference's fault, asserted as
  such; the port gives every item its rows;
- an OCR build: PNG pages of rendered digits through ``OcrImpl`` with one
  checkpoint trained by the reference's recipe (``test_torch_ocr.trained``):
  equal item_data and extracted_text rows, the blank page a placeholder;
- the quant reconcile bit for bit: a DB built by the JAX package, copied,
  reconciled and synced by the port (codes, artifact bytes and revision
  equal), through the frozen-artifact path (at least
  ``ARTIFACT_MIN_VECTORS`` rows, then new rows under the frozen scale) and
  ``force_rescale``.

The port's impls run on the CPU here (``config.device = "cpu"``), where the
kernels' plain versions stand in."""

import shutil
import types

import jax
import numpy as np
import pytest
import torch

from panoptikon_tpu.db import store as ref_store
from panoptikon_tpu.db.connection import Database as RefDatabase
from panoptikon_tpu.db.writer import IndexWriter as RefWriter
from panoptikon_tpu.index.vector_index import VectorIndex as RefIndex
from panoptikon_tpu.jobs import extraction as ref_extraction
from panoptikon_tpu.jobs import index_sync as ref_index_sync
from panoptikon_tpu.jobs import reconcile as ref_reconcile
from panoptikon_tpu.jobs import scan as ref_scan
from panoptikon_tpu.models import clip as ref_clip
from panoptikon_tpu.models import impls as ref_impls
from panoptikon_tpu.models import text_embed as ref_text
from panoptikon_tpu.models import weights as ref_weights
from panoptikon_tpu.models.manager import ModelManager as RefManager
from panoptikon_tpu.models.registry import Registry as RefRegistry
from panoptikon_tpu_torch.db import store
from panoptikon_tpu_torch.db.connection import Database
from panoptikon_tpu_torch.db.writer import IndexWriter
from panoptikon_tpu_torch.index import VectorIndex
from panoptikon_tpu_torch.jobs import extraction, index_sync, reconcile, scan
from panoptikon_tpu_torch.models import impls
from panoptikon_tpu_torch.models.manager import ModelManager
from panoptikon_tpu_torch.models.registry import Registry
from panoptikon_tpu_torch.ops import codec

REF = types.SimpleNamespace(
    name="ref", store=ref_store, Database=RefDatabase, Writer=RefWriter, Index=RefIndex,
    extraction=ref_extraction, reconcile=ref_reconcile, index_sync=ref_index_sync, scan=ref_scan,
    Manager=RefManager, Registry=RefRegistry, impls=ref_impls, device="")
PORT = types.SimpleNamespace(
    name="port", store=store, Database=Database, Writer=IndexWriter, Index=VectorIndex,
    extraction=extraction, reconcile=reconcile, index_sync=index_sync, scan=scan,
    Manager=ModelManager, Registry=Registry, impls=impls, device='config.device = "cpu"')

REG_TOML = """
[group.clip]
config.impl_class = "clip"
config.model_arch = "test-tiny"
config.checkpoint = "{clip}"
{device}
[group.clip.metadata]
output_type = "clip"
input_mime_types = ["image/"]
[group.clip.inference_ids.tiny]

[group.textembed]
config.impl_class = "sentence_transformers"
config.model_arch = "test-tiny"
config.checkpoint = "{bert}"
config.batch_cap = 4
config.combine_threshold = 4
{device}
[group.textembed.metadata]
default_batch_size = 4
target_entities = ["text"]
output_type = "text-embedding"
[group.textembed.inference_ids.tiny-te]
"""
NOW = "2026-01-01T00:00:00+00:00"


def bert_state_dict(cfg, seed=9):
    """A BERT-layout state dict (tests/test_weights.py's recipe) with random
    LayerNorm affines."""
    rng = np.random.default_rng(seed)
    w = cfg.width
    sd = {
        "embeddings.word_embeddings.weight": rng.normal(size=(cfg.vocab, w)) * 0.02,
        "embeddings.position_embeddings.weight": rng.normal(size=(cfg.ctx, w)) * 0.02,
        "embeddings.token_type_embeddings.weight": rng.normal(size=(2, w)) * 0.02,
    }
    lns = ["embeddings.LayerNorm"]
    for i in range(cfg.layers):
        p = f"encoder.layer.{i}"
        for name, (ci, co) in {
            "attention.self.query": (w, w), "attention.self.key": (w, w),
            "attention.self.value": (w, w), "attention.output.dense": (w, w),
            "intermediate.dense": (w, 4 * w), "output.dense": (4 * w, w),
        }.items():
            sd[f"{p}.{name}.weight"] = rng.normal(size=(co, ci)) * ci**-0.5
            sd[f"{p}.{name}.bias"] = rng.normal(size=co) * 0.02
        lns += [f"{p}.attention.output.LayerNorm", f"{p}.output.LayerNorm"]
    for name in lns:
        sd[f"{name}.weight"] = 1 + 0.1 * rng.normal(size=w)
        sd[f"{name}.bias"] = 0.1 * rng.normal(size=w)
    return {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in sd.items()}


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt")
    cfg = ref_clip.CONFIGS["test-tiny"]
    tree = jax.tree.map(np.asarray, ref_clip.init_params(jax.random.key(7), cfg))
    ref_weights.save_clip_checkpoint(tree, cfg, root / "clip.bin")
    tcfg = ref_text.CONFIGS["test-tiny"]
    torch.save(bert_state_dict(tcfg), str(root / "bert.bin"))
    return {"clip": str(root / "clip.bin"), "bert": str(root / "bert.bin")}


def make_png(path, color, size=(40, 40)):
    from PIL import Image

    Image.new("RGB", size, color).save(path)


@pytest.fixture
def media(tmp_path):
    root = tmp_path / "media"
    (root / "sub").mkdir(parents=True)
    make_png(root / "red.png", (255, 0, 0))
    make_png(root / "green.png", (0, 255, 0), size=(64, 40))
    make_png(root / "sub" / "blue.png", (0, 0, 255))
    for i in range(5):
        make_png(root / f"extra{i}.png", (i * 50 % 255, 40, 90), size=(40 + 8 * i, 40))
    (root / "notes.txt").write_text("not an image")
    (root / ".hidden.png").write_text("skip me")
    return root


def open_side(side, root, checkpoints, monkeypatch):
    """One package's DB, writer, index and manager over a registry that
    loads the shared checkpoints."""
    monkeypatch.setattr(side.store, "now_iso", lambda: NOW)
    reg = root / f"registry-{side.name}"
    reg.mkdir(parents=True)
    (reg / "00.toml").write_text(REG_TOML.format(device=side.device, **checkpoints))
    db = side.Database(root / f"data-{side.name}", "jobs")
    return types.SimpleNamespace(
        side=side, db=db, writer=side.Writer(db), index=side.Index(chunk_rows=64),
        manager=side.Manager(side.Registry(reg), side.impls.IMPL_INDEX))


def close_side(env):
    env.manager.shutdown()
    env.writer.close()


def tables(db, names=("items", "files", "item_data", "setters", "extraction_errors")):
    conn = db.reader()
    return {t: conn.execute(f"SELECT * FROM {t} ORDER BY 1").fetchall() for t in names}


def embeddings(db, setter):
    rows = db.reader().execute(
        """SELECT d.item_id, d.idx, e.embedding FROM embeddings e JOIN item_data d ON d.id = e.id
           JOIN setters s ON s.id = d.setter_id WHERE s.name = ? ORDER BY d.id""",
        (setter,)).fetchall()
    return {(r[0], r[1]): np.frombuffer(r[2], np.float32) for r in rows}


def same_embeddings(got, want):
    assert got.keys() == want.keys() and got
    for key in got:
        g, w = got[key], want[key]
        assert g.shape == w.shape
        assert float(g @ w / (np.linalg.norm(g) * np.linalg.norm(w))) >= 0.999, key


def same_snapshots(got, want, codes=False):
    assert (got.size, got.num_groups, got.dim) == (want.size, want.num_groups, want.dim)
    n = got.size
    np.testing.assert_array_equal(got.row_ids[:n], want.row_ids[:n])
    np.testing.assert_array_equal(got.group_ids[:n], want.group_ids[:n])
    np.testing.assert_array_equal(got.weights[:n], want.weights[:n])
    assert got.quant_ready and want.quant_ready
    if codes:
        assert got.scale == want.scale
        np.testing.assert_array_equal(got.codes[:n], want.codes[:n])


@pytest.mark.parametrize("handler", ["decoded_image", None])
def test_image_build_matches_the_reference(tmp_path, media, checkpoints, monkeypatch, handler):
    built = {}
    for side in (REF, PORT):
        env = open_side(side, tmp_path, checkpoints, monkeypatch)
        try:
            env.writer.call(lambda c: side.store.add_folder(c, str(media)))
            counters = side.scan.rescan_folders(env.db, env.writer)
            assert counters.new_files == 9  # 8 images, 1 text file; the hidden one skipped
            report = side.extraction.run_extraction_job(
                db=env.db, writer=env.writer, index=env.index, manager=env.manager,
                inference_id="clip/tiny", output_type="clip", batch_size=3,
                input_handler=handler, input_handler_opts={"size": 32}, loader_concurrency=2)
            assert (report.processed, report.input_errors, report.transient_errors) == (8, 0, 0)
            built[side.name] = (tables(env.db), embeddings(env.db, "clip/tiny"),
                                env.index.snapshot("clip/tiny"),
                                side.reconcile.coverage_status(env.db), _reconcile_state(env.db))
        finally:
            close_side(env)
    (got_t, got_e, got_s, got_c, _), (want_t, want_e, want_s, want_c, want_q) = \
        built["port"], built["ref"]
    for name in ("items", "files", "item_data", "setters", "extraction_errors"):
        assert got_t[name] == want_t[name], name
    assert len(got_t["items"]) == 9 and len(got_e) == 8
    same_embeddings(got_e, want_e)
    same_snapshots(got_s, want_s)
    assert got_c == want_c and got_c[0]["state"] == "ready" and got_c[0]["artifact_rev"] == 1
    # The DB the JAX job built, copied, synced and reconciled by the port:
    # the reference's codes, artifact and revision.
    shutil.copytree(tmp_path / "data-ref", tmp_path / "copy")
    db = Database(tmp_path / "copy", "jobs")
    writer, index = IndexWriter(db), VectorIndex(chunk_rows=64)
    try:
        assert index_sync.sync_all(db, index) == {"clip/tiny": 8}
        assert reconcile.run_reconcile(db, writer, index).ready == ["clip/tiny"]
        same_snapshots(index.snapshot("clip/tiny"), want_s, codes=True)
        assert _reconcile_state(db) == want_q
    finally:
        writer.close()


def _add_texts(side, lengths):
    """test_text_embedding_chain's scenario: OCR text rows on the scanned
    images, with item_data ids pushed apart from the item ids."""
    words = np.random.default_rng(21)

    def unit(conn):
        sid = side.store.upsert_setter(conn, "ocr")
        pad = side.store.upsert_setter(conn, "pad")
        rows = conn.execute("SELECT id FROM items WHERE type='image/png' ORDER BY id").fetchall()
        for k in range(7):
            side.store.insert_item_data(conn, rows[0][0], pad, "clip", idx=k)
        for (item_id,), n in zip(rows, lengths):
            did = side.store.insert_item_data(conn, item_id, sid, "text")
            text = " ".join(f"w{int(i)}" for i in words.integers(0, 500, size=n))
            side.store.insert_extracted_text(conn, did, text, confidence=0.8,
                                             language_confidence=0.9)
        return [r[0] for r in rows[: len(lengths)]]

    return unit


def test_text_chain_gives_every_item_its_rows(tmp_path, media, checkpoints, monkeypatch):
    # test-tiny's context is 32 tokens; batch_cap 4 makes the top bucket 4
    # chunks. 20 words are one chunk, 80 three, 200 seven (and the combined
    # row at combine_threshold 4). The window of four texts holds 12 chunks.
    lengths = (20, 80, 200, 20)
    built = {}
    for side in (REF, PORT):
        env = open_side(side, tmp_path, checkpoints, monkeypatch)
        try:
            env.writer.call(lambda c: side.store.add_folder(c, str(media)))
            side.scan.rescan_folders(env.db, env.writer)
            item_ids = env.writer.call(_add_texts(side, lengths))
            data_ids = [r[0] for r in env.db.reader().execute(
                "SELECT d.id FROM item_data d JOIN setters s ON s.id = d.setter_id"
                " WHERE s.name = 'ocr' ORDER BY d.id")]
            assert not set(data_ids) & set(item_ids)
            # The job's arguments from the registry metadata, as the server's
            # extraction runner derives them.
            meta = env.manager.registry.group_metadata("textembed")
            report = side.extraction.run_extraction_job(
                db=env.db, writer=env.writer, index=env.index, manager=env.manager,
                inference_id="textembed/tiny-te", output_type=meta["output_type"],
                batch_size=int(meta["default_batch_size"]),
                target_entity="text" if "text" in meta["target_entities"] else "items",
                source_setters=("ocr",))
            # A second job: nothing left on the port; the reference retries
            # the text it skipped, fails it again, and with nothing else
            # attempted the run counts as an inference outage.
            again = dict(db=env.db, writer=env.writer, index=env.index, manager=env.manager,
                         inference_id="textembed/tiny-te", output_type="text-embedding",
                         batch_size=4, target_entity="text", source_setters=("ocr",))
            if side is REF:
                with pytest.raises(ref_extraction.SystemicExtractionFailure):
                    side.extraction.run_extraction_job(**again)
            else:
                assert side.extraction.run_extraction_job(**again).processed == 0
            rows = env.db.reader().execute(
                """SELECT d.item_id, d.idx, d.source_id FROM item_data d
                   JOIN setters s ON s.id = d.setter_id WHERE s.name = 'textembed/tiny-te'
                   ORDER BY d.id""").fetchall()
            built[side.name] = (report, item_ids, data_ids, rows,
                                embeddings(env.db, "textembed/tiny-te"),
                                env.index.snapshot("textembed/tiny-te"))
        finally:
            close_side(env)
    # The reference's fault: the window raises IndexError, the job falls back
    # to one predict per input, and the seven-chunk text exceeds the top
    # bucket alone: a transient slot, the item skipped softly.
    ref_report, items, data_ids, ref_rows, ref_emb, ref_snap = built["ref"]
    assert (ref_report.processed, ref_report.transient_errors) == (3, 1)
    with pytest.raises(IndexError):
        ref_impls.TextEmbedImpl("test-tiny", checkpoint=checkpoints["bert"], batch_cap=4,
                                combine_threshold=4).predict(
            [ref_impls.PredictionInput(data={"text": "w1 " * 200})])
    # The port gives every item its rows, owned by the item, sourced from
    # its text row, weighted by the text's confidences.
    report, items, data_ids, rows, emb, snap = built["port"]
    assert (report.processed, report.input_errors, report.transient_errors) == (4, 0, 0)
    per_item = {i: [r for r in rows if r[0] == i] for i in items}
    assert [len(per_item[i]) for i in items] == [1, 3, 8, 1]
    assert {r[2] for r in rows} == set(data_ids)
    assert snap.size == len(rows) == 13 and snap.num_groups == 4
    np.testing.assert_allclose(snap.weights[: snap.size], np.float32(0.8 * 0.9), rtol=0, atol=1e-7)
    assert sorted(set(snap.group_ids[: snap.size])) == [0, 1, 2, 3]
    # Where the reference embedded a text, the port's rows agree with it.
    assert len(ref_rows) == 5 and ref_snap.size == 5
    same_embeddings({k: v for k, v in emb.items() if k[0] != items[2]}, ref_emb)


def _seed_vectors(side, n, dim, lo=0, scale=1.0, seed=31):
    rng = np.random.default_rng(seed + lo)

    def unit(conn):
        sid = side.store.upsert_setter(conn, "st/x")
        for i in range(lo, lo + n):
            item = side.store.upsert_item(conn, f"{i:064x}", f"{i:032x}", "image/png", size=i)
            did = side.store.insert_item_data(conn, item, sid, "text-embedding")
            side.store.insert_embedding(conn, did, (rng.normal(size=dim) * scale).astype(np.float32))

    return unit


def _reconcile_state(db):
    conn = db.reader()
    return conn.execute(
        "SELECT c.state, c.artifact, c.artifact_rev, c.n_at_artifact, c.dim FROM"
        " vector_quant_coverage c").fetchall()


def test_reconcile_of_a_reference_db_is_bit_identical(tmp_path, monkeypatch):
    # A DB the JAX package built (ARTIFACT_MIN_VECTORS rows, reconciled: the
    # artifact freezes), copied; the port reconciles the copy from a fresh
    # index. Then the same new rows, larger than the frozen scale covers, on
    # both sides: quantized under the frozen scale (saturating), revision
    # kept. Then force_rescale on both: a new scale, the revision bumped.
    monkeypatch.setattr(ref_store, "now_iso", lambda: NOW)
    monkeypatch.setattr(store, "now_iso", lambda: NOW)
    n0, dim = codec.ARTIFACT_MIN_VECTORS + 24, 16
    ref_db = RefDatabase(tmp_path / "ref", "r")
    ref_writer, ref_index = RefWriter(ref_db), RefIndex(chunk_rows=256)
    ref_writer.call(_seed_vectors(REF, n0, dim))
    ref_reconcile.run_reconcile(ref_db, ref_writer, ref_index)
    frozen = _reconcile_state(ref_db)
    assert frozen[0][0] == "ready" and frozen[0][2] == 1 and frozen[0][3] == n0
    ref_writer.close()
    shutil.copytree(tmp_path / "ref", tmp_path / "port")
    ref_writer = RefWriter(ref_db)
    db = Database(tmp_path / "port", "r")
    writer, index = IndexWriter(db), VectorIndex(chunk_rows=256)
    try:
        assert index_sync.sync_all(db, index) == {"st/x": n0}
        got = reconcile.run_reconcile(db, writer, index)
        assert got.ready == ["st/x"] and _reconcile_state(db) == frozen
        same_snapshots(index.snapshot("st/x"), ref_index.snapshot("st/x"), codes=True)
        for side, (w, idx) in ((REF, (ref_writer, ref_index)), (PORT, (writer, index))):
            w.call(_seed_vectors(side, 40, dim, lo=n0, scale=3.0))
            side.reconcile.run_reconcile(side is REF and ref_db or db, w, idx)
        assert _reconcile_state(db) == _reconcile_state(ref_db) == frozen
        snap = index.snapshot("st/x")
        same_snapshots(snap, ref_index.snapshot("st/x"), codes=True)
        assert snap.size == n0 + 40 and snap.scale == codec.artifact_scale(frozen[0][1])
        assert (np.abs(snap.codes[n0:snap.size].astype(np.int32)) >= 127).any()
        np.testing.assert_array_equal(
            snap.codes[: snap.size], codec.quantize_int8_host(snap.vectors[: snap.size], snap.scale))
        # A fresh index synced from the copy equals the built one.
        fresh = VectorIndex(chunk_rows=256)
        index_sync.sync_all(db, fresh)
        reconcile.run_reconcile(db, writer, fresh)
        same_snapshots(fresh.snapshot("st/x"), snap, codes=True)
        for side, (w, idx, d) in ((REF, (ref_writer, ref_index, ref_db)),
                                  (PORT, (writer, index, db))):
            side.reconcile.run_reconcile(d, w, idx, force_rescale=True)
        rescaled = _reconcile_state(db)
        assert rescaled == _reconcile_state(ref_db)
        assert rescaled[0][2] == 2 and rescaled[0][1] != frozen[0][1]
        same_snapshots(index.snapshot("st/x"), ref_index.snapshot("st/x"), codes=True)
        assert reconcile.coverage_status(db) == ref_reconcile.coverage_status(ref_db)
    finally:
        writer.close()
        ref_writer.close()


def test_reconcile_below_the_freeze_rederives_and_keeps_the_revision(tmp_path, monkeypatch):
    # Under ARTIFACT_MIN_VECTORS rows every reconcile re-derives the scale;
    # an identical artifact keeps its revision, new rows bump it, on both
    # sides alike; a space not desired drops its quant arm and coverage.
    monkeypatch.setattr(ref_store, "now_iso", lambda: NOW)
    monkeypatch.setattr(store, "now_iso", lambda: NOW)
    states = {}
    for side in (REF, PORT):
        db = side.Database(tmp_path / side.name, "r")
        writer, index = side.Writer(db), side.Index(chunk_rows=64)
        try:
            writer.call(_seed_vectors(side, 100, 8))
            seen = [side.reconcile.run_reconcile(db, writer, index).__dict__, _reconcile_state(db)]
            seen += [side.reconcile.run_reconcile(db, writer, index).__dict__, _reconcile_state(db)]
            writer.call(_seed_vectors(side, 10, 8, lo=100, scale=5.0))
            seen += [side.reconcile.run_reconcile(db, writer, index).__dict__, _reconcile_state(db)]
            snap = index.snapshot("st/x")
            seen.append((snap.scale, snap.codes[: snap.size].copy()))
            writer.call(lambda c: side.store.set_config(
                c, "vector_quants", {"profiles": {"int8": {"all": False, "setters": []}}}))
            seen += [side.reconcile.desired_spaces(db),
                     side.reconcile.run_reconcile(db, writer, index).__dict__,
                     _reconcile_state(db), index.snapshot("st/x").quant_ready]
            states[side.name] = seen
        finally:
            writer.close()
    got, want = states["port"], states["ref"]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(g, tuple) and len(g) == 2 and isinstance(g[1], np.ndarray):
            assert g[0] == w[0]
            np.testing.assert_array_equal(g[1], w[1])
        else:
            assert g == w
    assert [s[0][2] for s in (got[1], got[3], got[5])] == [1, 1, 2]
    assert got[-2] == [] and got[-1] is False



def test_text_work_query_matches_the_reference_and_looks_up_by_source(tmp_path, monkeypatch):
    # The port's derived-data work query returns the reference's rows on a
    # DB part way through a build (some text rows embedded, two text
    # setters, a source filter, a cursor), and finds a row's outputs
    # through item_data_source instead of walking every row of the setter.
    monkeypatch.setattr(store, "now_iso", lambda: NOW)
    db = Database(tmp_path / "w", "w")
    writer = IndexWriter(db)
    try:
        def unit(conn):
            ocr, stt, emb = (store.upsert_setter(conn, n) for n in ("ocr", "stt", "te/x"))
            for i in range(1, 41):
                item = store.upsert_item(conn, f"{i:064x}", f"{i:032x}", "image/png", size=i)
                for setter in (ocr, stt):
                    did = store.insert_item_data(conn, item, setter, "text")
                    store.insert_extracted_text(conn, did, f"text {i} {setter}", confidence=0.5,
                                                language_confidence=0.5)
                    if i % 3 == 0:
                        out = store.insert_item_data(conn, item, emb, "text-embedding",
                                                     source_id=did)
                        store.insert_embedding(conn, out, np.ones(4, np.float32))

        writer.call(unit)
        conn = db.reader()
        for sources in ((), ("ocr",), ("stt", "ocr"), ("none",)):
            for after in (0, 17, 79):
                got = extraction._unprocessed_text(conn, "te/x", sources, after)
                assert got == ref_extraction._unprocessed_text(conn, "te/x", sources, after)
        assert len(extraction._unprocessed_text(conn, "te/x", (), 0)) == 80 - 2 * 13
        plans = {}
        for name, fn in (("port", extraction._unprocessed_text),
                         ("ref", ref_extraction._unprocessed_text)):
            seen = []
            conn.set_trace_callback(seen.append)
            try:
                fn(conn, "te/x", (), 0)
            finally:
                conn.set_trace_callback(None)
            plans[name] = " ".join(str(r[3]) for r in conn.execute("EXPLAIN QUERY PLAN " + seen[-1]))
        assert "dv USING INDEX item_data_source" in plans["port"]
        assert "item_data_setter_type" not in plans["port"]
        assert "dv USING INDEX item_data_setter_type" in plans["ref"]  # a walk of the setter's rows
    finally:
        writer.close()


MD5_TOML = """
[group.tagmatch]
config.impl_class = "md5_lookup"
config.dump_path = "{dump}"
[group.tagmatch.metadata]
output_type = "tags"
[group.tagmatch.inference_ids.dump]
"""


def test_md5_lookup_build_matches_the_reference(tmp_path, media, monkeypatch):
    # tests/test_jobs.py::TestHashHandlers on both packages: a SQLite tag
    # dump keyed by three of the scanned images' md5s, the md5 handler (no
    # payload decode), equal items, item_data and tag rows.
    import hashlib
    import sqlite3

    images = sorted(p for p in media.rglob("*.png") if not p.name.startswith("."))
    md5s = [hashlib.md5(p.read_bytes()).hexdigest() for p in images]
    dump = tmp_path / "dump.sqlite"
    conn = sqlite3.connect(dump)
    conn.executescript("CREATE TABLE tags (md5 TEXT, namespace TEXT, name TEXT, confidence REAL);"
                       "CREATE INDEX tags_md5 ON tags(md5);")
    conn.executemany("INSERT INTO tags VALUES (?, 'danbooru', ?, ?)", [
        (md5s[0], "scenery", 0.8), (md5s[0], "sky", 0.5), (md5s[3], "scenery", 1.0),
        (md5s[5], "red", 0.25)])
    conn.commit()
    conn.close()
    built = {}
    for side in (REF, PORT):
        monkeypatch.setattr(side.store, "now_iso", lambda: NOW)
        reg = tmp_path / f"md5-registry-{side.name}"
        reg.mkdir()
        (reg / "00.toml").write_text(MD5_TOML.format(dump=dump))
        db = side.Database(tmp_path / f"md5-{side.name}", "jobs")
        writer, manager = side.Writer(db), side.Manager(side.Registry(reg), side.impls.IMPL_INDEX)
        try:
            writer.call(lambda c: side.store.add_folder(c, str(media)))
            side.scan.rescan_folders(db, writer)
            report = side.extraction.run_extraction_job(
                db=db, writer=writer, index=side.Index(chunk_rows=64), manager=manager,
                inference_id="tagmatch/dump", output_type="tags", mime_prefixes=("image/",),
                input_handler="md5")
            built[side.name] = (report, tables(db, ("items", "item_data", "setters", "tags",
                                                    "tags_items", "extraction_errors")))
        finally:
            manager.shutdown()
            writer.close()
    (report, got), (ref_report, want) = built["port"], built["ref"]
    assert (report.processed, report.input_errors, report.transient_errors) == \
        (ref_report.processed, ref_report.input_errors, ref_report.transient_errors) == (8, 0, 0)
    assert got == want
    rows = {(r[1], r[3]) for r in got["tags_items"]}
    assert len(got["tags_items"]) == 4 and {r[2] for r in got["tags"]} == {"scenery", "sky", "red"}
    assert {round(c, 6) for _, c in rows} == {0.8, 0.5, 1.0, 0.25}


OCR_TOML = """
[group.doctr]
config.impl_class = "ocr"
config.model_arch = "test-tiny"
config.checkpoint = "{ckpt}"
{device}
[group.doctr.metadata]
default_batch_size = 4
target_entities = ["items"]
output_type = "text"
input_mime_types = ["image/"]
[group.doctr.inference_ids.tiny]
"""


def test_ocr_build_matches_the_reference(tmp_path, monkeypatch):
    # An OCR job on both packages over one folder of PNG pages (one to three
    # lines of rendered digits each, and a blank page) with one checkpoint
    # trained by the reference's recipe: equal items, item_data (the blank
    # page a placeholder) and extracted_text rows, confidences within 1e-2;
    # FTS5 finds each text. A window of 4 pages holds at most 12 lines, under
    # the JAX impl's top bucket of 16 (ROADMAP §C).
    import pickle

    from PIL import Image

    from test_torch_ocr import SAMPLES, page, trained

    params, _ = trained("ctc")
    ckpt = tmp_path / "ocr.pkl"
    with open(ckpt, "wb") as f:
        pickle.dump(params, f)
    folder = tmp_path / "pages"
    folder.mkdir()
    for i in range(7):
        lines = [SAMPLES[(i + j) % len(SAMPLES)] for j in range(1 + i % 3)]
        Image.fromarray(page(lines)).save(folder / f"page{i}.png")
    Image.fromarray(np.full((30, 60), 255, np.uint8)).save(folder / "blank.png")
    built = {}
    for side in (REF, PORT):
        monkeypatch.setattr(side.store, "now_iso", lambda: NOW)
        reg = tmp_path / f"ocr-registry-{side.name}"
        reg.mkdir()
        (reg / "00.toml").write_text(OCR_TOML.format(ckpt=ckpt, device=side.device))
        db = side.Database(tmp_path / f"ocr-{side.name}", "jobs")
        writer, manager = side.Writer(db), side.Manager(side.Registry(reg), side.impls.IMPL_INDEX)
        try:
            writer.call(lambda c: side.store.add_folder(c, str(folder)))
            assert side.scan.rescan_folders(db, writer).new_files == 8
            report = side.extraction.run_extraction_job(
                db=db, writer=writer, index=side.Index(chunk_rows=64), manager=manager,
                inference_id="doctr/tiny", output_type="text", batch_size=4,
                mime_prefixes=("image/",))
            conn = db.reader()
            texts = conn.execute("SELECT * FROM extracted_text ORDER BY id").fetchall()
            # FTS5's trigram tokenizer matches terms of 3 or more characters.
            fts = {t[0]: {r[0] for r in conn.execute(
                "SELECT rowid FROM extracted_text_fts WHERE extracted_text_fts MATCH ?",
                (f'"{max(t[4].split(), key=len)}"',))} for t in texts}
            placeholders = conn.execute(
                "SELECT COUNT(*) FROM item_data WHERE is_placeholder = 1").fetchone()[0]
            built[side.name] = (report, tables(db), texts, fts, placeholders)
        finally:
            manager.shutdown()
            writer.close()
    (report, got, got_texts, got_fts, got_ph), (ref_report, want, want_texts, want_fts, want_ph) = \
        built["port"], built["ref"]
    assert (report.processed, report.input_errors, report.transient_errors) == \
        (ref_report.processed, ref_report.input_errors, ref_report.transient_errors) == (8, 0, 0)
    assert got == want
    assert len(got_texts) == len(want_texts) == 7
    for g, w in zip(got_texts, want_texts):
        (gid, glang, glc, gconf, gtext, glen), (wid, wlang, wlc, wconf, wtext, wlen) = g, w
        assert (gid, glang, glc, gtext, glen) == (wid, wlang, wlc, wtext, wlen)
        assert abs(gconf - wconf) <= 1e-2 and gconf > 0.5
        assert set(gtext.split("\n")) <= set(SAMPLES)
    assert got_fts == want_fts and all(tid in hits for tid, hits in got_fts.items())
    assert got_ph == want_ph == 1  # the blank page: an item_data row, no text
