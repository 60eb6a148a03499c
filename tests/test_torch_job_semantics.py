"""The semantics of the port's job layer, as ``tests/test_jobs.py`` holds
the JAX package's: the serialized queue (cancel pending and running jobs,
order, dedupe, failures, owed maintenance, durable and re-seeded), failure
classification of an extraction run, resume after a cancel, the error-slot
ledger and a bad payload under the ``decoded_image`` handler, with the
port's ``ClipImpl`` at ``test-tiny`` on the CPU and the port's fixture
impls."""

import threading
import time

import numpy as np
import pytest

from panoptikon_tpu_torch.db import store
from panoptikon_tpu_torch.db.connection import Database
from panoptikon_tpu_torch.db.writer import IndexWriter
from panoptikon_tpu_torch.index import VectorIndex
from panoptikon_tpu_torch.jobs import extraction, reconcile, scan
from panoptikon_tpu_torch.jobs.queue import ChangeSummary, JobQueue, JobType
from panoptikon_tpu_torch.models.impls import IMPL_INDEX
from panoptikon_tpu_torch.models.manager import ModelManager
from panoptikon_tpu_torch.models.registry import Registry

REG_TOML = """
[group.clip]
config.impl_class = "clip"
config.model_arch = "test-tiny"
config.device = "cpu"
[group.clip.metadata]
output_type = "clip"
input_mime_types = ["image/"]
[group.clip.inference_ids.tiny]

[group.oomfix]
config.impl_class = "oom_impl"
config.oom_above = 0
[group.oomfix.metadata]
output_type = "clip"
input_mime_types = ["image/"]
[group.oomfix.inference_ids.dead]
"""


def make_png(path, color, size=(40, 40)):
    from PIL import Image

    Image.new("RGB", size, color).save(path)


@pytest.fixture
def env(tmp_path):
    media = tmp_path / "media"
    (media / "sub").mkdir(parents=True)
    make_png(media / "red.png", (255, 0, 0))
    make_png(media / "green.png", (0, 255, 0))
    make_png(media / "sub" / "blue.png", (0, 0, 255))
    (media / "notes.txt").write_text("not an image")
    db = Database(tmp_path / "data", "jobs")
    writer = IndexWriter(db)
    reg_dir = tmp_path / "registry"
    reg_dir.mkdir()
    (reg_dir / "00.toml").write_text(REG_TOML)
    manager = ModelManager(Registry(reg_dir), IMPL_INDEX)
    yield {"db": db, "writer": writer, "index": VectorIndex(chunk_rows=64), "manager": manager,
           "media": media}
    manager.shutdown()
    writer.close()


def _scan(env):
    scan.rescan_folders(env["db"], env["writer"], folders=[str(env["media"])])


def _job(env, **kw):
    args = dict(db=env["db"], writer=env["writer"], index=env["index"], manager=env["manager"],
                inference_id="clip/tiny", output_type="clip", batch_size=2)
    return extraction.run_extraction_job(**{**args, **kw})


class TestQueue:
    def test_cancel_pending_job(self):
        gate = threading.Event()
        q = JobQueue({JobType.FOLDER_RESCAN: lambda handle: gate.wait(timeout=10) and None})
        running = q.enqueue("dbx", JobType.FOLDER_RESCAN, {"n": 0})
        pending = q.enqueue("dbx", JobType.FOLDER_RESCAN, {"n": 1})
        assert q.cancel("dbx", pending.job_id)
        gate.set()
        assert q.wait_idle("dbx", timeout=10)
        states = {h["job_id"]: h["state"] for h in q.status("dbx")["history"]}
        assert states == {running.job_id: "completed", pending.job_id: "cancelled"}
        q.shutdown()

    def test_cancel_running_job_cooperatively(self):
        started, progress = threading.Event(), []

        def runner(handle):
            started.set()
            for i in range(200):
                if handle.cancelled:
                    break
                progress.append(i)
                time.sleep(0.01)

        q = JobQueue({JobType.FOLDER_RESCAN: runner})
        h = q.enqueue("dbx", JobType.FOLDER_RESCAN)
        assert started.wait(timeout=10)
        q.cancel("dbx", h.job_id)
        assert q.wait_idle("dbx", timeout=10)
        assert 0 < len(progress) < 200 and h.state == "cancelled"
        q.shutdown()

    def test_serialized_execution_and_history(self):
        order, active = [], []

        def runner(handle):
            active.append(1)
            assert len(active) == 1  # one job at a time on a database
            order.append(handle.params["n"])
            time.sleep(0.01)
            active.pop()

        q = JobQueue({JobType.FOLDER_RESCAN: runner})
        for n in range(4):
            q.enqueue("dbx", JobType.FOLDER_RESCAN, {"n": n})
        assert q.wait_idle("dbx", timeout=10)
        assert order == [0, 1, 2, 3] and len(q.status("dbx")["history"]) == 4
        q.shutdown()

    def test_dedupe_pending(self):
        def slow_runner(handle):
            time.sleep(0.05)

        q = JobQueue({JobType.FOLDER_RESCAN: slow_runner})
        q.enqueue("dbx", JobType.FOLDER_RESCAN, {"p": 1})
        time.sleep(0.02)
        b = q.enqueue("dbx", JobType.FOLDER_RESCAN, {"p": 1})
        c = q.enqueue("dbx", JobType.FOLDER_RESCAN, {"p": 1})
        assert b.job_id == c.job_id
        q.wait_idle("dbx", timeout=10)
        q.shutdown()

    def test_failure_recorded(self):
        def bad(handle):
            raise RuntimeError("kaboom")

        q = JobQueue({JobType.FOLDER_RESCAN: bad})
        q.enqueue("dbx", JobType.FOLDER_RESCAN)
        q.wait_idle("dbx", timeout=10)
        hist = q.status("dbx")["history"]
        assert hist[0]["state"] == "failed" and "kaboom" in hist[0]["error"]
        q.shutdown()

    def test_boundary_maintenance_synthesized(self):
        ran = []

        def data_job(handle):
            ran.append("data")
            time.sleep(0.05)
            return ChangeSummary(wrote_data=True, needs_analyze=True)

        q = JobQueue({JobType.DATA_EXTRACTION: data_job,
                      JobType.DB_MAINTENANCE: lambda handle: ran.append("maintenance") and None})
        q.enqueue("dbx", JobType.DATA_EXTRACTION, {"a": 1})
        q.enqueue("dbx", JobType.DATA_EXTRACTION, {"a": 2})
        q.wait_idle("dbx", timeout=10)
        assert ran == ["data", "data", "maintenance"]
        q.shutdown()

    def test_owed_maintenance_persists_and_clears(self):
        saved, done = [], {"n": 0}
        q = JobQueue(runners={JobType.FOLDER_RESCAN: lambda h: ChangeSummary(needs_analyze=True),
                              JobType.DB_MAINTENANCE: lambda h: done.__setitem__("n", done["n"] + 1)},
                     persist_owed=lambda db, snap: saved.append((db, snap)))
        q.enqueue("d", JobType.FOLDER_RESCAN)
        deadline = time.time() + 10
        while time.time() < deadline and done["n"] == 0:
            time.sleep(0.02)
        q.shutdown()
        assert done["n"] == 1
        assert saved[0][1]["needs_analyze"] is True and saved[-1] == ("d", None)

    def test_seed_owed_triggers_maintenance(self):
        done = {"n": 0}
        q = JobQueue(runners={JobType.DB_MAINTENANCE: lambda h: done.__setitem__("n", done["n"] + 1)})
        q.seed_owed("d", ChangeSummary(tags_dirty=True))
        deadline = time.time() + 10
        while time.time() < deadline and done["n"] == 0:
            time.sleep(0.02)
        q.shutdown()
        assert done["n"] == 1
        assert ChangeSummary.from_dict(ChangeSummary(True, False, True).to_dict()) == \
            ChangeSummary(True, False, True)


class TestExtractionSemantics:
    def test_clip_build_then_rerun_finds_nothing(self, env):
        _scan(env)
        report = _job(env)
        assert (report.processed, report.input_errors) == (3, 0)
        snap = env["index"].snapshot("clip/tiny")
        assert snap.size == 3 and snap.quant_ready
        assert reconcile.coverage_status(env["db"])[0]["state"] == "ready"
        assert _job(env).processed == 0

    def test_all_systemic_fails_loudly(self, env):
        _scan(env)
        with pytest.raises(extraction.SystemicExtractionFailure, match="outage"):
            _job(env, inference_id="oomfix/dead", batch_size=4)
        env["writer"].call(store.remove_incomplete_jobs)
        assert env["db"].reader().execute("SELECT MAX(completed) FROM data_jobs").fetchone()[0] <= 0

    def test_input_only_completes(self, env):
        (env["media"] / "corrupt.png").write_bytes(b"\x89PNG\r\n\x1a\n" + b"\x00" * 64)
        _scan(env)
        report = _job(env, batch_size=4)
        assert report.processed == 3 and report.input_errors == 1

    def test_decoded_image_handler_bad_payload_is_input_error(self, env):
        (env["media"] / "broken.png").write_bytes(b"\x89PNG\r\n\x1a\n garbage")
        _scan(env)
        report = _job(env, setter_name="decerr", input_handler="decoded_image",
                      input_handler_opts={"size": 32}, loader_concurrency=2)
        assert report.processed == 3 and report.input_errors == 1

    def test_error_slots_ledger(self, env):
        _scan(env)
        calls = {"n": 0}

        def flaky_predict(inference_id, inputs, **kw):
            out = []
            for _ in inputs:
                calls["n"] += 1
                if calls["n"] == 1:
                    out.append({"__error__": {"class": "input", "message": "bad media"}})
                elif calls["n"] == 2:
                    out.append({"__error__": {"class": "transient", "message": "oom"}})
                else:
                    out.append({"namespace": "t", "tags": [("general", {"x": 0.9})],
                                "mcut": 0.5, "rating_severity": [], "metadata": {},
                                "metadata_score": 0.0})
            return out

        env["manager"].predict = flaky_predict
        report = _job(env, inference_id="tags/tiny-tagger", setter_name="flaky", output_type="tags",
                      batch_size=4)
        assert (report.input_errors, report.transient_errors, report.processed) == (1, 1, 1)
        assert report.summary.tags_dirty
        # The input-failed item leaves the work query; the transient one stays.
        assert store.count_unprocessed(env["db"].reader(), "flaky", ["image/"]) == 1

    def test_extraction_resumes_from_work_query(self, env):
        for i in range(9):
            make_png(env["media"] / f"extra{i}.png", (i * 20 % 255, 50, 90))
        _scan(env)
        calls = {"n": 0}

        def cancel_after_two():
            calls["n"] += 1
            return calls["n"] > 2

        first = _job(env, cancelled=cancel_after_two)
        conn = env["db"].reader()
        partial = conn.execute("SELECT COUNT(*) FROM embeddings").fetchone()[0]
        assert 0 < partial < 12
        second = _job(env, batch_size=4)
        assert conn.execute("SELECT COUNT(*) FROM embeddings").fetchone()[0] == 12
        assert first.processed + second.processed == 12
        assert env["index"].snapshot("clip/tiny").size == 12

    def test_byte_budget_admits_an_oversized_item_alone(self):
        budget = extraction.ByteBudget(100)
        order = []

        def second():
            with budget.hold(60):  # waits: 60 + 60 exceed the cap
                order.append("b")

        with budget.hold(60):
            t = threading.Thread(target=second)
            t.start()
            time.sleep(0.05)
            order.append("a")
        t.join(timeout=5)
        assert order == ["a", "b"]
        with budget.hold(500):  # over the cap, admitted alone
            pass

    def test_text_payloads_and_merge(self):
        row = (12, 3, 12, "some text", 0.8, 0.9)
        (inp,) = extraction._load_payloads(None, None, row, "text", None, None, None)
        assert inp.data == {"text": "some text"} and inp.file is None
        from panoptikon_tpu_torch.utils import npy

        a, b = np.ones((1, 4), np.float32), np.zeros((2, 4), np.float32)
        merged = npy.parse_npy(extraction._merge_outputs("clip", [npy.serialize_npy(a),
                                                                  npy.serialize_npy(b)]))
        assert merged.shape == (3, 4)
        assert extraction._merge_outputs("text", [{"text": "a"}, "b"])["text"] == "a\nb"
