"""The port's HTTP server against the reference's, on the CPU.

1. The cases of the reference's ``tests/test_api.py`` and
   ``tests/test_api_embed.py`` run again against the port: their source,
   with ``panoptikon_tpu.`` read as ``panoptikon_tpu_torch.`` (the
   ``ast.dump`` guard's renames), is compiled into a module of its own, and
   its classes are collected here with this file's ``client_env``: the
   port's ``AppState`` on ``device="cpu"`` (its registry TOML gives the
   CLIP group ``config.device = "cpu"``), served by the port's transport
   (``api/web.py``) on ``127.0.0.1:0``, called through ``http.client`` on
   one keep-alive connection. The cases that drive ``aiohttp``'s own client
   or server (a ranged file read, the metadata overlay's second server, the
   federation round trip and the pinboard-search differential) are
   overridden below by port forms that hold the same things.
2. A parity test drives one scripted flow through both servers, the
   reference's on a real ``aiohttp`` listener and the port's on its own,
   with one ``http.client`` client, over the same PNG folder, the same
   test-tiny CLIP checkpoint (written by the reference's
   ``save_clip_checkpoint``) and the same registry TOML.
3. The OpenAPI document and the CLI of the port against the reference's.
"""

import asyncio
import contextlib
import http.client
import json
import re
import threading
import types
import urllib.parse
from pathlib import Path

import numpy as np
import pytest

from panoptikon_tpu_torch.api import web
from panoptikon_tpu_torch.api.server import AppState, build_app

REPO = Path(__file__).resolve().parent.parent

# The renames of tests/test_torch_host_copies.py: the dotted package name,
# and the package's own name where no dot follows it.
_RENAMES = {r"\bpanoptikon_tpu\.": "panoptikon_tpu_torch.",
            r"\bimport panoptikon_tpu\b(?!_)": "import panoptikon_tpu_torch",
            r"\bfrom panoptikon_tpu import\b": "from panoptikon_tpu_torch import"}

PORT_REG_TOML = """
[group.clip]
config.impl_class = "clip"
config.model_arch = "test-tiny"
config.device = "cpu"
[group.clip.metadata]
name = "CLIP"
output_type = "clip"
input_mime_types = ["image/"]
default_batch_size = 4
[group.clip.inference_ids.tiny]
metadata.description = "tiny clip"

[group.fixtures]
config.impl_class = "echo_impl"
[group.fixtures.inference_ids.echo]
"""


def _reference_cases(name: str) -> types.ModuleType:
    """The reference's test module ``name``, compiled against the port."""
    path = REPO / "tests" / name
    src = path.read_text()
    for pattern, repl in _RENAMES.items():
        src = re.sub(pattern, repl, src)
    # aiohttp's test client is not the port's transport: the cases that use
    # it are overridden below.
    src = src.replace("from aiohttp.test_utils import TestClient, TestServer\n", "")
    module = types.ModuleType(f"{path.stem}_on_the_port")
    module.__file__ = str(path)
    exec(compile(src, str(path), "exec"), module.__dict__)
    return module


_api = _reference_cases("test_api.py")
_embed = _reference_cases("test_api_embed.py")
# The reference's registry TOML with the CLIP group on the CPU.
assert _api.REG_TOML.replace('config.model_arch = "test-tiny"\n',
                             'config.model_arch = "test-tiny"\nconfig.device = "cpu"\n') == \
    PORT_REG_TOML
_api.REG_TOML = PORT_REG_TOML
wait_jobs = _api.wait_jobs
make_png = _api.make_png


class Served:
    """An app served by an event loop in a thread on ``127.0.0.1:0``, on the
    port's transport or on ``aiohttp.web`` (``transport``); requests go
    through one keep-alive ``http.client`` connection."""

    def __init__(self, app, transport=web, timeout: float = 120.0):
        self.loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self._thread.start()
        self.runner = transport.AppRunner(app)

        async def start():
            await self.runner.setup()
            await transport.TCPSite(self.runner, "127.0.0.1", 0).start()

        self.submit(start(), 10)
        self.port = self.runner.addresses[0][1]
        self.conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=timeout)

    def submit(self, coro, timeout: float):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    def request(self, method, path, json_body=None, params=None, headers=None, data=None):
        """(status, headers, body bytes)."""
        if params:
            path += ("&" if "?" in path else "?") + urllib.parse.urlencode(params)
        headers = dict(headers or {})
        if json_body is not None:
            data = json.dumps(json_body).encode()
            headers.setdefault("Content-Type", "application/json")
        self.conn.request(method, path, body=data, headers=headers)
        resp = self.conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()

    def call(self, method, path, **kwargs):
        """The reference fixture's ``call``: (status, JSON or bytes)."""
        status, headers, body = self.request(
            method, path, json_body=kwargs.pop("json", None), **kwargs)
        ctype = headers.get("Content-Type", "").split(";")[0]
        return status, (json.loads(body) if ctype == "application/json" else body)

    def close(self):
        self.conn.close()
        self.submit(self.runner.cleanup(), 30)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self._thread.join(10)
        self.loop.close()


@contextlib.contextmanager
def served(state):
    server = Served(build_app(state))
    try:
        yield server
    finally:
        server.close()


@pytest.fixture
def client_env(tmp_path):
    media = tmp_path / "media"
    media.mkdir()
    for i, color in enumerate([(255, 0, 0), (0, 255, 0), (0, 0, 255)]):
        make_png(media / f"img{i}.png", color)
    reg = tmp_path / "registry"
    reg.mkdir()
    (reg / "00.toml").write_text(PORT_REG_TOML)
    state = AppState.create(tmp_path / "data", reg, device="cpu")
    server = Served(build_app(state))
    yield {"call": server.call, "state": state, "media": media, "tmp": tmp_path,
           "client": server, "loop": server.loop}
    server.close()
    state.shutdown()


# -- the reference's cases, collected here ----------------------------------

stub_server = _embed.stub_server
tag_stub_server = _embed.tag_stub_server
TestApiEmbed = _embed.TestApiEmbed
TestTagApi = _embed.TestTagApi

_PORT_FORMS = {"TestLifecycle", "TestWiredSubsystems", "TestFederation",
               "TestPinboardSearchDifferential"}
for _name, _cls in vars(_api).items():
    if _name.startswith("Test") and isinstance(_cls, type) and _name not in _PORT_FORMS:
        globals()[_name] = _cls


class TestLifecycle(_api.TestLifecycle):
    def test_file_range_requests(self, client_env):
        """Port form of the reference's ranged read (aiohttp's client there,
        http.client here): bytes 100-199 come back 206 with Content-Range
        and exactly those bytes, a suffix range its last bytes, an
        unsatisfiable range 416."""
        from PIL import Image

        call, state, server = client_env["call"], client_env["state"], client_env["client"]
        rng = np.random.default_rng(0)
        noise = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
        big_path = client_env["media"] / "noise.png"
        Image.fromarray(noise).save(big_path)
        call("PUT", "/api/jobs/folders", json={"included": [str(client_env["media"])]})
        wait_jobs(state)
        _, res = call(
            "POST", "/api/search/pql",
            json={"query": {"match": {"endswith": {"path": "noise.png"}}},
                  "page_size": 1},
        )
        sha = res["results"][0]["sha256"]
        full = big_path.read_bytes()
        assert len(full) > 300

        def ranged(hdr):
            return server.request("GET", f"/api/items/{sha}/file", headers={"Range": hdr})

        status, headers, body = ranged("bytes=100-199")
        assert status == 206
        assert headers["Content-Range"] == f"bytes 100-199/{len(full)}"
        assert body == full[100:200]
        status, headers, body = ranged("bytes=-50")
        assert status == 206 and body == full[-50:]
        status, _, _ = ranged(f"bytes={len(full) + 10}-")
        assert status == 416
        # Without a Range header the whole file, with the handler's type.
        status, headers, body = server.request("GET", f"/api/items/{sha}/file")
        assert status == 200 and body == full and headers["Content-Type"] == "image/png"


class TestWiredSubsystems(_api.TestWiredSubsystems):
    def test_metadata_availability_overlay(self, client_env, tmp_path):
        """Port form of the reference's overlay case (a second server on
        aiohttp's test client there, on the port's transport here): an
        api_embed id without an endpoint is unavailable, one with an
        endpoint available, and a local impl carries no flag."""
        reg = tmp_path / "ovl"
        reg.mkdir()
        (reg / "00.toml").write_text(
            "[group.jina]\nconfig.impl_class = 'api_embed'\n"
            "[group.jina.inference_ids.v1]\n"
            "[group.jina2]\nconfig.impl_class = 'api_embed'\n"
            "config.endpoint = 'http://127.0.0.1:1/x'\n"
            "[group.jina2.inference_ids.v1]\n"
            "[group.clip]\nconfig.impl_class = 'clip'\n"
            "config.model_arch = 'test-tiny'\n"
            "[group.clip.inference_ids.tiny]\n"
        )
        state = AppState.create(tmp_path / "ovl_data", reg, device="cpu")
        try:
            with served(state) as server:
                status, meta = server.call("GET", "/metadata")
        finally:
            state.shutdown()
        assert status == 200
        assert meta["jina"]["inference_ids"]["v1"]["available"] is False
        assert meta["jina2"]["inference_ids"]["v1"]["available"] is True
        assert "available" not in meta["clip"]["inference_ids"]["tiny"]


class TestFederation(_api.TestFederation):
    def test_http_backend_round_trip(self, client_env):
        """Port form of the reference's federation case (aiohttp's
        AppRunner there, the port's here): a pool reaches this server's
        /predict through the port's HTTP backend; the health probe heals a
        transiently unhealthy upstream, keeps a dead one unhealthy, and
        re-marks a backend without health() optimistically."""
        from panoptikon_tpu_torch.models.base import PredictionInput
        from panoptikon_tpu_torch.models.http_backend import HttpInferenceBackend
        from panoptikon_tpu_torch.models.pool import InferencePool

        call, state = client_env["call"], client_env["state"]
        status, _ = call("GET", "/health")
        assert status == 200
        with served(state) as server:
            backend = HttpInferenceBackend(f"http://127.0.0.1:{server.port}")
            pool = InferencePool()
            pool.add(backend, weight=2, name="remote")
            out = pool.predict("fixtures/echo", [PredictionInput(data={"x": 1})])
            assert out[0] == {"echo": {"x": 1}, "file_len": 0}
            assert backend.health()["status"] == "ok"
            pool._upstreams[0].healthy = False
            pool.probe_once()
            assert pool.stats()[0]["healthy"] is True
        dead = HttpInferenceBackend("http://127.0.0.1:1")
        pool2 = InferencePool()
        pool2.add(dead, name="dead")
        pool2._upstreams[0].healthy = False
        pool2.probe_once()
        assert pool2.stats()[0]["healthy"] is False

        class Bare:
            def predict(self, *a, **k):
                return []

        pool3 = InferencePool()
        pool3.add(Bare(), name="bare")
        pool3._upstreams[0].healthy = False
        pool3.probe_once()
        assert pool3.stats()[0]["healthy"] is True


class TestPinboardSearchDifferential:
    def test_ranking_matches_oracle_over_random_boards(self, tmp_path):
        """Port form of the reference's differential (aiohttp's test client
        there): over random boards on a 30-image corpus, the board ranking
        equals the oracle recomputed from the full search order (best rank
        asc, fraction desc, count desc, recency desc, id desc)."""
        import random

        media = tmp_path / "media"
        media.mkdir()
        rnd = random.Random(7)
        for i in range(30):
            make_png(media / f"img{i}.png",
                     (rnd.randrange(256), rnd.randrange(256), rnd.randrange(256)))
        reg = tmp_path / "registry"
        reg.mkdir()
        (reg / "00.toml").write_text(PORT_REG_TOML)
        state = AppState.create(tmp_path / "data", reg, device="cpu")
        try:
            with served(state) as server:
                call = server.call
                call("PUT", "/api/jobs/folders", json={"included": [str(media)]})
                wait_jobs(state)
                call("POST", "/api/jobs/data/extraction", json={"inference_id": "clip/tiny"})
                wait_jobs(state)
                query = {"image_embeddings": {"query": "a bright colorful image",
                                              "model": "clip/tiny"}}
                _, full = call("POST", "/api/search/pql", json={"query": query, "page_size": 30})
                ordered = [r["sha256"] for r in full["results"]]
                assert len(ordered) == 30
                pos = {}
                for i, sha in enumerate(ordered):
                    pos.setdefault(sha, i)
                boards = {}
                for b in range(12):
                    shas = rnd.sample(ordered, rnd.randrange(1, 8))
                    if rnd.random() < 0.3:
                        shas.append("f" * 64)
                    _, body = call("POST", "/api/pinboards/user", json={"name": f"b{b}"})
                    pid = body["id"]
                    call("POST", f"/api/pinboards/user/{pid}/versions", json={"layout": shas})
                    boards[pid] = shas
                _, res = call("POST", "/api/pinboards/search", json={"query": query})
        finally:
            state.shutdown()
        got = [(p["id"], p["match_count"]) for p in res["pinboards"]]
        oracle = []
        for pid, shas in boards.items():
            pins = set(shas)
            matched = [s for s in pins if s in pos]
            if not matched:
                continue
            best = min(pos[s] for s in matched)
            frac = len(matched) / len(pins)
            oracle.append((best, -frac, -len(matched), -pid, pid, len(matched)))
        oracle.sort()
        assert got == [(t[4], t[5]) for t in oracle]


def test_the_reference_cases_import_only_the_port():
    # Compiled against the port, the reference's cases reach none of the
    # JAX package's modules.
    for module in (_api, _embed, _cli):
        leaked = [name for name, value in vars(module).items()
                  if getattr(value, "__module__", None) and
                  str(getattr(value, "__module__")).split(".")[0] == "panoptikon_tpu"]
        leaked += [name for name, value in vars(module).items()
                   if type(value).__name__ == "module" and value.__name__.split(".")[0] ==
                   "panoptikon_tpu"]
        assert not leaked, (module.__name__, leaked)
    assert _cli.cli.__name__ == "panoptikon_tpu_torch.cli"


def test_every_reference_case_runs_here():
    # Every test of the two reference modules is collected in this file,
    # either as the reference's text or as its port form.
    import inspect

    def cases(module):
        return {f"{n}.{m}" for n, c in vars(module).items()
                if n.startswith("Test") and isinstance(c, type)
                for m in dir(c) if m.startswith("test_")}

    want = cases(_api) | cases(_embed)
    got = {f"{n}.{m}" for n, c in globals().items()
           if n.startswith("Test") and inspect.isclass(c) for m in dir(c) if m.startswith("test_")}
    assert want <= got and len(want) == 70, (len(want), sorted(want - got))


# -- the two servers on one flow ----------------------------------------------

PARITY_TOML = """
[group.clip]
config.impl_class = "clip"
config.model_arch = "test-tiny"
config.checkpoint = "{checkpoint}"
{device}
[group.clip.metadata]
name = "CLIP"
output_type = "clip"
input_mime_types = ["image/"]
default_batch_size = 4
[group.clip.inference_ids.tiny]
"""


def reference_server(app) -> Served:
    """The reference's app on a real aiohttp listener."""
    from aiohttp import web as aiohttp_web

    return Served(app, transport=aiohttp_web)


def _raw_query(dim: int, seed: int) -> str:
    import base64

    from panoptikon_tpu_torch.utils import npy

    vec = np.random.default_rng(seed).standard_normal(dim).astype(np.float32)
    return base64.standard_b64encode(npy.serialize_npy(vec)).decode()


def exact_pages(sha: str) -> dict:
    """Pages whose scores depend only on the stored vectors: a raw query
    vector, and an item's own vector (similar_to)."""
    raw = {"image_embeddings": {"query": _raw_query(32, 5), "model": "clip/tiny",
                                "embed": None}, "select_as": "distance"}
    similar = {"similar_to": {"target": sha, "model": "clip/tiny"}, "select_as": "distance"}
    return {"search.raw": {"query": raw, "page_size": 8, "cache": False},
            "search.similar": {"query": similar, "page_size": 8, "cache": False}}


def _flow(server, state, media: Path):
    """One scripted session: (label, status, body) for every step."""
    out = []

    def step(label, method, path, **kwargs):
        status, body = server.call(method, path, **kwargs)
        out.append((label, status, body))
        return body

    step("health", "GET", "/health")
    # The query-embedding cache is process-wide and keyed by model id, not
    # checkpoint: earlier tests embedded the same text with other weights.
    step("embed.cache.clear", "DELETE", "/api/search/embeddings/cache")
    step("folders", "PUT", "/api/jobs/folders", json={"included": [str(media)]})
    assert state.queue.wait_idle("default", timeout=120)
    step("folders.get", "GET", "/api/jobs/folders")
    step("extraction", "POST", "/api/jobs/data/extraction", json={"inference_id": "clip/tiny"})
    assert state.queue.wait_idle("default", timeout=120)
    step("queue", "GET", "/api/jobs/queue")
    step("quants", "GET", "/api/jobs/quants")
    step("stats", "GET", "/api/search/stats")
    text = {"query": {"image_embeddings": {"query": "a red image", "model": "clip/tiny"},
                      "select_as": "distance"},
            "page_size": 8}
    page = step("search.text", "POST", "/api/search/pql", json=text)
    step("search.text.cached", "POST", "/api/search/pql", json=text)
    for label, body in exact_pages(page["results"][1]["sha256"]).items():
        step(label, "POST", "/api/search/pql", json=body)
    step("search.build", "POST", "/api/search/pql/build", json=text)
    step("search.match", "POST", "/api/search/pql",
         json={"query": {"match": {"endswith": {"path": ".png"}}}, "page_size": 8})
    step("search.bad", "POST", "/api/search/pql", data=b"{not json",
         headers={"Content-Type": "application/json"})
    sha = page["results"][0]["sha256"]
    step("item", "GET", f"/api/items/{sha}")
    step("item.file", "GET", f"/api/items/{sha}/file")
    step("item.thumbnail", "GET", f"/api/items/{sha}/thumbnail")
    step("item.missing", "GET", "/api/items/" + "0" * 64)
    step("tags.top", "GET", "/api/search/tags/top")
    step("tags", "GET", "/api/search/tags", params={"q": "a"})
    step("setters.total", "GET", "/api/jobs/data/setters/total")
    step("history.data", "GET", "/api/jobs/history/data")
    step("history.scans", "GET", "/api/jobs/history/scans")
    step("db", "GET", "/api/db")
    step("db.create", "POST", "/api/db", json={"name": "second"})
    step("db.create.bad", "POST", "/api/db", json={"name": "../evil"})
    step("db.after", "GET", "/api/db")
    step("config", "GET", "/api/config/system")
    step("config.put", "PUT", "/api/config/system", json={"continuous_scan": False})
    step("bad.db", "GET", "/api/search/stats", params={"index_db": "../x"})
    step("not.found", "GET", "/api/no/such/route")
    step("wrong.method", "DELETE", "/api/search/pql")
    step("metadata", "GET", "/metadata")
    step("pool", "GET", "/api/inference/pool")
    step("client-config", "GET", "/api/client-config")
    step("accelerator", "GET", "/api/accelerator")
    return out


# Keys whose values are wall-clock times or durations, or depend on them
# (the search coalescer's counters and timings among them); any key ending
# in "_time" too.
_TIMES = {"metrics", "started_at", "finished_at", "enqueued_at", "coalescer"}


def _normalised(body):
    if isinstance(body, dict):
        return {k: ("<time>" if k in _TIMES or k.endswith("_time") else _normalised(v))
                for k, v in body.items()}
    if isinstance(body, list):
        return [_normalised(v) for v in body]
    if isinstance(body, str) and re.fullmatch(r"\d{4}-\d\d-\d\dT[\d:.]+([+-]\d\d:\d\d|Z)?", body):
        return "<time>"
    return body


def _same_page(got, want, atol=1e-6):
    assert got["count"] == want["count"] and len(got["results"]) == len(want["results"])
    for g, w in zip(got["results"], want["results"]):
        assert {k: v for k, v in g.items() if k != "extra"} == \
            {k: v for k, v in w.items() if k != "extra"}
        ge, we = g.get("extra") or {}, w.get("extra") or {}
        assert ge.keys() == we.keys()
        for key in ge:
            if isinstance(ge[key], float):
                assert abs(ge[key] - we[key]) <= atol, (key, ge[key], we[key])
            else:
                assert ge[key] == we[key]


@pytest.fixture(scope="module")
def clip_checkpoint(tmp_path_factory):
    import jax

    from panoptikon_tpu.models import clip as ref_clip
    from panoptikon_tpu.models import weights as ref_weights

    root = tmp_path_factory.mktemp("ckpt")
    cfg = ref_clip.CONFIGS["test-tiny"]
    tree = jax.tree.map(np.asarray, ref_clip.init_params(jax.random.key(7), cfg))
    ref_weights.save_clip_checkpoint(tree, cfg, root / "clip.bin")
    return str(root / "clip.bin")


def test_port_server_answers_as_the_reference_s(tmp_path, clip_checkpoint):
    # One flow through both servers gives equal statuses and equal JSON
    # bodies once times and timings are normalised; pages have equal ids,
    # order and counts. Each server embeds the folder with its own tower
    # (the JAX one and the port's, cosine >= 0.999), so the flow's
    # distances agree within 1e-2. Both servers restarted over copies of the
    # reference's database answer the raw-vector and similar_to pages with
    # equal ids and order and distances within 1e-6. By design two answers
    # differ:
    # client-config's multi_chip and /api/accelerator report each server's
    # devices (the reference runs on the 8 virtual CPU devices of
    # tests/conftest.py, the port on its one CPU device).
    from panoptikon_tpu.api.server import AppState as RefAppState
    from panoptikon_tpu.api.server import build_app as ref_build_app

    media = tmp_path / "media"
    media.mkdir()
    rng = np.random.default_rng(3)
    for i in range(6):
        make_png(media / f"img{i}.png", tuple(int(c) for c in rng.integers(0, 256, 3)))
    flows = {}
    for side, create, build, server_cls, device in (
            ("ref", RefAppState.create, ref_build_app, reference_server, ""),
            ("port", lambda *a: AppState.create(*a, device="cpu"), build_app, Served,
             'config.device = "cpu"')):
        reg = tmp_path / f"registry-{side}"
        reg.mkdir()
        (reg / "00.toml").write_text(PARITY_TOML.format(checkpoint=clip_checkpoint,
                                                        device=device))
        state = create(tmp_path / f"data-{side}", reg)
        server = server_cls(build(state))
        try:
            flows[side] = _flow(server, state, media)
        finally:
            server.close()
            state.shutdown()
    ref, port = flows["ref"], flows["port"]
    # Both servers over copies of one database: the reference's vectors.
    import shutil

    sha = next(body for label, _, body in ref if label == "search.text")["results"][1]["sha256"]
    same = {}
    for side, create, build, server_cls in (
            ("ref", RefAppState.create, ref_build_app, reference_server),
            ("port", lambda *a: AppState.create(*a, device="cpu"), build_app, Served)):
        shutil.copytree(tmp_path / "data-ref", tmp_path / f"same-{side}")
        state = create(tmp_path / f"same-{side}", tmp_path / f"registry-{side}")
        server = server_cls(build(state))
        try:
            same[side] = {label: server.call("POST", "/api/search/pql", json=body)
                          for label, body in exact_pages(sha).items()}
        finally:
            server.close()
            state.shutdown()
    for label, (status, want) in same["ref"].items():
        status_got, got = same["port"][label]
        assert status == status_got == 200 and want["count"] == 6
        assert "distance" in want["results"][-1]["extra"]
        _same_page(got, want)
    assert [(label, status) for label, status, _ in port] == \
        [(label, status) for label, status, _ in ref]
    for (label, _, got), (_, _, want) in zip(port, ref):
        if label.startswith("search.") and isinstance(want, dict) and "results" in want:
            _same_page(got, want, atol=1e-2)
            got, want = ({k: v for k, v in b.items() if k != "results"} for b in (got, want))
        if label == "client-config":
            assert got["capabilities"].pop("multi_chip") is False
            assert want["capabilities"].pop("multi_chip") is True
        if label == "embed.cache.clear":
            continue  # its hit and miss counters are the process's, not the server's
        if label == "stats":
            # The int8 scale comes from each tower's embeddings (the JAX
            # tower's and the port's, cosine >= 0.999 in test_torch_jobs.py).
            for space, st in want["spaces"].items():
                scale = got["spaces"][space].pop("scale")
                assert scale == pytest.approx(st.pop("scale"), rel=1e-2)
        if label == "accelerator":
            assert got == {"backend": "cpu", "device_count": 1, "devices": [
                {"id": 0, "kind": "cpu", "platform": "cpu", "process": 0}]}
            assert want["device_count"] == 8
            continue
        assert _normalised(got) == _normalised(want), (label, _normalised(got), _normalised(want))


# -- the CLI and the OpenAPI document ------------------------------------------

_cli = _reference_cases("test_cli_openapi.py")
for _name in ("TestCli", "TestSchemaGen", "TestEmbeddedResources", "TestSelfUpdate",
              "TestSelfUpdateVersionCompare"):
    globals()[_name] = getattr(_cli, _name)


class TestOpenApiSurface(_cli.TestOpenApiSurface):
    @pytest.fixture
    def client(self, tmp_path):
        """Port form of the reference's fixture (aiohttp's test client
        there): the port's server, ``call(method, path)`` giving
        (status, JSON or text)."""
        state = AppState.create(tmp_path / "data", device="cpu")
        server = Served(build_app(state))

        def call(method, path):
            status, body = server.call(method, path)
            return status, body if isinstance(body, (dict, list)) else body.decode()

        yield call
        server.close()
        state.shutdown()


class TestTraceMiddleware:
    def test_response_time_header(self, tmp_path):
        """Port form of the reference's case (aiohttp's test client there):
        every answer carries X-Response-Time, an HTTPException's too."""
        state = AppState.create(tmp_path / "data", device="cpu")
        try:
            with served(state) as server:
                status, headers, _ = server.request("GET", "/health")
                assert status == 200 and headers["X-Response-Time"].endswith("ms")
                status, headers, body = server.request(
                    "GET", "/api/search/stats", params={"index_db": "../x"})
                assert status == 400 and headers["X-Response-Time"].endswith("ms")
                assert body == b"400: database name must be alphanumeric/-/_"
        finally:
            state.shutdown()


class TestAcceleratorEnvMatrix:
    def test_env_matrix_reports_generation(self, capsys):
        """Port form: the reference's table of TPU generations has no
        counterpart on the card, and --env says so."""
        from panoptikon_tpu_torch import cli

        assert cli.main(["accelerator", "--env"]) == 0
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert out["generation"] is None and out["recommended"] == {}
        assert "no counterpart" in out["notes"]
        # The variables parallel.multihost.initialize() reads.
        assert set(out["multihost"]) == {"MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"}


def test_openapi_document_is_the_reference_s(tmp_path):
    # The port serves the reference's routes and PQL schemas: the two
    # /openapi.json documents are equal, and so are the CLI's parsers.
    from panoptikon_tpu import cli as ref_cli
    from panoptikon_tpu.api.server import AppState as RefAppState
    from panoptikon_tpu.api.server import build_app as ref_build_app
    from panoptikon_tpu_torch import cli

    docs = {}
    for side, create, build, server_cls in (
            ("ref", RefAppState.create, ref_build_app, reference_server),
            ("port", lambda root: AppState.create(root, device="cpu"), build_app, Served)):
        state = create(tmp_path / side)
        server = server_cls(build(state))
        try:
            docs[side] = server.call("GET", "/openapi.json")
        finally:
            server.close()
            state.shutdown()
    assert docs["port"][0] == docs["ref"][0] == 200
    got, want = docs["port"][1], docs["ref"][1]
    # Summaries are the handlers' docstrings: the ported device report
    # says what the port reports.
    assert got["paths"]["/api/accelerator"]["get"].pop("summary").startswith(
        "Device inventory under the reference's keys")
    want["paths"]["/api/accelerator"]["get"].pop("summary")
    assert got == want
    assert len(docs["port"][1]["paths"]) >= 70

    def commands(parser):
        sub = next(a for a in parser._actions if a.choices and "serve" in a.choices)
        return {name: sorted(a.dest for a in p._actions) for name, p in sub.choices.items()}

    got, want = commands(cli.build_parser()), commands(ref_cli.build_parser())
    # The port's serve takes --device; everything else is the reference's.
    assert got.pop("serve") == sorted(want.pop("serve") + ["device"])
    assert got == want


@pytest.mark.parametrize("processes,layout,device,refused", [
    (2, "replica", "cpu", False), (2, "replica", "cpu,cpu", True), (2, "shard", "cpu", True),
    (1, "shard", "cpu,cpu", False),
])
def test_cli_serve_refuses_a_mesh_across_processes(tmp_path, monkeypatch, processes, layout,
                                                    device, refused):
    # A --device list is the serving mesh, its executors on the first entry.
    # Across processes a mesh of more than one shard makes every search a
    # collective that each process must enter with the same queries, and the
    # server answers its own requests: it serves only the replica layout
    # with one shard a process, and refuses the rest before the device is
    # taken.
    from panoptikon_tpu_torch import cli
    from panoptikon_tpu_torch.api import server as port_server
    from panoptikon_tpu_torch.parallel import mesh as meshlib
    from panoptikon_tpu_torch.parallel import multihost

    class Stop(Exception):
        pass

    created = []

    def create(*a, **kw):
        created.append((kw["device"], meshlib.serving_shards()))
        raise Stop

    monkeypatch.setattr(multihost, "initialize", lambda **kw: processes > 1)
    monkeypatch.setattr(multihost, "process_count", lambda: processes)
    monkeypatch.setattr(port_server.AppState, "create", create)
    cfg = tmp_path / "parallel.toml"
    cfg.write_text(f"data_root = '{tmp_path / 'data'}'\n"
                   f"[parallel]\nmultihost_layout = '{layout}'\n")
    try:
        with pytest.raises(RuntimeError if refused else Stop, match="lockstep" if refused else None):
            cli.main(["serve", "--config", str(cfg), "--device", device])
    finally:
        meshlib.set_devices(None)
        meshlib.set_multihost_layout("replica")
    shards = len(device.split(",")) * (processes if layout == "shard" else 1)
    assert created == ([] if refused else [("cpu", shards)])
    assert not (tmp_path / "data").exists()


def test_cli_serve_refuses_what_waits(tmp_path, monkeypatch):
    # An [upstreams].ui is served as the reference serves it: serve_all
    # mounts the reverse proxy after the API routes of every listener, so an
    # unclaimed path (and a method the API's route does not take) reaches
    # the upstream while /health still answers from the API. A [parallel]
    # section is the reference's: main joins the runtime it names and sets
    # the mesh layout before the device is taken, and without a coordinator
    # the join does nothing. --device cuda without CUDA raises.
    import aiohttp
    import aiohttp.web
    import torch
    import torch.distributed as dist

    from panoptikon_tpu_torch import cli
    from panoptikon_tpu_torch.api import server as port_server
    from panoptikon_tpu_torch.api.proxy import LOOP_GUARD_HEADER
    from panoptikon_tpu_torch.config import Settings
    from panoptikon_tpu_torch.parallel import mesh as meshlib
    from panoptikon_tpu_torch.parallel import multihost

    async def upstream(request):
        return aiohttp.web.json_response({"upstream": request.raw_path, "method": request.method,
                                          "hop": request.headers.get(LOOP_GUARD_HEADER)})

    async def main():
        stub = aiohttp.web.Application()
        stub.router.add_route("*", "/{tail:.*}", upstream)
        stub_runner = aiohttp.web.AppRunner(stub)
        await stub_runner.setup()
        await aiohttp.web.TCPSite(stub_runner, "127.0.0.1", 0).start()
        cfg = tmp_path / "ui.toml"
        cfg.write_text(f"data_root = '{tmp_path / 'ui-data'}'\n[[listeners]]\nhost = '127.0.0.1'\n"
                       f"port = 0\n[upstreams]\n"
                       f"ui = 'http://127.0.0.1:{stub_runner.addresses[0][1]}/'\n")
        settings = Settings.load(str(cfg))
        state = AppState.create(settings.data_root, device="cpu")
        runners = await port_server.serve_all(settings, state)
        base = f"http://127.0.0.1:{runners[0].addresses[0][1]}"
        try:
            async with aiohttp.ClientSession() as session:
                out = []
                for method, path in (("GET", "/ui/page?x=1"), ("GET", "/health"),
                                     ("GET", "/api/search/pql"), ("PUT", "/health")):
                    async with session.request(method, base + path) as resp:
                        out.append((resp.status, await resp.json()))
                return out
        finally:
            for runner in runners:
                await runner.cleanup()
            await stub_runner.cleanup()
            state.shutdown()

    ui, health, pql, put = asyncio.run(asyncio.wait_for(main(), 120))
    assert ui == (200, {"upstream": "/ui/page?x=1", "method": "GET", "hop": "1"})
    assert health[0] == 200 and "upstream" not in health[1] and "registry_ok" in health[1]
    assert pql == (200, {"upstream": "/api/search/pql", "method": "GET", "hop": "1"})
    assert put == (200, {"upstream": "/health", "method": "PUT", "hop": "1"})

    joined, layouts = [], []
    real_initialize = multihost.initialize
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    monkeypatch.setattr(multihost, "initialize",
                        lambda **kw: joined.append(kw) or real_initialize(**kw))
    monkeypatch.setattr(meshlib, "set_multihost_layout", layouts.append)

    class Stop(Exception):
        pass

    def create(*a, **kw):
        raise Stop

    monkeypatch.setattr(port_server.AppState, "create", create)
    cfg = tmp_path / "parallel.toml"
    cfg.write_text(f"data_root = '{tmp_path / 'data'}'\n"
                   "[parallel]\nnum_processes = 2\nprocess_id = 1\nmultihost_layout = 'shard'\n")
    try:
        with pytest.raises(Stop):
            cli.main(["serve", "--config", str(cfg), "--device", "cpu"])
        # One process: its mesh is the one --device, one shard.
        assert meshlib.devices() == [torch.device("cpu")] and meshlib.serving_shards() == 1
    finally:
        meshlib.set_devices(None)
    assert joined == [{"coordinator": None, "num_processes": 2, "process_id": 1}]
    assert layouts == ["shard"] and not dist.is_initialized()
    assert not (tmp_path / "data").exists()
    monkeypatch.undo()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        AppState.create(tmp_path / "data-cuda")
