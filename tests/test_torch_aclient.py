"""The port's async client (``panoptikon_tpu_torch/aclient.py``, on the
port's own ``api/web_client.py``) against the reference's
(``panoptikon_tpu/aclient.py``, on ``aiohttp``).

1. Recorded requests: for every public method of every resource, with
   representative arguments, both clients send the same method, path,
   query, JSON body and headers to one recording ``aiohttp`` server (less
   the client library's own ``User-Agent`` and ``Accept-Encoding``, which
   neither caller sets), and return the same value.
2. ``TestAsyncClient``'s two cases (``tests/test_client.py``) in port form,
   on the port's live server (``tests/test_torch_api.py``'s ``client_env``):
   every result equals the port's sync client's on the same server.
3. ``PanoptikonError`` on the same 404 and 400 as the reference client's,
   and the client's ``timeout``."""

import asyncio
import base64
import dataclasses
import inspect
import json
import time

import pytest
from aiohttp import web as aio_web
from test_torch_api import client_env  # noqa: F401  (the port's live server)

from panoptikon_tpu import aclient as ref_aclient
from panoptikon_tpu_torch import aclient
from panoptikon_tpu_torch.client import PanoptikonClient, PanoptikonError

RESOURCES = ("search", "items", "bookmarks", "pinboards", "jobs", "config", "inference",
             "databases", "relay", "desktop")
# Arguments by parameter name; the rest by annotation (representative_value).
NAMED = {
    "query": {"page_size": 3, "query": {"match_text": {"match": "a b"}}},
    "config": {"a": 1, "b": [1, "é"]}, "text_ids": [3, 5],
    "jobs": [{"name": "n", "schedule": "0 3 * * *"}], "inputs": [{"x": 1}, "plain", 3],
    "inference_id": "clip/tiny", "sha256": "ab" * 32, "ident": "a b/é?#",
    "byte_range": (0, 9), "files": {0: b"zz", 2: b"\x00\xff"}, "setters": ["a", "b c"],
    "included": ["/m a", "/n"], "excluded": ["/x"], "layout": {"cols": 2},
    "items": ["cd" * 32], "metadata": {"note": "é"}, "prefix": "ca t",
    "cron_schedule": "0 3 * * *", "job_id": 7, "pinboard_id": 4, "version_id": 2,
    "item_id": 9, "limit": 5, "byte_budget": 1 << 20, "user": "ann", "namespace": "favs n",
    "name": "db2", "value": "v&x=y", "timeout": 5.0, "poll_s": 0.01,
    "preview_b64": base64.b64encode(b"png").decode(),
}
EXTRA_KWARGS = {"opt_a": 1, "opt_b": "x y"}
QUEUE = {"running": None, "pending": [], "history": [{"job_id": 7, "state": "completed"}]}


def representative_value(param: inspect.Parameter):
    if param.name in NAMED:
        return NAMED[param.name]
    ann = str(param.annotation)
    if "bool" in ann:
        return not param.default if isinstance(param.default, bool) else True
    if ann.startswith("int"):
        return 6
    if ann.startswith("float"):
        return 2.5
    return f"{param.name}-v é"


def calls(resource_cls, full: bool):
    """(method name, args, kwargs) for every public method of a sync resource
    class: its required parameters, and with ``full`` every keyword too."""
    out = []
    for name, fn in vars(resource_cls).items():
        if name.startswith("_") or not callable(fn):
            continue
        args, kwargs = [], {}
        for p in list(inspect.signature(fn).parameters.values())[1:]:
            required = p.default is inspect.Parameter.empty
            if p.kind is p.VAR_KEYWORD:
                if full:
                    kwargs.update(EXTRA_KWARGS)
            elif p.kind is p.POSITIONAL_OR_KEYWORD and required:
                args.append(representative_value(p))
            elif required or full:
                kwargs[p.name] = representative_value(p)
        out.append((name, args, kwargs))
    return out


def recording_app(seen: list):
    async def record(request):
        body = await request.read()
        headers = sorted((k.lower(), v) for k, v in request.headers.items()
                         if k.lower() not in ("user-agent", "accept-encoding"))
        parsed = (json.loads(body) if request.content_type == "application/json" and body
                  else body)
        seen.append((request.method, request.raw_path, headers, parsed))
        path = request.path
        if path == "/api/jobs/queue":
            return aio_web.json_response(QUEUE)
        if path.startswith("/predict/"):
            return aio_web.json_response({"outputs": [
                {"__type__": "base64", "content": base64.b64encode(b"bin").decode()}, {"k": 1}]})
        if path.endswith(("/file", "/thumbnail")):
            return aio_web.Response(body=b"\x89PNG-bytes", content_type="image/png", headers={
                "Content-Range": "bytes 0-9/10", "Accept-Ranges": "bytes"})
        if path == "/cache":
            return aio_web.Response(status=204)
        return aio_web.json_response({"path": request.raw_path, "method": request.method})

    app = aio_web.Application()
    app.router.add_route("*", "/{tail:.*}", record)
    return app


async def _serve(app):
    runner = aio_web.AppRunner(app)
    await runner.setup()
    await aio_web.TCPSite(runner, "127.0.0.1", 0).start()
    return runner, f"http://127.0.0.1:{runner.addresses[0][1]}"


def _surface(client) -> list:
    """(resource name, the sync resource class it wraps)."""
    return [(res, getattr(client, res)._sync_cls) for res in RESOURCES]


def _value(out):
    """A result, with each package's FileResponse as its fields."""
    if dataclasses.is_dataclass(out):
        return type(out).__name__, dataclasses.asdict(out)
    return out


@pytest.mark.parametrize("pinned", [True, False], ids=["pinned", "bare"])
def test_every_method_sends_the_reference_s_request(pinned):
    seen = []
    options = {"index_db": "std db", "policy_token": "tok.1.ab"} if pinned else {}

    async def main():
        runner, base = await _serve(recording_app(seen))
        results = []
        try:
            async with ref_aclient.AsyncPanoptikonClient(base, **options) as ref, \
                    aclient.AsyncPanoptikonClient(base, **options) as port:
                for client_call in ("health", "openapi", "client_config", "accelerator"):
                    for c in (ref, port):
                        results.append((client_call, await getattr(c, client_call)()))
                for res, cls in _surface(port):
                    for full in (False, True):
                        for name, args, kwargs in calls(cls, full):
                            for c in (ref, port):
                                out = await getattr(getattr(c, res), name)(*args, **kwargs)
                                results.append((f"{res}.{name}", _value(out)))
        finally:
            await runner.cleanup()
        return results

    results = asyncio.run(asyncio.wait_for(main(), 120))
    assert len(seen) == len(results) and len(seen) >= 300
    for i in range(0, len(seen), 2):
        label = results[i][0]
        assert seen[i] == seen[i + 1], (label, seen[i], seen[i + 1])
        assert results[i] == results[i + 1], (label, results[i], results[i + 1])
    by_call = dict(zip((r[0] for r in results[::2]), seen[::2]))
    if pinned:
        # The pin and the token ride every /api/ request, and the
        # post-processed methods took their async paths.
        assert "index_db=std+db" in by_call["search.pql"][1]
        assert ("x-panoptikon-policy", "tok.1.ab") in by_call["search.pql"][2]
    waits = [r for r in results if r[0] == "jobs.wait"]
    assert waits and all(r[1] == {"job_id": 7, "state": "completed"} for r in waits)
    predicts = [r for r in results if r[0] == "inference.predict"]
    assert predicts and all(r[1] == [b"bin", {"k": 1}] for r in predicts)
    files = [s for s in seen if s[1].startswith("/predict/") and "file_b64" in json.dumps(s[3])]
    assert files


def _index(client: PanoptikonClient, media) -> None:
    client.jobs.set_folders(included=[str(media)], rescan=False)
    job = client.jobs.rescan_folders()
    done = client.jobs.wait(job["job_id"], timeout=120)
    assert done.get("state") in ("completed", "unknown")


def test_async_surface_matches_sync(client_env):  # noqa: F811
    # Port form of TestAsyncClient.test_async_surface_matches_sync: core
    # reads, a ranged file, mutations, predict, error mapping, the queue;
    # each result equal to the port's sync client's on the same server.
    url = f"http://127.0.0.1:{client_env['client'].port}"
    sync = PanoptikonClient(url, timeout=120)
    _index(sync, client_env["media"])

    def script(c, sha=None):
        page = yield c.search.pql({"page_size": 5})
        sha = sha or page["results"][0]["sha256"]
        meta = yield c.items.metadata(sha)
        ranged = yield c.items.file(sha, byte_range=(0, 9))
        put = yield c.bookmarks.put("bob", "favs", sha)
        rows = yield c.bookmarks.list("bob")
        deleted = yield c.bookmarks.delete("bob", "favs", sha)
        out = yield c.inference.predict("fixtures/echo", [{"x": 1}], files={0: b"zz"})
        health = yield c.health()
        # A page compared by its rows: its cache state and timings are the
        # request's own (the second client's page is a span-cache hit).
        page = {"count": page["count"], "results": page["results"]}
        # and a bookmark by what was put, not by the moment it was.
        rows = [{k: v for k, v in row.items() if k != "time_added"} for row in rows]
        return [page, meta, ranged, put, rows, deleted, out, health]

    def drive_sync():
        gen, value = script(sync), None
        try:
            while True:
                value = gen.send(value)
        except StopIteration as stop:
            return stop.value

    async def drive_async():
        async with aclient.AsyncPanoptikonClient(url, timeout=120) as c:
            gen, value = script(c), None
            try:
                while True:
                    value = await gen.send(value)
            except StopIteration as stop:
                results = stop.value
            with pytest.raises(PanoptikonError) as err:
                await c.items.metadata("0" * 64)
            status = await c.jobs.queue()
            return results, err.value, status

    want = drive_sync()
    got, err, status = asyncio.run(drive_async())
    assert got == want
    page, meta, ranged, put, rows, deleted, out, health = got
    assert page["count"] == 3 and "image/png" in json.dumps(meta)
    assert ranged.status == 206 and len(ranged.body) == 10
    assert len(out) == 1 and health["status"] == "ok"
    assert err.status == 404
    assert set(status) == {"running", "pending", "history"} and status == sync.jobs.queue()
    sync.close()


def test_async_wait_and_folders(client_env, tmp_path):  # noqa: F811
    # Port form of TestAsyncClient.test_async_wait_and_folders: the async
    # poll loop waits for a rescan job, and the folders it set are the ones
    # the sync client reads back.
    url = f"http://127.0.0.1:{client_env['client'].port}"
    extra = tmp_path / "async_media"
    extra.mkdir()

    async def main():
        async with aclient.AsyncPanoptikonClient(url, timeout=120) as c:
            await c.jobs.set_folders(included=[str(extra)], rescan=False)
            job = await c.jobs.rescan_folders()
            done = await c.jobs.wait(job["job_id"], timeout=120)
            return job, done, await c.jobs.get_folders()

    job, done, folders = asyncio.run(main())
    assert done.get("state") in ("completed", "unknown") and done["job_id"] == job["job_id"]
    sync = PanoptikonClient(url, timeout=120)
    assert folders == sync.jobs.get_folders() and str(extra) in json.dumps(folders)
    history = {h["job_id"]: h for h in sync.jobs.queue()["history"]}
    assert history[job["job_id"]] == done
    sync.close()


def test_errors_match_the_reference_client_s(client_env):  # noqa: F811
    # The same 404 and 400 from the port's server raise PanoptikonError with
    # the same status, message and path through both async clients.
    url = f"http://127.0.0.1:{client_env['client'].port}"

    async def errors(module):
        out = []
        async with module.AsyncPanoptikonClient(url, timeout=60) as c:
            for call in (lambda: c.items.metadata("0" * 64),
                         lambda: c.search.pql({"page_size": "many"}),
                         lambda: c.request("GET", "/api/nowhere")):
                try:
                    await call()
                    out.append(None)
                except module.PanoptikonError as exc:
                    out.append((exc.status, str(exc), exc.path))
        return out

    got = asyncio.run(errors(aclient))
    want = asyncio.run(errors(ref_aclient))
    assert got == want
    assert [g[0] for g in got] == [404, 400, 404]


@pytest.mark.parametrize("module", [aclient, ref_aclient], ids=["port", "reference"])
def test_timeout_is_honoured(module):
    # AsyncPanoptikonClient(timeout=) bounds a whole request: a server that
    # answers after 5 s raises TimeoutError at about the limit, on both.
    async def slow(request):
        await asyncio.sleep(5)
        return aio_web.json_response({})

    async def main():
        app = aio_web.Application()
        app.router.add_get("/health", slow)
        runner, base = await _serve(app)
        try:
            async with module.AsyncPanoptikonClient(base, timeout=0.5) as c:
                t0 = time.monotonic()
                with pytest.raises(TimeoutError):
                    await c.health()
                return time.monotonic() - t0
        finally:
            await runner.cleanup()

    waited = asyncio.run(asyncio.wait_for(main(), 30))
    assert 0.4 <= waited < 2.0


def test_lazy_export():
    import panoptikon_tpu_torch

    assert panoptikon_tpu_torch.AsyncPanoptikonClient is aclient.AsyncPanoptikonClient
