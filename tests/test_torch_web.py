"""The port's HTTP transport (``panoptikon_tpu_torch/api/web.py``): the
subset of ``aiohttp.web`` the server's handlers use, on
``asyncio.start_server``.

Every test starts its listener on ``127.0.0.1:0`` and runs under a time
limit of its own (``run``: ``asyncio.wait_for``); requests go over raw
asyncio streams, so a test can see which connection answered."""

import asyncio
import json

import pytest

from panoptikon_tpu_torch.api import web

LIMIT_S = 10.0


def run(coro, limit: float = LIMIT_S):
    return asyncio.run(asyncio.wait_for(coro, limit))


async def start(app, **runner_kwargs):
    runner = web.AppRunner(app, **runner_kwargs)
    await runner.setup()
    await web.TCPSite(runner, "127.0.0.1", 0).start()
    return runner, runner.addresses[0][1]


class Conn:
    """One client connection: send requests, read whole responses."""

    def __init__(self, reader, writer):
        self.reader, self.writer = reader, writer

    @classmethod
    async def open(cls, port):
        return cls(*await asyncio.open_connection("127.0.0.1", port))

    async def send(self, method, path, body=b"", headers=None, raw=None):
        if raw is not None:
            self.writer.write(raw)
        else:
            head = {"Host": "127.0.0.1", "Content-Length": str(len(body)), **(headers or {})}
            lines = [f"{method} {path} HTTP/1.1"] + [f"{k}: {v}" for k, v in head.items()]
            self.writer.write(("\r\n".join(lines) + "\r\n\r\n").encode() + body)
        await self.writer.drain()
        return await self.response(head_only=method == "HEAD")

    async def response(self, head_only=False):
        status_line = await self.reader.readline()
        if not status_line:
            return None
        status = int(status_line.split()[1])
        headers = {}
        while (line := await self.reader.readline()) not in (b"\r\n", b""):
            name, _, value = line.decode().partition(":")
            headers[name.strip().lower()] = value.strip()
        n = int(headers.get("content-length", 0))
        body = b"" if head_only else await self.reader.readexactly(n)
        return status, headers, body

    def close(self):
        self.writer.close()


async def text(request):
    return web.Response(text=f"{request.method} {request.path}")


def test_routes_match_in_order_with_parameters():
    async def item(request):
        return web.json_response({"route": "item", **request.match_info})

    async def users(request):
        return web.json_response({"route": "users"})

    async def main():
        app = web.Application()
        app.add_routes([
            web.get("/api/users", users),
            web.get("/api/{user}", item),
            web.get("/api/{user}/items/{sha}", item),
            web.post("/api/{user}/items/{sha}", item),
            web.delete("/files/{tail:.*}", item),
        ])
        runner, port = await start(app)
        c = await Conn.open(port)
        try:
            # A literal route added before a wildcard shadows it.
            assert json.loads((await c.send("GET", "/api/users"))[2]) == {"route": "users"}
            assert json.loads((await c.send("GET", "/api/ann"))[2]) == {
                "route": "item", "user": "ann"}
            # Parameters are percent-decoded; %2F stays inside its segment.
            status, _, body = await c.send("POST", "/api/a%20b/items/x%2Fy?z=1")
            assert status == 200 and json.loads(body) == {
                "route": "item", "user": "a b", "sha": "x/y"}
            assert json.loads((await c.send("DELETE", "/files/a/b/c"))[2])["tail"] == "a/b/c"
            status, _, body = await c.send("GET", "/nowhere")
            assert (status, body) == (404, b"404: Not Found")
            # The path matches but the method does not: 405 with Allow.
            status, headers, body = await c.send("PUT", "/api/ann/items/x")
            assert (status, body) == (405, b"405: Method Not Allowed")
            assert headers["allow"] == "GET,POST"
            # GET routes answer HEAD without a body.
            status, headers, _ = await c.send("HEAD", "/api/users")
            assert status == 200 and int(headers["content-length"]) > 0
            assert [r.method for r in app.router.routes()] == ["GET", "GET", "GET", "POST",
                                                                "DELETE"]
            assert app.router.routes()[2].get_info() == {"formatter": "/api/{user}/items/{sha}"}
            assert app.router.routes()[0].get_info() == {"path": "/api/users"}
        finally:
            c.close()
            await runner.cleanup()

    run(main())


def test_query_gives_the_first_value():
    async def handler(request):
        q = request.query
        return web.json_response({"first": q.get("a"), "item": q["a"], "has": "a" in q,
                                  "missing": q.get("b", "dflt"), "blank": q.get("c"),
                                  "plus": q.get("d"), "raw": str(request.rel_url)})

    async def main():
        app = web.Application()
        app.add_routes([web.get("/q", handler)])
        runner, port = await start(app)
        c = await Conn.open(port)
        try:
            _, _, body = await c.send("GET", "/q?a=1&a=2&c=&d=x+y%2Bz")
            assert json.loads(body) == {"first": "1", "item": "1", "has": True, "missing": "dflt",
                                        "blank": "", "plus": "x y+z",
                                        "raw": "/q?a=1&a=2&c=&d=x+y%2Bz"}
        finally:
            c.close()
            await runner.cleanup()

    run(main())


def test_json_bodies_bad_json_and_unhandled_errors():
    async def echo(request):
        readable = request.can_read_body
        try:
            body = await request.json()
        except Exception as exc:  # the handlers catch what aiohttp raises
            return web.json_response({"error": type(exc).__name__}, status=400)
        return web.json_response({"body": body, "readable": readable,
                                  "after": request.can_read_body,
                                  "ctype": request.content_type})

    async def raw_json(request):
        return web.json_response(await request.json())  # uncaught: a 500

    async def main():
        app = web.Application()
        app.add_routes([web.post("/echo", echo), web.post("/raw", raw_json)])
        runner, port = await start(app)
        c = await Conn.open(port)
        try:
            status, headers, body = await c.send(
                "POST", "/echo", json.dumps({"x": [1, "é"]}).encode(),
                {"Content-Type": "application/json"})
            assert status == 200 and headers["content-type"] == "application/json; charset=utf-8"
            assert json.loads(body) == {"body": {"x": [1, "é"]}, "readable": True,
                                        "after": False, "ctype": "application/json"}
            # No Content-Type: aiohttp's default.
            _, _, body = await c.send("POST", "/echo", b"[1]")
            assert json.loads(body)["ctype"] == "application/octet-stream"
            for bad in (b"{not json", b""):
                status, _, body = await c.send("POST", "/echo", bad)
                assert (status, json.loads(body)) == (400, {"error": "JSONDecodeError"})
            status, headers, body = await c.send("POST", "/raw", b"{oops")
            assert status == 500 and headers["connection"] == "close"
            assert body == b"500 Internal Server Error\n\nServer got itself in trouble"
            assert await c.response() is None  # the server closed the connection
        finally:
            c.close()
            await runner.cleanup()

    run(main())


def test_bodies_past_client_max_size_get_413():
    async def handler(request):
        return web.json_response({"n": len(await request.read())})

    async def main():
        app = web.Application(client_max_size=1024)
        app.add_routes([web.post("/up", handler)])
        runner, port = await start(app)
        c = await Conn.open(port)
        try:
            status, _, body = await c.send("POST", "/up", b"x" * 1024)
            assert (status, json.loads(body)) == (200, {"n": 1024})
            status, headers, body = await c.send("POST", "/up", b"x" * 1025)
            assert status == 413 and headers["connection"] == "close"
            assert body == (b"Maximum request body size 1024 exceeded, "
                            b"actual body size 1025")
            # A chunked body is held to the same limit.
            c2 = await Conn.open(port)
            raw = (b"POST /up HTTP/1.1\r\nTransfer-Encoding: chunked\r\n\r\n"
                   b"400\r\n" + b"y" * 1024 + b"\r\n2\r\nzz\r\n0\r\n\r\n")
            status, _, _ = await c2.send("POST", "/up", raw=raw)
            assert status == 413
            c2.close()
            c3 = await Conn.open(port)
            raw = b"POST /up HTTP/1.1\r\nTransfer-Encoding: chunked\r\n\r\n3\r\nabc\r\n0\r\n\r\n"
            status, _, body = await c3.send("POST", "/up", raw=raw)
            assert (status, json.loads(body)) == (200, {"n": 3})
            c3.close()
        finally:
            c.close()
            await runner.cleanup()

    run(main())


def test_http_exceptions_middleware_order_and_request_keys():
    calls = []

    @web.middleware
    async def outer(request, handler):
        calls.append("outer")
        request["seen"] = ["outer"]
        try:
            resp = await handler(request)
        except web.HTTPException as exc:
            exc.headers["X-Outer"] = "1"  # as the server's trace middleware does
            raise
        resp.headers["X-Outer"] = "1"
        return resp

    @web.middleware
    async def inner(request, handler):
        calls.append("inner")
        request["seen"].append("inner")
        if request.query.get("deny"):
            raise web.HTTPForbidden(reason="denied by policy 'p'")
        return await handler(request)

    async def handler(request):
        calls.append("handler")
        if request.query.get("bad"):
            raise web.HTTPBadRequest(reason="limit must be an integer")
        return web.json_response({"seen": request["seen"], "get": request.get("absent", 7)})

    async def main():
        app = web.Application(middlewares=[outer, inner])
        app["state"] = "shared"
        app.add_routes([web.get("/h", handler)])
        runner, port = await start(app)
        c = await Conn.open(port)
        try:
            status, headers, body = await c.send("GET", "/h")
            assert json.loads(body) == {"seen": ["outer", "inner"], "get": 7}
            assert headers["x-outer"] == "1" and calls == ["outer", "inner", "handler"]
            status, headers, body = await c.send("GET", "/h?bad=1")
            assert (status, body) == (400, b"400: limit must be an integer")
            assert headers["x-outer"] == "1"
            assert headers["content-type"] == "text/plain; charset=utf-8"
            status, headers, body = await c.send("GET", "/h?deny=1")
            assert (status, body, headers["x-outer"]) == (403, b"403: denied by policy 'p'", "1")
            # Middlewares run for unmatched paths too, as aiohttp's do.
            status, headers, _ = await c.send("GET", "/missing")
            assert status == 404 and headers["x-outer"] == "1"
            # The connection stays open across error answers.
            assert (await c.send("GET", "/h"))[0] == 200
            assert app["state"] == "shared" and app.get("absent") is None
        finally:
            c.close()
            await runner.cleanup()

    run(main())


def test_responses_and_file_ranges(tmp_path):
    blob = bytes(range(256)) * 4
    path = tmp_path / "clip.bin"
    path.write_bytes(blob)

    async def file(request):
        return web.FileResponse(path, headers={"Content-Type": "video/mp4"})

    async def guessed(request):
        return web.FileResponse(tmp_path / "page.html")

    async def thumb(request):
        return web.Response(body=b"\xff\xd8\xff", content_type="image/jpeg",
                            headers={"Cache-Control": "no-store"})

    async def empty(request):
        return web.Response(status=204)

    async def page(request):
        return web.Response(text="<p>é</p>", content_type="text/html")

    async def main():
        (tmp_path / "page.html").write_text("<html></html>")
        app = web.Application()
        app.add_routes([web.get("/f", file), web.get("/g", guessed), web.get("/t", thumb),
                        web.delete("/e", empty), web.get("/p", page)])
        runner, port = await start(app)
        c = await Conn.open(port)
        try:
            status, headers, body = await c.send("GET", "/f")
            assert (status, body, headers["content-type"]) == (200, blob, "video/mp4")
            assert headers["accept-ranges"] == "bytes"
            for spec, want, rng in (("bytes=100-199", blob[100:200], "100-199"),
                                    ("bytes=1000-", blob[1000:], "1000-1023"),
                                    ("bytes=-24", blob[-24:], "1000-1023"),
                                    ("bytes=1000-5000", blob[1000:], "1000-1023")):
                status, headers, body = await c.send("GET", "/f", headers={"Range": spec})
                assert (status, body) == (206, want), spec
                assert headers["content-range"] == f"bytes {rng}/{len(blob)}"
            for spec in ("bytes=1024-", "bytes=-0", "bytes=5-2", "items=1-2"):
                status, headers, body = await c.send("GET", "/f", headers={"Range": spec})
                assert (status, body) == (416, b""), spec
                assert headers["content-range"] == f"bytes */{len(blob)}"
            assert (await c.send("GET", "/g"))[1]["content-type"] == "text/html"
            status, headers, body = await c.send("GET", "/t")
            assert (body, headers["content-type"], headers["cache-control"]) == (
                b"\xff\xd8\xff", "image/jpeg", "no-store")
            status, headers, body = await c.send("DELETE", "/e")
            assert (status, body) == (204, b"") and "content-length" not in headers
            status, headers, body = await c.send("GET", "/p")
            assert body.decode() == "<p>é</p>"
            assert headers["content-type"] == "text/html; charset=utf-8"
        finally:
            c.close()
            await runner.cleanup()

    run(main())


def test_multipart_upload():
    async def handler(request):
        assert request.content_type.startswith("multipart/")
        reader = await request.multipart()
        out = {}
        async for part in reader:
            if part.name == "data":
                out["data"] = json.loads(await part.text())
            else:
                data = await part.read()
                out[part.name] = [part.filename, data.hex()]
        return web.json_response(out)

    async def main():
        app = web.Application()
        app.add_routes([web.post("/predict", handler)])
        runner, port = await start(app)
        c = await Conn.open(port)
        binary = b"\r\n--x\r\n\x00\xff\r\n" + bytes(range(256))
        boundary = "b0undary-42"
        body = (
            f"--{boundary}\r\n"
            'Content-Disposition: form-data; name="data"\r\n'
            "Content-Type: application/json\r\n\r\n"
            '{"inputs": [{"a": 1}, {"b": "é"}]}\r\n'
            f"--{boundary}\r\n"
            'Content-Disposition: form-data; name="0"; filename="x.bin"\r\n'
            "Content-Type: application/octet-stream\r\n\r\n"
        ).encode() + binary + f"\r\n--{boundary}\r\n".encode() + (
            'Content-Disposition: form-data; name="1"\r\n\r\n'
        ).encode() + b"" + f"\r\n--{boundary}--\r\n".encode()
        try:
            status, _, out = await c.send(
                "POST", "/predict", body,
                {"Content-Type": f'multipart/form-data; boundary="{boundary}"'})
            assert status == 200, out
            assert json.loads(out) == {"data": {"inputs": [{"a": 1}, {"b": "é"}]},
                                       "0": ["x.bin", binary.hex()], "1": [None, ""]}
        finally:
            c.close()
            await runner.cleanup()

    run(main())


def test_keep_alive_reuses_one_connection():
    peers = []

    async def handler(request):
        peers.append(request.remote)
        return web.json_response({"n": len(peers)})

    async def main():
        app = web.Application()
        app.add_routes([web.get("/n", handler)])
        runner, port = await start(app)
        c = await Conn.open(port)
        try:
            for i in range(1, 6):
                status, headers, body = await c.send("GET", "/n")
                assert json.loads(body) == {"n": i} and headers["connection"] == "keep-alive"
            assert len(runner._connections) == 1
            # Connection: close is honoured, as is HTTP/1.0 without keep-alive.
            status, headers, _ = await c.send("GET", "/n", headers={"Connection": "close"})
            assert headers["connection"] == "close" and await c.response() is None
            c10 = await Conn.open(port)
            status, headers, _ = await c10.send(
                "GET", "/n", raw=b"GET /n HTTP/1.0\r\nHost: x\r\n\r\n")
            assert status == 200 and headers["connection"] == "close"
            c10.close()
            # A malformed request line is a 400 and a closed connection.
            bad = await Conn.open(port)
            status, _, _ = await bad.send("GET", "/", raw=b"NONSENSE\r\n\r\n")
            assert status == 400 and await bad.response() is None
            bad.close()
        finally:
            c.close()
            await runner.cleanup()

    run(main())


def test_cleanup_closes_idle_connections_and_finishes_in_flight_requests():
    started = asyncio.Event()

    async def slow(request):
        started.set()
        await asyncio.sleep(0.3)
        return web.json_response({"done": True})

    async def main():
        app = web.Application()
        app.add_routes([web.get("/slow", slow), web.get("/t", text)])
        runner, port = await start(app)
        idle = await Conn.open(port)
        assert (await idle.send("GET", "/t"))[0] == 200  # now idle, kept alive
        busy = await Conn.open(port)
        busy.writer.write(b"GET /slow HTTP/1.1\r\nHost: x\r\n\r\n")
        await busy.writer.drain()
        await started.wait()
        loop = asyncio.get_running_loop()
        t0 = loop.time()
        await runner.cleanup()
        assert loop.time() - t0 < 5.0
        # The request in flight was answered, then its connection closed.
        status, headers, body = await busy.response()
        assert (status, json.loads(body), headers["connection"]) == (200, {"done": True}, "close")
        assert await busy.response() is None
        assert await idle.response() is None  # the idle one was closed
        with pytest.raises(OSError):
            await asyncio.open_connection("127.0.0.1", port)  # no longer listening
        idle.close()
        busy.close()

    run(main())


def test_cleanup_cancels_a_request_past_the_shutdown_timeout():
    async def forever(request):
        await asyncio.sleep(3600)

    async def main():
        app = web.Application()
        app.add_routes([web.get("/forever", forever)])
        runner, port = await start(app, shutdown_timeout=0.2)
        c = await Conn.open(port)
        c.writer.write(b"GET /forever HTTP/1.1\r\nHost: x\r\n\r\n")
        await c.writer.drain()
        await asyncio.sleep(0.1)
        loop = asyncio.get_running_loop()
        t0 = loop.time()
        await runner.cleanup()
        assert loop.time() - t0 < 3.0
        c.close()

    run(main())
