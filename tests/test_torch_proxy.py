"""The port's reverse proxy (``panoptikon_tpu_torch/api/proxy.py``) and the
transport halves it runs on (``api/web.py``: streamed bodies and responses,
multi-valued headers, ``*`` routes, WebSockets; ``api/web_client.py``: the
client) against the reference's proxy on ``aiohttp``.

Every case runs on two stacks, with the same requests:

- ``port``: the port's proxy on the port's transport, in front of an
  ``aiohttp`` upstream;
- ``reference``: the reference's proxy on ``aiohttp``, in front of an
  upstream on the port's ``web.py``.

So each half of the port meets ``aiohttp``'s other half. The two stacks
must give equal statuses and bodies, the same multiset of response headers
(less ``Date``, ``Server`` and the framing: ``Content-Length``,
``Transfer-Encoding``, ``Connection``, ``Keep-Alive``), and upstreams that
saw the same target, hop header, ``Cookie`` values and token policy.
Requests go over raw asyncio streams, a client of neither library, so that
repeated headers and the order bytes arrive in stay visible; the WebSocket
cases also drive each stack with the other library's client."""

import asyncio
import base64
import contextlib
import hashlib
import json
import os
import struct

import numpy as np
import pytest
from aiohttp import ClientSession as AioClientSession
from aiohttp import web as aio_web
from aiohttp.test_utils import make_mocked_request
from hypothesis import example, given, settings
from hypothesis import strategies as st

from panoptikon_tpu.api import policy as ref_policy
from panoptikon_tpu.api import policy_token as ref_token
from panoptikon_tpu.api import proxy as ref_proxy
from panoptikon_tpu.config import PolicyConfig as RefPolicyConfig
from panoptikon_tpu_torch.api import policy as port_policy
from panoptikon_tpu_torch.api import policy_token as port_token
from panoptikon_tpu_torch.api import proxy as port_proxy
from panoptikon_tpu_torch.api import web as port_web
from panoptikon_tpu_torch.api import web_client
from panoptikon_tpu_torch.config import PolicyConfig as PortPolicyConfig

LIMIT_S = 60.0
HOP = port_proxy.LOOP_GUARD_HEADER
TOKEN = port_token.POLICY_TOKEN_HEADER
KEY_HEX = "5e" * 32
FRONT_MAX = 16 * 1024 * 1024  # the server app's client_max_size
DROP = {"date", "server", "content-length", "transfer-encoding", "connection", "keep-alive"}
HEAD_BYTES = 65536


def run(coro, limit: float = LIMIT_S):
    return asyncio.run(asyncio.wait_for(coro, limit))


# -- the two stacks ----------------------------------------------------------

STACKS = {
    # name: (front transport, its proxy, its policy module, its token module,
    #        its PolicyConfig, the upstream's transport)
    "port": (port_web, port_proxy, port_policy, port_token, PortPolicyConfig, aio_web),
    "reference": (aio_web, ref_proxy, ref_policy, ref_token, RefPolicyConfig, port_web),
}


def upstream_app(W, views: list, gate: asyncio.Event):
    """The UI stand-in, the same code on either transport."""

    async def ui(request):
        view = {"method": request.method, "target": request.raw_path,
                "hop": request.headers.get(HOP), "cookies": request.headers.getall("Cookie", [])}
        views.append({**view, "token": request.headers.get(TOKEN)})
        return W.Response(text=json.dumps(view), content_type="application/json",
                          headers=[("Set-Cookie", "s1=a; Path=/"), ("Set-Cookie", "s2=b; Path=/"),
                                   ("X-Upstream", "1")])

    async def big(request):
        resp = W.StreamResponse(headers={"Content-Type": "application/octet-stream"})
        await resp.prepare(request)
        await resp.write(b"A" * HEAD_BYTES)
        # The tail waits until the client has seen the head through the proxy:
        # only a proxy that streams makes progress.
        await asyncio.wait_for(gate.wait(), timeout=10)
        await resp.write(b"B" * HEAD_BYTES)
        await resp.write_eof()
        return resp

    async def echo(request):
        digest, n = hashlib.sha256(), 0
        async for chunk in request.content.iter_chunked(1 << 16):
            digest.update(chunk)
            n += len(chunk)
        views.append({"method": request.method, "target": request.raw_path,
                      "hop": request.headers.get(HOP), "length": n})
        return W.json_response({"length": n, "sha256": digest.hexdigest()})

    async def ws_echo(request):
        ws = W.WebSocketResponse(protocols=("chat",))
        await ws.prepare(request)
        views.append({"ws": request.raw_path, "hop": request.headers.get(HOP),
                      "protocol": ws.ws_protocol})
        async for msg in ws:
            if msg.type == W.WSMsgType.TEXT:
                await ws.send_str(f"echo:{msg.data}")
            elif msg.type == W.WSMsgType.BINARY:
                await ws.send_bytes(msg.data[::-1])
        views.append({"ws_closed": ws.close_code})
        return ws

    app = W.Application(client_max_size=1 << 30)
    app.add_routes([W.get("/ui/{tail:.*}", ui), W.get("/big", big), W.post("/echo", echo),
                    W.get("/ws", ws_echo)])
    app.router.add_route("*", "/any/{tail:.*}", ui)
    return app


def front_app(W, proxy, policy, token_key, PolicyConfig, upstream: str):
    """The front: two API routes (the server's 16 MiB client_max_size), then
    the proxy at ``*`` ``/{tail:.*}``, as ``serve_all`` mounts it; with a
    policy pinned to its listener, as a deployment runs it."""
    policies = [PolicyConfig(name="locked", allow=["GET /health"], index_db="stdtest"),
                PolicyConfig(name="open", allow=["* /"])]
    middlewares = [policy.policy_middleware(policy.PolicyEngine(policies), "open",
                                            token_key=token_key)]
    app = W.Application(client_max_size=FRONT_MAX, middlewares=middlewares)

    async def search(request):
        return W.json_response({"api": "pql", "n": len(await request.json())})

    async def health(request):
        return W.json_response({"api": "health"})

    app.add_routes([W.post("/api/search/pql", search), W.get("/health", health)])
    app.router.add_route("*", "/{tail:.*}", proxy.make_upstream_handler(upstream,
                                                                       token_key=token_key))
    return app


class Stack:
    def __init__(self, name):
        self.name = name
        W, self.proxy, self.policy, self.token, self.PolicyConfig, self.UW = STACKS[name]
        self.W = W
        self.key = self.token.TokenKey.from_config(KEY_HEX)
        self.views: list = []
        self.gate = asyncio.Event()
        self.runners = []

    async def start(self, upstream: str | None = None):
        if upstream is None:
            self.upstream_port = await self._serve(self.UW, upstream_app(self.UW, self.views,
                                                                          self.gate))
            upstream = f"http://127.0.0.1:{self.upstream_port}"
        self.port = await self._serve(self.W, front_app(self.W, self.proxy, self.policy, self.key,
                                                        self.PolicyConfig, upstream))
        return self

    async def _serve(self, W, app) -> int:
        runner = W.AppRunner(app)
        await runner.setup()
        await W.TCPSite(runner, "127.0.0.1", 0).start()
        self.runners.append(runner)
        return runner.addresses[0][1]

    async def close(self):
        for runner in reversed(self.runners):
            await runner.cleanup()


@contextlib.asynccontextmanager
async def stacks(upstream: str | None = None):
    made = []
    try:
        for name in STACKS:
            made.append(await Stack(name).start(upstream))
        yield made
    finally:
        for stack in made:
            await stack.close()


# -- a raw HTTP client -------------------------------------------------------

async def _head(reader):
    line = await reader.readline()
    if not line:
        return None, []
    status = int(line.split()[1])
    headers = []
    while (raw := await reader.readline()) not in (b"\r\n", b""):
        name, _, value = raw.decode("latin-1").partition(":")
        headers.append((name.strip().lower(), value.strip()))
    return status, headers


async def _body(reader, headers, method, status):
    h = dict(headers)
    if method == "HEAD" or status in (204, 304):
        return b""
    if "chunked" in h.get("transfer-encoding", ""):
        out = bytearray()
        while True:
            size = int((await reader.readline()).split(b";")[0], 16)
            if size == 0:
                await reader.readline()
                return bytes(out)
            out += await reader.readexactly(size)
            await reader.readexactly(2)
    if "content-length" in h:
        return await reader.readexactly(int(h["content-length"]))
    return await reader.read()


def _request_bytes(method, target, headers=(), body=None):
    lines = [f"{method} {target} HTTP/1.1", "Host: 127.0.0.1", "Connection: close",
             *(f"{k}: {v}" for k, v in headers)]
    if body is not None:
        lines.append(f"Content-Length: {len(body)}")
    return ("\r\n".join(lines) + "\r\n\r\n").encode()


async def http(port, method, target, headers=(), body=None):
    """(status, header pairs, body) of one request on its own connection. A
    large body is written while the answer is read: a server may answer
    (413) before it has read it all."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port, limit=1 << 20)

    async def send():
        writer.write(_request_bytes(method, target, headers, body))
        if body:
            for at in range(0, len(body), 1 << 20):
                writer.write(body[at:at + (1 << 20)])
                await writer.drain()
        await writer.drain()

    sender = asyncio.ensure_future(send())
    try:
        status, got = await _head(reader)
        data = await _body(reader, got, method, status)
    finally:
        sender.cancel()
        with contextlib.suppress(BaseException):
            await sender
        writer.close()
    return status, got, data


def norm(headers) -> list:
    return sorted((k, v) for k, v in headers if k not in DROP)


def parity(results: dict) -> dict:
    """The port stack's results, required equal to the reference stack's."""
    assert results["port"] == results["reference"], (results["port"], results["reference"])
    return results["port"]


# -- HTTP ---------------------------------------------------------------------

def test_forwards_and_guards_loops():
    # Port form of TestProxy.test_forwards_and_guards_loops, with the hop
    # header's other values: one below the cap goes on (and counts up), a
    # malformed one counts as 0.
    cases = [("/ui/page?x=1", ()), ("/ui/a%20b/c?x=1&z=a+b&x=2&e=", ()),
             ("/ui/page", ((HOP, "3"),)), ("/ui/page", ((HOP, "7"),)),
             ("/ui/page", ((HOP, "2"),)), ("/ui/page", ((HOP, "abc"),)),
             ("/ui/page", ((HOP, ""),)), ("/ui/page", ((HOP, "-1"),))]

    async def main():
        out = {}
        async with stacks() as made:
            for stack in made:
                rows = []
                for target, headers in cases:
                    status, got, body = await http(stack.port, "GET", target, headers)
                    rows.append((status, norm(got), json.loads(body)))
                out[stack.name] = (rows, [{k: v for k, v in view.items() if k != "token"}
                                          for view in stack.views])
        return out

    rows, views = parity(run(main()))
    assert rows[0][0] == 200 and rows[0][2]["target"] == "/ui/page?x=1" and rows[0][2]["hop"] == "1"
    assert rows[1][2]["target"] == "/ui/a%20b/c?x=1&z=a+b&x=2&e="
    assert rows[2][:1] == (508,) and rows[2][2] == {"error": "proxy loop detected"}
    assert rows[3][0] == 508
    assert [r[2]["hop"] for r in rows[4:]] == ["3", "1", "1", "0"]
    assert len(views) == 6


def test_percent_encoding_is_forwarded_as_received():
    # The port forwards str(request.rel_url) as the request line had it:
    # the raw path and query in order, percent-encoding kept.
    async def main():
        async with stacks() as made:
            port = next(s for s in made if s.name == "port")
            target = "/ui/%7Euser/%2f/a%2Fb?q=%7e&y=%2F&y=1&z=a+b%20c"
            status, _, body = await http(port.port, "GET", target)
            return status, json.loads(body)["target"]

    assert run(main()) == (200, "/ui/%7Euser/%2f/a%2Fb?q=%7e&y=%2F&y=1&z=a+b%20c")


def test_repeated_cookies_pass_both_ways():
    async def main():
        out = {}
        async with stacks() as made:
            for stack in made:
                status, got, body = await http(stack.port, "GET", "/ui/c",
                                               [("Cookie", "a=1"), ("Cookie", "b=2")])
                out[stack.name] = (status, norm(got), json.loads(body), stack.views[-1]["cookies"])
        return out

    status, headers, body, cookies = parity(run(main()))
    assert status == 200 and cookies == ["a=1", "b=2"] and body["cookies"] == ["a=1", "b=2"]
    assert [v for k, v in headers if k == "set-cookie"] == ["s1=a; Path=/", "s2=b; Path=/"]


def test_proxy_mints_and_strips():
    # Port form of TestProxyMinting: a client's token never passes; the
    # upstream sees a fresh one that the gateway's key verifies to the
    # policy the request matched. A client token the key verifies selects
    # its policy at the gateway (locked: 403 before the proxy); one naming
    # the open policy is minted afresh on the way up (within a second the
    # same text: tokens carry their expiry in seconds).
    async def main():
        out = {}
        async with stacks() as made:
            for stack in made:
                forged = stack.token.TokenKey.from_config(None).mint("locked")
                rows = []
                for tok in (forged, stack.key.mint("open"), stack.key.mint("locked"), None):
                    before = len(stack.views)
                    status, _, _ = await http(stack.port, "GET", "/ui/page",
                                              [(TOKEN, tok)] if tok else [])
                    seen = stack.views[-1]["token"] if len(stack.views) > before else None
                    rows.append((status, seen is not None and seen != forged,
                                 seen and stack.key.verify(seen)))
                out[stack.name] = rows
        return out

    assert parity(run(main())) == [(200, True, "open"), (200, True, "open"), (403, False, None),
                                   (200, True, "open")]


def test_streams_without_buffering():
    # Port form of TestProxy.test_streams_without_buffering: the upstream
    # holds its tail until the client has read the head through the proxy;
    # then a 4 MiB upload echoes back intact.
    payload = np.random.default_rng(0).integers(0, 256, 4 << 20, dtype=np.uint8).tobytes()

    async def main():
        out = {}
        async with stacks() as made:
            for stack in made:
                reader, writer = await asyncio.open_connection("127.0.0.1", stack.port)
                writer.write(_request_bytes("GET", "/big"))
                await writer.drain()
                status, headers = await _head(reader)
                got = bytearray()
                assert "chunked" in dict(headers).get("transfer-encoding", "")
                while len(got) < HEAD_BYTES:
                    size = int((await reader.readline()).split(b";")[0], 16)
                    got += await reader.readexactly(size)
                    await reader.readexactly(2)
                head_seen = len(got)
                stack.gate.set()
                got += await _body(reader, headers, "GET", status)
                writer.close()
                echo = await http(stack.port, "POST", "/echo", body=payload)
                out[stack.name] = (status, norm(headers), head_seen, bytes(got),
                                   echo[0], json.loads(echo[2]))
        return out

    status, _, head_seen, body, echo_status, echo = parity(run(main()))
    assert status == 200 and head_seen == HEAD_BYTES and body == b"A" * HEAD_BYTES + b"B" * HEAD_BYTES
    assert echo_status == 200 and echo == {"length": len(payload),
                                           "sha256": hashlib.sha256(payload).hexdigest()}


def test_upload_past_client_max_size_relays_while_the_api_refuses():
    # A 64 MiB upload relays intact past the front's 16 MiB client_max_size
    # (the proxy streams request.content; the limit holds only where a
    # handler reads the body whole), while an API route with the same limit
    # answers 413. aiohttp's 413 text names the bytes read so far, which
    # depends on how they arrived: the texts compare up to that number.
    payload = np.random.default_rng(1).integers(0, 256, 64 << 20, dtype=np.uint8).tobytes()
    want = {"length": len(payload), "sha256": hashlib.sha256(payload).hexdigest()}

    async def main():
        out = {}
        async with stacks() as made:
            for stack in made:
                relayed = await http(stack.port, "POST", "/echo",
                                     [("Content-Type", "application/octet-stream")], payload)
                refused = await http(stack.port, "POST", "/api/search/pql",
                                     [("Content-Type", "application/json")], payload)
                small = await http(stack.port, "POST", "/api/search/pql",
                                   [("Content-Type", "application/json")], b'{"a": 1}')
                out[stack.name] = (relayed[0], json.loads(relayed[2]), stack.views[-1]["length"],
                                   refused[0], refused[2].split(b", actual")[0],
                                   small[0], json.loads(small[2]))
        return out

    got = parity(run(main()))
    assert got == (200, want, len(payload), 413,
                   b"Maximum request body size 16777216 exceeded", 200, {"api": "pql", "n": 1})


def test_unavailable_upstream_is_502():
    # Port form of TestProxy.test_unavailable_upstream_is_502: the same
    # status and the same body, aiohttp's connector error text included.
    async def main():
        out = {}
        async with stacks(upstream="http://127.0.0.1:9") as made:
            for stack in made:
                status, got, body = await http(stack.port, "GET", "/anything")
                out[stack.name] = (status, norm(got), json.loads(body))
        return out

    status, _, body = parity(run(main()))
    assert status == 502 and body["error"].startswith(
        "upstream unavailable: Cannot connect to host 127.0.0.1:9 ssl:default [")


def test_methods_and_heads_relay_alike():
    # PUT, DELETE and PATCH with and without a body, HEAD (no body back) and
    # OPTIONS reach the upstream alike through both proxies, and a method the
    # upstream's route does not take comes back as its 405.
    async def main():
        out = {}
        async with stacks() as made:
            for stack in made:
                rows = []
                for method, body in (("PUT", b"xyz"), ("DELETE", None), ("PATCH", b""),
                                     ("HEAD", None), ("OPTIONS", None), ("POST", b"")):
                    status, got, data = await http(stack.port, method, "/any/m?k=v", body=body)
                    rows.append((method, status, norm(got), data))
                status, got, data = await http(stack.port, "POST", "/big", body=b"")
                rows.append(("POST /big", status, data))
                out[stack.name] = (rows, [v["method"] for v in stack.views])
        return out

    rows, methods = parity(run(main()))
    assert [r[1] for r in rows] == [200] * 6 + [405]
    assert methods == ["PUT", "DELETE", "PATCH", "HEAD", "OPTIONS", "POST"]
    assert rows[3][3] == b"" and json.loads(rows[0][3])["method"] == "PUT"


def _port_table():
    """The port's served route table with the proxy mounted, as serve_all
    mounts it (``build_app`` stores its state and reads it only in the
    handlers)."""
    from panoptikon_tpu_torch.api.server import build_app

    app = build_app(None)
    upstream = port_proxy.make_upstream_handler("http://127.0.0.1:9")
    app.router.add_route("*", "/{tail:.*}", upstream)
    return app, upstream


SAMPLES = ("x1", "1", "0" * 64, "default", "a/b", "abc.png")


def _sample(resource: port_web.Resource, path: str):
    """A concrete path that ``resource`` matches, its parameters filled."""
    parts = port_web._PARAM.split(path)
    for value in SAMPLES:
        concrete = port_web._PARAM.sub(value, path)
        if resource.match(concrete) is not None:
            return concrete
    raise AssertionError(f"no sample matches {path} ({parts})")


METHODS = ("GET", "HEAD", "POST", "PUT", "DELETE", "PATCH", "OPTIONS")
UNKNOWN = ("/api/nope", "/api/search/nope", "/api/search/pql/extra", "/api/items/x/y/z/w",
           "/", "/ui/x", "/_next/static/a.js", "/health/x", "/api", "/api/")


def test_routing_with_the_proxy_mounted_is_aiohttp_s():
    # Every method on every path of the port's build_app, and unknown /api/
    # paths, reach the same route (or the same 404/405) as aiohttp routes the
    # same table: a path whose routes match only under other methods falls
    # through to the catch-all.
    app, upstream = _port_table()
    routes = app.router.routes()
    tags = {}
    aio = aio_web.Application()
    for k, r in enumerate(routes):
        async def stub(request, k=k):
            return k

        tags[id(r)] = k
        r.handler = stub
        if r.method == "GET":
            aio.router.add_get(r.path, stub)
        else:
            aio.router.add_route(r.method, r.path, stub)
    paths = sorted({_sample(r.resource, r.path) for r in routes if r.handler is not upstream}
                   | set(UNKNOWN))

    async def port_route(method, path):
        request = port_web.Request(app, method, path, "HTTP/1.1", port_web.CIMultiDict())
        handler = app.router.resolve(request)
        try:
            return await handler(request)
        except port_web.HTTPException as exc:
            return exc.status

    async def aio_route(method, path):
        match = await aio.router.resolve(make_mocked_request(method, path, app=aio))
        if match.http_exception is not None:
            return match.http_exception.status
        return await match.handler(None)

    async def main():
        return {(m, p): (await port_route(m, p), await aio_route(m, p))
                for m in METHODS for p in paths}

    got = run(main())
    assert len(got) >= 7 * 70
    differ = {k: v for k, v in got.items() if v[0] != v[1]}
    assert not differ, differ
    catch_all = len(routes) - 1
    # The method mismatches: only POST /api/search/pql reaches the API.
    assert got[("GET", "/api/search/pql")][0] == catch_all
    assert got[("POST", "/api/search/pql")][0] != catch_all
    assert got[("PUT", "/health")][0] == catch_all
    assert got[("GET", "/api/nope")][0] == catch_all


def test_without_a_star_route_answers_stay_404_and_405():
    async def h(request):
        return port_web.json_response({})

    app = port_web.Application()
    app.add_routes([port_web.get("/a", h), port_web.post("/a", h)])

    async def status(method, path):
        request = port_web.Request(app, method, path, "HTTP/1.1", port_web.CIMultiDict())
        try:
            await app.router.resolve(request)(request)
            return 200
        except port_web.HTTPException as exc:
            return exc.status, exc.headers.get("Allow")

    async def main():
        return [await status(m, p) for m, p in (("GET", "/a"), ("PUT", "/a"), ("GET", "/b"))]

    assert run(main()) == [200, (405, "GET,POST"), (404, None)]


# -- WebSockets ---------------------------------------------------------------

def _client_frame(opcode, payload, fin=True):
    """A client frame (masked), written independently of either library."""
    b0 = (0x80 if fin else 0) | opcode
    n = len(payload)
    if n < 126:
        head = struct.pack("!BB", b0, 0x80 | n)
    elif n < 65536:
        head = struct.pack("!BBH", b0, 0x80 | 126, n)
    else:
        head = struct.pack("!BBQ", b0, 0x80 | 127, n)
    mask = os.urandom(4)
    body = np.frombuffer(payload, np.uint8) ^ np.resize(np.frombuffer(mask, np.uint8), n)
    return head + mask + body.tobytes()


async def _server_frame(reader):
    b0, b1 = await reader.readexactly(2)
    assert not b1 & 0x80, "a server's frames are not masked"
    n = b1 & 0x7F
    if n == 126:
        n = struct.unpack("!H", await reader.readexactly(2))[0]
    elif n == 127:
        n = struct.unpack("!Q", await reader.readexactly(8))[0]
    return b0 >> 7, b0 & 0x0F, await reader.readexactly(n)


async def _ws_open(port, protocols="other, chat"):
    reader, writer = await asyncio.open_connection("127.0.0.1", port, limit=1 << 22)
    key = base64.b64encode(os.urandom(16)).decode()
    writer.write((f"GET /ws HTTP/1.1\r\nHost: 127.0.0.1\r\nUpgrade: websocket\r\n"
                  f"Connection: Upgrade\r\nSec-WebSocket-Key: {key}\r\n"
                  f"Sec-WebSocket-Version: 13\r\nSec-WebSocket-Protocol: {protocols}\r\n\r\n"
                  ).encode())
    await writer.drain()
    status, headers = await _head(reader)
    accept = base64.b64encode(hashlib.sha1(
        (key + "258EAFA5-E914-47DA-95CA-C5AB0DC85B11").encode()).digest()).decode()
    assert dict(headers)["sec-websocket-accept"] == accept
    return reader, writer, status, [h for h in norm(headers) if h[0] != "sec-websocket-accept"]


def test_websocket_bridging_with_each_library_s_client():
    # Port form of TestProxy.test_websocket_bridging. The port's stack is
    # driven by aiohttp's client and the reference's by the port's, so every
    # pairing of a client and a server end across the two libraries occurs
    # (each bridge dials its upstream with its own library's client).
    async def main():
        out = {}
        async with stacks() as made:
            for stack in made:
                session = (AioClientSession() if stack.name == "port"
                           else web_client.ClientSession())
                async with session:
                    ws = await session.ws_connect(f"http://127.0.0.1:{stack.port}/ws",
                                                  protocols=("chat",))
                    await ws.send_str("hello")
                    text = (await ws.receive(timeout=10)).data
                    await ws.send_bytes(b"abc")
                    data = (await ws.receive(timeout=10)).data
                    protocol = ws.protocol
                    await ws.close()
                for _ in range(100):
                    if "ws_closed" in stack.views[-1]:
                        break
                    await asyncio.sleep(0.02)
                out[stack.name] = (text, data, protocol, stack.views)
        return out

    text, data, protocol, views = parity(run(main()))
    assert (text, data, protocol) == ("echo:hello", b"cba", "chat")
    assert views == [{"ws": "/ws", "hop": "1", "protocol": "chat"}, {"ws_closed": 1000}]


def test_websocket_fragments_ping_close_and_subprotocol():
    # Raw frames through both bridges: a text message in three fragments and
    # a binary one in two (a ping between them), answered whole; the ping
    # answered by the front with its payload; the client's close code 4001
    # answered by the front (aiohttp's bridge closes each side with 1000) and
    # carried to the upstream as the bridge closes it; the subprotocol the
    # front chose from the client's offer and the one the upstream chose
    # from the bridge's.
    async def main():
        out = {}
        async with stacks() as made:
            for stack in made:
                reader, writer, status, headers = await _ws_open(stack.port)
                writer.write(_client_frame(1, b"he", fin=False) + _client_frame(0, b"ll", fin=False)
                             + _client_frame(0, b"o"))
                text = await _server_frame(reader)
                writer.write(_client_frame(2, b"\x01\x02", fin=False) + _client_frame(9, b"pp")
                             + _client_frame(0, b"\x03"))
                pong = await _server_frame(reader)
                binary = await _server_frame(reader)
                writer.write(_client_frame(9, b"ping-data"))
                pong2 = await _server_frame(reader)
                writer.write(_client_frame(8, struct.pack("!H", 4001) + b"bye"))
                close = await _server_frame(reader)
                tail = await reader.read()
                writer.close()
                for _ in range(100):
                    if "ws_closed" in stack.views[-1]:
                        break
                    await asyncio.sleep(0.02)
                out[stack.name] = (status, headers, text, pong, binary, pong2, close, tail,
                                   stack.views)
        return out

    status, headers, text, pong, binary, pong2, close, tail, views = parity(run(main()))
    assert status == 101 and ("sec-websocket-protocol", "other") in headers
    assert text == (1, 1, b"echo:hello") and binary == (1, 2, b"\x03\x02\x01")
    assert pong == (1, 10, b"pp") and pong2 == (1, 10, b"ping-data")
    assert close == (1, 8, struct.pack("!H", 1000)) and tail == b""
    assert views == [{"ws": "/ws", "hop": "1", "protocol": "chat"}, {"ws_closed": 1000}]


def test_websocket_hop_guard_and_plain_get():
    # The bridge dials with the hop header counted up; at the cap the front
    # answers 508 before the upgrade.
    async def main():
        out = {}
        async with stacks() as made:
            for stack in made:
                status, got, body = await http(stack.port, "GET", "/ws", [
                    (HOP, "3"), ("Upgrade", "websocket"), ("Sec-WebSocket-Key", "x"),
                    ("Sec-WebSocket-Version", "13")])
                out[stack.name] = (status, json.loads(body))
        return out

    assert parity(run(main())) == (508, {"error": "proxy loop detected"})


@settings(max_examples=6, deadline=None, derandomize=True)
@given(size=st.sampled_from([0, 127, 65535, 65537]) | st.integers(0, 1 << 20))
@example(size=125)
@example(size=126)
@example(size=65536)
@example(size=1 << 20)
def test_websocket_message_sizes(size):
    # 7-, 16- and 64-bit lengths both ways through both bridges, up to 1 MiB.
    payload = np.random.default_rng(size).integers(0, 256, size, dtype=np.uint8).tobytes()
    text = "é" * (size // 2)

    async def main():
        out = {}
        async with stacks() as made:
            for stack in made:
                reader, writer, _, _ = await _ws_open(stack.port, "chat")
                writer.write(_client_frame(2, payload))
                binary = await _server_frame(reader)
                writer.write(_client_frame(1, text.encode()))
                echoed = await _server_frame(reader)
                writer.write(_client_frame(8, struct.pack("!H", 1000)))
                await _server_frame(reader)
                writer.close()
                out[stack.name] = (binary[:2], binary[2] == payload[::-1],
                                   echoed[2] == f"echo:{text}".encode())
        return out

    assert parity(run(main())) == ((1, 2), True, True)


def test_websocket_past_the_message_limit_closes_with_1009():
    # aiohttp's 4 MiB max_msg_size on the front's end: a larger message
    # closes the socket with 1009, on both.
    async def main():
        out = {}
        async with stacks() as made:
            for stack in made:
                reader, writer, _, _ = await _ws_open(stack.port, "chat")
                writer.write(_client_frame(2, b"x" * ((4 << 20) + 1)))
                fin, opcode, data = await _server_frame(reader)
                writer.close()
                out[stack.name] = (opcode, struct.unpack("!H", data[:2])[0])
        return out

    assert parity(run(main())) == (8, 1009)


# -- the client half against aiohttp's server ---------------------------------

def test_client_streams_redirects_and_decompresses():
    # The port's ClientSession against an aiohttp server: a streamed upload
    # goes chunked, a redirect is followed unless asked not to, a gzip body is
    # inflated with auto_decompress and passed through without it, and
    # repeated response headers stay.
    import gzip

    seen = []

    async def echo(request):
        data = await request.read()
        seen.append((request.headers.get("Transfer-Encoding"), len(data)))
        return aio_web.Response(body=hashlib.sha256(data).hexdigest().encode())

    async def moved(request):
        return aio_web.Response(status=302, headers={"Location": "/zipped"})

    async def zipped(request):
        return aio_web.Response(body=gzip.compress(b"inflated " * 100),
                                headers=[("Content-Encoding", "gzip"), ("X-Two", "1"),
                                         ("X-Two", "2")])

    async def main():
        app = aio_web.Application(client_max_size=1 << 26)
        app.add_routes([aio_web.post("/echo", echo), aio_web.get("/moved", moved),
                        aio_web.get("/zipped", zipped)])
        runner = aio_web.AppRunner(app)
        await runner.setup()
        await aio_web.TCPSite(runner, "127.0.0.1", 0).start()
        base = f"http://127.0.0.1:{runner.addresses[0][1]}"
        payload = os.urandom(3 << 20)

        async def pieces():
            for at in range(0, len(payload), 1 << 18):
                yield payload[at:at + (1 << 18)]

        try:
            async with web_client.ClientSession() as session:
                async with session.post(base + "/echo", data=pieces()) as resp:
                    streamed = await resp.read()
                resp = await session.request("POST", base + "/echo", data=payload)
                whole = await resp.read()
                resp.release()
                async with session.get(base + "/moved") as resp:
                    followed = (resp.status, await resp.read(), resp.headers.getall("X-Two"))
                async with session.get(base + "/moved", allow_redirects=False) as resp:
                    kept = (resp.status, resp.headers["Location"])
                pool = sum(len(c) for c in session._pool.values())
            async with web_client.ClientSession(auto_decompress=False) as session:
                async with session.get(base + "/zipped") as resp:
                    raw = await resp.read()
        finally:
            await runner.cleanup()
        return streamed, whole, followed, kept, raw, pool, hashlib.sha256(payload).hexdigest()

    streamed, whole, followed, kept, raw, pool, digest = run(main())
    assert streamed == whole == digest.encode()
    assert seen == [("chunked", 3 << 20), (None, 3 << 20)]
    assert followed == (200, b"inflated " * 100, ["1", "2"]) and kept == (302, "/zipped")
    assert gzip.decompress(raw) == b"inflated " * 100
    assert pool == 1  # one keep-alive connection served every request


def test_client_params_encode_as_aiohttp_s():
    # params= go on the URL in aiohttp's encoding (yarl's), after the URL's
    # own query; the path's characters that cannot stand on a request line
    # are percent-encoded as aiohttp does.
    chars = "".join(chr(c) for c in range(32, 127)) + "é☃"
    cases = [("/q", {"k": chars, chars: "v"}), ("/api/y?pre=1", {"a": "1", "b": "x y"}),
             ("/q a/é", {"x": 3, "y": 2.5}), ("/q", {})]
    seen = {"port": [], "aiohttp": []}

    async def main():
        async def h(request):
            seen[request.headers["X-Who"]].append(request.raw_path)
            return aio_web.Response(text="ok")

        app = aio_web.Application()
        app.router.add_route("*", "/{t:.*}", h)
        runner = aio_web.AppRunner(app)
        await runner.setup()
        await aio_web.TCPSite(runner, "127.0.0.1", 0).start()
        base = f"http://127.0.0.1:{runner.addresses[0][1]}"
        try:
            for who, session in (("port", web_client.ClientSession()),
                                 ("aiohttp", AioClientSession())):
                async with session:
                    for path, params in cases:
                        async with session.get(base + path, params=params,
                                               headers={"X-Who": who}) as resp:
                            await resp.read()
        finally:
            await runner.cleanup()

    run(main())
    assert seen["port"] == seen["aiohttp"] and len(seen["port"]) == len(cases)


def test_client_reads_an_answer_given_before_the_body_was_taken():
    # A server that answers 413 once client_max_size bytes have come, and
    # closes: the port's client writes the body while it reads, as aiohttp's
    # does, so both see the 413 (not a broken pipe), on the port's server.
    async def up(request):
        return port_web.json_response({"n": len(await request.read())})

    async def main():
        app = port_web.Application(client_max_size=1 << 20)
        app.add_routes([port_web.post("/up", up)])
        runner = port_web.AppRunner(app)
        await runner.setup()
        await port_web.TCPSite(runner, "127.0.0.1", 0).start()
        url = f"http://127.0.0.1:{runner.addresses[0][1]}/up"
        out = []
        try:
            for session in (web_client.ClientSession(), AioClientSession()):
                async with session:
                    for body in (os.urandom(8 << 20), b"x" * 10):
                        async with session.post(url, data=body) as resp:
                            out.append((resp.status, (await resp.read())[:40]))
        finally:
            await runner.cleanup()
        return out

    port, aio = (lambda r: (r[:2], r[2:]))(run(main()))
    assert port == aio == [(413, b"Maximum request body size 1048576 exceed"), (200, b'{"n": 10}')]
