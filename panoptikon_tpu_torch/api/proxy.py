"""Reverse proxy for UI / external upstreams, on the port's own transport.

The port's copy of ``panoptikon_tpu/api/proxy.py``, held to it unit for
unit by ``tests/test_torch_host_copies.py``: the server half is
``api/web.py``, the client half ``api/web_client.py`` (the card machine has
no ``aiohttp``), and ``CIMultiDict`` is the transport's. The forwarded
target is ``str(request.rel_url)``: the raw path and query in order, their
percent-encoding kept.

The reference fronts its Next.js UI and remote inference servers with a
hyper-based reverse proxy (src/proxy.rs): any path not claimed by the API
forwards to the configured upstream, with hop-by-hop headers stripped, a
loop guard, and WebSocket Upgrade bridging (dev-mode UI servers use WS for
hot reload; the bridge pumps frames both directions until either side
closes)."""

from __future__ import annotations

import asyncio

from panoptikon_tpu_torch.api import web
from panoptikon_tpu_torch.api.web import WSMsgType
from panoptikon_tpu_torch.api.web_client import ClientSession, ClientTimeout

HOP_HEADERS = {
    "connection", "keep-alive", "proxy-authenticate", "proxy-authorization",
    "te", "trailers", "transfer-encoding", "upgrade", "host",
    "content-length",
}
LOOP_GUARD_HEADER = "X-Panoptikon-Proxy-Hop"
MAX_HOPS = 3


def _hops(request) -> int:
    """Loop-guard hop count; a malformed (client-supplied) header counts
    as 0 rather than 500ing the request."""
    try:
        return int(request.headers.get(LOOP_GUARD_HEADER, "0"))
    except ValueError:
        return 0


def make_upstream_handler(upstream: str, token_key=None):
    """A catch-all handler forwarding to ``upstream`` (e.g. the UI server).

    Mount with ``app.router.add_route('*', '/{tail:.*}', handler)`` AFTER
    the API routes so the API always wins.

    With ``token_key`` set, every forwarded request carries a freshly
    minted SSR policy token naming the policy the gateway matched for it
    (api/policy_token.py); any client-supplied token header is stripped
    first — the browser must never be able to smuggle one through.
    """
    from panoptikon_tpu_torch.api.policy_token import POLICY_TOKEN_HEADER

    upstream = upstream.rstrip("/")

    async def handler(request: web.Request) -> web.StreamResponse:
        hops = _hops(request)
        if hops >= MAX_HOPS:
            return web.json_response({"error": "proxy loop detected"}, status=508)
        if (
            request.headers.get("Upgrade", "").lower() == "websocket"
            and "upgrade" in request.headers.get("Connection", "").lower()
        ):
            return await _bridge_websocket(request, upstream)
        target = f"{upstream}{request.rel_url}"
        # CIMultiDict, not a plain dict: duplicate headers (Cookie,
        # Accept-*) must all forward, not collapse to the last one.
        from panoptikon_tpu_torch.api.web import CIMultiDict

        headers = CIMultiDict(
            (k, v) for k, v in request.headers.items()
            if k.lower() not in HOP_HEADERS
            and k.lower() != POLICY_TOKEN_HEADER
        )
        headers[LOOP_GUARD_HEADER] = str(hops + 1)
        if token_key is not None and request.get("policy_name"):
            headers[POLICY_TOKEN_HEADER] = token_key.mint(
                request["policy_name"]
            )
        # Stream both directions (proxy.rs streams via hyper bodies): the
        # request body forwards as the socket's StreamReader and the
        # response is relayed chunk-by-chunk — a multi-GB file or UI asset
        # pass-through never materializes in proxy memory.
        body = request.content if request.can_read_body else None
        timeout = ClientTimeout(total=None, sock_connect=30, sock_read=120)
        session = ClientSession(timeout=timeout, auto_decompress=False)
        try:
            resp = await session.request(
                request.method, target, headers=headers, data=body,
                allow_redirects=False,
            )
        except Exception as exc:
            await session.close()
            return web.json_response(
                {"error": f"upstream unavailable: {exc}"}, status=502
            )
        try:
            from panoptikon_tpu_torch.api.web import CIMultiDict

            out = web.StreamResponse(
                status=resp.status,
                # Preserve duplicates: collapsing would drop all but the
                # last Set-Cookie and break upstream sessions.
                headers=CIMultiDict(
                    (k, v) for k, v in resp.headers.items()
                    if k.lower() not in HOP_HEADERS
                ),
            )
            await out.prepare(request)
            async for chunk in resp.content.iter_chunked(1 << 16):
                await out.write(chunk)
            await out.write_eof()
            return out
        finally:
            resp.release()
            await session.close()

    return handler


async def _bridge_websocket(request: web.Request, upstream: str) -> web.StreamResponse:
    """Accept the client WS, dial the upstream WS, pump frames both ways
    until either side closes (proxy.rs Upgrade bridging). The hop counter
    rides the dial so WS loops 508 like HTTP ones; the client's requested
    subprotocols forward."""
    hops = _hops(request)
    if hops >= MAX_HOPS:
        return web.json_response({"error": "proxy loop detected"}, status=508)
    ws_url = upstream.replace("http://", "ws://").replace("https://", "wss://")
    target = f"{ws_url}{request.rel_url}"
    protocols = tuple(
        p.strip()
        for p in request.headers.get("Sec-WebSocket-Protocol", "").split(",")
        if p.strip()
    )
    server_ws = web.WebSocketResponse(protocols=protocols)
    await server_ws.prepare(request)
    try:
        async with ClientSession() as session:
            async with session.ws_connect(
                target,
                protocols=protocols,
                headers={LOOP_GUARD_HEADER: str(hops + 1)},
            ) as client_ws:

                async def pump(src, dst):
                    async for msg in src:
                        if msg.type == WSMsgType.TEXT:
                            await dst.send_str(msg.data)
                        elif msg.type == WSMsgType.BINARY:
                            await dst.send_bytes(msg.data)
                        elif msg.type in (WSMsgType.CLOSE, WSMsgType.CLOSING,
                                          WSMsgType.ERROR):
                            break
                    await dst.close()

                await asyncio.gather(
                    pump(server_ws, client_ws), pump(client_ws, server_ws),
                    return_exceptions=True,
                )
    except Exception:
        await server_ws.close()
    return server_ws
