"""The port's HTTP client: the subset of ``aiohttp``'s client that the
reverse proxy (``api/proxy.py``) and the async client (``aclient.py``) use,
on ``asyncio.open_connection``.

The card machine has no ``aiohttp``, so the port keeps its names and
signatures here, beside its server half (``api/web.py``, whose body stream,
header mapping and WebSocket frame codec this module shares):

- ``ClientTimeout(total, sock_connect, sock_read)``;
- ``ClientSession(timeout=, auto_decompress=)``, an async context manager
  with a keep-alive pool per (scheme, host, port);
- ``session.request(method, url, params=, json=, data=, headers=,
  allow_redirects=)``, awaitable and an async context manager, and
  ``get``/``post``;
- the response's ``.status``, ``.reason``, ``.headers`` (every value of a
  repeated name), ``.read()``, ``.json()``,
  ``.content.iter_chunked(n)`` and ``.release()``;
- ``session.ws_connect(url, protocols=, headers=)``: a WebSocket whose
  frames are masked, with the server end's message surface.

A request carries aiohttp's default headers where the caller set none
(``Accept: */*``, ``Accept-Encoding: gzip, deflate``, a ``User-Agent``),
and its body as aiohttp frames it: ``json=`` as ``application/json``,
bytes with their length, a stream (``readany()``, or async iteration)
chunked, and an empty body under ``POST``, ``PUT``, ``PATCH`` and
``DELETE`` as ``Content-Length: 0``. ``params=`` go after the URL's own
query in aiohttp's encoding. A response body comes by ``Content-Length``,
chunked or until the connection closes; with ``auto_decompress`` a gzip or
deflate body is inflated, without it passed through untouched. Redirects
(301, 302, 303, 307, 308) are followed unless ``allow_redirects=False``.
``https://`` and ``wss://`` go through the standard library's default
``ssl`` context.
"""

from __future__ import annotations

import asyncio
import base64
import json as jsonlib
import os
import ssl as ssllib
import sys
import zlib
from dataclasses import dataclass
from typing import Any, Mapping, Optional
from urllib.parse import quote, urljoin, urlsplit

from panoptikon_tpu_torch.api import web

USER_AGENT = f"Python/{sys.version_info[0]}.{sys.version_info[1]} panoptikon_tpu_torch"
DEFAULT_PORTS = {"http": 80, "https": 443, "ws": 80, "wss": 443}
_BODYLESS_METHODS = {"GET", "HEAD", "OPTIONS", "CONNECT", "TRACE"}
_POST_METHODS = {"POST", "PUT", "PATCH"}
MAX_REDIRECTS = 10
# aiohttp's query encoding (yarl's): these stay as they are, a space is "+".
_QUERY_SAFE = "!$'()*,/:?@~"


class ClientError(Exception):
    pass


class ClientConnectionError(ClientError, OSError):
    pass


class ClientConnectorError(ClientConnectionError):
    """The connection to the host could not be made (aiohttp's text)."""

    def __init__(self, host: str, port: int, os_error: OSError):
        super().__init__(os_error.errno, os_error.strerror or str(os_error))
        self.host, self.port, self.os_error = host, port, os_error

    def __str__(self) -> str:
        return (f"Cannot connect to host {self.host}:{self.port} ssl:default "
                f"[{self.os_error.strerror or self.os_error}]")


class ServerDisconnectedError(ClientConnectionError):
    def __init__(self, message: str = "Server disconnected"):
        super().__init__(message)
        self.message = message

    def __str__(self) -> str:
        return self.message


class ServerTimeoutError(ClientConnectionError, asyncio.TimeoutError):
    pass


class ClientPayloadError(ClientError):
    pass


class InvalidURL(ClientError, ValueError):
    pass


class WSServerHandshakeError(ClientError):
    def __init__(self, status: int, message: str):
        super().__init__(f"{status}, message={message!r}")
        self.status, self.message = status, message


@dataclass(frozen=True)
class ClientTimeout:
    """Seconds: ``total`` for a whole request (its body read included),
    ``sock_connect`` to open a socket, ``sock_read`` between two reads.
    None: no limit."""

    total: Optional[float] = None
    sock_read: Optional[float] = None
    sock_connect: Optional[float] = None


DEFAULT_TIMEOUT = ClientTimeout(total=300, sock_connect=30)  # aiohttp's


def _quote_query(text: str) -> str:
    return quote(text, safe=_QUERY_SAFE).replace("%20", "+")


def encode_params(params) -> str:
    """``params`` (a mapping or pairs) as aiohttp puts them on a URL."""
    pairs = params.items() if hasattr(params, "items") else params
    out = []
    for key, value in pairs:
        if isinstance(value, bool) or not isinstance(value, (str, int, float)):
            raise TypeError(f"Invalid variable type: value should be str, int or float, "
                            f"got {value!r} of type {type(value)}")
        out.append(f"{_quote_query(str(key))}={_quote_query(str(value))}")
    return "&".join(out)


class _Target:
    """A URL split as a request needs it: scheme, host, port and the
    request target (path and query as given, characters that may not stand
    on a request line percent-encoded, encodings already there kept)."""

    def __init__(self, url: str, params=None):
        parts = urlsplit(url)
        if parts.scheme not in DEFAULT_PORTS or not parts.hostname:
            raise InvalidURL(url)
        self.url = url
        self.scheme = parts.scheme
        self.host = parts.hostname
        self.port = parts.port or DEFAULT_PORTS[parts.scheme]
        self.tls = parts.scheme in ("https", "wss")
        path = quote(parts.path or "/", safe="/%!$&'()*+,;=:@~")
        query = quote(parts.query.replace(" ", "+"), safe="%=&!$'()*+,;:@/?~")
        if params:
            extra = encode_params(params)
            query = f"{query}&{extra}" if query and extra else (query or extra)
        self.target = path + (f"?{query}" if query else "")
        default = self.port == DEFAULT_PORTS[self.scheme]
        host = f"[{self.host}]" if ":" in self.host else self.host
        self.host_header = host if default else f"{host}:{self.port}"
        self.key = (self.scheme in ("https", "wss"), self.host, self.port)


class _Conn:
    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter, key):
        self.reader, self.writer, self.key = reader, writer, key
        self.reused = False

    def close(self) -> None:
        self.writer.close()


class _Deadline:
    """The limits of one request: its total deadline and the per-read one."""

    def __init__(self, timeout: ClientTimeout):
        loop = asyncio.get_running_loop()
        self.timeout = timeout
        self.at = None if timeout.total is None else loop.time() + timeout.total

    def left(self, limit: Optional[float]) -> Optional[float]:
        if self.at is None:
            return limit
        rest = max(self.at - asyncio.get_running_loop().time(), 0.0)
        return rest if limit is None else min(rest, limit)

    async def run(self, coro, limit: Optional[float], error=asyncio.TimeoutError):
        wait = self.left(limit)
        if wait is None:
            return await coro
        try:
            return await asyncio.wait_for(coro, wait)
        except asyncio.TimeoutError:
            raise error() from None


class _Inflate(web.StreamReader):
    """A body stream whose bytes are gzip or deflate, read inflated."""

    def __init__(self, stream: web.StreamReader, encoding: str):
        super().__init__(stream)
        # gzip: a gzip header; deflate: a zlib header (or none, as some send).
        self._z = zlib.decompressobj(wbits=31 if encoding == "gzip" else 15)
        self._raw_fallback = encoding == "deflate"

    async def _next(self) -> bytes:
        while not self._eof:
            chunk = await self._reader.readany()
            if not chunk:
                self._finish()
                return self._z.flush()
            try:
                out = self._z.decompress(chunk)
            except zlib.error:
                if not self._raw_fallback:
                    raise ClientPayloadError("Can not decode content-encoding: gzip")
                self._z, self._raw_fallback = zlib.decompressobj(wbits=-15), False
                out = self._z.decompress(chunk)
            if out:
                return out
        return b""


class ClientResponse:
    """A response whose body is read from the connection as asked; once the
    body has been read to its end the connection goes back to the pool."""

    def __init__(self, method: str, url: str, status: int, reason: str, version: str,
                 headers: web.CIMultiDict):
        self.method, self.url = method, url
        self.status, self.reason, self.version = status, reason, version
        self.headers = headers
        self.content: Any = None
        self._body: Optional[bytes] = None
        self._conn: Optional[_Conn] = None
        self._session: Optional["ClientSession"] = None
        self._reusable = False
        self._sending: Optional[asyncio.Future] = None  # the request body's writer

    def _attach(self, session: "ClientSession", conn: _Conn, stream: web.StreamReader,
                reusable: bool, inflate: Optional[str]) -> None:
        self._session, self._conn, self._reusable = session, conn, reusable
        self.content = _Inflate(stream, inflate) if inflate else stream

    def _body_ended(self) -> None:
        conn, self._conn = self._conn, None
        if conn is None:
            return
        sent = self._sending is None or (self._sending.done() and not self._sending.cancelled()
                                         and self._sending.exception() is None)
        if self._reusable and sent and self._session is not None:
            self._session._put(conn)
        else:
            self._stop_sending()
            conn.close()

    def _stop_sending(self) -> None:
        if self._sending is not None and not self._sending.done():
            self._sending.cancel()

    async def read(self) -> bytes:
        if self._body is None:
            try:
                self._body = await self.content.read()
            except web.PayloadError as exc:
                self.close()
                raise ClientPayloadError(str(exc.reason)) from None
        return self._body

    async def json(self) -> Any:
        charset = web._charset(self.headers.get("Content-Type", "")) or "utf-8"
        return jsonlib.loads((await self.read()).decode(charset))

    def release(self) -> None:
        """Give the connection back if the body was read to its end, else
        close it (what is left of the body is never read)."""
        if self._conn is not None:
            self.close()

    def close(self) -> None:
        self._stop_sending()
        conn, self._conn = self._conn, None
        if conn is not None:
            conn.close()

    async def __aenter__(self) -> "ClientResponse":
        return self

    async def __aexit__(self, *exc) -> None:
        self.release()


class _RequestContext:
    """``session.request(...)``: awaitable, or ``async with``."""

    def __init__(self, coro):
        self._coro = coro
        self._resp = None

    def __await__(self):
        return self._coro.__await__()

    async def __aenter__(self):
        self._resp = await self._coro
        return self._resp

    async def __aexit__(self, *exc) -> None:
        self._resp.release()


class ClientWebSocketResponse(web._WebSocket):
    """The client's end of a WebSocket: masked frames out, the server end's
    message surface (``receive``, ``async for``, ``send_str``,
    ``send_bytes``, ``close``)."""

    def __init__(self, protocol: Optional[str], response: ClientResponse):
        super().__init__()
        self.protocol = protocol
        self._response = response

    async def __aenter__(self) -> "ClientWebSocketResponse":
        return self

    async def __aexit__(self, *exc) -> None:
        await self.close()


class _WSContext:
    def __init__(self, coro):
        self._coro = coro
        self._ws = None

    def __await__(self):
        return self._coro.__await__()

    async def __aenter__(self):
        self._ws = await self._coro
        return self._ws

    async def __aexit__(self, *exc) -> None:
        await self._ws.close()


class ClientSession:
    """Requests over pooled keep-alive connections (``aiohttp.ClientSession``'s
    surface as ``api/proxy.py`` and ``aclient.py`` use it)."""

    def __init__(self, *, timeout: Optional[ClientTimeout] = None, auto_decompress: bool = True):
        self._timeout = timeout or DEFAULT_TIMEOUT
        self._auto_decompress = auto_decompress
        self._pool: dict[tuple, list[_Conn]] = {}
        self._closed = False
        self._ssl: Optional[ssllib.SSLContext] = None

    @property
    def closed(self) -> bool:
        return self._closed

    async def close(self) -> None:
        self._closed = True
        for conns in self._pool.values():
            for conn in conns:
                conn.close()
        self._pool.clear()

    async def __aenter__(self) -> "ClientSession":
        return self

    async def __aexit__(self, *exc) -> None:
        await self.close()

    def _put(self, conn: _Conn) -> None:
        if self._closed or conn.writer.is_closing():
            conn.close()
            return
        conn.reused = True
        self._pool.setdefault(conn.key, []).append(conn)

    def _ssl_context(self) -> ssllib.SSLContext:
        if self._ssl is None:
            self._ssl = ssllib.create_default_context()
        return self._ssl

    async def _connect(self, target: _Target, deadline: _Deadline, *, pooled: bool) -> _Conn:
        if pooled:
            idle = self._pool.get(target.key, [])
            while idle:
                conn = idle.pop()
                if not conn.writer.is_closing() and not conn.reader.at_eof():
                    return conn
                conn.close()
        try:
            reader, writer = await deadline.run(
                asyncio.open_connection(target.host, target.port,
                                        ssl=self._ssl_context() if target.tls else None,
                                        limit=1 << 16),
                deadline.timeout.sock_connect, ServerTimeoutError)
        except OSError as exc:
            if isinstance(exc, ClientError):
                raise
            raise ClientConnectorError(target.host, target.port, exc) from exc
        return _Conn(reader, writer, target.key)

    def request(self, method: str, url: str, **kwargs) -> _RequestContext:
        return _RequestContext(self._request(method, url, **kwargs))

    def get(self, url: str, **kwargs) -> _RequestContext:
        return self.request("GET", url, **kwargs)

    def post(self, url: str, **kwargs) -> _RequestContext:
        return self.request("POST", url, **kwargs)

    async def _request(self, method: str, url: str, *, params=None, data=None, json=None,
                       headers=None, allow_redirects: bool = True,
                       timeout: Optional[ClientTimeout] = None) -> ClientResponse:
        if self._closed:
            raise RuntimeError("Session is closed")
        if data is not None and json is not None:
            raise ValueError("data and json parameters can not be used at the same time")
        method = method.upper()
        deadline = _Deadline(timeout or self._timeout)
        sent = web.CIMultiDict(headers)
        if json is not None:
            data = jsonlib.dumps(json).encode()
            sent.setdefault("Content-Type", "application/json")
        elif isinstance(data, str):
            data = data.encode()
            sent.setdefault("Content-Type", "text/plain; charset=utf-8")
        for _ in range(MAX_REDIRECTS + 1):
            target = _Target(url, params)
            resp = await self._send(method, target, sent, data, deadline)
            location = resp.headers.get("Location")
            if not allow_redirects or resp.status not in (301, 302, 303, 307, 308) or not location:
                return resp
            await resp.read()
            resp.release()
            if resp.status == 303 or (resp.status in (301, 302) and method == "POST"):
                if method != "HEAD":
                    method = "GET"
                data = None
                for name in ("Content-Type", "Content-Length"):
                    sent.pop(name, None)
            url, params = urljoin(target.url, location), None
        raise ClientError(f"Too many redirects: {url}")

    async def _send(self, method: str, target: _Target, headers: web.CIMultiDict, data,
                    deadline: _Deadline) -> ClientResponse:
        """One request on one connection. As in aiohttp the body is written
        while the answer is read: a server may answer (413) before it has
        taken the whole body; the connection is then not reused. A write
        that fails before any answer fails the request."""
        streamed = data is not None and not isinstance(data, (bytes, bytearray, memoryview))
        # A reused connection the server closed meanwhile fails before any
        # byte of the answer: once, a fresh one is tried (never for a stream,
        # whose bytes are gone).
        for attempt in (0, 1):
            conn = await self._connect(target, deadline, pooled=attempt == 0)
            sending = asyncio.ensure_future(
                deadline.run(self._write_request(conn, method, target, headers, data), None))
            reading = asyncio.ensure_future(self._read_response(conn, method, target, deadline))
            try:
                done, _ = await asyncio.wait({sending, reading},
                                             return_when=asyncio.FIRST_COMPLETED)
                if reading not in done and sending.exception() is not None:
                    raise sending.exception()
                resp = await reading
            except (ConnectionError, asyncio.IncompleteReadError, ServerDisconnectedError) as exc:
                await _cancel(sending, reading)
                conn.close()
                if attempt or not conn.reused or streamed:
                    if isinstance(exc, ClientError):
                        raise
                    raise ServerDisconnectedError() from exc
                continue
            except BaseException:
                await _cancel(sending, reading)
                conn.close()
                raise
            resp._sending = sending
            if resp.content.at_eof():
                resp._body_ended()  # a bodiless answer: the connection is free now
            return resp
        raise AssertionError("unreachable")

    async def _write_request(self, conn: _Conn, method: str, target: _Target,
                             headers: web.CIMultiDict, data) -> None:
        out = web.CIMultiDict([("Host", target.host_header)])
        out.extend(headers.items())
        for name, value in (("Accept", "*/*"), ("Accept-Encoding", "gzip, deflate"),
                            ("User-Agent", USER_AGENT)):
            if name not in out:
                out[name] = value
        streamed = data is not None and not isinstance(data, (bytes, bytearray, memoryview))
        for name in ("Content-Length", "Transfer-Encoding"):
            out.pop(name, None)
        if streamed:
            out["Transfer-Encoding"] = "chunked"
        elif data is not None or method not in _BODYLESS_METHODS:
            out["Content-Length"] = str(len(data or b""))
        if method in _POST_METHODS and "Content-Type" not in out:
            out["Content-Type"] = "application/octet-stream"
        lines = [f"{method} {target.target} HTTP/1.1\r\n"]
        lines += [f"{name}: {value}\r\n" for name, value in out.items()]
        conn.writer.write(("".join(lines) + "\r\n").encode("latin-1"))
        if streamed:
            async for chunk in _iterate(data):
                if chunk:
                    conn.writer.write(b"%x\r\n" % len(chunk))
                    conn.writer.write(chunk)
                    conn.writer.write(b"\r\n")
                    await conn.writer.drain()
            conn.writer.write(b"0\r\n\r\n")
        elif data:
            conn.writer.write(bytes(data))
        await conn.writer.drain()

    async def _read_response(self, conn: _Conn, method: str, target: _Target,
                             deadline: _Deadline) -> ClientResponse:
        sock_read = deadline.timeout.sock_read
        while True:
            line = await deadline.run(conn.reader.readline(), sock_read, ServerTimeoutError)
            if not line:
                raise ServerDisconnectedError()
            try:
                version, status, reason = (line.decode("latin-1").rstrip("\r\n").split(" ", 2)
                                           + [""])[:3]
                status = int(status)
            except ValueError:
                raise ClientError(f"bad status line {line[:80]!r}") from None
            headers = web.CIMultiDict()
            while True:
                raw = await deadline.run(conn.reader.readline(), sock_read, ServerTimeoutError)
                if raw in (b"\r\n", b"\n"):
                    break
                if not raw:
                    raise ServerDisconnectedError()
                name, _, value = raw.decode("latin-1").partition(":")
                headers.add(name.strip(), value.strip())
            if status == 101 or not 100 <= status < 200:
                break  # past an informational answer (100 Continue, 103)
        resp = ClientResponse(method, target.url, status, reason, version, headers)
        if status == 101:
            resp.content = web.StreamReader(None)  # the connection is the caller's now
            return resp
        tokens = {t.strip().lower() for t in headers.get("Connection", "").split(",")}
        reusable = ("close" not in tokens if version == "HTTP/1.1" else "keep-alive" in tokens)
        if method == "HEAD" or web._bodiless(status):
            stream = web.StreamReader(None)
        elif "chunked" in headers.get("Transfer-Encoding", "").lower():
            stream = web.StreamReader(conn.reader, chunked=True)
        elif "Content-Length" in headers:
            try:
                length = int(headers["Content-Length"])
            except ValueError:
                raise ClientError("bad Content-Length") from None
            stream = web.StreamReader(conn.reader, length=length)
        else:
            stream = web.StreamReader(conn.reader)
            reusable = False
        stream._on_eof = resp._body_ended
        stream._read_timeout = lambda: deadline.left(sock_read)
        encoding = headers.get("Content-Encoding", "").strip().lower()
        inflate = (encoding if self._auto_decompress and encoding in ("gzip", "deflate")
                   and not stream.at_eof() else None)
        resp._attach(self, conn, stream, reusable, inflate)
        return resp

    def ws_connect(self, url: str, *, protocols=(), headers=None) -> _WSContext:
        return _WSContext(self._ws_connect(url, tuple(protocols), headers))

    async def _ws_connect(self, url: str, protocols: tuple, headers) -> ClientWebSocketResponse:
        target = _Target(url)
        key = base64.b64encode(os.urandom(16)).decode()
        sent = web.CIMultiDict(headers)
        sent["Upgrade"] = "websocket"
        sent["Connection"] = "Upgrade"
        sent["Sec-WebSocket-Version"] = "13"
        sent["Sec-WebSocket-Key"] = key
        if protocols:
            sent["Sec-WebSocket-Protocol"] = ",".join(protocols)
        deadline = _Deadline(self._timeout)
        conn = await self._connect(target, deadline, pooled=False)
        try:
            await self._write_request(conn, "GET", target, sent, None)
            resp = await self._read_response(conn, "GET", target, deadline)
            if resp.status != 101:
                raise WSServerHandshakeError(resp.status, "Invalid response status")
            if resp.headers.get("Upgrade", "").lower() != "websocket":
                raise WSServerHandshakeError(resp.status, "Invalid upgrade header")
            if "upgrade" not in resp.headers.get("Connection", "").lower():
                raise WSServerHandshakeError(resp.status, "Invalid connection header")
            if resp.headers.get("Sec-WebSocket-Accept", "") != web.ws_accept(key):
                raise WSServerHandshakeError(resp.status, "Invalid challenge response")
            chosen = resp.headers.get("Sec-WebSocket-Protocol")
            if chosen is not None and chosen not in protocols:
                chosen = None
        except BaseException:
            conn.close()
            raise
        ws = ClientWebSocketResponse(chosen, resp)
        ws._attach(conn.reader, conn.writer, client=True)
        return ws


async def _cancel(*tasks) -> None:
    for task in tasks:
        task.cancel()
    for task in tasks:
        try:
            await task
        except BaseException:  # noqa: BLE001 — cancelled, or failed as the request did
            pass


async def _iterate(data):
    """The pieces of a request body given as a stream: an object with
    ``readany()`` (a body stream) or an async iterable."""
    if hasattr(data, "readany"):
        while chunk := await data.readany():
            yield bytes(chunk)
    elif hasattr(data, "__aiter__"):
        async for chunk in data:
            yield bytes(chunk)
    else:
        raise TypeError(f"data of type {type(data)!r} is neither bytes nor a stream")

