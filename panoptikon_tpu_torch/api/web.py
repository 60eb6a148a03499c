"""The port's HTTP transport: the subset of ``aiohttp.web`` that the server's
handlers use, on ``asyncio.start_server``.

The card machine has no ``aiohttp``, and nothing may be installed there, so
the port serves its API through this module on the card and in the CPU
tests alike. It keeps ``aiohttp.web``'s names and signatures, so that the
copied handlers (``api/server.py``, ``api/policy.py``, ``api/relay.py``)
read as the reference's text:

- ``Request``: ``.app``, ``.match_info``, ``.query`` (``get`` gives the
  first value, as ``MultiDict`` does), ``.json()`` (raises on a bad or
  empty body), ``.read()``, ``.text()``, ``.can_read_body``,
  ``.content_type``, ``.headers`` (case-insensitive), ``.method``,
  ``.path``, ``.rel_url``, ``.multipart()`` and per-request keys;
- ``Response``, ``json_response`` and ``FileResponse`` (single byte ranges,
  ``206``/``416``);
- ``get``/``post``/``put``/``delete`` routes with ``{name}`` and
  ``{name:regex}`` parameters, matched in the order they were added
  (``404``, or ``405`` when only the method differs);
- ``Application`` with ``client_max_size`` (``413`` past it) and
  ``middlewares`` (the first listed is the outermost, as in ``aiohttp``),
  and ``middleware``;
- ``HTTPException`` and its subclasses, whose ``headers`` a middleware may
  write before the server turns the exception into its status and body;
- ``AppRunner`` and ``TCPSite``: HTTP/1.1 with keep-alive and
  ``Content-Length`` (or chunked) request bodies. ``AppRunner.cleanup``
  closes the listeners, then idle keep-alive connections at once, and lets
  a request in flight finish (up to ``shutdown_timeout``).

Bodies and statuses follow ``aiohttp``'s where a client could tell:
``"{status}: {reason}"`` for an exception without a text, and ``500
Internal Server Error\\n\\nServer got itself in trouble`` (connection
closed) for a handler that raised anything else.
"""

from __future__ import annotations

import asyncio
import email.parser
import email.policy
import email.utils
import json
import logging
import mimetypes
import os
import re
from collections.abc import MutableMapping
from http import HTTPStatus
from pathlib import Path
from typing import Any, Awaitable, Callable, Iterator, Optional
from urllib.parse import parse_qsl, unquote

log = logging.getLogger(__name__)

MAX_LINE = 8190
MAX_HEADERS = 128


class CIDict(MutableMapping):
    """Case-insensitive header mapping, one value a name, keeping the name's
    spelling as first set (the handlers read and write single headers)."""

    def __init__(self, data=None):
        self._items: dict[str, tuple[str, str]] = {}
        self.update(data or {})

    def __getitem__(self, key: str) -> str:
        return self._items[key.lower()][1]

    def __setitem__(self, key: str, value) -> None:
        self._items[key.lower()] = (self._items.get(key.lower(), (key, ""))[0], str(value))

    def __delitem__(self, key: str) -> None:
        del self._items[key.lower()]

    def __iter__(self) -> Iterator[str]:
        return (name for name, _ in self._items.values())

    def __len__(self) -> int:
        return len(self._items)

    def __contains__(self, key) -> bool:
        return isinstance(key, str) and key.lower() in self._items



class MultiDict:
    """Read-only query mapping: ``get``/``[]`` give the first value of a
    name, as ``aiohttp``'s ``MultiDict`` does."""


    def __init__(self, pairs: list[tuple[str, str]]):
        self._pairs = list(pairs)

    def get(self, key: str, default=None):
        for name, value in self._pairs:
            if name == key:
                return value
        return default

    def __getitem__(self, key: str) -> str:
        for name, value in self._pairs:
            if name == key:
                return value
        raise KeyError(key)

    def __contains__(self, key) -> bool:
        return any(name == key for name, _ in self._pairs)


class URL:
    """A request target split into its decoded path and its query."""

    def __init__(self, target: str):
        raw_path, _, self.query_string = target.partition("?")
        self.raw_path = raw_path or "/"
        self.path = unquote(self.raw_path)
        self.query = MultiDict(parse_qsl(self.query_string, keep_blank_values=True))

    def __str__(self) -> str:
        return self.raw_path + (f"?{self.query_string}" if self.query_string else "")


# ---------------------------------------------------------------------------
# Responses and exceptions
# ---------------------------------------------------------------------------


class Response:
    """A whole-body response (``aiohttp.web.Response``'s constructor)."""

    def __init__(self, *, body: Optional[bytes] = None, status: int = 200,
                 reason: Optional[str] = None, text: Optional[str] = None, headers=None,
                 content_type: Optional[str] = None):
        self.status = int(status)
        self.reason = reason or _phrase(self.status)
        self.headers = CIDict(headers)
        if body is not None and text is not None:
            raise ValueError("body and text are not allowed together")
        if text is not None:
            if not isinstance(text, str):
                raise TypeError(f"text argument must be str ({type(text)!r})")
            self.body = text.encode("utf-8")
            content_type = f"{content_type or 'text/plain'}; charset=utf-8"
        else:
            if body is not None and not isinstance(body, bytes):
                raise TypeError(f"body must be bytes ({type(body)!r})")
            self.body = body
            if body is not None and content_type is None:
                content_type = "application/octet-stream"
        if content_type is not None and "Content-Type" not in self.headers:
            self.headers["Content-Type"] = content_type

    async def _render(self, request: "Request") -> tuple[int, str, CIDict, bytes]:
        return self.status, self.reason, self.headers, self.body or b""


def json_response(data: Any = None, *, status: int = 200) -> Response:
    return Response(text=json.dumps(data), status=status, content_type="application/json")


_RANGE = re.compile(r"^bytes=(\d*)-(\d*)$")


class FileResponse(Response):
    """A file's bytes with the headers the handler passes (its
    ``Content-Type`` wins over a guess from the name); one byte range of
    ``Range: bytes=a-b``, ``a-`` or ``-n`` gives ``206``, an unsatisfiable
    one ``416``."""

    def __init__(self, path, status: int = 200, reason: Optional[str] = None, headers=None):
        super().__init__(status=status, reason=reason, headers=headers)
        self._path = Path(path)

    async def _render(self, request: "Request") -> tuple[int, str, CIDict, bytes]:
        try:
            st = await asyncio.to_thread(os.stat, self._path)
        except FileNotFoundError:
            raise HTTPNotFound()
        headers = CIDict(self.headers)
        if "Content-Type" not in headers:
            guessed, _ = mimetypes.guess_type(str(self._path))
            headers["Content-Type"] = guessed or "application/octet-stream"
        headers["Accept-Ranges"] = "bytes"
        headers["Last-Modified"] = email.utils.formatdate(st.st_mtime, usegmt=True)
        size = st.st_size
        spec = request.headers.get("Range")
        if spec is None or self.status != 200:
            return self.status, self.reason, headers, await self._slice(0, size)
        bounds = _byte_range(spec, size)
        if bounds is None:
            headers["Content-Range"] = f"bytes */{size}"
            return 416, _phrase(416), headers, b""
        start, end = bounds
        headers["Content-Range"] = f"bytes {start}-{end}/{size}"
        return 206, _phrase(206), headers, await self._slice(start, end + 1 - start)

    async def _slice(self, offset: int, length: int) -> bytes:
        def read():
            with open(self._path, "rb") as f:
                f.seek(offset)
                return f.read(length)

        return await asyncio.to_thread(read)


def _byte_range(spec: str, size: int) -> Optional[tuple[int, int]]:
    """``(first, last)`` byte of one ``bytes=`` range in a file of ``size``
    bytes, or None when it is malformed or unsatisfiable."""
    m = _RANGE.match(spec.strip())
    if m is None or not (m.group(1) or m.group(2)):
        return None
    if m.group(1):
        start = int(m.group(1))
        end = min(int(m.group(2)), size - 1) if m.group(2) else size - 1
    else:
        suffix = int(m.group(2))
        if suffix == 0:
            return None
        start, end = max(size - suffix, 0), size - 1
    if start >= size or start > end:
        return None
    return start, end


def _phrase(status: int) -> str:
    try:
        return HTTPStatus(status).phrase
    except ValueError:
        return ""


class HTTPException(Exception):
    """An HTTP error a handler raises; the server answers with its status,
    reason and ``text`` (``"{status}: {reason}"`` unless given) and the
    ``headers`` the exception carries by then."""

    status_code = 500

    def __init__(self, *, reason: Optional[str] = None, text: Optional[str] = None):
        self.status = self.status_code
        self.reason = reason or _phrase(self.status)
        self.headers = CIDict()
        self.text = f"{self.status}: {self.reason}" if text is None else text
        super().__init__(self.reason)

    def _response(self) -> Response:
        return Response(status=self.status, reason=self.reason, headers=self.headers,
                        text=self.text)


class HTTPBadRequest(HTTPException):
    status_code = 400


class HTTPForbidden(HTTPException):
    status_code = 403


class HTTPNotFound(HTTPException):
    status_code = 404


class HTTPMethodNotAllowed(HTTPException):
    status_code = 405

    def __init__(self, allowed_methods):
        super().__init__()
        self.headers["Allow"] = ",".join(sorted(allowed_methods))


class HTTPRequestEntityTooLarge(HTTPException):
    status_code = 413

    def __init__(self, max_size: int, actual_size: int):
        super().__init__(text=f"Maximum request body size {max_size} exceeded, "
                              f"actual body size {actual_size}")


# ---------------------------------------------------------------------------
# Requests
# ---------------------------------------------------------------------------


class BodyPartReader:
    """One part of a ``multipart/form-data`` body."""

    def __init__(self, headers: CIDict, data: bytes):
        self.headers = headers
        self._data = data
        disposition = email.message_from_string(
            f"Content-Disposition: {headers.get('Content-Disposition', '')}\r\n\r\n",
            policy=email.policy.HTTP,
        )
        self.name = disposition.get_param("name", header="content-disposition")
        self.filename = disposition.get_param("filename", header="content-disposition")

    async def read(self, *, decode: bool = False) -> bytes:
        return self._data

    async def text(self, *, encoding: Optional[str] = None) -> str:
        charset = encoding or _charset(self.headers.get("Content-Type", "")) or "utf-8"
        return self._data.decode(charset)


class MultipartReader:
    """The parts of a ``multipart/form-data`` body, in order (``async for
    part in reader``)."""

    def __init__(self, content_type: str, body: bytes):
        boundary = _param(content_type, "boundary")
        if not boundary:
            raise HTTPBadRequest(reason="multipart body without a boundary")
        self._parts = _split_multipart(body, boundary.encode("latin-1"))

    def __aiter__(self):
        return self

    async def __anext__(self) -> BodyPartReader:
        if not self._parts:
            raise StopAsyncIteration
        return self._parts.pop(0)


def _split_multipart(body: bytes, boundary: bytes) -> list[BodyPartReader]:
    delimiter = b"--" + boundary
    if not body.startswith(delimiter):
        at = body.find(b"\r\n" + delimiter)
        if at < 0:
            raise HTTPBadRequest(reason="multipart body without its boundary")
        body = body[at + 2:]
    parts = []
    for chunk in body.split(b"\r\n" + delimiter):
        if chunk.startswith(delimiter):
            chunk = chunk[len(delimiter):]
        if chunk.startswith(b"--"):
            break  # the closing delimiter
        chunk = chunk[2:] if chunk.startswith(b"\r\n") else chunk
        head, sep, data = chunk.partition(b"\r\n\r\n")
        if not sep:
            head, data = chunk, b""
        parsed = email.parser.BytesHeaderParser(policy=email.policy.HTTP).parsebytes(
            head + b"\r\n\r\n")
        parts.append(BodyPartReader(CIDict(parsed.items()), data))
    return parts


def _param(content_type: str, name: str) -> Optional[str]:
    msg = email.message_from_string(f"Content-Type: {content_type}\r\n\r\n",
                                    policy=email.policy.HTTP)
    value = msg.get_param(name, header="content-type")
    return None if value is None else str(value)


def _charset(content_type: str) -> Optional[str]:
    return _param(content_type, "charset") if content_type else None


class _Keys(MutableMapping):
    """Keys a caller sets on an object (``obj["k"] = v``, ``obj.get``)."""

    def __init__(self):
        self._state: dict[str, Any] = {}

    def __getitem__(self, key):
        return self._state[key]

    def __setitem__(self, key, value) -> None:
        self._state[key] = value

    def __delitem__(self, key) -> None:
        del self._state[key]

    def __iter__(self):
        return iter(self._state)

    def __len__(self) -> int:
        return len(self._state)


class Request(_Keys):
    """A request whose body was read whole before the handler ran; a
    mapping for per-request keys (``request["k"] = v``, ``request.get``)."""

    def __init__(self, app: "Application", method: str, target: str, version: str,
                 headers: CIDict, body: bytes, remote: Optional[str] = None):
        self.app = app
        self.method = method.upper()
        self.version = version
        self.rel_url = URL(target)
        self.path = self.rel_url.path
        self.query = self.rel_url.query
        super().__init__()
        self.headers = headers
        self.remote = remote
        self.match_info: dict[str, str] = {}
        self._body = body
        self._read = False


    @property
    def content_type(self) -> str:
        raw = self.headers.get("Content-Type")
        return raw.split(";")[0].strip().lower() if raw else "application/octet-stream"

    @property
    def charset(self) -> Optional[str]:
        return _charset(self.headers.get("Content-Type", ""))

    @property
    def can_read_body(self) -> bool:
        # As aiohttp's: a body that exists and has not been read yet.
        return bool(self._body) and not self._read

    async def read(self) -> bytes:
        self._read = True
        return self._body

    async def text(self) -> str:
        return (await self.read()).decode(self.charset or "utf-8")

    async def json(self) -> Any:
        return json.loads(await self.text())

    async def multipart(self) -> MultipartReader:
        self._read = True
        return MultipartReader(self.headers.get("Content-Type", ""), self._body)


# ---------------------------------------------------------------------------
# Routing and the application
# ---------------------------------------------------------------------------

_PARAM = re.compile(r"\{(?P<name>[A-Za-z_][A-Za-z0-9_]*)(?::(?P<regex>[^{}]*(?:\{[^{}]*\}[^{}]*)*))?\}")


class Resource:
    """A path pattern: literal text and ``{name}`` (one segment) or
    ``{name:regex}`` parameters, matched on the raw path, the parameters
    percent-decoded."""

    def __init__(self, path: str):
        self.canonical = path
        pattern, pos = "", 0
        for m in _PARAM.finditer(path):
            pattern += re.escape(path[pos:m.start()])
            pattern += f"(?P<{m.group('name')}>{m.group('regex') or '[^{}/]+'})"
            pos = m.end()
        pattern += re.escape(path[pos:])
        self.dynamic = pos > 0
        self._regex = re.compile(f"^{pattern}$")

    def match(self, raw_path: str) -> Optional[dict[str, str]]:
        m = self._regex.match(raw_path)
        if m is None:
            return None
        return {k: unquote(v) for k, v in m.groupdict().items()}

    def get_info(self) -> dict:
        return {"formatter": self.canonical} if self.dynamic else {"path": self.canonical}


class RouteDef:
    """A route: a method, a path pattern and its handler."""

    def __init__(self, method: str, path: str, handler: Callable[..., Awaitable]):
        self.method = method.upper()
        self.path = path
        self.handler = handler
        self.resource = Resource(path)

    def get_info(self) -> dict:
        return self.resource.get_info()

    def __repr__(self) -> str:
        return f"<RouteDef {self.method} {self.path} -> {self.handler.__name__!r}>"


def get(path: str, handler) -> RouteDef:
    return RouteDef("GET", path, handler)


def post(path: str, handler) -> RouteDef:
    return RouteDef("POST", path, handler)


def put(path: str, handler) -> RouteDef:
    return RouteDef("PUT", path, handler)


def delete(path: str, handler) -> RouteDef:
    return RouteDef("DELETE", path, handler)


class Router:
    def __init__(self):
        self._routes: list[RouteDef] = []

    def add_routes(self, routes) -> list[RouteDef]:
        routes = list(routes)
        self._routes.extend(routes)
        return routes

    def routes(self) -> list[RouteDef]:
        return list(self._routes)

    def resolve(self, request: Request) -> Callable[[Request], Awaitable]:
        """The first route, in the order added, whose path and method match
        (``GET`` also answers ``HEAD``); else a handler raising ``405`` if a
        path matched, or ``404``."""
        raw = request.rel_url.raw_path
        allowed: set[str] = set()
        for r in self._routes:
            params = r.resource.match(raw)
            if params is None:
                continue
            if r.method == request.method or (r.method, request.method) == ("GET", "HEAD"):
                request.match_info = params
                return r.handler
            allowed.add(r.method)
        if allowed:
            exc: HTTPException = HTTPMethodNotAllowed(allowed)
        else:
            exc = HTTPNotFound()

        async def refuse(_request):
            raise exc

        return refuse


def middleware(f):
    """Marks a new-style middleware ``async def m(request, handler)``."""
    f.__middleware_version__ = 1
    return f


class Application(_Keys):
    """Routes, middlewares and the state the handlers share
    (``app["state"]``)."""

    def __init__(self, *, middlewares=(), client_max_size: int = 1024 ** 2):
        super().__init__()
        self.router = Router()
        self.middlewares = list(middlewares)
        self._client_max_size = client_max_size


    def add_routes(self, routes) -> list[RouteDef]:
        return self.router.add_routes(routes)

    async def _handle(self, request: Request) -> Response:
        handler = self.router.resolve(request)
        # The first middleware listed wraps all the others (aiohttp's order).
        for mw in reversed(self.middlewares):
            handler = _bind(mw, handler)
        return await handler(request)


def _bind(mw, handler):
    async def call(request):
        return await mw(request, handler)

    return call


# ---------------------------------------------------------------------------
# The server
# ---------------------------------------------------------------------------


class _BadRequest(Exception):
    pass


class _Connection:
    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self.reader = reader
        self.writer = writer
        self.idle = True
        self.closing = False
        self.task: Optional[asyncio.Task] = None


class AppRunner:
    """Serves one ``Application`` on the sites started for it."""

    def __init__(self, app: Application, *, shutdown_timeout: float = 60.0):
        self.app = app
        self.shutdown_timeout = shutdown_timeout
        self._sites: list["TCPSite"] = []
        self._connections: set[_Connection] = set()

    @property
    def addresses(self) -> list:
        return [sock.getsockname() for site in self._sites for sock in site._sockets()]

    async def setup(self) -> None:
        pass

    async def cleanup(self) -> None:
        """Stop accepting, close idle keep-alive connections now, let a
        request in flight finish and then close its connection."""
        for site in list(self._sites):
            site._server.close()
        for conn in list(self._connections):
            conn.closing = True
            if conn.idle:
                conn.writer.close()
        tasks = [c.task for c in self._connections if c.task is not None]
        if tasks:
            _, pending = await asyncio.wait(tasks, timeout=self.shutdown_timeout)
            for task in pending:
                task.cancel()
            if pending:
                await asyncio.wait(pending, timeout=5)
        for site in list(self._sites):
            await site._server.wait_closed()
        self._sites.clear()

    async def _serve(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        conn = _Connection(reader, writer)
        conn.task = asyncio.current_task()
        self._connections.add(conn)
        peer = writer.get_extra_info("peername")
        remote = peer[0] if isinstance(peer, tuple) else None
        try:
            while not conn.closing:
                conn.idle = True
                try:
                    head = await _read_head(reader)
                except _BadRequest as exc:
                    await _write(writer, 400, _phrase(400), CIDict(
                        {"Content-Type": "text/plain; charset=utf-8"}),
                        f"400, message:\n  {exc}".encode(), keep_alive=False, head_only=False)
                    break
                if head is None:
                    break
                conn.idle = False
                method, target, version, headers = head
                keep = _keep_alive(version, headers)
                try:
                    body = await _read_body(reader, headers, self.app._client_max_size)
                except HTTPRequestEntityTooLarge as exc:
                    # The unread body is still on the wire: answer and close.
                    request = Request(self.app, method, target, version, headers, b"", remote)
                    response, keep = exc._response(), False
                else:
                    request = Request(self.app, method, target, version, headers, body, remote)
                    response, failed = await self._respond(request)
                    keep = keep and not failed
                if conn.closing:
                    keep = False
                try:
                    code, reason, out_headers, data = await response._render(request)
                except HTTPException as exc:  # a FileResponse's file went missing
                    code, reason, out_headers, data = await exc._response()._render(request)
                await _write(writer, code, reason, out_headers, data, keep_alive=keep,
                             head_only=method.upper() == "HEAD")
                if not keep:
                    break
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            self._connections.discard(conn)
            try:
                writer.close()
            except Exception:  # noqa: BLE001 — the socket is already gone
                pass

    async def _respond(self, request: Request) -> tuple[Response, bool]:
        try:
            response = await self.app._handle(request)
        except HTTPException as exc:
            return exc._response(), False
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001 — aiohttp's 500, connection closed
            log.exception("Error handling request %s %s", request.method, request.rel_url)
            return _server_error(), True
        if not isinstance(response, Response):
            log.error("handler for %s returned %r, not a Response", request.rel_url, response)
            return _server_error(), True
        return response, False


def _server_error() -> Response:
    return Response(status=500, text="500 Internal Server Error\n\nServer got itself in trouble")


class TCPSite:
    """A listener of a runner on ``host:port`` (``port`` 0: any free one,
    read back through ``runner.addresses``)."""

    def __init__(self, runner: AppRunner, host: Optional[str] = None, port: Optional[int] = None):
        self._runner = runner
        self._host = host or "0.0.0.0"
        self._port = 8080 if port is None else port
        self._server: Optional[asyncio.base_events.Server] = None

    def _sockets(self):
        return self._server.sockets if self._server is not None else ()

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._runner._serve, self._host, self._port, limit=1 << 16, reuse_address=True,
        )
        self._runner._sites.append(self)



async def _read_line(reader: asyncio.StreamReader) -> bytes:
    try:
        line = await reader.readuntil(b"\n")
    except asyncio.LimitOverrunError:
        line = b"x" * (MAX_LINE + 1)
    except asyncio.IncompleteReadError as exc:
        if exc.partial:
            raise _BadRequest("incomplete request line")
        return b""
    if len(line) > MAX_LINE:
        raise _BadRequest(f"Got more than {MAX_LINE} bytes when reading a line")
    return line


async def _read_head(reader: asyncio.StreamReader):
    """The request line and headers, or None at a clean end of stream."""
    line = await _read_line(reader)
    while line in (b"\r\n", b"\n"):  # tolerated blank lines between requests
        line = await _read_line(reader)
    if not line:
        return None
    try:
        method, target, version = line.decode("latin-1").strip().split(" ")
    except ValueError:
        raise _BadRequest(f"Bad request line {line[:80]!r}")
    if not version.startswith("HTTP/1.") or not target.startswith("/"):
        raise _BadRequest(f"Bad request line {line[:80]!r}")
    headers = CIDict()
    for _ in range(MAX_HEADERS + 1):
        raw = await _read_line(reader)
        if raw in (b"\r\n", b"\n"):
            return method, target, version, headers
        if not raw:
            raise _BadRequest("connection closed in the headers")
        name, sep, value = raw.decode("latin-1").partition(":")
        if not sep or not name or name != name.strip():
            raise _BadRequest(f"Bad header line {raw[:80]!r}")
        headers[name] = value.strip()
    raise _BadRequest("too many headers")


async def _read_body(reader: asyncio.StreamReader, headers: CIDict, max_size: int) -> bytes:
    if "chunked" in headers.get("Transfer-Encoding", "").lower():
        chunks, total = [], 0
        while True:
            size_line = await _read_line(reader)
            try:
                size = int(size_line.split(b";")[0].strip() or b"x", 16)
            except ValueError:
                raise _BadRequest("bad chunk size")
            if size == 0:
                while (await _read_line(reader)) not in (b"\r\n", b"\n", b""):
                    pass  # trailers
                return b"".join(chunks)
            total += size
            if max_size and total > max_size:
                raise HTTPRequestEntityTooLarge(max_size=max_size, actual_size=total)
            chunks.append(await reader.readexactly(size))
            await reader.readexactly(2)
    length = int(headers.get("Content-Length", "0") or 0)
    if length < 0:
        raise _BadRequest("negative Content-Length")
    if max_size and length > max_size:
        raise HTTPRequestEntityTooLarge(max_size=max_size, actual_size=length)
    return await reader.readexactly(length) if length else b""


def _keep_alive(version: str, headers: CIDict) -> bool:
    tokens = {t.strip().lower() for t in headers.get("Connection", "").split(",")}
    if version == "HTTP/1.0":
        return "keep-alive" in tokens
    return "close" not in tokens


async def _write(writer: asyncio.StreamWriter, status: int, reason: str, headers: CIDict,
                 body: bytes, *, keep_alive: bool, head_only: bool) -> None:
    out = CIDict(headers)
    no_body = status in (204, 304) or 100 <= status < 200
    if not no_body:
        out["Content-Length"] = str(len(body))
    out["Date"] = email.utils.formatdate(usegmt=True)
    out["Server"] = "panoptikon_tpu_torch"
    out["Connection"] = "keep-alive" if keep_alive else "close"
    lines = [f"HTTP/1.1 {status} {reason}\r\n"]
    lines += [f"{name}: {value}\r\n" for name, value in out.items()]
    writer.write(("".join(lines) + "\r\n").encode("latin-1"))
    if body and not no_body and not head_only:
        writer.write(body)
    await writer.drain()
