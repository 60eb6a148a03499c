"""The port's HTTP transport: the subset of ``aiohttp.web`` that the server's
handlers and the reverse proxy use, on ``asyncio.start_server``.

The card machine has no ``aiohttp``, and nothing may be installed there, so
the port serves its API through this module on the card and in the CPU
tests alike. It keeps ``aiohttp.web``'s names and signatures, so that the
copied handlers (``api/server.py``, ``api/policy.py``, ``api/relay.py``,
``api/proxy.py``) read as the reference's text:

- ``CIMultiDict``: case-insensitive headers that keep every value of a
  repeated name (``add``, ``getall``, ``items()``), for requests and
  responses alike;
- ``Request``: ``.app``, ``.match_info``, ``.query`` (``get`` gives the
  first value, as ``MultiDict`` does), ``.content`` (the body as it
  arrives: ``readany``, ``read(n)``, ``iter_chunked``), ``.read()``,
  ``.text()``, ``.json()`` (raises on a bad or empty body) and
  ``.multipart()``, which read it whole and answer ``413`` past the
  application's ``client_max_size``, ``.can_read_body``, ``.content_type``,
  ``.headers``, ``.method``, ``.path``, ``.raw_path``, ``.rel_url`` and
  per-request keys. No body is read before the route is known;
- ``StreamResponse`` (``prepare``, ``write``, ``write_eof``; chunked to an
  HTTP/1.1 client), ``Response``, ``json_response`` and ``FileResponse``
  (single byte ranges, ``206``/``416``);
- ``WebSocketResponse`` with ``WSMsgType`` and ``WSMessage`` (RFC 6455:
  the accept handshake and a subprotocol from the client's offer; text,
  binary, fragments, ping and close; masked client frames), over the frame
  codec that ``api/web_client.py``'s client end shares;
- ``get``/``post``/``put``/``delete`` routes and ``router.add_route``
  (``"*"``: every method) with ``{name}`` and ``{name:regex}`` parameters,
  matched in the order they were added; a path that matched only under
  other methods falls through to a later route (``404``, or ``405`` when
  nothing later matches and only the method differs);
- ``Application`` with ``client_max_size`` and ``middlewares`` (the first
  listed is the outermost, as in ``aiohttp``), and ``middleware``;
- ``HTTPException`` and its subclasses, whose ``headers`` a middleware may
  write before the server turns the exception into its status and body;
- ``AppRunner`` and ``TCPSite``: HTTP/1.1 with keep-alive and
  ``Content-Length`` (or chunked) request bodies; a body a handler left
  unread is drained (up to ``DRAIN_LIMIT``) or the connection closes, and
  a connection closed on a body still arriving lingers so that the answer
  is read. ``AppRunner.cleanup`` closes the listeners, then idle
  keep-alive connections at once, and lets a request in flight (an open
  WebSocket too) finish, up to ``shutdown_timeout``.

Bodies and statuses follow ``aiohttp``'s where a client could tell:
``"{status}: {reason}"`` for an exception without a text, and ``500
Internal Server Error\\n\\nServer got itself in trouble`` (connection
closed) for a handler that raised anything else.
"""

from __future__ import annotations

import asyncio
import base64
import email.parser
import email.policy
import email.utils
import enum
import hashlib
import json
import logging
import mimetypes
import os
import re
import struct
from collections.abc import MutableMapping
from http import HTTPStatus
from pathlib import Path
from typing import Any, Awaitable, Callable, Iterator, NamedTuple, Optional
from urllib.parse import parse_qsl, unquote

log = logging.getLogger(__name__)

MAX_LINE = 8190
MAX_HEADERS = 128
_MISSING = object()


class CIMultiDict(MutableMapping):
    """Case-insensitive header mapping that keeps every value of a name
    (``multidict.CIMultiDict``'s surface): ``[]`` and ``get`` give a name's
    first value, ``add`` appends one, ``getall`` gives them all and
    ``items()`` every pair in order; setting a name replaces all its values
    in the place of its first, keeping that one's spelling."""

    def __init__(self, data=None, **kwargs):
        self._pairs: list[tuple[str, str, str]] = []  # (lower, name, value)
        self.extend(data or ())
        self.extend(kwargs)

    def extend(self, data) -> None:
        for name, value in (data.items() if hasattr(data, "items") else data):
            self.add(name, value)

    def add(self, key: str, value) -> None:
        self._pairs.append((key.lower(), key, str(value)))

    def getall(self, key: str, default=_MISSING) -> list[str]:
        low = key.lower()
        values = [v for k, _, v in self._pairs if k == low]
        if values or default is not _MISSING:
            return values or default
        raise KeyError(key)

    def __getitem__(self, key: str) -> str:
        low = key.lower()
        for k, _, value in self._pairs:
            if k == low:
                return value
        raise KeyError(key)

    def __setitem__(self, key: str, value) -> None:
        low = key.lower()
        at = next((i for i, (k, _, _) in enumerate(self._pairs) if k == low), None)
        if at is None:
            self.add(key, value)
            return
        self._pairs[at] = (low, self._pairs[at][1], str(value))
        self._pairs[at + 1:] = [p for p in self._pairs[at + 1:] if p[0] != low]

    def __delitem__(self, key: str) -> None:
        low = key.lower()
        kept = [p for p in self._pairs if p[0] != low]
        if len(kept) == len(self._pairs):
            raise KeyError(key)
        self._pairs = kept

    def __iter__(self) -> Iterator[str]:
        return iter([name for _, name, _ in self._pairs])

    def __len__(self) -> int:
        return len(self._pairs)

    def __contains__(self, key) -> bool:
        return isinstance(key, str) and any(k == key.lower() for k, _, _ in self._pairs)

    def keys(self) -> list[str]:
        return [name for _, name, _ in self._pairs]

    def values(self) -> list[str]:
        return [value for _, _, value in self._pairs]

    def items(self) -> list[tuple[str, str]]:
        return [(name, value) for _, name, value in self._pairs]

    def copy(self) -> "CIMultiDict":
        return CIMultiDict(self.items())

    def __repr__(self) -> str:
        return f"<CIMultiDict({self.items()!r})>"


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


class StreamResponse:
    """A response whose body the handler writes as it goes
    (``aiohttp.web.StreamResponse``): ``prepare(request)`` sends the status
    line and headers, ``write`` a piece of the body and ``write_eof`` its
    end. Without a ``Content-Length`` the body goes chunked to an HTTP/1.1
    client and until the connection closes to an HTTP/1.0 one; a ``HEAD``
    request and a 1xx, 204 or 304 status carry no body."""

    def __init__(self, *, status: int = 200, reason: Optional[str] = None, headers=None):
        self.status = int(status)
        self.reason = reason or _phrase(self.status)
        self.headers = CIMultiDict(headers)
        self._writer: Optional[asyncio.StreamWriter] = None
        self._chunked = False
        self._no_body = False
        self._eof = False

    @property
    def prepared(self) -> bool:
        return self._writer is not None

    async def prepare(self, request: "Request") -> None:
        if self._writer is not None:
            return
        conn = request._conn
        if conn is None:
            raise RuntimeError("the request has no connection to answer on")
        out = CIMultiDict(self.headers)
        self._no_body = _bodiless(self.status) or request.method == "HEAD"
        keep = conn.keep_alive and request.content.at_eof()
        if _bodiless(self.status):
            for name in ("Content-Length", "Transfer-Encoding"):
                out.pop(name, None)
        elif "Content-Length" not in out and request.method != "HEAD":
            if request.version == "HTTP/1.1":
                out["Transfer-Encoding"] = "chunked"
                self._chunked = True
            else:
                keep = False  # the body ends where the connection does
        conn.keep_alive = keep
        request._prepared = self
        self._writer = conn.writer
        _write_head(conn.writer, self.status, self.reason, out, keep_alive=keep)
        await conn.writer.drain()

    async def write(self, data: bytes) -> None:
        if self._writer is None:
            raise RuntimeError("write() before prepare()")
        if self._eof:
            raise RuntimeError("write() after write_eof()")
        if not data or self._no_body:
            return
        if self._chunked:
            self._writer.write(b"%x\r\n" % len(data))
            self._writer.write(data)
            self._writer.write(b"\r\n")
        else:
            self._writer.write(data)
        await self._writer.drain()

    async def write_eof(self, data: bytes = b"") -> None:
        if self._eof:
            return
        await self.write(data)
        self._eof = True
        if self._chunked and not self._no_body:
            self._writer.write(b"0\r\n\r\n")
        await self._writer.drain()


class Response(StreamResponse):
    """A whole-body response (``aiohttp.web.Response``'s constructor)."""

    def __init__(self, *, body: Optional[bytes] = None, status: int = 200,
                 reason: Optional[str] = None, text: Optional[str] = None, headers=None,
                 content_type: Optional[str] = None):
        super().__init__(status=status, reason=reason, headers=headers)
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

    async def _render(self, request: "Request") -> tuple[int, str, CIMultiDict, bytes]:
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

    async def _render(self, request: "Request") -> tuple[int, str, CIMultiDict, bytes]:
        try:
            st = await asyncio.to_thread(os.stat, self._path)
        except FileNotFoundError:
            raise HTTPNotFound()
        headers = CIMultiDict(self.headers)
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
        self.headers = CIMultiDict()
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

    def __init__(self, headers: CIMultiDict, data: bytes):
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
        parts.append(BodyPartReader(CIMultiDict(parsed.items()), data))
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


class PayloadError(HTTPBadRequest):
    """A body whose framing broke off or is malformed."""


READ_CHUNK = 1 << 18


class StreamReader:
    """A body as it arrives on the connection (``aiohttp.StreamReader``'s
    reading surface): framed by ``Content-Length``, chunked, or (a response
    without either) until the connection closes. ``readany`` gives the next
    bytes there are, ``read(n)`` at most ``n`` (all with ``n < 0``),
    ``iter_chunked(n)`` pieces of at most ``n``; each gives ``b""`` at the
    end. ``on_eof`` runs once, when the end has been read."""

    def __init__(self, reader: Optional[asyncio.StreamReader], *, length: Optional[int] = None,
                 chunked: bool = False, on_eof: Optional[Callable[[], None]] = None,
                 read_timeout: Optional[Callable[[], Optional[float]]] = None):
        self._reader = reader
        self._left = length  # None: chunked, or until the connection closes
        self._chunked = chunked
        self._chunk_left = 0
        self._buffer = b""
        self._eof = False
        self._on_eof = on_eof
        self._read_timeout = read_timeout
        if reader is None or length == 0:
            self._finish()

    @classmethod
    def from_bytes(cls, data: bytes) -> "StreamReader":
        stream = cls(None)
        stream._buffer = bytes(data)
        return stream

    def _finish(self) -> None:
        if not self._eof:
            self._eof = True
            if self._on_eof is not None:
                self._on_eof()

    def at_eof(self) -> bool:
        return self._eof and not self._buffer

    async def _io(self, coro):
        limit = self._read_timeout() if self._read_timeout is not None else None
        return await (coro if limit is None else asyncio.wait_for(coro, limit))

    async def _next(self) -> bytes:
        """The next piece off the wire (b"" at the end)."""
        if self._eof:
            return b""
        reader = self._reader
        try:
            if self._chunked:
                if self._chunk_left == 0:
                    line = await self._io(reader.readline())
                    try:
                        size = int(line.split(b";")[0].strip() or b"x", 16)
                    except ValueError:
                        raise PayloadError(reason="bad chunk size")
                    if size == 0:
                        while (await self._io(reader.readline())) not in (b"\r\n", b"\n", b""):
                            pass  # trailers
                        self._finish()
                        return b""
                    self._chunk_left = size
                data = await self._io(reader.read(min(self._chunk_left, READ_CHUNK)))
                if not data:
                    raise PayloadError(reason="the connection closed inside a chunk")
                self._chunk_left -= len(data)
                if self._chunk_left == 0:
                    await self._io(reader.readexactly(2))
                return data
            if self._left is None:
                data = await self._io(reader.read(READ_CHUNK))
                if not data:
                    self._finish()
                return data
            data = await self._io(reader.read(min(self._left, READ_CHUNK)))
            if not data:
                raise PayloadError(reason="the connection closed inside the body")
            self._left -= len(data)
            if self._left == 0:
                self._finish()
            return data
        except asyncio.IncompleteReadError:
            raise PayloadError(reason="the connection closed inside the body")

    async def readany(self) -> bytes:
        if self._buffer:
            data, self._buffer = self._buffer, b""
            if self._reader is None:
                self._finish()
            return data
        return await self._next()

    async def read(self, n: int = -1) -> bytes:
        if n < 0:
            parts = []
            while chunk := await self.readany():
                parts.append(chunk)
            return b"".join(parts)
        if n == 0:
            return b""
        data = await self.readany()
        if len(data) > n:
            data, self._buffer = data[:n], data[n:] + self._buffer
        return data

    async def iter_chunked(self, n: int):
        while chunk := await self.read(n):
            yield chunk

    async def drain(self, limit: int) -> bool:
        """Read and drop up to ``limit`` bytes of what is left; True when the
        end was reached."""
        seen = 0
        while not self.at_eof() and seen <= limit:
            seen += len(await self.readany())
        return self.at_eof()


class Request(_Keys):
    """A request, its body left on the connection until a handler reads it
    (``content``, or whole through ``read``, ``text``, ``json`` and
    ``multipart``, which answer ``413`` past the application's
    ``client_max_size``); a mapping for per-request keys
    (``request["k"] = v``, ``request.get``)."""

    def __init__(self, app: "Application", method: str, target: str, version: str,
                 headers: CIMultiDict, payload=b"", remote: Optional[str] = None,
                 conn: Optional["_Connection"] = None):
        self.app = app
        self.method = method.upper()
        self.version = version
        self.rel_url = URL(target)
        self.path = self.rel_url.path
        self.raw_path = str(self.rel_url)
        self.query = self.rel_url.query
        super().__init__()
        self.headers = headers
        self.remote = remote
        self.match_info: dict[str, str] = {}
        self.content = (payload if isinstance(payload, StreamReader)
                        else StreamReader.from_bytes(payload))
        self._read_bytes: Optional[bytes] = None
        self._conn = conn
        self._prepared: Optional[StreamResponse] = None

    @property
    def content_type(self) -> str:
        raw = self.headers.get("Content-Type")
        return raw.split(";")[0].strip().lower() if raw else "application/octet-stream"

    @property
    def charset(self) -> Optional[str]:
        return _charset(self.headers.get("Content-Type", ""))

    @property
    def can_read_body(self) -> bool:
        # As aiohttp's: a body that is there and not read to its end yet.
        return not self.content.at_eof()

    async def read(self) -> bytes:
        """The whole body; ``413`` once more than ``client_max_size`` bytes
        have come (aiohttp's check, on the bytes read so far)."""
        if self._read_bytes is None:
            limit = self.app._client_max_size
            body = bytearray()
            while chunk := await self.content.readany():
                body.extend(chunk)
                if limit and len(body) > limit:
                    raise HTTPRequestEntityTooLarge(max_size=limit, actual_size=len(body))
            self._read_bytes = bytes(body)
        return self._read_bytes

    async def text(self) -> str:
        return (await self.read()).decode(self.charset or "utf-8")

    async def json(self) -> Any:
        return json.loads(await self.text())

    async def multipart(self) -> MultipartReader:
        return MultipartReader(self.headers.get("Content-Type", ""), await self.read())


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

    def add_route(self, method: str, path: str, handler) -> RouteDef:
        """A route for ``method``, or for every method with ``"*"``."""
        return self.add_routes([RouteDef(method, path, handler)])[0]

    def routes(self) -> list[RouteDef]:
        return list(self._routes)

    def resolve(self, request: Request) -> Callable[[Request], Awaitable]:
        """The first route, in the order added, whose path and method match
        (``GET`` also answers ``HEAD``, ``*`` every method): a path that
        matched only under other methods falls through to a later route, as
        in ``aiohttp``. Else a handler raising ``405`` if a path matched, or
        ``404``."""
        raw = request.rel_url.raw_path
        allowed: set[str] = set()
        for r in self._routes:
            params = r.resource.match(raw)
            if params is None:
                continue
            if r.method in ("*", request.method) or (r.method, request.method) == ("GET", "HEAD"):
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
# WebSockets (RFC 6455): the server's end here, the client's in
# api/web_client.py, over one frame codec
# ---------------------------------------------------------------------------

WS_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"
WS_MAX_MSG_SIZE = 4 * 1024 * 1024  # aiohttp's default on both ends
WS_CLOSE_S = 10.0  # aiohttp's wait for the peer's close frame


class WSMsgType(enum.IntEnum):
    CONTINUATION = 0x0
    TEXT = 0x1
    BINARY = 0x2
    PING = 0x9
    PONG = 0xA
    CLOSE = 0x8
    CLOSING = 0x100
    CLOSED = 0x101
    ERROR = 0x102


class WSCloseCode(enum.IntEnum):
    OK = 1000
    PROTOCOL_ERROR = 1002
    ABNORMAL_CLOSURE = 1006
    INVALID_TEXT = 1007
    MESSAGE_TOO_BIG = 1009


class WSMessage(NamedTuple):
    type: WSMsgType
    data: Any
    extra: Any

    def json(self, *, loads=json.loads) -> Any:
        return loads(self.data)


_CLOSED_MESSAGE = WSMessage(WSMsgType.CLOSED, None, None)


class WebSocketError(Exception):
    """A frame that breaks the protocol, with the close code it earns."""

    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code


def ws_accept(key: str) -> str:
    """``Sec-WebSocket-Accept`` for a client's ``Sec-WebSocket-Key``."""
    return base64.b64encode(hashlib.sha1((key + WS_GUID).encode()).digest()).decode()


def _xor_mask(data: bytes, key: bytes) -> bytes:
    """``data`` XOR the 4-byte ``key`` repeated: masks and unmasks."""
    n = len(data)
    if not n:
        return b""
    pad = (key * (n // 4 + 1))[:n]
    return (int.from_bytes(data, "little") ^ int.from_bytes(pad, "little")).to_bytes(n, "little")


def ws_frame(opcode: int, payload: bytes, *, fin: bool = True, mask: bool = False) -> bytes:
    """One frame, its length in 7, 16 or 64 bits; masked with a fresh random
    key where ``mask`` (a client's frames), bare otherwise (a server's)."""
    n = len(payload)
    b0 = (0x80 if fin else 0) | opcode
    bit = 0x80 if mask else 0
    if n < 126:
        head = struct.pack("!BB", b0, bit | n)
    elif n < 1 << 16:
        head = struct.pack("!BBH", b0, bit | 126, n)
    else:
        head = struct.pack("!BBQ", b0, bit | 127, n)
    if not mask:
        return head + payload
    key = os.urandom(4)
    return head + key + _xor_mask(payload, key)


async def ws_read_frame(reader: asyncio.StreamReader, *, masked: bool,
                        max_size: int) -> tuple[bool, int, bytes]:
    """(fin, opcode, payload) of the next frame. Raises ``WebSocketError``
    for a frame whose mask is not what ``masked`` says (a client masks, a
    server does not), with reserved bits, a control frame over 125 bytes or
    fragmented, or one past ``max_size`` bytes."""
    b0, b1 = await reader.readexactly(2)
    fin, opcode, n = bool(b0 & 0x80), b0 & 0x0F, b1 & 0x7F
    if b0 & 0x70:
        raise WebSocketError(WSCloseCode.PROTOCOL_ERROR, "Received frame with non-zero reserved bits")
    if bool(b1 & 0x80) != masked:
        raise WebSocketError(WSCloseCode.PROTOCOL_ERROR,
                             "a client's frames are masked and a server's are not")
    if n == 126:
        n = struct.unpack("!H", await reader.readexactly(2))[0]
    elif n == 127:
        n = struct.unpack("!Q", await reader.readexactly(8))[0]
    if opcode >= 0x8 and (n > 125 or not fin):
        raise WebSocketError(WSCloseCode.PROTOCOL_ERROR,
                             "Control frame payload cannot be larger than 125 bytes or fragmented")
    if max_size and n > max_size:
        raise WebSocketError(WSCloseCode.MESSAGE_TOO_BIG,
                             f"Message size {n} exceeds limit {max_size}")
    key = await reader.readexactly(4) if masked else b""
    payload = await reader.readexactly(n)
    return fin, opcode, (_xor_mask(payload, key) if masked else payload)


class _WebSocket:
    """The message side of an open WebSocket, on either end. A reader task
    turns frames into whole messages (fragments joined, text decoded, at
    most WS_MAX_MSG_SIZE bytes) on a queue, so that ``receive(timeout=)``
    can give up without cutting a frame; ``receive`` answers a ping with a
    pong and a close with a close, as aiohttp does by default. ``close()``
    sends a close frame and waits (up to WS_CLOSE_S) for the peer's."""

    def __init__(self):
        self._ws_writer: Optional[asyncio.StreamWriter] = None
        self._mask_out = False
        self._queue: Optional[asyncio.Queue] = None
        self._reader_task: Optional[asyncio.Task] = None
        self._peer_closed: Optional[asyncio.Event] = None
        self._closed = False
        self.close_code: Optional[int] = None

    def _attach(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter, *,
                client: bool) -> None:
        self._ws_writer = writer
        self._mask_out = client
        self._queue = asyncio.Queue()
        self._peer_closed = asyncio.Event()
        self._reader_task = asyncio.ensure_future(self._read_messages(reader, masked=not client))

    async def _read_messages(self, reader: asyncio.StreamReader, *, masked: bool) -> None:
        kind, parts, size = None, [], 0
        try:
            while True:
                fin, opcode, payload = await ws_read_frame(
                    reader, masked=masked, max_size=WS_MAX_MSG_SIZE)
                if opcode == WSMsgType.CLOSE:
                    if len(payload) == 1:
                        raise WebSocketError(WSCloseCode.PROTOCOL_ERROR, "Invalid close frame")
                    code = struct.unpack("!H", payload[:2])[0] if payload else 0
                    self._queue.put_nowait(WSMessage(
                        WSMsgType.CLOSE, code, payload[2:].decode("utf-8", "replace")))
                    return
                if opcode in (WSMsgType.PING, WSMsgType.PONG):
                    self._queue.put_nowait(WSMessage(WSMsgType(opcode), payload, ""))
                    continue
                if opcode in (WSMsgType.TEXT, WSMsgType.BINARY):
                    if kind is not None:
                        raise WebSocketError(WSCloseCode.PROTOCOL_ERROR,
                                             "a new message inside a fragmented one")
                    kind, parts, size = opcode, [], 0
                elif opcode != WSMsgType.CONTINUATION or kind is None:
                    raise WebSocketError(WSCloseCode.PROTOCOL_ERROR,
                                         f"Unexpected frame opcode {opcode}")
                parts.append(payload)
                size += len(payload)
                if size > WS_MAX_MSG_SIZE:
                    raise WebSocketError(WSCloseCode.MESSAGE_TOO_BIG,
                                         f"Message size {size} exceeds limit {WS_MAX_MSG_SIZE}")
                if not fin:
                    continue
                data = b"".join(parts)
                if kind == WSMsgType.TEXT:
                    try:
                        data = data.decode("utf-8")
                    except UnicodeDecodeError:
                        raise WebSocketError(WSCloseCode.INVALID_TEXT, "invalid UTF-8 text message")
                self._queue.put_nowait(WSMessage(WSMsgType(kind), data, ""))
                kind, parts = None, []
        except WebSocketError as exc:
            self._queue.put_nowait(WSMessage(WSMsgType.ERROR, exc, None))
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass
        finally:
            self._queue.put_nowait(None)  # the end of the stream
            self._peer_closed.set()

    @property
    def closed(self) -> bool:
        return self._closed

    async def _send(self, opcode: int, payload: bytes) -> None:
        if self._ws_writer is None:
            raise RuntimeError("Call .prepare() first")
        if self._closed or self._ws_writer.is_closing():
            raise ConnectionResetError("Cannot write to closing transport")
        self._ws_writer.write(ws_frame(opcode, payload, mask=self._mask_out))
        await self._ws_writer.drain()

    async def send_str(self, data: str) -> None:
        if not isinstance(data, str):
            raise TypeError(f"data argument must be str ({type(data)!r})")
        await self._send(WSMsgType.TEXT, data.encode("utf-8"))

    async def send_bytes(self, data: bytes) -> None:
        if not isinstance(data, (bytes, bytearray, memoryview)):
            raise TypeError(f"data argument must be byte-ish ({type(data)!r})")
        await self._send(WSMsgType.BINARY, bytes(data))

    async def close(self, *, code: int = WSCloseCode.OK, message: bytes = b"") -> bool:
        """Send a close frame, wait for the peer's and drop the connection;
        False when already closed."""
        if self._ws_writer is None:
            raise RuntimeError("Call .prepare() first")
        if self._closed:
            return False
        self._closed = True
        try:
            self._ws_writer.write(ws_frame(WSMsgType.CLOSE, struct.pack("!H", code) + message,
                                           mask=self._mask_out))
            await self._ws_writer.drain()
        except (ConnectionError, OSError):
            self.close_code = WSCloseCode.ABNORMAL_CLOSURE
            self._drop()
            return True
        if self.close_code is None:
            self.close_code = code
        try:
            await asyncio.wait_for(self._peer_closed.wait(), WS_CLOSE_S)
        except asyncio.TimeoutError:
            self.close_code = WSCloseCode.ABNORMAL_CLOSURE
        self._drop()
        return True

    def _drop(self) -> None:
        if self._reader_task is not None and not self._reader_task.done():
            self._reader_task.cancel()
        self._ws_writer.close()

    async def receive(self, timeout: Optional[float] = None) -> WSMessage:
        if self._queue is None:
            raise RuntimeError("Call .prepare() first")
        while True:
            if self._closed and self._queue.empty():
                return _CLOSED_MESSAGE
            get = self._queue.get()
            msg = await (get if timeout is None else asyncio.wait_for(get, timeout))
            if msg is None:  # the connection ended without a close frame
                self._queue.put_nowait(None)
                if not self._closed:
                    self._closed = True
                    self.close_code = WSCloseCode.ABNORMAL_CLOSURE
                    self._drop()
                return _CLOSED_MESSAGE
            if msg.type == WSMsgType.PING:
                try:
                    await self._send(WSMsgType.PONG, msg.data)
                except ConnectionError:
                    pass
                continue
            if msg.type == WSMsgType.PONG:
                continue
            if msg.type == WSMsgType.CLOSE:
                if not self._closed:
                    self.close_code = msg.data
                    await self.close()
            elif msg.type == WSMsgType.ERROR:
                self.close_code = msg.data.code
                await self.close(code=msg.data.code)
            return msg

    def __aiter__(self):
        return self

    async def __anext__(self) -> WSMessage:
        msg = await self.receive()
        if msg.type in (WSMsgType.CLOSE, WSMsgType.CLOSING, WSMsgType.CLOSED):
            raise StopAsyncIteration
        return msg


class WebSocketResponse(_WebSocket, StreamResponse):
    """The server's end of a WebSocket (``aiohttp.web.WebSocketResponse``):
    ``prepare(request)`` answers the upgrade (``101``, the accept key, and
    the first subprotocol of the client's offer that ``protocols`` holds),
    then the message surface of ``_WebSocket``. Its connection leaves the
    keep-alive loop and closes when the handler returns."""

    def __init__(self, *, protocols=()):
        StreamResponse.__init__(self, status=101)
        _WebSocket.__init__(self)
        self._protocols = tuple(protocols)
        self.ws_protocol: Optional[str] = None

    async def prepare(self, request: "Request") -> None:
        if self._writer is not None:
            return
        headers = request.headers
        if headers.get("Upgrade", "").lower() != "websocket":
            raise HTTPBadRequest(text=f"No WebSocket UPGRADE hdr: {headers.get('Upgrade')}\n "
                                      'Can "Upgrade" only to "WebSocket".')
        if "upgrade" not in headers.get("Connection", "").lower():
            raise HTTPBadRequest(text=f"No CONNECTION upgrade hdr: {headers.get('Connection')}")
        if headers.get("Sec-WebSocket-Version") != "13":
            raise HTTPBadRequest(
                text=f"Unsupported version: {headers.get('Sec-WebSocket-Version')}")
        key = headers.get("Sec-WebSocket-Key", "")
        try:
            valid = len(base64.b64decode(key, validate=True)) == 16
        except ValueError:
            valid = False
        if not valid:
            raise HTTPBadRequest(text=f"Handshake error: {key!r}")
        offered = [p.strip() for p in headers.get("Sec-WebSocket-Protocol", "").split(",")
                   if p.strip()]
        self.ws_protocol = next((p for p in offered if p in self._protocols), None)
        out = CIMultiDict([("Upgrade", "websocket"), ("Connection", "upgrade"),
                           ("Sec-WebSocket-Accept", ws_accept(key))])
        if self.ws_protocol:
            out["Sec-WebSocket-Protocol"] = self.ws_protocol
        conn = request._conn
        conn.upgraded, conn.keep_alive = True, False
        request._prepared = self
        self._writer = conn.writer
        _write_head(conn.writer, 101, "Switching Protocols", out, keep_alive=None)
        await conn.writer.drain()
        self._attach(conn.reader, conn.writer, client=False)


# ---------------------------------------------------------------------------
# The server
# ---------------------------------------------------------------------------


class _BadRequest(Exception):
    pass


# What the connection reads and drops of a body a handler left unread before
# it answers the next request on the connection; past either, it closes.
DRAIN_LIMIT = 1 << 20
DRAIN_S = 1.0
# Closing on a body still arriving, the connection first stops writing and
# reads and drops what comes for up to LINGER_S (aiohttp lingers too): a
# socket closed with unread bytes resets, and the reset can destroy the
# answer (a 413) before the client has read it.
LINGER_S = 5.0


class _Connection:
    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self.reader = reader
        self.writer = writer
        self.idle = True
        self.closing = False
        self.keep_alive = True
        self.upgraded = False
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
        request in flight finish and then close its connection. An open
        WebSocket is a handler in flight, as in aiohttp 3.13: it has up to
        ``shutdown_timeout`` to close, and is then cancelled."""
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
        payload = None
        try:
            while not conn.closing:
                conn.idle = True
                try:
                    head = await _read_head(reader)
                    if head is None:
                        break
                    conn.idle = False
                    method, target, version, headers = head
                    payload = _request_payload(reader, headers)
                except _BadRequest as exc:
                    await _write(writer, 400, _phrase(400), CIMultiDict(
                        {"Content-Type": "text/plain; charset=utf-8"}),
                        f"400, message:\n  {exc}".encode(), keep_alive=False, head_only=False)
                    break
                conn.keep_alive = _keep_alive(version, headers) and not conn.closing
                request = Request(self.app, method, target, version, headers, payload, remote,
                                  conn)
                response, reusable = await self._respond(request)
                if conn.upgraded:
                    break  # a WebSocket: its handler has ended
                if request._prepared is not None:
                    # The handler streamed its answer; one that raised after
                    # its head went out leaves the connection cut short.
                    if response is not request._prepared or not reusable:
                        break
                    await response.write_eof()
                    keep = conn.keep_alive
                elif not isinstance(response, Response):  # a StreamResponse left unprepared
                    await response.prepare(request)
                    await response.write_eof()
                    keep = conn.keep_alive
                else:
                    keep = conn.keep_alive and reusable and not conn.closing
                    if keep and not payload.at_eof():
                        keep = await _drain(payload)
                    try:
                        code, reason, out_headers, data = await response._render(request)
                    except HTTPException as exc:  # a FileResponse's file went missing
                        code, reason, out_headers, data = await exc._response()._render(request)
                    await _write(writer, code, reason, out_headers, data, keep_alive=keep,
                                 head_only=method.upper() == "HEAD")
                if not keep or not payload.at_eof():
                    break
            if payload is not None and not payload.at_eof() and not conn.upgraded:
                await _linger(reader, writer)
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            self._connections.discard(conn)
            try:
                writer.close()
            except Exception:  # noqa: BLE001 — the socket is already gone
                pass

    async def _respond(self, request: Request) -> tuple[StreamResponse, bool]:
        """The handler's response, and whether the connection may serve
        another request after it."""
        try:
            response = await self.app._handle(request)
        except HTTPException as exc:
            # A body past client_max_size, or one whose framing broke, is
            # still (partly) on the wire: answer and close.
            return exc._response(), not isinstance(exc, (HTTPRequestEntityTooLarge, PayloadError))
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001 — aiohttp's 500, connection closed
            log.exception("Error handling request %s %s", request.method, request.rel_url)
            return _server_error(), False
        if not isinstance(response, StreamResponse):
            log.error("handler for %s returned %r, not a Response", request.rel_url, response)
            return _server_error(), False
        return response, True


async def _linger(reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
    await writer.drain()
    if writer.can_write_eof():
        writer.write_eof()

    async def discard():
        while await reader.read(READ_CHUNK):
            pass

    try:
        await asyncio.wait_for(discard(), LINGER_S)
    except asyncio.TimeoutError:
        pass


async def _drain(payload: StreamReader) -> bool:
    """Drop the rest of a body the handler left unread; False (close the
    connection) past DRAIN_LIMIT bytes or DRAIN_S seconds."""
    try:
        return await asyncio.wait_for(payload.drain(DRAIN_LIMIT), DRAIN_S)
    except (asyncio.TimeoutError, HTTPException, ConnectionError):
        return False


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
    """The request line and headers (every value of a repeated name), or
    None at a clean end of stream."""
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
    headers = CIMultiDict()
    for _ in range(MAX_HEADERS + 1):
        raw = await _read_line(reader)
        if raw in (b"\r\n", b"\n"):
            return method, target, version, headers
        if not raw:
            raise _BadRequest("connection closed in the headers")
        name, sep, value = raw.decode("latin-1").partition(":")
        if not sep or not name or name != name.strip():
            raise _BadRequest(f"Bad header line {raw[:80]!r}")
        headers.add(name, value.strip())
    raise _BadRequest("too many headers")


def _request_payload(reader: asyncio.StreamReader, headers: CIMultiDict) -> StreamReader:
    """The request's body, left on the wire: chunked, or ``Content-Length``
    bytes (none without one)."""
    if "chunked" in headers.get("Transfer-Encoding", "").lower():
        return StreamReader(reader, chunked=True)
    try:
        length = int(headers.get("Content-Length", "0") or 0)
    except ValueError:
        raise _BadRequest("bad Content-Length")
    if length < 0:
        raise _BadRequest("negative Content-Length")
    return StreamReader(reader, length=length)


def _keep_alive(version: str, headers: CIMultiDict) -> bool:
    tokens = {t.strip().lower() for t in headers.get("Connection", "").split(",")}
    if version == "HTTP/1.0":
        return "keep-alive" in tokens
    return "close" not in tokens


def _bodiless(status: int) -> bool:
    return status in (204, 304) or 100 <= status < 200


def _write_head(writer: asyncio.StreamWriter, status: int, reason: str, headers: CIMultiDict, *,
                keep_alive: Optional[bool]) -> None:
    """The status line and headers (``Connection`` unless ``keep_alive`` is
    None: an upgrade)."""
    out = CIMultiDict(headers)
    out["Date"] = email.utils.formatdate(usegmt=True)
    out["Server"] = "panoptikon_tpu_torch"
    if keep_alive is not None:
        out["Connection"] = "keep-alive" if keep_alive else "close"
    lines = [f"HTTP/1.1 {status} {reason}\r\n"]
    lines += [f"{name}: {value}\r\n" for name, value in out.items()]
    writer.write(("".join(lines) + "\r\n").encode("latin-1"))


async def _write(writer: asyncio.StreamWriter, status: int, reason: str, headers: CIMultiDict,
                 body: bytes, *, keep_alive: bool, head_only: bool) -> None:
    out = CIMultiDict(headers)
    if not _bodiless(status):
        out["Content-Length"] = str(len(body))
    _write_head(writer, status, reason, out, keep_alive=keep_alive)
    if body and not _bodiless(status) and not head_only:
        writer.write(body)
    await writer.drain()
