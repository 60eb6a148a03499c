"""Typed Python client for the panoptikon_tpu HTTP API.

The port's copy of ``panoptikon_tpu/client.py``, held to it unit for unit by
``tests/test_torch_host_copies.py``.

The reference exposes its API to clients through generated TypeScript
bindings consumed by the Next.js UI and the Tauri desktop app (SURVEY §1
L8; `/root/reference/src/openapi.rs` publishes the schema they are built
from). This module is the Python-native equivalent: a dependency-free
synchronous client over :mod:`http.client` with persistent keep-alive
connections, typed errors mapped from the server's ``{"error": ...}``
envelope, and one resource namespace per API area mirroring the server's
route table (``api/server.py``).

Design notes:

- **stdlib only** — a serving client must not drag the framework's JAX
  stack into an ingest script; numpy is imported lazily and only by the
  :func:`raw_embedding_query` convenience.
- **keep-alive per thread** — connections are cached in a
  ``threading.local`` so concurrent callers never share a socket (the
  reference's reqwest client pools the same way, inferio_client.rs).
- **database pinning** — ``index_db`` is injected as a query parameter on
  every ``/api/`` call, matching the server's ``_db_name`` resolution; a
  policy token (``x-panoptikon-policy``) rides every request when given.

Usage::

    from panoptikon_tpu_torch.client import PanoptikonClient

    c = PanoptikonClient("http://127.0.0.1:6342")
    c.jobs.set_folders(included=["/data/media"])
    job = c.jobs.enqueue_extraction("clip/vit-b-32")
    page = c.search.pql({"query": {"image_embeddings": {
        "query": "a red bicycle", "model": "clip/vit-b-32"}}, "page_size": 10})
"""

from __future__ import annotations

import base64
import json
import threading
import urllib.parse
from dataclasses import dataclass
from http.client import HTTPConnection, HTTPSConnection
from typing import Any, Iterable, Mapping, Sequence

POLICY_TOKEN_HEADER = "x-panoptikon-policy"


class PanoptikonError(Exception):
    """A non-2xx API response, carrying the server's error envelope."""

    def __init__(self, status: int, message: str, *, path: str = ""):
        self.status = status
        self.message = message
        self.path = path
        super().__init__(f"HTTP {status} on {path}: {message}")


@dataclass
class FileResponse:
    """A streamed binary endpoint result (item file / thumbnail)."""

    status: int
    content_type: str
    body: bytes
    content_range: str | None = None
    accept_ranges: str | None = None


def raw_embedding_query(vector) -> str:
    """Encode a raw query vector as the base64 npy string the semantic
    filters accept in place of text (``embed: null`` mode) — the same
    payload the PQL preprocessor produces from a model embed."""
    import numpy as np

    from panoptikon_tpu_torch.utils import npy

    vec = np.asarray(vector, dtype=np.float32).reshape(-1)
    return base64.standard_b64encode(npy.serialize_npy(vec)).decode()


class PanoptikonClient:
    """Synchronous client over the full HTTP surface.

    Parameters
    ----------
    base_url:
        ``http://host:port`` of a server listener.
    index_db:
        Optional database name pinned onto every ``/api/`` request.
    policy_token:
        Optional SSR policy token sent as ``x-panoptikon-policy``.
    timeout:
        Per-request socket timeout in seconds.
    """

    def __init__(
        self,
        base_url: str = "http://127.0.0.1:6342",
        *,
        index_db: str | None = None,
        policy_token: str | None = None,
        timeout: float = 60.0,
    ):
        parsed = urllib.parse.urlsplit(base_url)
        if parsed.scheme not in ("http", "https"):
            raise ValueError(f"unsupported scheme: {parsed.scheme!r}")
        if not parsed.hostname:
            raise ValueError(f"base_url has no host: {base_url!r}")
        self._scheme = parsed.scheme
        self._host = parsed.hostname
        self._port = parsed.port or (443 if parsed.scheme == "https" else 80)
        self._prefix = parsed.path.rstrip("/")
        self.index_db = index_db
        self.policy_token = policy_token
        self.timeout = timeout
        self._local = threading.local()

        self.search = _Search(self)
        self.items = _Items(self)
        self.bookmarks = _Bookmarks(self)
        self.pinboards = _Pinboards(self)
        self.jobs = _Jobs(self)
        self.config = _Config(self)
        self.inference = _Inference(self)
        self.databases = _Databases(self)
        self.relay = _Relay(self)
        self.desktop = _Desktop(self)

    # -- transport ----------------------------------------------------------

    def _conn(self):
        conn = getattr(self._local, "conn", None)
        if conn is None:
            cls = HTTPSConnection if self._scheme == "https" else HTTPConnection
            conn = cls(self._host, self._port, timeout=self.timeout)
            self._local.conn = conn
        return conn

    def close(self) -> None:
        """Close this thread's persistent connection (others close on GC)."""
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            conn.close()
            self._local.conn = None

    def __enter__(self) -> "PanoptikonClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # POST routes that are mutation-free by contract (the server's policy
    # layer exempts them from read_only the same way) — safe to retry.
    READONLY_POSTS = ("/api/search/pql", "/api/search/pql/build")

    def request(
        self,
        method: str,
        path: str,
        *,
        params: Mapping[str, Any] | None = None,
        json_body: Any = None,
        raw: bool = False,
        headers: Mapping[str, str] | None = None,
        idempotent: bool | None = None,
    ) -> Any:
        """One API call. Returns parsed JSON, or a :class:`FileResponse`
        when ``raw=True``. Raises :class:`PanoptikonError` on non-2xx."""
        q = dict(params or {})
        if self.index_db is not None and path.startswith("/api/"):
            q.setdefault("index_db", self.index_db)
        q = {k: v for k, v in q.items() if v is not None}
        url = self._prefix + path
        if q:
            url += "?" + urllib.parse.urlencode(q)
        hdrs = {"accept": "application/json"}
        if self.policy_token:
            hdrs[POLICY_TOKEN_HEADER] = self.policy_token
        body = None
        if json_body is not None:
            body = json.dumps(json_body).encode()
            hdrs["content-type"] = "application/json"
        if headers:
            hdrs.update(headers)

        # One retry on a dropped keep-alive socket. A failure while SENDING
        # (stale idle connection the server closed) is safe to retry for
        # any method — the request never completed. A failure AWAITING the
        # response is ambiguous: the server may have executed the call, so
        # only idempotent calls retry. GET/HEAD/PUT/DELETE default to
        # idempotent (this API's PUT/DELETEs are upserts/sets), POST to not
        # (a re-sent POST could enqueue a job twice) — except the
        # mutation-free search POSTs; callers whose semantics differ
        # (e.g. a folders PUT that triggers a rescan job) override via
        # the ``idempotent`` parameter.
        if idempotent is None:
            idempotent = (
                method in ("GET", "HEAD", "PUT", "DELETE")
                or (method == "POST" and path in self.READONLY_POSTS)
            )
        conn = self._conn()
        for attempt in (0, 1):
            sent = False
            try:
                conn.request(method, url, body=body, headers=hdrs)
                sent = True
                resp = conn.getresponse()
                payload = resp.read()
                break
            except (ConnectionError, BrokenPipeError, OSError):
                self.close()
                if attempt or (sent and not idempotent):
                    raise
                conn = self._conn()

        ctype = resp.getheader("content-type", "") or ""
        if resp.status >= 400:
            message = payload.decode("utf-8", "replace")
            if ctype.startswith("application/json"):
                try:
                    message = json.loads(payload).get("error", message)
                except (ValueError, AttributeError):
                    pass
            raise PanoptikonError(resp.status, message, path=path)
        if raw:
            return FileResponse(
                status=resp.status,
                content_type=ctype,
                body=payload,
                content_range=resp.getheader("content-range"),
                accept_ranges=resp.getheader("accept-ranges"),
            )
        if not payload:
            return None
        if ctype.startswith("application/json"):
            return json.loads(payload)
        return payload

    # -- top-level endpoints -------------------------------------------------

    def health(self) -> dict:
        return self.request("GET", "/health")

    def openapi(self) -> dict:
        return self.request("GET", "/openapi.json")

    def client_config(self) -> dict:
        return self.request("GET", "/api/client-config")

    def accelerator(self) -> dict:
        return self.request("GET", "/api/accelerator")


class _Resource:
    def __init__(self, client: PanoptikonClient):
        self._c = client


class _Search(_Resource):
    def pql(self, query: Mapping[str, Any]) -> dict:
        """``POST /api/search/pql`` with a full PQL body (query, order_by,
        page/page_size, entity, count/results, seed, cache...)."""
        return self._c.request("POST", "/api/search/pql", json_body=dict(query))

    def pql_build(self, query: Mapping[str, Any]) -> dict:
        """Compile-only endpoint: returns the execution plan, runs nothing."""
        return self._c.request(
            "POST", "/api/search/pql/build", json_body=dict(query)
        )

    def stats(self) -> dict:
        return self._c.request("GET", "/api/search/stats")

    def cache_stats(self) -> dict:
        return self._c.request("GET", "/api/search/cache")

    def cache_resize(self, *, byte_budget: int) -> dict:
        return self._c.request(
            "PUT", "/api/search/cache", json_body={"byte_budget": byte_budget}
        )

    def cache_clear(self) -> dict:
        return self._c.request("DELETE", "/api/search/cache")

    def embedding_cache_stats(self) -> dict:
        return self._c.request("GET", "/api/search/embeddings/cache")

    def embedding_cache_clear(self) -> dict:
        return self._c.request("DELETE", "/api/search/embeddings/cache")

    def tags_top(
        self, *, limit: int = 100, namespace: str | None = None,
        setters: Sequence[str] | None = None,
        confidence_threshold: float | None = None,
    ) -> Any:
        return self._c.request(
            "GET", "/api/search/tags/top",
            params={
                "limit": limit, "namespace": namespace,
                "setters": ",".join(setters) if setters else None,
                "confidence_threshold": confidence_threshold,
            },
        )

    def tags_autocomplete(self, prefix: str, *, limit: int = 25) -> Any:
        return self._c.request(
            "GET", "/api/search/tags", params={"q": prefix, "limit": limit}
        )


class _Items(_Resource):
    def metadata(self, ident: str, *, id_type: str | None = None) -> dict:
        """Item metadata by sha256 (default) or any reference identifier
        — ``id_type`` in sha256/item_id/file_id/data_id/path/md5
        (api/items.rs ItemIdentifierType)."""
        enc = urllib.parse.quote(str(ident), safe="")
        return self._c.request(
            "GET", f"/api/items/{enc}", params={"id_type": id_type}
        )

    def file(
        self, sha256: str, *, byte_range: tuple[int, int | None] | None = None
    ) -> FileResponse:
        """Fetch file bytes; ``byte_range=(start, end)`` issues an HTTP
        Range request (end inclusive, ``None`` = to EOF) and returns 206."""
        headers = {}
        if byte_range is not None:
            start, end = byte_range
            headers["range"] = f"bytes={start}-{'' if end is None else end}"
        return self._c.request(
            "GET", f"/api/items/{sha256}/file", raw=True, headers=headers
        )

    def thumbnail(self, sha256: str) -> FileResponse:
        return self._c.request(
            "GET", f"/api/items/{sha256}/thumbnail", raw=True
        )

    def open(self, sha256: str, *, folder: bool = False) -> dict:
        return self._c.request(
            "POST", f"/api/open/{sha256}",
            params={"folder": "1" if folder else "0"},
        )

    def texts_any(self, text_ids: Sequence[int]) -> dict:
        """Texts by extracted-text id (reference items.rs texts_any)."""
        return self._c.request(
            "GET", "/api/items/text/any",
            params={"text_ids": ",".join(str(i) for i in text_ids)},
        )


class _Bookmarks(_Resource):
    def list(self, user: str, *, namespace: str | None = None) -> Any:
        return self._c.request(
            "GET", f"/api/bookmarks/{user}", params={"namespace": namespace}
        )

    def users(self) -> dict:
        return self._c.request("GET", "/api/bookmarks/users")

    def delete_namespace(self, user: str, namespace: str) -> dict:
        """Bulk-delete a namespace's bookmarks (bookmarks.rs
        delete_bookmarks_by_namespace)."""
        return self._c.request(
            "DELETE", f"/api/bookmarks/{user}/{namespace}"
        )

    def namespaces(self, user: str) -> dict:
        return self._c.request("GET", f"/api/bookmarks/{user}/ns")

    def put(
        self, user: str, namespace: str, sha256: str,
        *, metadata: Mapping[str, Any] | None = None,
    ) -> dict:
        return self._c.request(
            "PUT", f"/api/bookmarks/{user}/{namespace}/{sha256}",
            json_body={"metadata": dict(metadata)} if metadata else {},
        )

    def delete(self, user: str, namespace: str, sha256: str) -> dict:
        return self._c.request(
            "DELETE", f"/api/bookmarks/{user}/{namespace}/{sha256}"
        )


class _Pinboards(_Resource):
    def list(self, user: str) -> Any:
        return self._c.request("GET", f"/api/pinboards/{user}")

    def create(self, user: str, name: str) -> dict:
        return self._c.request(
            "POST", f"/api/pinboards/{user}", json_body={"name": name}
        )

    def get(self, user: str, pinboard_id: int) -> dict:
        return self._c.request("GET", f"/api/pinboards/{user}/{pinboard_id}")

    def save_version(
        self, user: str, pinboard_id: int, *,
        layout: Any, items: Iterable[str] | None = None,
        preview_b64: str | None = None, **extra: Any,
    ) -> dict:
        """Append a version snapshot. ``layout`` is the client's layout
        JSON (a flat list of sha256 strings doubles as the item set);
        ``preview_b64`` attaches a base64 preview blob; ``extra`` passes
        name/preview_w/preview_h/screenful_h through."""
        body: dict[str, Any] = {"layout": layout, **extra}
        if items is not None:
            body["items"] = list(items)
        if preview_b64 is not None:
            body["preview_b64"] = preview_b64
        return self._c.request(
            "POST", f"/api/pinboards/{user}/{pinboard_id}/versions",
            json_body=body,
        )

    def delete(self, user: str, pinboard_id: int) -> dict:
        return self._c.request(
            "DELETE", f"/api/pinboards/{user}/{pinboard_id}"
        )

    def get_version(
        self, user: str, pinboard_id: int, version_id: int
    ) -> dict:
        return self._c.request(
            "GET",
            f"/api/pinboards/{user}/{pinboard_id}/versions/{version_id}",
        )

    def version_preview(
        self, user: str, pinboard_id: int, version_id: int
    ) -> FileResponse:
        return self._c.request(
            "GET",
            f"/api/pinboards/{user}/{pinboard_id}/versions/{version_id}/preview",
            raw=True,
        )

    def put_version_preview(
        self, user: str, pinboard_id: int, version_id: int, *,
        preview_b64: str, **extra: Any,
    ) -> dict:
        return self._c.request(
            "PUT",
            f"/api/pinboards/{user}/{pinboard_id}/versions/{version_id}/preview",
            json_body={"preview_b64": preview_b64, **extra},
        )

    def search(self, query: Any = None, *, user: str = "user") -> dict:
        """Boards whose pinned images match a PQL query (reference
        search.rs search_pql_pinboards): unpaginated, board-ranked."""
        return self._c.request(
            "POST", "/api/pinboards/search", params={"user": user},
            json_body=query or {},
        )


class _Jobs(_Resource):
    def queue(self) -> Any:
        return self._c.request("GET", "/api/jobs/queue")

    def cancel(self, job_id: int) -> dict:
        return self._c.request("DELETE", f"/api/jobs/queue/{job_id}")

    def enqueue_extraction(self, inference_id: str, **options: Any) -> dict:
        return self._c.request(
            "POST", "/api/jobs/data/extraction",
            json_body={"inference_id": inference_id, **options},
        )

    def delete_setter_data(self, setter_name: str) -> dict:
        return self._c.request(
            "DELETE", "/api/jobs/data",
            json_body={"setter_name": setter_name},
        )

    def get_folders(self) -> dict:
        return self._c.request("GET", "/api/jobs/folders")

    def set_folders(
        self,
        *,
        included: Iterable[str] | None = None,
        excluded: Iterable[str] | None = None,
        rescan: bool = True,
    ) -> dict:
        """Register folders; the server enqueues a rescan unless
        ``rescan=False`` (pass False when you will trigger one yourself)."""
        body: dict[str, Any] = {"rescan": rescan}
        if included is not None:
            body["included"] = list(included)
        if excluded is not None:
            body["excluded"] = list(excluded)
        # With rescan=True this PUT enqueues a job — NOT idempotent; a
        # response-phase retry could double-enqueue the rescan.
        return self._c.request(
            "PUT", "/api/jobs/folders", json_body=body,
            idempotent=not rescan,
        )

    def rescan_folders(self) -> dict:
        return self._c.request("POST", "/api/jobs/folders/rescan")

    def update_folders(self) -> dict:
        return self._c.request("POST", "/api/jobs/folders/update")

    def data_deletion(self) -> dict:
        """Enqueue orphaned-item deletion (items with no available file)."""
        return self._c.request("POST", "/api/jobs/data/deletion")

    def continuous_status(self) -> Any:
        return self._c.request("GET", "/api/jobs/continuous")

    def history_scans(self, *, limit: int = 50) -> Any:
        return self._c.request(
            "GET", "/api/jobs/history/scans", params={"limit": limit}
        )

    def history_data(self, *, limit: int = 50) -> Any:
        return self._c.request(
            "GET", "/api/jobs/history/data", params={"limit": limit}
        )

    def failures_extraction(self, *, setter: str | None = None) -> Any:
        return self._c.request(
            "GET", "/api/jobs/failures/extraction", params={"setter": setter}
        )

    def clear_failures_extraction(
        self, *, setter: str | None = None, item_id: int | None = None
    ) -> dict:
        return self._c.request(
            "DELETE", "/api/jobs/failures/extraction",
            params={"setter": setter, "item_id": item_id},
        )

    def failures_scan(self) -> Any:
        return self._c.request("GET", "/api/jobs/failures/scan")

    def quants(self) -> Any:
        return self._c.request("GET", "/api/jobs/quants")

    def reconcile_quants(self, **body: Any) -> dict:
        return self._c.request(
            "POST", "/api/jobs/quants/reconcile", json_body=body
        )

    def get_cron(self) -> Any:
        return self._c.request("GET", "/api/jobs/cron")

    def set_cron(self, jobs: Any) -> dict:
        return self._c.request("PUT", "/api/jobs/cron", json_body=jobs)

    def run_cron(self) -> dict:
        """Trigger every configured cron entry now (jobs.rs
        manual_trigger_cronjob)."""
        return self._c.request("POST", "/api/jobs/cronjob/run")

    def cron_schedule(self) -> dict:
        return self._c.request("GET", "/api/jobs/cronjob/schedule")

    def maintenance(self) -> dict:
        """Enqueue the deferred ANALYZE/checkpoint/VACUUM unit on demand."""
        return self._c.request("POST", "/api/jobs/maintenance")

    def setters_total(self) -> dict:
        return self._c.request("GET", "/api/jobs/data/setters/total")

    def wait(
        self, job_id: int, *, timeout: float = 600.0, poll_s: float = 0.25
    ) -> dict:
        """Poll the queue until ``job_id`` is neither running nor pending;
        returns its history entry (keys: job_id/type/state/error/...), or a
        synthesized ``{"job_id", "state": "unknown"}`` if history already
        rotated it out. Raises TimeoutError after ``timeout`` seconds."""
        import time as _time

        deadline = _time.monotonic() + timeout
        while _time.monotonic() < deadline:
            status = self.queue() or {}
            running = status.get("running")
            active = ([running] if running else []) + list(
                status.get("pending", [])
            )
            if not any(e.get("job_id") == job_id for e in active):
                for entry in reversed(status.get("history", [])):
                    if entry.get("job_id") == job_id:
                        return entry
                return {"job_id": job_id, "state": "unknown"}
            _time.sleep(poll_s)
        raise TimeoutError(f"job {job_id} still queued after {timeout}s")


class _Config(_Resource):
    def get(self) -> dict:
        return self._c.request("GET", "/api/config/system")

    def put(self, config: Mapping[str, Any]) -> dict:
        return self._c.request(
            "PUT", "/api/config/system", json_body=dict(config)
        )


class _Inference(_Resource):
    def metadata(self) -> dict:
        return self._c.request("GET", "/metadata")

    def pool(self) -> Any:
        return self._c.request("GET", "/api/inference/pool")

    def predict(
        self,
        inference_id: str,
        inputs: Iterable[Any],
        *,
        files: Mapping[int, bytes] | None = None,
        cache_key: str = "default",
        lru_size: int = 1,
        ttl_seconds: float = 3600,
        max_batch: int | None = None,
    ) -> list:
        """``POST /predict/{group}/{id}``. ``inputs`` are per-slot JSON
        payloads; ``files[i]`` attaches raw bytes to slot i (sent as
        ``file_b64``, the JSON transport the server accepts alongside
        multipart). Binary outputs come back decoded to ``bytes``."""
        group, _, short = inference_id.partition("/")
        body_inputs = []
        for i, data in enumerate(inputs):
            entry = data if isinstance(data, dict) else {"data": data}
            if files and i in files:
                entry = dict(entry)
                entry["file_b64"] = base64.b64encode(files[i]).decode()
            body_inputs.append(entry)
        out = self._c.request(
            "POST", f"/predict/{group}/{short}",
            params={
                "cache_key": cache_key, "lru_size": lru_size,
                "ttl_seconds": ttl_seconds, "max_batch": max_batch,
            },
            json_body={"inputs": body_inputs},
        )
        decoded = []
        for slot in out.get("outputs", []):
            if isinstance(slot, dict) and slot.get("__type__") == "base64":
                decoded.append(base64.b64decode(slot["content"]))
            else:
                decoded.append(slot)
        return decoded

    def load(
        self,
        inference_id: str,
        *,
        cache_key: str = "default",
        lru_size: int = 1,
        ttl_seconds: float = 3600,
        prewarm: bool = False,
    ) -> dict:
        group, _, short = inference_id.partition("/")
        return self._c.request(
            "PUT", f"/load/{group}/{short}",
            params={
                "cache_key": cache_key, "lru_size": lru_size,
                "ttl_seconds": ttl_seconds,
                "prewarm": "true" if prewarm else None,
            },
        )

    def unload(self, inference_id: str, *, cache_key: str = "default") -> dict:
        group, _, short = inference_id.partition("/")
        return self._c.request(
            "DELETE", f"/load/{group}/{short}",
            params={"cache_key": cache_key},
        )

    def cache_list(self) -> Any:
        return self._c.request("GET", "/cache")

    def cache_clear(self, cache_key: str) -> dict:
        return self._c.request("DELETE", f"/cache/{cache_key}")


class _Databases(_Resource):
    def list(self) -> Any:
        return self._c.request("GET", "/api/db")

    def create(self, name: str) -> dict:
        return self._c.request("POST", "/api/db", json_body={"name": name})


class _Relay(_Resource):
    """Two-phase Relay pairing recovery (api/relay.py; reference
    api/relay.rs): begin an operation, commit the credential, recover it
    later by relay id."""

    def pairing(self, relay_id: str) -> dict:
        return self._c.request("GET", f"/api/relay/pairings/{relay_id}")

    def delete_pairing(self, relay_id: str) -> dict:
        return self._c.request("DELETE", f"/api/relay/pairings/{relay_id}")

    def operation(self, relay_id: str) -> dict:
        return self._c.request(
            "GET", f"/api/relay/pairing-operations/{relay_id}"
        )

    def begin(self, relay_id: str) -> dict:
        return self._c.request(
            "POST", f"/api/relay/pairing-operations/{relay_id}"
        )

    def commit(
        self, operation_id: str, *, relay_id: str, instance_id: str,
        credential: str,
    ) -> Any:
        return self._c.request(
            "POST", f"/api/relay/pairing-operations/{operation_id}/commit",
            json_body={
                "relay_id": relay_id, "instance_id": instance_id,
                "credential": credential,
            },
        )

    def cancel(self, operation_id: str) -> Any:
        return self._c.request(
            "POST", f"/api/relay/pairing-operations/{operation_id}/cancel"
        )


class _Desktop(_Resource):
    def update_status(self) -> dict:
        return self._c.request("GET", "/api/desktop/update-status")

    def snooze_ribbon(self) -> dict:
        return self._c.request("POST", "/api/desktop/update-ribbon/snooze")

    def dismiss_ribbon(self) -> dict:
        return self._c.request("POST", "/api/desktop/update-ribbon/dismiss")

    def external_inputs(self) -> Any:
        return self._c.request("GET", "/api/desktop/external-inputs")

    def set_external_input(self, variable: str, value: str) -> dict:
        return self._c.request(
            "PUT", f"/api/desktop/external-inputs/{variable}",
            json_body={"value": value},
        )

    # Setup wizard (desktop-managed servers only; api/desktop.rs setup_*).

    def setup_status(self) -> dict:
        return self._c.request("GET", "/api/desktop/setup-status")

    def validate_setup_folders(self, **body: Any) -> dict:
        return self._c.request(
            "POST", "/api/desktop/setup-folders/validate", json_body=body
        )

    def validate_setup_continuous(self, **body: Any) -> dict:
        return self._c.request(
            "POST", "/api/desktop/setup-continuous/validate", json_body=body
        )

    def preview_setup_schedule(self, cron_schedule: str) -> dict:
        return self._c.request(
            "POST", "/api/desktop/setup-schedule/preview",
            json_body={"cron_schedule": cron_schedule},
        )

    def complete_setup(self, **body: Any) -> dict:
        return self._c.request(
            "POST", "/api/desktop/setup/complete", json_body=body
        )

    def open_update_window(self) -> Any:
        return self._c.request("POST", "/api/desktop/update-window/open")
