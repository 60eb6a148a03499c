"""Async Python client for the panoptikon_tpu_torch HTTP API.

The port's copy of ``panoptikon_tpu/aclient.py``, held to it unit for unit
by ``tests/test_torch_host_copies.py``; its session is the port's own
(``api/web_client.py``: the card machine has no ``aiohttp``).

The async twin of :mod:`panoptikon_tpu_torch.client`: same resource layout,
same typed errors, same database pinning and policy-token handling —
for use inside asyncio services (the reference's own UI and desktop
clients are async consumers of the same surface).

The resource namespaces are generated from the sync client's modules by
wrapping each public method: every sync method resolves to one
``request()`` call, so the async twin routes the identical
(method, path, params, body) through a ``ClientSession``. This keeps the
two clients impossible to drift apart — the OpenAPI coverage guard in
``tests/test_client.py`` pins the sync surface, and this module mirrors it
mechanically.

Usage::

    async with AsyncPanoptikonClient("http://127.0.0.1:6342") as c:
        page = await c.search.pql({"page_size": 10})
        meta = await c.items.metadata(page["results"][0]["sha256"])
"""

from __future__ import annotations

import json
from typing import Any, Mapping

from panoptikon_tpu_torch import client as _sync
from panoptikon_tpu_torch.client import (  # noqa: F401  (re-exported surface)
    POLICY_TOKEN_HEADER,
    FileResponse,
    PanoptikonError,
)


class _AsyncResource:
    """Wraps a sync resource class: each public method runs against a
    recording stub to capture its single ``request()`` call, then replays
    that call through the async transport."""

    def __init__(self, aclient: "AsyncPanoptikonClient", sync_cls):
        self._aclient = aclient
        self._sync_cls = sync_cls

    def __getattr__(self, name: str):
        method = getattr(self._sync_cls, name, None)
        if method is None or name.startswith("_") or not callable(method):
            raise AttributeError(name)

        async def call(*args, **kwargs):
            stub = self._sync_cls(_Recorder())
            try:
                method(stub, *args, **kwargs)
            except _Recorded as rec:
                return await self._aclient.request(
                    *rec.req_args, **rec.req_kwargs
                )
            raise TypeError(
                f"{self._sync_cls.__name__}.{name} never issued a request; "
                "override it on the async resource"
            )

        return call


class _Recorded(Exception):
    def __init__(self, args, kwargs):
        super().__init__("recorded")
        self.req_args = args
        self.req_kwargs = kwargs


class _Recorder:
    """Stands in for the sync PanoptikonClient inside a resource: the
    first transport call raises with the captured request."""

    index_db = None
    policy_token = None

    def request(self, *args, **kwargs):
        raise _Recorded(args, kwargs)


class AsyncPanoptikonClient:
    """Async client over the full HTTP surface (see the sync client for
    per-resource documentation — the methods and signatures match)."""

    READONLY_POSTS = _sync.PanoptikonClient.READONLY_POSTS

    def __init__(
        self,
        base_url: str = "http://127.0.0.1:6342",
        *,
        index_db: str | None = None,
        policy_token: str | None = None,
        timeout: float = 60.0,
    ):
        self.base_url = base_url.rstrip("/")
        self.index_db = index_db
        self.policy_token = policy_token
        self.timeout = timeout
        self._session = None

        self.search = _AsyncResource(self, _sync._Search)
        self.items = _AsyncResource(self, _sync._Items)
        self.bookmarks = _AsyncResource(self, _sync._Bookmarks)
        self.pinboards = _AsyncResource(self, _sync._Pinboards)
        self.jobs = _AsyncJobs(self, _sync._Jobs)
        self.config = _AsyncResource(self, _sync._Config)
        self.inference = _AsyncInference(self, _sync._Inference)
        self.databases = _AsyncResource(self, _sync._Databases)
        self.relay = _AsyncResource(self, _sync._Relay)
        self.desktop = _AsyncResource(self, _sync._Desktop)

    async def _ensure(self):
        if self._session is None:
            from panoptikon_tpu_torch.api import web_client

            self._session = web_client.ClientSession(
                timeout=web_client.ClientTimeout(total=self.timeout)
            )
        return self._session

    async def close(self) -> None:
        if self._session is not None:
            await self._session.close()
            self._session = None

    async def __aenter__(self) -> "AsyncPanoptikonClient":
        await self._ensure()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.close()

    async def request(
        self,
        method: str,
        path: str,
        *,
        params: Mapping[str, Any] | None = None,
        json_body: Any = None,
        raw: bool = False,
        headers: Mapping[str, str] | None = None,
        idempotent: bool | None = None,  # noqa: ARG002 — aiohttp pools/retries
    ) -> Any:
        session = await self._ensure()
        q = {k: v for k, v in dict(params or {}).items() if v is not None}
        if self.index_db is not None and path.startswith("/api/"):
            q.setdefault("index_db", self.index_db)
        hdrs = {"accept": "application/json"}
        if self.policy_token:
            hdrs[POLICY_TOKEN_HEADER] = self.policy_token
        if headers:
            hdrs.update(headers)
        # aiohttp requires string param values.
        q = {k: (str(v).lower() if isinstance(v, bool) else str(v))
             for k, v in q.items()}
        async with session.request(
            method, self.base_url + path, params=q, json=json_body,
            headers=hdrs,
        ) as resp:
            payload = await resp.read()
            ctype = resp.headers.get("content-type", "")
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
                    status=resp.status, content_type=ctype, body=payload,
                    content_range=resp.headers.get("content-range"),
                    accept_ranges=resp.headers.get("accept-ranges"),
                )
            if not payload:
                return None
            if ctype.startswith("application/json"):
                return json.loads(payload)
            return payload

    async def health(self) -> dict:
        return await self.request("GET", "/health")

    async def openapi(self) -> dict:
        return await self.request("GET", "/openapi.json")

    async def client_config(self) -> dict:
        return await self.request("GET", "/api/client-config")

    async def accelerator(self) -> dict:
        return await self.request("GET", "/api/accelerator")


class _AsyncJobs(_AsyncResource):
    """jobs.wait needs an async poll loop (the sync one blocks)."""

    async def wait(
        self, job_id: int, *, timeout: float = 600.0, poll_s: float = 0.25
    ) -> dict:
        import asyncio
        import time as _time

        deadline = _time.monotonic() + timeout
        while _time.monotonic() < deadline:
            status = await self.queue() or {}
            running = status.get("running")
            active = ([running] if running else []) + list(
                status.get("pending", [])
            )
            if not any(e.get("job_id") == job_id for e in active):
                for entry in reversed(status.get("history", [])):
                    if entry.get("job_id") == job_id:
                        return entry
                return {"job_id": job_id, "state": "unknown"}
            await asyncio.sleep(poll_s)
        raise TimeoutError(f"job {job_id} still queued after {timeout}s")


class _AsyncInference(_AsyncResource):
    """predict post-processes the response (base64 slots) — reimplemented
    on the async transport."""

    async def predict(
        self,
        inference_id: str,
        inputs,
        *,
        files: Mapping[int, bytes] | None = None,
        cache_key: str = "default",
        lru_size: int = 1,
        ttl_seconds: float = 3600,
        max_batch: int | None = None,
    ) -> list:
        import base64

        group, _, short = inference_id.partition("/")
        body_inputs = []
        for i, data in enumerate(inputs):
            entry = data if isinstance(data, dict) else {"data": data}
            if files and i in files:
                entry = dict(entry)
                entry["file_b64"] = base64.b64encode(files[i]).decode()
            body_inputs.append(entry)
        out = await self._aclient.request(
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
