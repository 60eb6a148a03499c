"""Durable, policy-scoped Relay pairing registry + two-phase operations.

The port's copy of ``panoptikon_tpu/api/relay.py``, held to it unit for unit by
``tests/test_torch_host_copies.py``. Its handlers run on the port's transport, ``api/web.py``.

File actions never pass through the server (reference api/relay.rs:1-5):
the desktop Relay holds the credential; this registry only lets a browser
RECOVER a relay credential and RESUME an interrupted pairing operation.

Contract (reference api/relay.rs:230-430):

- Pairings and pending operations are scoped per POLICY NAME — one
  listener's boards cannot read another's credentials.
- Operations are the two-phase half: ``begin`` (idempotent per
  (policy, relay_id), 202 on create) reserves an operation id with a
  10-minute TTL; ``commit`` binds the credential (idempotent replay →
  204; a different live pairing → 409 CONFLICT; expired/unknown
  operation → 410 GONE); ``cancel`` discards it.
- The store is a JSON file under the data root — pairings survive
  restarts (the whole point: recovery after an interrupted pairing).
- Bounds: 256 pending operations (64/policy), 4096 pairings
  (2048/policy) — api/relay.rs:24-28.
- Every response carries ``Cache-Control: no-store`` (credentials).
"""

from __future__ import annotations

import asyncio
import json
import os
import time
import uuid
from dataclasses import dataclass, field
from pathlib import Path

from panoptikon_tpu_torch.api import web

OPERATION_TTL_S = 10 * 60
MAX_PENDING_OPERATIONS = 256
MAX_PENDING_OPERATIONS_PER_POLICY = 64
MAX_PAIRINGS = 4096
MAX_PAIRINGS_PER_POLICY = 2048


def _now() -> int:
    return int(time.time())


@dataclass
class RelayStore:
    """File-backed pairing store. All mutation happens under ``lock`` on
    the event loop (file IO is small and local; the reference serializes
    through a global mutex the same way, api/relay.rs:23)."""

    path: Path
    lock: asyncio.Lock = field(default_factory=asyncio.Lock)
    pairings: list[dict] = field(default_factory=list)
    operations: list[dict] = field(default_factory=list)
    _loaded: bool = False

    def _load(self) -> None:
        if self._loaded:
            return
        self._loaded = True
        try:
            raw = json.loads(self.path.read_text())
            self.pairings = list(raw.get("pairings", []))
            self.operations = list(raw.get("operations", []))
        except (OSError, ValueError):
            self.pairings, self.operations = [], []

    def _save(self) -> None:
        tmp = self.path.with_suffix(".tmp")
        tmp.write_text(
            json.dumps(
                {"pairings": self.pairings, "operations": self.operations}
            )
        )
        os.replace(tmp, self.path)

    def prune(self, now: int) -> bool:
        live = [o for o in self.operations if o["expires_unix"] > now]
        changed = len(live) != len(self.operations)
        self.operations = live
        return changed


# One store per file, shared by every listener app in the process —
# per-app instances would race their saves on the same JSON (the reference
# serializes all access through one global mutex, api/relay.rs:23).
_STORES: dict[str, RelayStore] = {}


def _store(request: web.Request) -> RelayStore:
    state = request.app["state"]
    path = Path(state.data_root) / "relay_pairings.json"
    key = str(path)
    store = _STORES.get(key)
    if store is None:
        store = _STORES.setdefault(key, RelayStore(path=path))
    return store


def _policy_name(request: web.Request) -> str:
    # Unrestricted listeners (no policy matched) share the "" scope.
    return request.get("policy_name", "")


def _relay_enabled(request: web.Request) -> bool:
    """The matched policy's ``relay_enabled`` switch (api/relay.rs:87-104).
    Requests with no policy are unrestricted → enabled."""
    name = request.get("policy_name")
    if name is None:
        return True
    for p in request.app.get("policies") or []:
        if p.name == name:
            return getattr(p, "relay_enabled", True)
    return True


def _no_store(payload, status: int = 200) -> web.Response:
    resp = web.json_response(payload, status=status)
    resp.headers["Cache-Control"] = "no-store"
    return resp


def _err(status: int, message: str) -> web.Response:
    resp = web.json_response({"error": message}, status=status)
    resp.headers["Cache-Control"] = "no-store"
    return resp


async def get_pairing(request: web.Request) -> web.Response:
    if not _relay_enabled(request):
        return _err(403, "Relay is disabled for this endpoint")
    store = _store(request)
    relay_id = request.match_info["relay_id"]
    async with store.lock:
        store._load()
        if store.prune(_now()):
            store._save()
        record = next(
            (
                p for p in store.pairings
                if p["policy"] == _policy_name(request)
                and p["relay_id"] == relay_id
            ),
            None,
        )
    if record is None:
        return _err(404, "unknown pairing")
    return _no_store(
        {
            "relay_id": relay_id,
            "instance_id": record["instance_id"],
            "credential": record["credential"],
            "operation_id": record.get("operation_id"),
        }
    )


async def delete_pairing(request: web.Request) -> web.Response:
    if not _relay_enabled(request):
        return _err(403, "Relay is disabled for this endpoint")
    store = _store(request)
    relay_id = request.match_info["relay_id"]
    policy = _policy_name(request)
    async with store.lock:
        store._load()
        before = len(store.pairings)
        store.pairings = [
            p for p in store.pairings
            if not (p["policy"] == policy and p["relay_id"] == relay_id)
        ]
        store.prune(_now())
        store._save()
        deleted = len(store.pairings) != before
    return _no_store({"deleted": deleted}, status=200)


async def get_operation(request: web.Request) -> web.Response:
    if not _relay_enabled(request):
        return _err(403, "Relay is disabled for this endpoint")
    store = _store(request)
    relay_id = request.match_info["relay_id"]
    policy = _policy_name(request)
    async with store.lock:
        store._load()
        changed = store.prune(_now())
        op = next(
            (
                o for o in store.operations
                if o["policy"] == policy and o["relay_id"] == relay_id
            ),
            None,
        )
        if changed:
            store._save()
    if op is None:
        return _err(404, "no pending pairing operation")
    return _no_store(
        {
            "relay_id": relay_id,
            "operation_id": op["operation_id"],
            "expires_unix": op["expires_unix"],
        }
    )


async def begin_operation(request: web.Request) -> web.Response:
    if not _relay_enabled(request):
        return _err(403, "Relay is disabled for this endpoint")
    store = _store(request)
    relay_id = request.match_info["relay_id"]
    policy = _policy_name(request)
    now = _now()
    async with store.lock:
        store._load()
        if store.prune(now):
            # Persist GC even when the request below is idempotent or
            # rejected (api/relay.rs:301-305).
            store._save()
        existing = next(
            (
                o for o in store.operations
                if o["policy"] == policy and o["relay_id"] == relay_id
            ),
            None,
        )
        if existing is not None:
            return _no_store(
                {
                    "relay_id": relay_id,
                    "operation_id": existing["operation_id"],
                    "expires_unix": existing["expires_unix"],
                }
            )
        per_policy = sum(1 for o in store.operations if o["policy"] == policy)
        if (
            len(store.operations) >= MAX_PENDING_OPERATIONS
            or per_policy >= MAX_PENDING_OPERATIONS_PER_POLICY
        ):
            return _err(429, "too many pending Relay pairing operations")
        op = {
            "policy": policy,
            "relay_id": relay_id,
            "operation_id": str(uuid.uuid4()),
            "created_unix": now,
            "expires_unix": now + OPERATION_TTL_S,
        }
        store.operations.append(op)
        store._save()
    return _no_store(
        {
            "relay_id": relay_id,
            "operation_id": op["operation_id"],
            "expires_unix": op["expires_unix"],
        },
        status=202,
    )


async def commit_operation(request: web.Request) -> web.Response:
    if not _relay_enabled(request):
        return _err(403, "Relay is disabled for this endpoint")
    try:
        body = await request.json()
    except Exception:
        return _err(400, "invalid JSON body")
    if not isinstance(body, dict):
        # '[]' / '"x"' are valid JSON; .get on them is a 500 traceback.
        return _err(400, "body must be a JSON object")
    credential = body.get("credential") or ""
    relay_id = body.get("relay_id") or ""
    instance_id = body.get("instance_id") or ""
    if not (32 <= len(credential) <= 512):
        return _err(400, "invalid Relay credential")
    store = _store(request)
    operation_id = request.match_info["operation_id"]
    policy = _policy_name(request)
    async with store.lock:
        store._load()
        store.prune(_now())
        existing = next(
            (
                p for p in store.pairings
                if p["policy"] == policy and p["relay_id"] == relay_id
            ),
            None,
        )
        if existing is not None:
            if (
                existing.get("operation_id") == operation_id
                and existing["instance_id"] == instance_id
                and existing["credential"] == credential
            ):
                # Idempotent replay of a commit that already landed.
                store.operations = [
                    o for o in store.operations
                    if o["operation_id"] != operation_id
                ]
                store._save()
                return _no_store({}, status=204)
            return _err(409, "Relay pairing already changed")
        op = next(
            (
                o for o in store.operations
                if o["operation_id"] == operation_id
                and o["policy"] == policy
                and o["relay_id"] == relay_id
            ),
            None,
        )
        if op is None:
            return _err(410, "Relay pairing operation expired")
        per_policy = sum(1 for p in store.pairings if p["policy"] == policy)
        if (
            len(store.pairings) >= MAX_PAIRINGS
            or per_policy >= MAX_PAIRINGS_PER_POLICY
        ):
            return _err(429, "too many stored Relay pairings")
        store.pairings.append(
            {
                "policy": policy,
                "relay_id": relay_id,
                "instance_id": instance_id,
                "credential": credential,
                "operation_id": operation_id,
                "created_unix": op["created_unix"],
            }
        )
        store.operations = [
            o for o in store.operations if o["operation_id"] != operation_id
        ]
        store._save()
    return _no_store({}, status=204)


async def cancel_operation(request: web.Request) -> web.Response:
    if not _relay_enabled(request):
        return _err(403, "Relay is disabled for this endpoint")
    store = _store(request)
    operation_id = request.match_info["operation_id"]
    policy = _policy_name(request)
    async with store.lock:
        store._load()
        store.operations = [
            o for o in store.operations
            if not (
                o["operation_id"] == operation_id and o["policy"] == policy
            )
        ]
        store.prune(_now())
        store._save()
    return _no_store({}, status=204)


ROUTES = [
    web.get("/api/relay/pairings/{relay_id}", get_pairing),
    web.delete("/api/relay/pairings/{relay_id}", delete_pairing),
    web.get("/api/relay/pairing-operations/{relay_id}", get_operation),
    web.post("/api/relay/pairing-operations/{relay_id}", begin_operation),
    web.post(
        "/api/relay/pairing-operations/{operation_id}/commit",
        commit_operation,
    ),
    web.post(
        "/api/relay/pairing-operations/{operation_id}/cancel",
        cancel_operation,
    ),
]
