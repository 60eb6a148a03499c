"""HTTP inference backend — the federation client.

The port's copy of ``panoptikon_tpu/models/http_backend.py``, held to it unit for unit by
``tests/test_torch_host_copies.py``.

The reference's ``InferenceApiClient`` (src/inferio_client.rs) lets one
instance run inference on another's ``/predict`` surface; the job-level
``InferencePool`` (jobs/inference_pool.rs:10-66) spreads work over
``[[inference.upstreams]]`` with smooth weighted round-robin + failover.
This is that client for ``models.pool.InferencePool``: a synchronous
urllib transport speaking this server's own wire format (JSON inputs with
``file_b64`` payloads, base64 ``__type__`` envelopes on binary outputs).
"""

from __future__ import annotations

import base64
import json
import urllib.error
import urllib.parse
import urllib.request
from typing import Any, Optional, Sequence

from panoptikon_tpu_torch.models.base import PredictionInput


class HttpBackendError(RuntimeError):
    """Transport/protocol failure against a remote backend. ``code`` carries
    the HTTP status when one was received (pool failover classifies 4xx as
    caller mistakes that must NOT demote the upstream)."""

    def __init__(self, message: str, *, code: Optional[int] = None):
        super().__init__(message)
        self.code = code


def _path_id(inference_id: str) -> str:
    """group/name → URL path segments, percent-encoded: a name with a
    space/'#'/'?' must not mangle the request line or truncate the path."""
    from urllib.parse import quote

    group, _, name = inference_id.partition("/")
    return f"{quote(group, safe='')}/{quote(name, safe='')}"


class HttpInferenceBackend:
    """InferenceBackend over a remote panoptikon_tpu (or wire-compatible
    reference) server."""

    def __init__(self, base_url: str, *, timeout: float = 120.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout

    # -- transport ----------------------------------------------------------

    def _request(
        self, method: str, path: str, *, params: Optional[dict] = None,
        body: Optional[dict] = None,
    ) -> dict:
        url = self.base_url + path
        if params:
            clean = {k: v for k, v in params.items() if v is not None}
            if clean:
                url += "?" + urllib.parse.urlencode(clean)
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(
            url, data=data, method=method,
            headers={"content-type": "application/json"} if data else {},
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                payload = resp.read()
        except urllib.error.HTTPError as exc:
            detail = exc.read().decode(errors="replace")[:300]
            raise HttpBackendError(
                f"{method} {path} -> {exc.code}: {detail}", code=exc.code
            ) from exc
        except Exception as exc:
            raise HttpBackendError(f"{method} {path} failed: {exc}") from exc
        return json.loads(payload) if payload else {}

    # -- InferenceBackend protocol -------------------------------------------

    def predict(
        self, inference_id: str, inputs: Sequence[PredictionInput], **kw
    ) -> list[Any]:
        body_inputs = []
        for inp in inputs:
            entry: Any = inp.data if inp.data is not None else {}
            if inp.file is not None:
                if not isinstance(entry, dict):
                    # __data__ sentinel (unwrapped server-side): wrapping
                    # as {"data": ...} would change the payload shape vs a
                    # local backend for impls that read raw values.
                    entry = {"__data__": entry}
                entry = dict(entry)
                entry["file_b64"] = base64.b64encode(inp.file).decode()
            body_inputs.append(entry)
        out = self._request(
            "POST", f"/predict/{_path_id(inference_id)}",
            params={
                "cache_key": kw.get("cache_key"),
                "lru_size": kw.get("lru_size"),
                "ttl_seconds": kw.get("ttl_seconds"),
                "max_batch": kw.get("max_batch"),
            },
            body={"inputs": body_inputs},
        )
        outputs = []
        for slot in out.get("outputs", []):
            if isinstance(slot, dict) and slot.get("__type__") == "base64":
                outputs.append(base64.b64decode(slot["content"]))
            else:
                outputs.append(slot)
        return outputs

    def load_model(self, inference_id: str, **kw) -> None:
        self._request(
            "PUT", f"/load/{_path_id(inference_id)}",
            params={
                "cache_key": kw.get("cache_key"),
                "lru_size": kw.get("lru_size"),
                "ttl_seconds": kw.get("ttl_seconds"),
                "prewarm": "true" if kw.get("prewarm") else None,
            },
        )

    def unload_model(self, inference_id: str, cache_key: Optional[str] = None) -> bool:
        out = self._request(
            "DELETE", f"/load/{_path_id(inference_id)}",
            params={"cache_key": cache_key},
        )
        return bool(out.get("unloaded", True))

    def health(self) -> dict:
        return self._request("GET", "/health")
