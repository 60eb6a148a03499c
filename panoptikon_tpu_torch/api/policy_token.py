"""Policy tokens: HMAC-signed, short-lived policy selectors for SSR.

The port's copy of ``panoptikon_tpu/api/policy_token.py``, held to it unit for unit by
``tests/test_torch_host_copies.py``.

The gateway stamps ``x-panoptikon-policy: <policy>.<expiry>.<hmac_hex>``
onto every request it proxies to the UI upstream, naming the policy that
matched the browser request. When the UI's server-side renderer calls back
into the gateway's API it echoes the token, and the policy layer selects
the named policy instead of matching by listener/host — SSR acts with the
authority of the browser request that triggered it, never with the
authority of the UI process's own network position.

Threat model (reference: src/policy_token.rs, docs/architecture.md:84-99):
the UI process holds no standing authority — tokens are minted per request
and expire after ``TOKEN_TTL_SECS``. A forged, tampered, expired, or
absent token is silently ignored and selection falls back to listener/host
matching, so deployments point SSR traffic at the most-restricted
listener. The key is random per boot unless ``[server] policy_token_key``
(64 hex chars) pins it for multi-gateway chains.
"""

from __future__ import annotations

import hmac
import secrets
import time
from hashlib import sha256

# Injected on UI-bound proxied requests; verified-then-consumed at policy
# ingress (never forwarded to handlers or upstream API calls).
POLICY_TOKEN_HEADER = "x-panoptikon-policy"

# Long enough for a slow SSR render's API fan-out, short enough that a
# leaked token goes stale quickly.
TOKEN_TTL_SECS = 300


class TokenError(Exception):
    """Why a presented token was ignored; ``.kind`` is one of
    ``malformed`` / ``bad-hmac`` / ``expired``."""

    def __init__(self, kind: str):
        super().__init__(kind)
        self.kind = kind


class TokenKey:
    """In-memory HMAC key. No __repr__ leaking bytes — the key must never
    end up in logs."""

    __slots__ = ("_key",)

    def __init__(self, key: bytes):
        if len(key) != 32:
            raise ValueError(
                f"policy_token_key must be 32 bytes (64 hex chars), got {len(key)}"
            )
        self._key = key

    def __repr__(self) -> str:  # pragma: no cover - hygiene only
        return "TokenKey(<redacted>)"

    @classmethod
    def from_config(cls, hex_key: str | None) -> "TokenKey":
        """The configured key, or a fresh random per-boot key when unset."""
        if hex_key:
            try:
                raw = bytes.fromhex(hex_key.strip())
            except ValueError as e:
                raise ValueError("policy_token_key is not valid hex") from e
            return cls(raw)
        return cls(secrets.token_bytes(32))

    def mint(self, policy_name: str) -> str:
        """``<policy>.<expiry>.<hmac_hex>`` expiring TOKEN_TTL_SECS from
        now."""
        return self.sign(policy_name, int(time.time()) + TOKEN_TTL_SECS)

    def sign(self, policy_name: str, expiry_unix: int) -> str:
        message = f"{policy_name}.{expiry_unix}"
        tag = hmac.new(self._key, message.encode(), sha256).hexdigest()
        return f"{message}.{tag}"

    def verify(self, token: str) -> str:
        return self.verify_at(token, int(time.time()))

    def verify_at(self, token: str, now: int) -> str:
        """Return the policy name the token names, or raise TokenError.

        Policy names may contain ``.``, so the token splits from the
        RIGHT: last two segments are expiry and tag, the rest is the name.
        The HMAC check (``hmac.compare_digest``, constant-time) runs before
        the expiry check so a forged token's code path does not depend on
        its claimed expiry. Whether the named policy exists is the
        caller's check — this only proves we minted it and it is fresh.
        """
        parts = token.rsplit(".", 2)
        if len(parts) != 3 or not parts[0]:
            raise TokenError("malformed")
        name, expiry_str, tag_hex = parts
        try:
            expiry = int(expiry_str)
            bytes.fromhex(tag_hex)
        except ValueError:
            raise TokenError("malformed") from None
        message = token[: -(len(tag_hex) + 1)]
        want = hmac.new(self._key, message.encode(), sha256).hexdigest()
        if not hmac.compare_digest(want, tag_hex):
            raise TokenError("bad-hmac")
        if expiry < now:
            raise TokenError("expired")
        return name
