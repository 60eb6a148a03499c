"""Request policy layer: first-match policies, rulesets, DB pinning.

The port's copy of ``panoptikon_tpu/api/policy.py``, held to it unit for unit by
``tests/test_torch_host_copies.py``. Its middleware runs on the port's transport, ``api/web.py``.

aiohttp middleware replicating the reference's gateway policy semantics
(src/policy.rs, docs/architecture.md:84-103): the listener (or Host header)
selects the first matching policy; its ruleset allows or denies the
method+path; a pinned ``index_db`` overrides the request's database
selection (the test-listener pattern: a second endpoint whose policy pins
throwaway DBs so previews can't touch real data); ``read_only`` policies
reject mutating methods.
"""

from __future__ import annotations

import logging
from typing import Optional

from panoptikon_tpu_torch.api import web

from panoptikon_tpu_torch.config import PolicyConfig

MUTATING = {"POST", "PUT", "DELETE", "PATCH"}
# Mutation-free POST routes (search is a POST for body ergonomics).
READONLY_POSTS = {"/api/search/pql", "/api/search/pql/build"}


def _rule_matches(rule: str, method: str, path: str) -> bool:
    parts = rule.split(None, 1)
    if len(parts) != 2:
        return False
    rule_method, prefix = parts
    if rule_method != "*" and rule_method.upper() != method:
        return False
    return path.startswith(prefix)


class PolicyEngine:
    def __init__(self, policies: list[PolicyConfig]):
        self.policies = policies

    def select(self, host: Optional[str], listener_policy: Optional[str]) -> Optional[PolicyConfig]:
        """First match wins: a listener-pinned policy short-circuits;
        otherwise the first policy with an explicit matching host. A policy
        with no host list binds ONLY via listener pinning — otherwise a
        test-listener policy would capture every listener and lock the
        whole server down (found driving the real server)."""
        if listener_policy:
            for p in self.policies:
                if p.name == listener_policy:
                    return p
        bare_host = (host or "").split(":", 1)[0]
        for p in self.policies:
            if p.hosts and bare_host in p.hosts:
                return p
        return None

    def check(self, policy: PolicyConfig, method: str, path: str) -> bool:
        for rule in policy.deny:
            if _rule_matches(rule, method, path):
                return False
        for rule in policy.allow:
            if _rule_matches(rule, method, path):
                if policy.read_only and method in MUTATING and path not in READONLY_POSTS:
                    return False
                return True
        return False


def policy_middleware(
    engine: PolicyEngine,
    listener_policy: Optional[str] = None,
    token_key=None,
):
    """``token_key`` (api/policy_token.TokenKey) enables SSR policy tokens:
    a verified ``x-panoptikon-policy`` header selects the named policy
    instead of listener/host matching, so the UI's server-side renderer
    acts with the authority of the browser request that minted the token
    (policy_token.rs). Forged/expired/unknown-name tokens fall back
    silently to listener/host selection."""

    from panoptikon_tpu_torch.api.policy_token import POLICY_TOKEN_HEADER, TokenError

    @web.middleware
    async def middleware(request: web.Request, handler):
        policy = None
        if token_key is not None:
            presented = request.headers.get(POLICY_TOKEN_HEADER)
            if presented:
                try:
                    name = token_key.verify(presented)
                    policy = next(
                        (p for p in engine.policies if p.name == name), None
                    )
                except TokenError as e:
                    logging.getLogger("panoptikon_tpu_torch.api").debug(
                        "policy token ignored: %s", e.kind
                    )
        if policy is None:
            policy = engine.select(request.headers.get("Host"), listener_policy)
        if policy is None:
            # No policy claims this listener/host → unrestricted. Policies
            # are opt-in restrictions bound to listeners or hosts; the
            # pinned test listener stays locked down either way.
            return await handler(request)
        # Surfaced so the UI proxy can mint an SSR token naming this policy.
        request["policy_name"] = policy.name
        # Relay bootstrap paths bypass the ALLOW list and the read-only
        # switch (policy.rs:288-293): a restricted search-only policy must
        # still be able to recover its own relay credential, and relay
        # commits mutate only the pairing store, never DB data. EXPLICIT
        # deny rules still apply, and the relay handlers enforce the
        # policy's relay_enabled switch + scope records per policy name.
        relay_bootstrap = request.path.startswith(
            ("/api/relay/pairings/", "/api/relay/pairing-operations/")
        )
        if relay_bootstrap:
            for rule in policy.deny:
                if _rule_matches(rule, request.method, request.path):
                    raise web.HTTPForbidden(
                        reason=f"denied by policy {policy.name!r}"
                    )
        elif not engine.check(policy, request.method, request.path):
            raise web.HTTPForbidden(reason=f"denied by policy {policy.name!r}")
        if policy.index_db is not None:
            # DB pinning: the policy's database overrides the query param.
            request["pinned_index_db"] = policy.index_db
        return await handler(request)

    return middleware
