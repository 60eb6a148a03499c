"""Server settings: layered typed configuration.

The port's copy of ``panoptikon_tpu/config.py``, held to it unit for unit by
``tests/test_torch_host_copies.py``.

The reference's ``Settings`` (src/config.rs) reduced to the surfaces this
framework serves: listeners/endpoints, data root, search, jobs, inference
and policy sections, loaded from TOML with ``${VAR}`` templating applied to
every string (architecture.md:52-66) after a ``.env`` auto-load. Layering:
defaults → TOML file → environment templating; per-DB runtime state lives
in the databases themselves (db.store system_config), not here.
"""

from __future__ import annotations

import tomllib
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Optional

from panoptikon_tpu_torch.utils.env_template import load_dotenv, resolve_tree


@dataclass
class ListenerConfig:
    host: str = "127.0.0.1"
    port: int = 6342
    policy: Optional[str] = None  # name of the policy pinned to this listener


@dataclass
class PolicyConfig:
    """First-match request policy (reference policy.rs): optional host
    match, a ruleset of allowed method+path prefixes, and DB pinning."""

    name: str = "default"
    hosts: list[str] = field(default_factory=list)  # empty = any host
    allow: list[str] = field(default_factory=lambda: ["* /"])  # "METHOD /prefix"
    deny: list[str] = field(default_factory=list)
    index_db: Optional[str] = None  # pin requests to this database
    read_only: bool = False
    # Relay pairing registry switch (reference api/relay.rs:87-104 reads
    # the policy's client.relay_enabled): false denies every
    # /api/relay/* request matched by this policy with 403.
    relay_enabled: bool = True


@dataclass
class SearchConfig:
    cache_bytes: int = 256 * 1024 * 1024
    embedding_cache_entries: int = 256
    prefetch_rows_cap: int = 10_000


@dataclass
class JobsConfig:
    loader_concurrency: int = 4
    default_batch_size: int = 16
    scan_thumbnails: bool = True


@dataclass
class InferenceConfig:
    registry_dir: Optional[str] = None
    user_registry_dir: Optional[str] = None
    default_ttl_seconds: float = 3600.0
    # Federation upstreams (jobs/inference_pool.rs): [{url, weight}].
    upstreams: list[dict] = field(default_factory=list)
    # Eager prewarm loop (inferio/prewarm.rs run_eager_prewarm_loop):
    # keep search-usable embedding models loaded + bucket-compiled.
    eager_prewarm: bool = True
    prewarm_interval_s: float = 60.0


@dataclass
class ParallelConfig:
    """[parallel] — multi-host runtime (parallel/multihost.py).

    coordinator/num_processes/process_id fall back to the standard
    JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID env vars
    (TPU pod runtimes set them automatically); multihost_layout picks the
    serving mesh: "replica" (one corpus replica per host, merges on ICI)
    or "shard" (one global corpus across all hosts)."""

    coordinator: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    multihost_layout: str = "replica"


@dataclass
class LoggingConfig:
    level: str = "info"
    file: Optional[str] = None


@dataclass
class Settings:
    data_root: str = "./data"
    listeners: list[ListenerConfig] = field(
        default_factory=lambda: [ListenerConfig()]
    )
    policies: list[PolicyConfig] = field(default_factory=list)
    search: SearchConfig = field(default_factory=SearchConfig)
    jobs: JobsConfig = field(default_factory=JobsConfig)
    inference: InferenceConfig = field(default_factory=InferenceConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    logging: LoggingConfig = field(default_factory=LoggingConfig)
    # [upstreams].ui — a UI server (e.g. Next.js) fronted by the reverse
    # proxy: any path the API doesn't claim forwards there (proxy.rs).
    ui_upstream: str | None = None
    # [ui].command — when set, the server SUPERVISES this UI process
    # (bounded crash restarts, process-group teardown — src/ui.rs).
    ui_command: list[str] = field(default_factory=list)
    ui_cwd: str | None = None
    # [server].policy_token_key — 64 hex chars pinning the HMAC key for
    # SSR policy tokens (api/policy_token.py); random per boot when unset.
    policy_token_key: str | None = None
    # [update].manifest — JSON release-manifest URL for the self-update
    # surfaces (cli self-update, /api/desktop/update-status).
    update_manifest: str | None = None
    # [desktop].managed — the desktop supervisor owns this server: unlocks
    # the /api/desktop/setup-* wizard surface (reference --desktop-managed,
    # main.rs:152; unmanaged servers 404 those routes).
    desktop_managed: bool = False

    @classmethod
    def load(cls, path: str | Path | None = None, root: str | Path = ".") -> "Settings":
        load_dotenv(Path(root) / ".env")
        raw: dict[str, Any] = {}
        if path is not None:
            # An EXPLICIT config path that doesn't exist is an error, not a
            # silent fall-through to defaults (a localhost-only listener
            # writing data into the cwd — undebuggable in a container).
            if not Path(path).is_file():
                raise FileNotFoundError(f"config file not found: {path}")
            raw = tomllib.loads(Path(path).read_text())
        raw = resolve_tree(raw)
        return cls.from_dict(raw)

    @classmethod
    def from_dict(cls, raw: dict[str, Any]) -> "Settings":
        s = cls()
        if "data_root" in raw:
            s.data_root = str(raw["data_root"])
        if "listeners" in raw:
            s.listeners = [
                ListenerConfig(
                    host=l.get("host", "127.0.0.1"),
                    port=int(l.get("port", 6342)),
                    policy=l.get("policy"),
                )
                for l in raw["listeners"]
            ]
        if "policies" in raw:
            s.policies = [
                PolicyConfig(
                    name=p.get("name", f"policy{i}"),
                    hosts=list(p.get("hosts", [])),
                    allow=list(p.get("allow", ["* /"])),
                    deny=list(p.get("deny", [])),
                    index_db=p.get("index_db"),
                    read_only=bool(p.get("read_only", False)),
                    relay_enabled=bool(p.get("relay_enabled", True)),
                )
                for i, p in enumerate(raw["policies"])
            ]
        search = raw.get("search", {})
        s.search = SearchConfig(
            cache_bytes=int(search.get("cache_bytes", s.search.cache_bytes)),
            embedding_cache_entries=int(
                search.get("embedding_cache_entries", s.search.embedding_cache_entries)
            ),
            prefetch_rows_cap=int(
                search.get("prefetch_rows_cap", s.search.prefetch_rows_cap)
            ),
        )
        jobs = raw.get("jobs", {})
        s.jobs = JobsConfig(
            loader_concurrency=int(jobs.get("loader_concurrency", 4)),
            default_batch_size=int(jobs.get("default_batch_size", 16)),
            scan_thumbnails=bool(jobs.get("scan_thumbnails", True)),
        )
        inf = raw.get("inference", {})
        s.inference = InferenceConfig(
            registry_dir=inf.get("registry_dir"),
            user_registry_dir=inf.get("user_registry_dir"),
            default_ttl_seconds=float(inf.get("default_ttl_seconds", 3600.0)),
            upstreams=list(inf.get("upstreams", [])),
            eager_prewarm=bool(inf.get("eager_prewarm", True)),
            prewarm_interval_s=float(inf.get("prewarm_interval_s", 60.0)),
        )
        par = raw.get("parallel", {})
        s.parallel = ParallelConfig(
            coordinator=par.get("coordinator"),
            num_processes=(
                int(par["num_processes"]) if "num_processes" in par else None
            ),
            process_id=int(par["process_id"]) if "process_id" in par else None,
            multihost_layout=str(par.get("multihost_layout", "replica")),
        )
        logging = raw.get("logging", {})
        s.logging = LoggingConfig(
            level=logging.get("level", "info"), file=logging.get("file")
        )
        upstreams = raw.get("upstreams", {})
        s.ui_upstream = upstreams.get("ui")
        ui = raw.get("ui", {})
        s.ui_command = [str(a) for a in ui.get("command", [])]
        s.ui_cwd = ui.get("cwd")
        server = raw.get("server", {})
        s.policy_token_key = server.get("policy_token_key")
        s.update_manifest = (raw.get("update") or {}).get("manifest")
        s.desktop_managed = bool((raw.get("desktop") or {}).get("managed", False))
        return s
