"""CLI entry: subcommands mirroring the reference binary (main.rs:77-113).

The port's copy of ``panoptikon_tpu/cli.py``, held to it unit for unit by
``tests/test_torch_host_copies.py``. ``accelerator`` reports ``torch.cuda``'s devices; ``serve`` takes ``--device``.

``panoptikon-tpu [serve]``      — run the server (default subcommand).
``panoptikon-tpu setup``        — first-run materialization: write the
                                  default config templates into --root
                                  (reference resources.rs
                                  materialize_first_run; idempotent, never
                                  overwrites user edits).
``panoptikon-tpu accelerator``  — print the device report as JSON
                                  (reference accelerator_report.rs).
``panoptikon-tpu version``      — print the package version.

``panoptikon-tpu self-update``  — check a release manifest for a newer
                                  version and (with --apply) upgrade the
                                  package via pip (reference main.rs
                                  ``update`` → GitHub releases; the
                                  Python-deploy analog is a pip upgrade
                                  from a configured index/manifest).

Client subcommands (the reference's scripts/ + UI tooling surface, built
on :mod:`panoptikon_tpu_torch.client`; all take ``--server`` and ``--db``,
print JSON for scripting):

``panoptikon-tpu search``       — PQL search: ``search "red bicycle"
                                  --model clip/vit-b-32`` or a full PQL
                                  body via ``--pql file.json`` (``-`` for
                                  stdin).
``panoptikon-tpu scan``         — register folders (``--add PATH``...)
                                  and run a rescan; ``--wait`` blocks.
``panoptikon-tpu extract``      — enqueue an extraction job for an
                                  inference id; ``--wait`` blocks.
``panoptikon-tpu jobs``         — queue status (running/pending/history).
``panoptikon-tpu health``       — server health document.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
from pathlib import Path

def _bundled_config() -> Path:
    """Default config templates embedded in the package
    (panoptikon_tpu/resources/config — reference resources.rs bundles
    its first-run defaults in the binary)."""
    from panoptikon_tpu_torch import resources as _res

    return _res.config_dir()


BUNDLED_CONFIG = _bundled_config()


def cmd_setup(args) -> int:
    root = Path(args.root)
    wrote = []
    for sub in ("server", "inference"):
        src_dir = BUNDLED_CONFIG / sub
        dst_dir = root / "config" / sub
        dst_dir.mkdir(parents=True, exist_ok=True)
        if src_dir.is_dir():
            for src in sorted(src_dir.glob("*.toml")):
                dst = dst_dir / src.name
                if dst.exists():
                    continue  # never clobber user edits
                shutil.copyfile(src, dst)
                wrote.append(str(dst))
    (root / "data").mkdir(parents=True, exist_ok=True)
    env = root / ".env"
    if not env.exists():
        env.write_text("# panoptikon_tpu environment overrides\n")
        wrote.append(str(env))
    print(json.dumps({"root": str(root), "materialized": wrote}))
    return 0


def cmd_accelerator(args) -> int:
    """The card's inventory under the reference's keys (``torch.cuda``),
    or one CPU device where there is no CUDA. ``--env``: the reference's
    table of TPU generations has no counterpart on the card."""
    import torch

    if getattr(args, "env", False):
        print(json.dumps({
            "generation": None,
            "recommended": {},
            # Consumed by parallel.multihost.initialize() when [parallel]
            # names no coordinator (torchrun sets them).
            "multihost": {
                "MASTER_ADDR": "<host0>",
                "MASTER_PORT": "<port>",
                "WORLD_SIZE": "<n_processes>",
                "RANK": "<0..n_processes-1>",
            },
            "notes": "no recommended environment for CUDA devices: the TPU "
                     "generation table has no counterpart on the card",
        }))
        return 0

    if torch.cuda.is_available():
        devices = [
            {"id": i, "kind": torch.cuda.get_device_name(i), "platform": "gpu",
             "process": 0}
            for i in range(torch.cuda.device_count())
        ]
        backend = "cuda"
    else:
        devices = [{"id": 0, "kind": "cpu", "platform": "cpu", "process": 0}]
        backend = "cpu"
    print(
        json.dumps(
            {
                "backend": backend,
                "device_count": len(devices),
                "devices": devices,
            }
        )
    )
    return 0


def cmd_self_update(args) -> int:
    """Version check + optional pip upgrade.

    The manifest is a JSON document {"name": ..., "version": "X.Y.Z",
    "requirement": "panoptikon-tpu==X.Y.Z"} at --manifest (any URL
    urllib can open, file:// included — this deploy model has no
    assumption of GitHub egress). Without --apply it only reports; with
    --apply it runs ``pip install --upgrade <requirement>`` in this
    interpreter's environment.
    """
    import json as _json

    import panoptikon_tpu_torch

    if not args.manifest:
        print(_json.dumps({
            "error": "no release manifest configured (--manifest URL)",
            "current": panoptikon_tpu_torch.__version__,
        }))
        return 2
    from panoptikon_tpu_torch.utils.version import fetch_manifest, newer_than

    try:
        manifest = fetch_manifest(args.manifest)
    except Exception as exc:
        print(_json.dumps({
            "error": f"manifest fetch failed: {exc}",
            "current": panoptikon_tpu_torch.__version__,
        }))
        return 2
    latest = str(manifest.get("version", ""))
    current = panoptikon_tpu_torch.__version__
    newer = bool(latest) and newer_than(latest, current)
    plan = manifest.get("requirement") or f"panoptikon-tpu=={latest}"
    out = {"current": current, "latest": latest, "update_available": newer,
           "plan": ["pip", "install", "--upgrade", plan] if newer else None,
           "applied": False}
    if newer and args.apply:
        import subprocess

        rc = subprocess.call(
            [sys.executable, "-m", "pip", "install", "--upgrade", plan]
        )
        out["applied"] = rc == 0
        print(_json.dumps(out))
        return rc
    print(_json.dumps(out))
    return 0


def _client(args):
    from panoptikon_tpu_torch.client import PanoptikonClient

    return PanoptikonClient(
        args.server, index_db=args.db, timeout=args.timeout
    )


def cmd_health(args) -> int:
    print(json.dumps(_client(args).health()))
    return 0


def cmd_jobs(args) -> int:
    print(json.dumps(_client(args).jobs.queue()))
    return 0


def cmd_scan(args) -> int:
    c = _client(args)
    if args.add:
        current = c.jobs.get_folders() or []
        kept = {f["path"] for f in current if f.get("included")}
        # rescan=False: we enqueue exactly one rescan below (the server
        # would otherwise enqueue its own on the folders PUT).
        c.jobs.set_folders(
            included=sorted(kept | set(args.add)), rescan=False
        )
    job = c.jobs.rescan_folders()
    out = {"job_id": job["job_id"]}
    if args.wait:
        out["result"] = c.jobs.wait(job["job_id"], timeout=args.timeout)
    print(json.dumps(out))
    return 0


def cmd_extract(args) -> int:
    c = _client(args)
    job = c.jobs.enqueue_extraction(args.inference_id)
    out = {"job_id": job["job_id"]}
    if args.wait:
        out["result"] = c.jobs.wait(job["job_id"], timeout=args.timeout)
        if out["result"].get("state") == "failed":
            print(json.dumps(out))
            return 1
    print(json.dumps(out))
    return 0


def cmd_search(args) -> int:
    c = _client(args)
    if args.pql:
        raw = (
            sys.stdin.read() if args.pql == "-"
            else Path(args.pql).read_text()
        )
        body = json.loads(raw)
    else:
        if not args.query or not args.model:
            print(json.dumps({
                "error": "either --pql FILE or QUERY --model ID required"}))
            return 2
        filter_name = (
            "text_embeddings" if args.entity == "text"
            else "image_embeddings"
        )
        body = {
            "query": {filter_name: {
                "query": args.query, "model": args.model}},
            "entity": args.entity if args.entity != "image" else "file",
            "page_size": args.page_size,
            "page": args.page,
        }
    print(json.dumps(c.search.pql(body)))
    return 0


def cmd_version(args) -> int:
    import panoptikon_tpu_torch

    print(panoptikon_tpu_torch.__version__)
    return 0


def cmd_serve(args) -> int:
    from panoptikon_tpu_torch.api import server

    server.main(args)
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="panoptikon-tpu")
    sub = parser.add_subparsers(dest="command")

    serve = sub.add_parser("serve", help="run the server (default)")
    for p in (parser, serve):
        p.add_argument("--config", default=None, help="server TOML path")
        p.add_argument("--port", type=int, default=None)
        p.add_argument("--host", default=None)
        p.add_argument("--data-root", default=None)
        p.add_argument("--registry-dir", default=None)
        p.add_argument("--root", default=".", help="working root (chdir)")
        p.add_argument("--device", default="cuda",
                       help="device the executors run on: cuda (default), "
                            "cuda:N or cpu; a comma-separated list shards "
                            "every space over those devices")

    setup = sub.add_parser("setup", help="materialize default configs")
    setup.add_argument("--root", default=".", help="target root directory")

    acc = sub.add_parser("accelerator", help="print the device report")
    acc.add_argument("--env", action="store_true",
                     help="print the recommended env matrix for this generation")
    sub.add_parser("version", help="print the version")

    def _client_args(p):
        p.add_argument("--server", default="http://127.0.0.1:6342",
                       help="server base URL")
        p.add_argument("--db", default=None, help="index database name")
        p.add_argument("--timeout", type=float, default=600.0,
                       help="request/wait timeout seconds")

    srch = sub.add_parser("search", help="run a PQL search")
    srch.add_argument("query", nargs="?", default=None,
                      help="semantic query text")
    srch.add_argument("--model", default=None,
                      help="embedding inference id (e.g. clip/vit-b-32)")
    srch.add_argument("--entity", default="image",
                      choices=["image", "file", "text"],
                      help="search entity (image→file via CLIP, text→"
                           "text_embeddings)")
    srch.add_argument("--page-size", type=int, default=10)
    srch.add_argument("--page", type=int, default=1)
    srch.add_argument("--pql", default=None,
                      help="full PQL JSON body from FILE ('-' = stdin)")
    _client_args(srch)

    scan = sub.add_parser("scan", help="register folders + rescan")
    scan.add_argument("--add", action="append", default=[],
                      help="folder to include (repeatable)")
    scan.add_argument("--wait", action="store_true",
                      help="block until the scan finishes")
    _client_args(scan)

    ext = sub.add_parser("extract", help="enqueue an extraction job")
    ext.add_argument("inference_id", help="e.g. clip/vit-b-32")
    ext.add_argument("--wait", action="store_true",
                     help="block until the job finishes")
    _client_args(ext)

    jobs = sub.add_parser("jobs", help="print the job queue status")
    _client_args(jobs)
    health = sub.add_parser("health", help="print server health")
    _client_args(health)

    upd = sub.add_parser("self-update", help="check/apply a package update")
    upd.add_argument("--manifest", default=None,
                     help="release manifest URL (json: {version, requirement})")
    upd.add_argument("--apply", action="store_true",
                     help="run the pip upgrade when newer")

    desk = sub.add_parser(
        "desktop",
        help="local-app mode: supervise the server, open the UI, restart "
             "on crash (the reference desktop app's lifecycle, tray-less)",
    )
    desk.add_argument("--config", default=None, help="server TOML path")
    desk.add_argument("--port", type=int, default=None)
    desk.add_argument("--host", default=None)
    desk.add_argument("--data-root", default=None)
    desk.add_argument("--registry-dir", default=None)
    desk.add_argument("--no-browser", action="store_true",
                      help="skip opening the UI in a browser")
    desk.add_argument("--manifest", default=None,
                      help="release manifest URL for the startup update check")
    desk.add_argument("--max-restarts", type=int, default=None,
                      help="give up after this many crashes (default: never)")
    return parser


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    cmd = args.command or "serve"
    if cmd == "setup":
        return cmd_setup(args)
    if cmd == "accelerator":
        return cmd_accelerator(args)
    if cmd == "version":
        return cmd_version(args)
    if cmd == "self-update":
        return cmd_self_update(args)
    if cmd == "search":
        return cmd_search(args)
    if cmd == "scan":
        return cmd_scan(args)
    if cmd == "extract":
        return cmd_extract(args)
    if cmd == "jobs":
        return cmd_jobs(args)
    if cmd == "health":
        return cmd_health(args)
    if cmd == "desktop":
        from panoptikon_tpu_torch.desktop import run_desktop

        return run_desktop(args)
    return cmd_serve(args)


if __name__ == "__main__":
    sys.exit(main())
