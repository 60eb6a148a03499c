"""File scanning: walk folders, hash, identify, register items/files.

The port's copy of ``panoptikon_tpu/jobs/scan.py``, held to it unit for unit
by ``tests/test_torch_host_copies.py``: host code only, with imports of the
port. PIL imports lazily, as in the reference.

The host-side intake pipeline (reference jobs/files.rs):

- walk included folders minus excluded subtrees, skipping hidden/junk
  directories (files.rs:5754-5796);
- mtime+size unchanged → skip re-hash (the false-change counter tracks
  entries whose mtime changed but whose hash didn't);
- sha256+md5 in one streaming pass; mime from magic bytes then extension;
- per-file work (hash + decode + thumbnail + frames) fans out over a
  thread pool (files.rs:76-87 ScanOptions.worker_count) — hashlib, PIL
  and OpenCV all release the GIL; DB writes stay on the writer thread;
- media intake per type (jobs/media.py): video frame sampling with outro
  trimming (files.rs:5300 + media_tools/outro.rs), animated-image frames,
  PDF page renders (files.rs:4484, pdfium-gated), WAV duration, blurhash;
  frames land in ``storage.frames``, outcomes in ``visual_attempts``;
- missing host dependencies ledger ``blocked`` and HEAL on a later scan
  when the dependency appears (files.rs:719 heal_blocked_scan_errors);
- files table upserted; vanished paths marked unavailable; per-path scan
  errors ledgered with stage + blocker.
"""

from __future__ import annotations

import hashlib
import mimetypes
import os
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable, Optional

from panoptikon_tpu_torch.db import store
from panoptikon_tpu_torch.db.connection import Database
from panoptikon_tpu_torch.db.writer import IndexWriter
from panoptikon_tpu_torch.jobs import media
from panoptikon_tpu_torch.jobs import outro as outro_mod

JUNK_DIRS = {
    ".git", ".svn", "__pycache__", "node_modules", ".cache", ".thumbnails",
    "@eaDir", ".Trash", "$RECYCLE.BIN", "System Volume Information",
}

_MAGIC = [
    (b"\x89PNG\r\n\x1a\n", "image/png"),
    (b"\xff\xd8\xff", "image/jpeg"),
    (b"GIF87a", "image/gif"),
    (b"GIF89a", "image/gif"),
    (b"BM", "image/bmp"),
    (b"%PDF", "application/pdf"),
    (b"\x1a\x45\xdf\xa3", "video/x-matroska"),
    (b"OggS", "audio/ogg"),
    (b"fLaC", "audio/flac"),
    (b"ID3", "audio/mpeg"),
    (b"RIFF", None),  # WAV/WEBP/AVI — disambiguated below
]

THUMBNAIL_SIZE = 300
THUMBNAIL_VERSION = 1


def sniff_mime(path: str, head: bytes) -> str:
    for magic, mime in _MAGIC:
        if head.startswith(magic):
            if mime is not None:
                return mime
            if head[8:12] == b"WEBP":
                return "image/webp"
            if head[8:12] == b"WAVE":
                return "audio/wav"
            if head[8:12] == b"AVI ":
                return "video/x-msvideo"
    if len(head) >= 12 and head[4:8] == b"ftyp":
        brand = head[8:12]
        if brand in (b"M4A ", b"M4B "):
            return "audio/mp4"
        return "video/mp4"
    guess, _ = mimetypes.guess_type(path)
    return guess or "application/octet-stream"


def hash_file(path: str, chunk: int = 1 << 20) -> tuple[str, str, bytes]:
    """One streaming pass → (sha256 hex, md5 hex, head bytes)."""
    sha, md5 = hashlib.sha256(), hashlib.md5()
    head = b""
    with open(path, "rb") as f:
        first = True
        while True:
            data = f.read(chunk)
            if not data:
                break
            if first:
                head = data[:64]
                first = False
            sha.update(data)
            md5.update(data)
    return sha.hexdigest(), md5.hexdigest(), head


def image_meta(path: str) -> tuple[Optional[int], Optional[int]]:
    try:
        from PIL import Image

        with Image.open(path) as im:
            return im.width, im.height
    except Exception:
        return None, None


def make_thumbnail(path: str) -> Optional[tuple[bytes, int, int]]:
    try:
        import io

        from PIL import Image

        with Image.open(path) as im:
            im = im.convert("RGB")
            im.thumbnail((THUMBNAIL_SIZE, THUMBNAIL_SIZE))
            buf = io.BytesIO()
            im.save(buf, format="JPEG", quality=85)
            return buf.getvalue(), im.width, im.height
    except Exception:
        return None


@dataclass
class ScanCounters:
    total_available: int = 0
    new_items: int = 0
    new_files: int = 0
    unchanged_files: int = 0
    modified_files: int = 0
    marked_unavailable: int = 0
    errors: int = 0
    false_changes: int = 0
    metadata_time: float = 0.0
    hashing_time: float = 0.0
    thumbgen_time: float = 0.0
    blurhash_time: float = 0.0
    frames_written: int = 0
    blocked: int = 0
    healed: int = 0
    skipped_type: int = 0


@dataclass
class ScanRow:
    """One path's fully prepared intake result (thread-pool output)."""

    path: str
    sha256: str = ""
    md5: str = ""
    mime: str = ""
    mtime: str = ""
    size: int = 0
    width: Optional[int] = None
    height: Optional[int] = None
    duration: Optional[float] = None
    audio_tracks: Optional[int] = None
    video_tracks: Optional[int] = None
    blurhash: Optional[str] = None
    thumb: Optional[tuple[bytes, int, int]] = None
    frames: list[tuple[bytes, int, int]] = field(default_factory=list)
    attempt: Optional[tuple[str, str, Optional[str]]] = None  # kind, outcome, msg
    status: str = "new"  # new | modified | unchanged | false_change | error
    error: Optional[tuple[str, str, Optional[str], str]] = None  # stage, class, blocker, msg
    hashing_time: float = 0.0
    metadata_time: float = 0.0
    thumbgen_time: float = 0.0
    blurhash_time: float = 0.0


def iter_files(
    included: Iterable[str], excluded: Iterable[str]
) -> Iterable[str]:
    excluded = [str(Path(e)) for e in excluded]
    for root in included:
        root_path = Path(root)
        if not root_path.is_dir():
            continue
        for dirpath, dirnames, filenames in os.walk(root_path):
            dirnames[:] = [
                d
                for d in dirnames
                if d not in JUNK_DIRS
                and not d.startswith(".")
                and not any(_under(str(Path(dirpath) / d), e) for e in excluded)
            ]
            for name in filenames:
                if name.startswith("."):
                    continue
                yield str(Path(dirpath) / name)


def _under(path: str, root: str) -> bool:
    """True when ``path`` is ``root`` or inside it — with a separator
    boundary, so '/data/x' never claims '/data/x2' (the bug class
    _run_folder_update fixes for deletes also applies to scans: a bare
    prefix match pruned sibling folders from the walk while keeping their
    files in `known`, mass-marking them unavailable)."""
    root = str(Path(root))
    return path == root or path.startswith(root + os.sep)


def _video_thumb(frame: tuple[bytes, int, int]) -> Optional[tuple[bytes, int, int]]:
    try:
        import io

        from PIL import Image

        with Image.open(io.BytesIO(frame[0])) as im:
            im = im.convert("RGB")
            im.thumbnail((THUMBNAIL_SIZE, THUMBNAIL_SIZE))
            buf = io.BytesIO()
            im.save(buf, format="JPEG", quality=85)
            return buf.getvalue(), im.width, im.height
    except Exception:
        return None


def mime_class(mime: str) -> str:
    """Scan-filter media class for a sniffed mime (the per-DB
    ``scan_types`` switches; reference system_config scan_images/_video/
    _audio/_pdf/_html)."""
    if mime.startswith("image/"):
        return "images"
    if mime.startswith("video/"):
        return "video"
    if mime.startswith("audio/"):
        return "audio"
    if mime == "application/pdf":
        return "pdf"
    if mime == "text/html":
        return "html"
    return "other"


def process_path(
    path: str,
    prev: Optional[tuple[str, str]],
    *,
    make_thumbnails: bool,
    max_frames: int = media.DEFAULT_MAX_FRAMES,
    detect_outros: bool = True,
    disabled_types: frozenset = frozenset(),
) -> Optional[ScanRow]:
    """Hash + identify + media intake for ONE path — thread-pool work unit.
    Returns None for unchanged files."""
    row = ScanRow(path=path)
    try:
        stat = os.stat(path)
    except OSError as exc:
        row.status = "error"
        row.error = ("stat", "transient", None, str(exc))
        return row
    row.mtime = time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(stat.st_mtime))
    row.size = stat.st_size
    if (
        prev is not None and prev[0] == row.mtime
        and (len(prev) < 3 or prev[2] is None or int(prev[2]) == row.size)
    ):
        # mtime AND size must both match (module contract, files.rs): a
        # content rewrite with a preserved timestamp still re-hashes.
        row.status = "unchanged"
        return row
    if disabled_types:
        # Pre-hash gate: sniff from a small head read so a disabled class
        # (e.g. 500 GB of video with scan_types.video=false) never pays a
        # full-file hash on every rescan — skipped rows are not persisted,
        # so without this every scan would re-hash the whole class.
        try:
            with open(path, "rb") as f:
                head_probe = f.read(8192)
        except OSError as exc:
            row.status = "error"
            row.error = ("stat", "transient", None, str(exc))
            return row
        if mime_class(sniff_mime(path, head_probe)) in disabled_types:
            # No intake, but the file still counts as present on disk
            # (the caller adds it to `seen`, so existing rows are never
            # vanish-marked by a toggle).
            row.status = "skipped_type"
            return row
    try:
        t0 = time.perf_counter()
        row.sha256, row.md5, head = hash_file(path)
        row.hashing_time = time.perf_counter() - t0
    except OSError as exc:
        row.status = "error"
        row.error = ("hash", "transient", None, str(exc))
        return row
    if prev is not None:
        row.status = "false_change" if prev[1] == row.sha256 else "modified"
    t0 = time.perf_counter()
    row.mime = sniff_mime(path, head)
    mime = row.mime

    if mime.startswith("image/"):
        row.width, row.height = image_meta(path)
        row.metadata_time = time.perf_counter() - t0
        # Animated images get sampled frames like videos (image_frames
        # handler reads storage.frames first).
        try:
            with open(path, "rb") as f:
                payload = f.read()
            try:
                row.frames = media.sample_animated_frames(
                    payload, max_frames=max_frames
                )
                row.attempt = ("frames", "ok", None)
            except media.MediaError:
                pass  # stills are the normal case
            t1 = time.perf_counter()
            row.blurhash = media.blurhash_for_image_bytes(payload)
            row.blurhash_time = time.perf_counter() - t1
        except Exception:  # noqa: BLE001 — bomb images / truncated reads
            pass
        if make_thumbnails:
            t1 = time.perf_counter()
            row.thumb = make_thumbnail(path)
            row.thumbgen_time = time.perf_counter() - t1
    elif mime.startswith("video/"):
        try:
            info = media.probe_video(path)
            row.width, row.height = info.width, info.height
            row.duration = info.duration
            row.video_tracks = 1
            skip_tail = 0.0
            if detect_outros:
                tail = media.decode_tail_frames(
                    path, seconds=outro_mod.TAIL_S, fps=outro_mod.FPS,
                    width=outro_mod.W,
                )
                if tail is not None:
                    verdict = outro_mod.detect_outro_from_frames(tail)
                    if verdict.kind != outro_mod.KIND_NONE:
                        skip_tail = verdict.outro_seconds
            row.frames = media.sample_video_frames(
                path, max_frames=max_frames, skip_tail_s=skip_tail
            )
            row.attempt = ("frames", "ok", None)
            if make_thumbnails and row.frames:
                t1 = time.perf_counter()
                row.thumb = _video_thumb(row.frames[0])
                row.thumbgen_time = time.perf_counter() - t1
            if row.frames:
                row.blurhash = media.blurhash_for_image_bytes(row.frames[0][0])
        except media.MediaError as exc:
            outcome = "blocked" if exc.blocker else "failed"
            row.attempt = ("frames", outcome, str(exc))
            row.error = ("frames", exc.error_class, exc.blocker, str(exc))
        except Exception as exc:  # noqa: BLE001 — a corrupt file must never
            # abort the whole scan (the reference folds decoder crashes
            # into the per-path ledger too).
            row.attempt = ("frames", "failed", str(exc))
            row.error = ("frames", "input", None, f"decode crashed: {exc}")
        row.metadata_time = time.perf_counter() - t0
    elif mime == "application/pdf":
        try:
            row.frames = media.render_pdf_pages(path)
            row.attempt = ("frames", "ok", None)
            if make_thumbnails and row.frames:
                row.thumb = _video_thumb(row.frames[0])
            if row.frames:
                row.width, row.height = row.frames[0][1], row.frames[0][2]
        except media.MediaError as exc:
            outcome = "blocked" if exc.blocker else "failed"
            row.attempt = ("frames", outcome, str(exc))
            row.error = ("frames", exc.error_class, exc.blocker, str(exc))
        except Exception as exc:  # noqa: BLE001
            row.attempt = ("frames", "failed", str(exc))
            row.error = ("frames", "input", None, f"decode crashed: {exc}")
        row.metadata_time = time.perf_counter() - t0
    elif mime == "text/html":
        # Browser viewport capture (files.rs:4692); absence of a headless
        # browser is a heal-able blocker like pdfium. New HTML items need
        # this first render; failures fold into the per-path ledger.
        try:
            row.frames = media.render_html_screenshot(path)
            row.attempt = ("frames", "ok", None)
            if make_thumbnails and row.frames:
                row.thumb = _video_thumb(row.frames[0])
            if row.frames:
                row.width, row.height = row.frames[0][1], row.frames[0][2]
        except media.MediaError as exc:
            outcome = "blocked" if exc.blocker else "failed"
            row.attempt = ("frames", outcome, str(exc))
            row.error = ("frames", exc.error_class, exc.blocker, str(exc))
        except Exception as exc:  # noqa: BLE001
            row.attempt = ("frames", "failed", str(exc))
            row.error = ("frames", "input", None, f"render crashed: {exc}")
        row.metadata_time = time.perf_counter() - t0
    elif mime.startswith("audio/"):
        # Container-level metadata (the reference reads it via lofty,
        # files.rs:3596): duration for WAV/FLAC/MP3/OGG, plus a thumbnail
        # from embedded cover art or a tagged gradient placeholder.
        info = media.audio_info(path, mime)
        row.duration = info.duration
        row.audio_tracks = 1
        if make_thumbnails:
            try:
                row.thumb = media.audio_thumbnail(path, mime, info=info)
            except Exception:  # pragma: no cover — placeholder is infallible
                row.thumb = None
        row.metadata_time = time.perf_counter() - t0
    else:
        row.metadata_time = time.perf_counter() - t0
    return row


def heal_blocked(db: Database, writer: IndexWriter) -> tuple[int, set[str]]:
    """Clear 'blocked' ledger rows whose missing dependency is now present
    (files.rs:719): returns (#healed, sha256s to force re-intake)."""
    caps = media.capabilities()
    resolved = [name for name, ok in caps.items() if ok]
    if not resolved:
        return 0, set()
    conn = db.reader()
    qmarks = ",".join("?" * len(resolved))
    paths = [
        r[0]
        for r in conn.execute(
            f"SELECT path FROM scan_errors WHERE blocker IN ({qmarks})",
            resolved,
        ).fetchall()
    ]
    blocked_extractions = conn.execute(
        f"SELECT COUNT(*) FROM extraction_errors WHERE blocker IN ({qmarks})",
        resolved,
    ).fetchone()[0]
    if not paths and not blocked_extractions:
        return 0, set()
    # Blocked visual attempts heal only for items whose ledgered blocker is
    # among the now-resolved dependencies (the attempt row itself carries
    # no blocker; the scan_errors row does).
    shas = {
        r[0]
        for r in conn.execute(
            f"""SELECT DISTINCT f.sha256 FROM scan_errors e
                JOIN files f ON f.path = e.path
                WHERE e.blocker IN ({qmarks})""",
            resolved,
        ).fetchall()
    }

    def unit(c):
        c.execute(
            f"DELETE FROM scan_errors WHERE blocker IN ({qmarks})", resolved
        )
        # Extraction ledger rows blocked on the same dependency heal too
        # (e.g. audio transcode blocked on ffmpeg).
        c.execute(
            f"DELETE FROM extraction_errors WHERE blocker IN ({qmarks})",
            resolved,
        )
        if shas:
            sq = ",".join("?" * len(shas))
            c.execute(
                f"""DELETE FROM storage.visual_attempts
                    WHERE outcome='blocked' AND item_sha256 IN ({sq})""",
                list(shas),
            )

    writer.call(unit)
    return len(paths) + blocked_extractions, shas


def rescan_folders(
    db: Database,
    writer: IndexWriter,
    *,
    folders: Optional[list[str]] = None,
    make_thumbnails: bool = True,
    worker_count: int = 4,
    max_frames: int = media.DEFAULT_MAX_FRAMES,
    detect_outros: bool = True,
    cancelled=lambda: False,
) -> ScanCounters:
    """Full rescan of the configured (or given) folders."""
    conn = db.reader()
    if folders is None:
        included = [p for p, inc in store.list_folders(conn, included=True)]
        excluded = [p for p, inc in store.list_folders(conn, included=False)]
    else:
        included, excluded = folders, []
    # Per-DB media-class switches ({"images": true, "video": false, ...},
    # written by /api/desktop/setup/complete and /api/jobs/config): a class
    # set to false is skipped at intake, never vanish-marked.
    type_cfg = store.get_config(conn, "scan_types", {}) or {}
    disabled_types = frozenset(
        cls for cls, enabled in type_cfg.items() if enabled is False
    )
    counters = ScanCounters()
    scan_id = writer.call(lambda c: store.start_file_scan(c, ";".join(included)))

    healed, heal_shas = heal_blocked(db, writer)
    counters.healed = healed

    # Known files under the scanned roots → unchanged-skip + vanish marking.
    # Items whose blocked intake just healed are dropped from `known` so
    # the unchanged-mtime skip cannot mask the re-attempt.
    known: dict[str, tuple[str, str, object]] = {}
    for path, mtime, sha, size in conn.execute(
        """SELECT f.path, f.last_modified, f.sha256, i.size
           FROM files f JOIN items i ON i.id = f.item_id
           WHERE f.available = 1"""
    ).fetchall():
        if sha in heal_shas:
            continue
        if any(_under(path, r) for r in included):
            known[path] = (mtime, sha, size)

    seen: set[str] = set()

    def flush(rows: list[ScanRow]):
        def unit(c):
            for r in rows:
                item_id = store.upsert_item(
                    c, r.sha256, r.md5, r.mime, size=r.size, width=r.width,
                    height=r.height, duration=r.duration,
                    audio_tracks=r.audio_tracks, video_tracks=r.video_tracks,
                    blurhash=r.blurhash,
                )
                store.upsert_file(c, item_id, r.sha256, r.path, r.mtime, scan_id)
                if r.thumb is not None:
                    c.execute(
                        """INSERT INTO storage.thumbnails
                           (item_sha256, idx, item_mime_type, width, height,
                            version, thumbnail) VALUES (?,?,?,?,?,?,?)
                           ON CONFLICT(item_sha256, idx) DO UPDATE SET
                             thumbnail=excluded.thumbnail, width=excluded.width,
                             height=excluded.height, version=excluded.version""",
                        (r.sha256, 0, r.mime, r.thumb[1], r.thumb[2],
                         THUMBNAIL_VERSION, r.thumb[0]),
                    )
                for idx, (blob, fw, fh) in enumerate(r.frames):
                    c.execute(
                        """INSERT INTO storage.frames
                           (item_sha256, idx, item_mime_type, width, height,
                            version, frame) VALUES (?,?,?,?,?,?,?)
                           ON CONFLICT(item_sha256, idx) DO UPDATE SET
                             frame=excluded.frame, width=excluded.width,
                             height=excluded.height, version=excluded.version""",
                        (r.sha256, idx, r.mime, fw, fh,
                         media.FRAMES_VERSION, blob),
                    )
                if r.attempt is not None:
                    kind, outcome, msg = r.attempt
                    c.execute(
                        """INSERT INTO storage.visual_attempts
                           (item_sha256, kind, version, outcome, message, time)
                           VALUES (?,?,?,?,?,datetime('now'))
                           ON CONFLICT(item_sha256, kind) DO UPDATE SET
                             outcome=excluded.outcome, message=excluded.message,
                             version=excluded.version, time=excluded.time""",
                        (r.sha256, kind, media.FRAMES_VERSION, outcome, msg),
                    )
                if r.error is not None:
                    stage, error_class, blocker, msg = r.error
                    store.record_scan_error(
                        c, r.path, stage=stage, error_class=error_class,
                        blocker=blocker, message=msg,
                    )

        writer.call(unit)

    def handle(row: Optional[ScanRow]):
        if row is None:
            return None
        counters.hashing_time += row.hashing_time
        counters.metadata_time += row.metadata_time
        counters.thumbgen_time += row.thumbgen_time
        counters.blurhash_time += row.blurhash_time
        if row.status == "unchanged":
            counters.unchanged_files += 1
            return None
        if row.status == "skipped_type":
            counters.skipped_type += 1
            return None
        if row.status == "error" and not row.sha256:
            counters.errors += 1
            writer.call(
                lambda c, r=row: store.record_scan_error(
                    c, r.path, stage=r.error[0], error_class=r.error[1],
                    blocker=r.error[2], message=r.error[3],
                )
            )
            return None
        if row.status == "new":
            counters.new_files += 1
            counters.new_items += 1
        elif row.status == "modified":
            counters.modified_files += 1
        elif row.status == "false_change":
            counters.false_changes += 1
        if row.error is not None:
            counters.errors += 1
            if row.error[2]:
                counters.blocked += 1
        counters.frames_written += len(row.frames)
        return row

    batch: list[ScanRow] = []
    pool = ThreadPoolExecutor(max_workers=max(1, worker_count))
    try:
        pending: list = []
        WINDOW = 64
        for path in iter_files(included, excluded):
            if cancelled():
                break
            seen.add(path)
            counters.total_available += 1
            pending.append(
                pool.submit(
                    process_path, path, known.get(path),
                    make_thumbnails=make_thumbnails, max_frames=max_frames,
                    detect_outros=detect_outros,
                    disabled_types=disabled_types,
                )
            )
            if len(pending) >= WINDOW:
                for fut in pending:
                    row = handle(fut.result())
                    if row is not None:
                        batch.append(row)
                pending = []
                if len(batch) >= 64:
                    flush(batch)
                    batch = []
        for fut in pending:
            row = handle(fut.result())
            if row is not None:
                batch.append(row)
    finally:
        pool.shutdown(wait=True)
    if batch:
        flush(batch)

    vanished = [p for p in known if p not in seen]
    if vanished and not cancelled():
        counters.marked_unavailable = writer.call(
            lambda c: store.mark_files_unavailable(c, vanished)
        )

    writer.call(
        lambda c: store.finish_file_scan(
            c,
            scan_id,
            total_available=counters.total_available,
            new_items=counters.new_items,
            new_files=counters.new_files,
            unchanged_files=counters.unchanged_files,
            modified_files=counters.modified_files,
            marked_unavailable=counters.marked_unavailable,
            errors=counters.errors,
            false_changes=counters.false_changes,
            metadata_time=counters.metadata_time,
            hashing_time=counters.hashing_time,
            thumbgen_time=counters.thumbgen_time,
        )
    )
    return counters
