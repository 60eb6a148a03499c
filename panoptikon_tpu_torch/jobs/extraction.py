"""The extraction pipeline: the index-build path.

The port's copy of ``panoptikon_tpu/jobs/extraction.py``, held to it unit for unit
by ``tests/test_torch_host_copies.py``: host code only, with imports of the
port. The manager it is given is the port's ``ModelManager``, whose impls
run on the card; loader threads never touch CUDA.

The reference's streaming extraction job (jobs/extraction.rs:237
``run_extraction_job``) re-expressed for in-process inference:

- the work list is the ledger-aware unprocessed-items query (chunked keyset
  cursor, WORK_CHUNK_ROWS semantics — short-lived read snapshots keep the
  WAL checkpointable);
- per chunk: load file payloads (host), run the model through the manager
  on static-shape buckets, route outputs through per-type handlers that
  write via the single-writer;
- per-item typed error slots: ``input`` persists in the ledger and excludes
  the item from future work queries; ``transient`` fails the item softly
  and the next run retries it;
- items with no output still get a placeholder row so ProcessedBy sees
  them as done (output_handlers/mod.rs:18-27);
- embeddings also append to the device VectorIndex in the same logical
  step, and the finishing phase runs the quant reconcile inline
  (jobs/vector_quants.rs:280 ``finishing_phase``).
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np

from panoptikon_tpu_torch.db import store
from panoptikon_tpu_torch.db.connection import Database
from panoptikon_tpu_torch.db.writer import IndexWriter
from panoptikon_tpu_torch.index.vector_index import VectorIndex
from panoptikon_tpu_torch.jobs.queue import ChangeSummary
from panoptikon_tpu_torch.models.base import PredictionInput, is_error_slot, parse_error_slot
from panoptikon_tpu_torch.utils import npy

logger = logging.getLogger("panoptikon_tpu_torch.jobs")

WORK_CHUNK_ROWS = 1024
LOADER_BUDGET_BYTES = 256 << 20  # in-flight payload cap (budget_slots KiB)


class SystemicExtractionFailure(RuntimeError):
    """Every attempted item failed and at least one failure was NOT an
    input-media verdict — an inference outage, not bad files. The job must
    fail loudly (the queue marks it failed; the incomplete-job guard marks
    its log row) instead of soft-completing a run that did nothing
    (extraction.rs:582-600 classify_extraction_job_failure)."""


@dataclass
class LoadError:
    """Typed loader failure: keeps the media blocker/class so the ledger
    row is heal-able (a bare empty-payload fallback would settle as a
    blockerless 'input' error that nothing ever retries)."""

    stage: str
    error_class: str
    blocker: Optional[str]
    message: str


class ByteBudget:
    """In-flight byte budget (the reference's budget_slots semaphore,
    extraction.rs:462-478): ``hold(n)`` blocks until n bytes fit under the
    cap; an over-cap single item is always admitted alone rather than
    deadlocking."""

    def __init__(self, cap: int):
        import threading

        self.cap = cap
        self._used = 0
        self._cond = threading.Condition()

    def hold(self, n: int):
        budget = self

        class _Hold:
            def __enter__(self):
                with budget._cond:
                    while budget._used > 0 and budget._used + n > budget.cap:
                        budget._cond.wait()
                    budget._used += n
                return self

            def __exit__(self, *exc):
                with budget._cond:
                    budget._used -= n
                    budget._cond.notify_all()
                return False

        return _Hold()


@dataclass
class ExtractionReport:
    setter: str
    total_remaining: int = 0
    processed: int = 0
    segments: int = 0
    input_errors: int = 0
    transient_errors: int = 0
    data_load_time: float = 0.0
    inference_time: float = 0.0
    summary: ChangeSummary = field(default_factory=ChangeSummary)


def _decode_outputs(kind: str, output: Any) -> dict:
    """Normalize one model output by group output_type."""
    if kind in ("clip", "text-embedding"):
        assert isinstance(output, bytes)
        return {"embeddings": npy.parse_npy_matrix(output)}
    if kind == "tags":
        assert isinstance(output, dict)
        return {"tags": output}
    if kind == "text":
        if isinstance(output, dict):
            return {"text": output}
        return {"text": {"text": str(output)}}
    raise ValueError(f"unknown output type {kind!r}")


def run_extraction_job(
    *,
    db: Database,
    writer: IndexWriter,
    index: VectorIndex,
    manager,
    inference_id: str,
    setter_name: Optional[str] = None,
    output_type: str = "clip",
    mime_prefixes: tuple[str, ...] = ("image/",),
    batch_size: int = 16,
    threshold: Optional[float] = None,
    target_entity: str = "items",
    source_setters: tuple[str, ...] = (),
    input_handler: Optional[str] = None,
    input_handler_opts: Optional[dict] = None,
    loader_concurrency: int = 4,
    cancelled=lambda: False,
) -> ExtractionReport:
    """Run one extraction pass for a model over all unprocessed items.

    ``target_entity='items'`` feeds file payloads (image/media models);
    ``'text'`` feeds previously extracted text rows (text-embedding models,
    whose work query is the derived-data one — HasUnprocessedData).
    """
    # Setter identity IS the full inference id ("group/name") — the same
    # naming the reference records, and what PQL's `model` field resolves.
    setter = setter_name or inference_id
    report = ExtractionReport(setter=setter)
    conn = db.reader()

    job_id = writer.call(store.create_data_job)
    if target_entity == "items":
        report.total_remaining = store.count_unprocessed(conn, setter, mime_prefixes)
    log_id = writer.call(
        lambda c: store.add_data_log(
            c,
            job_id,
            log_type=output_type,
            setter=setter,
            batch_size=batch_size,
            threshold=threshold,
            total_remaining=report.total_remaining,
        )
    )
    setter_id = writer.call(lambda c: store.upsert_setter(c, setter))

    after = 0
    pending_vectors: list[tuple[int, int, np.ndarray, float]] = []

    # Bounded-concurrency loading (the reference's loader_slots + KiB
    # budget_slots semaphores, extraction.rs:462-478): file reads + decode
    # overlap while inference output order stays deterministic; the byte
    # budget caps in-flight payload memory so a run of large videos can't
    # balloon the host heap. The loop keeps ONE chunk of lookahead in
    # flight: the loader threads read/decode batch k+1 WHILE the device
    # embeds batch k, so host decode tracks the device embed rate instead of
    # serializing in front of it (the overlap extraction.rs gets from its
    # spawned loader tasks; measured in tools/build_bench.py).
    pool = None
    if loader_concurrency > 1 and target_entity == "items":
        from concurrent.futures import ThreadPoolExecutor

        budget = ByteBudget(LOADER_BUDGET_BYTES)
        pool = ThreadPoolExecutor(max_workers=loader_concurrency)

        def load_one(row):
            # row[3] is the item size from the work query.
            est = int(row[3]) if len(row) == 4 and row[3] else 1 << 20
            with budget.hold(est):
                return _load_payloads(
                    db.reader(), db, row, target_entity, threshold,
                    input_handler, input_handler_opts,
                )

    def submit_chunk(chunk):
        if pool is None:
            return chunk, None
        return chunk, [pool.submit(load_one, row) for row in chunk]

    try:
        while not cancelled():
            if target_entity == "items":
                work = store.unprocessed_items(
                    conn, setter, mime_prefixes=mime_prefixes,
                    after_item_id=after, limit=WORK_CHUNK_ROWS,
                )
            else:
                work = _unprocessed_text(conn, setter, source_setters, after)
            if not work:
                break
            after = work[-1][0]
            chunks = [
                work[s : s + batch_size] for s in range(0, len(work), batch_size)
            ]
            pending = submit_chunk(chunks[0])
            for ci in range(len(chunks)):
                if cancelled():
                    break
                chunk, futures = pending
                pending = (
                    submit_chunk(chunks[ci + 1]) if ci + 1 < len(chunks)
                    else (None, None)
                )
                t0 = time.perf_counter()
                inputs, loadable, spans = [], [], []
                batch_writes: list[tuple[int, tuple, Any]] = []
                if futures is not None:
                    loaded = [f.result() for f in futures]
                else:
                    loaded = [
                        _load_payloads(
                            conn, db, row, target_entity, threshold,
                            input_handler, input_handler_opts,
                        )
                        for row in chunk
                    ]
                for row, payloads in zip(chunk, loaded):
                    if isinstance(payloads, LoadError):
                        err = payloads
                        if err.error_class == "input":
                            writer.call(
                                lambda c, r=row, e=err: store.record_extraction_error(
                                    c, r[0], setter, stage=e.stage,
                                    error_class="input", message=e.message,
                                    blocker=e.blocker,
                                )
                            )
                            report.input_errors += 1
                        else:
                            report.transient_errors += 1
                        continue
                    if not payloads:
                        writer.call(
                            lambda c, r=row: store.record_extraction_error(
                                c, r[0], setter, stage="load",
                                error_class="input", message="no loadable payload",
                            )
                        )
                        report.input_errors += 1
                        continue
                    spans.append((len(inputs), len(payloads)))
                    inputs.extend(payloads)
                    loadable.append(row)
                report.data_load_time += time.perf_counter() - t0
                if not inputs:
                    continue
                t0 = time.perf_counter()
                try:
                    # The job's batch_size rides the request as the dispatch
                    # window cap (reference design §6: max_batch on the wire).
                    outputs = manager.predict(
                        inference_id, inputs, max_batch=max(batch_size, len(inputs))
                    )
                except Exception as exc:
                    # Merged-batch failure → per-request fallback
                    # (dispatch.rs:28-35).
                    outputs = []
                    for single in inputs:
                        try:
                            outputs.extend(manager.predict(inference_id, [single]))
                        except Exception:
                            outputs.append(
                                {"__error__": {"class": "transient", "message": str(exc)}}
                            )
                report.inference_time += time.perf_counter() - t0

                for row, (start, count) in zip(loadable, spans):
                    # text-entity rows lead with the DATA-id cursor key
                    # (_unprocessed_text: cursor, item_id, src, ...); using it
                    # as the item would attribute embeddings and ledger rows
                    # to whatever item happens to share that number.
                    item_id = row[1] if target_entity == "text" else row[0]
                    item_outputs = outputs[start : start + count]
                    # Per-unit error slots: one `transient` fails the whole item
                    # softly; `input` slots among survivors are settled verdicts
                    # on those units only (protocol doc:99-126).
                    kept = []
                    input_fail_msg = None
                    transient = False
                    for out in item_outputs:
                        if is_error_slot(out):
                            cls, msg = parse_error_slot(out)
                            if cls == "transient":
                                transient = True
                            else:
                                input_fail_msg = msg
                        else:
                            kept.append(out)
                    if transient:
                        report.transient_errors += 1
                        continue
                    if not kept:
                        writer.call(
                            lambda c, i=item_id, m=input_fail_msg or "all units failed":
                            store.record_extraction_error(
                                c, i, setter, stage="inference",
                                error_class="input", message=m,
                            )
                        )
                        report.input_errors += 1
                        continue
                    merged = _merge_outputs(output_type, kept)
                    batch_writes.append((item_id, row, merged))
                if batch_writes:
                    _flush_writes(
                        writer, output_type, setter_id, job_id, batch_writes,
                        report, pending_vectors,
                    )
            report.summary.wrote_data = True

    finally:
        if pool is not None:
            # Always reap loader threads — an exception escaping the
            # chunk loop (writer failure, systemic error) must not leak
            # workers or keep decoding into a dead job.
            pool.shutdown(wait=True, cancel_futures=True)

    # Flush device-index appends in row-id order.
    if pending_vectors:
        pending_vectors.sort(key=lambda t: t[1])
        items = np.array([p[0] for p in pending_vectors], dtype=np.int64)
        rows = np.array([p[1] for p in pending_vectors], dtype=np.int64)
        vecs = np.stack([p[2] for p in pending_vectors])
        weights = np.array([p[3] for p in pending_vectors], dtype=np.float32)
        index.add(setter, items, rows, vecs, weights)
        report.summary.needs_analyze = True

    # Failure classification (extraction.rs:218): a run where EVERY
    # attempted item failed and any failure was systemic (transient) did
    # nothing useful — fail loudly, leaving the log row for the incomplete
    # guard. Input-only failure runs did all they could: complete, warn.
    attempted = report.processed + report.input_errors + report.transient_errors
    if attempted > 0 and report.processed == 0 and not cancelled():
        if report.transient_errors > 0:
            raise SystemicExtractionFailure(
                f"{setter}: all {attempted} attempted items failed "
                f"({report.transient_errors} systemic) — inference outage?"
            )
        logger.warning(
            "%s: %d items failed on input media; not an inference outage",
            setter, report.input_errors,
        )

    writer.call(
        lambda c: store.finish_data_log(
            c,
            log_id,
            total_segments=report.segments,
            errors=report.input_errors + report.transient_errors,
            data_load_time=report.data_load_time,
            inference_time=report.inference_time,
        )
    )
    writer.call(lambda c: store.complete_data_job(c, job_id))
    if output_type == "tags":
        report.summary.tags_dirty = True

    # Finishing phase: inline quant reconcile for the touched space
    # (jobs/vector_quants.rs:280).
    if output_type in ("clip", "text-embedding") and pending_vectors:
        from panoptikon_tpu_torch.jobs.reconcile import reconcile_space

        reconcile_space(db, writer, index, setter)
    return report


def _unprocessed_text(conn, setter: str, source_setters, after: int):
    """Derived-data work query: text rows not yet embedded by this setter
    (the HasUnprocessedData shape). The existence test finds a text row's
    outputs through ``item_data_source``: without the hint SQLite walks
    every row of the setter (``item_data_setter_type``) for each text row,
    so a build's work queries grow with the square of its rows (the
    reference's plan; ROADMAP §C)."""
    src_sql, params = "", [setter, after]
    if source_setters:
        src_sql = f"AND ss.name IN ({','.join('?' * len(source_setters))})"
        params.extend(source_setters)
    rows = conn.execute(
        f"""SELECT d.item_id, d.id, t.text, t.confidence, t.language_confidence
            FROM item_data d
            JOIN extracted_text t ON t.id = d.id
            JOIN setters ss ON ss.id = d.setter_id
            WHERE NOT EXISTS (
                SELECT 1 FROM item_data dv INDEXED BY item_data_source
                JOIN setters s2 ON s2.id = dv.setter_id
                WHERE dv.source_id = d.id AND s2.name = ?)
              AND d.id > ? {src_sql}
            ORDER BY d.id LIMIT {WORK_CHUNK_ROWS}""",
        params,
    ).fetchall()
    # (cursor_key=data_id, item_id, source data_id, text payload)
    return [(int(r[1]), int(r[0]), int(r[1]), r[2], r[3], r[4]) for r in rows]


def _load_payloads(
    conn, db: Database, row, target_entity: str, threshold,
    input_handler, input_handler_opts,
) -> list[PredictionInput]:
    if target_entity == "text":
        _cursor, _item, _src, text, _conf, _lconf = row
        return [PredictionInput(data={"text": text})]
    item_id, sha, mime = row[0], row[1], row[2]
    file_row = conn.execute(
        "SELECT path FROM files WHERE item_id = ? AND available = 1 LIMIT 1",
        (item_id,),
    ).fetchone()
    if file_row is None:
        return []
    try:
        with open(file_row[0], "rb") as f:
            payload = f.read()
    except OSError:
        return []
    data: dict = {}
    if threshold is not None:
        data["threshold"] = threshold
    if input_handler in ("md5", "md5_image", "sha256_md5_path"):
        # Hash-only handlers (lookup taggers): no file payload rides along.
        row_meta = conn.execute(
            "SELECT md5, sha256 FROM items WHERE id = ?", (item_id,)
        ).fetchone()
        if row_meta is None:
            return []
        data["md5"] = row_meta[0]
        if input_handler == "sha256_md5_path":
            data["sha256"] = row_meta[1]
            data["path"] = file_row[0]
        return [PredictionInput(data=data)]
    if input_handler == "decoded_image":
        # Decode + model-native preprocess IN THE LOADER THREAD (PIL
        # releases the GIL for decode/resize), so the manager thread ships
        # ready pixel batches to the device instead of serializing decode
        # in front of every embed (the host-decode saturation SURVEY §7
        # hard part 6 predicts; measured in tools/build_bench.py).
        from panoptikon_tpu_torch.models.base import SlotError
        from panoptikon_tpu_torch.models.impls import decode_image

        opts = input_handler_opts or {}
        size = int(opts.get("size", 224))
        try:
            arr = decode_image(payload, size)
        except SlotError as err:
            return LoadError("decode", err.error_class, None, err.message)
        data["pixels"] = arr
        return [PredictionInput(data=data)]
    if input_handler == "audio_tracks":
        from panoptikon_tpu_torch.jobs import media
        from panoptikon_tpu_torch.jobs.input_handlers import prepare_audio_tracks

        try:
            wavs = prepare_audio_tracks(file_row[0], payload, mime)
        except media.MediaError as exc:
            return LoadError("load", exc.error_class, exc.blocker, str(exc))
        return [PredictionInput(data=dict(data), file=wv) for wv in wavs]
    if input_handler == "image_frames":
        from panoptikon_tpu_torch.jobs.input_handlers import prepare_image_frames

        opts = input_handler_opts or {}
        frames = prepare_image_frames(
            conn, item_id, sha, payload,
            max_frames=int(opts.get("max_frames", 4)),
            slice_frames=bool(opts.get("slice_frames", False)),
            slice_settings=opts.get("slice_settings"),
        )
        return [PredictionInput(data=dict(data), file=fr) for fr in frames]
    return [PredictionInput(data=data, file=payload)]


def _merge_outputs(output_type: str, outputs: list):
    """Aggregate one item's per-unit outputs (frames/slices)."""
    if len(outputs) == 1:
        return outputs[0]
    if output_type in ("clip", "text-embedding"):
        mats = [npy.parse_npy_matrix(o) for o in outputs]
        return npy.serialize_npy(np.concatenate(mats, axis=0))
    if output_type == "tags":
        merged = dict(outputs[0])
        tag_sections: dict[str, dict] = {}
        for out in outputs:
            for sub_ns, tag_map in out.get("tags", []):
                dst = tag_sections.setdefault(sub_ns, {})
                for name, conf in tag_map.items():
                    dst[name] = max(dst.get(name, 0.0), float(conf))
        merged["tags"] = [(ns, tags) for ns, tags in tag_sections.items()]
        return merged
    if output_type == "text":
        texts = []
        for out in outputs:
            body = out if isinstance(out, dict) else {"text": str(out)}
            if body.get("text"):
                texts.append(body["text"])
        first = outputs[0] if isinstance(outputs[0], dict) else {}
        return {**first, "text": "\n".join(texts)}
    return outputs[0]


def _flush_writes(
    writer, output_type, setter_id, job_id, batch_writes, report,
    pending_vectors,
):
    """Persist one dispatch batch's outputs in a SINGLE writer transaction.

    One ``writer.call`` per batch (not per item) means one SQLite
    transaction + commit + epoch bump per dispatch batch — the build-path
    analogue of the reference's per-batch insert loop
    (extraction.rs:531-560, which holds one write unit across a batch's
    rows). Output decode (npy parse, payload shaping) happens here on the
    job thread, BEFORE entering the writer actor, so the single-writer
    thread only executes SQL and is never the decode bottleneck.
    """
    prepared = []
    for item_id, row, output in batch_writes:
        prepared.append((item_id, row, _decode_outputs(output_type, output)))

    def unit(c):
        results = []
        for item_id, row, decoded in prepared:
            if "embeddings" in decoded:
                matrix = decoded["embeddings"]
                source_id = row[2] if len(row) >= 6 else None
                ids = []
                for i in range(matrix.shape[0]):
                    did = store.insert_item_data(
                        c, item_id, setter_id, output_type, idx=i,
                        job_id=job_id, source_id=source_id,
                    )
                    store.insert_embedding(c, did, matrix[i])
                    ids.append(did)
                results.append(ids)
            elif "tags" in decoded:
                payload = decoded["tags"]
                did = store.insert_item_data(
                    c, item_id, setter_id, "tags", job_id=job_id
                )
                n = 0
                namespace = payload.get("namespace", "tags")
                for sub_ns, tag_map in payload.get("tags", []):
                    if not tag_map:
                        continue
                    full_ns = f"{namespace}:{sub_ns}" if sub_ns else namespace
                    for name, confidence in tag_map.items():
                        tid = store.upsert_tag(c, full_ns, name)
                        store.tag_item(c, did, item_id, tid, float(confidence))
                        n += 1
                if n == 0:
                    c.execute(
                        "UPDATE item_data SET is_placeholder = 1 WHERE id = ?",
                        (did,),
                    )
                results.append(n)
            elif "text" in decoded:
                payload = decoded["text"]
                text = payload.get("text", "")
                did = store.insert_item_data(
                    c, item_id, setter_id, "text", job_id=job_id,
                    is_placeholder=not text,
                )
                if text:
                    store.insert_extracted_text(
                        c,
                        did,
                        text,
                        language=payload.get("language"),
                        language_confidence=payload.get("language_confidence"),
                        confidence=payload.get("confidence"),
                    )
                results.append(1 if text else 0)
            else:
                results.append(0)
        return results

    results = writer.call(unit)
    for (item_id, row, decoded), res in zip(prepared, results):
        if "embeddings" in decoded:
            matrix = decoded["embeddings"]
            weight = 1.0
            if len(row) > 4:
                conf = row[4] if row[4] is not None else 1.0
                lconf = row[5] if row[5] is not None else 1.0
                weight = float(conf) * float(lconf)
            for did, i in zip(res, range(matrix.shape[0])):
                pending_vectors.append((item_id, did, matrix[i], weight))
            report.segments += matrix.shape[0]
        else:
            report.segments += int(res)
        report.processed += 1
