"""Vector-quant reconcile: stateless desired-vs-actual convergence.

The port's copy of ``panoptikon_tpu/jobs/reconcile.py``, held to it unit for unit
by ``tests/test_torch_host_copies.py``: host code only, with imports of the
port. The codes are made by the host codec (``ops.codec``, native where it builds).

The reference's reconcile job (jobs/vector_quants.rs:49 ``run_reconcile``):
"the data is the checkpoint" — each run recomputes its work list from the
diff between the desired state (per-DB system config) and the actual state
(coverage rows + the device index), so a killed run resumes for free.

State machine per (profile, setter) pair (migration comments,
20260720130000_vector_quants.sql): ``pending`` → ``building`` (artifact
frozen at a revision) → ``ready`` (flips only in the completing step).
The artifact is the 4-byte LE f32 scale, frozen once the space holds
``ARTIFACT_MIN_VECTORS`` rows; below that every reconcile recomputes it.

Divergence from the reference: the quantized codes live ONLY in the device index
(rebuildable in one device pass from the durable f32 vectors); SQLite keeps
the profile/coverage state machine, not the codes.
"""

from __future__ import annotations

from dataclasses import dataclass

from panoptikon_tpu_torch.db import store
from panoptikon_tpu_torch.db.connection import Database
from panoptikon_tpu_torch.db.writer import IndexWriter
from panoptikon_tpu_torch.index.vector_index import VectorIndex
from panoptikon_tpu_torch.ops import codec

DEFAULT_PROFILE = "int8"


@dataclass
class ReconcileReport:
    built: list[str]
    dropped: list[str]
    ready: list[str]


def desired_spaces(db: Database) -> dict[str, bool]:
    """setter → quant desired. Config key ``vector_quants`` holds
    ``{"profiles": {"int8": {"setters": [...], "all": bool}}}``; by default
    every embedding setter is desired (the reference's default profile)."""
    conn = db.reader()
    cfg = store.get_config(conn, "vector_quants", None)
    setters = [
        r[0]
        for r in conn.execute(
            """SELECT DISTINCT s.name FROM setters s
               JOIN item_data d ON d.setter_id = s.id
               WHERE d.data_type IN ('clip', 'text-embedding')"""
        ).fetchall()
    ]
    if not cfg:
        return {s: True for s in setters}
    profile = (cfg.get("profiles") or {}).get(DEFAULT_PROFILE) or {}
    if profile.get("all", True):
        return {s: True for s in setters}
    wanted = set(profile.get("setters") or [])
    return {s: s in wanted for s in setters}


def reconcile_space(
    db: Database, writer: IndexWriter, index: VectorIndex, setter: str,
    force_rescale: bool = False,
) -> bool:
    """Converge one space: sync rows from the durable store into the device
    index if missing, freeze/honor the artifact, build/backfill codes, flip
    ready. Returns True when the quant arm is ready after the call.

    Artifact freeze semantics (vector_quants.rs:585,1024,1119): once a
    coverage row is ``ready`` with an artifact frozen over at least
    ``ARTIFACT_MIN_VECTORS`` rows, later reconciles quantize ONLY the new
    rows under the frozen scale — existing codes (and any golden quant_ab
    dumps) stay byte-stable. The artifact revision bumps only when the
    scale is actually (re)derived: below the freeze threshold, or on an
    explicit ``force_rescale`` rebuild.
    """
    from panoptikon_tpu_torch.jobs.index_sync import sync_space

    sync_space(db, index, setter)
    try:
        snap = index.snapshot(setter)
    except KeyError:
        return False
    if snap.size == 0:
        return False

    def begin(conn):
        pid = _ensure_profile(conn)
        sid = store.upsert_setter(conn, setter)
        row = conn.execute(
            """SELECT artifact, n_at_artifact, dim, state
               FROM vector_quant_coverage
               WHERE profile_id=? AND setter_id=?""",
            (pid, sid),
        ).fetchone()
        conn.execute(
            """INSERT INTO vector_quant_coverage (profile_id, setter_id, state, dim)
               VALUES (?,?, 'building', ?)
               ON CONFLICT(profile_id, setter_id) DO UPDATE SET
                 state='building', dim=excluded.dim""",
            (pid, sid, snap.dim),
        )
        return pid, sid, row

    pid, sid, row = writer.call(begin)
    frozen_scale = None
    if not force_rescale and row is not None:
        artifact, n_at_artifact, dim, state = row
        if (
            state == "ready"
            and artifact is not None
            and dim == snap.dim
            and (n_at_artifact or 0) >= codec.ARTIFACT_MIN_VECTORS
        ):
            frozen_scale = codec.artifact_scale(artifact)

    if frozen_scale is not None:
        index.backfill_quant(setter, frozen_scale)

        def complete(conn):
            # Ready flips back in the completing transaction; the frozen
            # artifact and its revision are untouched.
            conn.execute(
                """UPDATE vector_quant_coverage SET state='ready'
                   WHERE profile_id=? AND setter_id=?""",
                (pid, sid),
            )

        writer.call(complete)
        return True

    scale = index.build_quant(setter)
    artifact = codec.scale_artifact(scale)
    n = snap.size
    unchanged = row is not None and row[0] == artifact

    def complete(conn):
        # Ready flips only in the completing transaction; the frozen
        # artifact + revision land atomically with it. A re-derive that
        # lands on the identical artifact keeps its revision (codes are
        # byte-identical, nothing churned).
        conn.execute(
            f"""UPDATE vector_quant_coverage
               SET state='ready', artifact=?,
                   artifact_rev=artifact_rev{'' if unchanged else '+1'},
                   n_at_artifact=?
               WHERE profile_id=? AND setter_id=?""",
            (artifact, n, pid, sid),
        )

    writer.call(complete)
    return True


def run_reconcile(
    db: Database, writer: IndexWriter, index: VectorIndex,
    cancelled=lambda: False, force_rescale: bool = False,
) -> ReconcileReport:
    desired = desired_spaces(db)
    report = ReconcileReport(built=[], dropped=[], ready=[])
    for setter, wanted in desired.items():
        if cancelled():
            break
        if wanted:
            if reconcile_space(db, writer, index, setter,
                               force_rescale=force_rescale):
                report.built.append(setter)
                report.ready.append(setter)
        else:
            try:
                if index.snapshot(setter).quant_ready:
                    index.drop_quant(setter)
                    report.dropped.append(setter)
            except KeyError:
                pass
            writer.call(lambda c, s=setter: _drop_coverage(c, s))
    return report


def coverage_status(db: Database) -> list[dict]:
    conn = db.reader()
    rows = conn.execute(
        """SELECT p.name, s.name, c.state, c.artifact_rev, c.n_at_artifact, c.dim
           FROM vector_quant_coverage c
           JOIN vector_quant_profiles p ON p.id = c.profile_id
           JOIN setters s ON s.id = c.setter_id"""
    ).fetchall()
    return [
        {
            "profile": r[0],
            "setter": r[1],
            "state": r[2],
            "artifact_rev": r[3],
            "n_at_artifact": r[4],
            "dim": r[5],
        }
        for r in rows
    ]


def _ensure_profile(conn) -> int:
    row = conn.execute(
        "SELECT id FROM vector_quant_profiles WHERE name = ?", (DEFAULT_PROFILE,)
    ).fetchone()
    if row:
        return int(row[0])
    return int(
        conn.execute(
            """INSERT INTO vector_quant_profiles (name, quantizer, state, is_default)
               VALUES (?, 'int8_absmax', 'active', 1) RETURNING id""",
            (DEFAULT_PROFILE,),
        ).fetchone()[0]
    )


def _drop_coverage(conn, setter: str) -> None:
    sid = store.setter_id(conn, setter)
    if sid is not None:
        conn.execute(
            """DELETE FROM vector_quant_coverage WHERE setter_id = ?
               AND profile_id IN (SELECT id FROM vector_quant_profiles WHERE name = ?)""",
            (sid, DEFAULT_PROFILE),
        )
