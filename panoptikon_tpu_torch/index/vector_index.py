"""The host vector index: embedding spaces as capacity-padded NumPy arrays.

The port's own copy of ``panoptikon_tpu/index/vector_index.py`` (NumPy only;
the port imports nothing of the JAX package). It replaces the reference's
SQLite-resident ``embeddings`` / ``embedding_quants`` tables
(db/vector_quants.rs) as the thing queries scan. Layout per *embedding
space* (one (model setter, dimension) pair, e.g. "clip ViT-B/32 image
embeddings"):

- ``vectors``  (capacity, D) f32 — full-precision rows (the exact arm).
- ``codes``    (capacity, D) int8 — quantized rows under the space's frozen
  scale (the quant arm). Present only when the space's quant profile is
  READY, mirroring the reference's profile/coverage lifecycle.
- ``row_valid`` (capacity,) bool; ``group_ids`` (capacity,) int32 — dense
  item slots; ``row_ids`` host-side int64 — the DB identity of each row.
- ``item_of_group`` (capacity,) int64 — the DB item id of each of the first
  ``num_groups`` slots. A space never holds more items than rows, so the
  row capacity always holds the table.

Each space is capacity-padded and grows by power-of-two reallocation. Rows
are appended in ascending id order; deletions clear ``row_valid``
(tombstones) and a rebuild compacts. The host index is the source of
truth; ``index.device_index.DeviceIndex`` uploads one snapshot to the
device as a rebuildable projection (jobs/vector_quants.rs:1-9).

Item-group invariant: all rows of one item are contiguous.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

import numpy as np

from panoptikon_tpu_torch import tracing
from panoptikon_tpu_torch.ops import codec

MIN_CAPACITY = 4096


def _next_capacity(n: int, chunk_rows: int) -> int:
    cap = MIN_CAPACITY
    while cap < n:
        cap *= 2
    # Keep capacity a multiple of the streaming chunk so reshapes are exact.
    if cap % chunk_rows:
        cap = ((cap // chunk_rows) + 1) * chunk_rows
    return cap


@dataclass
class SpaceSnapshot:
    """An immutable, device-ready view of one embedding space.

    Queries run against a snapshot; writers build a new snapshot and swap it
    in atomically (generation bump) — the single-writer/epoch discipline of
    the reference's index writer actor (db/index_writer.rs) expressed as
    immutable array generations instead of SQLite transactions.
    """

    generation: int
    dim: int
    size: int  # valid rows
    capacity: int
    vectors: np.ndarray  # (capacity, D) f32
    row_valid: np.ndarray  # (capacity,) bool
    group_ids: np.ndarray  # (capacity,) int32 — dense item slot per row
    row_ids: np.ndarray  # (capacity,) int64 — DB identity (host-side only)
    weights: np.ndarray  # (capacity,) f32 — per-row confidence weights
    num_groups: int
    # Quant arm (None until the profile is READY).
    scale: float | None = None
    codes: np.ndarray | None = None

    @property
    def quant_ready(self) -> bool:
        return self.codes is not None and self.scale is not None


@dataclass
class _SpaceState:
    dim: int
    size: int = 0
    capacity: int = 0
    generation: int = 0
    vectors: np.ndarray | None = None
    row_valid: np.ndarray | None = None
    group_ids: np.ndarray | None = None
    row_ids: np.ndarray | None = None
    weights: np.ndarray | None = None
    group_of_item: dict[int, int] = field(default_factory=dict)
    item_of_group: np.ndarray | None = None
    num_groups: int = 0
    # Largest item id ever assigned a slot: lets chunked ascending appends
    # of strictly-new items take the vectorized bulk path.
    max_item: int = -(2**63)
    # Quant profile lifecycle: None → (scale, codes) once built.
    scale: float | None = None
    codes: np.ndarray | None = None
    quant_revision: int = 0
    # Rows [0:codes_covered] hold valid codes under `scale`; appended rows
    # past it await a backfill (the reference's coverage-row discipline,
    # vector_quants.rs:585 — old codes stay byte-stable across backfills).
    codes_covered: int = 0


class VectorIndex:
    """Host-side owner of every embedding space's device-ready arrays.

    Thread-safe single-writer semantics: all mutation happens under one
    lock; readers grab immutable snapshots. chunk_rows is the streaming
    scorer's chunk size — capacities are kept multiples of it.
    """

    def __init__(self, chunk_rows: int = 32768):
        self.chunk_rows = chunk_rows
        self._spaces: dict[str, _SpaceState] = {}
        self._lock = threading.Lock()
        self._snapshots: dict[str, SpaceSnapshot] = {}

    def space_names(self) -> list[str]:
        with self._lock:
            return list(self._spaces.keys())

    def reserve(self, space: str, n: int, dim: int) -> None:
        """Pre-size a space for ``n`` total rows (bulk builders): chunked
        appends into an unreserved space reallocate at every capacity
        doubling. Idempotent; never shrinks."""
        with self._lock:
            st = self._spaces.get(space)
            if st is None:
                st = _SpaceState(dim=dim)
                self._spaces[space] = st
            if st.dim != dim:
                raise ValueError(
                    f"space {space!r} holds {st.dim}-d vectors, got {dim}-d"
                )
            if st.capacity < max(n, 1):
                # Materialize the arrays even for n == 0: an empty reserved
                # space must still snapshot/build_quant without crashing.
                self._grow(st, max(n, 1))

    def add(
        self,
        space: str,
        item_ids,
        row_ids,
        vectors: np.ndarray,
        weights=None,
    ) -> None:
        """Append rows (ascending row_id order within the call).

        item_ids: (n,) int64 — owning item per row (repeats allowed for
        multi-row items; an item's rows may arrive across multiple calls).
        """
        vectors = np.asarray(vectors, dtype=np.float32)
        n, dim = vectors.shape
        item_ids = np.asarray(item_ids, dtype=np.int64)
        row_ids = np.asarray(row_ids, dtype=np.int64)
        if weights is None:
            weights = np.ones(n, dtype=np.float32)
        with self._lock:
            st = self._spaces.get(space)
            if st is None:
                st = _SpaceState(dim=dim)
                self._spaces[space] = st
            if st.dim != dim:
                raise ValueError(
                    f"space {space!r} holds {st.dim}-d vectors, got {dim}-d"
                )
            need = st.size + n
            if st.capacity < need:
                self._grow(st, need)
            sl = slice(st.size, st.size + n)
            st.vectors[sl] = vectors
            st.row_ids[sl] = row_ids
            st.row_valid[sl] = True
            st.weights[sl] = np.asarray(weights, dtype=np.float32)
            known = st.num_groups
            if len(item_ids) and bool(
                np.all(np.diff(item_ids) >= 0)
            ) and (known == 0 or int(item_ids[0]) > st.max_item):
                # Bulk-build fast path (ascending-sorted batches of
                # strictly-new items): vectorized slot assignment instead
                # of a per-row dict loop. Also taken by chunked appends
                # whose items are all beyond every item seen so far
                # (``max_item``).
                uniq, gids_new = np.unique(item_ids, return_inverse=True)
                gids = (gids_new + known).astype(np.int32)
                st.item_of_group[known : known + len(uniq)] = uniq
                st.num_groups = known + len(uniq)
                st.group_of_item.update(
                    zip(uniq.tolist(), range(known, known + len(uniq)))
                )
                st.max_item = max(st.max_item, int(uniq[-1]))
            else:
                gids = np.empty(n, dtype=np.int32)
                for j, item in enumerate(item_ids.tolist()):
                    slot = st.group_of_item.get(item)
                    if slot is None:
                        slot = st.num_groups
                        st.group_of_item[item] = slot
                        st.item_of_group[slot] = item
                        st.num_groups += 1
                        if item > st.max_item:
                            st.max_item = item
                    gids[j] = slot
            st.group_ids[sl] = gids
            st.size = need
            # New rows are not covered by the frozen codes array; quant
            # coverage is restored by build_quant (the reconcile loop's
            # backfill). Existing codes stay usable for the covered prefix.
            st.generation += 1
            self._snapshots.pop(space, None)

    def remove_items(self, space: str, item_ids) -> int:
        """Tombstone every row of the given items. Returns rows cleared."""
        with self._lock:
            st = self._spaces.get(space)
            if st is None:
                return 0
            slots = {
                st.group_of_item[i] for i in np.asarray(item_ids).tolist()
                if i in st.group_of_item
            }
            if not slots:
                return 0
            mask = np.isin(st.group_ids[: st.size], list(slots))
            cleared = int(mask.sum())
            st.row_valid[: st.size][mask] = False
            st.generation += 1
            self._snapshots.pop(space, None)
            return cleared

    def build_quant(self, space: str, scale: float | None = None) -> float:
        """(Re)build the int8 arm: freeze scale from the live corpus absmax
        (or quantize under a caller-supplied frozen ``scale``), quantize
        every valid row. The reconcile job calls this; mirrors
        compute_int8_scale_artifact + backfill (jobs/vector_quants.rs:49).
        A scale derivation bumps the quant revision (codes may churn); a
        supplied scale re-emits byte-identical codes and keeps the
        revision. Returns the scale in effect."""
        with self._lock:
            st = self._require(space)
            if scale is None:
                # Masked chunk-wise reduction: no boolean fancy-index copy
                # of the corpus.
                scale = codec.scale_from_absmax(
                    codec.corpus_absmax(
                        st.vectors[: st.size], valid=st.row_valid[: st.size]
                    )
                )
                st.quant_revision += 1
            codes = np.zeros((st.capacity, st.dim), dtype=np.int8)
            codec.quantize_int8_host(st.vectors[: st.size], scale, out=codes[: st.size])
            st.scale = scale
            st.codes = codes
            st.codes_covered = st.size
            st.generation += 1
            self._snapshots.pop(space, None)
            return scale

    def backfill_quant(self, space: str, scale: float) -> int:
        """Quantize only rows appended since the last build/backfill, under
        the FROZEN scale — existing codes stay byte-identical (the
        reference's incremental backfill, vector_quants.rs:1024,1119).
        Returns the number of rows backfilled."""
        with self._lock:
            st = self._require(space)
            if st.codes is None or st.scale != scale:
                # Arm missing or scale drifted: full (re)quantize under the
                # frozen scale — per-row deterministic, so rows already
                # coded at this scale come out byte-identical anyway.
                codes = np.zeros((st.capacity, st.dim), dtype=np.int8)
                codec.quantize_int8_host(
                    st.vectors[: st.size], scale, out=codes[: st.size]
                )
                st.codes = codes
                done = st.size
            elif st.codes_covered >= st.size:
                return 0
            else:
                # In-place fill past the covered prefix: rows below it are
                # untouched (older snapshots never score rows beyond their
                # own size, so the shared-array mutation is invisible to
                # them — same invariant as `add`).
                lo, hi = st.codes_covered, st.size
                codec.quantize_int8_host(
                    st.vectors[lo:hi], scale, out=st.codes[lo:hi]
                )
                done = hi - lo
            st.scale = scale
            st.codes_covered = st.size
            st.generation += 1
            self._snapshots.pop(space, None)
            return done

    def drop_space(self, space: str) -> None:
        """Remove a space entirely (its durable rows were deleted; a later
        sync_space rebuild starts from scratch)."""
        with self._lock:
            self._spaces.pop(space, None)
            self._snapshots.pop(space, None)

    def drop_quant(self, space: str) -> None:
        with self._lock:
            st = self._require(space)
            st.scale = None
            st.codes = None
            st.generation += 1
            self._snapshots.pop(space, None)

    def compact(self, space: str) -> None:
        """Drop tombstoned rows and re-pack (keeps ascending row_id order)."""
        with self._lock:
            st = self._require(space)
            live = st.row_valid[: st.size]
            vectors = st.vectors[: st.size][live]
            row_ids = st.row_ids[: st.size][live]
            weights = st.weights[: st.size][live]
            items = st.item_of_group[st.group_ids[: st.size][live]]
            frozen_scale = st.scale
            dim = st.dim
            self._spaces.pop(space)
            self._snapshots.pop(space, None)
        if len(row_ids):
            self.add(space, items, row_ids, vectors, weights)
        else:
            # Every row tombstoned: leave an initialized EMPTY space (the
            # frozen scale survives for future appends) instead of crashing
            # half-popped and losing the space.
            self.reserve(space, 0, dim)
        if frozen_scale is not None:
            # Re-quantize under the PRESERVED scale: surviving rows' codes
            # stay byte-identical and the artifact revision is untouched.
            self.build_quant(space, scale=frozen_scale)

    def snapshot(self, space: str) -> SpaceSnapshot:
        with self._lock:
            st = self._require(space)
            snap = self._snapshots.get(space)
            if snap is not None and snap.generation == st.generation:
                return snap
            snap = SpaceSnapshot(
                generation=st.generation,
                dim=st.dim,
                size=st.size,
                capacity=st.capacity,
                vectors=st.vectors,
                row_valid=st.row_valid.copy(),
                group_ids=st.group_ids,
                row_ids=st.row_ids,
                weights=st.weights,
                num_groups=max(st.num_groups, 1),
                # The quant arm is exposed only at FULL coverage: rows
                # appended after the last build/backfill hold zero codes,
                # and serving them through the int8 path would rank
                # garbage. Uncovered snapshots serve the exact arm until
                # the reconcile backfill restores coverage (the reference's
                # coverage-row discipline, vector_quants.rs:585).
                scale=st.scale if st.codes_covered >= st.size else None,
                codes=st.codes if st.codes_covered >= st.size else None,
            )
            self._snapshots[space] = snap
            return snap

    def group_slots_for_items(self, space: str, item_ids) -> np.ndarray:
        """DB item ids → dense group slots (-1 where the item has no rows in
        this space). Host-side join used by the PQL executor."""
        with self._lock:
            st = self._require(space)
            table = st.group_of_item
        ids = np.asarray(item_ids, dtype=np.int64)
        out = np.full(ids.shape, -1, dtype=np.int64)
        flat = out.reshape(-1)
        for j, item in enumerate(ids.reshape(-1).tolist()):
            slot = table.get(item)
            if slot is not None:
                flat[j] = slot
        return out

    def item_id_of_groups(self, space: str, group_slots: np.ndarray) -> np.ndarray:
        """Dense group slots → DB item ids (host-side join after top-k)."""
        with self._lock:
            st = self._require(space)
            with tracing.span("vector_index.id_table"):
                table = st.item_of_group[: st.num_groups]
            tracing.count("vector_index.id_table_rows", len(table))
        # The view is safe to read without the lock: entries below the count
        # are never rewritten (remove_items leaves them; compact and
        # drop_space replace the whole state), and a _grow copies them into
        # a new buffer while this view keeps the old one alive.
        out = np.full(group_slots.shape, -1, dtype=np.int64)
        ok = (group_slots >= 0) & (group_slots < len(table))
        out[ok] = table[group_slots[ok]]
        return out

    def stats(self) -> dict:
        with self._lock:
            return {
                name: {
                    "dim": st.dim,
                    "rows": st.size,
                    "capacity": st.capacity,
                    "items": st.num_groups,
                    "generation": st.generation,
                    "quant_ready": (st.scale is not None
                                    and st.codes_covered >= st.size),
                    "scale": st.scale,
                    "quant_revision": st.quant_revision,
                }
                for name, st in self._spaces.items()
            }

    # -- internals ----------------------------------------------------------

    def _require(self, space: str) -> _SpaceState:
        st = self._spaces.get(space)
        if st is None:
            raise KeyError(f"unknown embedding space {space!r}")
        return st

    def _grow(self, st: _SpaceState, need: int) -> None:
        cap = _next_capacity(need, self.chunk_rows)
        new_vec = np.zeros((cap, st.dim), dtype=np.float32)
        new_valid = np.zeros(cap, dtype=bool)
        new_gids = np.zeros(cap, dtype=np.int32)
        new_rids = np.full(cap, -1, dtype=np.int64)
        new_w = np.ones(cap, dtype=np.float32)
        new_items = np.full(cap, -1, dtype=np.int64)
        if st.capacity:
            new_vec[: st.size] = st.vectors[: st.size]
            new_valid[: st.size] = st.row_valid[: st.size]
            new_gids[: st.size] = st.group_ids[: st.size]
            new_rids[: st.size] = st.row_ids[: st.size]
            new_w[: st.size] = st.weights[: st.size]
            new_items[: st.num_groups] = st.item_of_group[: st.num_groups]
        (st.vectors, st.row_valid, st.group_ids, st.row_ids, st.weights,
         st.item_of_group) = (
            new_vec,
            new_valid,
            new_gids,
            new_rids,
            new_w,
            new_items,
        )
        st.capacity = cap
        if st.codes is not None:
            new_codes = np.zeros((cap, st.dim), dtype=np.int8)
            new_codes[: st.codes.shape[0]] = st.codes
            st.codes = new_codes
