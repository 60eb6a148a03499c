"""Typed PQL query construction — the Python analog of the reference's
generated TypeScript client models (SURVEY §1 L8; its UI builds PQL bodies
from typed filter objects).

The port's copy of ``panoptikon_tpu/pql/build.py``, held to it unit for unit by
``tests/test_torch_host_copies.py``.

Everything here produces PLAIN DICTS in the exact JSON shape
``pql.model.PqlQuery.from_json`` parses (and the HTTP API accepts), so the
module stays dependency-free and usable from ingest scripts together with
:mod:`panoptikon_tpu_torch.client` without importing the engine.

Usage::

    from panoptikon_tpu_torch.pql import build as Q

    q = (Q.image("a red bicycle", model="clip/vit-b-32")
         & Q.match(type__startswith="image/", size__gte=10_000)
         & ~Q.path("/trash/"))
    body = Q.body(q, page_size=40, order_by=[Q.order("random")], seed=7)

    fused = Q.rrf(
        Q.image("sunset over water", model="clip/vit-b-32"),
        Q.text_embed("sunset over water", model="st/minilm"),
        k=60, weights=(1.0, 0.5),
    )
"""

from __future__ import annotations

from typing import Any, Iterable, Mapping, Optional, Sequence

_OPERATOR_KEYS = ("and_", "or_", "not_", "and", "or", "not")

# column__op kwargs accepted by match(); "in"/"not_in" map onto the model's
# "in_"/"nin" (pql/model.py MATCH_OPS).
_OP_ALIASES = {"in": "in_", "not_in": "nin"}


class Filter(dict):
    """One PQL query element (a filter or operator node) with combinators:
    ``&`` → and_, ``|`` → or_, ``~`` → not_ (adjacent same-operator nodes
    flatten, matching how hand-written trees are usually shaped)."""

    def _merge(self, op: str, other: "Filter") -> "Filter":
        if not isinstance(other, dict):
            raise TypeError(f"cannot combine Filter with {type(other)!r}")
        mine = self[op] if set(self) == {op} else [self]
        theirs = other[op] if set(other) == {op} else [other]
        return Filter({op: list(mine) + list(theirs)})

    def __and__(self, other: "Filter") -> "Filter":
        return self._merge("and_", other)

    def __or__(self, other: "Filter") -> "Filter":
        return self._merge("or_", other)

    # plain_dict OP Filter must build an operator node too — without these
    # reflected forms Python falls back to PEP-584 dict merge, which would
    # silently fuse two filters into one corrupt node.
    def __rand__(self, other) -> "Filter":
        return Filter(other)._merge("and_", self)

    def __ror__(self, other) -> "Filter":
        return Filter(other)._merge("or_", self)

    def __invert__(self) -> "Filter":
        if set(self) == {"not_"}:
            return Filter(self["not_"])  # double negation unwraps
        return Filter({"not_": dict(self)})

    def ranked(
        self,
        *,
        order_by: bool = True,
        direction: Optional[str] = None,
        priority: Optional[int] = None,
        row_n: Optional[bool] = None,
        rrf: Optional[Mapping[str, Any]] = None,
        select_as: Optional[str] = None,
        gt=None,
        lt=None,
    ) -> "Filter":
        """Return a copy carrying sortable options (order_by/priority/
        row_n/rrf — pql/model.py SortableOptions). Only leaf filters rank;
        operators raise, as they do server-side."""
        if set(self) & set(_OPERATOR_KEYS):
            raise ValueError("operators (and_/or_/not_) cannot carry "
                             "sortable options; rank the leaf filters")
        out = Filter(self)
        out["order_by"] = order_by
        for key, val in (
            ("direction", direction), ("priority", priority),
            ("row_n", row_n), ("rrf", dict(rrf) if rrf else None),
            ("select_as", select_as), ("gt", gt), ("lt", lt),
        ):
            if val is not None:
                out[key] = val
        return out


def _filter(key: str, args: Mapping[str, Any]) -> Filter:
    return Filter({key: {k: v for k, v in args.items() if v is not None}})


# ----------------------------------------------------------------- leaves

def image(
    query: str, *, model: str, index: Optional[str] = None,
    embed: Any = "unset", distance_aggregation: Optional[str] = None,
    clip_xmodal: Optional[bool] = None, src_text: Any = None,
) -> Filter:
    """Semantic image search (image_embeddings). ``query`` is natural
    language, or a base64 npy vector with ``embed=None`` (the raw-vector
    mode — see client.raw_embedding_query). ``distance_aggregation`` is
    MIN/MAX/AVG (the engine's multi-row group fold)."""
    args = {k: v for k, v in {
        "query": query, "model": model, "index": index,
        "distance_aggregation": distance_aggregation,
        "clip_xmodal": clip_xmodal, "src_text": src_text,
    }.items() if v is not None}
    if embed != "unset":
        args["embed"] = embed  # None is meaningful: raw-vector mode
    return Filter({"image_embeddings": args})


def text_embed(
    query: str, *, model: str, index: Optional[str] = None,
    embed: Any = "unset", distance_aggregation: Optional[str] = None,
    src_text: Any = None,
) -> Filter:
    """Semantic text search (text_embeddings) over extracted-text chunks."""
    args = {k: v for k, v in {
        "query": query, "model": model, "index": index,
        "distance_aggregation": distance_aggregation,
        "src_text": src_text,
    }.items() if v is not None}
    if embed != "unset":
        args["embed"] = embed  # None is meaningful: raw-vector mode
    return Filter({"text_embeddings": args})


def similar(
    target: str, *, model: str, index: Optional[str] = None,
    distance_function: Optional[str] = None,
    distance_aggregation: Optional[str] = None,
    src_text: Any = None, clip_xmodal: Optional[bool] = None,
) -> Filter:
    """similar_to: rank by similarity to the item with this sha256.
    ``distance_function`` is L2/COSINE; ``distance_aggregation``
    MIN/MAX/AVG over the anchor's rows."""
    return _filter("similar_to", {
        "target": target, "model": model, "index": index,
        "distance_function": distance_function,
        "distance_aggregation": distance_aggregation,
        "src_text": src_text, "clip_xmodal": clip_xmodal,
    })


def match(**column_ops: Any) -> Filter:
    """Typed column constraints: ``column__op=value`` pairs, e.g.
    ``match(type__startswith="image/", size__gte=1000)``. Multiple pairs
    AND together inside one match filter (match_filter.rs nesting)."""
    clauses = []
    for key, value in column_ops.items():
        col, sep, op = key.rpartition("__")
        if not sep:
            raise ValueError(
                f"match() kwargs are column__op pairs, got {key!r}")
        op = _OP_ALIASES.get(op, op)
        clauses.append({op: {col: value}})
    if not clauses:
        raise ValueError("match() needs at least one column__op pair")
    body = clauses[0] if len(clauses) == 1 else {"and_": clauses}
    return Filter({"match": body})


def path(match_: str, *, raw_fts5: Optional[bool] = None,
         filename_only: Optional[bool] = None) -> Filter:
    """Path full-text match (match_path). By default the string is
    JSON-quoted into an FTS5 phrase (the built-in UI's convention);
    ``raw_fts5=True`` passes FTS5 syntax through verbatim, ``False`` asks
    the engine to escape it."""
    import json as _json

    return _filter("match_path", {
        "match": _json.dumps(match_) if raw_fts5 is None else match_,
        "raw_fts5_match": raw_fts5, "filename_only": filename_only,
    })


def text(match_: str, *, raw_fts5: Optional[bool] = None,
         setters: Optional[Sequence[str]] = None,
         languages: Optional[Sequence[str]] = None,
         min_confidence: Optional[float] = None,
         filter_only: Optional[bool] = None,
         select_snippet_as: Optional[str] = None) -> Filter:
    """Extracted-text full-text match (match_text, FTS5 trigram). Quoting
    follows the same convention as :func:`path`."""
    import json as _json

    return _filter("match_text", {
        "match": _json.dumps(match_) if raw_fts5 is None else match_,
        "raw_fts5_match": raw_fts5, "setters": list(setters) if setters else None,
        "languages": list(languages) if languages else None,
        "min_confidence": min_confidence, "filter_only": filter_only,
        "select_snippet_as": select_snippet_as,
    })


def tags(*names: str, match_any: bool = True,
         namespaces: Optional[Sequence[str]] = None,
         setters: Optional[Sequence[str]] = None,
         min_confidence: Optional[float] = None) -> Filter:
    """Tag filter (match_tags): any-of by default, ``match_any=False`` for
    all-of."""
    if not names:
        raise ValueError("tags() needs at least one tag name")
    return _filter("match_tags", {
        "tags": list(names), "match_any": match_any,
        "namespaces": list(namespaces) if namespaces else None,
        "setters": list(setters) if setters else None,
        "min_confidence": min_confidence,
    })


def in_bookmarks(*, user: Optional[str] = None,
                 namespaces: Optional[Sequence[str]] = None,
                 sub_ns: Optional[bool] = None,
                 include_wildcard: Optional[bool] = None) -> Filter:
    return _filter("in_bookmarks", {
        "user": user, "sub_ns": sub_ns,
        "include_wildcard": include_wildcard,
        "namespaces": list(namespaces) if namespaces else None,
    })


def in_pinboard(*pinboard_ids: int, user: Optional[str] = None) -> Filter:
    return _filter("in_pinboard", {
        "pinboard_ids": list(pinboard_ids), "user": user,
    })


def processed_by(setter: str) -> Filter:
    """Items already processed by this setter (bare-string filter)."""
    return Filter({"processed_by": setter})


def has_unprocessed(setter: str,
                    data_types: Optional[Sequence[str]] = None) -> Filter:
    """Items with derived data this setter has NOT processed yet
    (has_data_unprocessed — the extraction work-query predicate)."""
    return _filter("has_data_unprocessed", {
        "setter_name": setter,
        "data_types": list(data_types) if data_types else None,
    })


def failed_for(setter: str) -> Filter:
    """Items in this setter's failure ledger (bare-string filter)."""
    return Filter({"failed_for": setter})


# ------------------------------------------------------------ composition

def rrf(*filters: Filter, k: int = 60,
        weights: Optional[Sequence[float]] = None,
        priority: int = 5) -> Filter:
    """Reciprocal-rank fusion: each filter becomes a ranked entry in one
    same-priority order group (Σ w/(k+rank) — the multi-model fusion the
    device rank join serves)."""
    if len(filters) < 2:
        raise ValueError("rrf() fuses two or more ranked filters")
    ws = list(weights) if weights is not None else [1.0] * len(filters)
    if len(ws) != len(filters):
        raise ValueError("weights must match the number of filters")
    entries = [
        f.ranked(priority=priority, row_n=True,
                 rrf={"k": k, "weight": w})
        for f, w in zip(filters, ws)
    ]
    return Filter({"and_": entries})


def order(field: str = "last_modified", *, direction: Optional[str] = None,
          priority: Optional[int] = None) -> dict:
    """A top-level order_by entry (order(\"random\") + seed for the
    deterministic pageable shuffle). The wire key for direction is
    ``order`` (asc/desc) — distinct from the filter-level ``direction``
    sortable option."""
    out: dict[str, Any] = {"order_by": field}
    if direction is not None:
        out["order"] = direction
    if priority is not None:
        out["priority"] = priority
    return out


def body(query: Optional[Filter] = None, *, page: int = 1,
         page_size: int = 10, order_by: Optional[Iterable[dict]] = None,
         select: Optional[Sequence[str]] = None, entity: str = "file",
         partition_by: Optional[Sequence[str]] = None,
         seed: Optional[int] = None, count: bool = True,
         results: bool = True, check_path: bool = False,
         cache: bool = True) -> dict:
    """The full POST /api/search/pql body."""
    out: dict[str, Any] = {
        "page": page, "page_size": page_size, "entity": entity,
        "count": count, "results": results, "check_path": check_path,
        "cache": cache,
    }
    if query is not None:
        out["query"] = dict(query)
    if order_by is not None:
        out["order_by"] = [dict(o) for o in order_by]
    if select is not None:
        out["select"] = list(select)
    if partition_by is not None:
        out["partition_by"] = list(partition_by)
    if seed is not None:
        out["seed"] = seed
    return out
