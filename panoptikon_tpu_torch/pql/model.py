"""PQL — the JSON query language AST.

Wire-compatible with the reference's model (``panoptikon/src/pql/model.rs``
and ``pql/builder/filters/*``): the same field names, defaults, operator
aliases (``and``/``and_`` …), per-filter default sort directions, and the
"untagged enum" parse discipline (filters are discriminated by their unique
payload key; the bare-``match`` filter is tried last and rejects unknown
keys so it cannot swallow operator trees — match_filter.rs:198-206).

The compiler target differs by design: instead of SQL CTE chains the
executor (``pql.executor``) lowers a ``PqlQuery`` to host-side candidate
masks (SQLite predicates) + device scoring passes + on-device rank fusion.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Literal, Optional, Union

MAX_SYNTHESIZED_SEED = 1 << 53  # model.rs:443 — JS-lossless seed bound


class PqlError(ValueError):
    """Raised for malformed or invalid PQL payloads."""


# ---------------------------------------------------------------------------
# Columns / order fields
# ---------------------------------------------------------------------------

FILE_COLUMNS = {
    "file_id", "sha256", "path", "filename", "last_modified", "item_id",
    "md5", "type", "size", "width", "height", "duration", "time_added",
    "audio_tracks", "video_tracks", "subtitle_tracks", "blurhash",
}
TEXT_COLUMNS = {
    "data_id", "language", "language_confidence", "text", "confidence",
    "text_length", "job_id", "setter_id", "setter_name", "data_index",
    "source_id",
}
ALL_COLUMNS = FILE_COLUMNS | TEXT_COLUMNS
ORDER_BY_FIELDS = ALL_COLUMNS | {"random"}

DEFAULT_SELECT = ["sha256", "path", "last_modified", "type"]

Direction = Literal["asc", "desc"]


def _direction(value: Any, default: Direction = "asc") -> Direction:
    if value is None:
        return default
    if value not in ("asc", "desc"):
        raise PqlError(f"invalid order direction {value!r}")
    return value


# ---------------------------------------------------------------------------
# Sortable options (model.rs:128-238)
# ---------------------------------------------------------------------------


@dataclass
class Rrf:
    """Reciprocal rank fusion parameters: ``weight * 1/(rank + k)``."""

    k: int = 1
    weight: float = 1.0

    @staticmethod
    def from_json(obj: Any) -> "Rrf":
        if not isinstance(obj, dict):
            raise PqlError("rrf must be an object")
        return Rrf(k=int(obj.get("k", 1)), weight=float(obj.get("weight", 1.0)))


@dataclass
class SortableOptions:
    order_by: bool = False
    direction: Direction = "asc"
    priority: int = 0
    row_n: bool = False
    row_n_direction: Direction = "asc"
    gt: Optional[Union[int, float, str]] = None
    lt: Optional[Union[int, float, str]] = None
    select_as: Optional[str] = None
    rrf: Optional[Rrf] = None

    @staticmethod
    def from_json(obj: dict, defaults: "SortableOptions" | None = None) -> "SortableOptions":
        """Parse flattened sort fields with per-filter defaults — the
        reference's ``PartialSortableOptions::resolve`` (model.rs:240+)."""
        d = defaults or SortableOptions()
        rrf = obj.get("rrf")
        return SortableOptions(
            order_by=bool(obj.get("order_by", d.order_by)),
            direction=_direction(obj.get("direction"), d.direction),
            priority=int(obj.get("priority", d.priority)),
            row_n=bool(obj.get("row_n", d.row_n)),
            row_n_direction=_direction(obj.get("row_n_direction"), d.row_n_direction),
            gt=obj.get("gt", d.gt),
            lt=obj.get("lt", d.lt),
            select_as=obj.get("select_as", d.select_as),
            rrf=Rrf.from_json(rrf) if rrf is not None else d.rrf,
        )


def _sort_asc_orderby() -> SortableOptions:
    # Vector filters: order by distance ascending by default.
    return SortableOptions(order_by=True, direction="asc", row_n_direction="asc")


def _sort_desc() -> SortableOptions:
    # MatchTags / MatchText: highest confidence / rank first.
    return SortableOptions(direction="desc", row_n_direction="desc")


# ---------------------------------------------------------------------------
# Match filter (match_filter.rs)
# ---------------------------------------------------------------------------

MATCH_OPS = (
    "eq", "neq", "in_", "nin", "gt", "gte", "lt", "lte",
    "startswith", "not_startswith", "endswith", "not_endswith",
    "contains", "not_contains",
)
_SCALAR_OPS = {"eq", "neq", "gt", "gte", "lt", "lte"}


@dataclass
class MatchOps:
    """One column-ops leaf: op name → {column: value-or-values}."""

    ops: dict[str, dict[str, Any]] = field(default_factory=dict)

    @staticmethod
    def from_json(obj: dict) -> "MatchOps":
        ops: dict[str, dict[str, Any]] = {}
        for key, payload in obj.items():
            name = "in_" if key == "in_" else key
            if name not in MATCH_OPS:
                raise PqlError(f"unknown match op {key!r}")
            if payload is None:
                continue
            if not isinstance(payload, dict):
                raise PqlError(f"match op {key!r} must be an object")
            cols = {}
            for col, value in payload.items():
                if col not in ALL_COLUMNS:
                    raise PqlError(f"unknown match column {col!r}")
                if value is None:
                    continue
                if name in _SCALAR_OPS:
                    cols[col] = value
                else:
                    cols[col] = value if isinstance(value, list) else [value]
            if cols:
                ops[name] = cols
        return MatchOps(ops=ops)

    @property
    def empty(self) -> bool:
        return not self.ops


@dataclass
class MatchAnd:
    and_: list["Matches"]


@dataclass
class MatchOr:
    or_: list["Matches"]


@dataclass
class MatchNot:
    not_: "Matches"


Matches = Union[MatchAnd, MatchOr, MatchNot, MatchOps]


def parse_matches(obj: Any) -> Matches:
    """Untagged parse: and/or/not trees first, bare ops last
    (match_filter.rs:198-206)."""
    if not isinstance(obj, dict):
        raise PqlError("match expression must be an object")
    keys = set(obj.keys())
    if keys & {"and_", "and"}:
        if len(keys) != 1:
            raise PqlError("and_ operator takes no other fields")
        return MatchAnd([parse_matches(x) for x in obj.get("and_", obj.get("and"))])
    if keys & {"or_", "or"}:
        if len(keys) != 1:
            raise PqlError("or_ operator takes no other fields")
        return MatchOr([parse_matches(x) for x in obj.get("or_", obj.get("or"))])
    if keys & {"not_", "not"}:
        if len(keys) != 1:
            raise PqlError("not_ operator takes no other fields")
        return MatchNot(parse_matches(obj.get("not_", obj.get("not"))))
    return MatchOps.from_json(obj)


# ---------------------------------------------------------------------------
# Filters
# ---------------------------------------------------------------------------


@dataclass
class MatchFilter:
    match_: Matches


@dataclass
class MatchPathArgs:
    match: str
    filename_only: bool = False
    raw_fts5_match: bool = True


@dataclass
class MatchPath:
    sort: SortableOptions
    match_path: MatchPathArgs


@dataclass
class MatchTextArgs:
    match: str
    filter_only: bool = False
    setters: list[str] = field(default_factory=list)
    languages: list[str] = field(default_factory=list)
    min_language_confidence: Optional[float] = None
    min_confidence: Optional[float] = None
    raw_fts5_match: bool = True
    min_length: Optional[int] = None
    max_length: Optional[int] = None
    select_snippet_as: Optional[str] = None


@dataclass
class MatchText:
    sort: SortableOptions
    match_text: MatchTextArgs


@dataclass
class TagsArgs:
    tags: list[str] = field(default_factory=list)
    match_any: bool = False
    min_confidence: float = 0.0
    setters: list[str] = field(default_factory=list)
    namespaces: list[str] = field(default_factory=list)
    all_setters_required: bool = False


@dataclass
class MatchTags:
    sort: SortableOptions
    match_tags: TagsArgs


@dataclass
class EmbedArgs:
    """Inference-model lifecycle hints riding the query
    (text_embeddings.rs:19-35)."""

    cache_key: str = "search"
    lru_size: int = 1
    ttl_seconds: int = 3600


@dataclass
class SourceArgs:
    """Source-text filters + confidence weighting for derived (text)
    embeddings (item_similarity.rs:19-70)."""

    setters: list[str] = field(default_factory=list)
    languages: Optional[list[str]] = None
    min_confidence: Optional[float] = None
    min_language_confidence: Optional[float] = None
    confidence_weight: float = 0.0
    language_confidence_weight: float = 0.0

    @property
    def weighted(self) -> bool:
        return self.confidence_weight != 0.0 or self.language_confidence_weight != 0.0


@dataclass
class SemanticTextArgs:
    query: str
    model: str
    distance_aggregation: str = "MIN"
    embed: Optional[EmbedArgs] = None
    src_text: Optional[SourceArgs] = None
    index: str = "auto"  # auto | exact | quant | ann(reserved)
    variant: Optional[str] = None
    k: int = 10_000  # deprecated/ignored (embedding_types.rs:60-66)
    # Resolved at preprocess time:
    _embedding: Optional[bytes] = None
    _distance_func_override: Optional[str] = None
    _quant: Optional[Any] = None


@dataclass
class SemanticTextSearch:
    sort: SortableOptions
    text_embeddings: SemanticTextArgs


@dataclass
class SemanticImageArgs:
    query: str
    model: str
    distance_aggregation: str = "MIN"
    embed: Optional[EmbedArgs] = None
    clip_xmodal: bool = False
    src_text: Optional[SourceArgs] = None
    index: str = "auto"
    variant: Optional[str] = None
    k: int = 10_000
    _embedding: Optional[bytes] = None
    _distance_func_override: Optional[str] = None
    _quant: Optional[Any] = None


@dataclass
class SemanticImageSearch:
    sort: SortableOptions
    image_embeddings: SemanticImageArgs


@dataclass
class SimilarityArgs:
    target: str  # sha256 of the anchor item
    model: str
    distance_function: str = "L2"
    force_distance_function: Optional[bool] = None
    distance_aggregation: str = "AVG"
    src_text: Optional[SourceArgs] = None
    clip_xmodal: bool = False
    xmodal_t2t: bool = True
    xmodal_i2i: bool = True
    index: str = "auto"
    variant: Optional[str] = None
    k: int = 10_000
    _quant: Optional[Any] = None
    _distance_func_override: Optional[str] = None


@dataclass
class SimilarTo:
    sort: SortableOptions
    similar_to: SimilarityArgs


@dataclass
class InBookmarksArgs:
    filter: bool = True
    namespaces: list[str] = field(default_factory=list)
    sub_ns: bool = False
    user: str = "user"
    include_wildcard: bool = True


@dataclass
class InBookmarks:
    sort: SortableOptions
    in_bookmarks: InBookmarksArgs


@dataclass
class InPinboardArgs:
    filter: bool = True
    pinboard_ids: list[int] = field(default_factory=list)
    user: str = "user"


@dataclass
class InPinboard:
    sort: SortableOptions
    in_pinboard: InPinboardArgs


@dataclass
class ProcessedBy:
    processed_by: str  # setter name


@dataclass
class DerivedDataArgs:
    setter_name: str
    data_types: list[str] = field(default_factory=list)


@dataclass
class HasUnprocessedData:
    has_data_unprocessed: DerivedDataArgs


@dataclass
class FailedFor:
    failed_for: str  # setter name (ledger-aware exclusion)


@dataclass
class AndOperator:
    and_: list["QueryElement"]


@dataclass
class OrOperator:
    or_: list["QueryElement"]


@dataclass
class NotOperator:
    not_: "QueryElement"


QueryElement = Union[
    AndOperator, OrOperator, NotOperator,
    MatchFilter, MatchPath, MatchText, MatchTags,
    SemanticTextSearch, SemanticImageSearch, SimilarTo,
    InBookmarks, InPinboard, ProcessedBy, HasUnprocessedData, FailedFor,
]

SORTABLE_KEYS = {
    "order_by", "direction", "priority", "row_n", "row_n_direction",
    "gt", "lt", "select_as", "rrf",
}


def _args(obj: dict, cls, **renames):
    """Build a dataclass from a JSON object, ignoring private fields."""
    import dataclasses

    names = {f.name for f in dataclasses.fields(cls) if not f.name.startswith("_")}
    kwargs = {}
    for key, value in obj.items():
        name = renames.get(key, key)
        if name in names and value is not None:
            kwargs[name] = value
    try:
        return cls(**kwargs)
    except TypeError as exc:
        raise PqlError(f"invalid {cls.__name__}: {exc}") from exc


def _nested(obj: dict, key: str, cls):
    value = obj.get(key)
    if value is None:
        return None
    if not isinstance(value, dict):
        raise PqlError(f"{key} must be an object")
    return _args(value, cls)


def parse_query_element(obj: Any) -> QueryElement:
    """Discriminate a filter by its payload key (the untagged-enum parse,
    model.rs:499-520)."""
    if not isinstance(obj, dict):
        raise PqlError("query element must be an object")
    keys = set(obj.keys())

    if keys & {"and_", "and"}:
        return AndOperator([parse_query_element(x) for x in obj.get("and_", obj.get("and"))])
    if keys & {"or_", "or"}:
        return OrOperator([parse_query_element(x) for x in obj.get("or_", obj.get("or"))])
    if keys & {"not_", "not"}:
        return NotOperator(parse_query_element(obj.get("not_", obj.get("not"))))

    def sort(defaults=None):
        return SortableOptions.from_json(obj, defaults)

    if "match_path" in keys:
        args = _args(obj["match_path"], MatchPathArgs)
        return MatchPath(sort(), args)
    if "match_text" in keys:
        args = _args(obj["match_text"], MatchTextArgs)
        return MatchText(sort(_sort_desc()), args)
    if "match_tags" in keys:
        args = _args(obj["match_tags"], TagsArgs)
        return MatchTags(sort(_sort_desc()), args)
    if "text_embeddings" in keys:
        args = _args(obj["text_embeddings"], SemanticTextArgs)
        args.embed = _embed_args(obj["text_embeddings"])
        args.src_text = _src_text(obj["text_embeddings"])
        return SemanticTextSearch(sort(_sort_asc_orderby()), args)
    if "image_embeddings" in keys:
        args = _args(obj["image_embeddings"], SemanticImageArgs)
        args.embed = _embed_args(obj["image_embeddings"])
        args.src_text = _src_text(obj["image_embeddings"])
        return SemanticImageSearch(sort(_sort_asc_orderby()), args)
    if "similar_to" in keys:
        args = _args(obj["similar_to"], SimilarityArgs)
        args.src_text = _src_text(obj["similar_to"])
        return SimilarTo(sort(_sort_asc_orderby()), args)
    if "in_bookmarks" in keys:
        return InBookmarks(sort(), _args(obj["in_bookmarks"], InBookmarksArgs))
    if "in_pinboard" in keys:
        return InPinboard(sort(), _args(obj["in_pinboard"], InPinboardArgs))
    if "processed_by" in keys:
        value = obj["processed_by"]
        if not isinstance(value, str):
            raise PqlError("processed_by takes a setter name")
        return ProcessedBy(value)
    if "has_data_unprocessed" in keys:
        return HasUnprocessedData(_args(obj["has_data_unprocessed"], DerivedDataArgs))
    if "failed_for" in keys:
        value = obj["failed_for"]
        if not isinstance(value, str):
            raise PqlError("failed_for takes a setter name")
        return FailedFor(value)
    if "match" in keys:
        # Tried last; rejects anything else so it cannot swallow trees.
        extra = keys - {"match"}
        if extra:
            raise PqlError(f"unknown fields on match filter: {sorted(extra)}")
        return MatchFilter(parse_matches(obj["match"]))
    raise PqlError(f"unrecognized query element with keys {sorted(keys)}")


def _embed_args(obj: dict) -> Optional[EmbedArgs]:
    # `embed` defaults to present (embed the query string) unless the
    # caller explicitly passes null (image_embeddings.rs:118-120).
    if "embed" in obj and obj["embed"] is None:
        return None
    value = obj.get("embed")
    return _args(value, EmbedArgs) if isinstance(value, dict) else EmbedArgs()


def _src_text(obj: dict) -> Optional[SourceArgs]:
    value = obj.get("src_text")
    return _args(value, SourceArgs) if isinstance(value, dict) else None


# ---------------------------------------------------------------------------
# Top-level query
# ---------------------------------------------------------------------------


@dataclass
class OrderArgs:
    order_by: str = "last_modified"
    order: Optional[Direction] = None
    priority: int = 0


@dataclass
class PqlQuery:
    query: Optional[QueryElement] = None
    order_by: list[OrderArgs] = field(default_factory=lambda: [OrderArgs()])
    select: list[str] = field(default_factory=lambda: list(DEFAULT_SELECT))
    entity: str = "file"
    partition_by: Optional[list[str]] = None
    seed: Optional[int] = None
    page: int = 1
    page_size: int = 10
    count: bool = True
    results: bool = True
    check_path: bool = False
    cache: bool = True
    prefetch_rows: int = 0

    @staticmethod
    def from_json(obj: Any) -> "PqlQuery":
        if obj is None:
            return PqlQuery()
        if not isinstance(obj, dict):
            raise PqlError("PQL query must be an object")
        q = PqlQuery()
        if obj.get("query") is not None:
            q.query = parse_query_element(obj["query"])
        if "order_by" in obj and obj["order_by"] is not None:
            q.order_by = []
            for o in obj["order_by"]:
                if not isinstance(o, dict):
                    raise PqlError("order_by entries must be objects")
                f = o.get("order_by", "last_modified")
                if f not in ORDER_BY_FIELDS:
                    raise PqlError(f"unknown order_by field {f!r}")
                q.order_by.append(
                    OrderArgs(
                        order_by=f,
                        order=o.get("order"),
                        priority=int(o.get("priority", 0)),
                    )
                )
        if "select" in obj and obj["select"] is not None:
            for col in obj["select"]:
                if col not in ALL_COLUMNS:
                    raise PqlError(f"unknown select column {col!r}")
            q.select = list(obj["select"])
        entity = obj.get("entity", "file")
        if entity not in ("file", "text"):
            raise PqlError(f"unknown entity {entity!r}")
        q.entity = entity
        if obj.get("partition_by") is not None:
            for col in obj["partition_by"]:
                if col not in ALL_COLUMNS:
                    raise PqlError(f"unknown partition_by column {col!r}")
            q.partition_by = list(obj["partition_by"])
        if obj.get("seed") is not None:
            q.seed = int(obj["seed"])
        q.page = max(1, int(obj.get("page", 1)))
        q.page_size = max(0, int(obj.get("page_size", 10)))
        q.count = bool(obj.get("count", True))
        q.results = bool(obj.get("results", True))
        q.check_path = bool(obj.get("check_path", False))
        q.cache = bool(obj.get("cache", True))
        q.prefetch_rows = int(obj.get("prefetch_rows", 0))
        if q.entity == "file":
            bad = [c for c in q.select if c in TEXT_COLUMNS]
            if bad:
                raise PqlError(f"text columns {bad} require entity 'text'")
            if q.partition_by:
                bad = [c for c in q.partition_by if c in TEXT_COLUMNS]
                if bad:
                    raise PqlError(f"cannot partition by text columns {bad} on entity 'file'")
        return q

    def orders_by_random(self) -> bool:
        return any(o.order_by == "random" for o in self.order_by)

    def resolve_seed(self) -> tuple[Optional[int], bool]:
        """Mint a seed for random ordering when the caller omitted one.
        Returns (effective_seed, synthesized) — a synthesized seed bypasses
        the result cache (model.rs:449-476)."""
        if not self.orders_by_random():
            return None, False
        if self.seed is not None:
            return self.seed, False
        import secrets

        self.seed = secrets.randbelow(MAX_SYNTHESIZED_SEED)
        return self.seed, True


def walk_filters(element: Optional[QueryElement]):
    """Yield every leaf filter in the tree (preprocessing passes use this)."""
    if element is None:
        return
    if isinstance(element, AndOperator):
        for child in element.and_:
            yield from walk_filters(child)
    elif isinstance(element, OrOperator):
        for child in element.or_:
            yield from walk_filters(child)
    elif isinstance(element, NotOperator):
        yield from walk_filters(element.not_)
    else:
        yield element


def prune_empty(element: Optional[QueryElement]) -> Optional[QueryElement]:
    """Drop empty operators/filters — preprocess normalization
    (preprocess.rs:188)."""
    if element is None:
        return None
    if isinstance(element, AndOperator):
        kept = [e for e in (prune_empty(c) for c in element.and_) if e is not None]
        if not kept:
            return None
        return kept[0] if len(kept) == 1 else AndOperator(kept)
    if isinstance(element, OrOperator):
        kept = [e for e in (prune_empty(c) for c in element.or_) if e is not None]
        if not kept:
            return None
        return kept[0] if len(kept) == 1 else OrOperator(kept)
    if isinstance(element, NotOperator):
        inner = prune_empty(element.not_)
        return None if inner is None else NotOperator(inner)
    if isinstance(element, MatchFilter) and isinstance(element.match_, MatchOps):
        if element.match_.empty:
            return None
    if isinstance(element, MatchText) and not element.match_text.match and not element.match_text.filter_only:
        return None
    if isinstance(element, MatchTags) and not element.match_tags.tags:
        return None
    return element
