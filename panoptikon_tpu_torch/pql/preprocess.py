"""PQL preprocessing: validation, query embedding, quant resolution.

Mirrors the reference pass (``pql/preprocess.rs``): normalize the AST
(prune empty filters), then for every vector filter either decode the
caller-supplied base64 npy embedding (``embed = null``) or fetch the query
embedding through the model manager with a process-global LRU keyed by
(model, kind, query) — the payloads are wire-identical
(``{"text": q, "task": "s2s"}`` for text-embedding models,
``{"text": q}`` for CLIP text towers — preprocess.rs:846-920).

Quant resolution (preprocess.rs:314-440): ``index = auto`` uses the int8
arm when the space's quant profile is READY (else exact, non-strictly);
``quant`` demands readiness and errors; ``exact`` always brute-forces;
``ann`` is reserved. The resolved scale also quantizes the query with the
same codec the write side used.
"""

from __future__ import annotations

import base64
import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Optional

import numpy as np

from panoptikon_tpu_torch.models.base import PredictionInput, is_error_slot, parse_error_slot
from panoptikon_tpu_torch.ops import codec
from panoptikon_tpu_torch.pql import model as pql
from panoptikon_tpu_torch.utils import npy


@dataclass
class QuantResolved:
    scale: float
    query_quant: Optional[np.ndarray]  # int8 codes; None for similar_to


class _EmbeddingCache:
    """Process-global LRU over (model, kind, query) → embedding
    (preprocess.rs:42-128)."""

    def __init__(self, capacity: int = 256):
        self.capacity = capacity
        self._lock = threading.Lock()
        self._map: OrderedDict[tuple, np.ndarray] = OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, key: tuple) -> Optional[np.ndarray]:
        with self._lock:
            vec = self._map.get(key)
            if vec is not None:
                self._map.move_to_end(key)
                self.hits += 1
            else:
                self.misses += 1
            return vec

    def put(self, key: tuple, vec: np.ndarray) -> None:
        with self._lock:
            self._map[key] = vec
            self._map.move_to_end(key)
            while len(self._map) > self.capacity:
                self._map.popitem(last=False)

    def clear(self) -> None:
        with self._lock:
            self._map.clear()

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._map),
                "capacity": self.capacity,
                "hits": self.hits,
                "misses": self.misses,
            }


EMBED_CACHE = _EmbeddingCache()


def _decode_base64_embedding(query: str) -> np.ndarray:
    try:
        raw = base64.standard_b64decode(query)
    except Exception as exc:
        raise pql.PqlError(f"Invalid base64 embeddings: {exc}") from exc
    return npy.parse_npy_embedding(raw)


def _embed_via_manager(manager, model: str, payload: dict, embed: pql.EmbedArgs) -> np.ndarray:
    outputs = manager.predict(
        model,
        [PredictionInput(data=payload)],
        cache_key=embed.cache_key,
        lru_size=embed.lru_size,
        ttl_seconds=embed.ttl_seconds,
    )
    out = outputs[0]
    if is_error_slot(out):
        cls, msg = parse_error_slot(out)
        raise pql.PqlError(f"inference rejected the embed input ({cls}): {msg}")
    if isinstance(out, bytes):
        return npy.parse_npy_embedding(out)
    raise pql.PqlError("embed model returned a non-binary output")


def fetch_query_embedding(
    manager,
    model: str,
    query: str,
    kind: str,  # 'text' (text-embedding model, s2s task) or 'image' (CLIP text tower)
    embed: Optional[pql.EmbedArgs],
) -> np.ndarray:
    """The preprocess-side embed: base64 passthrough when embed is None,
    else inference with the global LRU."""
    if embed is None:
        return _decode_base64_embedding(query)
    key = (model, kind, query)
    cached = EMBED_CACHE.get(key)
    if cached is not None:
        return cached
    payload = {"text": query, "task": "s2s"} if kind == "text" else {"text": query}
    vec = _embed_via_manager(manager, model, payload, embed)
    EMBED_CACHE.put(key, vec)
    return vec


def resolve_quant(
    index,
    space: str,
    index_mode: str,
    variant: Optional[str],
    query_vec: Optional[np.ndarray],
) -> Optional[QuantResolved]:
    """Decide the scoring arm for one vector filter. Returns None for the
    exact arm; QuantResolved for the int8 arm. Raises for strict failures."""
    if index_mode == "exact":
        return None
    if index_mode == "ann":
        raise pql.PqlError("index mode 'ann' is reserved")
    try:
        snap = index.snapshot(space)
        ready = snap.quant_ready
    except KeyError:
        ready = False
        snap = None
    if not ready:
        if index_mode == "quant" or variant is not None:
            raise pql.PqlError(
                f"quant profile not ready for {space!r}"
                + (f" (variant {variant!r})" if variant else "")
            )
        return None  # auto falls back to exact, non-strictly
    quant = None
    if query_vec is not None:
        quant = codec.compute_query_quant(query_vec, snap.scale)
    return QuantResolved(scale=float(snap.scale), query_quant=quant)


def _registry_distance(manager, model: str) -> Optional[str]:
    """The group's declared distance_func override (inference.toml:721,972
    pattern): some embedding families are L2-native."""
    registry = getattr(manager, "registry", None)
    if registry is None:
        return None
    try:
        group = model.partition("/")[0]
        return registry.group_metadata(group).get("distance_func")
    except Exception:
        return None


def preprocess_query(query: pql.PqlQuery, *, manager, index) -> pql.PqlQuery:
    """Normalize + resolve every vector filter in place. ``manager`` may be
    None when every semantic filter supplies base64 embeddings."""
    query.query = pql.prune_empty(query.query)
    for leaf in pql.walk_filters(query.query):
        if isinstance(leaf, pql.SemanticTextSearch):
            args = leaf.text_embeddings
            if not args.query:
                raise pql.PqlError("text_embeddings.query must not be empty")
            vec = fetch_query_embedding(manager, args.model, args.query, "text", args.embed)
            args._embedding = vec
            args._quant = resolve_quant(index, args.model, args.index, args.variant, vec)
            if args._distance_func_override is None:
                args._distance_func_override = _registry_distance(manager, args.model)
        elif isinstance(leaf, pql.SemanticImageSearch):
            args = leaf.image_embeddings
            if not args.query:
                raise pql.PqlError("image_embeddings.query must not be empty")
            vec = fetch_query_embedding(manager, args.model, args.query, "image", args.embed)
            args._embedding = vec
            args._quant = resolve_quant(index, args.model, args.index, args.variant, vec)
            if args._distance_func_override is None:
                args._distance_func_override = _registry_distance(manager, args.model)
        elif isinstance(leaf, pql.SimilarTo):
            args = leaf.similar_to
            if len(args.target) != 64:
                raise pql.PqlError("similar_to.target must be a sha256 hex digest")
            args._quant = resolve_quant(index, args.model, args.index, args.variant, None)
            if args._distance_func_override is None:
                args._distance_func_override = _registry_distance(manager, args.model)
    return query
