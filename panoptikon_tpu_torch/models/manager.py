"""Model manager: cache-key LRU/TTL lifecycle over in-process models.

The port's copy of ``panoptikon_tpu/models/manager.py``, held to it by
``tests/test_torch_host_copies.py``: host code only. Its out-of-memory
test (``_is_oom``) keys on "out of memory", which the message of
``torch.OutOfMemoryError`` (CUDA's allocator) contains, so the batch split
below fires on the card as it does on the TPU.

Keeps the reference manager's observable semantics (inferio/manager.rs
header, itself a port of the legacy Python manager) while replacing
process-per-model workers with resident model objects:

- ``lru_caches[cache_key]`` is an insertion-ordered ``inference_id →
  expiration`` map; ``lru_size`` enforced on every load, oldest evicted.
- ``cache_refs[inference_id]`` is the set of cache keys referencing the
  model; it unloads only when the last reference disappears.
- TTL ≥ 0 → now + ttl; negative → never. A sweeper pass (caller- or
  timer-driven) expires entries and unloads unreferenced models.
- Repeated load renews TTL and moves to MRU (the cron preload loop
  depends on this).
- Predict pins the model with a refcount: the sweeper skips pinned models
  entirely, and each completing predict restores its own cache-key TTL —
  overlapping predicts through different keys cannot unpin each other.
- Failed loads never leave phantom ids; ``lru_size <= 0`` refuses the
  load (the fixed Python leaks, manager.rs:39-55).
- **Cross-request dispatch batching** (dispatch.rs:264 ``run_dispatcher``):
  concurrent predicts for one model enqueue into a per-model FIFO; whoever
  holds the model lock drains a WINDOW — up to the effective cap = max
  over explicit ``max_batch`` in the window, else the registry's
  ``default_batch_size`` — as ONE merged predict, split back per request.
  Merged-batch failure falls back to per-request predicts
  (dispatch.rs:28-35).
- **Prewarm**: ``load_model(prewarm=True)`` invokes the impl's optional
  ``prepare()`` after load (the reference warms worker processes,
  inferio/prewarm.rs; here each bucket shape runs once ahead of the first
  caller: kernel builds, library handles, the allocator's pools).
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence

from panoptikon_tpu_torch.models.base import InferenceModel, PredictionInput
from panoptikon_tpu_torch.models.registry import Registry

DEFAULT_BATCH = 16


class ModelLoadError(RuntimeError):
    pass


def _is_oom(exc: BaseException) -> bool:
    """Device out-of-memory, by message: XLA raises XlaRuntimeError with
    RESOURCE_EXHAUSTED; TPU allocator messages mention HBM."""
    s = str(exc)
    return "RESOURCE_EXHAUSTED" in s or "out of memory" in s.lower()


@dataclass
class _Request:
    """One caller's slice of a dispatch window."""

    inputs: Sequence[PredictionInput]
    max_batch: Optional[int]
    done: threading.Event = field(default_factory=threading.Event)
    outputs: Optional[list] = None
    error: Optional[BaseException] = None


@dataclass
class _LoadedModel:
    model: InferenceModel
    impl_class: str
    default_batch: int = DEFAULT_BATCH
    predict_pins: int = 0
    # Eviction arrived while pinned: the LAST unpinner performs the unload
    # (an unload mid-predict would null the weights under the caller).
    evict_when_unpinned: bool = False
    lock: threading.Lock = field(default_factory=threading.Lock)
    queue: list = field(default_factory=list)
    qlock: threading.Lock = field(default_factory=threading.Lock)


class ModelManager:
    def __init__(self, registry: Registry, impl_index: dict[str, type[InferenceModel]]):
        self.registry = registry
        self.impl_index = impl_index
        self._state = threading.Lock()
        self._load_lock = threading.Lock()  # serializes slow load phases
        self._models: dict[str, _LoadedModel] = {}
        self._lru: dict[str, OrderedDict[str, float]] = {}
        self._refs: dict[str, set[str]] = {}

    # -- lifecycle ----------------------------------------------------------

    def load_model(
        self,
        inference_id: str,
        *,
        cache_key: str = "default",
        lru_size: int = 1,
        ttl_seconds: float = 3600.0,
        prewarm: bool = False,
    ) -> None:
        if lru_size <= 0:
            raise ModelLoadError("lru_size must be positive")
        group, _, name = inference_id.partition("/")
        resolved = self.registry.resolve(group, name)
        # Fast path — already loaded: renew under _state only. Holding
        # _load_lock here would stall TTL renewals (the cron preload
        # contract) behind any concurrent slow cold load, letting a hot
        # model expire mid-use.
        if self._renew(inference_id, cache_key, lru_size, ttl_seconds):
            return
        with self._load_lock:
            with self._state:
                already = inference_id in self._models
            if not already:
                impl_cls = self.impl_index.get(resolved.impl_class)
                if impl_cls is None:
                    # User custom impls (reference impl_dirs/IMPL_CLASS
                    # discovery): resolved lazily at LOAD so a broken user
                    # module can never break package import.
                    from panoptikon_tpu_torch.models import discovery

                    try:
                        impl_cls = discovery.find(
                            self.registry.impl_dirs(), resolved.impl_class
                        )
                    except LookupError as exc:
                        raise ModelLoadError(
                            f"unknown impl_class {resolved.impl_class!r} "
                            f"for {inference_id}: {exc}"
                        ) from exc
                try:
                    model = impl_cls(**resolved.spawn_kwargs())
                    model.load()
                    if prewarm and hasattr(model, "prepare"):
                        # Compile the bucket shapes before the first caller
                        # (the reference's prewarm pool made jit-native).
                        model.prepare()
                except Exception as exc:
                    raise ModelLoadError(
                        f"failed to load {inference_id}: {exc}"
                    ) from exc
                default_batch = int(
                    resolved.metadata.get("default_batch_size")
                    or self.registry.group_metadata(group).get("default_batch_size")
                    or DEFAULT_BATCH
                )
                with self._state:
                    self._models[inference_id] = _LoadedModel(
                        model=model,
                        impl_class=resolved.impl_class,
                        default_batch=default_batch,
                    )
            self._renew(inference_id, cache_key, lru_size, ttl_seconds)

    def _renew(
        self, inference_id: str, cache_key: str, lru_size: int,
        ttl_seconds: float,
    ) -> bool:
        """Reference/renew an already-loaded model in one atomic _state
        pass (TTL + MRU + refs + LRU eviction). The cache dict is
        RE-FETCHED here, never captured across a slow load — a concurrent
        clear_cache would orphan a captured dict and leak the model with
        phantom refs. Returns False when the model isn't loaded."""
        with self._state:
            entry = self._models.get(inference_id)
            if entry is None:
                return False
            entry.evict_when_unpinned = False  # re-referenced: resurrect
            cache = self._lru.setdefault(cache_key, OrderedDict())
            expiry = (
                time.monotonic() + ttl_seconds if ttl_seconds >= 0
                else float("inf")
            )
            # Renewal moves to MRU before reassigning (manager.rs:18-20).
            if inference_id in cache:
                cache.move_to_end(inference_id)
            cache[inference_id] = expiry
            self._refs.setdefault(inference_id, set()).add(cache_key)
            evicted = []
            while len(cache) > lru_size:
                old_id, _ = cache.popitem(last=False)
                self._refs.get(old_id, set()).discard(cache_key)
                if not self._refs.get(old_id):
                    evicted.append(old_id)
        for old_id in evicted:
            self._unload(old_id)
        return True

    def predict(
        self, inference_id: str, inputs: Sequence[PredictionInput],
        *, cache_key: str = "default", lru_size: int = 1, ttl_seconds: float = 3600.0,
        max_batch: Optional[int] = None,
    ) -> list[Any]:
        # Pin acquisition is ATOMIC with the liveness check (and declines
        # dying entries): a sweep/evict between "get" and "pin" would
        # otherwise unload the model under this predict. A load that gets
        # evicted before we can pin (adversarial lru_size=1 churn) retries.
        entry = None
        for _ in range(3):
            with self._state:
                candidate = self._models.get(inference_id)
                if candidate is not None and not candidate.evict_when_unpinned:
                    candidate.predict_pins += 1
                    entry = candidate
                    break
            self.load_model(
                inference_id, cache_key=cache_key, lru_size=lru_size,
                ttl_seconds=ttl_seconds,
            )
        if entry is None:
            raise ModelLoadError(
                f"{inference_id}: loaded but evicted before it could be "
                "pinned (cache churn — raise lru_size)"
            )
        req = _Request(inputs=inputs, max_batch=max_batch)
        with entry.qlock:
            entry.queue.append(req)
        try:
            # Dispatch loop (dispatch.rs:264): whoever holds the model lock
            # drains FIFO windows as merged predicts; a caller whose request
            # was served by another thread's window just returns. One
            # outstanding model call at a time (the reference's &mut self).
            while not req.done.is_set():
                with entry.lock:
                    if req.done.is_set():
                        break
                    self._drain_window(inference_id, entry)
            if req.error is not None:
                raise req.error
            return req.outputs
        finally:
            with self._state:
                entry.predict_pins -= 1
                deferred = (
                    entry.predict_pins == 0
                    and entry.evict_when_unpinned
                    and not self._refs.get(inference_id)
                )
                cache = self._lru.get(cache_key)
                if (
                    not deferred and cache is not None
                    and inference_id in cache
                ):
                    # Restore this key's TTL only (manager.rs:51-55).
                    cache[inference_id] = (
                        time.monotonic() + ttl_seconds
                        if ttl_seconds >= 0
                        else float("inf")
                    )
            if deferred:
                # The eviction that arrived mid-predict runs now, on the
                # last unpinner.
                self._unload(inference_id)

    @staticmethod
    def _predict_split(entry: _LoadedModel, inputs: list, cap: int) -> list:
        """Predict, splitting batches larger than the model's batch cap
        into cap-sized worker batches (dispatch.rs oversized-request
        splitting). Without this, one request bigger than the bucket
        ladder's top would overflow ``batching.pad_batch`` instead of
        simply taking several device steps."""
        cap = max(1, cap or entry.default_batch)
        if len(inputs) <= cap:
            try:
                return list(entry.model.predict(inputs))
            except Exception as exc:
                # Device-OOM → batch-halving retry (the reference's
                # impl/utils.py run_with_oom_retry): smaller buckets
                # compile smaller activations; anything else re-raises.
                if not _is_oom(exc) or len(inputs) == 1:
                    raise
                cap = max(1, len(inputs) // 2)
        outputs: list = []
        for at in range(0, len(inputs), cap):
            chunk = inputs[at : at + cap]
            got = ModelManager._predict_split(entry, chunk, cap)
            if len(got) != len(chunk):
                raise RuntimeError(
                    f"{len(got)} outputs for {len(chunk)} inputs"
                )
            outputs.extend(got)
        return outputs

    def _drain_window(self, inference_id: str, entry: _LoadedModel) -> None:
        """Pop one FIFO window and run it as a single merged predict.

        Effective cap = max over explicit ``max_batch`` in the window, else
        the registry's ``default_batch_size`` (dispatch.rs:12-22). A merged
        failure falls back to per-request predicts so one bad payload can't
        poison its window-mates (dispatch.rs:28-35).
        """
        with entry.qlock:
            if not entry.queue:
                return
            window: list[_Request] = []
            cap = 0
            total = 0
            for req in entry.queue:
                explicit = req.max_batch or entry.default_batch
                new_cap = max(cap, explicit)
                if window and total + len(req.inputs) > new_cap:
                    break
                window.append(req)
                total += len(req.inputs)
                cap = new_cap
            del entry.queue[: len(window)]
        merged: list[PredictionInput] = []
        for req in window:
            merged.extend(req.inputs)
        try:
            outputs = self._predict_split(entry, merged, cap)
            if len(outputs) != len(merged):
                raise RuntimeError(
                    f"{inference_id}: {len(outputs)} outputs for {len(merged)} inputs"
                )
            at = 0
            for req in window:
                req.outputs = outputs[at : at + len(req.inputs)]
                at += len(req.inputs)
                req.done.set()
        except BaseException as exc:  # noqa: BLE001 — window-mates must
            # never be left spinning on an unset done event (the window was
            # already popped from the queue); fatal signals re-raise after
            # every caller is released.
            fatal = not isinstance(exc, Exception)
            if fatal or len(window) == 1:
                for req in window:
                    req.error = exc
                    req.done.set()
                if fatal:
                    raise
                return
            # Merged failure → per-request fallback. A FATAL signal here
            # must still release every remaining window-mate (they were
            # already popped from the queue; an unset done event leaves
            # their caller threads spinning forever) before re-raising.
            for wi, req in enumerate(window):
                try:
                    outputs = self._predict_split(
                        entry, list(req.inputs),
                        req.max_batch or entry.default_batch,
                    )
                    if len(outputs) != len(req.inputs):
                        raise RuntimeError(
                            f"{inference_id}: {len(outputs)} outputs for "
                            f"{len(req.inputs)} inputs"
                        )
                    req.outputs = outputs
                except Exception as exc2:
                    req.error = exc2
                except BaseException as exc2:  # noqa: BLE001
                    for rest in window[wi:]:
                        rest.error = exc2
                        rest.done.set()
                    raise
                req.done.set()

    def unload_model(self, inference_id: str, cache_key: str | None = None) -> bool:
        with self._state:
            keys = (
                [cache_key]
                if cache_key is not None
                else list(self._refs.get(inference_id, set()))
            )
            for key in keys:
                cache = self._lru.get(key)
                if cache is not None:
                    cache.pop(inference_id, None)
                self._refs.get(inference_id, set()).discard(key)
            gone = not self._refs.get(inference_id)
        if gone:
            self._unload(inference_id)
        return gone

    def clear_cache(self, cache_key: str) -> None:
        with self._state:
            cache = self._lru.pop(cache_key, OrderedDict())
            to_unload = []
            for inference_id in cache:
                self._refs.get(inference_id, set()).discard(cache_key)
                if not self._refs.get(inference_id):
                    to_unload.append(inference_id)
        for inference_id in to_unload:
            self._unload(inference_id)

    def sweep(self) -> list[str]:
        """Expire overdue entries; returns unloaded ids. Pinned models are
        skipped entirely."""
        now = time.monotonic()
        unloaded = []
        with self._state:
            pinned = {
                mid for mid, m in self._models.items() if m.predict_pins > 0
            }
            for key, cache in self._lru.items():
                for mid in [m for m, exp in cache.items() if exp <= now]:
                    if mid in pinned:
                        continue
                    cache.pop(mid, None)
                    self._refs.get(mid, set()).discard(key)
                    if not self._refs.get(mid):
                        unloaded.append(mid)
        for mid in unloaded:
            self._unload(mid)
        return unloaded

    # -- introspection (the /cache and /health surfaces) --------------------

    def loaded_models(self) -> dict[str, list[str]]:
        with self._state:
            return {mid: sorted(refs) for mid, refs in self._refs.items() if refs}

    def cache_expirations(self, cache_key: str) -> dict[str, float]:
        with self._state:
            cache = self._lru.get(cache_key, OrderedDict())
            now = time.monotonic()
            return {mid: exp - now for mid, exp in cache.items()}

    def health(self) -> dict:
        with self._state:
            return {
                "status": "ok",
                "model_count": len(self._models),
                "cache_keys": list(self._lru.keys()),
            }

    def shutdown(self) -> None:
        with self._state:
            ids = list(self._models.keys())
            self._lru.clear()
            self._refs.clear()
        for mid in ids:
            self._unload(mid)

    # -- internals ----------------------------------------------------------

    def _unload(self, inference_id: str) -> None:
        with self._state:
            entry = self._models.get(inference_id)
            if entry is None:
                return
            if self._refs.get(inference_id):
                # Resurrected between the caller's decision (made under
                # _state) and this re-acquire: a concurrent load_model
                # re-referenced the entry — unloading now would null the
                # weights of a model just promised loaded. Every unload
                # path drops its refs first, so live refs == live model.
                return
            if entry.predict_pins > 0:
                # In-flight predicts read the model's weights: defer to
                # the last unpinner instead of nulling params under them.
                entry.evict_when_unpinned = True
                return
            self._models.pop(inference_id, None)
            self._refs.pop(inference_id, None)
        try:
            entry.model.unload()
        except Exception:
            pass
