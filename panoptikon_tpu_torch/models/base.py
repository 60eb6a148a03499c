"""Inference model interface + per-item error slots.

The port's own copy of ``panoptikon_tpu/models/base.py``. In-process
analog of the reference's worker-side ABC (``python/inferio/model.py``:
name/load/predict/unload, optional ``prepare`` for prewarm) and the typed
error-slot contract
(``docs/inferio-worker-protocol.md:99-153``): an output slot may carry
``{"__error__": {"class": "input"|"transient", "message": str}}`` instead
of a payload. ``input`` is a settled verdict on that input's media (the
ledger persists it); ``transient`` says nothing about the payload and fails
the whole item transiently. Slot count must equal input count.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import Any, Optional, Sequence


@dataclass
class PredictionInput:
    """One predict slot: structured data and/or a file payload."""

    data: Any = None
    file: Optional[bytes] = None


class SlotError(Exception):
    """Raised by an impl for ONE input; converted into an error slot."""

    def __init__(self, error_class: str, message: str):
        if error_class not in ("input", "transient"):
            raise ValueError(f"invalid slot error class {error_class!r}")
        super().__init__(message)
        self.error_class = error_class
        self.message = message

    def to_slot(self) -> dict:
        return {"__error__": {"class": self.error_class, "message": self.message}}


def is_error_slot(output: Any) -> bool:
    return isinstance(output, dict) and "__error__" in output


def parse_error_slot(output: dict) -> tuple[str, str]:
    """Strict parse — malformed error slots are protocol violations
    (protocol doc: 'Malformed is fatal')."""
    body = output.get("__error__")
    if not isinstance(body, dict):
        raise ValueError("malformed error slot: body not an object")
    cls = body.get("class")
    msg = body.get("message")
    if cls not in ("input", "transient") or not isinstance(msg, str):
        raise ValueError("malformed error slot: bad class or message")
    return cls, msg


class InferenceModel(ABC):
    """load → predict* → unload. Constructed with the registry's merged
    config kwargs; predict returns one output per input (bytes = npy or
    binary payload, dict/list/str = JSON-like, or an error slot)."""

    @classmethod
    @abstractmethod
    def name(cls) -> str:
        ...

    @abstractmethod
    def load(self) -> None:
        ...

    @abstractmethod
    def predict(self, inputs: Sequence[PredictionInput]) -> Sequence[Any]:
        ...

    @abstractmethod
    def unload(self) -> None:
        ...

    @classmethod
    def prepare(cls) -> None:
        """Optional prewarm hook (downloads/compile warmup)."""
