"""Explicit device selection.

The JAX package lets the backend pick a platform; the port names its device.
Asking for CUDA where there is none raises — a run that meant to measure the
card must never fall back to the CPU and report CPU numbers.
"""

from __future__ import annotations

import torch


def device(name: str = "cuda") -> torch.device:
    """``torch.device`` for ``name`` ("cuda", "cuda:N" or "cpu").

    Raises ``RuntimeError`` for a CUDA device when CUDA is unavailable or
    the ordinal does not exist."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {name!r} requested but CUDA is not available")
        index = 0 if dev.index is None else dev.index
        if index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {name!r} requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) exist"
            )
        return torch.device("cuda", index)
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {name!r}")
    return dev
