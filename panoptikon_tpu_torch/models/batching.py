"""Static-shape batching: padding buckets replacing dynamic batch shapes.

The port's own copy of ``panoptikon_tpu/models/batching.py``. The reference
batches dynamically at dispatch time (inferio/dispatch.rs window drain — any
batch size up to the cap); the JAX package quantizes batch sizes to a small
bucket ladder (powers of two up to the cap) and pads, so that each bucket
compiles once. The port keeps the same ladder, so both packages embed the
same padded batches. Pad rows are dead work bounded at <2× (and amortized
~1.33×).

Sequence lengths bucket the same way (text chunks pad to the next length
bucket, attention-masked).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def bucket_ladder(cap: int, base: int = 1) -> list[int]:
    """[base, 2·base, …, cap] powers of two, cap always included."""
    sizes = []
    b = base
    while b < cap:
        sizes.append(b)
        b *= 2
    sizes.append(cap)
    return sizes


def bucket_for(n: int, ladder: Sequence[int]) -> int:
    for b in ladder:
        if n <= b:
            return b
    return ladder[-1]


def pad_batch(batch: np.ndarray, bucket: int) -> tuple[np.ndarray, np.ndarray]:
    """Pad the leading axis to ``bucket`` rows; returns (padded, valid_mask).
    Pad rows repeat row 0 (keeps values in-distribution, avoiding NaN traps
    in normalization paths) — outputs for them are dropped via the mask."""
    n = batch.shape[0]
    if n == bucket:
        return batch, np.ones(n, dtype=bool)
    if n > bucket:
        raise ValueError(f"batch of {n} exceeds bucket {bucket}")
    fill = np.broadcast_to(batch[:1], (bucket - n, *batch.shape[1:]))
    padded = np.concatenate([batch, fill], axis=0)
    valid = np.zeros(bucket, dtype=bool)
    valid[:n] = True
    return padded, valid


def pad_token_batch(
    sequences: Sequence[Sequence[int]],
    length_ladder: Sequence[int],
    batch_ladder: Sequence[int],
    pad_id: int = 0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Token seqs → (ids (B, L), attention_mask (B, L), valid (B,)) with both
    axes bucketed. Sequences longer than the top length bucket truncate."""
    max_len = max((len(s) for s in sequences), default=1)
    length = bucket_for(max_len, length_ladder)
    batch = bucket_for(max(len(sequences), 1), batch_ladder)
    ids = np.full((batch, length), pad_id, dtype=np.int32)
    mask = np.zeros((batch, length), dtype=np.int32)
    for i, seq in enumerate(sequences):
        seq = list(seq)[:length]
        ids[i, : len(seq)] = seq
        mask[i, : len(seq)] = 1
    if sequences:
        # Pad rows mirror row 0 (see pad_batch rationale).
        for i in range(len(sequences), batch):
            ids[i] = ids[0]
            mask[i] = mask[0]
    valid = np.zeros(batch, dtype=bool)
    valid[: len(sequences)] = True
    return ids, mask, valid
