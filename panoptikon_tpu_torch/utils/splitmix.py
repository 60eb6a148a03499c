"""Deterministic seeded-random ordering: the splitmix64 mixer.

Ordering by ``pk_mix(row_id, seed)`` is a deterministic permutation of the
result set, reproducible from the seed alone — which is what makes seeded
random ordering pageable and cacheable. The seed is mixed before being
combined so that adjacent seeds (1, 2, 3 — exactly what a naive minter
produces) give uncorrelated orderings rather than near-identical ones.

Bit-exact with the reference's SQLite scalar function
(``panoptikon/src/db/sql_functions.rs:27-50``). Implemented with explicit
64-bit wrapping arithmetic (NumPy uint64 / Python masking) for the same
reason the reference avoids SQL expressions: anything that silently promotes
to float loses precision and clumps.
"""

from __future__ import annotations

import numpy as np

_MASK = (1 << 64) - 1
_C1 = 0x9E3779B97F4A7C15
_C2 = 0xBF58476D1CE4E5B9
_C3 = 0x94D049BB133111EB


def mix64(z: int) -> int:
    """splitmix64's finalizer: a full-avalanche 64-bit mixer."""
    z = (z + _C1) & _MASK
    z = ((z ^ (z >> 30)) * _C2) & _MASK
    z = ((z ^ (z >> 27)) * _C3) & _MASK
    return z ^ (z >> 31)


def pk_mix(row_id: int, seed: int) -> int:
    """Map a row identity and a seed onto a pseudorandom i64 value."""
    mixed = mix64((row_id & _MASK) ^ mix64(seed & _MASK))
    # Reinterpret as signed i64, matching the SQLite function's return type.
    return mixed - (1 << 64) if mixed >= (1 << 63) else mixed


def pk_mix_array(row_ids: np.ndarray, seed: int) -> np.ndarray:
    """Vectorized :func:`pk_mix` over an id array → int64 keys.

    Used to materialize the random-order sort key for a whole candidate set
    (device ordering uses these keys; SQLite ordering uses the scalar UDF —
    both produce the identical permutation).
    """
    with np.errstate(over="ignore"):
        z = row_ids.astype(np.uint64) ^ np.uint64(mix64(seed & _MASK))
        z = z + np.uint64(_C1)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(_C2)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(_C3)
        z = z ^ (z >> np.uint64(31))
    return z.view(np.int64)


# Exclusive upper bound on a server-minted seed: seeds are echoed to clients
# as JSON numbers (IEEE doubles in JS), so minting inside the exactly-
# representable range keeps the round trip lossless (pql/model.rs:443
# `MAX_SYNTHESIZED_SEED`).
MAX_SYNTHESIZED_SEED = 1 << 53
