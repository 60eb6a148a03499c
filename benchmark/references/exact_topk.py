"""Plain exact cosine similarity: the reference of the similar-search cells.

Every query against every row, in f32 with TF32 off (or, for the control,
in bfloat16). Imports nothing of the program.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def no_tf32():
    """f32 products in f32: the card would otherwise round their inputs to
    TF32."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@torch.inference_mode()
def cosine_sims(rows: torch.Tensor, queries: torch.Tensor, *, dtype=torch.float32) -> torch.Tensor:
    """(Q, N) f32 cosine similarities of ``queries`` (Q, D) against ``rows``
    (N, D). The products run in ``dtype`` (bfloat16 rounds the operands and
    the products' results to bfloat16); the norms and the division in f32."""
    with no_tf32():
        r = rows.to(dtype)
        q = queries.to(dtype)
        row_norm = torch.linalg.norm(r.to(torch.float32), dim=1)
        q_norm = torch.linalg.norm(q.to(torch.float32), dim=1)
        dots = (q @ r.T).to(torch.float32)
        return dots / torch.clamp(q_norm[:, None] * row_norm[None, :], min=1e-30)
